"""The port's checkpoint reader against the JAX package's orbax loader: the
same tree, bit for bit, on the repository's trained priors; a tree of
several B-tree levels as tensorstore writes it; faults raise."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts

from quantized_spectrum_cartography_tpu.training import (
    load_checkpoint as jax_load_checkpoint,
)
from quantized_spectrum_cartography_tpu.training.checkpoints import (
    latest_step_dir as jax_latest_step_dir,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    latest_step_dir,
    load_checkpoint,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    DIGESTS,
    leaf_digests,
)
from quantized_spectrum_cartography_tpu_torch.training.ocdbt import (
    FormatError,
    OcdbtReader,
)

TREES = ["checkpoints/gan256/final", "checkpoints/vae_best/final",
         "checkpoints/vae_peak_z256", "checkpoints/ae_completion/final"]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("path", TREES)
def test_reader_matches_jax_bitwise(path):
    """Same keys, and every leaf a numpy array of the same dtype, shape
    and bytes (scalars as 0-d arrays of JAX's 32-bit types)."""
    got = dict(_flat(load_checkpoint(path)))
    ref = dict(_flat(jax.tree.map(np.asarray, jax_load_checkpoint(path))))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert isinstance(got[k], np.ndarray), k
        assert (got[k].dtype, got[k].shape) == (v.dtype, v.shape), k
        assert got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("path", TREES)
def test_committed_digests_match_jax(path):
    """The per-leaf digests that chip_smoke.py holds the card's read
    against are those of the JAX package's loader (and of the port's
    reader here).  After retraining a prior, rewrite them with
    json.dumps({path: leaf_digests(tree)}, indent=1, sort_keys=True)."""
    want = json.loads(DIGESTS.read_text())[path]
    ref = jax.tree.map(np.asarray, jax_load_checkpoint(path))
    assert leaf_digests(ref) == want
    assert leaf_digests(load_checkpoint(path)) == want


def test_multilevel_tree_matches_tensorstore(tmp_path):
    """A store with small B-tree nodes (interior nodes two levels deep),
    values inline and in data files, read back as tensorstore reads it."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 600,
                       "max_inline_value_bytes": 8}}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(300):
            kv.with_transaction(txn)[f"key{i:04d}/x"] = (b"v%d" % i) * (
                1 + i % 5)
    store = OcdbtReader(str(tmp_path))
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == keys and len(keys) == 300
    for k in keys:
        assert store[k] == kv.read(k).result().value


@pytest.fixture
def tree_copy(tmp_path):
    dst = tmp_path / "gan256"
    shutil.copytree("checkpoints/gan256/final", dst)
    return dst


def _largest_data_file(root):
    d = root / "ocdbt.process_0" / "d"
    return max(d.iterdir(), key=lambda p: p.stat().st_size)


def _truncate(root):
    f = _largest_data_file(root)
    data = f.read_bytes()
    f.write_bytes(data[:len(data) // 2])


def _remove(root):
    _largest_data_file(root).unlink()


def _bad_magic(root):
    f = root / "manifest.ocdbt"
    f.write_bytes(b"\x00" + f.read_bytes()[1:])


def _corrupt_node(root):
    f = next((root / "d").iterdir())
    data = bytearray(f.read_bytes())
    data[40] ^= 0xFF
    f.write_bytes(bytes(data))


def _corrupt_chunk(root):
    f = _largest_data_file(root)
    data = bytearray(f.read_bytes())
    for i in range(0, len(data), 4096):
        data[i] ^= 0xFF
    f.write_bytes(bytes(data))


FAULTS = {"truncated data file": (_truncate, "bytes at"),
          "missing data file": (_remove, "data file missing"),
          "bad magic": (_bad_magic, "bad magic"),
          "corrupt node": (_corrupt_node, "checksum"),
          "corrupt chunk": (_corrupt_chunk, "zstd")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_raise(tree_copy, fault):
    """Each fault raises, naming the file; no partial tree comes back."""
    damage, message = FAULTS[fault]
    damage(tree_copy)
    with pytest.raises(FormatError, match=message) as err:
        load_checkpoint(str(tree_copy))
    assert str(tree_copy) in str(err.value)


def test_missing_metadata_raises(tmp_path):
    with pytest.raises(FormatError, match="_METADATA"):
        load_checkpoint(str(tmp_path))


def test_latest_step_dir_matches(tmp_path):
    assert latest_step_dir(str(tmp_path / "none")) is None
    assert latest_step_dir(str(tmp_path)) is None
    for n in (5, 40, 300):
        os.makedirs(tmp_path / f"step_{n}")
    got = latest_step_dir(str(tmp_path))
    assert got == jax_latest_step_dir(str(tmp_path))
    assert got.endswith("step_300")
