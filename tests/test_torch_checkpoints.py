"""The port's checkpoint reader against the JAX package's orbax loader: the
same tree, bit for bit, on the repository's trained priors; a tree of
several B-tree levels as tensorstore writes it; faults raise.  The port's
writer: its trees back bit for bit, read by the loaders of the priors, in
the layouts of the JAX trainers."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from quantized_spectrum_cartography_tpu.training import (
    load_checkpoint as jax_load_checkpoint,
)
from quantized_spectrum_cartography_tpu.training.checkpoints import (
    latest_step_dir as jax_latest_step_dir,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    latest_step_dir,
    load_checkpoint,
    save_checkpoint,
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


# ------------------------------------------------------- the port's writer


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"Dense_0": {"kernel": rng.normal(size=(3, 4)).astype(
            np.float32), "bias": np.zeros(4, np.float32)},
            "log_gain": np.float32(0.25)},
        "batch_stats": {"BatchNorm_0": {"mean": rng.normal(size=5),
                                        "var": np.ones(5, np.float64)}},
        "steps": np.arange(6, dtype=np.int32).reshape(2, 3),
        "tensor": torch.arange(4.0),
        "scale": 2.5,
        "config": {"z_dim": 64, "lr_ae": 1e-3, "name": "aae", "flag": True},
        "empty": {},
    }


def test_save_checkpoint_round_trip_bitwise(tmp_path):
    """Every array leaf back with its dtype, shape and bytes (a tensor as
    a numpy array), every other leaf back equal and of its type, the
    nesting as written; a second save replaces the first."""
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"old": np.ones(3)})
    save_checkpoint(path, _tree())
    got = load_checkpoint(path)
    want = _tree()
    assert sorted(got) == sorted(want)
    flat_got, flat_want = dict(_flat(got)), dict(_flat(want))
    flat_want["tensor"] = flat_want["tensor"].numpy()
    flat_want["params/log_gain"] = np.asarray(flat_want["params/log_gain"])
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        if isinstance(v, np.ndarray):
            assert isinstance(flat_got[k], np.ndarray), k
            assert (flat_got[k].dtype, flat_got[k].shape) == (v.dtype,
                                                              v.shape), k
            assert flat_got[k].tobytes() == v.tobytes(), k
        else:
            assert type(flat_got[k]) is type(v) and flat_got[k] == v, k
    assert got["empty"] == {} and got["config"]["flag"] is True


def test_port_written_priors_load_through_the_loaders(tmp_path):
    """A generator and a VAE saved in flax's layout by the port load back
    through load_generator / load_vae_prior, the same paths that read the
    JAX package's trees: the same weights and outputs."""
    from quantized_spectrum_cartography_tpu_torch.models import (
        VAE,
        Generator256,
    )
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        load_vae_prior,
    )
    from quantized_spectrum_cartography_tpu_torch.training import (
        flax_from_state_dict,
        load_generator,
        save_checkpoint,
    )
    from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
        flax_from_generator,
    )

    g = Generator256(seed=1)
    save_checkpoint(str(tmp_path / "gan"),
                    {**flax_from_generator(g), "scale": 2.5})
    g2, scale = load_generator(load_checkpoint(str(tmp_path / "gan")))
    assert scale == 2.5
    for k, v in g.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(v, g2.state_dict()[k]), k
    torch.manual_seed(2)
    vae = VAE().eval()
    save_checkpoint(str(tmp_path / "vae"),
                    flax_from_state_dict(vae.state_dict()))
    gen, latent, _ = load_vae_prior(str(tmp_path / "vae"))
    z = torch.randn(3, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(gen(z), vae.decode(z)[:, 0] * 0.26)
    assert latent == 64


def test_trainers_write_the_jax_layouts(tmp_path):
    """GAN: step_<n> every checkpoint_every and final, each with scale; AE:
    final with scale; VAE: final without; AAE: the directory itself, with
    its config.  latest_step_dir finds the GAN's last step."""
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.training import (
        AETrainConfig,
        GANTrainConfig,
        VAETrainConfig,
        train_ae,
        train_gan,
        train_vae,
    )
    from quantized_spectrum_cartography_tpu_torch.training.aae_trainer import (
        AAETrainConfig,
        train_aae,
    )

    phys = PhysicsConfig(decorrelation_distance=30.0)
    gen = torch.Generator().manual_seed(0)
    quiet = dict(log_fn=lambda *a: None)
    train_gan(gen, GANTrainConfig(steps=2, batch_size=2, z_dim=64), phys,
              checkpoint_dir=str(tmp_path / "gan"), checkpoint_every=1,
              **quiet)
    assert sorted(os.listdir(tmp_path / "gan")) == ["final", "step_1",
                                                    "step_2"]
    assert latest_step_dir(str(tmp_path / "gan")).endswith("step_2")
    for name in ("step_1", "final"):
        tree = load_checkpoint(str(tmp_path / "gan" / name))
        assert sorted(tree) == ["batch_stats", "params", "scale"]
        assert tree["scale"] == 2.5
    train_ae(gen, AETrainConfig(steps=1, batch_size=2), phys,
             checkpoint_dir=str(tmp_path / "ae"), **quiet)
    assert sorted(load_checkpoint(str(tmp_path / "ae" / "final"))) == [
        "batch_stats", "params", "scale"]
    train_vae(gen, VAETrainConfig(steps=1, batch_size=2, latent_dim=8),
              phys, checkpoint_dir=str(tmp_path / "vae"), **quiet)
    assert sorted(load_checkpoint(str(tmp_path / "vae" / "final"))) == [
        "batch_stats", "params"]
    train_aae(gen, AAETrainConfig(steps=1, batch_size=2, z_dim=16), phys,
              checkpoint_dir=str(tmp_path / "aae"), log_every=0)
    tree = load_checkpoint(str(tmp_path / "aae"))
    assert sorted(tree) == ["config", "dec", "dec_stats", "dz", "enc",
                            "enc_stats"]
    assert tree["config"]["z_dim"] == 16 and "Encoder_0" in tree["enc"]
