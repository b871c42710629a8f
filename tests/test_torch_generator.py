"""The port's generators under the JAX package's weights: the converter of
training/checkpoints.py on the repository's trained Generator256
(checkpoints/gan256/final, read by the port's own checkpoint reader, which
gives the JAX package's orbax loader's tree) and on freshly initialized flax
generators of every size; the .npz tree reader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import models as jmodels
from quantized_spectrum_cartography_tpu.training import (
    load_checkpoint as jax_load_checkpoint,
)
from quantized_spectrum_cartography_tpu_torch import models as tmodels
from quantized_spectrum_cartography_tpu_torch.solvers import (
    make_generator_apply,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    generator_state_dict_from_flax,
    load_checkpoint,
    load_generator,
    load_npz_tree,
)

torch.set_num_threads(1)

CHECKPOINT = "checkpoints/gan256/final"


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def trained():
    return load_checkpoint(CHECKPOINT)


def test_trained_tree_is_jax_tree(trained):
    """The port's reader gives the tree the JAX package's loader gives."""
    ref = dict(_flat(_numpy_tree(jax_load_checkpoint(CHECKPOINT))))
    got = dict(_flat(trained))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _compare(jgen, jvars, tgen, z_dim, scale=1.0):
    Z = np.random.default_rng(0).standard_normal((6, z_dim)).astype(np.float32)
    ref = np.asarray(jgen.apply(jvars, jnp.asarray(Z), train=False))
    with torch.no_grad():
        got = tgen(torch.from_numpy(Z)).numpy()
    assert got.shape == ref.shape == (6, 51, 51, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    apply = make_generator_apply(tgen, scale)
    with torch.no_grad():
        S = apply(torch.from_numpy(Z)).numpy()
    np.testing.assert_allclose(S, ref[..., 0] / scale, rtol=1e-4, atol=1e-5)


def test_trained_generator256_matches_flax(trained):
    """The repository's trained prior: outputs within rtol 1e-4, atol 1e-5
    of flax's, and the checkpoint's output scale carried over."""
    gen, scale = load_generator(trained, 256, "cpu")
    assert scale == float(trained["scale"])
    _compare(jmodels.Generator256(), {"params": trained["params"],
                                      "batch_stats": trained["batch_stats"]},
             gen, 256, scale)


@pytest.mark.parametrize("z_dim", [64, 128, 256, 512])
def test_initialized_generators_match_flax(z_dim):
    """flax `init` variables of every generator size, with batch statistics
    moved off (0, 1) so the running statistics are exercised too."""
    jgen = jmodels.make_generator(z_dim)
    jvars = _numpy_tree(jgen.init(jax.random.PRNGKey(z_dim),
                                  jnp.zeros((1, z_dim)), train=False))
    rng = np.random.default_rng(z_dim)
    for st in jvars["batch_stats"].values():
        st["mean"] = rng.normal(0.0, 0.1, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    tgen = tmodels.make_generator(z_dim)
    sd, scale = generator_state_dict_from_flax(jvars)
    assert scale == 1.0
    tgen.load_state_dict(sd)            # strict: every parameter mapped
    _compare(jgen, jvars, tgen, z_dim)


def test_npz_tree_round_trip(trained, tmp_path):
    """A tree written as an .npz of "/"-joined keys reads back equal."""
    path = tmp_path / "gan256.npz"
    np.savez(path, **dict(_flat(trained)))
    back = load_npz_tree(str(path))
    assert sorted(_flat(back)) and dict(_flat(back)).keys() == dict(
        _flat(trained)).keys()
    for k, v in _flat(trained):
        np.testing.assert_array_equal(dict(_flat(back))[k], v)


def test_seeded_generators_are_reproducible():
    a, b = tmodels.Generator256(seed=3), tmodels.Generator256(seed=3)
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert not a.training
