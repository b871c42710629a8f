"""The port's architecture-dict builders against the JAX package's: the
shape walks and their InvalidArchitectureError, and `GANEncoder`,
`DictEncoder` and `DictDiscriminator` forward in train and eval mode on the
same weights (through `training.checkpoints.state_dict_from_flax`, which
also maps them back).  The encoders' Dense reads flax's NHWC flatten."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.models import builders as jb
from quantized_spectrum_cartography_tpu_torch.models import builders as tb
from quantized_spectrum_cartography_tpu_torch.training import (
    flax_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(1)

SMALL = {"conv_layers": 3, "conv_channels": [4, 6, 8],
         "conv_kernel_sizes": [(3, 3), (4, 4), (3, 2)],
         "conv_strides": [(1, 1), (2, 2), (2, 1)],
         "conv_paddings": [(1, 1), (1, 1), (0, 1)],
         "z_dimension": 16}
COLLAPSING = dict(SMALL, conv_kernel_sizes=[(3, 3), (4, 4), (40, 3)])


@pytest.mark.parametrize("arch,hw", [(SMALL, (51, 51)), (SMALL, (20, 13)),
                                     (jb.GANEncoder().arch, (51, 51))],
                         ids=["small", "small_20x13", "gan_encoder"])
def test_shape_walk_matches_jax(arch, hw):
    assert tb.trace_encoder_shapes(arch, hw) == jb.trace_encoder_shapes(
        arch, hw)
    assert tb.conv_output_shape(hw, (4, 3), (2, 1), (1, 0)) == \
        jb.conv_output_shape(hw, (4, 3), (2, 1), (1, 0))


def test_invalid_architecture_raises_as_jax():
    with pytest.raises(jb.InvalidArchitectureError) as jerr:
        jb.trace_encoder_shapes(COLLAPSING)
    with pytest.raises(tb.InvalidArchitectureError) as terr:
        tb.trace_encoder_shapes(COLLAPSING)
    assert str(terr.value) == str(jerr.value)
    assert issubclass(tb.InvalidArchitectureError, ValueError)
    with pytest.raises(tb.InvalidArchitectureError):
        tb.DictEncoder(COLLAPSING)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["gan_encoder", "dict_encoder"])
def test_encoders_match_flax(which, train):
    """Outputs (and in train mode the moved running statistics) within
    rtol 1e-4 / atol 1e-5 on a batch of four maps."""
    jmod, tmod = ((jb.GANEncoder(), tb.GANEncoder()) if which == "gan_encoder"
                  else (jb.DictEncoder(SMALL), tb.DictEncoder(SMALL)))
    x = np.random.default_rng(1).uniform(size=(4, 51, 51, 1)).astype(
        np.float32)
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    if train:
        ref, mut = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        ref = jax.jit(lambda v, x: jmod.apply(v, x))(variables, x)
    tmod.load_state_dict(state_dict_from_flax(variables))
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    back = flax_from_state_dict(tmod.state_dict())
    if train:
        for name, stats in _np_tree(mut["batch_stats"]).items():
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(back["batch_stats"][name][leaf],
                                           stats[leaf], rtol=1e-4, atol=1e-6)
    else:
        for name, p in variables["params"].items():
            for leaf, value in p.items():
                np.testing.assert_array_equal(back["params"][name][leaf],
                                              value)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_dict_discriminator_matches_flax(num_layers):
    jmod = jb.DictDiscriminator(z_dimension=16, num_layers=num_layers)
    z = np.random.default_rng(2).standard_normal((5, 16)).astype(np.float32)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(3), jnp.asarray(z)))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(z)))
    tmod = tb.DictDiscriminator(16, num_layers)
    tmod.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = tmod(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (5, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
