"""The port's deep-image-prior decoder and solvers against the JAX
package's on the same weights and draws: `DecoderDip` in train mode
(outputs and moved running statistics), `recover_dip` and
`recover_dip_tensor` fed JAX's z, initial weights (through
`training.checkpoints.state_dict_from_flax`, leaf [r] of the vmapped tree
for instance r), C0 and validation mask; and the mechanics checks of the
JAX suite (tests/test_gan_solvers.py) on the port alone.

Tolerances.  The first update's gradients agree to about 1e-5 of their
largest entry (the biases in front of a train-mode BatchNorm have
gradients of rounding noise; flax's BatchNorm takes the variance as
E[x^2] - E[x]^2, the port's in two passes), so the loss and NMSE that
follow the first update agree within FIRST_RTOL.  Past that the runs part
by rounding: a pre-activation on one side of a SELU kink, or a gradient of
rounding noise, moves a weight by up to about lr a step apart (Adam), and
the decoders' maps follow.  Measured after ten steps (holdout + cosine /
output EMA): losses within 1.8e-5 / 1.6e-4, NMSEs 3.3e-5 / 4.1e-4, C
within 7.8e-7 / 1.2e-5 of its largest entry, S within 0.034 / 0.116 of
its largest entry (median 0.0018 / 0.011), T_ema 0.019; JAX against
itself with `mean` one ULP up parts by 0.002 in S over the same ten steps.
So the ten-step losses within LOSS_RTOL, NMSEs within NMSE_RTOL, C within
C_RTOL, S within S_ATOL (its median within S_MEDIAN) and T_ema within
T_EMA_ATOL, each of the largest |entry|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.models import DecoderDip as JDecoderDip
from quantized_spectrum_cartography_tpu.solvers import (
    recover_dip as jax_recover_dip,
    recover_dip_tensor as jax_recover_dip_tensor,
)
from quantized_spectrum_cartography_tpu_torch.models import DecoderDip
from quantized_spectrum_cartography_tpu_torch.solvers import (
    recover_dip,
    recover_dip_tensor,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    flax_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(1)

Z_DIM, K, I, STEPS = 64, 8, 51, 10
MEAN, STD = 0.01, 0.05
FIRST_RTOL, LOSS_RTOL, NMSE_RTOL, C_RTOL = 1e-5, 5e-4, 1e-3, 1e-3
S_ATOL, S_MEDIAN, T_EMA_ATOL = 0.15, 0.02, 0.03
STATIC_TENSOR = ("mean", "std", "num_emitters", "steps", "z_dim",
                 "holdout_frac", "l2_c", "val_ema_decay", "lr_schedule",
                 "out_ema_decay")
STATIC = ("mean", "std", "onebit", "steps", "z_dim")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _decoder(tree, instance=None):
    dec = DecoderDip(Z_DIM)
    dec.load_state_dict(state_dict_from_flax(tree, instance=instance))
    return dec.train()


def _close(got, ref, atol, median=None):
    """|got - ref| within atol (and its median within `median`) of the
    largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol * scale)
    if median is not None:
        assert np.median(np.abs(got - ref)) <= median * scale


def _trajectories(losses, nmses, losses0, nmses0):
    losses0, nmses0 = np.asarray(losses0), np.asarray(nmses0)
    np.testing.assert_allclose(losses.numpy()[:2], losses0[:2],
                               rtol=FIRST_RTOL)
    np.testing.assert_allclose(nmses.numpy()[:1], nmses0[:1],
                               rtol=FIRST_RTOL)
    np.testing.assert_allclose(losses.numpy(), losses0, rtol=LOSS_RTOL)
    np.testing.assert_allclose(nmses.numpy(), nmses0, rtol=NMSE_RTOL)


def test_decoder_dip_train_mode_matches_flax():
    """Three z's in one train-mode batch: the map and the moved running
    statistics of every BatchNorm, rtol 1e-5; the tree maps back."""
    model = JDecoderDip(z_dim=Z_DIM)
    z = np.random.default_rng(0).standard_normal((3, Z_DIM)).astype(
        np.float32)
    variables = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(z)))
    ref, mut = jax.jit(lambda v, z: model.apply(
        v, z, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(z))
    dec = _decoder(variables)
    with torch.no_grad():
        got = dec(torch.from_numpy(z)).numpy()
    assert got.shape == (3, 51, 51, 1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    back = flax_from_state_dict(dec.state_dict())
    for name, stats in _np_tree(mut["batch_stats"]).items():
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(back["batch_stats"][name][leaf],
                                       stats[leaf], rtol=1e-5, atol=1e-7)
    for name, p in variables["params"].items():
        for leaf, value in p.items():
            np.testing.assert_array_equal(back["params"][name][leaf], value)


def _problem():
    S_true = jax.random.uniform(jax.random.PRNGKey(1), (2, I, I)) * 0.1
    C_true = jax.random.uniform(jax.random.PRNGKey(2), (2, K))
    T_true = jnp.einsum("rij,rk->kij", S_true, C_true)
    return np.array((T_true > MEAN).astype(jnp.float32)), np.array(T_true)


@functools.lru_cache(maxsize=None)
def _jax_init(seed, R, K):
    """zs, the vmapped decoders' variables and C0 that
    `recover_dip_tensor` draws from PRNGKey(seed), in its order."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    kz, kp, kc = jax.random.split(key, 3)
    zs = jax.random.normal(kz, (R, 1, Z_DIM))
    model = JDecoderDip(z_dim=Z_DIM)
    variables = _np_tree(jax.jit(jax.vmap(
        lambda k, z: model.init(k, z, train=True)))(
            jax.random.split(kp, R), zs))
    C0 = np.array(0.01 * jax.random.uniform(kc, (R, K)))
    return np.array(zs), variables, C0


def _jax_draws(seed, R, shape, holdout_frac):
    """The draws of `recover_dip_tensor(PRNGKey(seed), ...)`: the
    validation mask (None without a holdout) and `_jax_init`'s."""
    _, kh = jax.random.split(jax.random.PRNGKey(seed))
    val_mask = (np.asarray(jax.random.bernoulli(kh, holdout_frac, shape),
                           np.float32) if holdout_frac > 0 else None)
    return (val_mask,) + _jax_init(seed, R, shape[0])


def test_vmapped_tree_maps_both_ways():
    """Instance r of JAX's vmapped init is leaf [r] of every leaf; the
    instances' state_dicts stack back into the same tree, bit for bit."""
    _, variables, _ = _jax_init(0, 2, K)
    back = flax_from_state_dict([_decoder(variables, r).state_dict()
                                 for r in range(2)])
    for col in ("params", "batch_stats"):
        flat = jax.tree_util.tree_leaves_with_path(variables[col])
        for path, leaf in flat:
            node = back[col]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, leaf)


@pytest.mark.parametrize("kw", [
    dict(holdout_frac=0.05, lr_schedule="cosine", l2_c=0.03),
    dict(holdout_frac=0.0, out_ema_decay=0.9),
], ids=["holdout_cosine", "out_ema"])
def test_recover_dip_tensor_matches_jax(kw):
    """Losses, NMSEs, the returned S and C (the best-EMA iterate with a
    holdout), holdout_best, final_fit and T_ema against JAX's."""
    y01, T_true = _problem()
    key = jax.random.PRNGKey(0)
    ref = jax.jit(jax_recover_dip_tensor, static_argnames=STATIC_TENSOR)(
        key, jnp.asarray(y01), mean=MEAN, std=STD, num_emitters=2,
        steps=STEPS, z_dim=Z_DIM, T_true=jnp.asarray(T_true), **kw)
    val_mask, zs, variables, C0 = _jax_draws(0, 2, y01.shape,
                                             kw["holdout_frac"])
    got = recover_dip_tensor(
        None, torch.from_numpy(y01), MEAN, STD, num_emitters=2, steps=STEPS,
        z_dim=Z_DIM, T_true=torch.from_numpy(T_true),
        val_mask=None if val_mask is None else torch.from_numpy(val_mask),
        init=(torch.from_numpy(zs),
              [_decoder(variables, r) for r in range(2)],
              torch.from_numpy(C0)), **kw)
    S, C, losses, nmses, aux = got
    S0, C0_, losses0, nmses0, aux0 = ref
    _trajectories(losses, nmses, losses0, nmses0)
    _close(S.numpy(), S0, S_ATOL, S_MEDIAN)
    _close(C.numpy(), C0_, C_RTOL)
    assert (C >= 0).all()
    np.testing.assert_allclose(float(aux["final_fit"]),
                               float(aux0["final_fit"]), rtol=LOSS_RTOL)
    hb, hb0 = float(aux["holdout_best"]), float(aux0["holdout_best"])
    if np.isinf(hb0):
        assert np.isinf(hb)
    else:
        np.testing.assert_allclose(hb, hb0, rtol=LOSS_RTOL)
    assert ("T_ema" in aux) == ("T_ema" in aux0)
    if "T_ema" in aux0:
        _close(aux["T_ema"].numpy(), aux0["T_ema"], T_EMA_ATOL)


def test_recover_dip_matches_jax():
    """The single-SLF solver, 1-bit with a mask: losses, NMSEs and S."""
    rng = np.random.default_rng(3)
    S_true = rng.uniform(size=(I, I)).astype(np.float32)
    y01 = (S_true > 0.5).astype(np.float32)
    mask = (rng.uniform(size=(I, I)) < 0.3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    S0, losses0, nmses0 = jax.jit(jax_recover_dip, static_argnames=STATIC)(
        key, jnp.asarray(y01), jnp.asarray(mask), mean=0.5, std=0.1,
        steps=STEPS, z_dim=Z_DIM, slf_true=jnp.asarray(S_true))
    kz, kp = jax.random.split(key)
    z = jax.random.normal(kz, (1, Z_DIM))
    variables = _np_tree(jax.jit(JDecoderDip(z_dim=Z_DIM).init)(kp, z))
    S, losses, nmses = recover_dip(
        None, torch.from_numpy(y01), torch.from_numpy(mask), mean=0.5,
        std=0.1, steps=STEPS, z_dim=Z_DIM, slf_true=torch.from_numpy(S_true),
        init=(torch.from_numpy(np.array(z)), _decoder(variables)))
    _trajectories(losses, nmses, losses0, nmses0)
    _close(S.numpy(), S0, S_ATOL, S_MEDIAN)


# the JAX suite's mechanics checks (tests/test_gan_solvers.py), on the port

def _port_problem():
    y01, T_true = _problem()
    return torch.from_numpy(y01), torch.from_numpy(T_true)


def test_dip_recovery_smoke():
    gen = torch.Generator().manual_seed(0)
    S_true = torch.rand(51, 51, generator=gen)
    y01 = (S_true > 0.5).float()
    S_hat, losses, _ = recover_dip(gen, y01, mask=None, mean=0.5, std=0.1,
                                   steps=5, z_dim=Z_DIM)
    assert S_hat.shape == (51, 51)
    assert torch.isfinite(losses).all()


def test_dip_tensor_recovery_mechanics():
    """Shapes, finite losses, the likelihood decreasing, C >= 0, a finite
    holdout score and final fit."""
    y01, T_true = _port_problem()
    S_hat, C_hat, losses, _, aux = recover_dip_tensor(
        torch.Generator().manual_seed(0), y01, mean=MEAN, std=STD,
        num_emitters=2, steps=30, z_dim=Z_DIM, T_true=T_true)
    assert S_hat.shape == (2, I, I) and C_hat.shape == (2, K)
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
    assert (C_hat >= 0).all()
    assert np.isfinite(float(aux["holdout_best"]))
    assert np.isfinite(float(aux["final_fit"]))


def test_dip_output_ema_tracks_reconstruction():
    """T_ema is finite, of the observations' shape, in the output's range."""
    y01, T_true = _port_problem()
    S_hat, C_hat, _, _, aux = recover_dip_tensor(
        torch.Generator().manual_seed(0), y01, mean=MEAN, std=STD,
        num_emitters=2, steps=40, z_dim=Z_DIM, T_true=T_true,
        out_ema_decay=0.9)
    T_ema = aux["T_ema"]
    assert T_ema.shape == y01.shape and torch.isfinite(T_ema).all()
    T_fin = torch.einsum("rij,rk->kij", S_hat, C_hat)
    assert T_ema.max() <= max(T_fin.max().item() * 3.0, 1.0)
