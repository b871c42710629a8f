"""Support of the port's training tests (no tests of its own): the random
numbers the JAX package draws, as the port's ``draws=`` (for a key that a
JAX function splits in a known way, the same uniforms and normals in the
structures of ``data.datasets`` and the trainers), and the comparisons of
a port trainer with a JAX one.

Tolerances.  The first step's gradients are the port's loss (the function
its step calls) on JAX's batch and weights, against the gradient JAX's
step handed its optimizer: within GRAD_RTOL of each tensor's largest
|entry| plus GRAD_RTOL of the whole gradient's (a bias in front of a
train-mode BatchNorm has a gradient of rounding noise).  A loss on the
initial weights within FIRST_RTOL.  Past that, the two runs part by
rounding: the simulator's maps differ by ~1e-6 relative (a 2601-term
shadowing sum in another order), and at these widths that moves some
pre-activation across a ReLU / LeakyReLU / SELU kink, which changes a
few layers' gradients by percents; and Adam moves a weight by about lr a
step whatever the size of its gradient, so an entry whose gradient is
small or rounding noise moves up to 2 lr apart a step (|m_hat| /
sqrt(v_hat) reaches 1.13 at b1 = 0.5).  So later steps' losses within
LOSS_RTOL; after three steps every weight within W_ATOL_LR x lr, the
median entry within lr / 10 and nine in ten within lr / 2; BatchNorm
running statistics, which follow the weights, within STATS_TOL.  The GAN's
and the AAE's running statistics after the first step come from forwards
of the initial weights on the same batch: within TOL.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    MaskDraws,
    SLFDraws,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_state_dict,
)

B, STEPS = 4, 3
FIRST_RTOL, LOSS_RTOL = 1e-5, 5e-3
GRAD_RTOL = 1e-4
W_ATOL_LR = 7.0
STATS_TOL = dict(rtol=5e-2, atol=5e-3)
TOL = dict(rtol=1e-4, atol=1e-6)
PHYS = dict(decorrelation_distance=30.0)      # as tests/test_training.py


def t(x):
    return torch.tensor(np.array(x))


def slf_draws(key, n, grid=51):
    """The draws of JAX ``make_slf_sampler(...)(key, n)``: one key per
    map, each split into (location, exponent, shadowing) keys
    (physics/simulator.py:sample_slf)."""

    def one(k):
        k_loc, k_alpha, k_shadow = jax.random.split(k, 3)
        return (jax.random.uniform(k_loc, (2,)),
                jax.random.uniform(k_alpha, ()),
                jax.random.normal(k_shadow, (grid * grid,),
                                  dtype=jnp.float32))

    loc, alpha, shadow = jax.vmap(one)(jax.random.split(key, n))
    return SLFDraws(t(loc), t(alpha), t(shadow))


def mask_draws(key, shape):
    """The draws of JAX ``mask_batch(key, maps [B, I, J], cfg)``."""
    k_rate, k_mask = jax.random.split(key)
    return MaskDraws(t(jax.random.uniform(k_rate, (shape[0], 1, 1))[:, 0, 0]),
                     t(jax.random.uniform(k_mask, shape)))


def band_draws(key, n, R):
    """The draws of JAX ``train_ae``'s band_sampler(key, n)."""
    ka, kb = jax.random.split(key)
    return (slf_draws(ka, n * R),
            t(jax.random.normal(kb, (n, R, 1, 1))[..., 0, 0]))


def normal(key, shape):
    return t(jax.random.normal(key, shape))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_tree_close(got, want, what, **tol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=f"{what} {k}", **tol)


def assert_weights_close(got, want, what, lr):
    """Every entry within W_ATOL_LR x lr, the median within lr / 10, nine
    in ten within lr / 2."""
    assert_tree_close(got, want, what, rtol=0, atol=W_ATOL_LR * lr)
    want = dict(leaves(want))
    diffs = np.concatenate([np.abs(a - want[k]).ravel()
                            for k, a in leaves(got)])
    median, p90 = np.quantile(diffs, [0.5, 0.9])
    assert median <= lr / 10 and p90 <= lr / 2, (what, median / lr,
                                                 p90 / lr)


def assert_losses(got, want, name=""):
    """Per-step losses: the first step's within FIRST_RTOL, later ones
    within LOSS_RTOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[:1], want[:1], rtol=FIRST_RTOL,
                               err_msg=name)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=name)


def assert_grads_close(named_grads, want):
    """named_grads: {name: .grad}; want: the same names from JAX."""
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in named_grads.items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * (np.abs(w).max() + scale), (name, err)


def grads_of(module):
    return {n: p.grad for n, p in module.named_parameters()}


def nchw(x):
    return t(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def recording(opt, store):
    """`opt` that also records what it is given: store["init"] the initial
    parameters, store["grads"] each update's gradients."""

    def init(params):
        store["init"] = jax.tree.map(np.asarray, params)
        return opt.init(params)

    def update(g, state, params=None):
        jax.debug.callback(
            lambda g: store.setdefault("grads", []).append(
                jax.tree.map(np.asarray, g)), g)
        return opt.update(g, state, params)

    return optax.GradientTransformation(init, update)


def recording_optax(store):
    """The `optax` module with `adam` recording into `store`."""
    return types.SimpleNamespace(
        exponential_decay=optax.exponential_decay,
        apply_updates=optax.apply_updates,
        adam=lambda *a, **kw: recording(optax.adam(*a, **kw), store))


def stats_tree(module):
    """The flax batch_stats tree of a port module as it stands."""
    return flax_from_state_dict(module.state_dict())["batch_stats"]


def step_keys(key, steps=STEPS):
    """The per-step keys of JAX's train_ae / train_vae after their init
    key: `key, k = split(key)` each step."""
    _, key = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(k)
    return out
