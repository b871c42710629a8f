"""The port's single-map latent inversions (init_z, run_onebit_inversion
with its four losses, recover_masked_mse, optimize_z), both amplitude
calibrators, the three completion-AE closures and the AE descents
(run_descent_ae, recover_dowjons_ae, recover_dowjons_ae_latent) against
the JAX package's, on the same inputs: a function-level generator, a
narrow Autoencoder(base_width=4) initialized by flax and mapped by
state_dict_from_flax, and a base-condition problem (51x51, K=16) from the
port's simulator; every random draw is JAX's, passed in, and JAX's
functions run under jax.jit.

Tolerances: rtol 1e-4 (atol 1e-6 of the largest entry) for closed-form and
fixed-iteration code; the AE descents 1e-3 of the largest entry (the
networks agree to rtol 1e-4 / atol 1e-5, tests/test_torch_vae.py, and NNLS
and Adam carry that through every step); the calibrated gains 2e-3, said
where.  Early stops are equal, problem by problem."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops import likelihood as jlik
from quantized_spectrum_cartography_tpu.ops.quantizer import quantize_log
from quantized_spectrum_cartography_tpu.training import (
    ae_trainer as jae_trainer,
)
from quantized_spectrum_cartography_tpu_torch import models as tm
from quantized_spectrum_cartography_tpu_torch.baselines import (
    harness as tharness,
)
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.solvers import calibrate as tcal
from quantized_spectrum_cartography_tpu_torch.solvers import completion as tc
from quantized_spectrum_cartography_tpu_torch.solvers import (
    gan_inversion as tgi,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    ae_trainer as tae,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    state_dict_from_flax,
)

jcal = importlib.import_module(
    "quantized_spectrum_cartography_tpu.solvers.calibrate")
jc = importlib.import_module(
    "quantized_spectrum_cartography_tpu.solvers.completion")
jgi = importlib.import_module(
    "quantized_spectrum_cartography_tpu.solvers.gan_inversion")

torch.set_num_threads(1)

K = 16

def t(x):
    return torch.tensor(np.array(x))


def jit(fn, *arrays):
    """fn(*arrays) compiled as one XLA program (None passes through)."""
    return jax.jit(fn)(*(None if a is None else jnp.asarray(a)
                         for a in arrays))


def close(got, want, rtol=1e-4, atol_rel=1e-6, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def hp():
    """One base-condition example (f=0.05, R=2, K=16), numpy arrays."""
    p = tharness.make_problem(torch.Generator().manual_seed(1),
                              tharness.Condition(), PhysicsConfig(num_bands=K),
                              device="cpu")
    out = {f.name: getattr(p, f.name)[0].numpy()
           for f in dataclasses.fields(p) if f.name != "fraction"}
    return out | {"T_obs": p.T_obs[0].numpy()}


@pytest.fixture(scope="module")
def narrow_ae():
    """A flax Autoencoder(base_width=4), initialized, its batch statistics
    moved off (0, 1), and the same weights in the port's module."""
    jmodel = jm.Autoencoder(base_width=4)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(6), jnp.zeros((1, 51, 51, 2))))
    rng = np.random.default_rng(7)
    for name, stats in variables["batch_stats"]["encoder"].items():
        stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(
            np.float32)
    tmodel = tm.Autoencoder(base_width=4)
    tmodel.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, tmodel, 2.5


def function_generator(I=9, J=9, z_dim=6, seed=0):
    """The same smooth nonnegative map generator in both frameworks."""
    basis = np.random.default_rng(seed).normal(
        size=(z_dim, I * J)).astype(np.float32)

    def jgen(z):
        return jax.nn.softplus(z @ basis).reshape(z.shape[0], I, J) * 0.01

    def tgen(z):
        return torch.nn.functional.softplus(z @ t(basis)).reshape(
            z.shape[0], I, J) * 0.01

    return jgen, tgen


def test_ae_closures_match(narrow_ae):
    jmodel, variables, tmodel, scale = narrow_ae
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(3, 51, 51)) < 0.2).astype(np.float32)
    maps = rng.uniform(0.0, 0.2, (3, 51, 51)).astype(np.float32)
    jfn = jae_trainer.make_ae_completer(jmodel, variables, scale)
    want = jit(jax.vmap(jfn), mask, maps)
    with torch.no_grad():
        got = tae.make_ae_completer(tmodel, scale, chunk=2)(t(mask), t(maps))
    close(got.numpy(), want)

    jenc, jdec = jae_trainer.make_ae_latent_fns(jmodel, variables, scale)
    tenc, tdec = tae.make_ae_latent_fns(tmodel, scale)
    z = np.asarray(jit(jenc, mask[0], maps))
    with torch.no_grad():
        close(tenc(t(mask[0]), t(maps)).numpy(), z, atol_rel=1e-5)
        close(tdec(t(z)).numpy(), jit(jdec, z))

    x = np.stack([mask, maps * scale], -1)                 # [3, 51, 51, 2]
    jin = jae_trainer.make_ae_input_fn(jmodel, variables, scale)
    with torch.no_grad():
        close(tae.make_ae_input_fn(tmodel, scale)(t(x)).numpy(),
              jit(jin, x))


def jax_inversion_draws(key, z_dim, num_global, num_local):
    """init_z / run_onebit_inversion's z0 and search normals."""
    k0, ks = jax.random.split(key)
    k1, k2 = jax.random.split(ks)
    return (t(jax.random.normal(k0, (1, z_dim))),
            (t(jax.random.normal(k1, (num_global, 1, z_dim))),
             t(jax.random.normal(k2, (num_local, 1, z_dim)))))


def test_init_z_matches():
    jgen, tgen = function_generator()
    target = np.asarray(jgen(jax.random.normal(jax.random.PRNGKey(2),
                                               (1, 6))))[0]
    key = jax.random.PRNGKey(3)
    kw = dict(z_dim=6, num_global=12, num_local=6, adam_steps=5, lr=0.05)
    want = jit(lambda tg: jgi.init_z(key, jgen, tg, **kw), target)
    got = tgi.init_z(tgen, t(target), draws=jax_inversion_draws(
        key, 6, 12, 6), **kw)
    close(got.numpy(), want)


@pytest.mark.parametrize("loss", ["bce", "probit", "balevi", "balevi-nuc"])
def test_run_onebit_inversion_matches(loss):
    """All four losses, masked, from JAX's draws: map, z and losses."""
    jgen, tgen = function_generator()
    rng = np.random.default_rng(4)
    S_true = np.asarray(jgen(jnp.asarray(rng.normal(size=(1, 6)),
                                         jnp.float32)))[0]
    mean = float(np.median(S_true))
    y01 = (S_true > mean).astype(np.float32)
    y = y01 if loss in ("bce", "probit") else 2.0 * y01 - 1.0
    mask = (rng.uniform(size=S_true.shape) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(loss_criterion=loss, std=0.002, z_dim=6, num_global=12,
              num_local=6, adam_steps=5, lr=0.05)
    want = jit(lambda yy, m: jgi.run_onebit_inversion(key, jgen, yy, mean,
                                                      mask=m, **kw), y, mask)
    got = tgi.run_onebit_inversion(tgen, t(y), mean, mask=t(mask),
                                   draws=jax_inversion_draws(key, 6, 12, 6),
                                   **kw)
    for name, a, b in zip(("S", "z", "losses"), got, want):
        close(a.numpy(), b, err_msg=name)


@pytest.fixture(scope="module")
def calib_problem():
    rng = np.random.default_rng(6)
    S = rng.uniform(0.0, 0.3, (2, 9, 9)).astype(np.float32)
    C = rng.uniform(0.1, 1.0, (2, K)).astype(np.float32)
    T = np.einsum("rij,rk->kij", S, C)
    bb = np.asarray(jbnd.QUANTIZATION_BOUNDARIES_8_BINS_LOG, np.float32)
    Y = np.asarray(quantize_log(jax.random.PRNGKey(7), jnp.asarray(T), 1.0,
                                jnp.asarray(bb), jbnd.LOG_OFFSET_4))
    mask = (rng.uniform(size=T.shape) < 0.5).astype(np.float32)
    return S, C, T, Y, bb, mask


@pytest.mark.parametrize("linear", [False, True])
def test_recalibrate_gain_matches(calib_problem, linear):
    """The grid's argmin and the golden-section refinement, the log link on
    a shrunken estimate and the linear link."""
    S, C, T, Y, bb, mask = calib_problem
    T_hat = 0.3 * T if not linear else 0.3 * np.log(T + jbnd.LOG_OFFSET_4)
    args = (bb, 1.0, jbnd.LOG_OFFSET_4)
    g, Tg = jit(lambda th, yy, m: jcal.recalibrate_gain(
        th, yy, *args, mask=m, linear=linear), T_hat, Y, mask)
    tg, tTg = tcal.recalibrate_gain(t(T_hat), t(Y), *args, mask=t(mask),
                                    linear=linear)
    # each refinement step compares two f32 sums of the NLL; near the
    # optimum the NLL is flat to their rounding, so a step may keep the
    # other side: the gains agree to 2e-3 and are equally good (NLL 1e-6)
    close(tg.numpy(), g, rtol=2e-3)
    close(tTg.numpy(), Tg, rtol=2e-3)

    def nll(gain):
        x = gain * T_hat if linear else np.log(gain * T_hat
                                               + jbnd.LOG_OFFSET_4)
        return float(jlik.masked_nll(jlik.log_prob_probit(
            jnp.asarray(Y), jnp.asarray(x, jnp.float32), jnp.asarray(bb),
            1.0), jnp.asarray(mask)))

    np.testing.assert_allclose(nll(float(tg)), nll(float(g)), rtol=1e-6)


def test_recalibrate_gains_per_emitter_matches(calib_problem):
    S, C, T, Y, bb, mask = calib_problem
    S_hat = S * np.asarray([[[0.3]], [[0.8]]], np.float32)
    args = (bb, 1.0, jbnd.LOG_OFFSET_4)
    g, Tg = jit(lambda sh, c, yy, m: jcal.recalibrate_gains_per_emitter(
        sh, c, yy, *args, mask=m, steps=30), S_hat, C, Y, mask)
    tg, tTg = tcal.recalibrate_gains_per_emitter(
        t(S_hat), t(C), t(Y), *args, mask=t(mask), steps=30)
    # Adam starts from the global gain, equal to 2e-3 (see above)
    close(tg.numpy(), g, rtol=2e-3)
    close(tTg.numpy(), Tg, rtol=2e-3)


def test_masked_mse_and_optimize_z_match():
    jgen, tgen = function_generator()
    rng = np.random.default_rng(12)
    target = np.asarray(jgen(jnp.asarray(rng.normal(size=(2, 6)),
                                         jnp.float32)))
    mask = (rng.uniform(size=target.shape[1:]) < 0.5).astype(np.float32)
    key = jax.random.PRNGKey(13)
    k0, ks = jax.random.split(key)
    k1, k2 = jax.random.split(ks)
    draws = (t(jax.random.normal(k0, (2, 6))),
             (t(jax.random.normal(k1, (12, 2, 6))),
              t(jax.random.normal(k2, (6, 2, 6)))))
    kw = dict(z_dim=6, num_emitters=2, num_global=12, num_local=6,
              adam_steps=5, lr=0.05)
    want = jit(lambda m, tg: jc.recover_masked_mse(key, jgen, m, tg, **kw),
               mask, target)
    got = tc.recover_masked_mse(tgen, t(mask), t(target), draws=draws, **kw)
    for name, a, b in zip(("S", "z", "losses"), got, want):
        close(a.numpy(), b, err_msg=name)
    z0 = rng.normal(size=(2, 6)).astype(np.float32)
    want = jit(lambda tg, m, z: jc.optimize_z(key, jgen, tg, m, z,
                                              adam_steps=7, lr=0.05),
               target, mask, z0)
    got = tc.optimize_z(tgen, t(target), t(mask), t(z0), adam_steps=7,
                        lr=0.05)
    for a, b in zip(got, want):
        close(a.numpy(), b)


def test_ae_descents_match(hp, narrow_ae):
    """run_descent_ae (early stop problem by problem), recover_dowjons_ae
    and recover_dowjons_ae_latent through the narrow AE, cut depth."""
    jmodel, variables, tmodel, scale = narrow_ae
    jin = jae_trainer.make_ae_input_fn(jmodel, variables, scale)
    tin = tae.make_ae_input_fn(tmodel, scale)
    T_obs, Om = hp["T_obs"], hp["Om"]
    W = Om.astype(np.float32)
    x0 = np.stack([np.broadcast_to(W, (2, 51, 51)),
                   hp["S_true"] * scale], -1).astype(np.float32)
    C = hp["C_true"]
    for tol, iters in ((1e-5, 8), (1e3, 6)):  # runs on / stops at min_iters
        want = jit(lambda x, c, T, w: jc.run_descent_ae(
            jin, x, c, T, w[None], lr=0.01, max_iters=8, tol=tol),
            x0, C, T_obs, W)
        got = tc.run_descent_ae(tin, t(x0), t(C), t(T_obs), t(W), lr=0.01,
                                max_iters=8, tol=tol)
        assert int(got[2]) == int(want[2]) == iters
        for a, b in zip((got[0], got[1], got[3]),
                        (want[0], want[1], want[3])):
            close(a.detach().numpy(), b, rtol=0.0, atol_rel=1e-3)
    # batched: the second problem (C = 0, a constant cost) stops at
    # min_iters and stays frozen while the first runs on
    x0s, Ws = torch.stack([t(x0)] * 2), torch.stack([t(W)] * 2)
    got = tc.run_descent_ae(tin, x0s, torch.stack([t(C), 0.0 * t(C)]),
                            torch.stack([t(T_obs)] * 2), Ws, max_iters=8,
                            tol=1e-5)
    assert got[2].tolist() == [8, 6]
    one = tc.run_descent_ae(tin, t(x0), t(C), t(T_obs), t(W), max_iters=8,
                            tol=1e-5)
    close(got[0][0].numpy(), one[0].numpy())
    torch.testing.assert_close(got[0][1], x0s[1], rtol=0, atol=0)

    kw = dict(num_emitters=2, outer_iters=2, nnls_iters=10)
    want = jit(lambda T, om, tt: jc.recover_dowjons_ae(T, om, jin, T_true=tt,
                                                       **kw),
               T_obs, Om, hp["T_true"])
    got = tc.recover_dowjons_ae(t(T_obs), t(Om), tin,
                                T_true=t(hp["T_true"]), **kw)
    for name in ("S", "C", "T_hat", "costs", "nmses"):
        close(getattr(got, name).detach().numpy(), getattr(want, name),
              rtol=0.0, atol_rel=1e-3, err_msg=f"dowjons_ae {name}")

    jenc, jdec = jae_trainer.make_ae_latent_fns(jmodel, variables, scale)
    tenc, tdec = tae.make_ae_latent_fns(tmodel, scale)
    kw = dict(num_emitters=2, outer_iters=2, z_steps=3, nnls_iters=10,
              polish_ridge=0.1)
    want = jit(lambda T, om, tt: jc.recover_dowjons_ae_latent(
        T, om, jenc, jdec, T_true=tt, T_anchor=tt, **kw),
        T_obs, Om, hp["T_true"])
    got = tc.recover_dowjons_ae_latent(
        t(T_obs), t(Om), tenc, tdec, T_true=t(hp["T_true"]),
        T_anchor=t(hp["T_true"]), **kw)
    for name in ("S", "C", "T_hat", "costs", "nmses"):
        close(getattr(got, name).detach().numpy(), getattr(want, name),
              rtol=0.0, atol_rel=1e-3, err_msg=f"dowjons_ae_latent {name}")
