"""The port's Nasdac, the completion-witness gates, the C polish and
DowJons on unquantized samples against the JAX package's, on the same
inputs: a base-condition problem (51x51, cut to K=16 bands) from the
port's simulator (the harness tests hold it against JAX's), the committed
completion AE (checkpoints/ae_completion/final) and VAE prior
(checkpoints/vae_peak_z256) read by each package's own reader; every
random draw is JAX's, passed in, and JAX's solvers run under jax.jit.

Tolerances: rtol 1e-4 (atol 1e-6 of the largest entry) for closed-form and
fixed-iteration code; the solvers through a network 1e-3 of the largest
entry, because the networks themselves agree to rtol 1e-4 / atol 1e-5
(tests/test_torch_vae.py) and NNLS and Adam carry that through every
step.  Discrete choices are equal: witness peaks, flags, restart winners."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.solvers import vae_prior as jv
from quantized_spectrum_cartography_tpu.training import (
    ae_trainer as jae_trainer,
)
from quantized_spectrum_cartography_tpu.training import (
    load_checkpoint as jax_load,
)
from quantized_spectrum_cartography_tpu_torch.baselines import (
    harness as tharness,
)
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.solvers import completion as tc
from quantized_spectrum_cartography_tpu_torch.solvers import nasdac as tn
from quantized_spectrum_cartography_tpu_torch.solvers import vae_prior as tv
from quantized_spectrum_cartography_tpu_torch.training import (
    ae_trainer as tae,
)

jc = importlib.import_module(
    "quantized_spectrum_cartography_tpu.solvers.completion")
jn = importlib.import_module("quantized_spectrum_cartography_tpu.solvers.nasdac")

torch.set_num_threads(1)

K = 16
AE_CKPT = "checkpoints/ae_completion/final"
VAE_CKPT = "checkpoints/vae_peak_z256"


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


# -- shared inputs ----------------------------------------------------------

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
def trained_ae():
    """(JAX completer, port completer) of the committed completion AE."""
    state = dict(jax_load(AE_CKPT))
    scale = float(state.pop("scale"))
    jfn = jae_trainer.make_ae_completer(jm.Autoencoder(), state, scale)
    model, tscale = tae.load_ae(AE_CKPT, "selu", "cpu")
    assert tscale == scale
    return jax.jit(jfn), tae.make_ae_completer(model, tscale)


# -- witness gates, polish, refinement --------------------------------------

def test_witness_peaks_and_flags_match(hp):
    """Peaks equal; each flag equal to JAX's on a case where it fires (one
    emitter extinguished) and one where it does not; both flags batched."""
    T, T_obs, Om = hp["T_true"], hp["T_obs"], hp["Om"].astype(np.float32)
    S, C = hp["S_true"], hp["C_true"]
    lost = np.einsum("rij,rk->kij", S * np.asarray([[[1.0]], [[0.05]]],
                                                   np.float32), C)
    np.testing.assert_array_equal(
        tn.witness_peaks(t(T), 4).numpy(),
        np.asarray(jn.witness_peaks(jnp.asarray(T), 4)))
    flags, jflags = [], []
    for cur in (T, lost):
        jflags.append((bool(jn.lost_peak_flag(jnp.asarray(cur),
                                              jnp.asarray(T), 4)),
                       bool(jn.witnessed_swap_flag(
                           jnp.asarray(cur), jnp.asarray(T), jnp.asarray(T),
                           jnp.asarray(T_obs), jnp.asarray(Om), 4))))
        flags.append((bool(tn.lost_peak_flag(t(cur), t(T), 4)),
                      bool(tn.witnessed_swap_flag(t(cur), t(T), t(T),
                                                  t(T_obs), t(Om), 4))))
    assert flags == jflags and jflags == [(False, False), (True, True)]
    cur = torch.stack([t(T), t(lost)])
    Tb = torch.stack([t(T), t(T)])
    assert tn.lost_peak_flag(cur, Tb, 4).tolist() == [False, True]
    assert tn.witnessed_swap_flag(cur, Tb, Tb, torch.stack([t(T_obs)] * 2),
                                  torch.stack([t(Om)] * 2),
                                  4).tolist() == [False, True]


def test_anchor_weights_match(hp):
    Om = hp["Om"].astype(np.float32)
    sparse = Om * (np.random.default_rng(8).uniform(size=Om.shape) < 0.3)
    close(tn.distance_to_observed(t(Om)).numpy(),
          jn.distance_to_observed(jnp.asarray(Om)))
    close(tn.anchor_confidence(t(sparse), 3.0).numpy(),
          jn.anchor_confidence(jnp.asarray(sparse), 3.0))
    both = torch.stack([t(Om), t(sparse)])
    got = tn.anchor_weight(both, 0.3, 0.05).numpy()
    for b, W in enumerate((Om, sparse)):
        # at f = 130/2601, just under rho0, 1 - f/rho0 cancels to 4e-4: one
        # ulp of the f32 mean moves the weight by ~2e-8
        np.testing.assert_allclose(
            got[b], jn.anchor_weight(jnp.asarray(W), 0.3, 0.05), rtol=1e-4,
            atol=1e-7)


@pytest.fixture(scope="module")
def polish_inputs(hp):
    """Factors off the truth, the anchored C too high on emitter 0."""
    rng = np.random.default_rng(9)
    S = hp["S_true"] * rng.uniform(0.7, 1.3, hp["S_true"].shape).astype(
        np.float32)
    C_anch = hp["C_true"] * np.asarray([[1.6], [0.9]], np.float32)
    return S, C_anch, hp["T_obs"], hp["Om"].astype(np.float32), hp["T_true"]


def test_polish_and_blend_match(polish_inputs):
    S, C_anch, T_obs, W, T_wit = polish_inputs
    want = jc._polish_c_to_observed(jnp.asarray(S), jnp.asarray(C_anch),
                                    jnp.asarray(T_obs), jnp.asarray(W)[None],
                                    ridge_rel=0.1)
    got = tc._polish_c_to_observed(t(S), t(C_anch), t(T_obs), t(W),
                                   ridge_rel=0.1)
    close(got.numpy(), want)
    pts = np.asarray(jn.witness_peaks(jnp.asarray(T_wit), 4))
    for floor in (0.0, 0.02):
        close(tc.peak_gated_blend(t(S), t(C_anch), got, t(pts), 0.75,
                                  floor).numpy(),
              jc.peak_gated_blend(jnp.asarray(S), jnp.asarray(C_anch), want,
                                  jnp.asarray(pts), 0.75, floor))
    close(tc._constrained_polish_c(t(S), t(C_anch), t(T_obs), t(W), t(pts),
                                   gamma=0.75).numpy(),
          jc._constrained_polish_c(jnp.asarray(S), jnp.asarray(C_anch),
                                   jnp.asarray(T_obs), jnp.asarray(W)[None],
                                   jnp.asarray(pts), gamma=0.75))


@pytest.mark.parametrize("mode", ["blend", "qp"])
def test_gated_polish_matches(polish_inputs, mode):
    """Both modes, one problem and batched (the second problem's mask
    thinned); an unknown mode raises in both packages."""
    S, C_anch, T_obs, W, T_wit = polish_inputs
    W2 = W * (np.random.default_rng(10).uniform(size=W.shape) < 0.5)
    batched = tc.gated_polish_c(
        torch.stack([t(S)] * 2), torch.stack([t(C_anch)] * 2),
        torch.stack([t(T_obs), t(T_obs * W2)]), torch.stack([t(W), t(W2)]),
        torch.stack([t(T_wit)] * 2), 4, gamma=0.75, mode=mode)
    for b, (Wb, Tb) in enumerate(((W, T_obs), (W2, T_obs * W2))):
        want = jc.gated_polish_c(jnp.asarray(S), jnp.asarray(C_anch),
                                 jnp.asarray(Tb), jnp.asarray(Wb)[None],
                                 jnp.asarray(T_wit), 4, gamma=0.75,
                                 mode=mode)
        close(batched[b].numpy(), want, err_msg=f"problem {b}")
    with pytest.raises(ValueError, match="unknown polish mode"):
        tc.gated_polish_c(t(S), t(C_anch), t(T_obs), t(W), t(T_wit), 4,
                          mode="typo")


def test_residual_peak_refine_matches(hp):
    """An estimate with one emitter at a third of its amplitude: the patches
    land where JAX's do and lift the same amounts."""
    S, C = hp["S_true"], hp["C_true"]
    low = np.einsum("rij,rk->kij", S * np.asarray([[[1.0]], [[0.3]]],
                                                  np.float32), C)
    W = hp["Om"].astype(np.float32)
    want = jc.residual_peak_refine(jnp.asarray(low), jnp.asarray(hp["T_obs"]),
                                   jnp.asarray(W), num_patches=3)
    got = tc.residual_peak_refine(t(low), t(hp["T_obs"]), t(W), num_patches=3)
    close(got.numpy(), want)
    assert not np.allclose(np.asarray(want), low)


# -- Nasdac and DowJons under the committed networks -------------------------

NASDAC_CASES = {
    "plain": dict(anchor_mu0=0.0),
    "anchored_blend_conf": dict(anchor_mu0=0.3, anchor_rho0=1.0,
                                polish_ridge=0.1, polish_gamma=0.75,
                                anchor_conf_tau=3.0),
    "anchored_qp": dict(anchor_mu0=0.3, anchor_rho0=1.0, polish_ridge=0.1,
                        polish_gamma=0.75, polish_mode="qp"),
    "anchored_unconstrained": dict(anchor_mu0=0.3, anchor_rho0=1.0,
                                   polish_ridge=0.1),
}


@pytest.mark.parametrize("case", sorted(NASDAC_CASES))
def test_recover_nasdac_matches(hp, trained_ae, case):
    jfn, tfn = trained_ae
    kw = NASDAC_CASES[case]
    want = jax.jit(lambda T, Om: jn.recover_nasdac(
        T, Om, jfn, num_emitters=2, **kw))(jnp.asarray(hp["T_obs"]),
                                           jnp.asarray(hp["Om"]))
    with torch.no_grad():
        got = tn.recover_nasdac(t(hp["T_obs"]), t(hp["Om"]), tfn,
                                num_emitters=2, **kw)
    close(got.aux["S_spa"].numpy(), want.aux["S_spa"])
    for name in ("S", "C", "T_hat"):
        close(getattr(got, name).numpy(), getattr(want, name), rtol=0.0,
              atol_rel=1e-3, err_msg=name)


def jax_dowjons_draws(key, R, z_dim, n_restarts, with_init):
    """recover_dowjons_unquantized's init-fit start and restart starts."""
    fit = (t(jax.random.normal(jax.random.fold_in(key, 17), (R, z_dim)))
           if with_init else None)
    keys = [key] if n_restarts <= 1 else list(jax.random.split(key,
                                                               n_restarts))
    return fit, torch.stack([t(jax.random.normal(k, (R, z_dim)))
                             for k in keys])


DOWJONS_CASES = {
    "spa_init_restarts_anchored": dict(n_restarts=2, init=True, anchor=True),
    "random_start": dict(n_restarts=1, init=False),
}


@pytest.mark.parametrize("case", sorted(DOWJONS_CASES))
def test_recover_dowjons_unquantized_matches(hp, case):
    """Cut depth (outer 2, z steps 2, init fit 3, NNLS 10) under
    vae_peak_z256: the restart winner, factors, T_hat, costs, NMSEs."""
    c = DOWJONS_CASES[case]
    jgen, z_dim, _ = jv.load_vae_prior(VAE_CKPT)
    tgen, tz, _ = tv.load_vae_prior(VAE_CKPT, device="cpu")
    assert tz == z_dim
    R, key = 2, jax.random.PRNGKey(11)
    S_init = hp["S_true"] * 3.0 if c["init"] else None
    kw = dict(num_emitters=R, z_dim=z_dim, outer_iters=2, z_steps_per_iter=2,
              nnls_iters=10, init_steps=3, n_restarts=c["n_restarts"],
              S_init_dense=True, polish_ridge=0.1 if c.get("anchor") else 0.0)
    anchor = hp["T_true"] if c.get("anchor") else None
    want = jit(lambda T, Om, Tt, Si, Ta: jc.recover_dowjons_unquantized(
        key, T, Om, jgen, T_true=Tt, S_init=Si, T_anchor=Ta, **kw),
        hp["T_obs"], hp["Om"], hp["T_true"], S_init, anchor)
    got = tc.recover_dowjons_unquantized(
        t(hp["T_obs"]), t(hp["Om"]), tgen, T_true=t(hp["T_true"]),
        S_init=None if S_init is None else t(S_init),
        T_anchor=None if anchor is None else t(anchor),
        draws=jax_dowjons_draws(key, R, z_dim, c["n_restarts"], c["init"]),
        **kw)
    for name in ("S", "C", "T_hat", "costs", "nmses"):
        close(getattr(got, name).numpy(), getattr(want, name), rtol=0.0,
              atol_rel=1e-3, err_msg=name)
    close(got.aux["Z"].numpy(), want.aux["Z"], rtol=0.0, atol_rel=1e-3)


