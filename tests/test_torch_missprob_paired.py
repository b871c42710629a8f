"""DowJons of the port against the JAX package's on the same problems and
the same random draws, at the miss protocol's configuration
(`tools/missprob_tpu.py` CONFIG: checkpoints/vae_peak_z256, the AE
completer, polish ridge 0.1 / gamma 0.75 / 2 extra peaks, backstop 0.5, 2
residual patches, 4 restarts of 20 z-steps, NNLS 100), K=64.

The problems are JAX's: `BatchedHarness._problem_gen` at the protocol's
keys (seed 0, the condition index of each rho), method keys folded with
crc32("dowjons") as JAX's harness folds them.  JAX's method runs vmapped
under jax.jit, as in its harness; the port's takes JAX's restart and fit
draws through `draws=`.  Both outputs go through the detection rule of
`joint_opt_ae.m:514-544` (`detection_counts`), example by example.

- `test_paired_events_tier1`: 4 examples at rho 10% and 1%, the outer
  iterations cut from 30 to TIER1_ITERS: equal per-example events, and
  T_hat within 2e-3 of the largest entry (tests/test_torch_methods.py's
  end-to-end tolerance) except where one of two discrete choices, each
  checked to be a tie that rounding decides, went the other way.
- `test_paired_events_port_misses` (slow): the problems where the port's
  dowjons missed on the card in the five draws of MISSPROB_TORCH.json at
  rho 7.5% and 10% (`missprob.py --missed-from`, an npz under
  build/missprob/), each run with REPLAY_KEYS of JAX's draws through both
  packages' dowjons and nasdac at full depth, with JAX's nasdac in a
  second XLA program as the control.
- `test_paired_events_full_depth` (slow: minutes of CPU time on each side):
  FULL_EXAMPLES examples at 30 outer iterations.  It writes, per rho, the
  examples whose miss events differ in each direction, McNemar's exact p
  on the per-(emitter, band) events, each stage's relative difference
  (chained, and each cheap stage on JAX's input) and the paired final fits,
  to build/missprob_paired/; JAX's method against JAX's own stage
  composition (the same math under another XLA program) is the control
  for how far rounding alone moves a chaotic 600-step descent.
"""

import dataclasses
import functools
import json
import math
import os
import time
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.baselines import harness as jh
from quantized_spectrum_cartography_tpu.baselines import (
    load_pretrained_methods as jax_methods,
)
from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.physics.shadowing import (
    correlation_cholesky,
)
from quantized_spectrum_cartography_tpu_torch.baselines import harness as th
from quantized_spectrum_cartography_tpu_torch.baselines import (
    load_pretrained_methods as port_methods,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import (
    detection_counts,
)

torch.set_num_threads(int(os.environ.get("QSC_PAIRED_THREADS", "2")))

ROOT = Path(__file__).resolve().parents[1]
# tools/missprob_tpu.py CONFIG (dowjons_iters set per case)
PROTOCOL = dict(dowjons_restarts=4, polish_ridge=0.1, polish_gamma=0.75,
                polish_peaks_extra=2, backstop_frac=0.5, peak_refine=2)
PROTOCOL_RHOS = (0.01, 0.025, 0.05, 0.075, 0.10)
RHOS = (0.10, 0.01)
TIER1_EXAMPLES, TIER1_ITERS = 4, 1
FULL_EXAMPLES, FULL_ITERS = 32, 30
ATOL_REL = 2e-3
SPA_TIE = 1e-6                  # relative score gap: 8 float32 ulps
SPA_SAME = 1e-5                 # JAX's SPA factor at the port's picks
Z_DIM = 256                     # checkpoints/vae_peak_z256
OUT_DIR = ROOT / "build" / "missprob_paired"
MISSED = ROOT / "build" / "missprob" / "missed_dowjons.npz"
REPLAY_KEYS = 4


def t(x):
    return torch.tensor(np.array(x))


@functools.lru_cache(maxsize=None)
def _cholesky():
    return jnp.asarray(correlation_cholesky(JPhys().grid_size, 50.0))


def jax_problems(rho, n, seed=0):
    """The miss protocol's examples of `rho` (JAX's BatchedHarness.run:
    keys split from seed*100000 + ci*1000, ci the rho's index) and the
    dowjons method keys."""
    ci = PROTOCOL_RHOS.index(rho)
    h = jh.BatchedHarness({}, JPhys())
    I = h.physics.grid_size
    keys = jax.random.split(jax.random.PRNGKey(seed * 100_000 + ci * 1_000),
                            n)
    arrs = dict(h._problem_gen(2)(
        keys, _cholesky(), jnp.float32(5.0), jnp.float32(0.0),
        jnp.int32(int(round(rho * I * I)))))
    mkeys = jax.vmap(lambda k: jax.random.fold_in(
        k, zlib.crc32(b"dowjons") % (2 ** 31)))(keys)
    return arrs, mkeys


def port_problem(arrs, rho) -> th.HarnessProblem:
    return th.HarnessProblem(
        T_true=t(arrs["T_true"]), T_noisy=t(arrs["T_noisy"]),
        S_true=t(arrs["S_true"]), C_true=t(arrs["C_true"]),
        peaks=t(arrs["peaks"]), Om=t(arrs["Om"]), sample_idx=None,
        fraction=rho)


def jax_draws(mkeys, R, z_dim, restarts):
    """JAX's standard normals of recover_dowjons_unquantized per example:
    the init fit's start (fold_in 17) and each restart's start (split)."""
    def one(k):
        fit = jax.random.normal(jax.random.fold_in(k, 17), (R, z_dim))
        starts = jnp.stack([jax.random.normal(kz, (R, z_dim))
                            for kz in jax.random.split(k, restarts)])
        return fit, starts

    fit, starts = jax.jit(jax.vmap(one))(mkeys)
    return t(fit), t(starts)


def miss_events(T_hat, T_ref, peaks, low_level=0.01, miss_threshold=0.25):
    """Per-(example, band, emitter) peak events and misses of the
    detection rule (ops.metrics.detection_counts), in numpy."""
    T_hat, T_ref, peaks = (np.asarray(x) for x in (T_hat, T_ref, peaks))
    I, J = T_ref.shape[-2:]
    px = np.clip(np.round(peaks[..., 0]).astype(int), 0, J - 1)
    py = np.clip(np.round(peaks[..., 1]).astype(int), 0, I - 1)
    b = np.arange(T_ref.shape[0])[:, None]
    ref = T_ref[b, :, py, px].transpose(0, 2, 1)          # [B, K, R]
    hat = T_hat[b, :, py, px].transpose(0, 2, 1)
    is_peak = ref > low_level
    return is_peak, is_peak & (hat < miss_threshold * ref)


def counts(T_hat, hp):
    """detection_counts per example: [B, 4] ints."""
    c = detection_counts(torch.as_tensor(np.asarray(T_hat)), hp.T_noisy,
                         hp.peaks)
    return torch.stack(c, -1).numpy()


@pytest.fixture(scope="module")
def registries():
    """The protocol's dowjons of both packages at TIER1_ITERS and at full
    depth, from the committed checkpoints (each package's loader)."""
    cache = {}

    def both(iters):
        if iters not in cache:
            kw = dict(dowjons_iters=iters, **PROTOCOL)
            cache[iters] = (
                jax_methods(only=("nasdac", "dowjons"), **kw),
                port_methods(only=("nasdac", "dowjons"), device="cpu", **kw))
        return cache[iters]

    return both


def run_pair(jm, tm, rhos, n, jax_also=None):
    """The n protocol examples of each rho in `rhos`, in one batch: JAX's
    problems and dowjons (vmapped, jitted) and the port's on JAX's draws;
    `jax_also(mkeys, arrs, hp)`, JAX's further programs, is dispatched
    before the port runs and joins JAX's output.  Returns (JAX's arrays,
    method keys, the port's problem, the draws, JAX's output, the port's
    output) as numpy / torch."""
    parts = [jax_problems(rho, n) for rho in rhos]
    arrs = {k: jnp.concatenate([p[0][k] for p in parts]) for k in parts[0][0]}
    mkeys = jnp.concatenate([p[1] for p in parts])
    hp = port_problem(arrs, rhos[0])
    draws = jax_draws(mkeys, 2, Z_DIM, PROTOCOL["dowjons_restarts"])
    # JAX dispatches asynchronously: its method runs beside the port's
    want = jh.BatchedHarness(jm, JPhys())._method_batched(
        "dowjons", jm["dowjons"])(mkeys, arrs)
    if jax_also is not None:
        want = {**want, **jax_also(mkeys, arrs, hp)}
    with torch.no_grad():
        got = tm["dowjons"](None, hp, draws=draws)
    return (arrs, mkeys, hp, draws,
            {k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _spa_jax(T_obs, port_picks):
    """JAX's SPA on one problem's masked unfolding (`nmf_spa`, NMF_SPA.m):
    its picks, the squared column norms its scan ranks at each step, its
    S factor, and the same factor from JAX's math at the port's picks."""
    from quantized_spectrum_cartography_tpu.baselines import spa as jspa

    T_km = T_obs.reshape(T_obs.shape[0], -1)
    Tn, normalizer = jspa.column_sum_normalize(T_km.T)

    def step(Rm, _):
        norms = jnp.sum(jnp.square(Rm), axis=0)
        u = Rm[:, jnp.argmax(norms)]
        u = u / jnp.maximum(jnp.linalg.norm(u), 1e-12)
        return Rm - jnp.outer(u, u @ Rm), norms

    def factor_at(idx):                         # spa.py:57-67 at `idx`
        Sm = Tn[:, idx] * normalizer[idx][None, :]
        C = jnp.linalg.solve(Sm.T @ Sm + 1e-10 * jnp.eye(idx.shape[0]),
                             Sm.T @ T_km.T).T
        return (Sm * jnp.linalg.norm(jnp.maximum(C, 0.0), axis=0)).T

    _, norms = jax.lax.scan(step, Tn, None, length=port_picks.shape[0])
    return {"picks": jspa.spa_indices(Tn, port_picks.shape[0]),
            "norms": norms, "S": jspa.nmf_spa(T_km, port_picks.shape[0])[1],
            "S_at_port_picks": factor_at(port_picks)}


@pytest.fixture(scope="module")
def tier1(registries):
    """TIER1_EXAMPLES examples of each rho of RHOS through both packages'
    dowjons at TIER1_ITERS outer iterations, with what the two discrete
    choices read: each side's Nasdac stage (JAX's in its own program) and
    SPA (picks, JAX's scores, S factors)."""
    from quantized_spectrum_cartography_tpu_torch.baselines import spa as tspa

    jm, tm = registries(TIER1_ITERS)

    def port_picks(hp):
        Tn, _ = tspa.column_sum_normalize(
            hp.T_obs.flatten(-2).transpose(-1, -2))
        return tspa.spa_indices(Tn, 2).numpy()

    def jax_also(mkeys, arrs, hp):
        out = jax.jit(jax.vmap(_spa_jax))(jnp.asarray(hp.T_obs.numpy()),
                                          jnp.asarray(port_picks(hp)))
        out["T_nas"] = jh.BatchedHarness(jm, JPhys())._method_batched(
            "nasdac", jm["nasdac"])(mkeys, arrs)["T_hat"]
        return out

    _, _, hp, _, want, got = run_pair(jm, tm, RHOS, TIER1_EXAMPLES,
                                      jax_also)
    with torch.no_grad():
        got["T_nas"] = tm["nasdac"](None, hp)["T_hat"].numpy()
        got["S"] = tspa.nmf_spa(hp.T_obs.flatten(-2), 2)[1].numpy()
    got["picks"] = port_picks(hp)
    return hp, want, got


def _t_plain(out):
    """The restarts' winner S C before the backstop, in float64."""
    return np.einsum("brij,brk->bkij", out["S_hat"].astype(np.float64),
                     out["C_hat"].astype(np.float64))


@pytest.mark.parametrize("rho", RHOS)
def test_paired_events_tier1(tier1, rho):
    """TIER1_EXAMPLES examples of the protocol at rho: per-example events
    equal, and T_hat within 2e-3 of the largest entry except where one of
    two discrete choices that rounding decides went the other way, each
    checked here:

    - SPA's pick among bands whose normalized columns tie.  Where the
      picks differ, JAX's scores of its pick and the port's are within
      SPA_TIE, and JAX's SPA math at the port's picks gives the port's S
      factor.  NMF_SPA's 1e-10 ridge is not scale-invariant, so two tied
      bands of different power can give S factors that differ beyond
      2e-3; such an example is held to its events only.
    - The backstop's pointwise switch (T_plain < 0.5 T_nas).  Elsewhere an
      entry beyond 2e-3 must be one where the two sides' switches differ
      while their T_plain and T_nas each agree there within 2e-3, and it
      may differ by at most the switch's jump, 0.5 T_nas, plus 2e-3."""
    hp, want, got = tier1
    i = RHOS.index(rho)
    sl = slice(i * TIER1_EXAMPLES, (i + 1) * TIER1_EXAMPLES)
    hp = dataclasses.replace(hp, **{f: getattr(hp, f)[sl] for f in (
        "T_true", "T_noisy", "S_true", "C_true", "peaks", "Om")})
    w, g = ({k: v[sl] for k, v in d.items()} for d in (want, got))
    np.testing.assert_array_equal(counts(g["T_hat"], hp),
                                  counts(w["T_hat"], hp))
    tol = ATOL_REL * np.abs(w["T_hat"]).max()
    # SPA: every differing pick a tie on JAX's side, and the same function
    for b in range(TIER1_EXAMPLES):
        diff = np.nonzero(w["picks"][b] != g["picks"][b])[0]
        if len(diff):
            s = diff[0]
            top = w["norms"][b, s, w["picks"][b, s]]
            gap = (top - w["norms"][b, s, g["picks"][b, s]]) / top
            assert 0 <= gap <= SPA_TIE, (b, s, gap)
        assert rel(g["S"][b:b + 1], w["S_at_port_picks"][b:b + 1])[0] \
            <= SPA_SAME, b
    held = rel(g["S"], w["S"]) <= ATOL_REL
    # the backstop's switch everywhere else
    P_w, P_g = _t_plain(w), _t_plain(g)
    N_w, N_g = (x.astype(np.float64) for x in (w["T_nas"], g["T_nas"]))
    T_w, T_g = (x.astype(np.float64) for x in (w["T_hat"], g["T_hat"]))
    stray = np.abs(T_g - T_w) > tol
    switched = (((P_w < 0.5 * N_w) != (P_g < 0.5 * N_g))
                & (np.abs(P_g - P_w) <= tol) & (np.abs(N_g - N_w) <= tol)
                & (np.abs(T_g - T_w) <= 0.5 * np.maximum(N_w, N_g) + tol))
    bad = stray & ~switched & held[:, None, None, None]
    assert not bad.any(), (np.argwhere(bad)[:10], held)
    # the per-(emitter, band) events sum to detection_counts
    is_peak, miss = miss_events(g["T_hat"], hp.T_noisy, hp.peaks)
    c = counts(g["T_hat"], hp)
    np.testing.assert_array_equal(miss.sum((1, 2)), c[:, 0])
    np.testing.assert_array_equal(is_peak.sum((1, 2)), c[:, 1])


# -- the full-depth comparison ----------------------------------------------

def mcnemar_p(b: int, c: int) -> float:
    """Exact two-sided McNemar p of b discordant pairs one way against c
    the other (a binomial test at 1/2)."""
    from scipy.stats import binomtest

    return 1.0 if b + c == 0 else float(binomtest(b, b + c, 0.5).pvalue)


def rel(a, b):
    """Per-example relative Frobenius difference |a - b| / |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ax = tuple(range(1, a.ndim))
    return np.sqrt(((a - b) ** 2).sum(ax)) / np.maximum(
        np.sqrt((b ** 2).sum(ax)), 1e-30)


def jax_stages(jm_nasdac, gen_apply, ae_complete, z_dim, iters):
    """JAX's dowjons_gan_fn (harness.py:659-718) as its stages, for one
    example under vmap: SPA, the AE completion, the restarts' winner, the
    Nasdac stage, the backstop and the residual patches."""
    from quantized_spectrum_cartography_tpu.baselines.spa import nmf_spa
    from quantized_spectrum_cartography_tpu.solvers.completion import (
        recover_dowjons_unquantized, residual_peak_refine)

    def one(key, arrs):
        hp = jh.HarnessProblem(**arrs, sample_idx=None, fraction=0.0)
        R = hp.S_true.shape[0]
        W = hp.Om.astype(hp.T_obs.dtype)
        _, S_flat = nmf_spa((hp.T_obs * W[None]).reshape(
            hp.T_obs.shape[0], -1), R)
        S_spa = S_flat.reshape(R, *hp.Om.shape)
        S_ae = jnp.stack([ae_complete(W, S_spa[r]) for r in range(R)])
        plain = recover_dowjons_unquantized(
            key, hp.T_obs, hp.Om, gen_apply, num_emitters=R, z_dim=z_dim,
            outer_iters=iters, S_init=S_ae,
            n_restarts=PROTOCOL["dowjons_restarts"], S_init_dense=True)
        T_nas = jm_nasdac(key, hp)["T_hat"]
        T_back = jnp.where(plain.T_hat < PROTOCOL["backstop_frac"] * T_nas,
                           T_nas, plain.T_hat)
        T_hat = residual_peak_refine(T_back, hp.T_obs, W,
                                     num_patches=max(2, R // 2))
        return {"spa": S_spa, "ae": S_ae, "Z": plain.aux["Z"],
                "T_plain": plain.T_hat, "T_nas": T_nas, "T_back": T_back,
                "T_hat": T_hat}

    return jax.jit(jax.vmap(one))


def port_stages(tm_nasdac, gen_apply, ae_complete, z_dim, iters, hp, draws,
                feed=None):
    """The port's dowjons_gan_fn as the same stages on the batch; with
    `feed` (JAX's stages) each cheap stage also runs on JAX's input."""
    from quantized_spectrum_cartography_tpu_torch.baselines.spa import (
        nmf_spa)
    from quantized_spectrum_cartography_tpu_torch.solvers.completion import (
        recover_dowjons_unquantized, residual_peak_refine)

    R, W = hp.S_true.shape[-3], hp.Om.to(hp.T_noisy.dtype)
    I, J = hp.T_obs.shape[-2:]

    def refine(T):
        return residual_peak_refine(T, hp.T_obs, W,
                                    num_patches=max(2, R // 2))

    def backstop(T, T_nas):
        return torch.where(T < PROTOCOL["backstop_frac"] * T_nas, T_nas, T)

    def ae(S):
        return ae_complete(W[..., None, :, :], S)

    with torch.no_grad():
        _, S_flat = nmf_spa(hp.T_obs.flatten(-2), R)
        out = {"spa": S_flat.reshape(*hp.T_obs.shape[:-3], R, I, J)}
        out["ae"] = ae(out["spa"])
        plain = recover_dowjons_unquantized(
            hp.T_obs, hp.Om, gen_apply, num_emitters=R, z_dim=z_dim,
            outer_iters=iters, S_init=out["ae"],
            n_restarts=PROTOCOL["dowjons_restarts"], S_init_dense=True,
            draws=draws)
        out["Z"], out["T_plain"] = plain.aux["Z"], plain.T_hat
        out["T_nas"] = tm_nasdac(None, hp)["T_hat"]
        out["T_back"] = backstop(out["T_plain"], out["T_nas"])
        out["T_hat"] = refine(out["T_back"])
        fed = {}
        if feed is not None:
            f = {k: t(v) for k, v in feed.items()}
            fed = {"ae": ae(f["spa"]), "T_back": backstop(f["T_plain"],
                                                          f["T_nas"]),
                   "T_hat": refine(f["T_back"])}
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in fed.items()})


STAGES = ("spa", "ae", "Z", "T_plain", "T_nas", "T_back", "T_hat")


def fits(T_plain, hp):
    """The masked data fit of the restarts' winner, per example."""
    W = hp.Om.numpy()[:, None].astype(np.float64)
    return (W * (np.asarray(T_plain, np.float64)
                 - hp.T_obs.numpy()) ** 2).sum((1, 2, 3))


def disagreement(T_a, T_b, hp):
    """Per-(emitter, band) miss events of two outputs: (a only, b only),
    McNemar's p on them; the examples whose miss counts differ each way
    and the sign test on those (misses cluster within an example, so the
    events are not independent)."""
    is_peak, miss_a = miss_events(T_a, hp.T_noisy, hp.peaks)
    _, miss_b = miss_events(T_b, hp.T_noisy, hp.peaks)
    a_only = int((miss_a & ~miss_b).sum())
    b_only = int((miss_b & ~miss_a).sum())
    ma, mb = miss_a.sum((1, 2)), miss_b.sum((1, 2))
    return {"peaks": int(is_peak.sum()), "misses": [int(ma.sum()),
                                                    int(mb.sum())],
            "events_first_only": a_only, "events_second_only": b_only,
            "examples_first_more": int((ma > mb).sum()),
            "examples_second_more": int((mb > ma).sum()),
            "examples_differ": [int(b) for b in np.nonzero(ma != mb)[0]],
            "mcnemar_p": mcnemar_p(a_only, b_only),
            "example_sign_p": mcnemar_p(int((ma > mb).sum()),
                                        int((mb > ma).sum()))}


@pytest.mark.slow
@pytest.mark.parametrize("rho", RHOS)
def test_paired_events_full_depth(registries, rho):
    """FULL_EXAMPLES examples at the protocol's full depth: the paired
    table (see the module docstring), written to build/missprob_paired/.
    Fails on a one-sided excess of port misses (McNemar p < 0.05 with
    port-only misses outnumbering JAX-only ones) or on a deterministic
    stage (SPA, the AE completion, the Nasdac stage, the backstop and the
    patches on JAX's input) that differs from JAX's beyond 2e-3."""
    from quantized_spectrum_cartography_tpu.models import Autoencoder
    from quantized_spectrum_cartography_tpu.solvers import vae_prior as jv
    from quantized_spectrum_cartography_tpu.training import (
        load_checkpoint as jax_load)
    from quantized_spectrum_cartography_tpu.training import ae_trainer as jae
    from quantized_spectrum_cartography_tpu_torch.baselines import pretrained
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        vae_prior as tv)
    from quantized_spectrum_cartography_tpu_torch.training import (
        ae_trainer as tae)

    t0 = time.time()
    jm, tm = registries(FULL_ITERS)
    arrs, mkeys, hp, draws, want, got = run_pair(jm, tm, (rho,),
                                                 FULL_EXAMPLES)
    t_methods = time.time() - t0

    state = dict(jax_load(pretrained.AE_CKPT))
    scale = float(state.pop("scale"))
    j_ae = jae.make_ae_completer(Autoencoder(activation="selu"), state, scale)
    j_gen, z_dim, _ = jv.load_vae_prior(pretrained.VAE_CKPT)
    model, t_scale = tae.load_ae(pretrained.AE_CKPT, "selu", "cpu")
    t_ae = tae.make_ae_completer(model, t_scale)
    t_gen, _, _ = tv.load_vae_prior(pretrained.VAE_CKPT, device="cpu")
    js = {k: np.asarray(v) for k, v in jax_stages(
        jm["nasdac"], j_gen, j_ae, z_dim, FULL_ITERS)(mkeys, arrs).items()}
    ps, fed = port_stages(tm["nasdac"], t_gen, t_ae, z_dim, FULL_ITERS, hp,
                          draws, feed=js)

    stages = {}
    for k in STAGES:
        d = rel(ps[k], js[k])
        stages[k] = {"chained_median": float(np.median(d)),
                     "chained_max": float(d.max())}
        if k in fed:
            e = rel(fed[k], js[k])
            stages[k].update(fed_median=float(np.median(e)),
                             fed_max=float(e.max()))
    stages["spa"]["columns_differ"] = int(
        (rel(ps["spa"].reshape(-1, *ps["spa"].shape[2:]),
             js["spa"].reshape(-1, *js["spa"].shape[2:])) > 1e-3).sum())
    first = next((k for k in STAGES if stages[k]["chained_max"] > ATOL_REL),
                 None)
    fit_p, fit_j = fits(ps["T_plain"], hp), fits(js["T_plain"], hp)
    port_vs_jax = disagreement(got["T_hat"], want["T_hat"], hp)
    table = {
        "rho": rho, "examples": FULL_EXAMPLES, "outer_iters": FULL_ITERS,
        "protocol": PROTOCOL,
        "port_vs_jax": port_vs_jax,
        "jax_method_vs_jax_stages": disagreement(js["T_hat"], want["T_hat"],
                                                 hp),
        "port_method_equals_port_stages": bool(np.array_equal(
            got["T_hat"], ps["T_hat"])),
        "stages": stages, "first_stage_beyond_2e-3": first,
        "fit_port_over_jax": {
            "median": float(np.median(fit_p / fit_j)),
            "port_lower": int((fit_p < fit_j).sum()),
            "jax_lower": int((fit_j < fit_p).sum())},
        "seconds": {"methods": t_methods, "all": time.time() - t0},
    }
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / f"paired_rho{rho}.json", "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))
    one_sided = (port_vs_jax["mcnemar_p"] < 0.05
                 and port_vs_jax["events_first_only"]
                 > port_vs_jax["events_second_only"])
    assert not one_sided, port_vs_jax
    for k in ("ae", "T_back", "T_hat"):
        assert stages[k]["fed_max"] <= ATOL_REL, (k, stages[k])
    assert math.isfinite(stages["T_nas"]["chained_median"])


def _spa_picks_jax(T_obs, Om):
    """SPA's bands in JAX's nasdac (nmf_spa on the masked unfolding)."""
    from quantized_spectrum_cartography_tpu.baselines import spa as jspa

    W = Om.astype(T_obs.dtype)
    Tn, _ = jspa.column_sum_normalize(
        (T_obs * W[None]).reshape(T_obs.shape[0], -1).T)
    return jspa.spa_indices(Tn, 2)


@pytest.mark.slow
def test_paired_events_port_misses(registries):
    """The port's own misses on the card, run again on the CPU with JAX's
    draws through both packages (dowjons with REPLAY_KEYS keys per problem,
    nasdac, which draws nothing, once per lane), with SPA's picks on each
    side, and JAX's nasdac and picks in a second XLA program (one problem
    per jit instead of all lanes under vmap) as the control; the table to
    build/missprob_paired/paired_port_misses.json.  The problems are
    selected for the port's misses, so a one-sided count of misses here is
    expected and is recorded, not gated.  Fails unless, on every problem
    where the packages' Nasdac stage (which the DowJons backstop takes)
    misses differently, JAX's two programs miss differently too, JAX's
    single-problem program misses as the port does, and the SPA picks
    differ: the outputs part at SPA's pick among near-tied pure bands,
    which rounding decides in JAX as in the port."""
    from quantized_spectrum_cartography_tpu_torch.baselines import spa as tspa

    if not MISSED.exists():
        pytest.skip(f"{MISSED} not written (missprob.py --missed-from)")
    with np.load(MISSED) as z:
        d = {k: z[k] for k in z.files}
    n = len(d["index"])
    lanes = np.repeat(np.arange(n), REPLAY_KEYS)
    arrs = {k: jnp.asarray(d[k][lanes]) for k in (
        "T_true", "T_noisy", "S_true", "C_true", "peaks", "Om")}
    mkeys = jax.random.split(jax.random.PRNGKey(14), n * REPLAY_KEYS)
    hp = port_problem(arrs, 0.0)
    draws = jax_draws(mkeys, 2, Z_DIM, PROTOCOL["dowjons_restarts"])
    jm, tm = registries(FULL_ITERS)
    h = jh.BatchedHarness(jm, JPhys())
    t0 = time.time()
    want = {m: np.asarray(h._method_batched(m, jm[m])(mkeys, arrs)["T_hat"])
            for m in ("nasdac", "dowjons")}
    with torch.no_grad():
        got = {"dowjons": tm["dowjons"](None, hp, draws=draws)["T_hat"],
               "nasdac": tm["nasdac"](None, hp)["T_hat"]}
    got = {m: v.numpy() for m, v in got.items()}
    first = np.arange(n) * REPLAY_KEYS
    one = {k: v[first] for k, v in arrs.items()}
    nas_single = jax.jit(lambda a: jm["nasdac"](None, jh.HarnessProblem(
        **a, sample_idx=None, fraction=0.0))["T_hat"])
    jax_single = np.stack([np.asarray(nas_single({k: v[i] for k, v in
                                                  one.items()}))
                           for i in range(n)])
    T_obs = arrs["T_noisy"] * arrs["Om"][:, None].astype(jnp.float32)
    picks_jax = np.asarray(jax.jit(jax.vmap(_spa_picks_jax))(T_obs,
                                                             arrs["Om"]))
    picks_single = np.stack([np.asarray(jax.jit(_spa_picks_jax)(
        T_obs[i], arrs["Om"][i])) for i in first])
    Tn, _ = tspa.column_sum_normalize(hp.T_obs.flatten(-2).transpose(-1, -2))
    picks_port = tspa.spa_indices(Tn, 2).numpy()

    def misses(T, sel):
        return [int(x) for x in counts(T, _lanes(hp, sel))[:, 0]]

    problems = []
    for i in range(n):
        sel = lanes == i
        row = {"rho": float(d["rho"][i]), "seed": int(d["seed"][i]),
               "index": int(d["index"][i]),
               "card_misses": int(d["misses"][i])}
        for m in ("dowjons", "nasdac"):
            row[f"{m}_port"] = misses(got[m][sel], sel)
            row[f"{m}_jax"] = misses(want[m][sel], sel)
        row["nasdac_jax_single_program"] = misses(
            jax_single[i:i + 1], np.arange(len(lanes)) == first[i])
        row["spa_port"] = picks_port[first[i]].tolist()
        row["spa_jax"] = picks_jax[first[i]].tolist()
        row["spa_jax_single_program"] = picks_single[i].tolist()
        row["differ"] = any(row[f"{m}_port"] != row[f"{m}_jax"]
                            for m in ("dowjons", "nasdac"))
        problems.append(row)
    table = {"problems": problems, "keys_per_problem": REPLAY_KEYS,
             "outer_iters": FULL_ITERS,
             "port_vs_jax": {m: disagreement(got[m], want[m], hp)
                             for m in got},
             "seconds": time.time() - t0}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "paired_port_misses.json", "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))
    parted = [r for r in problems if r["nasdac_port"] != r["nasdac_jax"]]
    assert all(r["nasdac_jax_single_program"] != r["nasdac_jax"][:1]
               and r["nasdac_jax_single_program"] == r["nasdac_port"][:1]
               and r["spa_port"] != r["spa_jax"] for r in parted), parted


def _lanes(hp, sel):
    return dataclasses.replace(hp, **{f: getattr(hp, f)[torch.as_tensor(sel)]
                                      for f in ("T_true", "T_noisy", "S_true",
                                                "C_true", "peaks", "Om")})
