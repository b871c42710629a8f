"""The port's 1-to-8-bit ladder (`bits_sweep`) against the same math
composed from the JAX package (`gather_bin_bounds`,
`log_prob_probit_bounds`, `masked_nll`, `get_tensor`, `project_rank`,
`project_nonneg`, `safe_fro`, and optax's chain(clip_by_global_norm(10),
adam(cosine_decay_schedule(0.02, iters, 0.05))), as
`tools/bits_sweep_tpu.py:116-202` composes it), on fed inputs: B=2 maps of
13x13, K=8, R=2, 20 warm + 30 NLL steps (one rank projection in the NLL
phase), at the 4-bit (16-adjusted log table, offset 2.4e-7: the largest
tail gradients, which the clip bounds) and the 8-bit (256-bin linear)
depths.  JAX runs under jax.jit.

Tolerances: the warm phase's per-step summed losses rtol 1e-4 at both
depths; at 8 bits the NLL phase's too and T_hat 1e-4 of the largest entry.
At 4 bits the NLL phase holds the first TIGHT_STEPS steps at rtol 1e-4
(they agree to 1e-5); after that the two runs part by rounding, as the
JAX tool's comment on this table says its tail gradients are ~100x the
7-bin table's: an entry of S o C that crosses zero meets log(x + 2.4e-7)
with a slope of 4e6 and Adam's lr-sized steps, and the rank projection at
step 25 moves the parted factors again.  Past that point the costs are
held at rtol 0.2 and T_hat at 0.2 relative Frobenius (measured: 0.12 and
0.08)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quantized_spectrum_cartography_tpu.ops import boundaries as jb
from quantized_spectrum_cartography_tpu.ops.likelihood import (
    gather_bin_bounds,
    log_prob_probit_bounds,
    masked_nll,
)
from quantized_spectrum_cartography_tpu.ops.lowrank import (
    get_tensor,
    project_nonneg,
    project_rank,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch import bits_sweep as bs

torch.set_num_threads(1)

B, K, I, R = 2, 8, 13, 2
WARM, ITERS = 20, 30
TIGHT_STEPS = 5              # 4-bit NLL steps held at rtol 1e-4
DEPTHS = {c[0]: c for c in bs.CONFIGS}


def jax_solve(Wb, Ub, mask, Td, sigma, offset, S0, C0, warm, iters):
    """bits_sweep_tpu.py's solver_body, on the JAX package's functions."""
    linear = offset is None
    opt = optax.chain(
        optax.clip_by_global_norm(10.0),
        optax.adam(optax.cosine_decay_schedule(0.02, iters, alpha=0.05)))

    def one_loss(S, C, w, u, m, td):
        Th = jnp.maximum(get_tensor(S, C), 0.0)
        x = Th if linear else jnp.log(Th + offset)
        nll = masked_nll(log_prob_probit_bounds(w, u, x, sigma), m)
        tether = 0.1 * 1e4 * jnp.sum(m * jnp.square(Th - td))
        return nll + tether + 0.01 * safe_fro(C) + 0.01 * safe_fro(S)

    def loss(params):
        S, C = params
        return jnp.sum(jax.vmap(one_loss)(S, C, Wb, Ub, mask, Td))

    def warm_loss(params):
        S, C = params
        return jnp.sum(mask * jnp.square(jax.vmap(get_tensor)(S, C) - Td)
                       ) * 1e4

    def stepper(loss_fn, o):
        def step(carry, i):
            params, state = carry
            val, g = jax.value_and_grad(loss_fn)(params)
            up, state = o.update(g, state, params)
            S, C = optax.apply_updates(params, up)
            S, C = jax.lax.cond(
                (i + 1) % 25 == 0,
                lambda sc: (project_nonneg(project_rank(sc[0], 10)),
                            project_nonneg(sc[1])),
                lambda sc: sc, (S, C))
            return ((S, C), state), val
        return step

    wopt = optax.adam(0.02)
    (params, _), warm_costs = jax.lax.scan(
        stepper(warm_loss, wopt), ((S0, C0), wopt.init((S0, C0))),
        jnp.arange(warm))
    (params, _), costs = jax.lax.scan(
        stepper(loss, opt), (params, opt.init(params)), jnp.arange(iters))
    S, C = params
    return jnp.maximum(jax.vmap(get_tensor)(S, C), 0.0), warm_costs, costs


def fed_inputs(label, seed=0):
    """A low-rank nonnegative T at the table's scale, the per-entry mask
    and the standard normals, from numpy; the port quantizes, and JAX
    takes the same bin indices."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.0, 1.0, (B, R, I, I)) ** 3
    C = rng.uniform(0.0, 1.0, (B, R, K))
    T = np.einsum("brij,brk->bkij", S, C).astype(np.float32)
    T *= (0.25 if DEPTHS[label][3] is None else 0.05) / T.max()
    mask = (rng.uniform(size=T.shape) < 0.3).astype(np.float32)
    noise = rng.standard_normal(T.shape).astype(np.float32)
    S0 = (0.01 * np.abs(rng.standard_normal((B, R, I, I)))).astype(
        np.float32)
    C0 = np.full((B, R, K), 0.01, np.float32)
    return T, mask, noise, S0, C0


@pytest.mark.parametrize("label", ["4-bit", "8-bit"])
def test_solve_matches_jax_composition(label):
    _, bits, table, offset, sigma = DEPTHS[label]
    T, mask, noise, S0, C0 = fed_inputs(label)
    Y, Wb, Ub, Td = bs.observe(torch.tensor(T), torch.tensor(noise), table,
                               offset, sigma)
    bb = jnp.asarray(np.asarray(table), jnp.float32)
    jW, jU = jax.vmap(lambda y: gather_bin_bounds(y, bb))(jnp.asarray(
        Y.numpy()))
    np.testing.assert_array_equal(Wb.numpy(), np.asarray(jW))
    np.testing.assert_array_equal(Ub.numpy(), np.asarray(jU))
    mid = (jnp.clip(jW, bb[0], bb[-1]) + jnp.clip(jU, bb[0], bb[-1])) / 2
    jTd = mid if offset is None else jnp.maximum(jnp.exp(mid) - offset, 0.0)
    np.testing.assert_allclose(Td.numpy(), np.asarray(jTd), rtol=1e-6,
                               atol=1e-12)
    assert int(Y.max()) - int(Y.min()) >= 3          # several bins in play

    got, got_warm, got_costs = bs.solve(
        Wb, Ub, torch.tensor(mask), Td, sigma, offset, torch.tensor(S0),
        torch.tensor(C0), WARM, ITERS)
    want, want_warm, want_costs = jax.jit(
        lambda *a: jax_solve(*a, sigma, offset, jnp.asarray(S0),
                             jnp.asarray(C0), WARM, ITERS))(
        jW, jU, jnp.asarray(mask), jTd)
    np.testing.assert_allclose(got_warm.numpy(), np.asarray(want_warm),
                               rtol=1e-4)
    got, got_costs = got.numpy(), got_costs.numpy()
    want, want_costs = np.asarray(want), np.asarray(want_costs)
    if label == "8-bit":
        np.testing.assert_allclose(got_costs, want_costs, rtol=1e-4)
        np.testing.assert_allclose(got, want, rtol=0.0,
                                   atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got_costs[:TIGHT_STEPS],
                                   want_costs[:TIGHT_STEPS], rtol=1e-4)
        np.testing.assert_allclose(got_costs, want_costs, rtol=0.2)
        assert np.linalg.norm(got - want) <= 0.2 * np.linalg.norm(want)


def test_clip_matches_optax():
    """The global-norm clip over both factors of every map, below and
    above the limit, as optax computes it."""
    rng = np.random.default_rng(3)
    for scale in (0.01, 50.0):
        gS = (scale * rng.standard_normal((B, R, I, I))).astype(np.float32)
        gC = (scale * rng.standard_normal((B, R, K))).astype(np.float32)
        want, _ = optax.clip_by_global_norm(10.0).update(
            (jnp.asarray(gS), jnp.asarray(gC)), None)
        got = bs._clip_global((torch.tensor(gS), torch.tensor(gC)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_depths_match_the_tool():
    """CONFIGS holds the JAX tool's tables, offsets and sigmas."""
    want = {
        "1-bit": ((jb.QUANTIZATION_BOUNDARIES_4_BINS_LOG[0],
                   jb.QUANTIZATION_BOUNDARIES_4_BINS_LOG[2],
                   jb.QUANTIZATION_BOUNDARIES_4_BINS_LOG[-1]),
                  jb.LOG_OFFSET_4, 1.287),
        "2-bit": (jb.QUANTIZATION_BOUNDARIES_4_BINS_LOG, jb.LOG_OFFSET_4,
                  1.287),
        "3-bit": (jb.QUANTIZATION_BOUNDARIES_7_ADJUSTED,
                  jb.LOG_OFFSET_7_ADJUSTED, 0.5),
        "4-bit": (jb.QUANTIZATION_BOUNDARIES_16_ADJUSTED,
                  jb.LOG_OFFSET_16_ADJUSTED, 0.5),
        "8-bit": (jb.QUANTIZATION_BOUNDARIES_256_BINS_UNIFORM, None,
                  jb.SD_256_BINS_UNIFORM),
    }
    assert list(DEPTHS) == list(want)
    for label, (table, offset, sigma) in want.items():
        _, _, t, o, s = DEPTHS[label]
        np.testing.assert_allclose(np.asarray(t), np.asarray(table),
                                   rtol=0)
        assert o == offset and s == pytest.approx(float(sigma), rel=0)
    assert bs.METRIC_OFFSET == jb.LOG_OFFSET_7_ADJUSTED


def test_ladder_and_gate_on_cpu():
    """The whole ladder at a toy size on the CPU: every depth and the
    floor finite with their keys; the gate against BITS_SWEEP.json."""
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig

    gen = torch.Generator().manual_seed(0)
    physics = PhysicsConfig(grid_size=21, num_bands=16)
    T, mask = bs.problem_set(gen, 3, physics, device="cpu")
    noise = torch.randn(T.shape, generator=gen)
    S0, C0 = bs.initial_factors(gen, 3, *T.shape[1:], "cpu")
    res = bs.ladder(T, mask, noise, S0, C0, warm=3, iters=3,
                    log=lambda *a: None)
    assert list(res) == [c[0] for c in bs.CONFIGS] + ["unquantized floor"]
    for label, r in res.items():
        for k in ("nmse_mean", "nmse_median", "nmse_sd", "nmse_log_mean",
                  "nmse_log_median", "nmse_log_sd"):
            assert np.isfinite(r[k]), (label, k)
    assert res["8-bit"]["domain"] == "linear" and res["8-bit"]["finite"]
    import json
    with open(bs.REFERENCE) as f:
        ref = json.load(f)["results"]
    g = bs.gate(res, ref, 3)
    assert set(g["per_depth"]) == set(res)
    row = g["per_depth"]["3-bit"]
    assert row["jax"] == ref["3-bit"]["nmse_log_mean"]
    assert row["in_band"] == (abs(row["z"]) <= bs.Z_LIMIT)


def test_kernel_inputs_on_cpu():
    """The 256-bin point's inputs: per-map copies of one quantized map,
    the masked entries folded to the sentinels, every observed bin inside
    the 256-bin table; the plain pair on them finite."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    gen = torch.Generator().manual_seed(1)
    T0 = 0.3 * torch.rand(K, I, I, generator=gen)
    mask0 = (torch.rand(K, I, I, generator=gen) < 0.1).float()
    S, C, W, U, sigma = bs.kernel_inputs(T0, mask0, gen, batch=3)
    assert S.shape == (3, R, I * I) and C.shape == (3, K, R)
    assert W.shape == U.shape == (3, K, I * I)
    assert torch.equal(W[0], W[2]) and W.is_contiguous()
    obs = mask0.flatten(-2) > 0
    assert (W[0][~obs] == -q.MASK_SENTINEL).all()
    assert (W[0][obs] >= 0).all() and (U[0][obs] <= 0.3312 + 1e-6).all()
    assert not q._fast_ok(sigma)
    v = q.quantized_nll_plain(S, C, W, U, sigma, 0.0, True, False)
    dS, dC = q.quantized_nll_grad_plain(S, C, W, U, torch.ones(3), sigma,
                                        0.0, True, False)
    assert torch.isfinite(v).all() and torch.isfinite(dS).all()
    assert torch.isfinite(dC).all()
