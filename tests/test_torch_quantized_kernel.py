"""The ordinal likelihood of the port (ops/kernels/quantized_nll.py):

- its numerics and observation packing against the JAX package's;
- its plain forward and analytic backward, both encodings, against the JAX
  package's `fused_quantized_nll`/`fused_quantized_nll_coded` (their pure
  jnp versions, `fused_nll_reference`/`_nll_jnp_coded`, and the Pallas
  kernels in interpret mode), for the fast and the robust numerics, the log
  and the linear link, with and without a mask;
- masked entries, the batched scorer, dispatch and input checks.  The CUDA
  kernels themselves are checked on the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops.lowrank import pad_spatial
from quantized_spectrum_cartography_tpu.ops.pallas import fused_likelihood as jfl
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    quantized_nll as q,
)

torch.set_num_threads(1)

B, R, K, I = 2, 3, 8, 11
P = I * I
MEAN = 0.0045
# (link, numerics) -> (boundary table, sigma, offset)
CASES = {
    ("log", "fast"): (jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0,
                      jbnd.LOG_OFFSET_4),
    ("log", "robust"): (jbnd.QUANTIZATION_BOUNDARIES_8_BINS_LOG, 1.0,
                        jbnd.LOG_OFFSET_4),
    ("linear", "fast"): (jfl.onebit_bounds(MEAN), 2.5, 0.0),
    ("linear", "robust"): (jfl.onebit_bounds(MEAN), 0.008, 0.0),
}


def t(x):
    return torch.tensor(np.array(x))


def make_inputs(rng, case, masked):
    """S, C and bin indices Y quantized from C@S with noise, so every bin
    and both tails of the numerics are hit."""
    (link, _), (table, sigma, offset) = case, CASES[case]
    S = rng.uniform(0.001, 0.05, (B, R, P)).astype(np.float32)
    C = rng.uniform(0.0, 1.0, (B, K, R)).astype(np.float32)
    X = np.einsum("bkr,brp->bkp", C, S)
    x = np.log(X + offset) if link == "log" else X
    noisy = x + 0.8 * sigma * rng.standard_normal(x.shape)
    Y = np.searchsorted(np.array(table[1:-1]), noisy, side="left")
    Y = Y.reshape(B, K, I, I).astype(np.int32)
    mask = ((rng.uniform(size=Y.shape) < 0.5).astype(np.float32)
            if masked else None)
    return S, C, Y, mask


@pytest.mark.parametrize("fn", ["_log1mexp", "_log_prob", "_log_prob_fast",
                                "_dlogp_dx"])
def test_numerics_match_jax(fn):
    """Same f32 formulas: agree to a few ulp (exp/log of two libraries)."""
    a = np.linspace(-40.0, 12.0, 3001).astype(np.float32)
    b = a + np.float32(1.7)
    if fn == "_log1mexp":
        d = np.r_[-np.logspace(-12, 2, 3001), -0.6931472, -0.6931471,
                  -0.6931473].astype(np.float32)
        got, ref = q._log1mexp(t(d)), jfl._log1mexp(jnp.asarray(d))
    elif fn == "_dlogp_dx":
        lp = jfl._log_prob(jnp.asarray(a), jnp.asarray(b))
        got = q._dlogp_dx(t(a), t(b), t(lp), 0.2)
        ref = jfl._dlogp_dx(jnp.asarray(a), jnp.asarray(b), lp, 0.2)
    else:
        got = getattr(q, fn)(t(a), t(b))
        ref = getattr(jfl, fn)(jnp.asarray(a), jnp.asarray(b))
    got, ref = got.numpy(), np.asarray(ref)
    if fn == "_log_prob_fast":
        # the floor 1e-38 is subnormal in f32: XLA on the CPU flushes it to
        # 0 (log -> -inf); the port keeps it, as the CUDA kernels do
        deep = ~np.isfinite(ref)
        assert deep.any() and np.all(got[deep] == np.float32(np.log(1e-38)))
        got, ref = got[~deep], ref[~deep]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 1.9999, 2.0, 5.0])
def test_fast_ok_matches(sigma):
    assert q._fast_ok(sigma) == jfl._fast_ok(sigma)


@pytest.mark.parametrize("masked", [False, True])
def test_packing_matches(rng, masked):
    """pack_bounds, pack_bounds_1bit, pack_codes and the code decoding give
    the JAX package's arrays (without its lane padding)."""
    table = jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG
    Y = rng.integers(0, 4, (B, K, I, I)).astype(np.int32)
    y01 = rng.integers(0, 2, (B, K, I, I)).astype(np.float32)
    m = (rng.uniform(size=Y.shape) < 0.5).astype(np.float32)
    mm = t(m) if masked else None
    W, U = q.pack_bounds(t(Y), table, mm)
    W1, U1 = q.pack_bounds_1bit(t(y01), MEAN, mm)
    codes = q.pack_codes(t(Y), 4, mm)
    assert codes.dtype == torch.int8 and W.dtype == torch.float32
    for b in range(B):
        jm = jnp.asarray(m[b]) if masked else None
        for got, ref in zip(
                (W[b], U[b], W1[b], U1[b], codes[b]),
                (*jfl.pack_bounds(jnp.asarray(Y[b]), jnp.asarray(table), jm),
                 *jfl.pack_bounds_1bit(jnp.asarray(y01[b]), MEAN, jm),
                 jfl.pack_codes(jnp.asarray(Y[b]), 4, jm))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:, :P])
    Wd, Ud = q._bounds_from_codes(codes, table)
    assert torch.equal(Wd, W) and torch.equal(Ud, U)
    assert q.onebit_bounds(MEAN) == jfl.onebit_bounds(MEAN)
    with pytest.raises(ValueError):
        q.pack_codes(t(Y), 32)


def _jax_value_and_grad(S, C, Y, m, case, coded, interpret):
    """One map through the JAX package's entry point."""
    (link, num), (table, sigma, offset) = case, CASES[case]
    linear, fast = link == "linear", num == "fast"
    jm = None if m is None else jnp.asarray(m)
    if coded:
        Yc = jfl.pack_codes(jnp.asarray(Y), len(table) - 1, jm)
        bbt = tuple(float(v) for v in table)

        def f(s, c):
            return jfl.fused_quantized_nll_coded(s, c, Yc, bbt, sigma, offset,
                                                 interpret, linear, fast,
                                                 "xla")
    else:
        Wp, Up = jfl.pack_bounds(jnp.asarray(Y), jnp.asarray(np.array(table)),
                                 jm)

        def f(s, c):
            return jfl.fused_quantized_nll(s, c, Wp, Up, sigma, offset,
                                           interpret, linear, fast, "xla")

    v, (gS, gC) = jax.value_and_grad(f, (0, 1))(pad_spatial(jnp.asarray(S)),
                                                jnp.asarray(C))
    return float(v), np.asarray(gS)[:, :P], np.asarray(gC)


@pytest.mark.parametrize("coded", [False, True], ids=["bounds", "codes"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("case", sorted(CASES), ids="-".join)
def test_plain_pair_matches_jax(rng, case, masked, coded):
    """The port's entry point on CPU tensors (its plain versions) against
    the JAX package's jnp path and, for the log link, its Pallas kernels in
    interpret mode, per map: value rtol 1e-4; gradients rtol 1e-4 with atol
    1e-6 of the largest gradient."""
    S, C, Y, mask = make_inputs(rng, case, masked)
    (link, num), (table, sigma, offset) = case, CASES[case]
    mm = None if mask is None else t(mask)
    St, Ct = t(S).requires_grad_(True), t(C).requires_grad_(True)
    if coded:
        codes = q.pack_codes(t(Y), len(table) - 1, mm)
        v = q.fused_quantized_nll_coded(St, Ct, codes, table, sigma, offset,
                                        link == "linear")
    else:
        W, U = q.pack_bounds(t(Y), table, mm)
        v = q.fused_quantized_nll(St, Ct, W, U, sigma, offset,
                                  link == "linear")
    gS, gC = torch.autograd.grad(v.sum(), (St, Ct))
    assert torch.isfinite(gS).all() and torch.isfinite(gC).all()
    for b in range(B):
        m = None if mask is None else mask[b]
        refs = [_jax_value_and_grad(S[b], C[b], Y[b], m, case, coded, False)]
        if link == "log":
            refs.append(_jax_value_and_grad(S[b], C[b], Y[b], m, case, coded,
                                            True))
        for rv, rS, rC in refs:
            np.testing.assert_allclose(v[b].item(), rv, rtol=1e-4)
            np.testing.assert_allclose(gS[b].numpy(), rS, rtol=1e-4,
                                       atol=1e-6 * np.abs(rS).max())
            np.testing.assert_allclose(gC[b].numpy(), rC, rtol=1e-4,
                                       atol=1e-6 * np.abs(rC).max())


@pytest.mark.parametrize("case", sorted(CASES), ids="-".join)
def test_masked_entries_are_exact_zero(rng, case):
    """Masked entries, by sentinel bounds or by code == nbins, add exactly 0
    to the value and to both gradients, never NaN."""
    S, C, Y, _ = make_inputs(rng, case, False)
    (link, num), (table, sigma, offset) = case, CASES[case]
    st = (sigma, offset, link == "linear", num == "fast")
    none = torch.zeros(B, K, I, I)
    W, U = q.pack_bounds(t(Y), table, none)
    codes = q.pack_codes(t(Y), len(table) - 1, none)
    g = torch.ones(B)
    assert torch.equal(q.quantized_nll_plain(t(S), t(C), W, U, *st),
                       torch.zeros(B))
    assert torch.equal(q.quantized_nll_coded_plain(t(S), t(C), codes, table,
                                                   *st), torch.zeros(B))
    for dS, dC in (q.quantized_nll_grad_plain(t(S), t(C), W, U, g, *st),
                   q.quantized_nll_coded_grad_plain(t(S), t(C), codes, table,
                                                    g, *st)):
        assert not dS.any() and not dC.any()


def test_zero_column_gives_finite_gradient(rng):
    """Log link with a zero column of S: X + offset = 1e-10 there, and dX
    divides by it; the value and the gradients stay finite."""
    case = ("log", "fast")
    S, C, Y, _ = make_inputs(rng, case, False)
    S[:, :, 5] = 0.0
    table, sigma, offset = CASES[case]
    W, U = q.pack_bounds(t(Y), table)
    dS, dC = q.quantized_nll_grad_plain(t(S), t(C), W, U, torch.ones(B),
                                        sigma, offset, False, True)
    assert torch.isfinite(dS).all() and torch.isfinite(dC).all()
    rv, rS, rC = _jax_value_and_grad(S[0], C[0], Y[0], None, case, False,
                                     False)
    np.testing.assert_allclose(dS[0].numpy(), rS, rtol=1e-4,
                               atol=1e-6 * np.abs(rS).max())


@pytest.mark.parametrize("coded", [False, True], ids=["bounds", "codes"])
def test_scorer_equals_per_candidate_calls(rng, coded):
    """The forward-only scorer over N candidates, with C and the
    observations shared (leading size 1), equals one call per candidate."""
    case = ("log", "fast")
    S, C, Y, mask = make_inputs(rng, case, True)
    table, sigma, offset = CASES[case]
    cand = t(rng.uniform(0.001, 0.05, (5, R, P)).astype(np.float32))
    if coded:
        obs, bb = (q.pack_codes(t(Y[:1]), 4, t(mask[:1])),), table
    else:
        obs, bb = q.pack_bounds(t(Y[:1]), table, t(mask[:1])), None
    scores = q.score_quantized_nll(cand, t(C[:1]), obs, sigma, offset, bb)
    assert scores.shape == (5,) and not scores.requires_grad
    for n in range(5):
        one = q.score_quantized_nll(cand[n:n + 1], t(C[:1]), obs, sigma,
                                    offset, bb)
        torch.testing.assert_close(scores[n:n + 1], one, rtol=1e-6, atol=0.0)


def test_dispatch_and_checks(rng):
    """CPU tensors take the plain version (no launch); the CUDA wrappers
    refuse CPU tensors before building anything; unknown modes raise."""
    case = ("log", "robust")
    S, C, Y, _ = make_inputs(rng, case, False)
    table, sigma, offset = CASES[case]
    W, U = q.pack_bounds(t(Y), table)
    codes = q.pack_codes(t(Y), len(table) - 1)
    q.reset_launches()
    for mode in ("auto", "plain"):
        v = q.fused_quantized_nll(t(S), t(C), W, U, sigma, offset, mode=mode)
        np.testing.assert_array_equal(
            v.numpy(),
            q.quantized_nll_plain(t(S), t(C), W, U, sigma, offset).numpy())
    assert all(fn.launches == 0 for fn in q._KERNELS)
    g = torch.ones(B)
    for call in (lambda: q.quantized_nll_fwd_cuda(t(S), t(C), W, U, 1.0, 0.0),
                 lambda: q.quantized_nll_bwd_cuda(t(S), t(C), W, U, g, 1.0,
                                                  0.0),
                 lambda: q.quantized_nll_coded_fwd_cuda(t(S), t(C), codes,
                                                        table, 1.0, 0.0),
                 lambda: q.quantized_nll_coded_bwd_cuda(t(S), t(C), codes,
                                                        table, g, 1.0, 0.0)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="mode"):
        q.fused_quantized_nll(t(S), t(C), W, U, sigma, offset, mode="xla")
