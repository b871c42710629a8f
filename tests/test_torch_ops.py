"""Port ops (quantizer, likelihood, lowrank, metrics) against the JAX
package's functions on the same numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops import likelihood as jlik
from quantized_spectrum_cartography_tpu.ops import lowrank as jlr
from quantized_spectrum_cartography_tpu.ops import metrics as jmet
from quantized_spectrum_cartography_tpu.ops import quantizer as jq
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as tbnd
from quantized_spectrum_cartography_tpu_torch.ops import likelihood as tlik
from quantized_spectrum_cartography_tpu_torch.ops import lowrank as tlr
from quantized_spectrum_cartography_tpu_torch.ops import metrics as tmet
from quantized_spectrum_cartography_tpu_torch.ops import quantizer as tq

torch.set_num_threads(1)

B, R, K, I = 3, 2, 8, 9
MEAN, STD = 0.0045, 0.008


def t(x):
    return torch.tensor(np.array(x))


@pytest.fixture
def problem(rng):
    S = rng.uniform(0.0, 0.05, (B, R, I, I)).astype(np.float32)
    C = rng.uniform(0.0, 0.5, (B, R, K)).astype(np.float32)
    y01 = rng.integers(0, 2, (B, K, I, I)).astype(np.float32)
    mask = (rng.uniform(size=(B, K, I, I)) < 0.3).astype(np.float32)
    return S, C, y01, mask


def test_constants_exact():
    assert tq._SQRT2 == jq._SQRT2 == 1.414213
    assert tlik._SIGMA_EFF == jlik._SIGMA_EFF


def test_F_probit_matches(rng):
    y = rng.normal(0.0, 0.02, (K, I, I)).astype(np.float32)
    np.testing.assert_allclose(tq.F_probit(t(y), STD).numpy(),
                               np.asarray(jq.F_probit(jnp.asarray(y), STD)),
                               rtol=1e-6, atol=1e-7)


def test_dither_probit_statistics(rng):
    """Bernoulli(Phi(y/std)): {0,1}, and the share of ones within 4 standard
    errors of mean Phi (torch's random bits differ from jax.random's)."""
    y = t(rng.normal(0.0, 0.01, (64, 32, 32)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    z = tq.dither_probit(y, STD, gen)
    assert z.dtype == y.dtype and set(z.unique().tolist()) <= {0.0, 1.0}
    p = tq.F_probit(y, STD)
    se = torch.sqrt((p * (1 - p)).sum()) / p.numel()
    assert abs(z.mean() - p.mean()) < 4 * se


@pytest.mark.parametrize("probit", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_neg_likelihood_1bit_matches(problem, probit, masked):
    S, C, y01, mask = problem
    T = np.einsum("brij,brk->bkij", S, C)
    m = mask if masked else None
    got = tlik.neg_likelihood_1bit(t(T), t(y01), MEAN, STD, probit,
                                   None if m is None else t(m))
    ref = jax.vmap(lambda a, b, mm: jlik.neg_likelihood_1bit(
        a, b, MEAN, STD, probit, mm), in_axes=(0, 0, 0 if masked else None))(
        jnp.asarray(T), jnp.asarray(y01), None if m is None else jnp.asarray(m))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_pack_sign_mask_matches(problem):
    _, _, y01, mask = problem
    np.testing.assert_array_equal(
        tlik.pack_sign_mask(t(y01), t(mask)).numpy(),
        np.asarray(jlik.pack_sign_mask(jnp.asarray(y01), jnp.asarray(mask))))


@pytest.mark.parametrize("masked", [False, True])
def test_onebit_nll_factors_value_and_grad(problem, masked):
    """Value rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (f32 sums in another
    order).  Gradients stay finite where entries are masked."""
    S, C, y01, mask = problem
    m = mask if masked else np.ones_like(mask)
    inv_s = 1.0 / (STD * jlik._SIGMA_EFF)
    inv_count = 1.0 / np.maximum(m.sum(axis=(1, 2, 3)), 1.0)
    sm = np.asarray(jlik.pack_sign_mask(jnp.asarray(y01), jnp.asarray(m)))

    def jax_one(s, c, smb, ic):
        return jlik.onebit_nll_factors(s, c, smb, jnp.float32(MEAN),
                                       jnp.float32(inv_s), ic)

    ref_v, (ref_gs, ref_gc) = jax.vmap(jax.value_and_grad(
        jax_one, argnums=(0, 1)))(jnp.asarray(S), jnp.asarray(C),
                                  jnp.asarray(sm),
                                  jnp.asarray(inv_count, jnp.float32))
    St = t(S).requires_grad_(True)
    Ct = t(C).requires_grad_(True)
    v = tlik.onebit_nll_factors(St, Ct, t(sm), MEAN, inv_s,
                                t(inv_count.astype(np.float32)))
    gs, gc = torch.autograd.grad(v.sum(), (St, Ct))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref_v),
                               rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ref_gs),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(ref_gc),
                               rtol=1e-4, atol=1e-6)
    assert torch.isfinite(gs).all() and torch.isfinite(gc).all()


def test_get_tensor_and_flat_match(problem):
    S, C, _, _ = problem
    ref = jax.vmap(jlr.get_tensor)(jnp.asarray(S), jnp.asarray(C))
    np.testing.assert_allclose(tlr.get_tensor(t(S), t(C)).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-9)
    Sf = S.reshape(B, R, -1)
    ref_f = jax.vmap(jlr.get_tensor_flat)(jnp.asarray(Sf), jnp.asarray(C))
    np.testing.assert_allclose(tlr.get_tensor_flat(t(Sf), t(C)).numpy(),
                               np.asarray(ref_f), rtol=1e-6, atol=1e-9)


def test_safe_fro_nonneg_and_nmse(problem):
    S, C, _, _ = problem
    np.testing.assert_allclose(float(tlr.safe_fro(t(S))),
                               float(jlr.safe_fro(jnp.asarray(S))), rtol=1e-6)
    per_map = tlr.safe_fro(t(S), dim=(-3, -2, -1))
    ref = jax.vmap(jlr.safe_fro)(jnp.asarray(S))
    np.testing.assert_allclose(per_map.numpy(), np.asarray(ref), rtol=1e-6)
    # gradient at the zero start is 0, not NaN
    z = torch.zeros(2, 3, requires_grad=True)
    (g,) = torch.autograd.grad(tlr.safe_fro(z), z)
    assert torch.equal(g, torch.zeros(2, 3))
    x = S - 0.025
    np.testing.assert_array_equal(tlr.project_nonneg(t(x)).numpy(),
                                  np.asarray(jlr.project_nonneg(jnp.asarray(x))))
    T1, T2 = S[:, 0], S[:, 1]
    np.testing.assert_allclose(
        tmet.nmse(t(T1), t(T2), dim=(-2, -1)).numpy(),
        np.asarray(jax.vmap(jmet.nmse)(jnp.asarray(T1), jnp.asarray(T2))),
        rtol=1e-6)
    np.testing.assert_allclose(float(tmet.nmse(t(T1), t(T2))),
                               float(jmet.nmse(jnp.asarray(T1),
                                               jnp.asarray(T2))), rtol=1e-6)


def _gapped(rng, n, spectrum):
    """[B, n, n] matrices with the given singular values (a clear gap after
    the retained rank keeps the projection well conditioned)."""
    out = []
    for _ in range(B):
        u, _ = np.linalg.qr(rng.normal(size=(n, n)))
        v, _ = np.linalg.qr(rng.normal(size=(n, n)))
        out.append((u * spectrum) @ v.T)
    return np.stack(out).astype(np.float32)


def test_project_rank_matches(rng):
    n, rank = 11, 3
    S = _gapped(rng, n, np.r_[[8.0, 4.0, 2.0], np.geomspace(0.2, 1e-3, n - 3)])
    got = tlr.project_rank(t(S), rank).numpy()
    ref = np.asarray(jlr.project_rank(jnp.asarray(S), rank))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_project_rank_subspace_with_jax_probe(rng):
    """Same probe as the JAX package (PRNGKey(7)): the projections agree to
    1e-4 of the largest entry (QR/eigh in another library; eigenvector
    signs may differ, U Uᵀ S does not)."""
    n, rank, over = 24, 3, 8
    S = _gapped(rng, n, np.r_[[8.0, 4.0, 2.0], np.geomspace(0.2, 1e-3, n - 3)])
    probe = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (n, rank + over), jnp.float32))
    got = tlr.project_rank_subspace(t(S), rank, probe=t(probe)).numpy()
    ref = np.asarray(jlr.project_rank_subspace(jnp.asarray(S), rank))
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_project_rank_subspace_default_probe(rng):
    """With the port's own probe, a matrix of rank <= `rank` is kept as it
    is, and a gapped one lands on the SVD truncation."""
    n, rank = 24, 3
    S = _gapped(rng, n, np.r_[[8.0, 4.0, 2.0], np.zeros(n - 3)])
    got = tlr.project_rank_subspace(t(S), rank)
    np.testing.assert_allclose(got.numpy(), S, atol=1e-5 * np.abs(S).max())
    S2 = _gapped(rng, n, np.r_[[8.0, 4.0, 2.0], np.geomspace(0.05, 1e-4,
                                                              n - 3)])
    np.testing.assert_allclose(
        tlr.project_rank_subspace(t(S2), rank).numpy(),
        tlr.project_rank(t(S2), rank).numpy(), atol=1e-3 * np.abs(S2).max())
    St = t(S)
    assert tlr.project_rank_subspace(St, n) is St   # full rank: unchanged


# --------------------------------------------------------------------------
# boundary tables, the ordinal quantizer and the unfused ordinal likelihood
# --------------------------------------------------------------------------

TABLES = sorted(n for n in dir(jbnd) if n.isupper())


def test_boundary_tables_are_the_same_set():
    assert TABLES == sorted(n for n in dir(tbnd) if n.isupper())


@pytest.mark.parametrize("name", TABLES)
def test_boundary_tables_exact(name):
    assert getattr(tbnd, name) == getattr(jbnd, name)


@pytest.mark.parametrize("n", [1, 4, 8, 256])
def test_uniform_boundaries(n):
    assert tbnd.uniform_boundaries(n) == jbnd.uniform_boundaries(n)


@pytest.mark.parametrize("log", [False, True])
def test_quantize_matches(rng, log):
    """Same noise draws in: the same bin indices out, exactly."""
    table = (tbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG if log
             else tbnd.QUANTIZATION_BOUNDARIES_16_BINS)
    X = rng.uniform(0.0, 0.02, (K, I, I)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, X.shape, jnp.float32))
    std = 5.0 if log else 0.001
    bb = jnp.asarray(np.array(table))
    if log:
        ref = jq.quantize_log(key, jnp.asarray(X), std, bb, tbnd.LOG_OFFSET_4)
        got = tq.quantize_log(t(X), std, table, tbnd.LOG_OFFSET_4,
                              noise=t(noise))
    else:
        ref = jq.quantize(key, jnp.asarray(X), std, bb)
        got = tq.quantize(t(X), std, table, noise=t(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.unique().numel() > 1            # several bins are hit
    mid = tq.dequantize_midpoints(got, table)
    np.testing.assert_array_equal(
        mid.numpy(), np.asarray(jq.dequantize_midpoints(ref, bb)))


def test_quantize_draws_from_generator():
    X = torch.zeros(4, 5, 5)
    a = tq.quantize_log(X, 5.0, tbnd.QUANTIZATION_BOUNDARIES_4_BINS, 1e-10,
                        torch.Generator().manual_seed(0))
    b = tq.quantize_log(X, 5.0, tbnd.QUANTIZATION_BOUNDARIES_4_BINS, 1e-10,
                        torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == X.shape


@pytest.mark.parametrize("masked", [False, True])
def test_log_prob_probit_bounds_and_masked_nll(rng, masked):
    """The unfused ordinal likelihood (value and autograd gradient) against
    the JAX package's on one map: rtol 1e-5 on values, 1e-4 on gradients."""
    table = tbnd.QUANTIZATION_BOUNDARIES_8_BINS_LOG
    Y = rng.integers(0, 8, (K, I, I)).astype(np.int32)
    X = rng.uniform(1e-4, 0.05, (K, I, I)).astype(np.float32)
    m = (rng.uniform(size=Y.shape) < 0.3).astype(np.float32)
    W, U = tlik.gather_bin_bounds(t(Y), table)
    jW, jU = jlik.gather_bin_bounds(jnp.asarray(Y), jnp.asarray(np.array(table)))
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    mm = m if masked else None

    def jf(x):
        lp = jlik.log_prob_probit_bounds(jW, jU, jnp.log(x + 1e-10), 1.0)
        return jlik.masked_nll(lp, None if mm is None else jnp.asarray(mm))

    rv, rg = jax.value_and_grad(jf)(jnp.asarray(X))
    x = t(X).requires_grad_(True)
    v = tlik.masked_nll(tlik.log_prob_probit_bounds(W, U, torch.log(x + 1e-10),
                                                    1.0),
                        None if mm is None else t(mm))
    (g,) = torch.autograd.grad(v, x)
    np.testing.assert_allclose(v.item(), float(rv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(rg)).max())


def test_gather_bin_bounds_clamp_outer():
    Y = torch.tensor([[0, 2]])
    W, U = tlik.gather_bin_bounds(Y, (0.0, 1.0, 2.0, 3.0), clamp_outer=1e5)
    jW, jU = jlik.gather_bin_bounds(jnp.asarray([[0, 2]]),
                                    jnp.asarray([0.0, 1.0, 2.0, 3.0]), 1e5)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))


# --- the rest of the ops core: links, bit packing, metrics, likelihood,
# factors, boundary estimators -------------------------------------------

def test_log_F_probit_and_F_sigmoid_match(rng):
    y = rng.normal(0.0, 0.05, (K, I, I)).astype(np.float32)
    y[0, 0, :3] = (-3.0, -0.5, 0.4)              # deep tails too
    np.testing.assert_allclose(
        tq.log_F_probit(t(y), STD).numpy(),
        np.asarray(jq.log_F_probit(jnp.asarray(y), STD)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(tq.F_sigmoid(t(y)).numpy(),
                               np.asarray(jq.F_sigmoid(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


def test_dither_sigmoid_statistics(rng):
    """Bernoulli(sigmoid(y)): {0,1}, the share of ones within 4 standard
    errors of mean sigmoid, and certain where sigmoid saturates."""
    y = t(rng.normal(0.0, 2.0, (64, 32, 32)).astype(np.float32))
    y[0, 0, :2] = torch.tensor([-200.0, 200.0])
    z = tq.dither_sigmoid(y, torch.Generator().manual_seed(0))
    assert z.dtype == y.dtype and set(z.unique().tolist()) <= {0.0, 1.0}
    assert z[0, 0, :2].tolist() == [0.0, 1.0]
    p = torch.sigmoid(y)
    se = torch.sqrt((p * (1 - p)).sum()) / p.numel()
    assert abs(z.mean() - p.mean()) < 4 * se


@pytest.mark.parametrize("last", [8, 13, 51])
def test_pack_and_unpack_bits_match(rng, last):
    y01 = rng.integers(0, 2, (3, 4, last)).astype(np.float32)
    packed = tq.pack_bits_host(y01)
    np.testing.assert_array_equal(packed, jq.pack_bits_host(y01))
    got = tq.unpack_bits(t(packed), last)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.unpack_bits(jnp.asarray(packed), last)))
    np.testing.assert_array_equal(got.numpy(), y01)


def test_map_metrics_match(rng):
    T_hat = rng.uniform(0.0, 0.1, (K, I, I)).astype(np.float32)
    T_true = rng.uniform(0.0, 0.1, (K, I, I)).astype(np.float32)
    x_hat = rng.uniform(0.0, 1.0, (R, K)).astype(np.float32)
    x_true = rng.uniform(0.0, 1.0, (R, K)).astype(np.float32)
    cases = [
        (tmet.nmse_log(t(T_hat), t(T_true), 1e-10),
         jmet.nmse_log(jnp.asarray(T_hat), jnp.asarray(T_true), 1e-10)),
        (tmet.sre(t(T_hat), t(T_true)),
         jmet.sre(jnp.asarray(T_hat), jnp.asarray(T_true))),
        (tmet.nae(t(x_hat), t(x_true)),
         jmet.nae(jnp.asarray(x_hat), jnp.asarray(x_true))),
        (tmet.nae_tensor(t(T_hat), t(T_true), R),
         jmet.nae_tensor(jnp.asarray(T_hat), jnp.asarray(T_true), R)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_detection_counts_match(rng):
    """Peaks on and off the grid's edge, bands above and below the low
    level: all four counts equal the JAX package's."""
    T_ref = rng.uniform(0.0, 0.03, (K, I, I)).astype(np.float32)
    T_hat = rng.uniform(0.0, 0.03, (K, I, I)).astype(np.float32)
    peaks = np.array([[2.4, 7.6], [-1.0, 12.0], [4.5, 3.5]], np.float32)
    got = tmet.detection_counts(t(T_hat), t(T_ref), t(peaks))
    ref = jmet.detection_counts(jnp.asarray(T_hat), jnp.asarray(T_ref),
                                jnp.asarray(peaks))
    assert [int(x) for x in got] == [int(x) for x in ref]
    assert int(got[0]) > 0 and int(got[2]) > 0


@pytest.mark.parametrize("clamp", [None, 1e5])
def test_prob_probit_and_log_prob_probit_match(rng, clamp):
    table = jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG
    Y = rng.integers(0, 4, (K, I, I))
    X = rng.normal(-8.0, 3.0, (K, I, I)).astype(np.float32)
    bb = np.array(table, np.float32)
    for tf, jf in ((tlik.prob_probit, jlik.prob_probit),
                   (tlik.log_prob_probit, jlik.log_prob_probit)):
        got = tf(t(Y), t(X), table, 5.0, clamp).numpy()
        ref = np.asarray(jf(jnp.asarray(Y), jnp.asarray(X), jnp.asarray(bb),
                            5.0, clamp))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_deterministic_cost_matches(problem):
    S, C, y01, _ = problem
    T_hat = np.einsum("brij,brk->bkij", S, C)
    got = tlik.deterministic_cost(t(T_hat), t(y01), MEAN, 0.01)
    assert got.shape == (B,)
    for b in range(B):
        ref = jlik.deterministic_cost(jnp.asarray(T_hat[b]),
                                      jnp.asarray(y01[b]), MEAN, 0.01)
        np.testing.assert_allclose(got[b].item(), float(ref), rtol=1e-5)


def test_outer_and_init_factors_match(rng):
    mat = rng.normal(size=(I, I)).astype(np.float32)
    vec = rng.normal(size=(K,)).astype(np.float32)
    np.testing.assert_allclose(
        tlr.outer(t(mat), t(vec)).numpy(),
        np.asarray(jlr.outer(jnp.asarray(mat), jnp.asarray(vec))),
        rtol=1e-6, atol=1e-7)
    for got, ref in zip(tlr.init_factors(R, I, I, K),
                        jlr.init_factors(R, I, I, K)):
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        assert not got.any()


@pytest.mark.parametrize("num_bins", [4, 8])
def test_find_boundaries_matches(rng, num_bins):
    """Equal-count bins of log-map samples, with a block of repeated values
    that forces the strictly-increasing fix-up."""
    samples = rng.normal(-8.0, 2.0, 4000).astype(np.float32)
    samples[:1500] = -23.0
    got, sd = tbnd.find_boundaries(t(samples), num_bins)
    ref, rsd = jbnd.find_boundaries(jnp.asarray(samples), num_bins)
    np.testing.assert_array_equal(got, ref)
    assert sd == rsd and np.all(np.diff(got) > 0)


def test_fit_log_offset_matches():
    raw = jbnd.QUANTIZATION_BOUNDARIES_8_BINS_SAMPLE[1:]
    f, b, logs = tbnd.fit_log_offset(raw)
    rf, rb, rlogs = jbnd.fit_log_offset(raw)
    assert (f, b) == (rf, rb)
    assert logs.dtype == torch.float32
    np.testing.assert_array_equal(logs.numpy(), np.asarray(rlogs))
