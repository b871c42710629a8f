"""The port's CUDA kernels on the card (marked `cuda`; they skip without a
GPU, since a CUDA kernel has no CPU mode).  This file imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import dataclasses

import pytest
import torch

from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    quantized_nll as q,
)
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    quantize,
    quantize_log,
)
from quantized_spectrum_cartography_tpu_torch.solvers.lowrank_mle import (
    recover_lowrank_mle,
)

MEAN, STD = 0.0045, 0.008
# the ordinal kernels' cases: (boundary table, sigma, offset, linear link)
ORDINAL = {
    "log4_fast": (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0,
                  bnd.LOG_OFFSET_4, False),
    "log8_robust": (bnd.QUANTIZATION_BOUNDARIES_8_BINS_LOG, 1.0,
                    bnd.LOG_OFFSET_4, False),
    "onebit_linear": (q.onebit_bounds(MEAN), STD, 0.0, True),
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 2, 7, 10, 16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,K,I", [(256, 64, 51), (8, 5, 10), (8, 64, 10),
                                   (8, 5, 51)])
def test_kernels_match_plain(gen, rank, masked, B, K, I):
    """The bench shapes (B=256, K=64, 51x51) and ragged ones (P = 100 or
    2601, K = 5 or 64: neither a multiple of a thread's tile of columns or
    bands), every tile width the kernels pick (ranks 1..16): value rtol
    1e-5, gradients within 1e-4 of max |grad|; a second launch gives the
    same bits."""
    S = 0.05 * torch.rand(B, rank, I * I, generator=gen, device="cuda")
    C = torch.rand(B, K, rank, generator=gen, device="cuda")
    y01 = (torch.rand(B, K, I, I, generator=gen, device="cuda") < 0.5).float()
    mask = ((torch.rand(B, K, I, I, generator=gen, device="cuda") < 0.1)
            .float() if masked else None)
    codes = k.pack_codes_1bit(y01, mask)
    g = 0.5 + torch.rand(B, generator=gen, device="cuda")
    v = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
    dS, dC = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
    v2 = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
    dS2, dC2 = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
    torch.cuda.synchronize()
    v0 = k.onebit_nll_plain(S, C, codes, MEAN, STD)
    dS0, dC0 = k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)
    assert ((v - v0).abs() / v0.abs()).max() <= 1e-5
    assert (dS - dS0).abs().max() <= 1e-4 * dS0.abs().max()
    assert (dC - dC0).abs().max() <= 1e-4 * dC0.abs().max()
    assert torch.equal(v, v2) and torch.equal(dS, dS2) and torch.equal(dC, dC2)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(gen):
    S = torch.rand(2, 3, 100, generator=gen, device="cuda")
    C = torch.rand(2, 8, 3, generator=gen, device="cuda")
    codes = torch.zeros(2, 8, 100, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        k.onebit_nll_fwd_cuda(S, C.transpose(1, 2).contiguous().transpose(1, 2),
                              codes, MEAN, STD)
    with pytest.raises(TypeError, match="int8"):
        k.onebit_nll_fwd_cuda(S, C, codes.float(), MEAN, STD)
    with pytest.raises(ValueError, match="rank"):
        k.onebit_nll_fwd_cuda(torch.rand(2, 17, 100, device="cuda"),
                              torch.rand(2, 8, 17, device="cuda"), codes,
                              MEAN, STD)


@pytest.mark.cuda
def test_solver_on_card_matches_plain_and_resumes_bitwise(gen):
    """A small solve through the kernels agrees with nll_mode="plain"
    (rtol 1e-4 on the costs), and, with no float atomics anywhere in the
    kernels, N + M resumed iterations equal N+M straight ones bitwise."""
    B, R, K, I = 4, 2, 16, 21
    T = torch.einsum("brij,brk->bkij",
                     0.3 * torch.rand(B, R, I, I, generator=gen, device="cuda"),
                     0.1 * torch.rand(B, R, K, generator=gen, device="cuda"))
    T_obs = (torch.rand(T.shape, generator=gen, device="cuda")
             < 0.5 * (1 + torch.erf((T - MEAN) / (STD * 1.414213)))).float()
    S0 = torch.zeros(B, R, I, I, device="cuda")
    C0 = torch.full((B, R, K), 0.01, device="cuda")
    cfg = SolverConfig(max_iters=12, s_inner_iters=3, c_inner_iters=3,
                       lr_s=0.001, lr_c=0.001, projection_interval=5)
    run = lambda c, **kw: recover_lowrank_mle(T_obs, S0, C0, c, MEAN, STD,  # noqa: E731
                                              T_true=T, **kw)
    k.reset_launches()
    straight = run(cfg)
    assert k.onebit_nll_fwd_cuda.launches == 12 * 6
    assert k.onebit_nll_bwd_cuda.launches == 12 * 6
    plain = run(cfg, nll_mode="plain")
    torch.testing.assert_close(straight.costs, plain.costs, rtol=1e-4,
                               atol=0.0)
    half = dataclasses.replace(cfg, max_iters=6)
    first = run(half)
    second = run(half, state=first.aux["state"])
    assert torch.equal(second.S, straight.S)
    assert torch.equal(second.C, straight.C)


def ordinal_inputs(gen, case, B, R, masked, K=64, I=51):
    """S, C, (W, U), codes, g for one case: Y quantized from C@S itself;
    for "onebit_half_sentinel", random signs packed as the 1-bit encodings
    pack them ((mean, +1e4) and (-1e4, mean) as bounds)."""
    S = 0.05 * torch.rand(B, R, I * I, generator=gen, device="cuda")
    C = torch.rand(B, K, R, generator=gen, device="cuda")
    if case == "onebit_half_sentinel":
        y01 = (torch.rand(B, K, I, I, generator=gen, device="cuda") < 0.5)
        Y, table = y01.float(), q.onebit_bounds(MEAN)
    else:
        table, sigma, offset, linear = ORDINAL[case]
        X = torch.matmul(C, S).reshape(B, K, I, I)
        Y = (quantize(X, sigma, table, gen) if linear
             else quantize_log(X, sigma, table, offset, gen))
    mask = ((torch.rand(B, K, I, I, generator=gen, device="cuda") < 0.1)
            .float() if masked else None)
    g = 0.5 + torch.rand(B, generator=gen, device="cuda")
    if case == "onebit_half_sentinel":
        return (S, C, q.pack_bounds_1bit(Y, MEAN, mask),
                k.pack_codes_1bit(Y, mask), g)
    return (S, C, q.pack_bounds(Y, table, mask),
            q.pack_codes(Y, len(table) - 1, mask), g)


@pytest.mark.cuda
@pytest.mark.parametrize("case,rank,masked,B,K,I", [
    (case, rank, masked, B, K, I) for case in sorted(ORDINAL)
    for rank in (2, 10) for masked in (False, True)
    for B, K, I in ((8, 64, 51), (1, 64, 51), (3, 70, 37))
] + [("log4_fast", 16, True, 2, 256, 51),
     ("log8_robust", 16, False, 2, 256, 51),
     ("onebit_half_sentinel", 2, True, 3, 70, 37)])
def test_ordinal_kernels_match_plain(gen, case, rank, masked, B, K, I):
    """Both encodings, forward and backward, each against its plain version:
    value rtol 1e-5, gradients within 1e-4 of max |grad|; the coded kernels
    give the bounds kernels' bits (one tile body, the same entries in the
    same order); a second launch gives the same bits.  Shapes: a batch, the
    MLE-GAN shape (B=1), one whose P = 37*37 and K = 70 leave a partial tile
    of columns and a partial chunk of bands, K = 256 bands (four chunks) at
    rank 16, and the 1-bit bounds with one bound at the sentinel."""
    table, sigma, offset, linear = (
        (q.onebit_bounds(MEAN), STD, 0.0, True)
        if case == "onebit_half_sentinel" else ORDINAL[case])
    fast = q._fast_ok(sigma)
    S, C, (W, U), codes, g = ordinal_inputs(gen, case, B, rank, masked, K=K,
                                            I=I)
    st = (sigma, offset, linear, fast)

    def run():
        return (q.quantized_nll_fwd_cuda(S, C, W, U, *st),
                *q.quantized_nll_bwd_cuda(S, C, W, U, g, *st),
                q.quantized_nll_coded_fwd_cuda(S, C, codes, table, *st),
                *q.quantized_nll_coded_bwd_cuda(S, C, codes, table, g, *st))

    out, again = run(), run()
    torch.cuda.synchronize()
    v0 = q.quantized_nll_plain(S, C, W, U, *st)
    dS0, dC0 = q.quantized_nll_grad_plain(S, C, W, U, g, *st)
    vc0 = q.quantized_nll_coded_plain(S, C, codes, table, *st)
    dSc0, dCc0 = q.quantized_nll_coded_grad_plain(S, C, codes, table, g, *st)
    v, dS, dC, vc, dSc, dCc = out
    assert torch.isfinite(v).all() and torch.isfinite(dS).all()
    assert torch.isfinite(vc).all() and torch.isfinite(dSc).all()
    for (a, b, c), (a0, b0, c0) in (((v, dS, dC), (v0, dS0, dC0)),
                                    ((vc, dSc, dCc), (vc0, dSc0, dCc0))):
        assert ((a - a0).abs() / a0.abs()).max() <= 1e-5
        assert (b - b0).abs().max() <= 1e-4 * b0.abs().max()
        assert (c - c0).abs().max() <= 1e-4 * c0.abs().max()
    assert all(torch.equal(a, b) for a, b in zip((vc, dSc, dCc), (v, dS, dC)))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
def test_ordinal_scorer_shares_inputs(gen):
    """The scorer's one launch over N candidates with C and the observations
    shared (batch stride 0) equals N per-candidate launches, bitwise."""
    table, sigma, offset, linear = ORDINAL["log4_fast"]
    S, C, (W, U), codes, _ = ordinal_inputs(gen, "log4_fast", 1, 2, True)
    cand = 0.05 * torch.rand(33, 2, S.shape[-1], generator=gen, device="cuda")
    for obs, bb in (((W, U), None), ((codes,), table)):
        scores = q.score_quantized_nll(cand, C, obs, sigma, offset, bb)
        one = torch.cat([q.score_quantized_nll(c[None], C, obs, sigma,
                                               offset, bb) for c in cand])
        assert torch.equal(scores, one)
        plain = q.score_quantized_nll(cand, C, obs, sigma, offset, bb,
                                      mode="plain")
        assert ((scores - plain).abs() / plain.abs()).max() <= 1e-5


@pytest.mark.cuda
def test_ordinal_masked_entries_are_exact_zero(gen):
    """An all-masked map: NLL 0 and gradients 0 from every kernel."""
    table, sigma, offset, linear = ORDINAL["log8_robust"]
    S, C, _, codes, g = ordinal_inputs(gen, "log8_robust", 2, 3, False)
    codes = torch.full_like(codes, len(table) - 1)
    W, U = q._bounds_from_codes(codes, table)
    st = (sigma, offset, linear, False)
    for v in (q.quantized_nll_fwd_cuda(S, C, W, U, *st),
              q.quantized_nll_coded_fwd_cuda(S, C, codes, table, *st)):
        assert torch.equal(v, torch.zeros_like(v))
    for dS, dC in (q.quantized_nll_bwd_cuda(S, C, W, U, g, *st),
                   q.quantized_nll_coded_bwd_cuda(S, C, codes, table, g,
                                                  *st)):
        assert not dS.any() and not dC.any()


@pytest.mark.cuda
def test_ordinal_wrapper_rejects_bad_inputs(gen):
    S, C, (W, U), codes, g = ordinal_inputs(gen, "log4_fast", 2, 2, False,
                                            K=8, I=10)
    with pytest.raises(ValueError, match="per-map"):
        q.quantized_nll_bwd_cuda(S, C[:1], W, U, g, 5.0, 1e-10)
    with pytest.raises(TypeError, match="int8"):
        q.quantized_nll_coded_fwd_cuda(S, C, codes.float(), (0.0, 1.0),
                                       5.0, 1e-10)
    with pytest.raises(ValueError, match="bins"):
        q.quantized_nll_coded_fwd_cuda(S, C, codes, tuple(range(34)), 5.0,
                                       1e-10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        q.quantized_nll_fwd_cuda(S.cpu(), C.cpu(), W.cpu(), U.cpu(), 5.0,
                                 1e-10)
    wide = torch.zeros(1, 1, q._MAX_P, device="cuda")
    with pytest.raises(ValueError, match="columns"):
        q.quantized_nll_fwd_cuda(wide, C[:1, :1, :1].contiguous(), wide, wide,
                                 5.0, 1e-10)
