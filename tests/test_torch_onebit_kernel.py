"""The 1-bit likelihood pair of the port (ops/kernels/onebit_nll.py):

- its numerics and its plain forward/backward against the JAX package's
  `fused_onebit_nll`, run in Pallas interpret mode, with and without a mask;
- dispatch and input checks.  The CUDA kernels themselves are checked on
  the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.ops.lowrank import pad_spatial
from quantized_spectrum_cartography_tpu.ops.pallas import fused_likelihood as jfl
from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k

torch.set_num_threads(1)

B, R, K, I = 2, 3, 8, 11
P = I * I
MEAN, STD = 0.0045, 0.008


def t(x):
    return torch.tensor(np.array(x))


@pytest.fixture
def inputs(rng):
    """S, C scaled so t = sgn*(C@S - mean)/s spans both branches of the
    numerics (the Mills tail below -4 and the direct form above)."""
    S = rng.uniform(0.001, 0.05, (B, R, P)).astype(np.float32)
    C = rng.uniform(0.0, 1.0, (B, K, R)).astype(np.float32)
    y01 = rng.integers(0, 2, (B, K, I, I)).astype(np.float32)
    mask = rng.integers(0, 2, (B, K, I, I)).astype(np.float32)
    return S, C, y01, mask


@pytest.mark.parametrize("fn", ["_erf", "_log_ndtr", "_hazard_ratio"])
def test_numerics_match_jax(fn):
    """Same f32 formulas: agree to a few ulp (exp/log of two libraries)."""
    x = np.r_[np.linspace(-80.0, 10.0, 9001), -4.0, np.nextafter(-4.0, 0),
              np.nextafter(-4.0, -5)].astype(np.float32)
    got = getattr(k, fn)(t(x)).numpy()
    ref = np.asarray(getattr(jfl, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_pack_codes_1bit_matches(inputs, masked):
    _, _, y01, mask = inputs
    m = mask if masked else None
    got = k.pack_codes_1bit(t(y01), None if m is None else t(m))
    assert got.dtype == torch.int8 and got.shape == (B, K, P)
    for b in range(B):
        ref = jfl.pack_codes_1bit(jnp.asarray(y01[b]),
                                  None if m is None else jnp.asarray(m[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref)[:, :P])


@pytest.mark.parametrize("masked", [False, True])
def test_plain_pair_matches_pallas_interpret(inputs, masked):
    """Plain fwd/bwd (through the autograd entry point on CPU tensors) vs
    the Pallas kernels in interpret mode, per map.  Value rtol 1e-5;
    gradients rtol 1e-4, atol 1e-6."""
    S, C, y01, mask = inputs
    m = mask if masked else None
    codes = k.pack_codes_1bit(t(y01), None if m is None else t(m))
    St, Ct = t(S).requires_grad_(True), t(C).requires_grad_(True)
    v = k.fused_onebit_nll(St, Ct, codes, MEAN, STD)
    gS, gC = torch.autograd.grad(v.sum(), (St, Ct))
    assert torch.isfinite(gS).all() and torch.isfinite(gC).all()
    for b in range(B):
        Yc = jfl.pack_codes_1bit(jnp.asarray(y01[b]),
                                 None if m is None else jnp.asarray(m[b]))
        f = lambda s, c: jfl.fused_onebit_nll(s, c, Yc, MEAN, STD, True)  # noqa: E731
        rv, (rS, rC) = jax.value_and_grad(f, (0, 1))(
            pad_spatial(jnp.asarray(S[b])), jnp.asarray(C[b]))
        np.testing.assert_allclose(v[b].item(), float(rv), rtol=1e-5)
        np.testing.assert_allclose(gS[b].numpy(), np.asarray(rS)[:, :P],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gC[b].numpy(), np.asarray(rC),
                                   rtol=1e-4, atol=1e-6)


def test_masked_entries_are_exact_zero(inputs):
    """All-masked maps: NLL 0 and gradient 0, never NaN (no 0*inf)."""
    S, C, y01, _ = inputs
    codes = k.pack_codes_1bit(t(y01), torch.zeros(B, K, I, I))
    g = torch.ones(B)
    assert torch.equal(k.onebit_nll_plain(t(S), t(C), codes, MEAN, STD),
                       torch.zeros(B))
    dS, dC = k.onebit_nll_grad_plain(t(S), t(C), codes, g, MEAN, STD)
    assert torch.equal(dS, torch.zeros_like(dS))
    assert torch.equal(dC, torch.zeros_like(dC))


def test_dispatch_and_checks(inputs):
    """CPU tensors take the plain version (no launch); the CUDA wrappers
    refuse CPU tensors before building anything; unknown modes raise."""
    S, C, y01, _ = inputs
    codes = k.pack_codes_1bit(t(y01))
    k.reset_launches()
    for mode in ("auto", "plain"):
        v = k.fused_onebit_nll(t(S), t(C), codes, MEAN, STD, mode)
        np.testing.assert_array_equal(
            v.numpy(), k.onebit_nll_plain(t(S), t(C), codes, MEAN, STD).numpy())
    assert k.onebit_nll_fwd_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        k.onebit_nll_fwd_cuda(t(S), t(C), codes, MEAN, STD)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k.onebit_nll_bwd_cuda(t(S), t(C), codes, torch.ones(B), MEAN, STD)
    with pytest.raises(ValueError, match="mode"):
        k.fused_onebit_nll(t(S), t(C), codes, MEAN, STD, "pallas")
