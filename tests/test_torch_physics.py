"""Port simulator against the JAX package's.  torch's random numbers are not
jax.random's, so: (1) the deterministic assembly is checked on the JAX
package's own draws, re-drawn here from its keys; (2) whole maps are checked
on their invariants and statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.physics import psd as jpsd
from quantized_spectrum_cartography_tpu.physics import shadowing as jsh
from quantized_spectrum_cartography_tpu.physics import simulator as jsim
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.ops import lowrank as tlr
from quantized_spectrum_cartography_tpu_torch.physics import psd as tpsd
from quantized_spectrum_cartography_tpu_torch.physics import shadowing as tsh
from quantized_spectrum_cartography_tpu_torch.physics import simulator as tsim

torch.set_num_threads(1)

GRID, XC = 15, 30.0


def t(x):
    return torch.tensor(np.array(x))


def test_bumps_and_normalize_match(rng):
    indK = np.arange(1, 33, dtype=np.float32)
    for f0, w in [(5.0, 2.5), (20.0, 3.7), (11.0, 2.0)]:
        np.testing.assert_allclose(
            tpsd.gaussian_bump(t(indK), f0, w).numpy(),
            np.asarray(jpsd.gaussian_bump(jnp.asarray(indK), f0, w)),
            rtol=1e-6, atol=1e-30)
        np.testing.assert_allclose(
            tpsd.sinc_bump(t(indK), f0, w).numpy(),
            np.asarray(jpsd.sinc_bump(jnp.asarray(indK), f0, w)),
            rtol=1e-5, atol=1e-7)
    C = rng.uniform(size=(3, 32)).astype(np.float32)
    C[1] = 0.0
    got, n = tpsd.column_normalize(t(C))
    ref, rn = jpsd.column_normalize(jnp.asarray(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(rn), rtol=1e-6)


@pytest.mark.parametrize("basis", ["g", "s"])
@pytest.mark.parametrize("separable", [True, False])
def test_psd_from_jax_draws(basis, separable):
    """sample_psd's draws (psd.py:52-77) fed to psd_from_draws."""
    K, Q, r = 64, 3, 1
    key = jax.random.PRNGKey(3)
    shared = jnp.asarray([14.0, 30.0]) if not separable else None
    ref = jpsd.sample_psd(key, r, K, basis=basis, separable=separable,
                          num_peaks=Q, shared_peaks=shared)
    k_peaks, k_amp, k_w0, k_w = jax.random.split(key, 4)
    amps = 0.5 + 1.5 * jax.random.uniform(k_amp, (Q + 1,))
    widths = 2.0 + 2.0 * jax.random.uniform(k_w, (Q,))
    if separable:
        cand = jnp.arange(10, K - 1, 2, dtype=jnp.float32)
        perm = jax.random.permutation(k_peaks, cand.shape[0])
        centers = cand[perm[: Q - 1]]
    else:
        centers = shared
    first_w = 2.0 + (3.0 if separable else 2.0) * jax.random.uniform(k_w0, ())
    got = tpsd.psd_from_draws(torch.tensor(float(r)), K, t(amps), t(widths),
                              t(centers), t(first_w), basis=basis,
                              separable=separable)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_too_few_bands_raises():
    with pytest.raises(ValueError, match="too small"):
        tpsd.candidate_centers(12, 3, device="cpu")


def test_helpers_take_the_device_explicitly():
    """No helper of the port defaults to a device: the caller names it."""
    with pytest.raises(TypeError):
        tpsd.candidate_centers(64, 3)
    with pytest.raises(TypeError):
        tlr.default_probe(8, 4)
    assert tpsd.candidate_centers(64, 3, device="cpu").device.type == "cpu"
    assert tlr.default_probe(8, 4, device="cpu").shape == (8, 4)


def test_cholesky_and_shadowing_from_jax_draws():
    np.testing.assert_array_equal(tsh.correlation_cholesky(GRID, XC),
                                  jsh.correlation_cholesky(GRID, XC))
    chol = jnp.asarray(jsh.correlation_cholesky(GRID, XC))
    key = jax.random.PRNGKey(5)
    ref = jsh.sample_shadowing(key, chol, GRID, 4.0)
    iid = 4.0 * jax.random.normal(key, (GRID * GRID,), dtype=jnp.float32)
    got = tsh.correlated_field(t(chol), t(iid), GRID)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_slf_from_jax_draws():
    """sample_slf's draws (simulator.py:38-49) fed to slf_from_draws."""
    cfg = JPhys(grid_size=GRID, decorrelation_distance=XC)
    chol = jnp.asarray(jsh.correlation_cholesky(GRID, XC))
    key = jax.random.PRNGKey(11)
    ref_S, ref_loc = jsim.sample_slf(key, chol, cfg)
    k_loc, k_alpha, k_shadow = jax.random.split(key, 3)
    loc = (GRID - 1.0) * jax.random.uniform(k_loc, (2,))
    alpha = cfg.alpha_lo + cfg.alpha_spread * jax.random.uniform(k_alpha, ())
    shadow = jsh.sample_shadowing(k_shadow, chol, GRID, cfg.shadow_sigma)
    got = tsim.slf_from_draws(t(loc), t(alpha), t(shadow),
                              PhysicsConfig(grid_size=GRID,
                                            decorrelation_distance=XC))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_S), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_array_equal(loc, ref_loc)
    d = np.array([0.0, 1.0, 2.0, 5.0], np.float32)
    np.testing.assert_allclose(tsim.path_loss(t(d), 2.0, 2.3).numpy(),
                               np.asarray(jsim.path_loss(jnp.asarray(d), 2.0,
                                                         2.3)), rtol=1e-6)


@pytest.mark.parametrize("separable", [True, False])
def test_map_batch_invariants_and_statistics(separable):
    """Invariants: unit-norm SLFs and PSDs, C >= 0, T = sum_r S_r o c_r,
    locations inside the grid.  Statistics over 256 maps against the JAX
    simulator's 256: the mean SLF value within 5% and the mean PSD profile
    within 15% of its peak (means over 512 independent fields; the spread
    between draws is about a third of each bound)."""
    Bn, K = 256, 32
    cfg = PhysicsConfig(grid_size=GRID, num_bands=K, decorrelation_distance=XC,
                        separable=separable)
    gen = torch.Generator().manual_seed(0)
    T, S, C, peaks = tsim.generate_map_batch(gen, cfg, Bn, device="cpu")
    assert T.shape == (Bn, K, GRID, GRID) and S.shape == (Bn, 2, GRID, GRID)
    assert C.shape == (Bn, 2, K) and peaks.shape == (Bn, 2, 2)
    np.testing.assert_allclose(S.square().sum((-2, -1)).numpy(), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(C.square().sum(-1).numpy(), 1.0, rtol=1e-5)
    assert (C >= 0).all() and (S > 0).all()
    assert ((peaks >= 0) & (peaks <= GRID - 1)).all()
    np.testing.assert_allclose(T.numpy(), torch.einsum(
        "brij,brk->bkij", S, C).numpy(), rtol=1e-6)
    jcfg = JPhys(grid_size=GRID, num_bands=K, decorrelation_distance=XC,
                 separable=separable)
    jT, jS, jC, _ = jsim.generate_map_batch(jax.random.PRNGKey(0), jcfg, Bn)
    assert abs(S.mean().item() / float(jnp.mean(jS)) - 1.0) < 0.05
    prof, jprof = C.mean((0, 1)).numpy(), np.asarray(jnp.mean(jC, (0, 1)))
    assert np.abs(prof - jprof).max() < 0.15 * jprof.max()


def test_onebit_problem_and_entry_mask():
    cfg = PhysicsConfig(grid_size=GRID, num_bands=32,
                        decorrelation_distance=XC)
    gen = torch.Generator().manual_seed(1)
    prob = tsim.generate_onebit_problem(gen, cfg, sample_fraction=0.1,
                                        device="cpu")
    assert prob.shape == (2, GRID, GRID, 32)
    assert int(prob.Om.sum()) == round(0.1 * GRID * GRID)
    assert (prob.T_true >= 0).all()
    assert torch.equal(prob.T_1bit, torch.where(prob.T_true > cfg.mean_slf,
                                                1.0, -1.0))
    m = tsim.sample_entry_mask(gen, (64, 32, 32), 0.1, device="cpu")
    assert m.dtype == torch.float32 and set(m.unique().tolist()) <= {0.0, 1.0}
    assert abs(m.mean().item() - 0.1) < 4 * np.sqrt(0.09 / m.numel())
