"""The port's sharded solvers in one process (no process group: the
(1, 1) layout) against the JAX package's on the 8-device CPU mesh of
tests/conftest.py, at the JAX tests' tolerances (tests/test_parallel.py),
with the same inputs made by numpy and JAX's projection probe."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.config import (
    QuantizerConfig as JQuantizer,
    SolverConfig as JSolver,
)
from quantized_spectrum_cartography_tpu.ops import boundaries as JB
from quantized_spectrum_cartography_tpu.ops.quantizer import (
    quantize_log as jax_quantize_log,
)
from quantized_spectrum_cartography_tpu.parallel import (
    batched_recover_lowrank as jax_batched,
    make_mesh as jax_make_mesh,
    make_sharded_mle_step as jax_step,
    recover_lowrank_mle_ksharded as jax_ksharded,
)
from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as B
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import F_probit
from quantized_spectrum_cartography_tpu_torch.parallel import (
    batch_freq_sharding,
    batch_sharding,
    batched_recover_lowrank,
    make_mesh,
    make_sharded_mle_step,
    recover_lowrank_mle_ksharded,
    replicated,
)

torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def test_mesh_without_process_group():
    """One process: the (1, 1) layout, every shard the whole tensor, and a
    layout that needs more ranks refused."""
    m = make_mesh()
    assert m.shape == (1, 1) and m.axis_names == ("data", "model")
    assert m.groups == {"data": None, "model": None}
    assert (m.index("data"), m.index("model")) == (0, 0)
    x = torch.arange(24.0).reshape(2, 3, 4)
    for helper in (batch_sharding, batch_freq_sharding, replicated):
        assert torch.equal(helper(m, x), x)
    with pytest.raises(ValueError):
        make_mesh((2, 1))


def _bounds(T, sigma):
    """W, U of the JAX package's 4-bin log quantizer at `sigma` on T."""
    bb = jnp.asarray(np.array(JB.QUANTIZATION_BOUNDARIES_4_BINS_LOG))
    Y = jax_quantize_log(jax.random.PRNGKey(1), jnp.asarray(T), sigma, bb,
                         JB.LOG_OFFSET_4)
    return np.asarray(bb[Y]), np.asarray(bb[Y + 1])


def _qcfgs(sigma):
    kw = dict(noise_std=sigma, log_offset=B.LOG_OFFSET_4)
    return (JQuantizer(boundaries=JB.QUANTIZATION_BOUNDARIES_4_BINS_LOG, **kw),
            QuantizerConfig(boundaries=B.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
                            **kw))


def test_sharded_mle_step_matches_jax():
    """One gradient step: the JAX step with K over 4 'model' devices
    against the port's; nll rtol 1e-4, S and C rtol 1e-4, atol 1e-7."""
    Bn, R, K, IJ = 4, 2, 16, 256
    rng = np.random.default_rng(0)
    S = rng.uniform(0, 0.05, (Bn, R, IJ)).astype(np.float32)
    C = rng.uniform(0, 1, (Bn, R, K)).astype(np.float32)
    W, U = _bounds(np.einsum("brp,brk->bkp", S, C), 0.0)
    jq, q = _qcfgs(5.0)
    ref = jax_step(jax_make_mesh((2, 4)), JSolver(), jq, lr=0.001)(
        jnp.asarray(S), jnp.asarray(C), jnp.asarray(W), jnp.asarray(U))
    got = make_sharded_mle_step(make_mesh(), SolverConfig(), q, lr=0.001)(
        t(S), t(C), t(W), t(U))
    for a, b, rtol, atol in zip(got, ref, (1e-4, 1e-4, 1e-4),
                                (1e-7, 1e-7, 0.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_ksharded_solver_matches_jax():
    """The full Adam solve, K over 4 'model' devices in JAX, with JAX's
    probe passed to the port: costs rtol 2e-4, factors rtol 1e-3, atol
    1e-6; the solve makes progress."""
    Bn, R, K, G = 2, 2, 16, 16
    IJ = G * G
    rng = np.random.default_rng(3)
    S_true = rng.uniform(0, 0.05, (Bn, R, IJ)).astype(np.float32)
    C_true = rng.uniform(0, 1, (Bn, R, K)).astype(np.float32)
    W, U = _bounds(np.einsum("brp,brk->bkp", S_true, C_true), 0.5)
    jq, q = _qcfgs(5.0)
    kw = dict(max_iters=12, lr_s=0.003, projection_interval=4,
              rank_truncation=6)
    S0 = np.zeros((Bn, R, IJ), np.float32)
    C0 = np.full((Bn, R, K), 0.01, np.float32)
    ref = jax_ksharded(jax_make_mesh((2, 4)), jnp.asarray(W), jnp.asarray(U),
                       jnp.asarray(S0), jnp.asarray(C0), JSolver(**kw), jq)
    probe = t(jax.random.normal(jax.random.PRNGKey(7), (G, 6 + 8),
                                jnp.float32))
    got = recover_lowrank_mle_ksharded(make_mesh(), t(W), t(U), t(S0), t(C0),
                                       SolverConfig(**kw), q, probe=probe)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=2e-4)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-6)
    assert got[2].shape == (Bn, kw["max_iters"])
    assert float(got[2][:, -1].mean()) < float(got[2][:, 0].mean())


def test_batched_recover_lowrank_matches_jax():
    """Data parallelism over maps: JAX's batch sharded over 8 'data'
    devices against the port's one rank holding every row, with JAX's
    probe; rtol 1e-3 on costs, S and C, atol 1e-6 of each array's largest
    entry (the port's low-rank parity test)."""
    Bn, R, K, I = 8, 2, 8, 11
    MEAN, STD = 0.0045, 0.008
    rng = np.random.default_rng(0)
    S = rng.uniform(0.0, 0.3, (Bn, R, I, I)).astype(np.float32)
    C = rng.uniform(0.0, 0.1, (Bn, R, K)).astype(np.float32)
    T = np.einsum("brij,brk->bkij", S, C).astype(np.float32)
    p = F_probit(t(T) - MEAN, STD).numpy()
    T_obs = (rng.uniform(size=T.shape) < p).astype(np.float32)
    S0 = np.zeros((Bn, R, I, I), np.float32)
    C0 = np.full((Bn, R, K), 0.01, np.float32)
    kw = dict(max_iters=6, s_inner_iters=2, c_inner_iters=2,
              projection_interval=3, rank_truncation=3)
    ref = jax_batched(jax_make_mesh((8, 1)), jnp.asarray(T_obs),
                      jnp.asarray(S0), jnp.asarray(C0), JSolver(**kw), MEAN,
                      STD)
    probe = t(jax.random.normal(jax.random.PRNGKey(7), (I, 3 + 8),
                                jnp.float32))
    got = batched_recover_lowrank(make_mesh(), t(T_obs), t(S0), t(C0),
                                  SolverConfig(**kw), MEAN, STD, probe=probe)
    for name in ("costs", "S", "C"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    # each map got an independent solve
    assert float(got.C[:, 0, 0].std()) > 0
