"""The slice as a whole: the port's batched `recover_lowrank_mle` against the
JAX package's, vmapped, on the same 1-bit observations (made with numpy),
with the JAX package's projection probe; resume; JAX state; the CLI."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.config import SolverConfig as JSolver
from quantized_spectrum_cartography_tpu.solvers.lowrank_mle import (
    recover_lowrank_mle as jax_recover,
)
from quantized_spectrum_cartography_tpu_torch.cli import main as cli_main
from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import F_probit
from quantized_spectrum_cartography_tpu_torch.solvers.lowrank_mle import (
    SolverState,
    from_jax_state,
    recover_lowrank_mle,
    to_jax_state,
)

torch.set_num_threads(1)

B, R, K, I = 2, 2, 8, 11
MEAN, STD = 0.0045, 0.008
RANK, OVER = 3, 8
SOLVER = dict(max_iters=10, s_inner_iters=5, c_inner_iters=5, lr_s=0.001,
              lr_c=0.001, projection_interval=5, rank_truncation=RANK)
JAX_PROBE = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (I, RANK + OVER), jnp.float32))


def t(x):
    return torch.tensor(np.array(x))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    S = rng.uniform(0.0, 0.3, (B, R, I, I)).astype(np.float32)
    C = rng.uniform(0.0, 0.1, (B, R, K)).astype(np.float32)
    T = np.einsum("brij,brk->bkij", S, C).astype(np.float32)
    p = F_probit(t(T) - MEAN, STD).numpy()
    T_obs = (rng.uniform(size=T.shape) < p).astype(np.float32)
    mask = (rng.uniform(size=T.shape) < 0.5).astype(np.float32)
    S0 = np.zeros((B, R, I, I), np.float32)
    C0 = np.full((B, R, K), 0.01, np.float32)
    return T, T_obs, mask, S0, C0


def _jax_run(problem, cfg, state=None, **kw):
    T, T_obs, mask, S0, C0 = problem
    m = kw.pop("mask", None)

    def one(tobs, s0, c0, tt, mm, st):
        return jax_recover(tobs, s0, c0, cfg, MEAN, STD, T_true=tt, mask=mm,
                           state=st, **kw)

    return jax.vmap(one)(jnp.asarray(T_obs), jnp.asarray(S0), jnp.asarray(C0),
                         jnp.asarray(T), None if m is None else jnp.asarray(m),
                         state)


def _port_run(problem, cfg, **kw):
    T, T_obs, mask, S0, C0 = problem
    m = kw.pop("mask", None)
    return recover_lowrank_mle(t(T_obs), t(S0), t(C0), cfg, MEAN, STD,
                               T_true=t(T), probe=t(JAX_PROBE),
                               mask=None if m is None else t(m), **kw)


def _assert_close(port, ref):
    """rtol 1e-3 on costs, NMSEs, S and C (atol 1e-6 of each array's
    largest entry, for entries that cross zero)."""
    for name in ("costs", "nmses", "S", "C"):
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


BRANCHES = {
    "kernel": {},
    "kernel_masked": {"mask": True},
    "factors": {"use_fused": False},
    "factors_masked": {"use_fused": False, "mask": True},
    "generic_logistic": {"probit": False},
    "joint": {"joint": True},
    "svd_nonneg": {"cfg": {"projection_method": "svd", "nonneg_slf": True}},
    "ordinal_codes": {"obs_encoding": "codes"},
    "ordinal_codes_masked": {"obs_encoding": "codes", "mask": True},
    "ordinal_bounds": {"obs_encoding": "bounds"},
    "ordinal_bounds_masked": {"obs_encoding": "bounds", "mask": True},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_matches_jax_solver(problem, branch):
    kw = dict(BRANCHES[branch])
    cfg_kw = dict(SOLVER, **kw.pop("cfg", {}))
    if kw.pop("mask", False):
        kw["mask"] = problem[2]
    ref = _jax_run(problem, JSolver(**cfg_kw), **dict(kw))
    port = _port_run(problem, SolverConfig(**cfg_kw), **kw)
    _assert_close(port, ref)
    assert port.costs.shape == (B, SOLVER["max_iters"])
    assert port.aux["state"].iteration == SOLVER["max_iters"]


def test_resume_matches_straight_run(problem):
    """N then M resumed iterations equal N+M straight ones, bitwise; the
    projection cadence (every 3, on the absolute counter) continues across
    the boundary."""
    cfg = SolverConfig(**dict(SOLVER, max_iters=20, projection_interval=3,
                              s_inner_iters=2, c_inner_iters=2))
    half = dataclasses.replace(cfg, max_iters=10)
    straight = _port_run(problem, cfg)
    first = _port_run(problem, half)
    snap = first.aux["state"]
    assert isinstance(snap, SolverState) and snap.iteration == 10
    second = _port_run(problem, half, state=snap)
    assert torch.equal(second.S, straight.S)
    assert torch.equal(second.C, straight.C)
    assert torch.equal(torch.cat([first.costs, second.costs], dim=1),
                       straight.costs)
    assert second.aux["state"].iteration == 20


def test_resume_from_jax_state(problem):
    """A JAX run of N iterations, carried over with `from_jax_state` and
    resumed in the port for M, matches the JAX run of N+M (rtol 1e-3); the
    state survives to_jax_state/from_jax_state unchanged."""
    jcfg = JSolver(**SOLVER)
    first = _jax_run(problem, jcfg)
    st = first.aux["state"]
    arrays = (st.S, st.C, (st.opt_s[0].count, st.opt_s[0].mu, st.opt_s[0].nu),
              (st.opt_c[0].count, st.opt_c[0].mu, st.opt_c[0].nu),
              st.iteration)
    state = from_jax_state(*jax.tree.map(np.asarray, arrays), device="cpu")
    assert state.iteration == SOLVER["max_iters"]
    port = _port_run(problem, SolverConfig(**SOLVER), state=state)
    ref = _jax_run(problem, jcfg, state=st)
    _assert_close(port, ref)

    again = from_jax_state(*to_jax_state(state), device="cpu")
    assert again.iteration == state.iteration
    for a, b in zip(jax.tree.leaves((again.S, again.C, again.opt_s,
                                     again.opt_c)),
                    jax.tree.leaves((state.S, state.C, state.opt_s,
                                     state.opt_c))):
        assert torch.equal(a, b)
    bad = list(to_jax_state(state))
    bad[4] = np.array([10, 11], np.int32)
    with pytest.raises(ValueError, match="iteration differs"):
        from_jax_state(*bad, device="cpu")


@pytest.mark.parametrize("enc", ["codes", "bounds", "nope"])
def test_unported_encodings_raise(problem, enc):
    """Every encoding of the JAX solver is ported now: "codes" and "bounds"
    run through the ordinal kernels' plain versions here and give the same
    costs as the 1-bit pair (rtol 1e-4); only an unknown encoding raises."""
    cfg = SolverConfig(**dict(SOLVER, max_iters=2))
    if enc == "nope":
        with pytest.raises(ValueError, match="unknown"):
            _port_run(problem, cfg, obs_encoding=enc)
        return
    got = _port_run(problem, cfg, obs_encoding=enc)
    ref = _port_run(problem, cfg, obs_encoding="auto")
    torch.testing.assert_close(got.costs, ref.costs, rtol=1e-4, atol=0.0)


def test_cli_recover_and_simulate(tmp_path, capsys):
    """The port's CLI on the CPU: one-line JSON like the JAX package's, for
    every solver (DowJons too, under the default VAE prior); a missing
    .mat fixture raises FileNotFoundError."""
    out = str(tmp_path / "res.npz")
    cli_main(["recover", "--solver", "lowrank", "--iters", "2", "--device",
              "cpu", "--out", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["solver"] == "lowrank" and res["iters"] == 2
    assert np.isfinite(res["final_cost"]) and np.isfinite(res["final_nmse"])
    assert np.load(out)["S"].shape == (2, 51, 51)
    maps = str(tmp_path / "maps.npz")
    cli_main(["simulate", "--batch", "2", "--device", "cpu", "--out", maps])
    assert np.load(maps)["T"].shape == (2, 64, 51, 51)
    cli_main(["recover", "--solver", "dowjons", "--iters", "2", "--device",
              "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["solver"] == "dowjons" and res["iters"] == 2
    assert np.isfinite(res["final_cost"]) and np.isfinite(res["final_nmse"])
    with pytest.raises(FileNotFoundError, match="onebitdata1.mat"):
        cli_main(["recover", "--fixture", str(tmp_path / "onebitdata1.mat"),
                  "--device", "cpu"])
