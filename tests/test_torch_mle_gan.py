"""The MLE-GAN slice as a whole: the port's `recover_mle_gan` against the
JAX package's on the problem of tests/test_gan_solvers.py (cut to K=8),
with the JAX run's own Z_init and z-search draws injected; resume; JAX
state; the `__graft_entry__.entry()` graph; the CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import entry
from quantized_spectrum_cartography_tpu.config import (
    QuantizerConfig as JQuant,
    SolverConfig as JSolver,
)
from quantized_spectrum_cartography_tpu.models import Generator256 as JGen
from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops.quantizer import quantize_log
from quantized_spectrum_cartography_tpu.solvers import (
    make_generator_apply as jax_apply,
    recover_mle_gan as jax_recover,
)
from quantized_spectrum_cartography_tpu_torch.cli import main as cli_main
from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.models import Generator256
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    quantized_nll as q,
)
from quantized_spectrum_cartography_tpu_torch.solvers import (
    GanSolverState,
    make_generator_apply,
    recover_mle_gan,
)
from quantized_spectrum_cartography_tpu_torch.solvers.mle_gan import (
    from_jax_state,
    to_jax_state,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    generator_state_dict_from_flax,
)

torch.set_num_threads(1)

K, R = 8, 2
QUANT = dict(boundaries=jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
             noise_std=5.0, domain="log", log_offset=jbnd.LOG_OFFSET_4)
SOLVER = dict(max_iters=6, z_search_global=8, z_search_local=8,
              z_search_at_iter=1)
KEY = jax.random.PRNGKey(1)


def t(x):
    return torch.tensor(np.array(x))


@pytest.fixture(scope="module")
def gens():
    """The flax Generator256 of tests/test_gan_solvers.py and the port's
    module with its weights."""
    g = JGen()
    variables = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 256)), train=False)
    module = Generator256()
    module.load_state_dict(generator_state_dict_from_flax(
        jax.tree.map(np.asarray, variables))[0])
    return jax_apply(g, variables), make_generator_apply(module)


@pytest.fixture(scope="module")
def problem(gens):
    """Ground truth built from the generator (the prior is realizable)."""
    jgen, _ = gens
    kz, kc, kq, km = jax.random.split(jax.random.PRNGKey(7), 4)
    S_true = jgen(jax.random.normal(kz, (R, 256)))
    C_true = jnp.abs(jax.random.normal(kc, (R, K)))
    T_true = jnp.einsum("rij,rk->kij", S_true, C_true)
    Y = quantize_log(kq, T_true, QUANT["noise_std"],
                     jnp.asarray(np.array(QUANT["boundaries"])),
                     QUANT["log_offset"])
    mask = jax.random.bernoulli(km, 0.3, Y.shape).astype(jnp.float32)
    return np.asarray(T_true), np.asarray(Y), np.asarray(mask)


def jax_draws(cfg):
    """The JAX solver's Z_init and search normals from KEY, as it splits it."""
    key, kz = jax.random.split(KEY)
    Z_init = jax.random.normal(kz, (R, 256))
    _, ks = jax.random.split(key)
    k1, k2 = jax.random.split(ks)
    G, L = cfg["z_search_global"], cfg["z_search_local"]
    return (np.asarray(Z_init),
            (np.asarray(jax.random.normal(k1, (G, R, 256))),
             np.asarray(jax.random.normal(k2, (L, R, 256)))))


def run_jax(gens, problem, cfg, state=None, **kw):
    T, Y, mask = problem
    return jax_recover(KEY, jnp.asarray(Y), jnp.asarray(mask), gens[0],
                       JSolver(**cfg), JQuant(**QUANT), num_emitters=R,
                       T_true=jnp.asarray(T), state=state, **kw)


def run_port(gens, problem, cfg, state=None, **kw):
    T, Y, mask = problem
    Z_init, draws = jax_draws(cfg)
    return recover_mle_gan(t(Y), t(mask), gens[1], SolverConfig(**cfg),
                           QuantizerConfig(**QUANT), Z_init=t(Z_init),
                           num_emitters=R, T_true=t(T), state=state,
                           search_draws=tuple(map(t, draws)), **kw)


def assert_close(port, ref):
    """rtol 1e-3 on costs, NMSEs, C and Z (atol 1e-6 of each array's
    largest entry, for entries at or near zero)."""
    for name, a, b in (("costs", port.costs, ref.costs),
                       ("nmses", port.nmses, ref.nmses),
                       ("C", port.C, ref.C),
                       ("Z", port.aux["Z"], ref.aux["Z"])):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


BRANCHES = {
    "bounds": {"obs_encoding": "bounds"},
    "codes": {"obs_encoding": "codes"},
    "unfused": {"use_fused": False},
    "no_search": {"cfg": {"z_search_global": 0, "z_search_local": 0}},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_matches_jax_solver(gens, problem, branch):
    kw = dict(BRANCHES[branch])
    cfg = dict(SOLVER, **kw.pop("cfg", {}))
    ref = run_jax(gens, problem, cfg, **kw)
    port = run_port(gens, problem, cfg, **kw)
    assert_close(port, ref)
    costs = port.costs.numpy()
    assert costs.shape == (6,) and np.all(np.isfinite(costs))
    assert port.T_hat.shape == (K, 51, 51) and (port.C >= 0).all()
    assert port.aux["state"].iteration == 6


@pytest.mark.parametrize("split", [1, 3])
def test_resume_matches_straight_run(gens, problem, split):
    """N then M resumed iterations equal N+M straight ones, bitwise, with
    the z-search at absolute iteration 1 falling in the second segment
    (split 1) or the first (split 3), and run once either way."""
    straight = run_port(gens, problem, SOLVER)
    first = run_port(gens, problem, dict(SOLVER, max_iters=split))
    snap = first.aux["state"]
    assert isinstance(snap, GanSolverState) and snap.iteration == split
    second = run_port(gens, problem, dict(SOLVER, max_iters=6 - split),
                      state=snap)
    assert torch.equal(second.C, straight.C)
    assert torch.equal(second.aux["Z"], straight.aux["Z"])
    assert torch.equal(torch.cat([first.costs, second.costs]),
                       straight.costs)


def test_resume_from_jax_state(gens, problem):
    """A JAX run of 3 iterations carried over with `from_jax_state` and
    resumed in the port for 3 matches the JAX run resumed for 3 (rtol
    1e-3); the state survives to_jax_state/from_jax_state unchanged."""
    cfg = dict(SOLVER, max_iters=3)
    st = run_jax(gens, problem, cfg).aux["state"]
    state = from_jax_state(
        st.C, st.Z, (st.opt_c[0].count, st.opt_c[0].mu, st.opt_c[0].nu),
        (st.opt_z[0].count, st.opt_z[0].mu, st.opt_z[0].nu), st.iteration,
        device="cpu")
    assert state.iteration == 3
    assert_close(run_port(gens, problem, cfg, state=state),
                 run_jax(gens, problem, cfg, state=st))
    again = from_jax_state(*to_jax_state(state), device="cpu")
    assert again.iteration == state.iteration
    for a, b in zip(jax.tree.leaves((again.C, again.Z, again.opt_c,
                                     again.opt_z)),
                    jax.tree.leaves((state.C, state.Z, state.opt_c,
                                     state.opt_z))):
        assert torch.equal(a, b)


def test_entry_graph_matches_jax(gens):
    """`__graft_entry__.entry()`: the coded NLL of G(Z) at its own inputs
    (Generator256 from PRNGKey(0), the 4-bin log table, sigma 5, a random
    half mask), the port's plain coded likelihood against the JAX graph."""
    fn, (Z0, C0) = entry()
    ref = float(fn(Z0, C0))
    rng = np.random.default_rng(0)
    Y = rng.integers(0, 4, (64, 51, 51))
    mask = rng.integers(0, 2, (64, 51, 51)).astype(np.float32)
    codes = q.pack_codes(t(Y), 4, t(mask))
    with torch.no_grad():
        S = gens[1](t(np.asarray(Z0)))
    v = q.fused_quantized_nll_coded(
        S.reshape(1, R, -1), t(np.asarray(C0))[None], codes[None],
        jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0, jbnd.LOG_OFFSET_4)
    np.testing.assert_allclose(v.item(), ref, rtol=1e-4)


def test_cli_recover_mle_gan(gens, tmp_path, capsys):
    """`recover --solver mle-gan --prior-kind gan` on the CPU, with the
    prior read from an .npz of the flax tree, and from the trained
    checkpoint directory; the default, the trained VAE prior."""
    variables = JGen().init(jax.random.PRNGKey(0), jnp.zeros((1, 256)),
                            train=False)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        flat["/".join(p.key for p in path)] = np.asarray(leaf)
    ckpt = str(tmp_path / "gan256.npz")
    np.savez(ckpt, scale=np.float32(2.0), **flat)
    out = str(tmp_path / "res.npz")
    cli_main(["recover", "--solver", "mle-gan", "--prior-kind", "gan",
              "--prior-checkpoint", ckpt, "--iters", "2", "--device", "cpu",
              "--out", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["solver"] == "mle-gan" and res["iters"] == 2
    assert np.isfinite(res["final_cost"]) and np.isfinite(res["final_nmse"])
    assert np.load(out)["S"].shape == (2, 51, 51)
    # one iteration: the z-search (at iteration 1) does not run
    for argv in (["--prior-kind", "gan", "--prior-checkpoint",
                  "checkpoints/gan256/final"], []):
        cli_main(["recover", "--solver", "mle-gan", "--iters", "1",
                  "--device", "cpu"] + argv)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["iters"] == 1 and np.isfinite(res["final_cost"])
        assert np.isfinite(res["final_nmse"])
