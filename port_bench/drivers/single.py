"""One map at a time: MLE-GAN recoveries back to back, closed loop.

Traffic: independent one-map problems cycled from a pool of `pool_maps`
made in set-up, each with its own observations, mask, start and search
draws.  The window runs whole solves, each ended by a device synchronize,
until `--seconds` have passed; `s_per_map` is all its time over its maps.

The reference runs every iteration of each checked map from the same
inputs, the search included.  The trajectory parts from it by rounding
only after about 200 iterations (`calibrate.py --curve`: the per-iteration
cost gap stays near 1e-7 until then, then grows to some 1e-5), so the
numbers are:
- `early_cost_gap`: the worst relative gap of the per-iteration costs over
  the first `early_iters` iterations, where rounding alone reads about
  1e-7;
- `late_cost_gap`: the same over the iterations after them, where the
  rounding's growth sets the limit: a run that skips or stalls late steps
  leaves the reference's cost curve;
- `iters_gap`: how many iterations the solve reported fewer or more than
  the configuration's (exact, 0);
- `map_gap`: the returned S and T_hat against the reference's generator at
  the returned Z and C.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from port_bench import check, problems, roofline
from port_bench.harness import spans
from port_bench.reference import mlegan as ref
from port_bench.reference.numerics import CONTROL, JUDGE
from port_bench.trace import STRETCH, from_profile


def program_solver(cell, weights) -> Callable:
    """The system under test: `recover_mle_gan` on the bounds pair under
    the port's Generator256 module holding the benchmark's weights."""
    from quantized_spectrum_cartography_tpu_torch.config import (
        QuantizerConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.models.generator import (
        DCGANGenerator)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        make_generator_apply, recover_mle_gan)

    cfg = cell.config
    pr, ob, sv = cfg["prior"], cfg["observation"], cfg["solver"]
    module = DCGANGenerator(pr["z_dim"], [tuple(s) for s in pr["stages"]])
    module = module.to(cell.device)
    state = module.state_dict()
    with torch.no_grad():
        for name, value in weights.items():
            state[name].copy_(value)
    gen_apply = make_generator_apply(module)
    qcfg = QuantizerConfig(boundaries=tuple(ob["boundaries"]),
                           noise_std=ob["noise_std"],
                           log_offset=ob["log_offset"])
    keys = ("max_iters", "lr_c", "lr_z", "lambda_c", "lambda_s",
            "c_inner_iters", "s_inner_iters", "z_dim", "z_search_global",
            "z_search_local", "z_search_local_scale", "z_search_at_iter")

    def solve(p, max_iters):
        scfg = SolverConfig(**{k: sv[k] for k in keys} | {
            "max_iters": max_iters})
        res = recover_mle_gan(
            p["Y"], p["mask"], gen_apply, scfg, qcfg, Z_init=p["Z_init"],
            num_emitters=cfg["physics"]["num_emitters"],
            obs_encoding=sv["obs_encoding"], search_draws=p["draws"])
        return {"S": res.S, "C": res.C, "T_hat": res.T_hat,
                "Z": res.aux["Z"], "costs": res.costs}
    return solve


def control_solver(cell, weights) -> Callable:
    """The reference in TF32, in the program's place."""
    cfg = cell.config

    def solve(p, max_iters):
        return ref.solve(p["Y"], p["mask"], weights, cfg["prior"]["stages"],
                         p["Z_init"], p["draws"], cfg["solver"],
                         cfg["observation"], cfg["observation"]["boundaries"],
                         CONTROL, max_iters=max_iters)
    return solve


@dataclasses.dataclass
class State:
    cell: object
    weights: dict
    pool: list
    solve: Callable
    kept: list = dataclasses.field(default_factory=list)
    chosen: Optional[list] = None


def sync(cell):
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()


def setup(cell, solver=None) -> State:
    gen = problems.generator(cell.seed, cell.device)
    weights = problems.generator_weights(gen, cell.config["prior"])
    pool = problems.mlegan_problems(gen, cell.config, weights,
                                    cell.workload["traffic"]["pool_maps"])
    solve = (solver or program_solver)(cell, weights)
    # warm: a short solve through the search, so every shape the solver
    # gives the generator and the likelihood has been seen
    solve(pool[0], cell.config["solver"]["z_search_at_iter"] + 2)
    sync(cell)
    return State(cell, weights, pool, solve)


def measure(st: State) -> dict:
    cell = st.cell
    iters = cell.config["solver"]["max_iters"]
    skip = cell.workload["trace"]["skip_units"]
    t0 = time.perf_counter()
    ends = [t0]
    j = 0
    while True:
        p = st.pool[j % len(st.pool)]
        if cell.trace and j == skip:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(STRETCH):
                    out = st.solve(p, iters)
                    sync(cell)
            traced = p
        else:
            out = st.solve(p, iters)
            sync(cell)
        st.kept.append(out)
        j += 1
        ends.append(time.perf_counter())
        if (ends[-1] - t0 >= cell.seconds
                and not (cell.trace and j <= skip)):
            break
    elapsed = time.perf_counter() - t0
    trace, work = None, None
    if cell.trace:
        trace = from_profile(prof)
        work = roofline.mlegan_map(cell.config, int(traced["mask"].sum()))
    return {"metrics": {"s_per_map": elapsed / j}, "attempted": j,
            "failed": 0, "trace": trace, "units": 1, "work": work,
            "stderr": [f"window {elapsed:.6f} s, {j} maps; each "
                       f"{spans(ends)}"]}


def release(st: State, window: dict) -> None:
    cell = st.cell
    chosen = check.sample(cell.seed, len(st.kept),
                          cell.workload["check"]["max_maps"], salt=-2)
    st.chosen = [(i % len(st.pool), st.kept[i]) for i in chosen]
    st.kept, st.solve = [], None
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()


def check_numbers(st: State, window: dict) -> dict:
    cfg = st.cell.config
    sv, ob, stages = cfg["solver"], cfg["observation"], cfg["prior"]["stages"]
    n_early = st.cell.workload["check"]["early_iters"]
    iters = sv["max_iters"]
    costs = {}
    early_gap, late_gap, off, map_gap = [], [], [], []
    for k, out in st.chosen:
        p = st.pool[k]
        if k not in costs:
            costs[k] = ref.solve(p["Y"], p["mask"], st.weights, stages,
                                 p["Z_init"], p["draws"], sv, ob,
                                 ob["boundaries"], JUDGE)["costs"]
        got = out["costs"].reshape(-1)
        n = min(len(got), iters)
        off.append(float(abs(iters - len(got))))
        m = min(n, n_early)
        early_gap.append(check.rel_gap(got[:m, None], costs[k][:m, None],
                                       (1,)))
        if n > n_early:
            late_gap.append(check.rel_gap(got[n_early:n, None],
                                          costs[k][n_early:n, None], (1,)))
        with torch.no_grad():
            S = ref.generator_forward(st.weights, stages, out["Z"].double(),
                                      JUDGE)
        T = torch.einsum("rij,rk->kij", S, out["C"].double())
        map_gap.append(max(check.rel_gap(out["S"], S, None),
                           check.rel_gap(out["T_hat"], T, None)))
    return {"early_cost_gap": check.worst(early_gap),
            "late_cost_gap": check.worst(late_gap),
            "iters_gap": max(off, default=float("inf")),
            "map_gap": check.worst(map_gap)}
