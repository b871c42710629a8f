"""Offline batched recovery: back-to-back solves of B maps, closed loop.

Traffic (the cell's "traffic"): `batch` maps a solve, cycled from a pool of
`pool_batches` batches of 1-bit observations made in set-up.  The window
runs whole solves, each ended by a device synchronize, until `--seconds`
have passed; `maps_per_s` is all its maps over all its time.

The check: `sample_maps` maps drawn from the seed among `positions` rows
kept of each solve; the reference (float64) solves their inputs again.
Numbers: `map_gap_p90`, the 90th percentile over the maps of
||T - T_ref|| / ||T_ref|| for the map rebuilt from the returned factors
(a percentile: a map whose 10th and 11th singular values nearly tie makes
the rank-10 projection ill-conditioned, so single maps part from the
reference by far more than rounding, in the program and the control
alike); `that_gap`, the worst gap of the returned T_hat against those
factors; `cost_gap`, the worst gap of the last cost against the
reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from port_bench import check, problems, roofline
from port_bench.harness import spans
from port_bench.reference import lowrank as ref
from port_bench.reference.numerics import CONTROL, JUDGE
from port_bench.trace import STRETCH, from_profile


def program_solver(cell, probe) -> Callable:
    """The system under test: `recover_lowrank_mle` on the 1-bit kernel
    pair (obs_encoding "auto"), with the benchmark's probe."""
    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_lowrank_mle,
    )

    sv, ob = cell.config["solver"], cell.config["observation"]

    def solve(y01, S0, C0, max_iters):
        scfg = SolverConfig(
            max_iters=max_iters, s_inner_iters=sv["s_inner_iters"],
            c_inner_iters=sv["c_inner_iters"], lr_s=sv["lr_s"],
            lr_c=sv["lr_c"], projection_interval=sv["projection_interval"],
            rank_truncation=sv["rank_truncation"],
            projection_method=sv["projection_method"])
        res = recover_lowrank_mle(
            y01, S0, C0, scfg, ob["threshold"], ob["dither_std"],
            l1=sv["l1"], l2=sv["l2"], obs_encoding=sv["obs_encoding"],
            probe=probe)
        return {"S": res.S, "C": res.C, "T_hat": res.T_hat,
                "cost": res.costs[:, -1]}
    return solve


def control_solver(cell, probe) -> Callable:
    """The reference in TF32, in the program's place."""
    ob = cell.config["observation"]

    def solve(y01, S0, C0, max_iters):
        return ref.solve(y01, S0, C0, probe, cell.config["solver"],
                         ob["threshold"], ob["dither_std"], CONTROL,
                         max_iters=max_iters)
    return solve


@dataclasses.dataclass
class State:
    cell: object
    pool: list
    probe: torch.Tensor
    S0: torch.Tensor
    C0: torch.Tensor
    solve: Callable
    kept: list = dataclasses.field(default_factory=list)
    chosen: Optional[list] = None
    per_map: Optional[list] = None


def setup(cell, solver=None) -> State:
    tr = cell.workload["traffic"]
    gen = problems.generator(cell.seed, cell.device)
    B = tr["batch"]
    pool = problems.onebit_batches(gen, cell.config, B, tr["pool_batches"])
    probe = problems.probe(gen, cell.config)
    S0, C0 = problems.starts(cell.config, B, cell.device)
    solve = (solver or program_solver)(cell, probe)
    # warm: every shape of the solve, one projection included
    solve(pool[0], S0, C0, cell.config["solver"]["projection_interval"])
    sync(cell)
    return State(cell, pool, probe, S0, C0, solve)


def sync(cell):
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()


def measure(st: State) -> dict:
    cell = st.cell
    tr, B = cell.workload["traffic"], cell.workload["traffic"]["batch"]
    iters = cell.config["solver"]["max_iters"]
    skip = cell.workload["trace"]["skip_units"]
    trace = None
    t0 = time.perf_counter()
    ends = [t0]
    j = 0
    while True:
        y01 = st.pool[j % len(st.pool)]
        if cell.trace and j == skip:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(STRETCH):
                    out = st.solve(y01, st.S0, st.C0, iters)
                    sync(cell)
        else:
            out = st.solve(y01, st.S0, st.C0, iters)
            sync(cell)
        pos = check.sample(cell.seed, B, tr["positions"], salt=j)
        st.kept.append({"S": out["S"], "C": out["C"],
                        "cost": out["cost"],
                        "T_rows": out["T_hat"][pos], "pos": pos})
        del out
        j += 1
        ends.append(time.perf_counter())
        if (ends[-1] - t0 >= cell.seconds
                and not (cell.trace and j <= skip)):
            break
    elapsed = time.perf_counter() - t0
    if cell.trace:
        trace = from_profile(prof)
    return {"metrics": {"maps_per_s": j * B / elapsed},
            "attempted": j * B, "failed": 0, "trace": trace, "units": 1,
            "work": roofline.lowrank_solve(cell.config, B),
            "stderr": [f"window {elapsed:.6f} s, {j} solves of {B} maps; "
                       f"each {spans(ends)}"]}


def release(st: State, window: dict) -> None:
    """Keep the sampled maps' inputs and answers; free the rest."""
    cell = st.cell
    pairs = [(j, r) for j, k in enumerate(st.kept)
             for r in range(len(k["pos"]))]
    chosen = check.sample(cell.seed, len(pairs),
                          cell.workload["check"]["sample_maps"], salt=-1)
    st.chosen = []
    for i in chosen:
        j, r = pairs[i]
        k, m = st.kept[j], st.kept[j]["pos"][r]
        st.chosen.append({"key": (j % len(st.pool), m),
                          "y01": st.pool[j % len(st.pool)][m],
                          "S": k["S"][m], "C": k["C"][m],
                          "cost": k["cost"][m], "T_row": k["T_rows"][r]})
    st.kept, st.pool, st.solve = [], [], None
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()


def reference_answers(cell, probe, inputs: dict) -> dict:
    """The judge's answers for the distinct inputs {key: y01}."""
    keys = list(inputs)
    ob = cell.config["observation"]
    y01 = torch.stack([inputs[k] for k in keys])
    S0, C0 = problems.starts(cell.config, len(keys), y01.device)
    out = ref.solve(y01, S0, C0, probe, cell.config["solver"],
                    ob["threshold"], ob["dither_std"], JUDGE)
    return {k: {"T": out["T_hat"][i], "cost": out["cost"][i]}
            for i, k in enumerate(keys)}


def check_numbers(st: State, window: dict) -> dict:
    refs = reference_answers(st.cell, st.probe,
                             {c["key"]: c["y01"] for c in st.chosen})
    map_gap, that_gap, cost_gap = [], [], []
    for c in st.chosen:
        r = refs[c["key"]]
        T = torch.einsum("rij,rk->kij", c["S"].double(), c["C"].double())
        map_gap.append(check.rel_gap(T, r["T"], None))
        that_gap.append(check.rel_gap(c["T_row"], T, None))
        cost_gap.append(check.rel_gap(c["cost"].reshape(1),
                                      r["cost"].reshape(1), None))
    st.per_map = [float(g) for g in map_gap]
    return {"map_gap_p90": check.percentile(map_gap, 90),
            "that_gap": check.worst(that_gap),
            "cost_gap": check.worst(cost_gap)}
