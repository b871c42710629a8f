"""Served recovery: single-map requests through the port's
`RecoveryScheduler`, open loop.

Traffic: bit-packed 1-bit requests cycled from a pool of `pool_maps` made
in set-up, arriving as a Poisson stream at the fixed `rate` (maps/s) of
the cell (`traffic.poisson_gaps`: the same gaps for every seed, in the
seed's order).  Arrivals start `warm_s` before the window and go on after
it until every request due in the window has its answer (at most
`tail_s`).  Each request is timed from its due time to its answer in the
client, so a late generator counts; `latency_p95_s` is over all requests
due in the window, a failed or missing one reading infinite.

The check: `sample_requests` requests due in the window, drawn from the
seed; the reference (float64) solves each one's map again.  Numbers:
`map_gap_p90` (the map rebuilt from the served factors) and `cost_gap`, as
in the batch driver; results served for other requests fail both.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from port_bench import check, problems, traffic
from port_bench.reference import lowrank as ref
from port_bench.reference.numerics import CONTROL, JUDGE
from port_bench.trace import STRETCH, from_profile


def unpack_device(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The benchmark's own unpacking of the wire format, on the device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n_bits].float()


def program_solver(cell, probe) -> Callable:
    """The batched solve behind the scheduler, as ``serving_bench.py``
    `make_solver` builds it (bit-packed observations in, S, C and the last
    cost out), with the benchmark's probe."""
    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        unpack_bits)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_lowrank_mle)

    cfg = cell.config
    ph, sv, ob = cfg["physics"], cfg["solver"], cfg["observation"]
    I, K = ph["grid_size"], ph["num_bands"]
    scfg = SolverConfig(
        max_iters=sv["max_iters"], s_inner_iters=sv["s_inner_iters"],
        c_inner_iters=sv["c_inner_iters"], lr_s=sv["lr_s"], lr_c=sv["lr_c"],
        projection_interval=sv["projection_interval"],
        rank_truncation=sv["rank_truncation"],
        projection_method=sv["projection_method"])

    def solver_fn(stacked):
        packed = stacked["T_obs"]
        B = packed.shape[0]
        y01 = unpack_bits(packed, I * I).reshape(B, K, I, I)
        S0, C0 = problems.starts(cfg, B, packed.device)
        res = recover_lowrank_mle(
            y01, S0, C0, scfg, ob["threshold"], ob["dither_std"],
            l1=sv["l1"], l2=sv["l2"], obs_encoding=sv["obs_encoding"],
            probe=probe)
        return {"S": res.S, "C": res.C, "cost": res.costs[:, -1]}
    return solver_fn


def control_solver(cell, probe) -> Callable:
    """The reference in TF32, in the program's place behind the scheduler."""
    cfg = cell.config
    ph, ob = cfg["physics"], cfg["observation"]
    I, K = ph["grid_size"], ph["num_bands"]

    def solver_fn(stacked):
        packed = stacked["T_obs"]
        B = packed.shape[0]
        y01 = unpack_device(packed, I * I).reshape(B, K, I, I)
        S0, C0 = problems.starts(cfg, B, packed.device)
        out = ref.solve(y01, S0, C0, probe, cfg["solver"], ob["threshold"],
                        ob["dither_std"], CONTROL)
        return {"S": out["S"], "C": out["C"], "cost": out["cost"]}
    return solver_fn


@dataclasses.dataclass
class State:
    cell: object
    packed: np.ndarray
    probe: torch.Tensor
    sched: object
    futures: list = dataclasses.field(default_factory=list)
    window_idx: Optional[list] = None
    chosen: Optional[list] = None
    per_map: Optional[list] = None


def scheduler(cell, solver_fn):
    from quantized_spectrum_cartography_tpu_torch.parallel import (
        RecoveryScheduler)

    tr = cell.workload["traffic"]
    return RecoveryScheduler(solver_fn, batch_size=tr["batch"],
                             max_wait_ms=tr["max_wait_ms"],
                             pipeline_depth=tr["pipeline_depth"],
                             drain_threads=tr["drain_threads"],
                             device=cell.device)


def setup(cell, solver=None) -> State:
    tr = cell.workload["traffic"]
    gen = problems.generator(cell.seed, cell.device)
    packed = problems.packed_requests(gen, cell.config, tr["pool_maps"])
    probe = problems.probe(gen, cell.config)
    sched = scheduler(cell, (solver or program_solver)(cell, probe))
    # warm: one full batch through the scheduler
    warm = [sched.submit({"T_obs": packed[i % len(packed)]})
            for i in range(tr["batch"])]
    for f in warm:
        f.result(timeout=600)
    return State(cell, packed, probe, sched)


def _counters(sched):
    return (sched.batches_dispatched, sched.maps_completed,
            len(sched.solve_seconds))


def _sleep_until(t: float) -> None:
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


def measure(st: State) -> dict:
    cell, sched = st.cell, st.sched
    tr = cell.workload["traffic"]
    rate, warm_s, W = tr["rate"], tr["warm_s"], cell.seconds
    gaps = traffic.poisson_gaps(
        rate, int(math.ceil(rate * (warm_s + W + tr["tail_s"]))) + 1,
        cell.seed)
    n_pool = len(st.packed)
    snaps = {}
    tr_plan = cell.workload["trace"]
    # a traced run profiles the window's last `seconds`; its counters are
    # read over the window before that stretch.  The profiler is prepared
    # before the first arrival, started as the stretch opens, and stopped
    # as the window closes, after every request due in it was submitted:
    # its stop holds the interpreter while it gathers the events, and
    # would make the generator late.
    prof = rf = None
    tr_times = {}
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        c0 = time.perf_counter()
        prof.prepare_trace()
        tr_times["prepare"] = time.perf_counter() - c0
    t_start = time.perf_counter()
    due = t_start + np.cumsum(gaps)
    win_open, win_close = t_start + warm_s, t_start + warm_s + W
    tr_start = win_close - tr_plan["seconds"] if cell.trace else math.inf
    done = np.zeros(len(due))
    submitted = np.zeros(len(due))
    futures = []
    for i, t in enumerate(due):
        if t >= win_open and "open" not in snaps:
            snaps["open"] = _counters(sched)
        if t >= min(win_close, tr_start) and "close" not in snaps:
            snaps["close"] = _counters(sched)
        if prof is not None and rf is None and "start" not in tr_times \
                and t >= tr_start:
            from torch.autograd.profiler import record_function
            _sleep_until(tr_start)
            c0 = time.perf_counter()
            prof.start_trace()
            rf = record_function(STRETCH)
            rf.__enter__()
            tr_times["start"] = time.perf_counter() - c0
        if rf is not None and t >= win_close:
            _sleep_until(win_close)
            c0 = time.perf_counter()
            rf.__exit__(None, None, None)
            prof.stop_trace()
            rf = None
            tr_times["stop"] = time.perf_counter() - c0
        if t >= win_close:
            pending = [f for j, f in enumerate(futures)
                       if win_open <= due[j] < win_close and not f.done()]
            if not pending or time.perf_counter() > win_close + tr["tail_s"]:
                break
        _sleep_until(t)
        submitted[i] = time.perf_counter()
        f = sched.submit({"T_obs": st.packed[i % n_pool]})
        f.add_done_callback(
            lambda fut, i=i: done.__setitem__(i, time.perf_counter()))
        futures.append(f)
    if rf is not None:
        rf.__exit__(None, None, None)
        prof.stop_trace()
    # the answers of the window's requests, a minute past its close at most
    idx = [j for j in range(len(futures)) if win_open <= due[j] < win_close]
    deadline = win_close + tr["tail_s"]
    for j in idx:
        try:
            futures[j].result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 -- a failed request counts below
            pass
    time.sleep(0.05)            # let the last done-callbacks stamp
    sched.shutdown(wait=True)
    ok = {j for j in idx if futures[j].done() and futures[j].exception()
          is None and done[j] > 0}
    lat = np.array([done[j] - due[j] if j in ok else np.inf for j in idx])
    p95 = float(np.percentile(lat, 95)) if len(idx) else math.inf
    late = float(np.max(submitted[idx] - due[idx])) if idx else 0.0
    trace = None
    if prof is not None:
        # the stretch counts only if the generator kept to the cell's
        # arrivals inside it
        in_tr = [j for j in idx if due[j] >= tr_start]
        tr_late = (float(np.max(submitted[in_tr] - due[in_tr])) if in_tr
                   else math.inf)
        tr_note = (f"trace: profiler prepare {tr_times.get('prepare')} s "
                   f"(before the arrivals), start {tr_times.get('start')} "
                   f"s, stop {tr_times.get('stop')} s (after the window's "
                   f"last arrival); generator late by at most {tr_late} s "
                   f"over the stretch's {len(in_tr)} requests")
        if tr_late <= tr_plan["max_late_s"]:
            trace = from_profile(prof)
        else:
            tr_note += (f", over the {tr_plan['max_late_s']} s allowed: "
                        "the stretch is not read")
    b0, m0, l0 = snaps.get("open", (0, 0, 0))
    b1, m1, l1 = snaps.get("close", _counters(sched))
    st.futures, st.window_idx = futures, [j for j in idx if j in ok]
    finite = lat[np.isfinite(lat)]
    return {
        "metrics": {"latency_p95_s": p95},
        "attempted": len(idx), "failed": len(idx) - len(ok),
        "trace": trace,
        "units": 1, "work": None,
        "counters": {"batches": b1 - b0, "maps": m1 - m0,
                     "batch": tr["batch"],
                     "solve_seconds": list(sched.solve_seconds[l0:l1])},
        "stderr": [
            f"window {W} s: {len(idx)} requests due at {rate} maps/s, "
            f"{len(ok)} answered; latency p50 "
            f"{float(np.percentile(finite, 50)) if len(finite) else math.inf}"
            f" s, p95 {p95} s, p99 "
            f"{float(np.percentile(lat, 99)) if len(idx) else math.inf} s; "
            f"generator late by at most {late} s; "
            f"{b1 - b0} batches dispatched, {m1 - m0} maps completed"]
        + ([tr_note] if prof is not None else [])}


def release(st: State, window: dict) -> None:
    cell = st.cell
    chosen = check.sample(cell.seed, len(st.window_idx),
                          cell.workload["check"]["sample_requests"], salt=-3)
    n_pool = len(st.packed)
    st.chosen = []
    for c in chosen:
        j = st.window_idx[c]
        r = st.futures[j].result()
        st.chosen.append({"key": j % n_pool, "S": r["S"], "C": r["C"],
                          "cost": r["cost"]})
    st.futures, st.sched = [], None
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()


def check_numbers(st: State, window: dict) -> dict:
    cfg = st.cell.config
    ob = cfg["observation"]
    keys = sorted({c["key"] for c in st.chosen})
    if not keys:
        return {"map_gap_p90": math.inf, "cost_gap": math.inf}
    dev = st.probe.device
    y01 = torch.as_tensor(problems.unpack_host(st.packed[keys], cfg),
                          device=dev)
    S0, C0 = problems.starts(cfg, len(keys), dev)
    out = ref.solve(y01, S0, C0, st.probe, cfg["solver"], ob["threshold"],
                    ob["dither_std"], JUDGE)
    at = {k: i for i, k in enumerate(keys)}
    map_gap, cost_gap = [], []
    for c in st.chosen:
        i = at[c["key"]]
        S = torch.as_tensor(c["S"], device=dev).double()
        C = torch.as_tensor(c["C"], device=dev).double()
        T = torch.einsum("rij,rk->kij", S, C)
        map_gap.append(check.rel_gap(T, out["T_hat"][i], None))
        cost_gap.append(check.rel_gap(
            torch.as_tensor(c["cost"], device=dev).reshape(1),
            out["cost"][i].reshape(1), None))
    st.per_map = [float(g) for g in map_gap]
    return {"map_gap_p90": check.percentile(map_gap, 90),
            "cost_gap": check.worst(cost_gap)}
