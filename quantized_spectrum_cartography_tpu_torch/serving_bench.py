"""End-to-end serving benchmark: continuous batching on the card.

    python -m quantized_spectrum_cartography_tpu_torch.serving_bench \\
        --requests 1024 --batch 64 [--out SERVING_TORCH.json] [--device cuda]

The counterpart of the JAX package's ``tools/serving_bench_tpu.py``, with
its protocol, flags and output keys.  N single-map 1-bit recovery requests
(51x51x64, R=2, threshold 0.0045, sigma 0.008; observations bit-packed on
the wire, S, C and the final cost sent back) stream through
`parallel.RecoveryScheduler` over the batched `recover_lowrank_mle` (the
1-bit kernel pair on the card; S0 = 0, C0 = 0.01, 50 outer x (5 S + 5 C)
Adam steps, rank-10 projection every 5) at a static device batch.  It
measures, in order:

1. a warm-up solve;
2. the raw batch-solver bound: back-to-back batched solves, downloads
   fenced at the end only;
3. a closed loop: all N requests submitted at once (a throughput
   measurement; its latencies are queue-dominated by construction);
4. an open loop: Poisson arrivals at `--open-frac` of the raw bound,
   completion times taken in the futures' done-callbacks.

Each request is timed from its due time (the loop's start in the closed
loop, its arrival in the open one), so a generator that falls behind
counts.  Each loop also gives the p50 and p95 of a request's waits and of
its batch's parts, from the scheduler's spans (``utils.tracing``): the
wait in the queue, the batch's collect, stack, solve, download and drain,
and the wait from the solve's return to the answer.

Quality gate: every returned cost finite and the mean NMSE of the served
maps below 1; a run that fails it exits 1.  Writes `--out` (default
``SERVING_TORCH.json`` at the repository root) after the closed loop and
again after the open loop, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    PhysicsConfig,
    SolverConfig,
    set_card_numerics,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    dither_probit,
    pack_bits_host,
    unpack_bits,
)
from quantized_spectrum_cartography_tpu_torch.parallel import (
    RecoveryScheduler,
)
from quantized_spectrum_cartography_tpu_torch.physics import (
    generate_map_batch,
)
from quantized_spectrum_cartography_tpu_torch.solvers import (
    recover_lowrank_mle,
)
from quantized_spectrum_cartography_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
G, K, R = 51, 64, 2
MEAN, STD = 0.0045, 0.008


def serving_config(iters: int = 50, inner: int = 5) -> SolverConfig:
    return SolverConfig(max_iters=iters, s_inner_iters=inner,
                        c_inner_iters=inner, lr_s=0.001, lr_c=0.001,
                        projection_interval=5, rank_truncation=10)


def make_requests(n: int, device, seed: int = 0):
    """(T_true [n, K, G, G] on `device`, bit-packed observations uint8
    [n, K, ceil(G*G/8)] on the host): a stream of independent problems."""
    gen = torch.Generator(device=device).manual_seed(seed)
    T, _, _, _ = generate_map_batch(gen, PhysicsConfig(
        grid_size=G, num_bands=K, num_emitters=R), n, device=device)
    y01 = dither_probit(T - MEAN, STD, gen.manual_seed(seed + 1))
    return T, pack_bits_host(y01.reshape(n, K, G * G).cpu().numpy())


def make_solver(scfg: SolverConfig, nll_mode: str = "auto"):
    """The batched solve behind the scheduler: bit-packed observations in
    (1 bit an entry on the wire), compact factors out (S, C and the final
    cost; a client rebuilds T_hat = sum_r S_r o c_r itself).  Returns
    device tensors: the scheduler downloads them.  `nll_mode` as in
    `recover_lowrank_mle` ("plain" takes the kernels' plain version)."""
    def solver_fn(stacked):
        packed = stacked["T_obs"]
        B = packed.shape[0]
        T_obs = unpack_bits(packed, G * G).reshape(B, K, G, G)
        res = recover_lowrank_mle(
            T_obs, torch.zeros(B, R, G, G, device=packed.device),
            torch.full((B, R, K), 0.01, device=packed.device), scfg,
            MEAN, STD, nll_mode=nll_mode)
        return {"S": res.S, "C": res.C, "cost": res.costs[:, -1]}
    return solver_fn


def served_nmse(results, T_true) -> float:
    """Mean NMSE of the maps rebuilt from the served factors."""
    S = torch.as_tensor(np.stack([r["S"] for r in results]),
                        device=T_true.device)
    C = torch.as_tensor(np.stack([r["C"] for r in results]),
                        device=T_true.device)
    return float(nmse(get_tensor(S, C), T_true, (-3, -2, -1)).mean())


def run_stream(sched, payloads, gaps=None):
    """Submit every payload (all at once, or after each gap in seconds);
    returns (results, due times, completion times, start), the
    completion times stamped in done-callbacks."""
    n = len(payloads)
    done = [0.0] * n
    due = [0.0] * n
    futures = []
    t0 = time.perf_counter()
    next_t = t0
    for i, p in enumerate(payloads):
        if gaps is not None:
            next_t += gaps[i]
            wait = next_t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        due[i] = next_t
        f = sched.submit(p)
        f.add_done_callback(
            lambda fut, i=i: done.__setitem__(i, time.perf_counter()))
        futures.append(f)
    results = [f.result(timeout=600) for f in futures]
    # CPython runs done-callbacks after waking result() waiters, so the
    # last batch's stamps may still be pending here
    deadline = time.perf_counter() + 30
    while any(d == 0.0 for d in done) and time.perf_counter() < deadline:
        time.sleep(0.005)
    if not all(d > 0.0 for d in done):
        raise RuntimeError("missing completion stamps")
    return results, np.asarray(due), np.asarray(done), t0


def latency_summary(lat) -> dict:
    return {f"latency_{q}_s": float(np.percentile(lat, p))
            for q, p in (("p50", 50), ("p95", 95), ("p99", 99))} | {
        "latency_max_s": float(lat.max())}


def request_parts() -> dict:
    """p50 and p95 seconds of each request's queue wait, result wait and
    whole, and of each batch's scheduler spans (collect, stack, solve,
    download, drain), from what the scheduler recorded since the recorder
    was last cleared (empty with recording off); summed up as the
    benchmark's readers do (``port_bench/program_spans.py``)."""
    from port_bench import program_spans as ps

    recs = tracing.spans()
    parts = {**ps.request_ms(recs), **ps.batch_ms(recs)}
    return {f"{part}_{q}_s": float(np.percentile(v, p)) / 1e3
            for part, v in parts.items() if v
            for q, p in (("p50", 50), ("p95", 95))}


def dispatch_summary(sched) -> dict:
    """The dispatch thread's host seconds a batch: its first batch (which
    pays the thread's first use of the card) and the median."""
    return {"dispatch_seconds_first": sched.solve_seconds[0],
            "dispatch_seconds_median": float(np.median(sched.solve_seconds))}


def card_line() -> str:
    """nvidia-smi's "name, power.limit" of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--inner", type=int, default=5)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--drain-threads", type=int, default=2)
    ap.add_argument("--open-frac", type=float, default=0.9,
                    help="open-loop offered load as a fraction of the "
                         "measured raw capacity")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "SERVING_TORCH.json"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        set_card_numerics()
        card = card_line()
    else:
        card = "cpu (a rehearsal: no device metric)"
    B = args.batch
    solver_fn = make_solver(serving_config(args.iters, args.inner))
    T_true, T_obs = make_requests(args.requests, device)

    def solve(rows):
        return solver_fn({"T_obs": torch.from_numpy(rows).to(device)})

    solve(T_obs[:B])["cost"].cpu()          # warm-up: builds the kernels
    print(f"warm; streaming {args.requests} requests (batch {B}) on "
          f"{card}", flush=True)

    # raw bound: back-to-back batched solves, downloads fenced at the end
    n_raw = max(1, args.requests // B)
    t0 = time.perf_counter()
    raw_outs = [solve(T_obs[i * B:(i + 1) * B]) for i in range(n_raw)]
    for o in raw_outs:
        o["cost"].cpu()
    raw_maps_per_sec = n_raw * B / (time.perf_counter() - t0)
    print(f"raw batch-solver bound: {raw_maps_per_sec:.2f} maps/s",
          flush=True)

    def scheduler():
        return RecoveryScheduler(solver_fn, batch_size=B, max_wait_ms=20.0,
                                 pipeline_depth=args.depth,
                                 drain_threads=args.drain_threads,
                                 device=device)

    payloads = [{"T_obs": T_obs[i]} for i in range(args.requests)]
    tracing.clear()
    sched = scheduler()
    results, due, done, t0 = run_stream(sched, payloads)
    sched.shutdown()
    serving = args.requests / (done.max() - t0)
    finite = bool(all(np.isfinite(r["cost"]) for r in results))
    mean_nmse = served_nmse(results, T_true)
    out = {
        "metric": "serving throughput, continuous-batched 1-bit recovery",
        "device": card,
        "requests": args.requests,
        "batch": B,
        "pipeline_depth": args.depth,
        "drain_threads": args.drain_threads,
        "maps_per_sec": serving,
        "raw_bound_maps_per_sec": raw_maps_per_sec,
        "fraction_of_raw": serving / raw_maps_per_sec,
        **latency_summary(done - due),
        **request_parts(),
        "batches_dispatched": sched.batches_dispatched,
        **dispatch_summary(sched),
        "quality": {"finite_costs": finite, "mean_nmse": mean_nmse},
        "notes": "closed-loop (all requests submitted at once): a "
                 "throughput measurement; p50 latency is queue-"
                 "dominated by construction",
    }
    print(json.dumps(out), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if not (finite and mean_nmse < 1.0):
        sys.exit(f"quality gate failed: finite {finite}, mean NMSE "
                 f"{mean_nmse}")

    # open loop: Poisson arrivals at open_frac x the raw capacity, so that
    # queueing delay reflects the scheduler, not a submission burst
    lam = args.open_frac * raw_maps_per_sec
    gaps = np.random.default_rng(7).exponential(1.0 / lam,
                                                size=args.requests)
    print(f"open loop: lambda = {lam:.2f} req/s ({args.open_frac:.2f} x raw "
          f"bound)", flush=True)
    tracing.clear()
    sched = scheduler()
    results, due, done, t0 = run_stream(sched, payloads, gaps)
    sched.shutdown()
    # the sustained rate leaves out the warm-up and drain edges:
    # completions between the 10th and 90th percentile completion times
    d = np.sort(done)
    lo, hi = d[int(0.1 * len(d))], d[int(0.9 * len(d)) - 1]
    sustained = np.sum((done >= lo) & (done <= hi)) / max(hi - lo, 1e-9)
    finite = bool(all(np.isfinite(r["cost"]) for r in results))
    out["open_loop"] = {
        "arrival_process": "Poisson",
        "target_rate_frac_of_raw": args.open_frac,
        "offered_load_maps_per_sec": lam,
        "sustained_maps_per_sec": float(sustained),
        "completed_over_span_maps_per_sec": args.requests / (done.max() - t0),
        **latency_summary(done - due),
        **request_parts(),
        "batches_dispatched": sched.batches_dispatched,
        **dispatch_summary(sched),
        "finite_costs": finite,
    }
    print(json.dumps(out["open_loop"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if not finite:
        sys.exit("quality gate failed in the open loop: non-finite costs")


if __name__ == "__main__":
    main()
