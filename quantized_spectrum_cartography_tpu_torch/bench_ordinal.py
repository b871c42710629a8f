"""Device time of the ordinal likelihood kernels on one GPU.

    python quantized_spectrum_cartography_tpu_torch/bench_ordinal.py \
        [--root DIR] [--against DIR] [--floor] [--sass-out FILE]

Times the f32-bounds pair (``quantized_nll_fwd_cuda``,
``quantized_nll_bwd_cuda``) of the port found under DIR (default: the
checkout that holds this script) and, as the control, the int8-coded pair
on the same observations, on four cases made from seed 0 on the card:
  gan      - the MLE-GAN shape: B=1, K=64, 51x51, R=2, 10% of the entries
             observed, the 4-bin log table, sigma 5, log link, fast
             numerics (observations quantized from C@S itself);
  scorer   - the z-search scorer: B=201 candidates sharing C and the
             observations of `gan` (batch stride 0), forward only;
  lowrank  - the low-rank shape: B=256, R=2, no mask, 2 bins split at
             0.0045, sigma 0.008, linear link, robust numerics (the true
             factors of simulated maps and their dithered signs);
  lowrank_r10_mask - the same at R=10 with 10% of the entries observed.
Device time (``graph_ms``) and back-to-back time (``eager_ms``) are taken
as ``bench_onebit.py`` takes them, with its functions; at `gan` also the
wrapper's host time per call (``host_ms``, the least of HOST_BATCHES
batches of HOST_REPS calls) and each kernel's device time per call from
torch.profiler.  Each case also holds the bounds pair against its plain
version (value rtol, gradients over max |grad|), the coded pair against
the bounds pair (whether their bits agree, and how far apart they are) and
checks that a second launch gives the same bits.  Prints one JSON line.

--against DIR runs this script on DIR and on --root in turns (DIR, root,
root, DIR), one process each, and prints both and the ratios.
--floor adds, for each checkout it runs on first: ptxas' registers and
spills of every ordinal kernel; the innermost loop of each (from
``cuobjdump -sass``), with its static and direct-path instructions; the SM
clock and power while each rank-2 kernel of `lowrank` runs back to back;
and the issue floor of each pair at each case, direct-path instructions of
the loop x the entries it runs over / (32 lanes x 4 schedulers x SMs x SM
clock under load).  A design that compacts the observed entries runs its
loop over those only, the older one over every entry; where a kernel has
a dense loop beside its list loop, `lowrank` (every entry observed) reads
the dense one.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

MEAN, STD = 0.0045, 0.008
K, GRID, SCORER_N, LOWRANK_B = 64, 51, 201, 256
MASK_FRACTION = 0.1
HOST_REPS, HOST_BATCHES = 100, 10
CASES = ("gan", "scorer", "lowrank", "lowrank_r10_mask")
KINDS = ("bounds_fwd", "bounds_bwd", "coded_fwd", "coded_bwd")


@functools.lru_cache(maxsize=None)
def _bench_onebit():
    """bench_onebit.py beside this file, whichever checkout --root names."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_bench_onebit", Path(__file__).with_name("bench_onebit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(case, device="cuda"):
    """(S, C, codes, (W, U), g, table, (sigma, offset, linear, fast)) on
    `device`."""
    import torch

    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
        pack_codes_1bit)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit, quantize_log)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch, sample_entry_mask)

    gen = torch.Generator(device=device).manual_seed(0)
    P = GRID * GRID
    if case in ("gan", "scorer"):
        table, sigma, offset = (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0,
                                bnd.LOG_OFFSET_4)
        S = 0.05 * torch.rand(1, 2, P, generator=gen, device=device)
        C = torch.rand(1, K, 2, generator=gen, device=device)
        Y = quantize_log(torch.matmul(C, S).reshape(1, K, GRID, GRID), sigma,
                         table, offset, gen)
        mask = sample_entry_mask(gen, tuple(Y.shape), MASK_FRACTION,
                                 device=device)
        codes = q.pack_codes(Y, len(table) - 1, mask)
        bounds = q.pack_bounds(Y, table, mask)
        if case == "scorer":
            S = 0.05 * torch.rand(SCORER_N, 2, P, generator=gen,
                                  device=device)
        st = (sigma, offset, False, q._fast_ok(sigma))
    else:
        R = 2 if case == "lowrank" else 10
        cfg = PhysicsConfig(grid_size=GRID, num_bands=K, num_emitters=R)
        T, S, C, _ = generate_map_batch(gen, cfg, LOWRANK_B, device=device)
        mask = (None if case == "lowrank" else sample_entry_mask(
            gen, tuple(T.shape), MASK_FRACTION, device=device))
        T_obs = dither_probit(T - MEAN, STD, gen)
        codes = pack_codes_1bit(T_obs, mask)
        bounds = q.pack_bounds_1bit(T_obs, MEAN, mask)
        S = S.reshape(LOWRANK_B, R, -1).contiguous()
        C = C.transpose(1, 2).contiguous()
        table = q.onebit_bounds(MEAN)
        st = (STD, 0.0, True, q._fast_ok(STD))
    g = 0.5 + torch.rand(S.shape[0], generator=gen, device=device)
    return S, C, codes, bounds, g, table, st


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def time_case(case):
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    bo = _bench_onebit()
    S, C, codes, (W, U), g, table, st = _inputs(case)
    fwd_only = case == "scorer"
    calls = {
        "bounds_fwd": lambda: q.quantized_nll_fwd_cuda(S, C, W, U, *st),
        "coded_fwd": lambda: q.quantized_nll_coded_fwd_cuda(
            S, C, codes, table, *st)}
    if not fwd_only:
        calls["bounds_bwd"] = lambda: q.quantized_nll_bwd_cuda(
            S, C, W, U, g, *st)
        calls["coded_bwd"] = lambda: q.quantized_nll_coded_bwd_cuda(
            S, C, codes, table, g, *st)

    def run():
        return {name: (lambda x: x if isinstance(x, tuple) else (x,))(fn())
                for name, fn in calls.items()}

    first, again = run(), run()
    torch.cuda.synchronize()
    v0 = q.quantized_nll_plain(S, C, W, U, *st)
    (v,) = first["bounds_fwd"]
    bounds = [x for name in calls if name.startswith("bounds")
              for x in first[name]]
    coded = [x for name in calls if name.startswith("coded")
             for x in first[name]]
    maps_per_obs = S.shape[0] // codes.shape[0]   # the scorer's N, else 1
    out = {
        "observed": int((codes.long() < len(table) - 1).sum().item())
        * maps_per_obs,
        "entries": codes.numel() * maps_per_obs,
        "value_rel": ((v - v0).abs() / v0.abs()).max().item(),
        "repeat_bitwise": all(torch.equal(a, b) for name in calls
                              for a, b in zip(first[name], again[name])),
        "coded_equals_bounds": all(torch.equal(a, b)
                                   for a, b in zip(coded, bounds)),
        "coded_rel_max": max(_rel(a, b) for a, b in zip(coded, bounds)),
    }
    if fwd_only:
        one = torch.cat([q.quantized_nll_fwd_cuda(s[None], C, W, U, *st)
                         for s in S])
        out["scorer_equals_single_launches"] = bool(torch.equal(v, one))
    else:
        dS0, dC0 = q.quantized_nll_grad_plain(S, C, W, U, g, *st)
        dS, dC = first["bounds_bwd"]
        out.update({"dS_rel_max": _rel(dS, dS0), "dC_rel_max": _rel(dC, dC0)})
    for name, fn in calls.items():
        out[name] = {"graph_ms": bo.graph_ms(fn), "eager_ms": bo.eager_ms(fn)}
        if case == "gan":
            out[name]["host_ms"] = host_ms(fn)
            out[name]["device_us_by_kernel"] = device_us_by_kernel(fn)
    return out


def host_ms(fn, reps=HOST_REPS, batches=HOST_BATCHES):
    """The host's time per call of `fn`: the least over `batches` of the
    host clock over `reps` calls, which the device does not hold back
    (fewer launches than its queue takes; synchronized between batches).
    The least, since other work on a shared host only adds time."""
    import torch

    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t)
    torch.cuda.synchronize()
    return best / reps * 1e3


def device_us_by_kernel(fn, reps=20):
    """{kernel: device microseconds per call of `fn`} from torch.profiler:
    how a call's device time splits between a kernel and its sum pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us and ev.count:
            name = re.sub(r"^.*?(\w*_kernel)\b.*$", r"\1", ev.key)
            out[name] = out.get(name, 0.0) + us / reps
    return out


def short_name(mangled):
    """'coded_fwd<2,1,0>' for a coded kernel at R=2, linear link, robust
    numerics; 'fwd<...>' for a bounds kernel.  The tile kernels name their
    observation source (Codes or Bounds) as their first template argument;
    earlier builds named the coded kernels qnll_coded_*, and the first one
    carried the coded flag as their first bool ('fwd<2,1,1,0>')."""
    m = re.search(r"qnll_(coded_)?(fwd|bwd)_kernelI(?:N\w*?(Codes|Bounds)E)?"
                  r"Li(\d+)E((?:Lb[01]E)*)", mangled)
    if not m:
        return mangled
    coded = "coded_" if m.group(1) or m.group(3) == "Codes" else ""
    flags = ",".join(re.findall(r"Lb([01])E", m.group(5)))
    return f"{coded}{m.group(2)}<{m.group(4)},{flags}>"


def loop_kind(instrs):
    """'list' for a numerics loop that reads the list of observed entries
    (16-bit entries in shared memory), else 'dense'."""
    return "list" if any("LDS.U16" in x for x in instrs) else "dense"


def _coded(short):
    """Whether a short name is a coded kernel, in either build."""
    return short.startswith("coded_") or short.count(",") == 3 and (
        short.split("<")[1].split(",")[1] == "1")


def floor_report(records, sass_out=None):
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    bo = _bench_onebit()
    path = _build.build()
    log = path.with_suffix(".log")
    regs = bo.ptxas_report(log.read_text() if log.exists() else "",
                           match="qnll_", short=short_name)
    loops = bo.sass_loops(path, sass_out, match="qnll_", short=short_name,
                          keep=lambda s: not _coded(s) and "<2," in s,
                          classify=loop_kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S, C, codes, (W, U), g, table, st = _inputs("lowrank")
    load = {
        "bounds_fwd": lambda: q.quantized_nll_fwd_cuda(S, C, W, U, *st),
        "bounds_bwd": lambda: q.quantized_nll_bwd_cuda(S, C, W, U, g, *st),
        "coded_fwd": lambda: q.quantized_nll_coded_fwd_cuda(
            S, C, codes, table, *st),
        "coded_bwd": lambda: q.quantized_nll_coded_bwd_cuda(
            S, C, codes, table, g, *st)}
    load = {kind: bo.clock_under_load(fn) for kind, fn in load.items()}
    lib = q._lib()
    # which pairs list the observed entries: the tile body's shared scratch
    # size, or the coded kernels' own in the build before the bounds pair
    # moved onto it
    compacts = {"bounds": hasattr(lib, "qsc_qnll_tiles"),
                "coded": hasattr(lib, "qsc_qnll_tiles")
                or hasattr(lib, "qsc_qnll_coded_tiles")}
    # the kernel each case runs: (rank, linear, fast)
    variant = {"gan": (2, 0, 1), "scorer": (2, 0, 1), "lowrank": (2, 1, 0),
               "lowrank_r10_mask": (10, 1, 0)}
    floors = {}
    for case, (R, lin, fast) in variant.items():
        rec = records[case]
        for kind in KINDS:
            if kind not in rec:
                continue
            pair, way = kind.split("_")
            n = rec["observed"] if compacts[pair] else rec["entries"]
            names = ((f"coded_{way}<{R},{lin},{fast}>",
                      f"{way}<{R},1,{lin},{fast}>") if pair == "coded" else
                     (f"{way}<{R},{lin},{fast}>",
                      f"{way}<{R},0,{lin},{fast}>"))
            key = [s for s in names if s in loops]
            by_loop = loops[key[0]] if key else {}
            # the loop this case runs: with every entry observed (lowrank),
            # the dense one where the kernel has one
            order = ("dense", "list") if case == "lowrank" else ("list",
                                                                 "dense")
            loop = next((lp for lp in order if lp in by_loop), None)
            direct = by_loop[loop][1] if loop else 0
            mhz, watts = load[kind]
            floors[f"{case} {kind}"] = {
                "kernel": key[0] if key else None, "loop": loop,
                "loop_direct_per_entry": direct, "loop_entries": n,
                "sm_mhz_under_load": mhz, "power_w_under_load": watts,
                "issue_floor_ms": None if not mhz else
                direct * n / 32 / (4 * sms * mhz * 1e6) * 1e3}
    return {"registers_spills": regs, "sass_loops": loops, "sms": sms,
            "compacts_observed": compacts, "floors": floors}


def worker(args):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"root": args.root, "card": torch.cuda.get_device_name(0),
           "cases": {case: time_case(case) for case in CASES}}
    if args.floor:
        rec["floor"] = floor_report(rec["cases"], args.sass_out)
    print(json.dumps(rec), flush=True)


def compare(args):
    here = str(Path(__file__).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    runs = []
    for i, root in enumerate((args.against, args.root, args.root,
                              args.against)):
        cmd = [sys.executable, here, "--root", root]
        if args.floor and i < 2:
            cmd += ["--floor"] + (["--sass-out", f"{args.sass_out}.{i}"]
                                  if args.sass_out else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{root} failed ({proc.returncode}): "
                     f"{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    table = {}
    for case in CASES:
        for kind in KINDS:
            if kind not in runs[0]["cases"][case]:
                continue
            for how in ("graph_ms", "eager_ms", "host_ms"):
                if how not in runs[0]["cases"][case][kind]:
                    continue
                old = [r["cases"][case][kind][how] for r in runs[0::3]]
                new = [r["cases"][case][kind][how] for r in runs[1:3]]
                table[f"{case} {kind} {how}"] = {
                    "against": old, "root": new,
                    "ratio": sum(old) / sum(new)}
    print(json.dumps({"card": smi, "runs": runs, "table": table}), flush=True)
    for key, row in table.items():
        print(f"{key}: against {row['against']}, root {row['root']}, "
              f"against/root {row['ratio']:.3f}", flush=True)
    print(smi, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--against", default=None)
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--sass-out", default=None,
                    help="with --floor: write the rank-2 bounds kernels' SASS "
                         "here (with --against: FILE.0 of DIR, FILE.1 of "
                         "the root)")
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    if args.against:
        args.against = os.path.abspath(args.against)
        compare(args)
    else:
        sys.path.insert(0, args.root)
        worker(args)


if __name__ == "__main__":
    main()
