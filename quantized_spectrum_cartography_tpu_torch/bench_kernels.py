"""Device time of each of the port's kernels alone on one GPU.

    python quantized_spectrum_cartography_tpu_torch/bench_kernels.py \
        [--root DIR] [--against DIR] [--floor] [--sass-out FILE]

Times the kernels of the port under DIR (default: the checkout that holds
this script) on seven cases made from seed 0 on the card:
  bench, r10_mask - the 1-bit pair at B=256, K=64, 51x51, R=2 with every
      entry observed, and at R=10 with 10% observed: the true factors of
      simulated maps and their dithered signs (sigma 0.008, split 0.0045);
  gan    - the four ordinal kernels (f32 bounds and int8 codes, forward and
      backward) at the MLE-GAN shape: B=1, R=2, 10% observed, the 4-bin
      log table, sigma 5, log link, fast numerics;
  scorer - the z-search scorer: 201 candidates sharing C and the
      observations of `gan` (batch stride 0), forward only;
  lowrank, lowrank_r10_mask - the ordinal kernels on the maps of `bench`
      and `r10_mask`: 2 bins, linear link, robust numerics;
  qr     - the Householder QR at the projection's [256, 2, 51, 18] (the
      true S of `bench` times the probe), torch.linalg.qr in the plain
      version's place as the yardstick (the port never calls it).
Each kernel is timed by `in_turns` (plain, kernel, kernel, plain: eager_ms
and plain_ms, back-to-back calls between CUDA events; then graph_ms, the
calls captured in one CUDA graph: the device time, the host's cost per
call left out) beside its `bound`, and checked: against its plain version
(largest difference over largest magnitude), a second launch bit for bit,
codes against bounds bit for bit, the scorer against single launches, the
QR's projector against torch.linalg.qr's.  At `gan` also host_ms and the
profiler's device time per kernel.  Prints one JSON line.

--against DIR runs this script on DIR and on --root in turns (DIR, root,
root, DIR), one process each, the kernels imported from each checkout (DIR
need not hold this script), and prints both and the ratios.
--floor adds, for each checkout it runs on first: ptxas' registers and
spills of each likelihood kernel; the innermost loop that runs its
numerics (``cuobjdump -sass``: static and direct-path instructions, the
direct path taking t > -4 and each division's fast path); the SM clock and
power under load (each kernel back to back at `bench` or `lowrank`); and
each kernel's issue floor at each case, direct-path instructions per entry
x the entries its loop runs over (the observed ones where the kernel lists
them; a case with every entry observed reads the dense loop) / (32 lanes x
4 schedulers x SMs x SM clock), at the maximum clock and under load.
--sass-out FILE writes the rank-2 1-bit and bounds kernels' SASS to FILE
(with --against: FILE.0 of DIR, FILE.1 of the root).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

MEAN, STD = 0.0045, 0.008
B, K, GRID, SCORER_N = 256, 64, 51, 201
MASK_FRACTION = 0.1
QR_COLS = 18              # the projection's Y: rank 10 + oversample 8
TIMING_REPS, GRAPH_REPLAYS, WARMUP = 20, 10, 3
HOST_REPS, HOST_BATCHES = 100, 10
# published H100 SXM peaks: HBM bytes/s and f32 FLOP/s outside tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12
ONEBIT = ("bench", "r10_mask")
ORDINAL = ("gan", "scorer", "lowrank", "lowrank_r10_mask")
CASES = ONEBIT + ORDINAL + ("qr",)
# the likelihood kernel each case runs: (rank, linear link, fast numerics)
VARIANT = {"bench": (2, 1, 0), "r10_mask": (10, 1, 0), "gan": (2, 0, 1),
           "scorer": (2, 0, 1), "lowrank": (2, 1, 0),
           "lowrank_r10_mask": (10, 1, 0)}


def _inputs(case, device="cuda"):
    """The case's inputs on `device`, from seed 0: the arguments of its
    family's `*_kernels` but `fwd_only`."""
    import torch

    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
    from quantized_spectrum_cartography_tpu_torch.ops import lowrank as lr
    from quantized_spectrum_cartography_tpu_torch.ops import quantizer
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
        pack_codes_1bit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch, sample_entry_mask)

    gen = torch.Generator(device=device).manual_seed(0)
    P = GRID * GRID
    if case in ("gan", "scorer"):
        table, sigma, offset = (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0,
                                bnd.LOG_OFFSET_4)
        S = 0.05 * torch.rand(1, 2, P, generator=gen, device=device)
        C = torch.rand(1, K, 2, generator=gen, device=device)
        Y = quantizer.quantize_log(torch.matmul(C, S).reshape(
            1, K, GRID, GRID), sigma, table, offset, gen)
        mask = sample_entry_mask(gen, tuple(Y.shape), MASK_FRACTION,
                                 device=device)
        codes = q.pack_codes(Y, len(table) - 1, mask)
        W, U = q.pack_bounds(Y, table, mask)
        if case == "scorer":
            S = 0.05 * torch.rand(SCORER_N, 2, P, generator=gen,
                                  device=device)
        g = 0.5 + torch.rand(S.shape[0], generator=gen, device=device)
        return (S, C, codes, W, U, g, table,
                (sigma, offset, False, q._fast_ok(sigma)))
    # simulated maps: their true factors and dithered signs
    R = 10 if "r10" in case else 2
    T, S, C, _ = generate_map_batch(gen, PhysicsConfig(
        grid_size=GRID, num_bands=K, num_emitters=R), B, device=device)
    if case == "qr":
        return (S @ lr.default_probe(GRID, QR_COLS, device=device),)
    mask = (sample_entry_mask(gen, tuple(T.shape), MASK_FRACTION,
                              device=device) if "r10" in case else None)
    T_obs = quantizer.dither_probit(T - MEAN, STD, gen)
    S, C = S.reshape(B, R, -1).contiguous(), C.transpose(1, 2).contiguous()
    codes = pack_codes_1bit(T_obs, mask)
    if case in ONEBIT:
        return S, C, codes, torch.full((B,), 1.0 / T_obs[0].numel(),
                                       device=device)
    g = 0.5 + torch.rand(B, generator=gen, device=device)
    return (S, C, codes, *q.pack_bounds_1bit(T_obs, MEAN, mask), g,
            q.onebit_bounds(MEAN), (STD, 0.0, True, q._fast_ok(STD)))


def bound(nbytes, flops):
    """The least time (ms) a pass can take on the card: its bytes at
    PEAK_BYTES_S or its f32 operations at PEAK_F32_FLOP_S, whichever is
    longer, and which one that is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def onebit_kernels(S, C, codes, g):
    """({name: (kernel call, plain call)}, {name: bound}) of the 1-bit pair.
    Bounds: each input read once and each output written once, and the f32
    operations of every entry, per the TPU kernels' cost estimates: 2KRP +
    15KP flops and 2KP transcendentals forward, 6KRP + 20KP and 3KP
    backward, per map."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)

    Bn, R, P = S.shape
    Kn = C.shape[1]
    calls = {
        "onebit_nll_fwd": (
            lambda: k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD),
            lambda: k.onebit_nll_plain(S, C, codes, MEAN, STD)),
        "onebit_nll_bwd": (
            lambda: k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD),
            lambda: k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)),
    }
    factors = 4 * (S.numel() + C.numel())
    in_bytes = codes.numel() + factors
    bounds = {
        "onebit_nll_fwd": bound(in_bytes + 4 * Bn,
                                Bn * (2 * Kn * R * P + 17 * Kn * P)),
        "onebit_nll_bwd": bound(in_bytes + 4 * Bn + factors,
                                Bn * (6 * Kn * R * P + 23 * Kn * P)),
    }
    return calls, bounds


def ordinal_kernels(S, C, codes, W, U, g, table, st, fwd_only=False):
    """({name: (kernel call, plain call)}, {name: bound}) of the four
    ordinal kernels (the forwards only with `fwd_only`).  Bounds: each input
    read once and each output written once ((W, U) 8 B per entry, codes
    1 B), and the f32 operations of the entries observed (the kernels skip
    masked ones), per the TPU kernels' cost estimates: 2R + 25 flops and 4
    transcendentals forward, 6R + 30 and 5 backward."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    R = S.shape[1]
    calls = {
        "quantized_nll_fwd": (
            lambda: q.quantized_nll_fwd_cuda(S, C, W, U, *st),
            lambda: q.quantized_nll_plain(S, C, W, U, *st)),
        "quantized_nll_bwd": (
            lambda: q.quantized_nll_bwd_cuda(S, C, W, U, g, *st),
            lambda: q.quantized_nll_grad_plain(S, C, W, U, g, *st)),
        "quantized_nll_coded_fwd": (
            lambda: q.quantized_nll_coded_fwd_cuda(S, C, codes, table, *st),
            lambda: q.quantized_nll_coded_plain(S, C, codes, table, *st)),
        "quantized_nll_coded_bwd": (
            lambda: q.quantized_nll_coded_bwd_cuda(S, C, codes, table, g,
                                                   *st),
            lambda: q.quantized_nll_coded_grad_plain(S, C, codes, table, g,
                                                     *st)),
    }
    maps_per_obs = S.shape[0] // codes.shape[0]   # the scorer's N, else 1
    observed = maps_per_obs * int((codes < len(table) - 1).sum().item())
    factors = 4 * (S.numel() + C.numel())
    tail = 4 * S.shape[0]
    ops_f = observed * (2 * R + 25 + 4)
    ops_b = observed * (6 * R + 30 + 5)
    bounds = {
        "quantized_nll_fwd": bound(factors + 8 * W.numel() + tail, ops_f),
        "quantized_nll_bwd": bound(2 * factors + 8 * W.numel() + tail,
                                   ops_b),
        "quantized_nll_coded_fwd": bound(factors + codes.numel() + tail,
                                         ops_f),
        "quantized_nll_coded_bwd": bound(2 * factors + codes.numel() + tail,
                                         ops_b),
    }
    keep = [name for name in calls if not (fwd_only and "bwd" in name)]
    return ({name: calls[name] for name in keep},
            {name: bounds[name] for name in keep})


def qr_kernel(Y):
    """({"householder_qr": (kernel call, torch.linalg.qr)}, its bound): Y
    read once and Q written once; 4mk² - 4k³/3 f32 operations a matrix
    (geqrf's 2mk² - 2k³/3 and as many for orgqr's explicit Q)."""
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        householder_qr as hq)

    m, k = Y.shape[-2:]
    n = Y.numel() // (m * k)
    return ({"householder_qr": (lambda: hq.householder_qr_cuda(Y),
                                lambda: torch.linalg.qr(Y))},
            {"householder_qr": bound(2 * 4 * n * m * k,
                                     n * (4 * m * k * k - 4 * k ** 3 / 3))})


def kernels(case, inputs):
    """The case's ({name: (kernel call, plain call)}, {name: bound})."""
    if case in ONEBIT:
        return onebit_kernels(*inputs)
    if case == "qr":
        return qr_kernel(*inputs)
    return ordinal_kernels(*inputs, fwd_only=case == "scorer")


def _event_ms(run, calls):
    """ms per call of `run()`, which makes `calls` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn):
    """ms per call of TIMING_REPS back-to-back calls of `fn`, warmed up."""
    for _ in range(WARMUP):
        fn()
    return _event_ms(lambda: [fn() for _ in range(TIMING_REPS)], TIMING_REPS)


def _capture(fn):
    """TIMING_REPS calls of `fn`, warmed up and captured in one CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMING_REPS):
            fn()
    graph.replay()
    return graph


def graph_ms(fn):
    """ms per call of TIMING_REPS calls of `fn` captured in one CUDA graph:
    the device's time, without the host's cost per call."""
    graph = _capture(fn)
    return _event_ms(lambda: [graph.replay() for _ in range(GRAPH_REPLAYS)],
                     GRAPH_REPLAYS * TIMING_REPS)


def in_turns(calls):
    """{name: {eager_ms, plain_ms, graph_ms}} of {name: (kernel, plain)}:
    back-to-back calls timed plain, kernel, kernel, plain (each pair
    averaged), then the kernel in a CUDA graph."""
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (eager_ms(plain), eager_ms(kern), eager_ms(kern),
                          eager_ms(plain))
        out[name] = {"eager_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "graph_ms": graph_ms(kern)}
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


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def run_twice(calls):
    """Each kernel of {name: (kernel, plain)} launched twice and its plain
    version once: ({name: outputs}, whether the second launches gave the
    same bits, {name: plain outputs})."""
    import torch

    out = {name: _tuple(kern()) for name, (kern, _) in calls.items()}
    again = {name: _tuple(kern()) for name, (kern, _) in calls.items()}
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for name in calls
                  for a, b in zip(out[name], again[name]))
    return out, bitwise, {name: _tuple(plain())
                          for name, (_, plain) in calls.items()}


def time_case(case):
    import torch

    inputs = _inputs(case)
    calls, bounds = kernels(case, inputs)
    first, bitwise, ref = run_twice(calls)
    out = {"repeat_bitwise": bitwise}
    if case == "qr":
        (Q,), Q0 = first["householder_qr"], ref["householder_qr"][0]
        out["projector_max_abs"] = (Q @ Q.transpose(-1, -2) - Q0
                                    @ Q0.transpose(-1, -2)).abs().max().item()
    else:
        out["rel_max"] = {name: max(_rel(a, b) for a, b in zip(
            first[name], ref[name])) for name in calls}
        S, codes = inputs[0], inputs[2]
        unobserved = len(inputs[6]) - 1 if case in ORDINAL else 2
        per_obs = S.shape[0] // codes.shape[0]   # the scorer's N, else 1
        out["entries"] = per_obs * codes.numel()
        out["observed"] = per_obs * int(
            (codes.long() < unobserved).sum().item())
    if case in ORDINAL:
        S, C, codes, W, U, _, table, st = inputs
        pairs = [(c, b) for way in ("fwd", "bwd")
                 if f"quantized_nll_{way}" in first
                 for c, b in zip(first[f"quantized_nll_coded_{way}"],
                                 first[f"quantized_nll_{way}"])]
        out["coded_equals_bounds"] = all(torch.equal(c, b) for c, b in pairs)
        if case == "scorer":
            from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
                quantized_nll as q)

            one = torch.cat([q.quantized_nll_fwd_cuda(s[None], C, W, U, *st)
                             for s in S])
            out["scorer_equals_single_launches"] = bool(
                torch.equal(first["quantized_nll_fwd"][0], one))
    for name, row in in_turns(calls).items():
        out[name] = {**row, **bounds[name]}
        if case == "gan":
            out[name]["host_ms"] = host_ms(calls[name][0])
            out[name]["device_us_by_kernel"] = device_us_by_kernel(
                calls[name][0])
    return out


def _tool(name):
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build

    return str(Path(_build._nvcc()).with_name(name))


def short_name(mangled):
    """'fwd<2>' for the 1-bit forward at R=2; 'coded_fwd<2,1,0>' for a coded
    ordinal kernel at R=2, linear link, robust numerics, 'fwd<2,1,0>' for a
    bounds kernel; None for any other kernel.  The ordinal tile kernels name
    their observation source (Codes or Bounds) as their first template
    argument; earlier builds named the coded kernels qnll_coded_*, and the
    first one carried the coded flag as their first bool ('fwd<2,1,1,0>')."""
    m = re.search(r"onebit_(fwd|bwd)_kernelILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"qnll_(coded_)?(fwd|bwd)_kernelI(?:N\w*?(Codes|Bounds)E)?"
                  r"Li(\d+)E((?:Lb[01]E)*)", mangled)
    if not m:
        return None
    coded = "coded_" if m.group(1) or m.group(3) == "Codes" else ""
    flags = ",".join(re.findall(r"Lb([01])E", m.group(5)))
    return f"{coded}{m.group(2)}<{m.group(4)},{flags}>"


def _coded(short):
    """Whether a short name is a coded ordinal kernel, in either build."""
    return short.startswith("coded_") or short.count(",") == 3 and (
        short.split("<")[1].split(",")[1] == "1")


def _rank2(short):
    """The rank-2 1-bit and bounds kernels, whose SASS --sass-out keeps."""
    return not _coded(short) and bool(re.match(r"(fwd|bwd)<2[,>]", short))


def ptxas_report(log_text):
    """{kernel: (registers, spill store bytes)} of the likelihood kernels
    (those `short_name` names), from ptxas' verbose build log."""
    report, name, spills = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), spills)
    return report


_CMP_AT_ZERO = {"GT": True, "GE": True, "LT": False, "LE": False,
                "EQ": False, "NE": True}


def direct_path(instrs, index, lo, hi):
    """Instructions issued by one pass of the loop instrs[lo..hi] (`index`
    maps an address to its instruction) when every element takes the direct
    branch (t > -4: the tail test is an FSETP against -4, decided here at
    t = 0) and every division or reciprocal its fast path (a branch that
    skips a stub of at most 8 instructions with a CALL to the slow path is
    taken); any other conditional branch falls through."""
    preds, i, n = {}, lo, 0
    while lo <= i <= hi and n < 100000:
        ins = instrs[i]
        n += not ins.startswith("NOP")
        m = re.match(r"FSETP\.([A-Z]+?)U?\.AND (P\d), PT, \S+, -4,", ins)
        if m and m.group(1) in _CMP_AT_ZERO:
            preds[m.group(2)] = _CMP_AT_ZERO[m.group(1)]
        m = re.match(r"(@(!?)(P\d) )?BRA (0x[0-9a-f]+)", ins)
        if not m:
            i += 1
            continue
        target = index[int(m.group(4), 16)]
        if i == hi:
            break
        if m.group(1) is None:
            taken = True
        elif m.group(3) in preds:
            taken = preds.pop(m.group(3)) != bool(m.group(2))
        else:
            taken = i < target <= i + 8 and any(
                "CALL" in x for x in instrs[i + 1:target])
        i = target if taken else i + 1
    return n


def loop_kind(instrs):
    """'list' for a numerics loop that reads the list of observed entries
    (16-bit entries in shared memory), else 'dense'."""
    return "list" if any("LDS.U16" in x for x in instrs) else "dense"


def sass_loops(lib_path, sass_out=None, keep=_rank2, classify=None):
    """{kernel: (static instructions, direct-path instructions, MUFU) of its
    largest innermost loop that holds a MUFU}, for the likelihood kernels,
    named by `short_name`; the SASS of those `keep` accepts (the rank-2
    1-bit and bounds kernels by default) goes to `sass_out`.  With
    `classify` (a loop's instructions -> a label), a kernel maps to
    {label: the largest such loop of that label}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = short_name(chunk.split(None, 1)[0])
        if name is None:
            continue
        if sass_out and keep(name):
            with open(sass_out, "a") as f:
                f.write(f"Function : {chunk}\n")
        instrs, index = [], {}
        for line in chunk.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                index[int(m.group(1), 16)] = len(instrs)
                instrs.append(m.group(2))
        loops = []
        for i, ins in enumerate(instrs):
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", ins)
            if m and index.get(int(m.group(1), 16), i + 1) <= i:
                loops.append((index[int(m.group(1), 16)], i))
        # the innermost loop that runs the numerics: one with a MUFU in it
        # and no other such loop inside (a loop of the boundary decode
        # nested in a band loop does not count)
        loops = [lp for lp in loops if any(
            "MUFU" in x for x in instrs[lp[0]:lp[1] + 1])]
        inner = [lp for lp in loops if not any(
            lp[0] <= o[0] and o[1] <= lp[1] and o != lp for o in loops)]
        if not inner:
            continue
        groups = {}
        for lo, hi in inner:
            label = classify(instrs[lo:hi + 1]) if classify else None
            groups.setdefault(label, []).append((lo, hi))
        read = {}
        for label, lps in groups.items():
            lo, hi = max(lps, key=lambda lp: lp[1] - lp[0])
            body = [x for x in instrs[lo:hi + 1] if not x.startswith("NOP")]
            read[label] = (len(body), direct_path(instrs, index, lo, hi),
                           sum("MUFU" in x for x in body))
        out[name] = read if classify else read[None]
    return out


def clock_under_load(fn, seconds=2.0):
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    while graphs of `fn` replay back to back for `seconds` (the first
    quarter of the samples dropped)."""
    import torch

    graph = _capture(fn)
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            for _ in range(20):
                graph.replay()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")]
            for line in out.splitlines() if line.count(",") == 1]
    rows = rows[len(rows) // 4:]
    if not rows:
        return None, None

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    return median([r[0] for r in rows]), median([r[1] for r in rows])


def floor_report(records, sass_out=None):
    """The floor of every likelihood kernel at every case of `records`
    (time_case's), for the checkout on sys.path."""
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    path = _build.build()
    log = path.with_suffix(".log")
    regs = ptxas_report(log.read_text() if log.exists() else "")
    loops = sass_loops(path, sass_out, classify=loop_kind)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=30).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    load = {}
    for case in ("bench", "lowrank"):         # every entry observed, R=2
        calls, _ = kernels(case, _inputs(case))
        load.update({name: clock_under_load(kern)
                     for name, (kern, _) in calls.items()})
    lib = q._lib()
    # whether the ordinal kernels list the observed entries: the tile
    # body's shared scratch size, or the coded kernels' own in the build
    # before the bounds pair moved onto it
    compacts = {"quantized_nll": hasattr(lib, "qsc_qnll_tiles"),
                "quantized_nll_coded": hasattr(lib, "qsc_qnll_tiles")
                or hasattr(lib, "qsc_qnll_coded_tiles")}
    floors = {}
    for case, rec in records.items():
        for name in [n for n in rec if n.endswith(("_fwd", "_bwd"))]:
            (R, lin, fast), way = VARIANT[case], name[-3:]
            # its short name: the current build's, then the one before the
            # coded kernels had a file of their own
            names = ([f"{way}<{R}>"] if name.startswith("onebit") else
                     [f"coded_{way}<{R},{lin},{fast}>",
                      f"{way}<{R},1,{lin},{fast}>"] if "coded" in name else
                     [f"{way}<{R},{lin},{fast}>", f"{way}<{R},0,{lin},{fast}>"])
            kernel = next((x for x in names if x in loops), None)
            by_loop = loops.get(kernel, {})
            # the loop this case runs: with every entry observed, the dense
            # one where the kernel has one
            order = (("dense", "list") if rec["observed"] == rec["entries"]
                     else ("list", "dense"))
            loop = next((lp for lp in order if lp in by_loop), None)
            static, direct, mufu = by_loop[loop] if loop else (0, 0, 0)
            # entries a pass of the loop covers: a 1-bit thread's columns
            per_pass = (k._lib().qsc_onebit_cols(R, int(way == "bwd"))
                        if name.startswith("onebit") else 1)
            n = rec["observed"] if compacts.get(name[:-4]) else rec["entries"]
            load_mhz, load_w = load.get(name, (None, None))
            floors[f"{case} {name}"] = {
                "kernel": kernel, "loop": loop, "loop_static": static,
                "loop_direct": direct, "loop_mufu": mufu,
                "entries_per_pass": per_pass, "loop_entries": n,
                "sm_mhz_under_load": load_mhz, "power_w_under_load": load_w,
                **{key: None if not mhz else direct / per_pass * n / 32
                   / (4 * sms * mhz * 1e6) * 1e3
                   for key, mhz in (("issue_floor_ms", max_mhz),
                                    ("issue_floor_ms_at_load_clock",
                                     load_mhz))}}
    return {"registers_spills": regs, "sass_loops": loops,
            "max_sm_mhz": max_mhz, "sms": sms, "compacts_observed": compacts,
            "floors": floors}


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
    for case, kinds in runs[0]["cases"].items():
        for name, row in kinds.items():
            for how in ("graph_ms", "eager_ms", "host_ms"):
                if not isinstance(row, dict) or how not in row:
                    continue
                old = [r["cases"][case][name][how] for r in runs[0::3]]
                new = [r["cases"][case][name][how] for r in runs[1:3]]
                table[f"{case} {name} {how}"] = {
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
                    help="with --floor: write the rank-2 1-bit and bounds "
                         "kernels' SASS here (with --against: FILE.0 of DIR, "
                         "FILE.1 of the root)")
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
