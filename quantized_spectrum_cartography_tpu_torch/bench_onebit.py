"""Device time of the 1-bit likelihood kernel pair on one GPU.

    python quantized_spectrum_cartography_tpu_torch/bench_onebit.py \
        [--root DIR] [--against DIR] [--floor]

Times ``onebit_nll_fwd_cuda`` and ``onebit_nll_bwd_cuda`` of the port found
under DIR (default: the checkout that holds this script) on two cases,
made from seed 0 on the card:
  bench    - B=256, K=64, 51x51, R=2, no mask: the true factors of
             simulated maps and their dithered 1-bit codes (sigma 0.008,
             threshold 0.0045), the shapes of the low-rank main path;
  r10_mask - the same at R=10 with 10% of the entries observed.
Each kernel's time is taken two ways: ``graph_ms``, TIMING_REPS wrapper
calls captured in one CUDA graph, its replays timed with CUDA events (the
device time, without the host's cost per call); and ``eager_ms``,
back-to-back wrapper calls timed the same way (what ``chip_smoke.py``
reports as ``ms``).  Each kernel is also held against its plain version.
Prints one JSON line.

--against DIR runs this script on DIR and on --root in turns (DIR, root,
root, DIR), one process each, and prints both and the ratio: a
comparison of two versions of the kernels in one call on one card.
--floor adds, for the root's kernels: ptxas' registers and spills of every
instantiation (from the build log); from ``cuobjdump -sass``, the innermost
loop of each kernel (one band over a thread's columns), its static
instruction count and the count on its direct path (every element with
t > -4 and the fast path of each division), per element; the SM clock and
power that nvidia-smi reads while each rank-2 kernel runs back to back;
and the issue floor at the bench case, direct-path instructions x
elements / (32 lanes x 4 schedulers x SMs x SM clock), at the card's
maximum clock and at the clock under load.  --sass-out FILE appends the
rank-2 kernels' SASS to FILE.
Needs a CUDA device.
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
B, K, GRID = 256, 64, 51
TIMING_REPS, GRAPH_REPLAYS, WARMUP = 20, 10, 3
CASES = {"bench": (2, None), "r10_mask": (10, 0.1)}


def _inputs(R, fraction):
    """S [B,R,P], C [B,K,R], codes [B,K,P], g [B] from seed 0 on the card."""
    import torch

    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
        pack_codes_1bit)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch, sample_entry_mask)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = PhysicsConfig(grid_size=GRID, num_bands=K, num_emitters=R)
    T, S, C, _ = generate_map_batch(gen, cfg, B, device="cuda")
    mask = (None if fraction is None else
            sample_entry_mask(gen, tuple(T.shape), fraction, device="cuda"))
    codes = pack_codes_1bit(dither_probit(T - MEAN, STD, gen), mask)
    g = torch.full((B,), 1.0 / T[0].numel(), device="cuda")
    return (S.reshape(B, R, -1).contiguous(), C.transpose(1, 2).contiguous(),
            codes, g)


def eager_ms(fn):
    import torch

    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMING_REPS


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
    """ms per call of TIMING_REPS calls of `fn` captured in one CUDA graph."""
    import torch

    graph = _capture(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * TIMING_REPS)


def time_case(R, fraction):
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)

    S, C, codes, g = _inputs(R, fraction)
    v = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
    dS, dC = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
    v2 = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
    dS2, dC2 = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
    torch.cuda.synchronize()
    v0 = k.onebit_nll_plain(S, C, codes, MEAN, STD)
    dS0, dC0 = k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)
    out = {
        "value_rel": ((v - v0).abs() / v0.abs()).max().item(),
        "dS_rel_max": ((dS - dS0).abs().max() / dS0.abs().max()).item(),
        "dC_rel_max": ((dC - dC0).abs().max() / dC0.abs().max()).item(),
        "repeat_bitwise": bool(torch.equal(v, v2) and torch.equal(dS, dS2)
                               and torch.equal(dC, dC2)),
    }
    for name, fn in (
            ("onebit_nll_fwd",
             lambda: k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)),
            ("onebit_nll_bwd",
             lambda: k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD))):
        out[name] = {"graph_ms": graph_ms(fn), "eager_ms": eager_ms(fn)}
    return out


def _tool(name):
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build

    return str(Path(_build._nvcc()).with_name(name))


def ptxas_report(log_text, match="onebit", short=None):
    """{kernel: (registers, spill store bytes)} of the kernels whose mangled
    name holds `match` (the 1-bit kernels by default), named by `short`."""
    short = short or _short
    report, name, spills = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and match in name:
            report[short(name)] = (int(m.group(1)), spills)
    return report


def _short(mangled):
    kind = "fwd" if "onebit_fwd" in mangled else "bwd"
    m = re.search(r"ILi(\d+)E", mangled)
    return f"{kind}<{m.group(1) if m else '?'}>"


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


def sass_loops(lib_path, sass_out=None, match="onebit", short=None,
               keep=lambda name: name.endswith("<2>"), classify=None):
    """{kernel: (static instructions, direct-path instructions, MUFU) of its
    largest innermost loop that holds a MUFU}, for the kernels whose
    mangled name holds `match`, named by `short`; the SASS of those whose
    short name `keep` accepts (the rank-2 ones by default) goes to
    `sass_out`.  With `classify` (a loop's instructions -> a label), a
    kernel maps to {label: the largest such loop of that label}."""
    short = short or _short
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split(None, 1)[0]
        if match not in name:
            continue
        if sass_out and keep(short(name)):
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
        out[short(name)] = read if classify else read[None]
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


def floor_report(sass_out=None):
    import torch

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)

    path = _build.build()
    log = path.with_suffix(".log")
    regs = ptxas_report(log.read_text() if log.exists() else "")
    loops = sass_loops(path, sass_out)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=30).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elements = B * K * GRID * GRID
    S, C, codes, g = _inputs(2, None)
    load = {
        "fwd": clock_under_load(
            lambda: k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)),
        "bwd": clock_under_load(
            lambda: k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD))}
    floor = {}
    for kind in ("fwd", "bwd"):
        load_mhz, load_w = load[kind]
        n, direct, mufu = loops.get(f"{kind}<2>", (0, 0, 0))
        cols = k._lib().qsc_onebit_cols(2, int(kind == "bwd"))
        per = direct / cols
        floor[kind] = {
            "loop_static": n, "loop_direct": direct, "loop_mufu": mufu,
            "elements_per_iteration": cols,
            "direct_instructions_per_element": per,
            "issue_floor_ms": per * elements / 32 / (4 * sms * mhz * 1e6)
            * 1e3,
            "sm_mhz_under_load": load_mhz, "power_w_under_load": load_w,
            "issue_floor_ms_at_load_clock": None if not load_mhz else
            per * elements / 32 / (4 * sms * load_mhz * 1e6) * 1e3}
    return {"registers_spills": regs, "sass_loops": loops,
            "max_sm_mhz": mhz, "sms": sms, "bench_floor_r2": floor}


def worker(args):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)

    rec = {"root": args.root, "card": torch.cuda.get_device_name(0)}
    lib = k._lib()
    if hasattr(lib, "qsc_onebit_cols"):
        rec["cols_fwd_bwd"] = {R: [lib.qsc_onebit_cols(R, 0),
                                   lib.qsc_onebit_cols(R, 1)]
                               for R, _ in CASES.values()}
    rec["cases"] = {name: time_case(*case) for name, case in CASES.items()}
    if args.floor:
        rec["floor"] = floor_report(args.sass_out)
    print(json.dumps(rec), flush=True)


def compare(args):
    here = str(Path(__file__).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    runs = []
    for root, floor in ((args.against, False), (args.root, args.floor),
                        (args.root, False), (args.against, False)):
        cmd = [sys.executable, here, "--root", root] + (
            ["--floor"] + (["--sass-out", args.sass_out] if args.sass_out
                           else []) if floor else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{root} failed ({proc.returncode}): "
                     f"{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    table = {}
    for case in CASES:
        for name in ("onebit_nll_fwd", "onebit_nll_bwd"):
            for how in ("graph_ms", "eager_ms"):
                old = [r["cases"][case][name][how] for r in runs[0::3]]
                new = [r["cases"][case][name][how] for r in runs[1:3]]
                mo, mn = sum(old) / 2, sum(new) / 2
                table[f"{case} {name} {how}"] = {
                    "against": old, "root": new, "ratio": mo / mn}
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
                    help="with --floor: append the rank-2 kernels' SASS here")
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
