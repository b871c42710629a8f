#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one line with its seconds:
  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   - the CUDA kernels, one nvcc call into build/torch_kernels/
  3. parity  - each kernel against its plain PyTorch version at the bench
               shapes (B=256, K=64, 51x51), R=2 and R=10, with and without a
               10% entry mask; value rtol 1e-5, gradients 1e-4 of max |grad|
  4. main    - the bench protocol through the port's entry points:
               generate_map_batch -> dither_probit -> recover_lowrank_mle
               (50 outer x (5 S + 5 C) Adam steps, rank-10 projection every
               5); both kernels must launch, the results must have their
               shapes and finite costs, the final NMSE must be finite
               and < 1, and the same solve with nll_mode="plain" must reach
               the same final costs (rtol 1e-3)
  5. timing  - kernel and plain ms at the bench shapes (CUDA events)

The line before the last two is the kernels' JSON record; then nvidia-smi's
"name, power.limit"; the last line is {"ok": true, "device": {...}}.  Any
failure, or running past DEADLINE_S, exits non-zero without that line.
"""

import json
import re
import subprocess
import sys
import time

import torch

DEADLINE_S = 600
DEVICE = "cuda"
BATCH, GRID, BANDS, RANK = 256, 51, 64, 2
OUTER, INNER = 50, 5
MEAN, STD = 0.0045, 0.008
PARITY_RANKS = (2, 10)
MASK_FRACTION = 0.1
VALUE_RTOL, GRAD_RTOL, COST_RTOL = 1e-5, 1e-4, 1e-3
TIMING_REPS = 20
# published H100 SXM peaks: HBM bytes/s and f32 FLOP/s outside tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12

SOURCE = "quantized_spectrum_cartography_tpu_torch/csrc/onebit_nll.cu"
TPU_KERNELS = "quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py"

_T0 = time.monotonic()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, fn):
    t = time.monotonic()
    out = fn()
    now = time.monotonic()
    print(f"phase {name}: {now - t:.2f} s", flush=True)
    if now - _T0 > DEADLINE_S:
        fail(f"past the {DEADLINE_S} s deadline after phase {name}")
    return out


def run_tool(cmd, timeout):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{cmd[0]} exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def device_info():
    smi = run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], timeout=30).splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return smi


def build():
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import _build

    path = _build.build()
    log = path.with_suffix(".log").read_text() if path.with_suffix(
        ".log").exists() else ""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
    print(f"built {path.name}: max {max(regs, default=0)} registers, "
          f"{spills} bytes of spill stores", flush=True)
    _build.load_library()


def parity_inputs(gen, R, masked):
    from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
        pack_codes_1bit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        sample_entry_mask)

    B, K, P = BATCH, BANDS, GRID * GRID
    S = 0.05 * torch.rand(B, R, P, generator=gen, device=DEVICE)
    C = torch.rand(B, K, R, generator=gen, device=DEVICE)
    y01 = (torch.rand(B, K, GRID, GRID, generator=gen, device=DEVICE) < 0.5)
    mask = (sample_entry_mask(gen, (B, K, GRID, GRID), MASK_FRACTION,
                              device=DEVICE)
            if masked else None)
    g = 0.5 + torch.rand(B, generator=gen, device=DEVICE)
    return S, C, pack_codes_1bit(y01.float(), mask), g


def parity():
    """Max abs errors (fwd, bwd) over all cases; fails past tolerance."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    err_f = err_b = 0.0
    for R in PARITY_RANKS:
        for masked in (False, True):
            S, C, codes, g = parity_inputs(gen, R, masked)
            v = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
            dS, dC = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
            torch.cuda.synchronize()
            v0 = k.onebit_nll_plain(S, C, codes, MEAN, STD)
            dS0, dC0 = k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)
            rel_v = ((v - v0).abs() / v0.abs()).max().item()
            rel_s = ((dS - dS0).abs().max() / dS0.abs().max()).item()
            rel_c = ((dC - dC0).abs().max() / dC0.abs().max()).item()
            print(f"parity R={R} mask={masked}: value rel {rel_v:.2e}, "
                  f"dS {rel_s:.2e}, dC {rel_c:.2e} of max", flush=True)
            if not (rel_v <= VALUE_RTOL and rel_s <= GRAD_RTOL
                    and rel_c <= GRAD_RTOL):
                fail(f"kernel disagrees with plain at R={R} mask={masked}")
            err_f = max(err_f, (v - v0).abs().max().item())
            err_b = max(err_b, (dS - dS0).abs().max().item(),
                        (dC - dC0).abs().max().item())
    return err_f, err_b


def main_path(card):
    from quantized_spectrum_cartography_tpu_torch.config import (
        PhysicsConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_lowrank_mle)

    cfg = PhysicsConfig(grid_size=GRID, num_bands=BANDS, num_emitters=RANK)
    scfg = SolverConfig(max_iters=OUTER, s_inner_iters=INNER,
                        c_inner_iters=INNER, lr_s=0.001, lr_c=0.001,
                        projection_interval=5, rank_truncation=10)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    T, _, _, _ = generate_map_batch(gen, cfg, BATCH, device=DEVICE)
    T_obs = dither_probit(T - MEAN, STD, gen)
    S0 = torch.zeros(BATCH, RANK, GRID, GRID, device=DEVICE)
    C0 = torch.full((BATCH, RANK, BANDS), 0.01, device=DEVICE)

    def solve(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = recover_lowrank_mle(T_obs, S0, C0, scfg, MEAN, STD, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    k.reset_launches()
    res, first_s = solve(T_true=T)
    launches = {"onebit_nll_fwd": k.onebit_nll_fwd_cuda.launches,
                "onebit_nll_bwd": k.onebit_nll_bwd_cuda.launches}
    if min(launches.values()) == 0:
        fail(f"the main path did not go through both kernels: {launches}")
    shapes = (tuple(res.S.shape), tuple(res.C.shape), tuple(res.costs.shape))
    if shapes != ((BATCH, RANK, GRID, GRID), (BATCH, RANK, BANDS),
                  (BATCH, OUTER)) or not torch.isfinite(res.costs).all():
        fail(f"unexpected result shapes {shapes} or non-finite costs")
    final_nmse = res.nmses[:, -1]
    mean_nmse = final_nmse.mean().item()
    if not (torch.isfinite(final_nmse).all() and mean_nmse < 1.0):
        fail(f"final NMSE not finite and < 1: mean {mean_nmse}")
    _, warm_s = solve()
    plain, plain_s = solve(T_true=T, nll_mode="plain")
    c, c0 = res.costs[:, -1], plain.costs[:, -1]
    cost_rel = ((c - c0).abs() / c0.abs()).max().item()
    print(f"main path: launches {launches}, final NMSE mean {mean_nmse:.4f}, "
          f"costs vs plain rel {cost_rel:.2e}", flush=True)
    print(f"main path: {BATCH} maps in {first_s:.3f} s first, {warm_s:.3f} s "
          f"warm = {BATCH / warm_s:.1f} maps/s on {card}; plain "
          f"{plain_s:.3f} s = {BATCH / plain_s:.1f} maps/s", flush=True)
    if not cost_rel <= COST_RTOL:
        fail(f"kernel and plain solves disagree on final cost: {cost_rel}")
    codes = k.pack_codes_1bit(T_obs)
    S_flat = res.S.reshape(BATCH, RANK, -1).contiguous()
    C = res.C.transpose(1, 2).contiguous()
    g = torch.full((BATCH,), 1.0 / T_obs[0].numel(), device=DEVICE)
    return launches, (S_flat, C, codes, g)


def event_ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMING_REPS


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing(inputs):
    """Kernel and plain ms in turns (plain, kernel, kernel, plain), and the
    bound of each pass from the bytes it must move and its f32 operations
    (the TPU kernels' own cost estimates: 2KRP + 15KP flops and 2KP
    transcendentals forward, 6KRP + 20KP and 3KP backward, per map)."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k

    S, C, codes, g = inputs
    B, R, P = S.shape
    K = C.shape[1]
    pairs = {
        "onebit_nll_fwd": (
            lambda: k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD),
            lambda: k.onebit_nll_plain(S, C, codes, MEAN, STD)),
        "onebit_nll_bwd": (
            lambda: k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD),
            lambda: k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)),
    }
    ms = {}
    for name, (kern, plain) in pairs.items():
        p1, k1, k2, p2 = (event_ms(plain), event_ms(kern), event_ms(kern),
                          event_ms(plain))
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    in_bytes = codes.numel() + 4 * (S.numel() + C.numel())
    bounds = {
        "onebit_nll_fwd": bound(in_bytes + 4 * B,
                                B * (2 * K * R * P + 17 * K * P)),
        "onebit_nll_bwd": bound(in_bytes + 4 * B + 4 * (S.numel() + C.numel()),
                                B * (6 * K * R * P + 23 * K * P)),
    }
    for name in pairs:
        print(f"timing {name}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]})", flush=True)
    return ms, bounds


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase("device", device_info)
    card = torch.cuda.get_device_name(0)
    phase("build", build)
    err_f, err_b = phase("parity", parity)
    launches, inputs = phase("main", lambda: main_path(card))
    ms, bounds = phase("timing", lambda: timing(inputs))

    errs = {"onebit_nll_fwd": err_f, "onebit_nll_bwd": err_b}
    lines = {"onebit_nll_fwd": 630, "onebit_nll_bwd": 638}
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": f"{TPU_KERNELS}:{lines[name]}",
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": ms[name][0], "plain_ms": ms[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": None,
    } for name in ("onebit_nll_fwd", "onebit_nll_bwd")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
