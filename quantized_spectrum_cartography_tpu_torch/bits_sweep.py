"""The 1-to-8-bit recovery ladder, and the bounds kernel at 256 bins, on the
port.

    python -m quantized_spectrum_cartography_tpu_torch.bits_sweep \\
        --out BITS_SWEEP_TORCH.json [--device cuda]

The counterpart of the JAX package's ``tools/bits_sweep_tpu.py``.  The
system's problem statement is "1-bit up to 8-bit"; this protocol recovers
one fixed problem set (64 maps of 51x51x64, R=2, per-entry mask f=0.1) at
five depths (`CONFIGS`): 1 and 2 bits on the 4-bin log table at sigma
1.287, 3 bits on the 7-adjusted table and 4 bits on the 16-adjusted table
at sigma 0.5, 8 bits on the 256-bin uniform LINEAR table at
SD_256_BINS_UNIFORM; and the unquantized masked-LS floor.  The solver
(`solve`, bits_sweep_tpu.py:116-202) is batched free-factor ordinal MLE:
WARM Adam steps of masked LS to the bin midpoints, then ITERS steps of the
ordinal NLL with a midpoint tether (0.1) and 0.01 Frobenius terms, the
gradient clipped to global norm 10 before Adam under a cosine schedule
(0.02, alpha 0.05), the nonnegative rank-10 projection every 25 steps; then
the per-map gain recalibration.  The likelihood is plain torch here, as
the JAX tool computes it outside any Pallas kernel.  Per depth: NMSE and
NMSE_LOG (offset LOG_OFFSET_7_ADJUSTED) mean, median and per-map standard
deviation, the raw NMSE, the bins seen and the seconds.

Last, the bounds kernel pair (`fused_quantized_nll`'s CUDA kernels) at the
tool's 256-bin operating point (`kernel_point`: B=128, K=64, 51x51, R=2,
10% mask, linear link, robust numerics): forward and backward against
their plain versions (value rtol 1e-5, gradients 1e-4 of max |grad|), a
second launch bit for bit, and the forward's time by CUDA events.

The gate, per depth: |mean_port - mean_jax| of NMSE_LOG <= 3 sqrt 2
sd_port / sqrt(64) against BITS_SWEEP.json, whose means only it keeps (so
the port's sd stands in for JAX's).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    PhysicsConfig,
    set_card_numerics,
)
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    gather_bin_bounds,
    log_prob_probit_bounds,
    masked_nll,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    get_tensor,
    project_nonneg,
    project_rank,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import (
    nmse,
    nmse_log,
)
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    adam_init,
    adam_step,
    cosine_lr,
    value_and_grad,
)
from quantized_spectrum_cartography_tpu_torch.utils.profiling import sync_device

BATCH, R, ITERS, WARM, LR = 64, 2, 2000, 400, 0.02
FRACTION = 0.1
TETHER = 0.1                 # midpoint tether weight (bits_sweep_tpu.py:60)
CLIP_NORM = 10.0             # global-norm clip before Adam
COSINE_ALPHA = 0.05
RANK, PROJECT_EVERY = 10, 25
FRO = 0.01                   # the S and C Frobenius terms
METRIC_OFFSET = bnd.LOG_OFFSET_7_ADJUSTED
_MAP = (-3, -2, -1)

# (label, bits, boundaries, offset (None: linear link), sigma)
CONFIGS = (
    ("1-bit", 1, (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG[0],
                  bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG[2],
                  bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG[-1]),
     bnd.LOG_OFFSET_4, 1.287),
    ("2-bit", 2, bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, bnd.LOG_OFFSET_4,
     1.287),
    ("3-bit", 3, bnd.QUANTIZATION_BOUNDARIES_7_ADJUSTED,
     bnd.LOG_OFFSET_7_ADJUSTED, 0.5),
    ("4-bit", 4, bnd.QUANTIZATION_BOUNDARIES_16_ADJUSTED,
     bnd.LOG_OFFSET_16_ADJUSTED, 0.5),
    ("8-bit", 8, bnd.QUANTIZATION_BOUNDARIES_256_BINS_UNIFORM, None,
     bnd.SD_256_BINS_UNIFORM),
)
ROOT = Path(__file__).resolve().parents[1]
REFERENCE = str(ROOT / "BITS_SWEEP.json")
Z_LIMIT = 3.0 * math.sqrt(2.0)
# the 256-bin kernel point (bits_sweep_tpu.py:309-357)
KERNEL_BATCH = 128
VALUE_RTOL, GRAD_RTOL = 1e-5, 1e-4
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3


def problem_set(generator: torch.Generator, batch: int = BATCH,
                physics: PhysicsConfig = PhysicsConfig(), device="cuda"):
    """The fixed problem set: `batch` maps (clamped at 0) and the
    per-entry observation mask (Bernoulli(FRACTION), float)."""
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)

    T, _, _, _ = generate_map_batch(generator, physics, batch, device)
    T = T.clamp_min(0.0)
    mask = (torch.rand(T.shape, generator=generator, device=device)
            < FRACTION).to(T.dtype)
    return T, mask


def observe(T: torch.Tensor, noise: torch.Tensor, table, offset, sigma):
    """Bin indices Y of one depth from the standard normals `noise` (the
    same for every depth, as the JAX tool's keys are), the bounds (W, U)
    and the bin-midpoint dequantization Td (the one-sided outer bins
    clipped to the table's edges; mapped back to linear for a log table)."""
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize, quantize_log)

    Y = (quantize(T, sigma, table, noise=noise) if offset is None
         else quantize_log(T, sigma, table, offset, noise=noise))
    Wb, Ub = gather_bin_bounds(Y, table)
    lo, hi = float(table[0]), float(table[-1])
    mid = (Wb.clamp(lo, hi) + Ub.clamp(lo, hi)) / 2
    Td = mid if offset is None else (torch.exp(mid) - offset).clamp_min(0.0)
    return Y, Wb, Ub, Td


def _project(S, C):
    return project_nonneg(project_rank(S, RANK)), project_nonneg(C)


def _clip_global(grads, max_norm: float = CLIP_NORM):
    """optax.clip_by_global_norm: every gradient scaled by max_norm / norm
    when the norm over all of them (every map of the batch) reaches
    max_norm."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    return tuple(torch.where(norm < max_norm, g, g / norm * max_norm)
                 for g in grads)


def _adam_phase(loss_fn, S, C, steps: int, lr_of, clip: bool):
    """`steps` Adam steps on (S, C) (one optax.adam over both, shared
    count), the rank projection every PROJECT_EVERY; returns (S, C, the
    per-step summed loss)."""
    st_S, st_C, costs = adam_init(S), adam_init(C), []
    for i in range(steps):
        cost, grads = value_and_grad(loss_fn, S, C)
        if clip:
            grads = _clip_global(grads)
        lr = lr_of(i)
        S, st_S = adam_step(lr, grads[0], S, st_S)
        C, st_C = adam_step(lr, grads[1], C, st_C)
        if (i + 1) % PROJECT_EVERY == 0:
            S, C = _project(S, C)
        costs.append(cost.sum())
    return S, C, torch.stack(costs) if costs else torch.zeros(0)


def solve(Wb, Ub, mask, Td, sigma: float, offset: Optional[float], S0, C0,
          warm: int = WARM, iters: int = ITERS):
    """Batched ordinal MLE on the bounds (Wb, Ub) [B, K, I, J]
    (bits_sweep_tpu.py:116-202); offset None takes the linear link.
    Returns (T_hat [B, K, I, J] = max(S o C, 0), the warm phase's and the
    NLL phase's per-step losses summed over the maps)."""
    linear = offset is None
    zero = torch.zeros((), dtype=Wb.dtype, device=Wb.device)

    def warm_loss(S, C):
        return (mask * (get_tensor(S, C) - Td).square()).sum(_MAP) * 1e4

    def loss(S, C):
        # torch.maximum shares the gradient at a tie, as jnp.maximum does
        Th = torch.maximum(get_tensor(S, C), zero)
        x = Th if linear else torch.log(Th + offset)
        out = masked_nll(log_prob_probit_bounds(Wb, Ub, x, sigma), mask)
        out = out + TETHER * 1e4 * (mask * (Th - Td).square()).sum(_MAP)
        return out + FRO * safe_fro(C, (-2, -1)) + FRO * safe_fro(S, _MAP)

    S, C, warm_costs = _adam_phase(warm_loss, S0, C0, warm, lambda i: LR,
                                   clip=False)
    S, C, costs = _adam_phase(
        loss, S, C, iters, lambda i: cosine_lr(LR, i, iters, COSINE_ALPHA),
        clip=True)
    with torch.no_grad():
        T_hat = get_tensor(S, C).clamp_min(0.0)
    return T_hat, warm_costs, costs


def solve_floor(mask, T, S0, C0, iters: int = ITERS):
    """The unquantized masked-LS low-rank fit, the floor the ladder
    approaches (bits_sweep_tpu.py:205): the same optimizer (no clip) and
    projection budget."""
    def loss(S, C):
        return (mask * (get_tensor(S, C) - T).square()).sum(_MAP) * 1e4

    S, C, costs = _adam_phase(
        loss, S0, C0, iters, lambda i: cosine_lr(LR, i, iters, COSINE_ALPHA),
        clip=False)
    with torch.no_grad():
        T_hat = get_tensor(S, C).clamp_min(0.0)
    return T_hat, costs


def initial_factors(generator, batch, K, I, J, device):
    """S0 = 0.01 |N(0, 1)| [B, R, I, J], C0 = 0.01 [B, R, K]."""
    S0 = 0.01 * torch.randn(batch, R, I, J, generator=generator,
                            device=device).abs()
    return S0, torch.full((batch, R, K), 0.01, device=device)


def recalibrate(T_hat, Y, table, sigma, offset, mask):
    """The per-map gain recalibration (solvers/calibrate.py), map by map."""
    from quantized_spectrum_cartography_tpu_torch.solvers.calibrate import (
        recalibrate_gain)

    with torch.no_grad():
        return torch.stack([recalibrate_gain(
            T_hat[b], Y[b], table, sigma, 0.0 if offset is None else offset,
            mask[b], linear=offset is None)[1] for b in range(T_hat.shape[0])])


def scores(T_hat, T) -> Dict[str, np.ndarray]:
    with torch.no_grad():
        return {"nmse": nmse(T_hat, T, dim=_MAP).cpu().numpy(),
                "nmse_log": nmse_log(T_hat, T, METRIC_OFFSET,
                                     dim=_MAP).cpu().numpy()}


def _summary(e: np.ndarray, el: np.ndarray) -> dict:
    return {"nmse_mean": round(float(e.mean()), 4),
            "nmse_median": round(float(np.median(e)), 4),
            "nmse_sd": round(float(e.std(ddof=1)), 4),
            "nmse_log_mean": round(float(el.mean()), 4),
            "nmse_log_median": round(float(np.median(el)), 4),
            "nmse_log_sd": round(float(el.std(ddof=1)), 4)}


def ladder(T, mask, noise, S0, C0, warm=WARM, iters=ITERS,
           log=print) -> Dict[str, dict]:
    """Every depth of CONFIGS and the floor on one problem set."""
    device = T.device
    results = {}
    for label, bits, table, offset, sigma in CONFIGS:
        sync_device(device)
        t0 = time.perf_counter()
        Y, Wb, Ub, Td = observe(T, noise, table, offset, sigma)
        T_hat, _, costs = solve(Wb, Ub, mask, Td, sigma, offset, S0, C0,
                                warm, iters)
        T_cal = recalibrate(T_hat, Y, table, sigma, offset, mask)
        s, raw = scores(T_cal, T), scores(T_hat, T)
        sync_device(device)
        results[label] = {
            "bits": bits, "num_bins": len(table) - 1, "sigma": float(sigma),
            "domain": "linear" if offset is None else "log",
            "bin_span_observed": [int(Y.min()), int(Y.max())],
            **_summary(s["nmse"], s["nmse_log"]),
            "nmse_raw_mean": round(float(raw["nmse"].mean()), 4),
            "final_cost": float(costs[-1]) if len(costs) else None,
            "finite": bool(np.isfinite(s["nmse"]).all()
                           and np.isfinite(s["nmse_log"]).all()),
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        log(f"{label}: NMSE {s['nmse'].mean():.4f} (raw "
            f"{raw['nmse'].mean():.4f}) NMSE_LOG {s['nmse_log'].mean():.4f} "
            f"(bins seen {results[label]['bin_span_observed']}, "
            f"{results[label]['wall_s']:.1f} s)")
    sync_device(device)
    t0 = time.perf_counter()
    T_hat, _ = solve_floor(mask, T, S0, C0, iters)
    s = scores(T_hat, T)
    sync_device(device)
    results["unquantized floor"] = {
        "bits": None, "num_bins": None, "sigma": 0.0, "domain": "linear",
        **_summary(s["nmse"], s["nmse_log"]),
        "wall_s": round(time.perf_counter() - t0, 3)}
    log(f"unquantized floor: NMSE {s['nmse'].mean():.4f} NMSE_LOG "
        f"{s['nmse_log'].mean():.4f}")
    return results


def gate(results: dict, ref: dict, examples: int) -> dict:
    """Per depth, |mean_port - mean_jax| of NMSE_LOG <= 3 sqrt 2 sd_port /
    sqrt(examples)."""
    rows, ok = {}, True
    for label, r in results.items():
        if label not in ref or "nmse_log_sd" not in r:
            continue
        mj = ref[label]["nmse_log_mean"]
        se = r["nmse_log_sd"] / math.sqrt(examples)
        z = (r["nmse_log_mean"] - mj) / se if se > 0 else 0.0
        rows[label] = {"port": r["nmse_log_mean"], "jax": mj,
                       "se_port": round(se, 5), "z": round(z, 3),
                       "in_band": bool(abs(z) <= Z_LIMIT)}
        ok &= rows[label]["in_band"]
    return {"rule": "|mean_port - mean_jax| of NMSE_LOG <= 3 sqrt(2) "
                    "sd_port / sqrt(maps); BITS_SWEEP.json keeps only means "
                    "and medians, so the port's per-map sd stands in for "
                    "both sides'",
            "per_depth": rows, "pass": ok}


def kernel_inputs(T0, mask0, generator, batch: int = KERNEL_BATCH):
    """The 256-bin point's inputs (bits_sweep_tpu.py:315-333): one map T0
    [K, I, J] quantized on the 256-bin linear table at
    SD_256_BINS_UNIFORM, packed with its mask, S ~ U(0, 0.05) [R, IJ] and
    C ~ U(0, 1) [K, R]; all repeated to `batch` maps (the backward takes
    per-map inputs)."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize)

    table = bnd.QUANTIZATION_BOUNDARIES_256_BINS_UNIFORM
    sigma = float(bnd.SD_256_BINS_UNIFORM)
    device = T0.device
    Y = quantize(T0, sigma, table, generator)
    W, U = q.pack_bounds(Y, table, mask0)
    K, P = W.shape
    S = 0.05 * torch.rand(R, P, generator=generator, device=device)
    C = torch.rand(K, R, generator=generator, device=device)

    def rep(x):
        return x[None].repeat(batch, *(1,) * x.dim()).contiguous()

    return rep(S), rep(C), rep(W), rep(U), sigma


def kernel_point(T0, mask0, generator) -> dict:
    """The bounds pair at the 256-bin point on the card: parity of the
    forward and backward kernels against their plain versions, a second
    launch bit for bit, the forward's and backward's ms (CUDA events over
    back-to-back calls) and device ms (the calls in one CUDA graph;
    bench_onebit.py's timers), and the bound: W and U read once (8 bytes an
    entry) at 3.35 TB/s."""
    from quantized_spectrum_cartography_tpu_torch.bench_onebit import (
        eager_ms, graph_ms)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    S, C, W, U, sigma = kernel_inputs(T0, mask0, generator)
    batch = S.shape[0]
    fast = q._fast_ok(sigma)
    st = (sigma, 0.0, True, fast)
    g = torch.ones(batch, device=S.device)

    def fwd():
        return q.quantized_nll_fwd_cuda(S, C, W, U, *st)

    def bwd():
        return q.quantized_nll_bwd_cuda(S, C, W, U, g, *st)

    v, (dS, dC) = fwd(), bwd()
    v2, (dS2, dC2) = fwd(), bwd()
    torch.cuda.synchronize()
    v0 = q.quantized_nll_plain(S, C, W, U, *st)
    dS0, dC0 = q.quantized_nll_grad_plain(S, C, W, U, g, *st)
    rel_v = ((v - v0).abs() / v0.abs()).max().item()
    rel_s = ((dS - dS0).abs().max() / dS0.abs().max()).item()
    rel_c = ((dC - dC0).abs().max() / dC0.abs().max()).item()
    bitwise = (torch.equal(v, v2) and torch.equal(dS, dS2)
               and torch.equal(dC, dC2))
    ms = {"fwd": eager_ms(fwd), "bwd": eager_ms(bwd)}
    graph = {"fwd": graph_ms(fwd), "bwd": graph_ms(bwd)}
    nbytes = 2 * W.numel() * 4
    return {
        "batch": batch, "K": int(C.shape[1]), "P": int(S.shape[2]),
        "R": R, "linear": True, "sigma": sigma, "fast_numerics": fast,
        "observed_entries": int((W > -q.MASK_SENTINEL).sum().item()),
        "value_rel": rel_v, "dS_rel_of_max": rel_s, "dC_rel_of_max": rel_c,
        "max_abs_err": max((v - v0).abs().max().item(),
                           (dS - dS0).abs().max().item(),
                           (dC - dC0).abs().max().item()),
        "parity": bool(rel_v <= VALUE_RTOL and rel_s <= GRAD_RTOL
                       and rel_c <= GRAD_RTOL),
        "second_launch_bitwise": bool(bitwise),
        "fwd_ms": ms["fwd"], "bwd_ms": ms["bwd"],
        "fwd_graph_ms": graph["fwd"], "bwd_graph_ms": graph["bwd"],
        "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "bound_bytes": nbytes,
    }


def main(argv=None):
    from quantized_spectrum_cartography_tpu_torch.published_sre import (
        device_info)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--maps", type=int, default=BATCH)
    p.add_argument("--warm", type=int, default=WARM)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if os.path.basename(args.out) == "BITS_SWEEP.json":
        p.error("BITS_SWEEP.json is the JAX package's; write the port's "
                "elsewhere (e.g. BITS_SWEEP_TORCH.json)")
    t0 = time.time()

    def log(*a):
        print(f"[{time.time() - t0:7.1f}s]", *a, flush=True)

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        set_card_numerics()
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    T, mask = problem_set(gen, args.maps, device=args.device)
    noise = torch.randn(T.shape, generator=gen, device=args.device)
    S0, C0 = initial_factors(gen, args.maps, *T.shape[1:], args.device)
    log(f"generated {args.maps} maps")
    results = ladder(T, mask, noise, S0, C0, args.warm, args.iters, log=log)
    if cuda:
        results["kernel_256bin"] = kernel_point(T[0], mask[0], gen)
        k = results["kernel_256bin"]
        log(f"256-bin bounds pair at B={k['batch']}: fwd {k['fwd_ms']:.4f} ms"
            f" (graph {k['fwd_graph_ms']:.4f}), bwd {k['bwd_ms']:.4f} ms "
            f"(graph {k['bwd_graph_ms']:.4f}), bound {k['bound_ms']:.4f} ms; "
            f"value rel {k['value_rel']:.2e}, dS {k['dS_rel_of_max']:.2e}, "
            f"dC {k['dC_rel_of_max']:.2e}; second launch bitwise "
            f"{k['second_launch_bitwise']}")
    with open(REFERENCE) as f:
        ref = json.load(f)["results"]
    doc = {
        "config": {"batch": args.maps, "fraction": FRACTION,
                   "warm": args.warm, "iters": args.iters, "lr": LR, "R": R,
                   "metric_offset": METRIC_OFFSET, "midpoint_tether": TETHER,
                   "clip_global_norm": CLIP_NORM,
                   "cosine_alpha": COSINE_ALPHA, "rank": RANK,
                   "project_every": PROJECT_EVERY, "seed": args.seed},
        "results": results,
        "gate": gate(results, ref, args.maps),
        "device": device_info(args.device),
        "wall_seconds": round(time.time() - t0, 1),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    log(f"wrote {args.out}; gate {'PASS' if doc['gate']['pass'] else 'FAIL'}")
    return doc


if __name__ == "__main__":
    main()
