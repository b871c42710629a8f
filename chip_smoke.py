#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   - the CUDA kernels, one nvcc process per source, then one link,
               into build/torch_kernels/
  3. parity  - the 1-bit pair against its plain PyTorch version at the bench
               shapes (B=256, K=64, 51x51), R=2 and R=10, with and without a
               10% entry mask; value rtol 1e-5, gradients 1e-4 of max |grad|;
               a second launch must give the same bits
  4. parity_ordinal - the four ordinal kernels (bounds and coded, forward
               and backward), each against its plain version, same
               tolerances, R=2 and R=10, with and without a 10% mask, on
               four cases:
               (a) log link, 4-bin log table, sigma 5 (fast numerics), B=1,
                   K=64, 51x51: the MLE-GAN shape;
               (b) log link, 8-bin log table, sigma 1 (robust numerics), B=1;
               (c) linear link, 2 bins split at 0.0045, sigma 0.008, B=256;
               (d) as (b) at B=3, K=70, 37x37: a partial tile of columns and
                   a partial chunk of bands;
               a second launch of each must give the same bits, and the
               coded kernels the bounds kernels' bits (one tile body, the
               same entries in the same order); and the forward as the
               z-search scorer, N=201 candidates sharing C and the
               observations, bitwise equal to N single launches, on codes
               bitwise equal to that on bounds
  5. main    - the bench protocol through the port's entry points:
               generate_map_batch -> dither_probit -> recover_lowrank_mle
               (50 outer x (5 S + 5 C) Adam steps, rank-10 projection every
               5); both 1-bit kernels must launch, the results must have
               their shapes and finite costs, the final NMSE must be finite
               and < 1, and the same solve with nll_mode="plain" must reach
               the same final costs (rtol 1e-3)
  6. checkpoints - the trained priors read from checkpoints/ by the port's
               reader (no orbax): gan256/final, vae_best/final,
               vae_peak_z256, ae_completion/final, each tree's paths and
               shapes held against its _METADATA, and each leaf's dtype,
               shape and sha256 against the digests of the JAX package's
               loader (training/checkpoint_digests.json, held against it by
               tests/test_torch_checkpoints.py); leaves, bytes, seconds;
               then the priors on the path (Generator256, the vae_best and
               vae_peak_z256 decoders) on the card against the same modules
               on the CPU, which the CPU tests hold against flax: 8 seeded
               latents, rtol 1e-4, atol 1e-5
  7. main_gan - MLE-GAN at full width: the trained Generator256
               (checkpoints/gan256/final), a problem it
               can realize (T = sum_r G(Z_true)_r |c_r|, K=64, 2 emitters,
               4-bin log quantizer, sigma 5, 10% entry mask), recover_mle_gan
               with SolverConfig() defaults (500 iterations, z-search of
               200 + 200 candidates at iteration 1) on "bounds" and on
               "codes": the counters must equal the launches the loop
               implies, costs finite and falling, C >= 0, the encodings'
               final costs within rtol 1e-3; then without the z-search,
               kernels against nll_mode="plain" (rtol 1e-3).  At these
               defaults the NMSE stays near 1, as in the JAX package: C
               starts at 0, where log(C S + 1e-10) makes the first C
               gradient so large that Adam's second moment stalls C near
               0.03, and sigma 5 leaves the 4 bins little to tell
  8. main_vae - `recover --solver mle-gan` at the CLI's defaults, in this
               process: the trained VAE prior (checkpoints/vae_best/final),
               a simulated 51x51x64 map, R=2, 10% observed, the 4-bin log
               quantizer at sigma 5, 100 iterations; the bounds pair must
               launch 2*100+2 / 2*100 times and no other ordinal kernel, the
               printed cost and NMSE be finite; then the same inputs through
               recover_mle_gan with the kernels and with nll_mode="plain"
               (final costs, rtol 1e-3; the final Z's difference printed);
               then `recover --solver dowjons` at its defaults: finite,
               falling costs and C >= 0
  9. harness - the five published methods (tps, btd, deepcomp, nasdac,
               dowjons) from load_pretrained_methods at the registry's
               defaults (checkpoints/ae_completion/final and
               checkpoints/vae_peak_z256) through BatchedHarness at the base
               condition (f=0.05, R=2, sigma 5, Xc 50, noiseless), 32
               examples at full width (51x51x64): each method's seconds,
               SRE mean / median / valid count, miss and false-alarm
               probabilities; every T_hat must be finite, every method
               present, and each method's mean SRE at most the JAX
               package's 256-example mean + 4 sd / sqrt(32) (both from
               PUBLISHED_SRE.json's sre_sorted, BTD's on its SRE < 3
               entries); none of the six kernels launches.  Then examples
               0 and 1 again on the CPU through the same code, with the
               card's random starts: tps, deepcomp and nasdac within
               relative Frobenius 1e-3 of the card's T_hat (a differing
               SPA column or witness peak is printed), btd's and dowjons'
               SRE differences printed
  10. main_lowrank_ordinal - recover_lowrank_mle at B=256 on obs_encoding
               "codes" and "bounds", cut from 50 to 10 outer iterations to
               keep the plain solves short, each against nll_mode="plain"
               (final costs, rtol 1e-3)
  11. timing - every kernel's and its plain version's ms (CUDA events over
               back-to-back calls, in turns plain, kernel, kernel, plain),
               the kernel's device time (graph_ms: TIMING_REPS calls captured
               in one CUDA graph, its replays timed with CUDA events, so the
               host's cost per call drops out) and its bound: the 1-bit pair
               at the bench shapes, the ordinal kernels at the MLE-GAN shape
               (B=1) and at the low-rank shape (B=256)

cuDNN runs without TF32 and with deterministic algorithms, so the solve
comparisons measure the likelihood kernels, not convolution atomics.
The line before the last two is the kernels' JSON record; then nvidia-smi's
"name, power.limit"; the last line is {"ok": true, "device": {...}}.  Any
failure, or running past DEADLINE_S, exits non-zero without that line.
"""

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

DEADLINE_S = 600
DEVICE = "cuda"
BATCH, GRID, BANDS, RANK = 256, 51, 64, 2
OUTER, INNER = 50, 5
LOWRANK_ORDINAL_OUTER = 10
MEAN, STD = 0.0045, 0.008
PARITY_RANKS = (2, 10)
MASK_FRACTION = 0.1
SCORER_N = 201
VALUE_RTOL, GRAD_RTOL, COST_RTOL = 1e-5, 1e-4, 1e-3
TIMING_REPS, GRAPH_REPLAYS = 20, 10
# published H100 SXM peaks: HBM bytes/s and f32 FLOP/s outside tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12

CSRC = "quantized_spectrum_cartography_tpu_torch/csrc/"
TPU_KERNELS = "quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py"
# kernel name -> (source, line of the TPU kernel it replaces)
KERNELS = {
    "onebit_nll_fwd": ("onebit_nll.cu", 630),
    "onebit_nll_bwd": ("onebit_nll.cu", 638),
    "quantized_nll_fwd": ("quantized_nll.cu", 157),
    "quantized_nll_bwd": ("quantized_nll.cu", 168),
    "quantized_nll_coded_fwd": ("quantized_nll_coded.cu", 442),
    "quantized_nll_coded_bwd": ("quantized_nll_coded.cu", 454),
}
ORDINAL = ("quantized_nll_fwd", "quantized_nll_bwd",
           "quantized_nll_coded_fwd", "quantized_nll_coded_bwd")
ROOT = Path(__file__).resolve().parent
CHECKPOINTS = {"gan256": "checkpoints/gan256/final",
               "vae_best": "checkpoints/vae_best/final",
               "vae_peak_z256": "checkpoints/vae_peak_z256",
               "ae_completion": "checkpoints/ae_completion/final"}
CLI_ITERS = 100                  # the CLI's --iters default
HARNESS_METHODS = ("tps", "btd", "deepcomp", "nasdac", "dowjons")
HARNESS_EXAMPLES, HARNESS_CPU_EXAMPLES = 32, 2
HARNESS_CPU_RTOL = 1e-3          # relative Frobenius, card against CPU
HARNESS_EXACT = ("tps", "deepcomp", "nasdac")   # the others: SRE printed
OUT_DIR = ROOT / "build" / "chip_smoke"
PRIOR_RTOL, PRIOR_ATOL = 1e-4, 1e-5

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
    print(f"built {path.name}: {len(regs)} kernels, max {max(regs, default=0)}"
          f" registers, {spills} bytes of spill stores", flush=True)
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


def rel_errs(v, v0, grads, grads0):
    """(value rel err, [grad err / max |grad|]) of kernel against plain."""
    rel_v = ((v - v0).abs() / v0.abs()).max().item()
    return rel_v, [((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(grads, grads0)]


def parity():
    """Max abs errors (fwd, bwd) over all cases; fails past tolerance."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    err_f = err_b = 0.0
    for R in PARITY_RANKS:
        for masked in (False, True):
            S, C, codes, g = parity_inputs(gen, R, masked)
            out = [(k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD),
                    *k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD))
                   for _ in range(2)]
            torch.cuda.synchronize()
            (v, dS, dC), again = out
            bitwise = all(torch.equal(a, b) for a, b in zip(out[0], again))
            v0 = k.onebit_nll_plain(S, C, codes, MEAN, STD)
            dS0, dC0 = k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)
            rel_v, (rel_s, rel_c) = rel_errs(v, v0, (dS, dC), (dS0, dC0))
            print(f"parity R={R} mask={masked}: value rel {rel_v:.2e}, "
                  f"dS {rel_s:.2e}, dC {rel_c:.2e} of max, second launch "
                  f"bitwise {bitwise}", flush=True)
            if not (rel_v <= VALUE_RTOL and rel_s <= GRAD_RTOL
                    and rel_c <= GRAD_RTOL and bitwise):
                fail(f"kernel disagrees with plain at R={R} mask={masked}, "
                     f"or with itself")
            err_f = max(err_f, (v - v0).abs().max().item())
            err_b = max(err_b, (dS - dS0).abs().max().item(),
                        (dC - dC0).abs().max().item())
    return {"onebit_nll_fwd": err_f, "onebit_nll_bwd": err_b}


def ordinal_cases():
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    # name -> (boundary table, sigma, offset, linear link, batch, bands, grid)
    log8 = (bnd.QUANTIZATION_BOUNDARIES_8_BINS_LOG, 1.0, bnd.LOG_OFFSET_4,
            False)
    return {
        "a_log4_sigma5": (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG, 5.0,
                          bnd.LOG_OFFSET_4, False, 1, BANDS, GRID),
        "b_log8_sigma1": log8 + (1, BANDS, GRID),
        "c_onebit_linear": (q.onebit_bounds(MEAN), STD, 0.0, True, BATCH,
                            BANDS, GRID),
        "d_log8_odd": log8 + (3, 70, 37),
    }


def ordinal_inputs(gen, case, R, masked):
    """S, C, (W, U), codes, g: observations quantized from C@S itself."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize, quantize_log)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        sample_entry_mask)

    table, sigma, offset, linear, B, K, I = case
    S = 0.05 * torch.rand(B, R, I * I, generator=gen, device=DEVICE)
    C = torch.rand(B, K, R, generator=gen, device=DEVICE)
    X = torch.matmul(C, S).reshape(B, K, I, I)
    Y = (quantize(X, sigma, table, gen) if linear
         else quantize_log(X, sigma, table, offset, gen))
    mask = (sample_entry_mask(gen, tuple(Y.shape), MASK_FRACTION,
                              device=DEVICE) if masked else None)
    g = 0.5 + torch.rand(B, generator=gen, device=DEVICE)
    return (S, C, q.pack_bounds(Y, table, mask),
            q.pack_codes(Y, len(table) - 1, mask), g)


def parity_ordinal():
    """Max abs errors of the four ordinal kernels over all cases."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    errs = dict.fromkeys(ORDINAL, 0.0)
    for name, case in ordinal_cases().items():
        table, sigma, offset, linear = case[:4]
        st = (sigma, offset, linear, q._fast_ok(sigma))
        for R in PARITY_RANKS:
            for masked in (False, True):
                S, C, (W, U), codes, g = ordinal_inputs(gen, case, R, masked)
                calls = {
                    "quantized_nll_fwd": lambda: (
                        q.quantized_nll_fwd_cuda(S, C, W, U, *st),),
                    "quantized_nll_bwd": lambda: q.quantized_nll_bwd_cuda(
                        S, C, W, U, g, *st),
                    "quantized_nll_coded_fwd": lambda: (
                        q.quantized_nll_coded_fwd_cuda(S, C, codes, table,
                                                       *st),),
                    "quantized_nll_coded_bwd": lambda: (
                        q.quantized_nll_coded_bwd_cuda(S, C, codes, table, g,
                                                       *st)),
                }
                out = {kname: fn() for kname, fn in calls.items()}
                again = {kname: fn() for kname, fn in calls.items()}
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b) for kname in calls
                              for a, b in zip(out[kname], again[kname]))
                ref = {"fwd": (q.quantized_nll_plain(S, C, W, U, *st),),
                       "bwd": q.quantized_nll_grad_plain(S, C, W, U, g, *st)}
                coded_ref = {
                    "fwd": (q.quantized_nll_coded_plain(S, C, codes, table,
                                                        *st),),
                    "bwd": q.quantized_nll_coded_grad_plain(
                        S, C, codes, table, g, *st)}
                # each kernel against its plain version, and the coded
                # kernels against the bounds kernels, bit for bit
                pairs = {
                    "bounds": ("quantized_nll_fwd", "quantized_nll_bwd", ref),
                    "coded": ("quantized_nll_coded_fwd",
                              "quantized_nll_coded_bwd", coded_ref),
                }
                same = all(torch.equal(a, b) for a, b in zip(
                    out["quantized_nll_coded_fwd"]
                    + out["quantized_nll_coded_bwd"],
                    out["quantized_nll_fwd"] + out["quantized_nll_bwd"]))
                ok, line = bitwise and same, []
                for label, (fwd, bwd, r) in pairs.items():
                    rel_v, (rel_s, rel_c) = rel_errs(
                        out[fwd][0], r["fwd"][0], out[bwd], r["bwd"])
                    ok = ok and (rel_v <= VALUE_RTOL and rel_s <= GRAD_RTOL
                                 and rel_c <= GRAD_RTOL)
                    line.append(f"{label}: value rel {rel_v:.2e}, dS "
                                f"{rel_s:.2e}, dC {rel_c:.2e} of max")
                print(f"parity {name} R={R} mask={masked}: "
                      + "; ".join(line) + f"; coded == bounds bitwise "
                      f"{same}; second launch bitwise {bitwise}", flush=True)
                if not ok:
                    fail(f"ordinal kernels disagree: {name} R={R} "
                         f"mask={masked}, or with themselves")
                for kname in ORDINAL:
                    r = (ref if "coded" not in kname else coded_ref)[
                        kname[-3:]]
                    errs[kname] = max(errs[kname], *(
                        (a - b).abs().max().item()
                        for a, b in zip(out[kname], r)))

    # the forward as the z-search scorer: N candidates share C and the
    # observations (batch stride 0); one launch against N single launches
    case = ordinal_cases()["a_log4_sigma5"]
    table, sigma, offset = case[:3]
    S, C, bounds, codes, _ = ordinal_inputs(gen, case, RANK, True)
    cand = 0.05 * torch.rand(SCORER_N, RANK, GRID * GRID, generator=gen,
                             device=DEVICE)
    by_encoding = []
    for obs, bb in ((bounds, None), ((codes,), table)):
        scores = q.score_quantized_nll(cand, C, obs, sigma, offset, bb)
        by_encoding.append(scores)
        torch.cuda.synchronize()
        one = torch.cat([q.score_quantized_nll(c[None], C, obs, sigma, offset,
                                               bb) for c in cand])
        plain = q.score_quantized_nll(cand, C, obs, sigma, offset, bb,
                                      mode="plain")
        rel = ((scores - plain).abs() / plain.abs()).max().item()
        print(f"parity scorer N={SCORER_N} {'codes' if bb else 'bounds'}: "
              f"rel {rel:.2e} of plain, equal to single launches "
              f"{torch.equal(scores, one)}", flush=True)
        if not (rel <= VALUE_RTOL and torch.equal(scores, one)):
            fail("the scorer disagrees with plain or with single launches")
        kname = "quantized_nll_coded_fwd" if bb else "quantized_nll_fwd"
        errs[kname] = max(errs[kname], (scores - plain).abs().max().item())
    same = torch.equal(*by_encoding)
    print(f"parity scorer N={SCORER_N}: codes == bounds bitwise {same}",
          flush=True)
    if not same:
        fail("the scorer gives other bits on codes than on bounds")
    return errs


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
    return launches, (S_flat, C, codes, g), T_obs


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _leaves(tree, prefix=()):
    for name, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), node


def checkpoints():
    """The four trained trees through the port's reader, each held against
    its _METADATA (the same paths, each array of its write shape, a
    scalar's ()) and against the JAX loader's per-leaf digests."""
    from quantized_spectrum_cartography_tpu_torch.training import (
        load_checkpoint)
    from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
        DIGESTS, leaf_digests)

    digests = json.loads(DIGESTS.read_text())
    trees = {}
    for name, path in CHECKPOINTS.items():
        t = time.perf_counter()
        tree = load_checkpoint(ROOT / path)
        secs = time.perf_counter() - t
        with open(ROOT / path / "_METADATA") as f:
            meta = json.load(f)["tree_metadata"]
        want = {tuple(k["key"] for k in e["key_metadata"]):
                tuple(e["value_metadata"].get("write_shape") or ())
                for e in meta.values()}
        got = {p: a.shape for p, a in _leaves(tree)}
        nbytes = sum(a.nbytes for _, a in _leaves(tree))
        print(f"checkpoints {path}: {len(got)} leaves, {nbytes} bytes in "
              f"{secs:.4f} s", flush=True)
        if got != want:
            fail(f"{path}: paths or shapes differ from _METADATA: "
                 f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
        got = leaf_digests(tree)
        wrong = sorted(k for k in got.keys() | digests[path].keys()
                       if got.get(k) != digests[path].get(k))
        if wrong:
            fail(f"{path}: leaves differ from the JAX loader's digests: "
                 f"{wrong[:4]}")
        trees[name] = tree
    priors_on_card(trees)
    return trees


def priors_on_card(trees):
    """The trained priors on the card against the same modules on the CPU
    (held against flax by the CPU tests), on 8 seeded latents."""
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        load_vae_prior, make_generator_apply)
    from quantized_spectrum_cartography_tpu_torch.training import (
        load_generator)

    def gan(device):
        return make_generator_apply(*load_generator(trees["gan256"], 256,
                                                    device)), 256

    def vae(name):
        return lambda device: load_vae_prior(ROOT / CHECKPOINTS[name],
                                             device)[:2]

    for name, build in (("gan256", gan), ("vae_best", vae("vae_best")),
                        ("vae_peak_z256", vae("vae_peak_z256"))):
        (card_fn, z_dim), (cpu_fn, _) = build(DEVICE), build("cpu")
        Z = torch.randn(8, z_dim, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            got, want = card_fn(Z.to(DEVICE)).cpu(), cpu_fn(Z)
        err = ((got - want).abs() - PRIOR_RTOL * want.abs()).max().item()
        print(f"checkpoints {name} on the card vs the CPU: max abs diff "
              f"{(got - want).abs().max().item():.3g}", flush=True)
        if not (got.shape == want.shape and err <= PRIOR_ATOL):
            fail(f"{name}: the card's prior differs from the CPU's")


def main_gan(card, trees):
    """MLE-GAN at full width through the ordinal kernels, both encodings,
    under the trained Generator256."""
    from quantized_spectrum_cartography_tpu_torch.config import (
        QuantizerConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize_log)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        sample_entry_mask)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        make_generator_apply, recover_mle_gan)
    from quantized_spectrum_cartography_tpu_torch.training import (
        load_generator)

    gen_apply = make_generator_apply(*load_generator(trees["gan256"], 256,
                                                     DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    with torch.no_grad():
        S_true = gen_apply(torch.randn(RANK, 256, generator=gen,
                                       device=DEVICE))
    C_true = torch.randn(RANK, BANDS, generator=gen, device=DEVICE).abs()
    T = get_tensor(S_true, C_true)
    qcfg = QuantizerConfig(boundaries=bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
                           noise_std=5.0, log_offset=bnd.LOG_OFFSET_4)
    Y = quantize_log(T, qcfg.noise_std, qcfg.boundaries, qcfg.log_offset, gen)
    mask = sample_entry_mask(gen, tuple(Y.shape), MASK_FRACTION,
                             device=DEVICE)
    scfg = SolverConfig()

    def solve(cfg, **kw):
        return timed(lambda: recover_mle_gan(
            Y, mask, gen_apply, cfg, qcfg, num_emitters=RANK, T_true=T,
            generator=torch.Generator(device=DEVICE).manual_seed(3), **kw))

    steps = scfg.max_iters * (scfg.c_inner_iters + scfg.s_inner_iters)
    # the scorer: one forward launch per search phase (global, local)
    expect = {"fwd": steps + 2, "bwd": steps}
    launches, results = {}, {}
    for enc, fwd, bwd in (("bounds", "quantized_nll_fwd", "quantized_nll_bwd"),
                          ("codes", "quantized_nll_coded_fwd",
                           "quantized_nll_coded_bwd")):
        q.reset_launches()
        res, secs = solve(scfg, obs_encoding=enc)
        got = {name: getattr(q, name + "_cuda").launches for name in ORDINAL}
        want = {name: 0 for name in ORDINAL}
        want.update({fwd: expect["fwd"], bwd: expect["bwd"]})
        costs = res.costs
        print(f"main_gan {enc}: launches {got}; costs {costs[0].item():.2f} "
              f"-> {costs[-1].item():.2f}, NMSE {res.nmses[0].item():.4f} -> "
              f"{res.nmses[-1].item():.4f}, best {res.nmses.min().item():.4f};"
              f" {secs:.3f} s per map on {card}", flush=True)
        if got != want:
            fail(f"MLE-GAN {enc}: launches {got}, the loop implies {want}")
        if not (costs.shape == (scfg.max_iters,)
                and torch.isfinite(costs).all()
                and costs[-1] < costs[0] and (res.C >= 0).all()):
            fail(f"MLE-GAN {enc}: costs not finite and falling, or C < 0")
        launches.update({fwd: got[fwd], bwd: got[bwd]})
        results[enc] = res
    c_b, c_c = results["bounds"].costs[-1], results["codes"].costs[-1]
    enc_rel = ((c_b - c_c).abs() / c_c.abs()).item()
    print(f"main_gan: bounds vs codes final cost rel {enc_rel:.2e}",
          flush=True)
    if not enc_rel <= COST_RTOL:
        fail(f"the two encodings disagree on final cost: {enc_rel}")

    flat = dataclasses.replace(scfg, z_search_global=0, z_search_local=0)
    kern, kern_s = solve(flat)
    plain, plain_s = solve(flat, nll_mode="plain")
    rel = ((kern.costs[-1] - plain.costs[-1]).abs()
           / plain.costs[-1].abs()).item()
    print(f"main_gan no search: kernels {kern_s:.3f} s, plain {plain_s:.3f} s"
          f" per map; final cost rel {rel:.2e}", flush=True)
    if not rel <= COST_RTOL:
        fail(f"MLE-GAN kernel and plain solves disagree: {rel}")

    res = results["bounds"]
    S_flat = res.S.reshape(1, RANK, -1).contiguous()
    C = res.C.T.contiguous()[None]
    obs = (tuple(x[None].contiguous()
                 for x in q.pack_bounds(Y, qcfg.boundaries, mask)),
           q.pack_codes(Y, qcfg.num_bins, mask)[None])
    inputs = (S_flat, C, obs, qcfg.boundaries, qcfg.noise_std,
              qcfg.log_offset, False, q._fast_ok(qcfg.noise_std))
    return launches, inputs


def run_cli(argv):
    """cli.main(argv) in this process; (its last printed line, seconds)."""
    from quantized_spectrum_cartography_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, secs = timed(lambda: cli.main(argv))
    print(out.getvalue(), end="", flush=True)
    return out.getvalue().strip().splitlines()[-1], secs


def main_vae(card):
    """`recover --solver mle-gan` at the CLI's defaults (the trained VAE
    prior) through the bounds pair, against the plain likelihood on the
    same inputs; then `recover --solver dowjons` at its defaults."""
    import numpy as np

    from quantized_spectrum_cartography_tpu_torch import cli
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    argv = ["recover", "--solver", "mle-gan"]
    q.reset_launches()
    line, secs = run_cli(argv)
    got = {name: getattr(q, name + "_cuda").launches for name in ORDINAL}
    want = dict.fromkeys(ORDINAL, 0)
    want.update({"quantized_nll_fwd": 2 * CLI_ITERS + 2,
                 "quantized_nll_bwd": 2 * CLI_ITERS})
    printed = json.loads(line)
    print(f"main_vae cli: launches {got}; {secs:.3f} s per map on {card}",
          flush=True)
    if got != want:
        fail(f"recover --solver mle-gan: launches {got}, expected {want}")
    if not (printed["iters"] == CLI_ITERS
            and np.isfinite(printed["final_cost"])
            and np.isfinite(printed["final_nmse"])):
        fail(f"recover --solver mle-gan printed {printed}")

    rec = cli.recovery(argv)
    kern, kern_s = timed(rec.run)
    plain, plain_s = timed(lambda: rec.run(nll_mode="plain"))
    c, c0 = kern.costs[-1], plain.costs[-1]
    rel = ((c - c0).abs() / c0.abs()).item()
    dz = (kern.aux["Z"] - plain.aux["Z"]).abs().max().item()
    print(f"main_vae recover_mle_gan: kernels {kern_s:.3f} s, plain "
          f"{plain_s:.3f} s per map on {card}; costs "
          f"{kern.costs[0].item():.2f} -> {c.item():.2f}, final NMSE "
          f"{kern.nmses[-1].item():.4f}; final cost vs plain rel {rel:.2e}, "
          f"final Z max abs diff {dz:.3g}, C equal "
          f"{torch.equal(kern.C, plain.C)}, vs the CLI's "
          f"{abs(c.item() - printed['final_cost']):.3g}", flush=True)
    if not (torch.isfinite(kern.costs).all() and rel <= COST_RTOL):
        fail(f"VAE-prior MLE-GAN: kernel and plain solves disagree: {rel}")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = str(OUT_DIR / "dowjons.npz")
    line, secs = run_cli(["recover", "--solver", "dowjons", "--out", out])
    res = np.load(out)
    costs = res["costs"]
    print(f"main_vae dowjons: costs {costs[0]:.2f} -> {costs[-1]:.2f}, final "
          f"NMSE {res['nmses'][-1]:.4f}; {secs:.3f} s per map on {card}",
          flush=True)
    if not (costs.shape == (CLI_ITERS,) and np.isfinite(costs).all()
            and costs[-1] < costs[0] and (res["C"] >= 0).all()):
        fail("recover --solver dowjons: costs not finite and falling, "
             "or C < 0")
    return {k: v for k, v in got.items() if v}


def jax_sre_limits():
    """{method: (JAX's 256-example mean, the gate mean + 4 sd / sqrt(32))}
    from the committed PUBLISHED_SRE.json (BTD on its SRE < 3 entries)."""
    import numpy as np

    table = json.loads((ROOT / "PUBLISHED_SRE.json").read_text())["methods"]
    out = {}
    for name in HARNESS_METHODS:
        s = np.asarray(table[name]["sre_sorted"])
        s = s[s < 3.0] if name == "btd" else s
        out[name] = (s.mean(), s.mean() + 4 * s.std(ddof=1)
                     / HARNESS_EXAMPLES ** 0.5)
    return out


def harness_methods(device):
    """The published five on `device`; btd and dowjons draw their random
    starts here, from the method's generator, and pass them as `draws`, so
    that the CPU can rerun an example from the card's starts."""
    import inspect

    from quantized_spectrum_cartography_tpu_torch.baselines import (
        load_pretrained_methods, standard_methods)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        load_vae_prior)

    defaults = {k: v.default for k, v in
                inspect.signature(standard_methods).parameters.items()}
    z_dim = load_vae_prior(ROOT / CHECKPOINTS["vae_peak_z256"], "cpu")[1]
    methods = load_pretrained_methods(only=HARNESS_METHODS, device=device)

    def shapes_btd(hp):
        B, K, I, J = hp.T_obs.shape
        head = (B, defaults["btd_restarts"], hp.S_true.shape[1])
        return [(*head, I, 5), (*head, J, 5), (*head, K)]

    def shapes_dowjons(hp):
        B, R = hp.S_true.shape[:2]
        return [(B, R, z_dim), (B, defaults["dowjons_restarts"], R, z_dim)]

    draws = {}

    def drawing(name, fn, shapes):
        def run(generator, hp, starts=None):
            if starts is None:
                starts = [torch.randn(*sh, generator=generator,
                                      device=hp.T_obs.device)
                          for sh in shapes(hp)]
                draws[name] = starts
            return fn(generator, hp, draws=starts)
        return run

    methods["btd"] = drawing("btd", methods["btd"], shapes_btd)
    methods["dowjons"] = drawing("dowjons", methods["dowjons"],
                                 shapes_dowjons)
    return methods, draws


def harness(card):
    """The published-SRE methods through BatchedHarness on the card, held
    to the JAX package's 256-example table, then two examples on the CPU."""
    import numpy as np

    from quantized_spectrum_cartography_tpu_torch.baselines import harness as h
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k, quantized_nll as q)

    limits = jax_sre_limits()
    methods, draws = harness_methods(DEVICE)
    T_hats = {}

    def recording(name, fn):
        def run(generator, hp):
            out = fn(generator, hp)
            T_hats[name] = out["T_hat"]
            return out
        return run

    runner = h.BatchedHarness({n: recording(n, f) for n, f in methods.items()},
                              device=DEVICE)
    cond = h.Condition()
    k.reset_launches()
    q.reset_launches()
    (label, stats), = runner.run((cond,), HARNESS_EXAMPLES, seed=0).items()
    launched = {name: getattr(mod, name + "_cuda").launches
                for mod, names in ((k, ("onebit_nll_fwd", "onebit_nll_bwd")),
                                   (q, ORDINAL)) for name in names}
    missing = [n for n in HARNESS_METHODS if n not in stats]
    if missing:
        fail(f"harness: methods missing: {missing}")
    over = []
    for name in HARNESS_METHODS:
        st, (jax_mean, limit) = stats[name], limits[name]
        s = np.asarray(st["sre_all"])
        valid = s[s < 3.0] if name == "btd" else s
        finite = bool(torch.isfinite(T_hats[name]).all())
        print(f"harness {name}: {runner.seconds[label][name]:.3f} s for "
              f"{HARNESS_EXAMPLES} examples on {card}; SRE mean "
              f"{st['sre']:.4f} median {np.median(valid):.4f} valid "
              f"{st['valid']}/{HARNESS_EXAMPLES} (JAX 256-example mean "
              f"{jax_mean:.4f}, limit {limit:.4f}); miss {st['miss_prob']:.4f}"
              f", false alarm {st['false_prob']:.4f}; T_hat finite {finite}",
              flush=True)
        if not finite:
            fail(f"harness {name}: non-finite T_hat")
        if not st["sre"] <= limit:
            over.append(name)
    print(f"harness: likelihood kernel launches {launched}", flush=True)
    if over:
        fail(f"harness: mean SRE above the JAX limit for {over}")
    if any(launched.values()):
        fail("harness: the evaluation launched a likelihood kernel")

    # examples 0 and 1 again, on the CPU, from the card's random starts
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    hp = h.make_problem(gen, cond, batch=HARNESS_EXAMPLES, device=DEVICE)
    n = HARNESS_CPU_EXAMPLES
    hp_n = dataclasses.replace(hp, **{
        f.name: getattr(hp, f.name)[:n]
        for f in dataclasses.fields(hp) if f.name != "fraction"})
    hp_cpu = dataclasses.replace(hp_n, **{
        f.name: getattr(hp_n, f.name).cpu()
        for f in dataclasses.fields(hp) if f.name != "fraction"})
    cpu_methods, _ = harness_methods("cpu")
    cpu_T, differ = {}, []                    # (method, example, rel)
    for name in HARNESS_METHODS:
        mhp = (hp_cpu if name in h.SAMPLE_IDX_METHODS
               else dataclasses.replace(hp_cpu, sample_idx=None))
        kw = ({"starts": [d[:n].cpu() for d in draws[name]]}
              if name in draws else {})
        with torch.no_grad():
            cpu_T[name] = cpu_methods[name](None, mhp, **kw)["T_hat"]
        card_T = T_hats[name][:n].cpu()
        rel = ((card_T - cpu_T[name]).flatten(1).norm(dim=1)
               / cpu_T[name].flatten(1).norm(dim=1)).tolist()
        sre = [((x - hp_cpu.T_true).square().sum((1, 2, 3))
                / hp_cpu.T_true.square().sum((1, 2, 3))).tolist()
               for x in (card_T, cpu_T[name])]
        print(f"harness {name} card vs CPU, examples 0-{n - 1}: relative "
              f"Frobenius {', '.join(f'{r:.2e}' for r in rel)}; SRE card "
              f"{', '.join(f'{x:.4f}' for x in sre[0])}, CPU "
              f"{', '.join(f'{x:.4f}' for x in sre[1])}", flush=True)
        for b in range(n):
            if name in HARNESS_EXACT and not rel[b] <= HARNESS_CPU_RTOL:
                differ.append((name, b, rel[b]))
    if any(name == "nasdac" for name, _, _ in differ):
        # Nasdac's SPA picks among bands whose normalized columns tie up to
        # rounding (sinc PSDs vanish outside their support, so whole bands
        # are pure): the card and the CPU may pick differently, and so may
        # the swap flag that follows.  Such an example is printed, not
        # failed; one with every choice the same must agree.
        choices = [nasdac_choices(hp_n, DEVICE), nasdac_choices(hp_cpu, "cpu")]
        for name, b, r in [d for d in differ if d[0] == "nasdac"]:
            diff = {k: (choices[0][k][b], choices[1][k][b])
                    for k in choices[0] if choices[0][k][b] != choices[1][k][b]}
            print(f"harness nasdac example {b} differs by {r:.2e}; discrete "
                  f"choices that differ (card, CPU): {diff or 'none'}",
                  flush=True)
            if diff:
                differ.remove((name, b, r))
    if differ:
        fail(f"harness: the card's T_hat differs from the CPU's by more "
             f"than {HARNESS_CPU_RTOL}: {differ}")


def nasdac_choices(hp, device):
    """Nasdac's discrete choices on examples hp (on `device`), as the
    registry's nasdac makes them: SPA's columns of the sampled unfolding,
    the witness peaks of the per-band completion and the swap flag
    between the plain and the anchored solve."""
    import inspect

    from quantized_spectrum_cartography_tpu_torch.baselines import (
        standard_methods)
    from quantized_spectrum_cartography_tpu_torch.baselines.spa import (
        column_sum_normalize, spa_indices)
    from quantized_spectrum_cartography_tpu_torch.solvers.nasdac import (
        recover_nasdac, witness_peaks, witnessed_swap_flag)
    from quantized_spectrum_cartography_tpu_torch.training.ae_trainer import (
        load_ae, make_ae_completer)

    d = {k: v.default for k, v in
         inspect.signature(standard_methods).parameters.items()}
    ae = make_ae_completer(*load_ae(ROOT / CHECKPOINTS["ae_completion"],
                                    "selu", device))
    R, W, T_obs = hp.S_true.shape[1], hp.Om.to(torch.float32), hp.T_obs
    with torch.no_grad():
        Tn, _ = column_sum_normalize(T_obs.flatten(-2).transpose(-1, -2))
        T_comp = ae(W[:, None], T_obs)
        plain = recover_nasdac(T_obs, hp.Om, ae, R, anchor_mu0=0.0)
        anch = recover_nasdac(
            T_obs, hp.Om, ae, R, anchor_mu0=d["anchor_mu0"], anchor_rho0=1.0,
            polish_ridge=d["polish_ridge"], polish_gamma=d["polish_gamma"],
            polish_peaks_extra=d["polish_peaks_extra"], T_comp=T_comp)
        flag = witnessed_swap_flag(plain.T_hat, anch.T_hat, T_comp, T_obs, W,
                                   R + 2)
    return {"SPA columns": spa_indices(Tn, R).tolist(),
            "witness peaks": witness_peaks(T_comp, R + 2).tolist(),
            "swap flag": flag.tolist()}


def main_lowrank_ordinal(T_obs):
    """recover_lowrank_mle at B=256 on the ordinal encodings (depth cut)."""
    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
        pack_codes_1bit)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_lowrank_mle)

    scfg = SolverConfig(max_iters=LOWRANK_ORDINAL_OUTER, s_inner_iters=INNER,
                        c_inner_iters=INNER, lr_s=0.001, lr_c=0.001,
                        projection_interval=5, rank_truncation=10)
    S0 = torch.zeros(BATCH, RANK, GRID, GRID, device=DEVICE)
    C0 = torch.full((BATCH, RANK, BANDS), 0.01, device=DEVICE)
    launches, res = {}, None
    for enc in ("codes", "bounds"):
        q.reset_launches()
        res, secs = timed(lambda: recover_lowrank_mle(
            T_obs, S0, C0, scfg, MEAN, STD, obs_encoding=enc))
        got = {name: getattr(q, name + "_cuda").launches for name in ORDINAL}
        plain, plain_s = timed(lambda: recover_lowrank_mle(
            T_obs, S0, C0, scfg, MEAN, STD, obs_encoding=enc,
            nll_mode="plain"))
        c, c0 = res.costs[:, -1], plain.costs[:, -1]
        rel = ((c - c0).abs() / c0.abs()).max().item()
        print(f"main_lowrank_ordinal {enc}: launches {got}, {secs:.3f} s "
              f"(plain {plain_s:.3f} s) for {BATCH} maps, final costs vs "
              f"plain rel {rel:.2e}", flush=True)
        if not (torch.isfinite(res.costs).all() and rel <= COST_RTOL):
            fail(f"low-rank {enc}: non-finite costs or kernel/plain "
                 f"disagree: {rel}")
        launches.update({k: v for k, v in got.items() if v})
    if sorted(launches) != sorted(ORDINAL):
        fail(f"the low-rank encodings did not launch every kernel: {launches}")
    W, U = q.pack_bounds_1bit(T_obs, MEAN)
    inputs = (res.S.reshape(BATCH, RANK, -1).contiguous(),
              res.C.transpose(1, 2).contiguous(), ((W, U),
                                                   pack_codes_1bit(T_obs)),
              q.onebit_bounds(MEAN), STD, 0.0, True, q._fast_ok(STD))
    return launches, inputs


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


def graph_ms(fn):
    """Device ms per call: TIMING_REPS calls of `fn` captured in one CUDA
    graph, its replays timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMING_REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * TIMING_REPS)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def in_turns(pairs):
    """{name: (kernel ms, plain ms, kernel graph ms)}: back-to-back calls
    timed plain, kernel, kernel, plain, then the kernel in a CUDA graph."""
    ms = {}
    for name, (kern, plain) in pairs.items():
        p1, k1, k2, p2 = (event_ms(plain), event_ms(kern), event_ms(kern),
                          event_ms(plain))
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2, graph_ms(kern))
    return ms


def timing_onebit(inputs):
    """The 1-bit pair at the bench shapes; bounds from the bytes each pass
    must move and its f32 operations (the TPU kernels' own cost estimates:
    2KRP + 15KP flops and 2KP transcendentals forward, 6KRP + 20KP and 3KP
    backward, per map)."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import onebit_nll as k

    S, C, codes, g = inputs
    B, R, P = S.shape
    K = C.shape[1]
    ms = in_turns({
        "onebit_nll_fwd": (
            lambda: k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD),
            lambda: k.onebit_nll_plain(S, C, codes, MEAN, STD)),
        "onebit_nll_bwd": (
            lambda: k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD),
            lambda: k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)),
    })
    in_bytes = codes.numel() + 4 * (S.numel() + C.numel())
    bounds = {
        "onebit_nll_fwd": bound(in_bytes + 4 * B,
                                B * (2 * K * R * P + 17 * K * P)),
        "onebit_nll_bwd": bound(in_bytes + 4 * B + 4 * (S.numel() + C.numel()),
                                B * (6 * K * R * P + 23 * K * P)),
    }
    return ms, bounds


def timing_ordinal(inputs, label):
    """The four ordinal kernels on one solve's final factors.  Bounds: each
    input read once and each output written once ((W, U) 8 B per entry,
    codes 1 B), and the f32 operations of the entries this run observes
    (the kernels skip masked ones), per the TPU kernels' cost estimates:
    2R + 25 flops and 4 transcendentals forward, 6R + 30 and 5 backward."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    S, C, (bounds_obs, codes), table, sigma, offset, linear, fast = inputs
    W, U = bounds_obs
    st = (sigma, offset, linear, fast)
    B, R, P = S.shape
    K = C.shape[1]
    g = torch.full((B,), 1.0, device=DEVICE)
    ms = in_turns({
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
    })
    observed = int((codes < len(table) - 1).sum().item())
    factors = 4 * (S.numel() + C.numel())
    ops_f = observed * (2 * R + 25 + 4)
    ops_b = observed * (6 * R + 30 + 5)
    bounds = {
        "quantized_nll_fwd": bound(factors + 8 * W.numel() + 4 * B, ops_f),
        "quantized_nll_bwd": bound(2 * factors + 8 * W.numel() + 4 * B,
                                   ops_b),
        "quantized_nll_coded_fwd": bound(factors + codes.numel() + 4 * B,
                                         ops_f),
        "quantized_nll_coded_bwd": bound(2 * factors + codes.numel() + 4 * B,
                                         ops_b),
    }
    print(f"timing {label}: B={B}, K={K}, P={P}, R={R}, {observed} of "
          f"{codes.numel()} entries observed", flush=True)
    return ms, bounds


def timing(inputs_1bit, inputs_gan, inputs_lowrank):
    ms, bounds = timing_onebit(inputs_1bit)
    ms_gan, bounds_gan = timing_ordinal(inputs_gan, "MLE-GAN shape")
    ms_lr, bounds_lr = timing_ordinal(inputs_lowrank, "low-rank shape")
    ms.update(ms_gan)
    bounds.update(bounds_gan)
    for name in KERNELS:
        print(f"timing {name}: kernel {ms[name][0]:.4f} ms, graph "
              f"{ms[name][2]:.4f} ms, plain {ms[name][1]:.4f} ms, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})", flush=True)
    for name in ORDINAL:
        print(f"timing {name} at B={BATCH}: kernel {ms_lr[name][0]:.4f} ms, "
              f"graph {ms_lr[name][2]:.4f} ms, plain {ms_lr[name][1]:.4f} ms, "
              f"bound "
              f"{bounds_lr[name][0]:.4f} ms ({bounds_lr[name][1]})",
              flush=True)
    return ms, bounds, ms_lr, bounds_lr


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    smi = phase("device", device_info)
    card = torch.cuda.get_device_name(0)
    phase("build", build)
    errs = phase("parity", parity)
    errs.update(phase("parity_ordinal", parity_ordinal))
    launches, inputs_1bit, T_obs = phase("main", lambda: main_path(card))
    trees = phase("checkpoints", checkpoints)
    launches_gan, inputs_gan = phase("main_gan",
                                     lambda: main_gan(card, trees))
    launches.update(launches_gan)
    launches_vae = phase("main_vae", lambda: main_vae(card))
    phase("harness", lambda: harness(card))
    launches_lr, inputs_lr = phase("main_lowrank_ordinal",
                                   lambda: main_lowrank_ordinal(T_obs))
    ms, bounds, ms_lr, bounds_lr = phase(
        "timing", lambda: timing(inputs_1bit, inputs_gan, inputs_lr))

    kernels = []
    for name, (source, line) in KERNELS.items():
        rec = {
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": f"{TPU_KERNELS}:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms[name][0], "graph_ms": ms[name][2],
            "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
            "main_vae_launches": launches_vae.get(name, 0),
        }
        if name in ORDINAL:
            rec["lowrank_b256"] = {
                "launches": launches_lr[name], "ms": ms_lr[name][0],
                "graph_ms": ms_lr[name][2], "plain_ms": ms_lr[name][1],
                "bound_ms": bounds_lr[name][0],
                "bound_by": bounds_lr[name][1]}
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
