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
  6. serve  - the port's RecoveryScheduler (parallel/scheduler.py) over
               the batched 1-bit solver at serving_bench.py's configuration
               (51x51x64, R=2, batch 64, 50 outer x (5 S + 5 C) Adam steps,
               S0 = 0, C0 = 0.01, observations bit-packed on the wire, S, C
               and the final cost sent back): first the packed requests
               through the native C++ queue (runtime/, built with g++ at
               first use) byte for byte, a check of the ported queue apart
               from the served path (the scheduler takes requests through
               Python's queue, as the JAX package's does); 256 requests in
               a closed loop, then 70 more (a padded last batch); the 1-bit
               pair must launch 500 / 500 times a dispatched batch and no
               other kernel, every request's S, C and cost must equal a
               direct solve of the batch it rode in (pad slots included)
               bit for bit, costs be finite and the mean NMSE < 1; the
               direct solves, back to back, give the raw bound; the first
               batch of 64 distinct requests solved again with
               nll_mode="plain" (final costs, rtol 1e-3) and the 1-bit pair
               at B=64 on its final factors against its plain version
               (parity's tolerances); then an
               open loop of 128 Poisson arrivals at 0.9 of the raw bound:
               raw and closed-loop maps/s and the open loop's
               p50/p95/p99/max latency
  7. distributed - a world-size-1 nccl process group on the card: the
               K-sharded ordinal solve (parallel/sharded_solver.py; 51x51,
               K=64, R=2, B=2, 4-bin log quantizer at sigma 5, 50 Adam
               steps) against the same solve without a group (costs rtol
               2e-4, factors rtol 1e-3 / atol 1e-6, JAX's tolerances),
               falling, and no kernel launched (plain likelihood, as in
               JAX); at world size 1 its all-reduces see one rank, so this
               checks that the path runs under nccl, not the collective's
               arithmetic (the CPU tests split K over two gloo ranks);
               multihost_recover_lowrank in this process on the regenerate
               path (4 maps x 10 outer x (2 S + 2 C) steps): the 1-bit pair
               must launch 40 / 40 times and the same rows solved with
               nll_mode="plain" reach the same final costs (rtol 1e-3);
               then multihost_launch.py in a fresh process
               on the --shard-dir path (a prep process writes the shard,
               the worker reads it through the native loader): its final
               costs must equal this process's bit for bit
  8. checkpoints - the trained priors read from checkpoints/ by the port's
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
  9. main_gan - MLE-GAN at full width: the trained Generator256
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
  10. main_vae - `recover --solver mle-gan` at the CLI's defaults, in this
               process: the trained VAE prior (checkpoints/vae_best/final),
               a simulated 51x51x64 map, R=2, 10% observed, the 4-bin log
               quantizer at sigma 5, 100 iterations; the bounds pair must
               launch 2*100+2 / 2*100 times and no other ordinal kernel, the
               printed cost and NMSE be finite; then the same inputs through
               recover_mle_gan with the kernels and with nll_mode="plain"
               (final costs, rtol 1e-3; the final Z's difference printed);
               then `recover --solver dowjons` at its defaults: finite,
               falling costs and C >= 0
  11. harness - the five published methods (tps, btd, deepcomp, nasdac,
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
  12. main_lowrank_ordinal - recover_lowrank_mle at B=256 on obs_encoding
               "codes" and "bounds", cut from 50 to 10 outer iterations to
               keep the plain solves short, each against nll_mode="plain"
               (final costs, rtol 1e-3)
  13. fixture - a .mat in the reference's MATLAB layouts (T, T_true,
               S_true (I,J,R), C_true (K,R), Om) written with scipy from one
               simulated 51x51x64, R=2 problem under build/chip_smoke/, read
               back by data.load_onebit_fixture bit for bit; then `recover
               --fixture` in this process at the CLI's defaults: --solver
               lowrank must launch the 1-bit pair 100 x (5 + 5) = 1000 /
               1000 times and no other kernel, --solver mle-gan the bounds
               pair 2*100+2 / 2*100; each final cost within rtol 1e-3 of
               the same recovery with nll_mode="plain", each --out npz
               holding the arrays `cli report` reads
  14. dip    - the deep-image prior: DecoderDip (z 256, train mode, 3 z's)
               on the card against the same weights on the CPU, outputs
               and moved running statistics within 1e-4 + 1e-5;
               recover_dip_tensor, three steps on the card and on the CPU
               from the same z's, weights, C0 and validation mask, at the
               train phase's tolerances (losses; weights and C in units of
               lr; running statistics); then one run at DIP_QUALITY.json's
               configuration (1000 steps, lr 1e-3, z 256, holdout 0.05,
               l2_c 0.03, validation EMA 0.9, output EMA 0.995) on a
               simulated problem with the fixture-parity dither (mean
               0.0005, std 0.008): the NMSE of T_ema and of the returned
               factors, the low-rank solver's on the same observations
               (50 x (10 + 10) steps, rank-10 SVD projection), the seconds;
               finite, and T_ema's NMSE < 1
  15. protocols - the evaluation's two protocols at a few examples: one
               R-axis condition (R=5, 8 examples) through the six-method
               and the plain registries (conditions_grid.py): the stack
               deltas and the R-axis verdict printed (not gated at 8
               examples), finite SREs and the pooled document's layout;
               the miss protocol (missprob.py) at rho 1% and 10% on 8
               examples: events, miss rates and the false-alarm guard
               printed, finite SREs; two 4-example draws pooled
               (missprob_pool_seeds.summed_events): the summed event counts
               reproduced exactly.  None of the six kernels runs here
  16. train  - prior training at the JAX configurations' full widths (GAN:
               Generator256, z 256, against the SN discriminator; AE: the
               selu Autoencoder; VAE: latent 64, decoder width 16; AAE:
               z 64; batch 64 each):
               (a) for each kind, three steps on the card and three on the
                   CPU from the same initial weights on the same draws:
                   losses, weights, BatchNorm statistics and spectral
                   vectors at the CPU tests' tolerances
                   (tests/test_torch_train_support.py);
               (b) `cli train-prior --kind K` in a fresh process, cut from
                   the CLI's 20000 steps to TRAIN_STEPS (nothing else cut):
                   exit 0, finite logged losses, the AE's MSE and the VAE's
                   reconstruction term falling (the mean of the last three
                   logs below the first three); seconds, and the steady
                   steps/s between the first and the last log;
               (c) `recover --solver mle-gan` on the GAN and the VAE
                   checkpoints (b) wrote: finite cost and NMSE, the bounds
                   pair launched 2*100+2 / 2*100 times;
               (d) `recover --solver mle-gan` at the CLI's defaults in a
                   fresh process, its final cost within rtol 1e-3 of
                   main_vae's in-process run: the CLI sets the card's
                   numerics itself
  17. timing - every kernel's and its plain version's ms (CUDA events over
               back-to-back calls, in turns plain, kernel, kernel, plain),
               the kernel's device time (graph_ms: TIMING_REPS calls captured
               in one CUDA graph, its replays timed with CUDA events, so the
               host's cost per call drops out) and its bound: the 1-bit pair
               at the bench shapes, the ordinal kernels at the MLE-GAN shape
               (B=1) and at the low-rank shape (B=256)

cuDNN runs without TF32 and with deterministic algorithms
(config.set_card_numerics, which the CLI sets too), so the solve
comparisons measure the likelihood kernels, not convolution atomics.
The line before the last two is the kernels' JSON record (each kernel's
launches on the main path, under the scheduler in `serve_launches`, and on
the fixture path in `fixture_launches`);
then nvidia-smi's
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
TRAIN_KINDS = ("gan", "ae", "vae", "aae")
CLI = (sys.executable, "-m", "quantized_spectrum_cartography_tpu_torch.cli")
TRAIN_STEPS, TRAIN_LOG_EVERY, TRAIN_PARITY_STEPS = 300, 30, 3
# serving: the scheduler's static batch, the closed-loop requests, the
# requests after them (a padded last batch), the open loop's requests and
# its offered load as a fraction of the raw bound
SERVE_BATCH, SERVE_CLOSED, SERVE_EXTRA, SERVE_OPEN = 64, 256, 70, 128
OPEN_FRAC = 0.9
# distribution: the K-sharded solve (maps, Adam steps; JAX's tolerances:
# costs rtol, factors rtol and atol), the multi-process launch (maps, outer
# iterations)
KSHARD_BATCH, KSHARD_ITERS = 2, 50
KSHARD_COST_RTOL, KSHARD_RTOL, KSHARD_ATOL = 2e-4, 1e-3, 1e-6
LAUNCH_BATCH, LAUNCH_ITERS = 4, 10
# the CPU tests' tolerances (tests/test_torch_train_support.py): losses on
# the initial weights, later losses, weights in units of lr (every entry;
# the median and nine in ten), running statistics
FIRST_RTOL, LOSS_RTOL = 1e-5, 5e-3
W_ATOL_LR, W_MEDIAN_LR, W_P90_LR = 7.0, 0.1, 0.5
STATS_RTOL, STATS_ATOL = 5e-2, 5e-3
# the .mat fixture's problem, and what `cli report` reads of an --out npz
FIXTURE_SEED = 11
REPORT_KEYS = {"S", "C", "T_hat", "nmses", "costs", "T_true", "S_true",
               "C_true"}
# DIP: DIP_QUALITY.json's configuration on a simulated problem, with the
# fixture-parity dither (mean 0.0005, std 0.008); steps of the card-vs-CPU
# check
DIP_SEED, DIP_Z, DIP_STEPS, DIP_PARITY_STEPS = 12, 256, 1000, 3
DIP_MEAN, DIP_STD = 0.0005, 0.008
DIP = dict(lr=1e-3, holdout_frac=0.05, l2_c=0.03, val_ema_decay=0.9,
           out_ema_decay=0.995)
# the evaluation protocols at a few examples (one R-axis condition; the
# miss protocol at two rhos; two draws pooled)
PROTOCOL_EXAMPLES, POOL_EXAMPLES = 8, 4
PROTOCOL_RHOS = (0.01, 0.10)
POOLED_KEYS = {"sre", "sre_std", "sre_median", "nae_s", "nae_c", "miss_prob",
               "false_prob", "miss_count", "peak_count", "false_count",
               "low_count", "valid", "sre_all"}

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


def serve():
    """The port's RecoveryScheduler over the batched 1-bit solver at the
    serving configuration (serving_bench.py): the packed requests through
    the native queue, a closed loop and a padded last batch, each request
    bitwise against a direct solve of the batch it rode in, then an open
    loop.  Returns the kernels' launches under the scheduler and the 1-bit
    pair's max abs errors against its plain version at the serving
    shape."""
    import numpy as np

    from quantized_spectrum_cartography_tpu_torch import serving_bench as sb
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k, quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.parallel import (
        RecoveryScheduler)
    from quantized_spectrum_cartography_tpu_torch.runtime import (
        NativeBatchQueue)

    n = SERVE_CLOSED + SERVE_EXTRA
    T_true, packed = sb.make_requests(n, DEVICE)
    wire = NativeBatchQueue(capacity=n, item_bytes=packed[0].nbytes)
    pushed = all(wire.push(p, timeout_ms=1000) for p in packed)
    popped = np.concatenate([wire.pop_batch(SERVE_BATCH, timeout_ms=1000)
                             for _ in range(-(-n // SERVE_BATCH))])
    wire.close()
    same_bytes = pushed and np.array_equal(popped.reshape(packed.shape),
                                           packed)
    print(f"serve: {n} packed requests of {packed[0].nbytes} bytes through "
          f"the native queue byte for byte: {same_bytes}", flush=True)
    if not same_bytes:
        fail("the native queue did not give the requests back unchanged")

    solver = sb.make_solver(sb.serving_config(OUTER, INNER))
    batches = []          # (ids, observations) of every dispatched batch

    def recording(stacked):
        batches.append((stacked["id"], stacked["T_obs"]))
        return solver(stacked)

    payloads = [{"T_obs": packed[i], "id": np.int64(i)} for i in range(n)]
    k.reset_launches()
    q.reset_launches()
    sched = RecoveryScheduler(recording, batch_size=SERVE_BATCH,
                              max_wait_ms=20.0, pipeline_depth=3,
                              drain_threads=2, device=DEVICE)
    results, _, done, t0 = sb.run_stream(sched, payloads[:SERVE_CLOSED])
    closed = SERVE_CLOSED / (done.max() - t0)
    results += sb.run_stream(sched, payloads[SERVE_CLOSED:])[0]
    sched.shutdown()
    dispatch = sched.solve_seconds
    launches = {name: getattr(k if name.startswith("onebit") else q,
                              name + "_cuda").launches for name in KERNELS}
    per_solve = OUTER * 2 * INNER
    want = {name: (sched.batches_dispatched * per_solve
                   if name.startswith("onebit") else 0) for name in KERNELS}
    print(f"serve: {sched.batches_dispatched} batches, {sched.maps_completed}"
          f" maps; launches {launches}", flush=True)
    if launches != want or sched.maps_completed != n:
        fail(f"serving launched {launches}, expected {want} "
             f"({per_solve} a batch), or completed {sched.maps_completed} "
             f"of {n} maps")

    # the same stacked batches, solved directly back to back: the raw bound
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs, calls = [], []
    for _, obs in batches:
        t_call = time.perf_counter()
        outs.append(solver({"T_obs": obs}))
        calls.append(time.perf_counter() - t_call)
    direct = [{key: v.cpu().numpy() for key, v in o.items()} for o in outs]
    raw = len(batches) * SERVE_BATCH / (time.perf_counter() - t)
    equal, padded = True, 0
    for (ids, _), ref in zip(batches, direct):
        ids = ids.cpu().numpy()
        real = [0] + [j for j in range(1, SERVE_BATCH) if ids[j] != ids[0]]
        padded += len(real) < SERVE_BATCH
        equal = equal and all(
            np.array_equal(results[ids[j]][key], ref[key][j])
            for j in real for key in ("S", "C", "cost"))
    finite = all(np.isfinite(r["cost"]) for r in results)
    mean_nmse = sb.served_nmse(results, T_true)
    print(f"serve: every request bitwise equal to a direct solve of its "
          f"batch: {equal} ({padded} padded batches); costs finite "
          f"{finite}; mean NMSE {mean_nmse:.4f}", flush=True)
    if not (equal and padded and finite and mean_nmse < 1.0):
        fail("served results differ from direct solves, no batch was "
             "padded, or the quality gate failed")
    # a batch of SERVE_BATCH distinct requests (no pad slots) on the plain path
    full = [i for i, (ids, _) in enumerate(batches)
            if len(set(ids.cpu().tolist())) == SERVE_BATCH]
    if not full:
        fail("no dispatched batch held SERVE_BATCH distinct requests")
    errs = serve_plain(batches[full[0]][1], outs[full[0]])

    gaps = np.random.default_rng(7).exponential(
        1.0 / (OPEN_FRAC * raw), size=SERVE_OPEN)
    sched = RecoveryScheduler(solver, batch_size=SERVE_BATCH,
                              max_wait_ms=20.0, pipeline_depth=3,
                              drain_threads=2, device=DEVICE)
    res_open, sub, done, _ = sb.run_stream(sched, payloads[:SERVE_OPEN], gaps)
    sched.shutdown()
    lat = sb.latency_summary(done - sub)
    print(f"serve: raw {raw:.2f} maps/s, closed loop {closed:.2f} maps/s = "
          f"{closed / raw:.4f} of raw; open loop of {SERVE_OPEN} at "
          f"{OPEN_FRAC} of raw: p50 {lat['latency_p50_s']:.3f} s, p95 "
          f"{lat['latency_p95_s']:.3f} s, p99 {lat['latency_p99_s']:.3f} s, "
          f"max {lat['latency_max_s']:.3f} s on {sb.card_line()}",
          flush=True)
    print(f"serve: host seconds a batch, dispatch thread (closed loop) "
          f"{' '.join(f'{x:.3f}' for x in dispatch)}; main thread (direct) "
          f"{' '.join(f'{x:.3f}' for x in calls)}", flush=True)
    if not all(np.isfinite(r["cost"]) for r in res_open):
        fail("non-finite costs in the open loop")
    return launches, errs


def serve_plain(obs, out):
    """One served batch (packed observations `obs`, its kernel solve `out`)
    against the plain path: the batch solved again with nll_mode="plain"
    (final costs, COST_RTOL), then the 1-bit pair on the solve's final
    factors against its plain version at this shape (parity's tolerances).
    Returns the pair's max abs errors."""
    from quantized_spectrum_cartography_tpu_torch import serving_bench as sb
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        unpack_bits)

    B = obs.shape[0]
    plain = sb.make_solver(sb.serving_config(OUTER, INNER),
                           nll_mode="plain")({"T_obs": obs})
    c, c0 = out["cost"], plain["cost"]
    cost_rel = ((c - c0).abs() / c0.abs()).max().item()
    y01 = unpack_bits(obs, GRID * GRID).reshape(B, BANDS, GRID, GRID)
    codes = k.pack_codes_1bit(y01)
    S = out["S"].reshape(B, RANK, -1).contiguous()
    C = out["C"].transpose(1, 2).contiguous()
    g = torch.full((B,), 1.0 / y01[0].numel(), device=DEVICE)
    v = k.onebit_nll_fwd_cuda(S, C, codes, MEAN, STD)
    dS, dC = k.onebit_nll_bwd_cuda(S, C, codes, g, MEAN, STD)
    v0 = k.onebit_nll_plain(S, C, codes, MEAN, STD)
    dS0, dC0 = k.onebit_nll_grad_plain(S, C, codes, g, MEAN, STD)
    rel_v, (rel_s, rel_c) = rel_errs(v, v0, (dS, dC), (dS0, dC0))
    print(f"serve: a batch of {B} on nll_mode=\"plain\": final costs rel "
          f"{cost_rel:.2e}; the 1-bit pair at B={B} on its final factors: "
          f"value rel {rel_v:.2e}, dS {rel_s:.2e}, dC {rel_c:.2e} of max",
          flush=True)
    if not (cost_rel <= COST_RTOL and rel_v <= VALUE_RTOL
            and rel_s <= GRAD_RTOL and rel_c <= GRAD_RTOL):
        fail("at the serving shape the kernels disagree with their plain "
             "version")
    return {"onebit_nll_fwd": (v - v0).abs().max().item(),
            "onebit_nll_bwd": max((dS - dS0).abs().max().item(),
                                  (dC - dC0).abs().max().item())}


def distributed(card):
    """A world-size-1 nccl group on the card: the K-sharded solve against
    the same solve without a process group (one rank: the path, not the
    all-reduce's arithmetic), the in-process multi-host solve with its
    launches counted and against its plain path, then multihost_launch.py
    in a fresh process on the native shard path, bitwise against it."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from quantized_spectrum_cartography_tpu_torch import multihost_launch as mh
    from quantized_spectrum_cartography_tpu_torch.config import (
        QuantizerConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k, quantized_nll as q)
    from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
        gather_bin_bounds)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize_log)
    from quantized_spectrum_cartography_tpu_torch.parallel import (
        init_distributed, make_global_mesh, make_mesh,
        multihost_recover_lowrank, recover_lowrank_mle_ksharded)

    B, P = KSHARD_BATCH, GRID * GRID
    table, offset, sigma = (bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
                            bnd.LOG_OFFSET_4, 5.0)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    S_true = 0.05 * torch.rand(B, RANK, P, generator=gen, device=DEVICE)
    C_true = torch.rand(B, RANK, BANDS, generator=gen, device=DEVICE)
    Y = quantize_log(torch.einsum("brp,brk->bkp", S_true, C_true), sigma,
                     table, offset, gen)
    W, U = gather_bin_bounds(Y, table)
    qcfg = QuantizerConfig(boundaries=table, noise_std=sigma,
                           log_offset=offset)
    scfg = SolverConfig(max_iters=KSHARD_ITERS, lr_s=0.003,
                        projection_interval=5, rank_truncation=10)
    S0 = torch.zeros(B, RANK, P, device=DEVICE)
    C0 = torch.full((B, RANK, BANDS), 0.01, device=DEVICE)
    solo = recover_lowrank_mle_ksharded(make_mesh(), W, U, S0, C0, scfg, qcfg)

    T_obs = mh.problem_rows(0, LAUNCH_BATCH)
    inits = (np.zeros((LAUNCH_BATCH, RANK, GRID, GRID), np.float32),
             np.full((LAUNCH_BATCH, RANK, BANDS), 0.01, np.float32))
    lcfg = mh.solver_config(LAUNCH_ITERS)

    def counts():
        return {name: getattr(k if name.startswith("onebit") else q,
                              name + "_cuda").launches for name in KERNELS}

    rdv = tempfile.mkdtemp(prefix="qsc_smoke_")
    init_distributed(f"file://{rdv}/rendezvous", 1, 0, DEVICE)
    try:
        mesh = make_global_mesh()
        k.reset_launches()
        q.reset_launches()
        t = time.perf_counter()
        grouped = recover_lowrank_mle_ksharded(mesh, W, U, S0, C0, scfg, qcfg)
        torch.cuda.synchronize()
        ksharded_s = time.perf_counter() - t
        ksharded_launches = counts()
        k.reset_launches()
        q.reset_launches()
        local, total = multihost_recover_lowrank(
            mesh, T_obs, *inits, lcfg, mh.MEAN, mh.STD, device=DEVICE)
        launches = counts()
        plain, _ = multihost_recover_lowrank(
            mesh, T_obs, *inits, lcfg, mh.MEAN, mh.STD, device=DEVICE,
            nll_mode="plain")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv)

    cost_rel = ((grouped[2] - solo[2]).abs() / solo[2].abs()).max().item()
    factor_ok = all(torch.allclose(a, b, rtol=KSHARD_RTOL, atol=KSHARD_ATOL)
                    for a, b in zip(grouped[:2], solo[:2]))
    falling = bool((grouped[2][:, -1] < grouped[2][:, 0]).all())
    print(f"distributed: K-sharded solve ({B} maps, {P} pixels, K={BANDS}, "
          f"{KSHARD_ITERS} steps) under an nccl group of 1 against no group: "
          f"costs rel {cost_rel:.2e}, factors within rtol {KSHARD_RTOL} "
          f"{factor_ok}; costs falling {falling}; {ksharded_s:.3f} s on "
          f"{card}", flush=True)
    if not (cost_rel <= KSHARD_COST_RTOL and factor_ok and falling
            and not any(ksharded_launches.values())):
        fail(f"the K-sharded solve under a process group differs from the "
             f"solve without one, did not progress, or launched a kernel: "
             f"{ksharded_launches}")
    per_solve = LAUNCH_ITERS * (lcfg.s_inner_iters + lcfg.c_inner_iters)
    want = {name: per_solve if name.startswith("onebit") else 0
            for name in KERNELS}
    c, c0 = local["costs"][:, -1], plain["costs"][:, -1]
    plain_rel = float(np.max(np.abs(c - c0) / np.abs(c0)))
    print(f"distributed: multihost_recover_lowrank ({LAUNCH_BATCH} maps x "
          f"{LAUNCH_ITERS} x ({lcfg.s_inner_iters} + {lcfg.c_inner_iters})) "
          f"launches {launches}; against nll_mode=\"plain\" on the same "
          f"rows: final costs rel {plain_rel:.2e}", flush=True)
    if launches != want or not plain_rel <= COST_RTOL:
        fail(f"multihost_recover_lowrank launched {launches}, expected "
             f"{want}, or disagrees with its plain path")

    shards, out = OUT_DIR / "shards", OUT_DIR / "multihost.json"
    shutil.rmtree(shards, ignore_errors=True)
    out.unlink(missing_ok=True)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "quantized_spectrum_cartography_tpu_torch."
         "multihost_launch", "--num-processes", "1", "--global-batch",
         str(LAUNCH_BATCH), "--iters", str(LAUNCH_ITERS), "--reps", "1",
         "--device", DEVICE,
         "--shard-dir", str(shards), "--out", str(out), "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        fail(f"multihost_launch exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    summary = json.loads(out.read_text())
    tail = [float(c) for c in local["costs"][:, -1]]
    same = (summary["data_path"] == "native_shard"
            and summary["global_costs_tail"] == tail
            and summary["global_cost"] == total)
    print(f"distributed: multihost_launch --shard-dir in a fresh process "
          f"({wall:.2f} s; {summary['maps_per_sec']:.2f} maps/s, "
          f"{LAUNCH_BATCH} maps x {LAUNCH_ITERS} iterations) equals the "
          f"in-process regenerate path bit for bit: {same} (total "
          f"{summary['global_cost']!r} vs {total!r})", flush=True)
    if not same:
        fail("the native shard path in a fresh process differs from the "
             "in-process regenerate path")


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
    return {k: v for k, v in got.items() if v}, printed["final_cost"]


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

def kernel_counts():
    """Each kernel's launch count since the last `reset_counts`."""
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k, quantized_nll as q)

    return {name: getattr(k if name.startswith("onebit") else q,
                          name + "_cuda").launches for name in KERNELS}


def reset_counts():
    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        onebit_nll as k, quantized_nll as q)

    k.reset_launches()
    q.reset_launches()


def write_fixture(path):
    """A .mat in the reference's MATLAB layouts (generate_test_data.m:78-80)
    from one simulated 51x51x64, R=2 problem; the source tensors' arrays."""
    import numpy as np
    import scipy.io as sio

    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_onebit_problem)

    prob = generate_onebit_problem(
        torch.Generator(device=DEVICE).manual_seed(FIXTURE_SEED),
        sample_fraction=0.1, device=DEVICE)
    src = {name: getattr(prob, name).cpu().numpy()
           for name in ("T_true", "S_true", "C_true", "T_1bit", "Om")}
    sio.savemat(path, {"T": src["T_1bit"].transpose(1, 2, 0),
                       "T_true": src["T_true"].transpose(1, 2, 0),
                       "S_true": src["S_true"].transpose(1, 2, 0),
                       "C_true": src["C_true"].T,
                       "Om": src["Om"].astype(np.uint8)})
    return src


def fixture(card):
    """The .mat fixture written and read back bit for bit, then `recover
    --fixture` at the CLI's defaults with --solver lowrank (the 1-bit pair,
    against nll_mode="plain") and mle-gan (the bounds pair; its --out npz
    holds what `report` reads).  Returns each kernel's launches over both."""
    import numpy as np

    from quantized_spectrum_cartography_tpu_torch import cli
    from quantized_spectrum_cartography_tpu_torch.data import (
        load_onebit_fixture)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(OUT_DIR / "fixture.mat")
    src = write_fixture(path)
    prob = load_onebit_fixture(path, device=DEVICE)
    for name, want in src.items():
        got = getattr(prob, name).cpu().numpy()
        if not (got.dtype == want.dtype and np.array_equal(got, want)):
            fail(f"fixture: {name} read back {got.dtype} {got.shape}, "
                 f"written {want.dtype} {want.shape}, or other bits")
    print(f"fixture {path}: T_true, S_true, C_true, T_1bit, Om read back "
          f"bit for bit ({prob.shape})", flush=True)

    launches = dict.fromkeys(KERNELS, 0)
    steps = CLI_ITERS * 2 * INNER             # --iters x (5 S + 5 C) steps
    for solver, want in (
            ("lowrank", {"onebit_nll_fwd": steps, "onebit_nll_bwd": steps}),
            ("mle-gan", {"quantized_nll_fwd": 2 * CLI_ITERS + 2,
                         "quantized_nll_bwd": 2 * CLI_ITERS})):
        argv = ["recover", "--fixture", path, "--solver", solver]
        out = str(OUT_DIR / f"fixture_{solver}.npz")
        reset_counts()
        line, secs = run_cli(argv + ["--out", out])
        got = kernel_counts()
        want = {**dict.fromkeys(KERNELS, 0), **want}
        printed = json.loads(line)
        plain = cli.recovery(argv).run(nll_mode="plain")
        c0 = plain.costs[-1].item()
        rel = abs(printed["final_cost"] - c0) / abs(c0)
        keys = set(np.load(out).files)
        print(f"fixture recover --solver {solver}: launches {got}; final "
              f"cost {printed['final_cost']:.6g} (plain {c0:.6g}, rel "
              f"{rel:.2e}), NMSE {printed['final_nmse']:.4f}; {secs:.3f} s "
              f"on {card}; npz {sorted(keys)}", flush=True)
        if got != want:
            fail(f"recover --fixture --solver {solver}: launches {got}, "
                 f"the loop implies {want}")
        if not (np.isfinite(printed["final_cost"]) and rel <= COST_RTOL):
            fail(f"recover --fixture --solver {solver}: final cost "
                 f"{printed['final_cost']} against plain {c0}")
        if not REPORT_KEYS <= keys:
            fail(f"{out} lacks {sorted(REPORT_KEYS - keys)} (cli report)")
        for name, n in got.items():
            launches[name] += n
    return launches


def dip(card):
    """DecoderDip and recover_dip_tensor on the card against the CPU, then
    one run at DIP_QUALITY.json's configuration on a simulated problem."""
    import copy

    import numpy as np

    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
    from quantized_spectrum_cartography_tpu_torch.models import DecoderDip
    from quantized_spectrum_cartography_tpu_torch.models.layers import (
        flax_init_)
    from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
        get_tensor)
    from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_onebit_problem)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_dip_tensor, recover_lowrank_mle)

    cpu_gen = torch.Generator().manual_seed(DIP_SEED)
    cpu_dec = flax_init_(DecoderDip(DIP_Z), cpu_gen).train()
    card_dec = copy.deepcopy(cpu_dec).to(DEVICE)
    z = torch.randn(3, DIP_Z, generator=cpu_gen)
    with torch.no_grad():
        got, want = card_dec(z.to(DEVICE)).cpu(), cpu_dec(z)
    a, b = flat_state({"dec": card_dec}), flat_state({"dec": cpu_dec})
    err = ((got - want).abs() - PRIOR_RTOL * want.abs()).max().item()
    stats = max(float(np.abs(a[k] - b[k]).max()) for k in b)
    print(f"dip DecoderDip (train mode, 3 z's) on the card vs the CPU: max "
          f"abs diff {(got - want).abs().max().item():.3g}, moved running "
          f"statistics {stats:.3g}", flush=True)
    if not (got.shape == want.shape == (3, GRID, GRID, 1)
            and err <= PRIOR_ATOL and stats <= PRIOR_ATOL):
        fail("DecoderDip: the card's forward differs from the CPU's")

    gen = torch.Generator(device=DEVICE).manual_seed(DIP_SEED)
    prob = generate_onebit_problem(gen, device=DEVICE)
    T_obs = dither_probit(prob.T_true - DIP_MEAN, DIP_STD, gen)
    R, I, J, K = prob.shape

    # three steps from the same draws on the card and on the CPU
    zs = torch.randn(R, 1, DIP_Z, generator=cpu_gen)
    decs = [flax_init_(DecoderDip(DIP_Z), cpu_gen) for _ in range(R)]
    C0 = 0.01 * torch.rand(R, K, generator=cpu_gen)
    val_mask = (torch.rand(T_obs.shape, generator=cpu_gen)
                < DIP["holdout_frac"]).float()

    def steps(device, decoders):
        return recover_dip_tensor(
            None, T_obs.to(device), DIP_MEAN, DIP_STD, num_emitters=R,
            steps=DIP_PARITY_STEPS, z_dim=DIP_Z,
            T_true=prob.T_true.to(device), val_mask=val_mask.to(device),
            init=(zs.to(device), decoders, C0.to(device)), **DIP)

    card_decs = [copy.deepcopy(d).to(DEVICE) for d in decs]
    got, want = steps(DEVICE, card_decs), steps("cpu", decs)
    rel = (np.abs(got[2].cpu().numpy() - want[2].numpy())
           / np.abs(want[2].numpy()))
    a = flat_state({f"dec{r}": d for r, d in enumerate(card_decs)})
    b = flat_state({f"dec{r}": d for r, d in enumerate(decs)})
    stats = [k for k in b if k.split("/")[-1] in ("mean", "var")]
    diffs = np.concatenate(
        [np.abs(a[k] - b[k]).ravel() / DIP["lr"] for k in b
         if k not in stats]
        + [(got[1].cpu() - want[1]).abs().numpy().ravel() / DIP["lr"]])
    median, p90, top = np.quantile(diffs, [0.5, 0.9, 1.0])
    stats_ok = all(np.allclose(a[k], b[k], rtol=STATS_RTOL, atol=STATS_ATOL)
                   for k in stats)
    print(f"dip recover_dip_tensor card vs CPU, {DIP_PARITY_STEPS} steps: "
          f"losses rel {rel.max():.2e} (first {rel[0]:.2e}); weights and C "
          f"apart in lr units median {median:.3g}, p90 {p90:.3g}, max "
          f"{top:.3g}; running statistics within rtol {STATS_RTOL} + atol "
          f"{STATS_ATOL}: {stats_ok}", flush=True)
    if not (rel[0] <= FIRST_RTOL and (rel <= LOSS_RTOL).all()
            and top <= W_ATOL_LR and median <= W_MEDIAN_LR
            and p90 <= W_P90_LR and stats_ok):
        fail("recover_dip_tensor: the card's steps differ from the CPU's")

    # one run at DIP_QUALITY.json's configuration
    (S, C, losses, nmses, aux), secs = timed(lambda: recover_dip_tensor(
        torch.Generator(device=DEVICE).manual_seed(DIP_SEED), T_obs,
        DIP_MEAN, DIP_STD, num_emitters=R, steps=DIP_STEPS, z_dim=DIP_Z,
        T_true=prob.T_true, **DIP))
    nmse_ema = nmse(aux["T_ema"], prob.T_true).item()
    nmse_factors = nmse(get_tensor(S, C), prob.T_true).item()
    # the low-rank solver on the same observations (the fixture-parity
    # protocol: 50 x (10 + 10) steps, rank-10 SVD projection every 5)
    scfg = SolverConfig(max_iters=50, s_inner_iters=10, c_inner_iters=10,
                        lr_s=1e-3, lr_c=1e-3, projection_interval=5,
                        rank_truncation=10, projection_method="svd")
    S0 = 0.01 * torch.randn(1, R, I, J, generator=gen, device=DEVICE)
    C0 = 0.01 * torch.rand(1, R, K, generator=gen, device=DEVICE)
    lowrank, lr_secs = timed(lambda: recover_lowrank_mle(
        T_obs[None], S0, C0, scfg, DIP_MEAN, DIP_STD, l1=0.0, l2=0.01,
        T_true=prob.T_true[None]))
    finite = all(torch.isfinite(x).all() for x in
                 (S, C, losses, nmses, aux["T_ema"]))
    print(f"dip recover_dip_tensor ({DIP_STEPS} steps, {DIP}): NMSE of "
          f"T_ema {nmse_ema:.4f}, of the returned factors "
          f"{nmse_factors:.4f} (holdout {float(aux['holdout_best']):.4f}); "
          f"{secs:.2f} s on {card}; the low-rank solver on the same "
          f"observations NMSE {lowrank.nmses[0, -1].item():.4f} in "
          f"{lr_secs:.2f} s", flush=True)
    if not (finite and nmse_ema < 1):
        fail(f"DIP: finite {finite}, NMSE of T_ema {nmse_ema}")


def protocols(card):
    """The condition grid's and the miss protocol's drivers at a few
    examples: one R-axis condition through both registries, the miss
    protocol at two rhos, and the pooling of two draws."""
    import math

    import numpy as np

    from quantized_spectrum_cartography_tpu_torch import (
        conditions_grid as cg, missprob as mp, missprob_pool_seeds as mps)
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        BatchedHarness, Condition, load_pretrained_methods)

    stack, plain = cg.harnesses(DEVICE, cg.POLISH)
    cond = Condition(num_emitters=5)
    label = cond.label()
    row, wall, secs = cg.run_condition(stack, plain, cond,
                                       PROTOCOL_EXAMPLES, 0, DEVICE)
    doc = cg.grid_document({label: row}, PROTOCOL_EXAMPLES, 0)
    rows = doc["results"][label]
    methods = list(stack.methods) + list(plain.methods)
    layout = (sorted(rows) == sorted(methods + ["nasdac_stack_delta",
                                                "dowjons_stack_delta"])
              and all(POOLED_KEYS <= set(rows[m]) for m in methods)
              and all(len(rows[m]["sre_all"]) == PROTOCOL_EXAMPLES
                      for m in methods))
    finite = all(math.isfinite(v) for m in methods
                 for v in rows[m]["sre_all"])
    check = doc["r_axis_regression_check"]
    print(f"protocols grid {label}, {PROTOCOL_EXAMPLES} examples: {wall:.2f}"
          f" s on {card} ({', '.join(f'{m} {s:.2f}' for m, s in secs.items())}"
          f"); SRE " + ", ".join(f"{m} {rows[m]['sre']:.4f}" for m in methods)
          + f"; deltas nasdac {rows['nasdac_stack_delta']}, dowjons "
          f"{rows['dowjons_stack_delta']}; R-axis check "
          f"{'PASS' if check['pass'] else 'FAIL'} (printed, not gated, at "
          f"{PROTOCOL_EXAMPLES} examples)", flush=True)
    if not (layout and finite):
        fail(f"condition grid: layout {layout}, finite SREs {finite}")

    harness = BatchedHarness(load_pretrained_methods(
        only=mp.METHODS, device=DEVICE, **cg.POLISH), device=DEVICE)
    t = time.perf_counter()
    events = mp.run_draw(harness, PROTOCOL_EXAMPLES, 0, PROTOCOL_RHOS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    guard = mp.false_guard(events)
    for m, ev in events.items():
        print(f"protocols miss {m:9s} rhos {PROTOCOL_RHOS}: events "
              f"{[(e['miss'], e['peaks'], e['false'], e['lows']) for e in ev]}"
              f", miss rates {[round(v, 4) for v in mp.curves(events)[m]]}",
              flush=True)
    print(f"protocols miss: {wall:.2f} s on {card}; false guard "
          f"{ {m: g['false_rates'] for m, g in guard['per_method'].items()} }"
          f" bounds {guard['per_method']['dowjons']['bounds']}: "
          f"{'PASS' if guard['all_pass'] else 'FAIL'}", flush=True)
    if not all(math.isfinite(e["sre"]) for ev in events.values()
               for e in ev):
        fail("miss protocol: a non-finite SRE")

    draws = [{"events": mp.run_draw(harness, POOL_EXAMPLES, s,
                                    PROTOCOL_RHOS)} for s in (0, 1)]
    for m in mp.METHODS:
        pooled = mps.summed_events(draws, m)
        for key in pooled:
            want = [a[key] + b[key] for a, b in zip(draws[0]["events"][m],
                                                    draws[1]["events"][m])]
            if not np.array_equal(pooled[key], want):
                fail(f"pooling: {m} {key} {pooled[key]} != {want}")
    print(f"protocols pooling of two {POOL_EXAMPLES}-example draws: the "
          "summed event counts reproduced exactly", flush=True)


def initial_state(kind):
    """{module: state_dict} of `kind` as its trainer initializes it, from
    CPU seed 0."""
    from quantized_spectrum_cartography_tpu_torch.models.layers import (
        flax_init_)
    from quantized_spectrum_cartography_tpu_torch.training import (
        aae_trainer as aae, ae_trainer as ae, gan_trainer as gan,
        vae_trainer as vae)

    gen = torch.Generator().manual_seed(0)
    if kind == "gan":
        g, d, _, _ = gan.init_gan(gen, gan.GANTrainConfig())
        modules = {"g": g, "d": d}
    elif kind == "aae":
        enc, dec, dz, _ = aae.init_aae(gen, aae.AAETrainConfig())
        modules = {"enc": enc, "dec": dec, "dz": dz}
    else:
        model = (ae.Autoencoder() if kind == "ae"
                 else vae.vae_model(vae.VAETrainConfig()))
        modules = {kind: flax_init_(model, gen)}
    return {k: m.state_dict() for k, m in modules.items()}


def train_models(kind, device, state):
    """(modules, run, config) of `kind` at full width on `device` from the
    weights `state` ({module: state_dict}); run(draws) takes one step's
    draws (the GAN, the AAE) or all steps' (the AE, the VAE: one trainer
    run, one Adam) and returns each step's losses."""
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.data.datasets import (
        make_slf_sampler)
    from quantized_spectrum_cartography_tpu_torch.training import (
        aae_trainer as aae, ae_trainer as ae, gan_trainer as gan,
        vae_trainer as vae)

    physics = PhysicsConfig()
    if kind == "gan":
        cfg = gan.GANTrainConfig()
        g, d = gan.make_generator(cfg.z_dim), gan.Discriminator(
            spectral_norm=True)
        modules = {"g": g, "d": d}
    elif kind == "aae":
        cfg = aae.AAETrainConfig()
        modules = {"enc": aae.AAEEncoder(cfg.z_dim),
                   "dec": aae.AAEDecoder(cfg.z_dim),
                   "dz": aae.LatentDiscriminator(cfg.z_dim)}
    elif kind == "ae":
        cfg = ae.AETrainConfig()
        modules = {"ae": ae.Autoencoder(activation=cfg.activation)}
    else:
        cfg = vae.VAETrainConfig()
        modules = {"vae": vae.vae_model(cfg)}
    for k, m in modules.items():
        m.load_state_dict(state[k])
        m.to(device).train()
    sampler = make_slf_sampler(physics, device)
    if kind == "gan":
        step = gan.make_train_step(
            g, d, gan.adam(g.parameters(), cfg.lr_g, cfg.beta1),
            gan.adam(d.parameters(), cfg.lr_d, cfg.beta1), cfg, sampler)

        def run(draws):
            m = step(draws=draws)
            return [m["d_loss"].item(), m["g_loss"].item()]
    elif kind == "aae":
        step = aae.make_aae_step(
            *modules.values(), aae.aae_optimizers(*modules.values(), cfg),
            cfg, physics)

        def run(draws):
            m = step(draws=draws)
            return [m[k].item() for k in ("recon", "dz", "gen")]
    else:
        # the trainer itself, all steps in one run (one Adam)
        trainer = ae.train_ae if kind == "ae" else vae.train_vae
        model = modules[kind]

        def run(all_draws):
            _, info = trainer(None, dataclasses.replace(
                cfg, steps=len(all_draws)), physics, log_every=1,
                draws=all_draws, model=model, log_fn=lambda *a: None)
            model.train()
            return [list(m[1:]) for m in info["metrics"]]
    return modules, run, cfg


def train_draws(kind, steps):
    """`steps` steps' draws of `kind` at full width, on the CPU."""
    from quantized_spectrum_cartography_tpu_torch.data.datasets import (
        draw_mask, draw_slf)
    from quantized_spectrum_cartography_tpu_torch.training import (
        aae_trainer as aae, ae_trainer as ae, gan_trainer as gan,
        vae_trainer as vae)

    gen = torch.Generator().manual_seed(1)
    B, I = 64, GRID
    out = []
    for _ in range(steps):
        slf = draw_slf(gen, B)
        if kind == "gan":
            out.append(gan.GANDraws(slf, torch.randn(B, 256, generator=gen),
                                    torch.randn(B, 256, generator=gen)))
        elif kind == "aae":
            out.append(aae.AAEDraws(slf, torch.randn(B, 64, generator=gen)))
        else:
            mask = draw_mask(gen, torch.zeros(B, I, I))
            out.append(ae.AEDraws(slf, mask) if kind == "ae" else
                       vae.VAEDraws(slf, mask,
                                    torch.randn(B, 64, generator=gen)))
    return out


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(_to(v, device) for v in x))


def flat_state(modules):
    """{module/flax path: array} of the modules' flax trees (weights,
    running statistics, spectral vectors)."""
    from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
        flax_from_state_dict)

    out = {}
    for name, m in modules.items():
        for path, a in _leaves(flax_from_state_dict(m.state_dict())):
            out["/".join((name,) + path)] = a
    return out


def train_parity(kind):
    """TRAIN_PARITY_STEPS steps of `kind` on the card and on the CPU from
    the same weights and draws; the largest differences found."""
    import numpy as np

    draws = train_draws(kind, TRAIN_PARITY_STEPS)
    state = initial_state(kind)
    card, run_card, cfg = train_models(kind, DEVICE, state)
    cpu, run_cpu, _ = train_models(kind, "cpu", state)
    if kind in ("gan", "aae"):
        got = [run_card(_to(d, DEVICE)) for d in draws]
        want = [run_cpu(d) for d in draws]
    else:
        got, want = run_card([_to(d, DEVICE) for d in draws]), run_cpu(draws)
    got, want = np.asarray(got), np.asarray(want)
    # the learning rate each module's weights move by (the AAE's encoder
    # twice a step)
    lr = {"g": getattr(cfg, "lr_g", 0), "d": getattr(cfg, "lr_d", 0),
          "enc": getattr(cfg, "lr_ae", 0) + getattr(cfg, "lr_adv", 0),
          "dec": getattr(cfg, "lr_ae", 0), "dz": getattr(cfg, "lr_adv", 0),
          "ae": getattr(cfg, "lr", 0), "vae": getattr(cfg, "lr", 0)}
    rel = np.abs(got - want) / np.abs(want)
    # losses on the initial weights: the D loss, the reconstruction, the
    # AE's loss and the VAE's three terms of step 1
    first = rel[0, :3 if kind == "vae" else 1]
    ok = (first <= FIRST_RTOL).all() and (rel <= LOSS_RTOL).all()
    a, b = flat_state(card), flat_state(cpu)
    stats = [k for k in b if k.split("/")[-1] in ("mean", "var", "u")]
    diffs = np.concatenate([np.abs(a[k] - b[k]).ravel() / lr[k.split("/")[0]]
                            for k in b if k not in stats])
    median, p90, top = np.quantile(diffs, [0.5, 0.9, 1.0])
    stats_ok = all(np.allclose(a[k], b[k], rtol=STATS_RTOL, atol=STATS_ATOL)
                   for k in stats)
    ok = ok and top <= W_ATOL_LR and median <= W_MEDIAN_LR and \
        p90 <= W_P90_LR and stats_ok
    print(f"train {kind} card vs CPU, {TRAIN_PARITY_STEPS} steps at batch "
          f"64: losses rel {rel.max():.2e} (first {first.max():.2e}"
          f"); weights apart in lr units median {median:.3g}, p90 "
          f"{p90:.3g}, max {top:.3g}; running statistics within "
          f"rtol {STATS_RTOL} + atol {STATS_ATOL}: {stats_ok}", flush=True)
    if not ok:
        fail(f"train {kind}: the card's steps differ from the CPU's")


def train_cli(kind, card):
    """`cli train-prior --kind K` at full width in a fresh process; its
    summary line (parsed)."""
    import math

    ckpt = OUT_DIR / "train" / kind
    cmd = [*CLI, "train-prior", "--kind", kind, "--steps", str(TRAIN_STEPS),
           "--log-every", str(TRAIN_LOG_EVERY), "--checkpoint-dir",
           str(ckpt)] + (["--z-dim", "64"] if kind == "aae" else [])
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        fail(f"train-prior --kind {kind} exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # "<kind> step <n>: <name> <value> <name> <value> ..."
    values = [[float(x) for x in line.split(":", 1)[1].split()[1::2]]
              for line in summary["log"]]
    finite = all(math.isfinite(v) for row in values for v in row)
    # the AE's MSE and the VAE's reconstruction term (its second number)
    col = {"ae": 0, "vae": 1}.get(kind)
    falls = None
    if col is not None:
        series = [row[col] for row in values]
        falls = sum(series[-3:]) / 3 < sum(series[:3]) / 3
    print(f"train cli {kind}: {TRAIN_STEPS} steps at batch 64 in "
          f"{summary['seconds']:.2f} s (process {wall:.2f} s), steady "
          f"{summary['steps_per_s']:.1f} steps/s on {card}; logs "
          f"{len(values)}, first "
          f"{summary['log'][0]!r}, last {summary['log'][-1]!r}; finite "
          f"{finite}; falling {falls}", flush=True)
    if not (finite and len(values) >= 6 and falls in (None, True)):
        fail(f"train-prior --kind {kind}: losses not finite or not falling")
    return ckpt


def train(card, vae_cost):
    """Prior training on the card: (a) card against CPU, (b) each kind
    through the CLI, (c) their GAN and VAE priors behind recover, (d) the
    CLI's own numerics."""
    import numpy as np

    from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
        quantized_nll as q)

    for kind in TRAIN_KINDS:
        train_parity(kind)
    ckpts = {kind: train_cli(kind, card) for kind in TRAIN_KINDS}

    want = dict.fromkeys(ORDINAL, 0)
    want.update({"quantized_nll_fwd": 2 * CLI_ITERS + 2,
                 "quantized_nll_bwd": 2 * CLI_ITERS})
    launched = {}
    for kind in ("gan", "vae"):
        q.reset_launches()
        line, secs = run_cli(["recover", "--solver", "mle-gan",
                              "--prior-kind", kind, "--prior-checkpoint",
                              str(ckpts[kind] / "final")])
        got = {name: getattr(q, name + "_cuda").launches for name in ORDINAL}
        printed = json.loads(line)
        print(f"train recover under the port-trained {kind}: launches {got}; "
              f"final cost {printed['final_cost']:.2f}, NMSE "
              f"{printed['final_nmse']:.4f}; {secs:.3f} s on {card}",
              flush=True)
        if got != want or not (np.isfinite(printed["final_cost"])
                               and np.isfinite(printed["final_nmse"])):
            fail(f"recover under the trained {kind}: launches {got} "
                 f"(expected {want}) or non-finite {printed}")
        for name, n in got.items():
            launched[name] = launched.get(name, 0) + n

    cmd = [*CLI, "recover", "--solver", "mle-gan"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    if proc.returncode != 0:
        fail(f"fresh recover exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])["final_cost"]
    rel = abs(fresh - vae_cost) / abs(vae_cost)
    print(f"train numerics: recover --solver mle-gan in a fresh process "
          f"final cost {fresh:.4f}, in this process {vae_cost:.4f}, rel "
          f"{rel:.2e}", flush=True)
    if not rel <= COST_RTOL:
        fail("the CLI in a fresh process computes another cost than the "
             "in-process run: its numerics are not the card's")
    return {k: v for k, v in launched.items() if v}


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
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)

    set_card_numerics()
    smi = phase("device", device_info)
    card = torch.cuda.get_device_name(0)
    phase("build", build)
    errs = phase("parity", parity)
    errs.update(phase("parity_ordinal", parity_ordinal))
    launches, inputs_1bit, T_obs = phase("main", lambda: main_path(card))
    launches_serve, errs_serve = phase("serve", serve)
    for name, err in errs_serve.items():
        errs[name] = max(errs[name], err)
    phase("distributed", lambda: distributed(card))
    trees = phase("checkpoints", checkpoints)
    launches_gan, inputs_gan = phase("main_gan",
                                     lambda: main_gan(card, trees))
    launches.update(launches_gan)
    launches_vae, vae_cost = phase("main_vae", lambda: main_vae(card))
    phase("harness", lambda: harness(card))
    launches_lr, inputs_lr = phase("main_lowrank_ordinal",
                                   lambda: main_lowrank_ordinal(T_obs))
    launches_fixture = phase("fixture", lambda: fixture(card))
    phase("dip", lambda: dip(card))
    phase("protocols", lambda: protocols(card))
    launches_train = phase("train", lambda: train(card, vae_cost))
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
            "serve_launches": launches_serve[name],
            "main_vae_launches": launches_vae.get(name, 0),
            "train_recover_launches": launches_train.get(name, 0),
            "fixture_launches": launches_fixture[name],
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
