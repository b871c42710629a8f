"""Where the time of one solve goes on the GPU.

    python -m quantized_spectrum_cartography_tpu_torch.profile_solve \
        [--solver lowrank|mle-gan|harness] [--method dowjons] [--batch N]
        [--trace trace.json]

--solver lowrank (default): the bench protocol of ``chip_smoke.py`` (B
51x51x64 maps, R=2, 50 outer x (5 S + 5 C) Adam steps, rank-10 projection
every 5).  --solver mle-gan: ``chip_smoke.py``'s MLE-GAN problem, one map
realizable by a seeded Generator256, 4-bin log quantizer, sigma 5, 10% of
the entries observed, SolverConfig() defaults, f32 bin bounds.
--solver harness: one of the published methods (``--method``, default
dowjons) of ``baselines.load_pretrained_methods`` on a batch of base-condition
examples (f=0.05, R=2, 51x51x64; ``--batch``, default 32), as
``chip_smoke.py``'s harness phase runs it.
Runs the solve once to warm up, once timed, then once under
``torch.profiler``.  Prints one JSON line: the card, the wall seconds of the
timed solve (and of the profiled one, which the profiler slows on the host),
the summed device time of the profiled solve's kernels and their share of
the timed wall time (the device-busy share; the rest is the host issuing
work), the kernel launches, and the kernels and host operators that take
the most time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from quantized_spectrum_cartography_tpu_torch.config import (
    PhysicsConfig, QuantizerConfig, SolverConfig)
from quantized_spectrum_cartography_tpu_torch.models import Generator256
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as bnd
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    dither_probit, quantize_log)
from quantized_spectrum_cartography_tpu_torch.physics import (
    generate_map_batch, sample_entry_mask)
from quantized_spectrum_cartography_tpu_torch.solvers import (
    make_generator_apply, recover_lowrank_mle, recover_mle_gan)

MEAN, STD = 0.0045, 0.008


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def lowrank_solve(batch):
    """The bench protocol's solve of `batch` maps; returns a fn."""
    cfg = PhysicsConfig()
    scfg = SolverConfig(max_iters=50, s_inner_iters=5, c_inner_iters=5,
                        lr_s=0.001, lr_c=0.001, projection_interval=5,
                        rank_truncation=10)
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, _, _, _ = generate_map_batch(gen, cfg, batch, device="cuda")
    T_obs = dither_probit(T - MEAN, STD, gen)
    R, K, I = cfg.num_emitters, cfg.num_bands, cfg.grid_size
    S0 = torch.zeros(batch, R, I, I, device="cuda")
    C0 = torch.full((batch, R, K), 0.01, device="cuda")

    return lambda: recover_lowrank_mle(T_obs, S0, C0, scfg, MEAN, STD)


def mle_gan_solve():
    """One MLE-GAN map at full width, as chip_smoke.py builds it."""
    gen_apply = make_generator_apply(Generator256(seed=0).to("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        S_true = gen_apply(torch.randn(2, 256, generator=gen, device="cuda"))
    T = get_tensor(S_true, torch.randn(2, 64, generator=gen,
                                       device="cuda").abs())
    qcfg = QuantizerConfig(boundaries=bnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
                           noise_std=5.0, log_offset=bnd.LOG_OFFSET_4)
    Y = quantize_log(T, qcfg.noise_std, qcfg.boundaries, qcfg.log_offset, gen)
    mask = sample_entry_mask(gen, tuple(Y.shape), 0.1, device="cuda")
    return lambda: recover_mle_gan(
        Y, mask, gen_apply, SolverConfig(), qcfg, T_true=T,
        generator=torch.Generator(device="cuda").manual_seed(3))


def harness_solve(batch, method):
    """One published method on `batch` base-condition examples."""
    import dataclasses

    from quantized_spectrum_cartography_tpu_torch.baselines import (
        Condition, load_pretrained_methods, make_problem)
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        SAMPLE_IDX_METHODS)

    fn = load_pretrained_methods(only=(method,), device="cuda")[method]
    hp = make_problem(torch.Generator(device="cuda").manual_seed(0),
                      Condition(), batch=batch, device="cuda")
    if method not in SAMPLE_IDX_METHODS:
        hp = dataclasses.replace(hp, sample_idx=None)

    def run():
        with torch.no_grad():
            return fn(torch.Generator(device="cuda").manual_seed(1), hp)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=["lowrank", "mle-gan", "harness"],
                    default="lowrank")
    ap.add_argument("--method", default="dowjons",
                    choices=["tps", "btd", "deepcomp", "nasdac", "dowjons"],
                    help="the harness method to profile")
    ap.add_argument("--batch", type=int, default=None,
                    help="maps per low-rank solve (256) or harness "
                         "examples (32)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled solve here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.solver == "mle-gan":
        maps, run = 1, mle_gan_solve()
    elif args.solver == "lowrank":
        maps = args.batch or 256
        run = lowrank_solve(maps)
    else:
        maps = args.batch or 32
        run = harness_solve(maps, args.method)

    def solve():
        res = run()
        torch.cuda.synchronize()
        return res

    solve()
    t0 = time.perf_counter()
    solve()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        profiled_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    avgs = prof.key_averages()
    kernels = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
    device_ms = sum(_device_us(a) for a in kernels) / 1e3
    host = sorted((a for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda a: a.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "solver": (args.solver if args.solver != "harness"
                   else f"harness {args.method}"),
        "batch": maps,
        "wall_s": wall_s,
        "maps_per_s": maps / wall_s,
        "profiled_wall_s": profiled_s,
        "device_ms": device_ms,
        "device_busy_share": device_ms / 1e3 / wall_s,
        "kernel_launches": sum(a.count for a in kernels),
        "top_kernels": [[a.key[:60], a.count, _device_us(a) / 1e3]
                        for a in kernels[: args.top]],
        "top_host_ops": [[a.key[:60], a.count, a.self_cpu_time_total / 1e3]
                         for a in host[: args.top]],
    }))


if __name__ == "__main__":
    main()
