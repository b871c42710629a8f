"""Five-method SRE table at the reference's published-figure configuration,
on the port.

    python -m quantized_spectrum_cartography_tpu_torch.published_sre \\
        --examples 256 --out PUBLISHED_SRE_TORCH.json [--device cuda]

The counterpart of the JAX package's ``tools/published_sre_tpu.py``: the
base condition (R=2, shadow_sigma=5, Xc=50, f=0.05, sinc basis, noiseless;
`joint_opt_ae.m:12-28`) or another sampling fraction (``--fraction``),
`--examples` Monte-Carlo examples in one `BatchedHarness` batch, the five
methods of `load_pretrained_methods` at the registry's defaults, and per
method the mean, median and 12.5%-per-tail trimmed mean of the SRE (BTD's
on its SRE < 3 examples, `:496-501`), the sorted per-example SREs, NAE and
the miss / false-alarm probabilities, in that script's JSON layout, plus
each method's seconds and the device.  The published anchors are the
reference's single-example figure titles (`:605-645`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import set_card_numerics

PUBLISHED = {"dowjons": 0.3163, "nasdac": 1.1751, "deepcomp": 0.4201,
             "btd": 1.2288, "tps": 1.9181}
METHODS = ("tps", "btd", "deepcomp", "nasdac", "dowjons")
CAPS = {"btd": 3.0}


def summarize(st: dict, pub: float, cap=None) -> dict:
    """One method's row from its `BatchedHarness` statistics."""
    sres = np.sort(np.asarray(st["sre_all"]))
    valid = sres[sres < cap] if cap else sres
    # symmetric 12.5%-per-tail trim
    k = max(1, int(round(0.125 * valid.size)))
    trimmed = float(valid[k:-k].mean()) if valid.size > 2 * k else float(
        valid.mean())
    return {
        "published_sre": pub,
        "sre_mean": round(float(valid.mean()), 4),
        "sre_median": round(float(np.median(valid)), 4),
        "sre_trimmed_mean_12.5pct_each_tail": round(trimmed, 4),
        "valid": int(valid.size),
        "nae_s": round(st["nae_s"], 4) if st["nae_s"] == st["nae_s"] else None,
        "nae_c": round(st["nae_c"], 4) if st["nae_c"] == st["nae_c"] else None,
        "miss_prob": round(st["miss_prob"], 4),
        "false_prob": round(st["false_prob"], 4),
        "sre_sorted": [round(float(v), 3) for v in sres],
        "beats_published_mean": bool(valid.mean() < pub),
        "beats_published_median": bool(np.median(valid) < pub),
        "beats_published_trimmed": bool(trimmed < pub),
    }


def device_info(device: str) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi_name_power_limit": smi}


def main(argv=None):
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        BatchedHarness, Condition, load_pretrained_methods)
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        pretrained)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--examples", type=int, default=64)
    p.add_argument("--fraction", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if os.path.basename(args.out) == "PUBLISHED_SRE.json":
        p.error("PUBLISHED_SRE.json is the JAX package's table; write the "
                "port's elsewhere (e.g. PUBLISHED_SRE_TORCH.json)")

    t0 = time.time()

    def log(*a):
        print(f"[{time.time() - t0:7.1f}s]", *a, flush=True)

    if torch.device(args.device).type == "cuda":
        set_card_numerics()
    methods = load_pretrained_methods(only=METHODS, device=args.device)
    harness = BatchedHarness(methods, log_fn=log, device=args.device)
    cond = Condition(fraction=args.fraction)
    out = harness.run((cond,), num_examples=args.examples, seed=args.seed)
    (label, per_method), = out.items()
    table = {}
    for name, st in per_method.items():
        row = summarize(st, PUBLISHED[name], CAPS.get(name))
        row["seconds"] = round(harness.seconds[label][name], 3)
        table[name] = row
        log(f"{name:9s} mean {row['sre_mean']:.4f} med {row['sre_median']:.4f}"
            f" trim {row['sre_trimmed_mean_12.5pct_each_tail']:.4f} "
            f"(published {row['published_sre']}) valid {row['valid']}/"
            f"{args.examples}, {row['seconds']} s")
    root = pretrained.REPO_ROOT
    result = {
        "protocol": (f"condition {label} (base: joint_opt_ae.m:12-28), "
                     f"{args.examples} Monte-Carlo examples (seed "
                     f"{args.seed}) in one BatchedHarness batch of the "
                     "PyTorch port; published anchors are the reference's "
                     "single-example figure titles (joint_opt_ae.m:605-645)"),
        "config": {
            "ae_checkpoint": os.path.relpath(pretrained.AE_CKPT, root),
            "vae_checkpoint": os.path.relpath(pretrained.VAE_CKPT, root),
            "dowjons_variant": "gan", "dowjons_iters": 30,
            "dowjons_restarts": 4, "anchor_mu0": 0.3,
            "fraction": args.fraction, "seed": args.seed,
        },
        "num_examples": args.examples,
        "methods": table,
        "device": device_info(args.device),
        "wall_seconds": round(time.time() - t0, 1),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
