"""Miss-detection-probability curves of the evaluation, on the port.

    python -m quantized_spectrum_cartography_tpu_torch.missprob \\
        --examples 150 --seed 0 --out build/missprob/MISSPROB_seed0.json

The counterpart of the JAX package's ``tools/missprob_tpu.py``: the
reference publishes miss probabilities at rho = [1, 2.5, 5, 7.5, 10]%
sampling for DeepComp, Nasdac and DowJons
(`backup/algorithms/joint_opt_ae.m:998-1004`), aggregated over Monte-Carlo
examples with the event rules at `:514-544` and the (total+1) denominators
at `:549-554`.  One `BatchedHarness` batch of `--examples` examples per rho
through the three methods with the gated polish settings; per method the
curve next to the published row, the raw events with each example's own
(the port's harness keeps them; the JAX package's does not), and the
false-alarm guard
(`missprob_tpu.py:122-157`): each factored method's false-alarm rate at
every rho at most max(1.2 x, + 0.01) DeepComp's.  Draws of several seeds
pool with ``missprob_pool_seeds``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.conditions_grid import POLISH
from quantized_spectrum_cartography_tpu_torch.conditions_pool import dump_json
from quantized_spectrum_cartography_tpu_torch.config import set_card_numerics
from quantized_spectrum_cartography_tpu_torch.published_sre import device_info

# joint_opt_ae.m:998-1004 — the published miss-probability rows
PUBLISHED = {
    "deepcomp": [0.5360, 0.2554, 0.0977, 0.0244, 0.0213],
    "nasdac":   [0.2882, 0.1115, 0.0262, 0.0089, 0.0069],
    "dowjons":  [0.2688, 0.0952, 0.0292, 0.0038, 0.0007],
}
METHODS = ("deepcomp", "nasdac", "dowjons")
RHOS = (0.01, 0.025, 0.05, 0.075, 0.10)
# the rhos whose dowjons misses --missed-from keeps (where the port's
# pooled rates sat above JAX's)
MISSED_RHOS = (0.075, 0.10)
FALSE_RATIO, FALSE_ABS = 1.2, 0.01


def _events(st: dict) -> dict:
    """One (method, rho)'s events: the counts, the mean SRE and the
    per-example events (`per_example`: miss / peaks / false / lows counts
    and the validity flags, one entry per example; the counts are their
    sums over the valid examples)."""
    return {"miss": st["miss_count"], "peaks": st["peak_count"],
            "false": st["false_count"], "lows": st["low_count"],
            "sre": st["sre"],
            "per_example": {"miss": st["miss_all"], "peaks": st["peak_all"],
                            "false": st["false_all"], "lows": st["low_all"],
                            "valid": st["valid_all"]}}


def run_draw(harness, examples: int, seed: int, rhos=RHOS) -> Dict:
    """{method: [per-rho events]} of one batch per rho (`_events`)."""
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        condition_grid)

    conds = condition_grid("fraction", rhos)
    out = harness.run(conds, num_examples=examples, seed=seed)
    return {m: [_events(out[c.label()][m]) for c in conds]
            for m in harness.methods}


def curves(events: Dict[str, List[dict]]) -> Dict[str, List[float]]:
    """Miss rates miss / (peaks + 1) per method and rho."""
    return {m: [e["miss"] / (e["peaks"] + 1) for e in ev]
            for m, ev in events.items()}


def match_or_beat(ours: Dict[str, List[float]]) -> bool:
    """Every method at or below its published row at every rho."""
    return all(bool(np.all(np.asarray(ours[m])
                           <= np.asarray(PUBLISHED[m]) + 1e-9))
               for m in ours)


def false_guard(events: Dict[str, List[dict]]) -> dict:
    """The false-alarm criterion against the completion baseline
    (DeepComp): nasdac's and dowjons' rates at every rho at most
    max(1.2 x, + 0.01) of DeepComp's (missprob_tpu.py:122-157)."""
    out = {"bound": f"max({FALSE_RATIO}x, +{FALSE_ABS}) vs completion",
           "baseline_method": "deepcomp", "per_method": {}}
    base = np.asarray([e["false"] / (e["lows"] + 1)
                       for e in events["deepcomp"]])
    bound = np.maximum(FALSE_RATIO * base, base + FALSE_ABS)
    all_pass = True
    for m in ("nasdac", "dowjons"):
        ours = np.asarray([e["false"] / (e["lows"] + 1) for e in events[m]])
        ok = bool(np.all(ours <= bound + 1e-9))
        all_pass &= ok
        out["per_method"][m] = {
            "false_rates": [round(float(v), 4) for v in ours],
            "baseline_rates": [round(float(v), 4) for v in base],
            "bounds": [round(float(v), 4) for v in bound],
            "ratios": [round(float(a / max(b, 1e-12)), 3)
                       for a, b in zip(ours, base)],
            "pass": ok,
        }
    out["all_pass"] = all_pass
    return out


def draw_document(events, examples: int, config: dict, wall: float,
                  device: str) -> dict:
    """One draw's document in the layout of the JAX package's
    MISSPROB.json, each event entry with its per-example events."""
    ours = curves(events)
    return {
        "protocol": "joint_opt_ae.m:514-544 events, :549-554 denominators",
        "config": config,
        "rhos": list(RHOS),
        "num_examples": examples,
        "published": PUBLISHED,
        "ours": ours,
        "events": events,
        "false_match": false_guard(events),
        "wall_seconds": wall,
        "all_match_or_beat": match_or_beat(ours),
        "device": device_info(device),
        "notes": "DowJons uses the VAE prior (reference: SNGAN); "
                 "published rows are the reference's own Monte-Carlo "
                 "aggregates at unspecified example counts.",
    }


def missed_problems(doc: dict, method: str, rhos, device) -> Dict:
    """The problems of one draw document where `method` missed a peak
    event, at each rho of `rhos`: regenerated as BatchedHarness.run draws
    them (condition ci of the draw's rhos from a generator seeded with
    seed * 100000 + ci * 1000, on the device the draw ran on), so a problem
    the port missed on the card can be run again elsewhere.  Returns numpy
    arrays stacked over the kept examples, with their rho, draw seed,
    index and misses."""
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        BatchedHarness, condition_grid)
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        make_problem)

    harness = BatchedHarness({}, device=device)
    seed, n = doc["config"]["seed"], doc["num_examples"]
    keys = ("T_true", "T_noisy", "S_true", "C_true", "peaks", "Om")
    out = {k: [] for k in keys + ("rho", "seed", "index", "misses")}
    for ci, cond in enumerate(condition_grid("fraction", doc["rhos"])):
        misses = doc["events"][method][ci]["per_example"]["miss"]
        idx = [i for i, m in enumerate(misses) if m > 0]
        if cond.fraction not in rhos or not idx:
            continue
        gen = torch.Generator(device=device).manual_seed(
            seed * 100_000 + ci * 1_000)
        hp = make_problem(gen, cond, harness.physics, n, device,
                          harness._cholesky(cond.xc))
        for k in keys:
            out[k].append(getattr(hp, k)[idx].cpu().numpy())
        out["rho"] += [cond.fraction] * len(idx)
        out["seed"] += [seed] * len(idx)
        out["index"] += idx
        out["misses"] += [misses[i] for i in idx]
    return {k: (np.concatenate(v) if k in keys else np.asarray(v))
            for k, v in out.items() if len(v)}


def main(argv=None):
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        BatchedHarness, load_pretrained_methods, pretrained)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--examples", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    p.add_argument("--polish-ridge", type=float,
                   default=POLISH["polish_ridge"])
    p.add_argument("--polish-gamma", type=float,
                   default=POLISH["polish_gamma"])
    p.add_argument("--polish-peaks", type=int,
                   default=POLISH["polish_peaks_extra"])
    p.add_argument("--missed-from", nargs="+", metavar="DRAW_JSON",
                   help="instead of a draw: save to --out (npz) the "
                        "problems of these draws where dowjons missed at "
                        "rho 7.5%% and 10%%")
    args = p.parse_args(argv)
    if args.missed_from:
        parts = []
        for path in args.missed_from:
            with open(path) as f:
                parts.append(missed_problems(json.load(f), "dowjons",
                                             MISSED_RHOS, args.device))
        parts = [d for d in parts if d]
        np.savez_compressed(args.out, **{
            k: np.concatenate([d[k] for d in parts]) for k in parts[0]})
        print(f"wrote {args.out}: {sum(len(d['index']) for d in parts)} "
              f"problems", flush=True)
        return
    t0 = time.time()

    def log(*a):
        print(f"[{time.time() - t0:7.1f}s]", *a, flush=True)

    if torch.device(args.device).type == "cuda":
        set_card_numerics()
    polish = dict(polish_ridge=args.polish_ridge,
                  polish_gamma=args.polish_gamma,
                  polish_peaks_extra=args.polish_peaks)
    root = pretrained.REPO_ROOT
    config = {
        "ae_checkpoint": os.path.relpath(pretrained.AE_CKPT, root),
        "vae_checkpoint": os.path.relpath(pretrained.VAE_CKPT, root),
        "dowjons_variant": "gan", "dowjons_iters": 30,
        "dowjons_restarts": 4, "anchor_mu0": 0.3,
        "c_polish_ridge_rel": args.polish_ridge,
        "c_polish_gamma": args.polish_gamma,
        "c_polish_peaks_extra": args.polish_peaks,
        "backstop_frac": 0.5, "peak_refine_patches": 2,
        "seed": args.seed,
    }
    harness = BatchedHarness(
        load_pretrained_methods(only=METHODS, device=args.device, **polish),
        log_fn=log, device=args.device)
    events = run_draw(harness, args.examples, args.seed)
    wall = time.time() - t0
    doc = draw_document(events, args.examples, config, wall, args.device)
    doc["per_condition_seconds"] = harness.seconds
    for m, ours in doc["ours"].items():
        log(f"{m:9s} ours  " + " ".join(f"{v:.4f}" for v in ours))
        log(f"{m:9s} publ  " + " ".join(f"{v:.4f}" for v in PUBLISHED[m]))
    for m, g in doc["false_match"]["per_method"].items():
        log(f"false guard {m:9s} rates "
            + " ".join(f"{v:.4f}" for v in g["false_rates"]) + "  bounds "
            + " ".join(f"{v:.4f}" for v in g["bounds"])
            + ("  PASS" if g["pass"] else "  FAIL"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dump_json(doc, args.out)
    log(f"total wall {wall:.1f} s; wrote {args.out}; all_match_or_beat = "
        f"{doc['all_match_or_beat']}")


if __name__ == "__main__":
    main()
