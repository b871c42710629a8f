"""The full five-axis condition grid of the evaluation, on the port.

    python -m quantized_spectrum_cartography_tpu_torch.conditions_grid \\
        --examples 64 --out chiprun_out/CONDITIONS_TORCH.json [--axis xc ...]

The counterpart of the JAX package's ``tools/conditions_tpu.py``
(`joint_opt_ae.m:11-25, 82-117`): 25 conditions (fraction / R / shadow /
Xc / SNR axes, 5 values each, `REFERENCE_AXES`), `--examples` Monte-Carlo
examples per condition in one `BatchedHarness` batch, through two
registries: the six methods of `load_pretrained_methods` with the gated
polish settings (`--polish-*`, the tool's defaults), and the "plain"
nasdac / dowjons with the detection stack off (anchor, witness swap,
backstop, patches, polish), renamed ``*_plain`` (`conditions_tpu.py:82-87`).
Per condition: each row's SRE spread, the stack-vs-plain deltas, the wall
seconds (device synchronized) and each method's seconds.

The document is written in the layout of the JAX package's
CONDITIONS_POOLED.json (`conditions_pool.pool_results` of the one draw,
keeping the per-example SREs to 3 decimals), incrementally to ``<out>.part``
and moved onto `--out` at the end, with:

- the R-axis regression verdict (`conditions_tpu.py:172-207`): at every R in
  {5..13} the stack minus plain has dmiss <= 0.02 and dSRE <= 0.05; a
  violation exits 1 after the document is written;
- the comparison with the JAX grid (`--reference`, CONDITIONS_POOLED.json),
  every (condition, row) by label: z = (port - JAX) / sqrt(sd_p^2/n_p +
  sd_j^2/n_j) on the SRE means, in band when |z| <= 3; BTD on its valid
  examples on both sides, JAX's recomputed from its draws
  (`--reference-draws`), since the pooled BTD mean counts an invalid
  example (ROADMAP Queue 3); each condition with a row out of band is drawn
  again (seed + 1) and compared once more (`redraws`).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from quantized_spectrum_cartography_tpu_torch.conditions_pool import (
    add_spread,
    add_stack_deltas,
    by_label_rows,
    compare_grids,
    dump_json,
    pool_results,
    pooled_rule,
    r_axis_check,
)
from quantized_spectrum_cartography_tpu_torch.config import set_card_numerics
from quantized_spectrum_cartography_tpu_torch.published_sre import (
    PUBLISHED,
    device_info,
)

ROOT = Path(__file__).resolve().parents[1]
AXES = ("fraction", "num_emitters", "shadow_sigma", "xc", "snr")
# the gated C polish of the six-method registry (the tool's defaults)
POLISH = dict(polish_ridge=0.1, polish_gamma=0.75, polish_peaks_extra=2)
PLAIN = dict(only=("nasdac", "dowjons"), anchor_mu0=0.0, peak_refine=0,
             backstop_frac=0.0, polish_ridge=0.0)


def harnesses(device: str, polish: dict, log_fn=None):
    """(the six-method harness with `polish`, the plain harness)."""
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        BatchedHarness, load_pretrained_methods)

    stack = BatchedHarness(load_pretrained_methods(device=device, **polish),
                           log_fn=log_fn, device=device)
    plain = load_pretrained_methods(device=device, **PLAIN)
    plain = BatchedHarness({f"{k}_plain": v for k, v in plain.items()},
                           log_fn=log_fn, device=device)
    return stack, plain


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_condition(stack, plain, cond, examples: int, seed: int, device):
    """One condition through both registries: (the draw's row with each
    method's spread and the stack deltas, wall seconds, each method's
    seconds)."""
    label = cond.label()
    _sync(device)
    t0 = time.perf_counter()
    row = add_spread(stack.run((cond,), num_examples=examples,
                               seed=seed)[label])
    row.update(add_spread(plain.run((cond,), num_examples=examples,
                                    seed=seed)[label]))
    _sync(device)
    wall = time.perf_counter() - t0
    seconds = {**stack.seconds[label], **plain.seconds[label]}
    return add_stack_deltas(row), wall, seconds


def grid_document(draws: dict, examples: int, seed: int) -> dict:
    """The pooled-layout document of one draw's rows ({label: row}) and
    its R-axis verdict."""
    results = pool_results([{"results": draws}], keep_sre_all=3)
    return {"results": results,
            "r_axis_regression_check": r_axis_check(results,
                                                    pooled_rule(examples)),
            "num_examples_pooled": examples, "seeds": [seed]}


def main(argv=None):
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        condition_grid)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--examples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--axis", nargs="+", choices=AXES, default=list(AXES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    p.add_argument("--polish-ridge", type=float,
                   default=POLISH["polish_ridge"])
    p.add_argument("--polish-gamma", type=float,
                   default=POLISH["polish_gamma"])
    p.add_argument("--polish-peaks", type=int,
                   default=POLISH["polish_peaks_extra"])
    p.add_argument("--reference", default=str(ROOT / "CONDITIONS_POOLED.json"))
    p.add_argument("--reference-draws", nargs="+",
                   default=[str(ROOT / "CONDITIONS.json"),
                            str(ROOT / "CONDITIONS_seed1.json")])
    args = p.parse_args(argv)
    if os.path.basename(args.out) in ("CONDITIONS.json",
                                      "CONDITIONS_POOLED.json"):
        p.error(f"{args.out} is the JAX package's; write the port's grid "
                "elsewhere (e.g. CONDITIONS_TORCH.json)")
    t_start = time.time()

    def log(*a):
        print(f"[{time.time() - t_start:7.1f}s]", *a, flush=True)

    if torch.device(args.device).type == "cuda":
        set_card_numerics()
    polish = dict(polish_ridge=args.polish_ridge,
                  polish_gamma=args.polish_gamma,
                  polish_peaks_extra=args.polish_peaks)
    stack, plain = harnesses(args.device, polish, log)
    with open(args.reference) as f:
        reference = json.load(f)["results"]
    ref_draws = []
    for path in args.reference_draws:
        with open(path) as f:
            ref_draws.append(json.load(f))

    draws, walls, seconds = {}, {}, {}
    part = args.out + ".part"

    def document():
        doc = {
            "what": (f"the {len(draws)}-condition grid of the PyTorch port, "
                     f"{args.examples} examples per condition in one "
                     f"BatchedHarness batch (seed {args.seed}), in the "
                     "layout of the JAX package's CONDITIONS_POOLED.json "
                     "(per-example SREs kept to 3 decimals)"),
            "protocol": "tools/conditions_tpu.py + tools/conditions_pool.py "
                        "of the JAX package (joint_opt_ae.m:11-25, 82-117)",
            "axes": {a: [c.label() for c in condition_grid(a)]
                     for a in args.axis},
            "polish_config": polish,
            **grid_document(draws, args.examples, args.seed),
            "per_condition_wall_seconds": walls,
            "per_method_seconds": seconds,
            "published_base_sre": PUBLISHED,
            "device": device_info(args.device),
            "total_wall_seconds": round(time.time() - t_start, 1),
        }
        dump_json(doc, part)
        return doc

    for axis in args.axis:
        for cond in condition_grid(axis):
            label = cond.label()
            if label in draws:
                continue
            draws[label], walls[label], seconds[label] = run_condition(
                stack, plain, cond, args.examples, args.seed, args.device)
            log(f"condition done in {walls[label]:.1f} s: {label}")
            for m in ("nasdac", "dowjons"):
                d = draws[label].get(f"{m}_stack_delta")
                if d:
                    log(f"  {m} stack-vs-plain: dSRE {d['sre']:+.4f} "
                        f"dmiss {d['miss_prob']:+.4f} "
                        f"dfalse {d['false_prob']:+.4f}")
            document()

    doc = document()
    rows = compare_grids(doc["results"], reference, ref_draws)
    for r in rows:
        log(f"z {r['z']:+7.3f} {'ok ' if r['in_band'] else 'OUT'} "
            f"{r['label']} {r['method']}: port {r['port']:.4f} "
            f"(n {r['n_port']}) JAX {r['ref']:.4f} (n {r['n_ref']})")
    out = [(r["label"], r["method"]) for r in rows if not r["in_band"]]
    redraws = {}
    by_label = {c.label(): c for a in args.axis for c in condition_grid(a)}
    for label in sorted({lab for lab, _ in out}):
        row, wall, _ = run_condition(stack, plain, by_label[label],
                                     args.examples, args.seed + 1,
                                     args.device)
        again = compare_grids(grid_document({label: row}, args.examples,
                                            args.seed + 1)["results"],
                              reference, ref_draws)
        redraws[label] = {"seed": args.seed + 1, "wall_seconds": wall,
                          "rows": by_label_rows(again)[label]}
        for r in again:
            log(f"redraw z {r['z']:+7.3f} "
                f"{'ok ' if r['in_band'] else 'OUT'} {label} "
                f"{r['method']}: port {r['port']:.4f} JAX {r['ref']:.4f}")
    doc["comparison"] = {
        "reference": os.path.relpath(args.reference, ROOT),
        "reference_draws": [os.path.relpath(p_, ROOT)
                            for p_ in args.reference_draws],
        "rule": "|z| <= 3, z = (port - JAX) / sqrt(sd_p^2/n_p + "
                "sd_j^2/n_j) on the SRE means, n the valid counts; BTD on "
                "its SRE < 3 examples on both sides, JAX's from its draws; "
                "a row out of band is drawn again (seed + 1) and persists "
                "if it is out of band there too",
        "rows": by_label_rows(rows),
        "out_of_band": [list(x) for x in out],
        "redraws": redraws,
        "persistent": [[lab, m, redraws[lab]["rows"][m]["z"]]
                       for lab, m in out
                       if not redraws[lab]["rows"][m]["in_band"]],
    }
    doc["total_wall_seconds"] = round(time.time() - t_start, 1)
    dump_json(doc, part)
    os.replace(part, args.out)
    check = doc["r_axis_regression_check"]
    log(f"grid complete: {len(draws)} conditions, "
        f"{doc['total_wall_seconds']} s; R-axis check "
        f"{'PASS' if check['pass'] else 'FAIL'} "
        f"{check['violations'] or ''}; {len(rows)} rows compared, "
        f"{len(doc['comparison']['out_of_band'])} out of band, "
        f"{len(doc['comparison']['persistent'])} of them again in the "
        f"redraw; "
        f"wrote {args.out}")
    if not check["pass"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
