"""Pool miss-detection draws of several seeds, and hold the pooled rates
against the JAX package's.

    python -m quantized_spectrum_cartography_tpu_torch.missprob_pool_seeds \\
        build/missprob/MISSPROB_seed{0,1,2,3,4}.json --out MISSPROB_TORCH.json

The logic of the JAX package's ``tools/missprob_pool_seeds.py`` as
functions: the raw event counts summed over the draws, the pooled per-rho
miss and false-alarm rates with the reference's (total+1) denominators, the
verdict against the published rows and the false-alarm guard on the
pooled rates.  `main` adds the comparison with the JAX package's pooled
draws (`--reference`, its five MISSPROB*.json): per method and rho,
|p_port - p_jax| <= 3 sqrt(p(1 - p)(1/N_port + 1/N_jax)), p the two draws'
misses over their peaks together, N each side's summed peak count; and the
same at the level of the draws (`draw_level`), whose spread shows how far
the binomial band understates the draws' own.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from quantized_spectrum_cartography_tpu_torch.conditions_pool import dump_json
from quantized_spectrum_cartography_tpu_torch.missprob import (
    FALSE_ABS,
    FALSE_RATIO,
    PUBLISHED,
)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = [str(ROOT / "MISSPROB.json")] + [
    str(ROOT / f"MISSPROB_seed{s}.json") for s in range(1, 5)]
Z_LIMIT = 3.0


def summed_events(docs: Sequence[dict], method: str) -> Dict[str, np.ndarray]:
    """Per-rho sums of the draws' miss / peaks / false / lows counts."""
    n = len(docs[0]["events"][method])
    out = {k: np.zeros(n) for k in ("miss", "peaks", "false", "lows")}
    for d in docs:
        for i, e in enumerate(d["events"][method]):
            for k in out:
                out[k][i] += e[k]
    return out


def pool(docs: Sequence[dict]) -> dict:
    """The pooled document of missprob_pool_seeds.py (per-seed curves,
    pooled miss rates and verdicts, pooled false-alarm rates and guard)."""
    out = {"per_seed": {}, "pooled": {}, "false_pooled": {}}
    for s, d in enumerate(docs):
        out["per_seed"][s] = {m: [round(v, 4) for v in d["ours"][m]]
                              for m in d["ours"]}
    pooled_pass = True
    for m in PUBLISHED:
        ev = summed_events(docs, m)
        rate = ev["miss"] / (ev["peaks"] + 1)
        ok = bool(np.all(rate <= np.asarray(PUBLISHED[m]) + 1e-9))
        pooled_pass &= ok
        out["pooled"][m] = {"miss_rates": [round(float(v), 4)
                                           for v in rate],
                            "published": PUBLISHED[m], "pass": ok}
        out["false_pooled"][m] = [round(float(v), 4)
                                  for v in ev["false"] / (ev["lows"] + 1)]
    base = np.asarray(out["false_pooled"]["deepcomp"])
    bound = np.maximum(FALSE_RATIO * base, base + FALSE_ABS)
    fpass = all(bool(np.all(np.asarray(out["false_pooled"][m])
                            <= bound + 1e-9))
                for m in ("nasdac", "dowjons"))
    out["pooled_all_match_or_beat"] = pooled_pass
    out["pooled_false_guard_pass"] = fpass
    out["per_seed_all_match_or_beat"] = {s: d["all_match_or_beat"]
                                         for s, d in enumerate(docs)}
    return out


def binomial_bands(port: Sequence[dict], ref: Sequence[dict]) -> List[dict]:
    """Per method and rho: both pooled miss rates, the band 3 sqrt(p(1-p)
    (1/N_p + 1/N_j)) and whether the difference lies in it."""
    rows = []
    for m in PUBLISHED:
        ep, ej = summed_events(port, m), summed_events(ref, m)
        for i in range(len(ep["miss"])):
            n_p, n_j = ep["peaks"][i], ej["peaks"][i]
            p_p = ep["miss"][i] / (n_p + 1)
            p_j = ej["miss"][i] / (n_j + 1)
            p = (ep["miss"][i] + ej["miss"][i]) / (n_p + n_j)
            band = Z_LIMIT * math.sqrt(p * (1 - p) * (1 / n_p + 1 / n_j))
            rows.append({"method": m, "rho_index": i,
                         "port": round(float(p_p), 4),
                         "jax": round(float(p_j), 4),
                         "n_port": int(n_p), "n_jax": int(n_j),
                         "band": round(band, 4),
                         "in_band": bool(abs(p_p - p_j) <= band + 1e-12)})
    return rows


def draw_level(port: Sequence[dict], ref: Sequence[dict]) -> List[dict]:
    """Per method and rho, the draws as the samples: each side's per-draw
    miss rates, t = (mean_p - mean_j) / sqrt(sd_p^2/n_p + sd_j^2/n_j) over
    the n draws, and the between-draw spread over a draw's binomial
    spread at the pooled rate (misses cluster within an example, so the
    binomial band understates how far two draws part)."""
    rows = []
    for m in PUBLISHED:
        for i in range(len(port[0]["events"][m])):
            def rates(docs):
                return np.asarray([d["events"][m][i]["miss"]
                                   / (d["events"][m][i]["peaks"] + 1)
                                   for d in docs])

            rp, rj = rates(port), rates(ref)
            se = math.sqrt(rp.var(ddof=1) / rp.size
                           + rj.var(ddof=1) / rj.size)
            t = (rp.mean() - rj.mean()) / se if se > 0 else 0.0
            ep, ej = summed_events(port, m), summed_events(ref, m)
            n = (ep["peaks"][i] + ej["peaks"][i]) / (rp.size + rj.size)
            p = (ep["miss"][i] + ej["miss"][i]) / (n * (rp.size + rj.size))
            spread = math.sqrt((rp.var(ddof=1) + rj.var(ddof=1)) / 2)
            binom = math.sqrt(p * (1 - p) / n)
            rows.append({"method": m, "rho_index": i,
                         "port_draws": [round(float(v), 4) for v in rp],
                         "jax_draws": [round(float(v), 4) for v in rj],
                         "t": round(float(t), 3),
                         "overdispersion": (round(spread / binom, 2)
                                            if binom > 0 else None),
                         "in_band": bool(abs(t) <= Z_LIMIT)})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+", help="the port's per-seed draws")
    p.add_argument("--reference", nargs="+", default=REFERENCE,
                   help="the JAX package's per-seed draws")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    def load(paths):
        out = []
        for path in paths:
            with open(path) as f:
                out.append(json.load(f))
        return out

    docs, ref = load(args.inputs), load(args.reference)
    out = {"what": f"{len(docs)} independent "
                   f"{docs[0]['num_examples']}-example Monte-Carlo draws of "
                   "the miss-detection protocol on the PyTorch port; "
                   "per-seed curves, the pooled estimate (event counts "
                   "summed, reference (total+1) denominators), verdicts, "
                   "and the binomial comparison with the JAX package's "
                   "pooled draws.",
           "inputs": [Path(x).name for x in args.inputs],
           **pool(docs),
           "wall_seconds_per_draw": [d["wall_seconds"] for d in docs],
           "device": docs[0].get("device")}
    rows, draws = binomial_bands(docs, ref), draw_level(docs, ref)
    out["comparison"] = {
        "reference": [Path(x).name for x in args.reference],
        "rule": "|p_port - p_jax| <= 3 sqrt(p (1 - p) (1/N_port + "
                "1/N_jax)), p = misses / peaks of both together, N the "
                "summed peak counts",
        "rows": rows,
        "all_in_band": all(r["in_band"] for r in rows),
        "draw_level": {
            "rule": "|t| <= 3, t = (mean_port - mean_jax) / sqrt(sd_p^2/n_p "
                    "+ sd_j^2/n_j) over the per-draw miss rates; "
                    "overdispersion = between-draw sd / a draw's binomial "
                    "sd",
            "rows": draws,
            "all_in_band": all(r["in_band"] for r in draws)}}
    dump_json(out, args.out)
    for m, row in out["pooled"].items():
        print(m, "pooled", row["miss_rates"], "PASS" if row["pass"]
              else "FAIL", "false", out["false_pooled"][m])
    print("false guard", "PASS" if out["pooled_false_guard_pass"] else "FAIL")
    for r in rows:
        print(f"{r['method']:9s} rho#{r['rho_index']} port {r['port']:.4f} "
              f"JAX {r['jax']:.4f} band {r['band']:.4f} "
              f"{'ok' if r['in_band'] else 'OUT'}")
    for r in draws:
        print(f"{r['method']:9s} rho#{r['rho_index']} draw-level t "
              f"{r['t']:+.2f} overdispersion {r['overdispersion']} "
              f"{'ok' if r['in_band'] else 'OUT'}")
    print(f"wrote {args.out}; binomial bands all in: "
          f"{out['comparison']['all_in_band']}; draw level all in: "
          f"{out['comparison']['draw_level']['all_in_band']}")


if __name__ == "__main__":
    main()
