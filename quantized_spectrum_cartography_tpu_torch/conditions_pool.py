"""Summaries, pooling and checks of condition-grid draws.

    python -m quantized_spectrum_cartography_tpu_torch.conditions_pool \\
        CONDITIONS.json CONDITIONS_seed1.json --out POOLED.json

The logic of the JAX package's ``tools/conditions_tpu.py`` (a draw's
per-condition spread and stack-vs-plain deltas, the R-axis regression
rule) and ``tools/conditions_pool.py`` (independent draws pooled: SRE
mean, median and spread over the concatenated per-example SREs; miss and
false-alarm rates from the summed event counts with the reference's
(total+1) denominators, `joint_opt_ae.m:549-554`; NAE means weighted by
the valid counts), as functions, plus the comparison of two grids by
label that `conditions_grid.py` applies to the port's.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

STAT_KEYS = ("miss_count", "peak_count", "false_count", "low_count",
             "valid")
STACKED = ("nasdac", "dowjons")
R_AXIS_RULE = ("stack vs plain at every R in {5..13}: dmiss <= 0.02 and "
               "dSRE <= 0.05")
BTD_CAP = 3.0          # the harness's validity cap (joint_opt_ae.m:496-501)
Z_LIMIT = 3.0


def _dumps(x, depth: int = 0) -> str:
    items = x.items() if isinstance(x, dict) else x
    if not isinstance(x, (dict, list)) or not any(
            isinstance(v, (dict, list))
            for v in (x.values() if isinstance(x, dict) else x)):
        return json.dumps(x)
    pad = " " * (depth + 1)
    if isinstance(x, dict):
        # a non-string key as json.dumps writes it ({0: ..} -> {"0": ..})
        lines = [f"{pad}{json.dumps(k if isinstance(k, str) else str(k))}: "
                 f"{_dumps(v, depth + 1)}" for k, v in items]
        return "{\n" + ",\n".join(lines) + "\n" + " " * depth + "}"
    lines = [pad + _dumps(v, depth + 1) for v in items]
    return "[\n" + ",\n".join(lines) + "\n" + " " * depth + "]"


def dump_json(doc, path: str) -> None:
    """`doc` to `path` as indented JSON, each container that holds no
    other container on one line."""
    with open(path, "w") as f:
        f.write(_dumps(doc) + "\n")


def add_spread(stats: Dict[str, dict]) -> Dict[str, dict]:
    """A draw's per-method SRE standard deviation and median from its
    per-example SREs (in place; conditions_tpu.py:add_spread)."""
    for st in stats.values():
        arr = np.asarray(st.get("sre_all", []), dtype=np.float64)
        if arr.size:
            st["sre_std"] = round(float(arr.std()), 4)
            st["sre_median"] = round(float(np.median(arr)), 4)
    return stats


def add_stack_deltas(row: Dict[str, dict]) -> Dict[str, dict]:
    """`<m>_stack_delta` = stack minus plain for nasdac and dowjons (in
    place): SRE, miss and false-alarm rates, rounded to 4 decimals."""
    for m in STACKED:
        pk = f"{m}_plain"
        if m in row and pk in row:
            row[f"{m}_stack_delta"] = {
                key: round(row[m][key] - row[pk][key], 4)
                for key in ("sre", "miss_prob", "false_prob")}
    return row


def _is_r_axis(label: str) -> bool:
    return label.split()[1] != "R=2"


def r_axis_check(results: Dict[str, dict], rule: str = R_AXIS_RULE) -> dict:
    """The R-axis regression verdict: at every condition with R != 2 the
    stack minus plain has dmiss <= 0.02 and dSRE <= 0.05."""
    viol = []
    for lab, row in results.items():
        if not _is_r_axis(lab):
            continue
        for m in STACKED:
            d = row.get(f"{m}_stack_delta")
            if d and (d["miss_prob"] > 0.02 or d["sre"] > 0.05):
                viol.append([lab, m, d])
    return {"rule": rule, "violations": viol, "pass": not viol}


def pool_rows(rows: Sequence[Dict[str, dict]],
              keep_sre_all: Optional[int] = None) -> Dict[str, dict]:
    """One condition's rows from independent draws, pooled
    (conditions_pool.py); `keep_sre_all` keeps the concatenated
    per-example SREs rounded to that many decimals."""
    row = {}
    for m in [m for m in rows[0] if not m.endswith("_stack_delta")]:
        sts = [r[m] for r in rows]
        sre_all = np.concatenate([np.asarray(st["sre_all"], np.float64)
                                  for st in sts])
        valid = sum(st["valid"] for st in sts)
        counts = {k: sum(st[k] for st in sts) for k in STAT_KEYS}
        nae_s = sum(st["nae_s"] * st["valid"] for st in sts) / max(valid, 1)
        nae_c = sum(st["nae_c"] * st["valid"] for st in sts) / max(valid, 1)
        row[m] = {
            "sre": round(float(sre_all.mean()), 4),
            "sre_std": round(float(sre_all.std()), 4),
            "sre_median": round(float(np.median(sre_all)), 4),
            "nae_s": round(nae_s, 4),
            "nae_c": round(nae_c, 4),
            "miss_prob": round(counts["miss_count"]
                               / (counts["peak_count"] + 1), 4),
            "false_prob": round(counts["false_count"]
                                / (counts["low_count"] + 1), 4),
            **counts,
        }
        if keep_sre_all is not None:
            row[m]["sre_all"] = [round(float(v), keep_sre_all)
                                 for v in sre_all]
    return add_stack_deltas(row)


def pool_results(docs: Sequence[dict],
                 keep_sre_all: Optional[int] = None) -> Dict[str, dict]:
    """{label: pooled row} over the labels every draw holds."""
    labels = [lab for lab in docs[0]["results"]
              if all(lab in d["results"] for d in docs)]
    return {lab: pool_rows([d["results"][lab] for d in docs], keep_sre_all)
            for lab in labels}


def pooled_rule(n: int) -> str:
    return f"{R_AXIS_RULE} (pooled {n} examples/condition)"


def pool_documents(docs: Sequence[dict], paths: Sequence[str]) -> dict:
    """The JAX package's CONDITIONS_POOLED.json document from its draws."""
    seeds = [d.get("seed", 0) for d in docs]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds pooled: {seeds}")
    n = sum(d["num_examples"] for d in docs)
    pooled = pool_results(docs)
    return {
        "what": f"{len(docs)} independent {docs[0]['num_examples']}-example "
                "draws of the full 25-condition grid pooled to "
                f"{n} examples/condition "
                "(concatenated per-example SREs; summed event counts; "
                "valid-weighted NAE means)",
        "why_pooled": "the direct 64-example batch reproducibly faults the "
                      "TPU worker at the f=0.20 condition (same crash "
                      "point, two runs); batch-32 shapes are stable",
        "inputs": list(paths),
        "seeds": seeds,
        "num_examples_pooled": n,
        "polish_config": docs[0].get("polish_config"),
        "results": pooled,
        "r_axis_regression_check": r_axis_check(pooled, pooled_rule(n)),
    }


def sre_sample(row: dict, method: str, draws: Sequence[dict] = (),
               label: Optional[str] = None):
    """(mean, sd, n) of a row's SRE for the comparison: BTD over its valid
    examples (SRE < 3) of `sre_all`, from `row` or, where the row keeps no
    per-example SREs (the JAX pooled document), from the draws `draws`
    under `label`; the others over all examples, from the row's mean and
    spread and its valid count."""
    if method == "btd":
        if "sre_all" in row:
            sre = np.asarray(row["sre_all"], np.float64)
        else:
            sre = np.concatenate([np.asarray(
                d["results"][label][method]["sre_all"], np.float64)
                for d in draws])
        sre = sre[sre < BTD_CAP]
        return float(sre.mean()), float(sre.std()), int(sre.size)
    return row["sre"], row["sre_std"], row["valid"]


def compare_grids(port: Dict[str, dict], ref: Dict[str, dict],
                  ref_draws: Sequence[dict] = ()) -> List[dict]:
    """Per (label, row) of `port` that `ref` holds: the SRE means, the
    z-score (port - ref) / sqrt(sd_p^2/n_p + sd_r^2/n_r) and whether
    |z| <= 3.  BTD is valid-only on both sides (`sre_sample`)."""
    out = []
    for lab, row in port.items():
        for m, st in row.items():
            if m.endswith("_stack_delta") or m not in ref.get(lab, {}):
                continue
            mp, sp, n_p = sre_sample(st, m)
            mj, sj, n_j = sre_sample(ref[lab][m], m, ref_draws, lab)
            se = math.sqrt(sp * sp / n_p + sj * sj / n_j)
            z = (mp - mj) / se if se > 0 else (0.0 if mp == mj
                                               else math.inf)
            out.append({"label": lab, "method": m,
                        "port": round(mp, 4), "ref": round(mj, 4),
                        "n_port": n_p, "n_ref": n_j, "z": round(z, 3),
                        "in_band": abs(z) <= Z_LIMIT})
    return out


def by_label_rows(rows: Sequence[dict]) -> Dict[str, Dict[str, dict]]:
    """`compare_grids`'s rows as {label: {method: row without the two}}."""
    out: Dict[str, Dict[str, dict]] = {}
    for r in rows:
        out.setdefault(r["label"], {})[r["method"]] = {
            k: v for k, v in r.items() if k not in ("label", "method")}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+", help="condition-grid draws (JSON)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    docs = []
    for path in args.inputs:
        with open(path) as f:
            docs.append(json.load(f))
    out = pool_documents(docs, args.inputs)
    dump_json(out, args.out)
    check = out["r_axis_regression_check"]
    print("R-axis check:", "PASS" if check["pass"]
          else f"FAIL {check['violations']}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
