"""The rho = 5% figure-caption anchors of the evaluation, on the port.

    python -m quantized_spectrum_cartography_tpu_torch.figure_anchors \\
        --examples 64 --out FIGURE_ANCHORS_TORCH.json [--device cuda]

The counterpart of the JAX package's ``tools/figure_anchors_tpu.py``.  The
reference's rho = 5% figure hardcodes single-example captions
(`backup/algorithms/joint_opt_ae.m:721-826`: map SRE, and per emitter NAE_S
and NAE_C, for Nasdac and DowJons), so the comparison is distributional:
the base condition (f=0.05, R=2, shadow sigma 5, Xc 50, sinc basis,
noiseless), `--examples` Monte-Carlo examples in one batch through
`load_pretrained_methods(only=("nasdac", "dowjons"))`, the per-example map
SRE and the per-emitter NAE_S / NAE_C after Hungarian factor matching
(`best_permutation`; the figure's NAE with R=1), with mean / median /
best / p90 and the verdicts against each anchor.  Three diagnostics: the
C refit on the true S over the observed entries (`oracle_c`, NNLS; the
C-fit noise floor), the smooth-estimator NAE_S floor (the simulator's
path-loss kernel at the true peak, best alpha) and the AE-manifold floor
(the completion AE on the fully observed true SLF).

The gate, per method, against the JAX package's FIGURE_ANCHORS.json: the
mean map SRE and the mean per-emitter NAE_C within 3 sqrt(se_port^2 +
se_jax^2) (3 sqrt 2 standard errors where the two are alike), the standard
errors from each side's per-example values (JAX's from its
sre_map_sorted / nae_c_sorted); NAE_S is reported with z on the port's
standard error alone (JAX's artifact keeps no per-example NAE_S).  A method
out of band is drawn again at seed + 1 and both draws are recorded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    PhysicsConfig,
    set_card_numerics,
)
from quantized_spectrum_cartography_tpu_torch.published_sre import device_info
from quantized_spectrum_cartography_tpu_torch.utils.profiling import sync_device

# joint_opt_ae.m:721-826, the rho = 5% figure's captions
ANCHORS = {
    "nasdac": {"sre_map": 0.0840, "nae_s": [0.2230, 0.2212],
               "nae_c": [0.0055, 0.5542]},
    "dowjons": {"sre_map": 0.0850, "nae_s": [0.2452, 0.2089],
                "nae_c": [0.010, 0.0510]},
}
METHODS = ("nasdac", "dowjons")
ROOT = Path(__file__).resolve().parents[1]
REFERENCE = str(ROOT / "FIGURE_ANCHORS.json")
Z_LIMIT = 3.0
ORACLE_NNLS_ITERS = 200


def nae_np(a: np.ndarray, b: np.ndarray) -> float:
    """The figure's per-factor NAE: both L1-normalized, summed |a - b|."""
    a = a / max(np.sum(np.abs(a)), 1e-12)
    b = b / max(np.sum(np.abs(b)), 1e-12)
    return float(np.sum(np.abs(a - b)))


def stats(v) -> dict:
    v = np.asarray(v, dtype=np.float64)
    return {"mean": round(float(v.mean()), 4),
            "median": round(float(np.median(v)), 4),
            "best": round(float(v.min()), 4),
            "p90": round(float(np.percentile(v, 90)), 4),
            "n": int(v.size)}


def per_example(T_hat, S_hat, C_hat, T_true, S_true, C_true):
    """(map SRE per example, NAE_S and NAE_C per emitter) after Hungarian
    matching of S_hat's rows to S_true's; numpy arrays [B, ...]."""
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        best_permutation)

    sres, naes_s, naes_c = [], [], []
    for b in range(T_true.shape[0]):
        sres.append(float(np.sum((T_hat[b] - T_true[b]) ** 2)
                          / np.sum(T_true[b] ** 2)))
        perm = best_permutation(S_hat[b], S_true[b])
        for r in range(S_true.shape[1]):
            naes_s.append(nae_np(S_true[b][r], S_hat[b][perm][r]))
            naes_c.append(nae_np(C_true[b][r], C_hat[b][perm][r]))
    return sres, naes_s, naes_c


def method_row(name: str, sres, naes_s, naes_c) -> dict:
    """One method's row in FIGURE_ANCHORS.json's layout."""
    anch = ANCHORS[name]
    pub_s, pub_c = anch["nae_s"], anch["nae_c"]
    return {
        "published_single_example": anch,
        "sre_map": stats(sres),
        "nae_s_per_emitter": stats(naes_s),
        "nae_c_per_emitter": stats(naes_c),
        "sre_map_sorted": [round(v, 4) for v in sorted(sres)],
        "nae_c_sorted": [round(v, 4) for v in sorted(naes_c)],
        "nae_s_sorted": [round(v, 4) for v in sorted(naes_s)],
        "verdicts": {
            "sre_vs_anchor": {
                "anchor": anch["sre_map"],
                "median_beats": bool(np.median(sres) < anch["sre_map"]),
                "best_beats": bool(min(sres) < anch["sre_map"]),
                "frac_examples_below_anchor": round(float(np.mean(
                    np.asarray(sres) < anch["sre_map"])), 3),
            },
            "nae_s_vs_anchors": {
                "anchors": pub_s,
                "median_vs_published_mean": [
                    round(float(np.median(naes_s)), 4),
                    round(float(np.mean(pub_s)), 4)],
                "median_beats_published_mean": bool(
                    np.median(naes_s) < np.mean(pub_s)),
            },
            "nae_c_vs_anchors": {
                "anchors": pub_c,
                "median_vs_published_mean": [
                    round(float(np.median(naes_c)), 4),
                    round(float(np.mean(pub_c)), 4)],
                "median_beats_published_mean": bool(
                    np.median(naes_c) < np.mean(pub_c)),
                "frac_emitters_below_larger_anchor": round(float(np.mean(
                    np.asarray(naes_c) < max(pub_c))), 3),
            },
        },
    }


def oracle_c(S_true: torch.Tensor, Om: torch.Tensor,
             T_obs: torch.Tensor) -> torch.Tensor:
    """C [B, R, K] refit by NNLS on the true S over the observed entries
    only (figure_anchors_tpu.py:169): the C-fit noise floor."""
    from quantized_spectrum_cartography_tpu_torch.baselines.nnls import (
        nnls_rows)

    W = Om.to(T_obs.dtype).flatten(-2)[..., None, :]               # [B, 1, IJ]
    design = (S_true.flatten(-2) * W).transpose(-1, -2)            # [B, IJ, R]
    targ = T_obs.flatten(-2) * W                                   # [B, K, IJ]
    return nnls_rows(design, targ, iters=ORACLE_NNLS_ITERS).transpose(-1, -2)


def smooth_floor(S_true: np.ndarray, peaks: np.ndarray) -> List[float]:
    """Per emitter, the NAE_S of the simulator's path-loss kernel
    min(1, (d/2)^-alpha) at the true peak, best alpha of 2..2.5
    (figure_anchors_tpu.py:210): shadow texture alone forces this much."""
    I, J = S_true.shape[-2:]
    yy = np.arange(I, dtype=np.float64)[:, None]
    xx = np.arange(J, dtype=np.float64)[None, :]
    out = []
    for b in range(S_true.shape[0]):
        for r in range(S_true.shape[1]):
            px, py = peaks[b, r]
            d = np.sqrt((yy - py) ** 2 + (xx - px) ** 2)
            out.append(min(
                nae_np(S_true[b][r],
                       np.minimum((np.maximum(d, 1e-6) / 2.0) ** -alpha, 1.0))
                for alpha in np.linspace(2.0, 2.5, 11)))
    return out


def ae_floor(ae_complete, S_true: torch.Tensor) -> List[float]:
    """Per emitter, the NAE_S of the completion AE re-encoding the fully
    observed true SLF (figure_anchors_tpu.py:237)."""
    with torch.no_grad():
        S_ae = ae_complete(torch.ones_like(S_true), S_true)
    S_ae, S_t = S_ae.cpu().numpy(), S_true.cpu().numpy()
    return [nae_np(S_t[b][r], S_ae[b][r]) for b in range(S_t.shape[0])
            for r in range(S_t.shape[1])]


def _z(diff: float, se: float):
    """diff / se rounded; None where se is 0 and diff is not."""
    if se > 0:
        return round(diff / se, 3)
    return 0.0 if diff == 0 else None


def _mean_se(v) -> tuple:
    v = np.asarray(v, dtype=np.float64)
    return float(v.mean()), float(v.std(ddof=1) / math.sqrt(v.size))


def gate(row: dict, ref_row: dict, raw: dict) -> dict:
    """The port's means against JAX's: z = (mean_p - mean_j) /
    sqrt(se_p^2 + se_j^2) for the map SRE and NAE_C (both sides'
    per-example lists), NAE_S on the port's standard error alone."""
    out = {}
    for key, sorted_key in (("sre_map", "sre_map_sorted"),
                            ("nae_c", "nae_c_sorted")):
        mp, sp = _mean_se(raw[key])
        mj, sj = _mean_se(ref_row[sorted_key])
        z = _z(mp - mj, math.sqrt(sp ** 2 + sj ** 2))
        out[key] = {"port": round(mp, 4), "jax": round(mj, 4),
                    "se_port": round(sp, 5), "se_jax": round(sj, 5),
                    "z": z, "in_band": z is not None and abs(z) <= Z_LIMIT}
    mp, sp = _mean_se(raw["nae_s"])
    mj = ref_row["nae_s_per_emitter"]["mean"]
    out["nae_s"] = {"port": round(mp, 4), "jax": mj, "se_port": round(sp, 5),
                    "z_on_port_se": _z(mp - mj, sp), "gated": False}
    out["pass"] = out["sre_map"]["in_band"] and out["nae_c"]["in_band"]
    return out


def draw(methods, examples: int, seed: int, device) -> Dict:
    """One draw: the base condition's `examples` problems (the harness's
    generator at seed * 100000, as BatchedHarness.run seeds its first
    condition), each method once on the batch, and the per-example
    statistics.  Returns {"hp": problem, "raw": {method: lists},
    "outputs": {method: its T_hat, S_hat, C_hat}, "seconds": {method:
    s}}."""
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        Condition, _method_generator, _run, make_problem)
    from quantized_spectrum_cartography_tpu_torch.physics.shadowing import (
        correlation_cholesky)

    cond, physics = Condition(), PhysicsConfig()
    base = seed * 100_000
    chol = torch.as_tensor(correlation_cholesky(physics.grid_size,
                                                float(cond.xc)),
                           device=device)
    hp = make_problem(torch.Generator(device=device).manual_seed(base), cond,
                      physics, examples, device, chol)
    hp = dataclasses.replace(hp, sample_idx=None)
    truth = [hp.T_true.cpu().numpy(), hp.S_true.cpu().numpy(),
             hp.C_true.cpu().numpy()]
    raw, outputs, seconds = {}, {}, {}
    for name, fn in methods.items():
        sync_device(device)
        t0 = time.perf_counter()
        res = _run(fn, _method_generator(device, base, name), hp)
        sync_device(device)
        seconds[name] = time.perf_counter() - t0
        sres, naes_s, naes_c = per_example(
            *(res[k].cpu().numpy() for k in ("T_hat", "S_hat", "C_hat")),
            *truth)
        raw[name] = {"sre_map": sres, "nae_s": naes_s, "nae_c": naes_c}
        outputs[name] = res
    return {"hp": hp, "raw": raw, "outputs": outputs, "seconds": seconds}


def diagnostics(hp, ae_complete) -> dict:
    """The oracle-S C refit and the two NAE_S floors on a draw's problems."""
    C_or = oracle_c(hp.S_true, hp.Om, hp.T_obs).cpu().numpy()
    C_true = hp.C_true.cpu().numpy()
    oracle = [nae_np(C_true[b][r], C_or[b][r])
              for b in range(C_true.shape[0]) for r in range(C_true.shape[1])]
    return {
        "oracle_s_cfit": {
            "what": "NNLS C refit on the TRUE S design over observed "
                    "entries only: the C-fit noise floor at ~130 samples",
            "nae_c_per_emitter": stats(oracle)},
        "oracle_smooth_naes_floor": {
            "what": "NAE_S of the oracle path-loss kernel (true peak, best "
                    "alpha) vs the true shadowed SLF: the smooth-estimator "
                    "floor",
            "nae_s_per_emitter": stats(smooth_floor(
                hp.S_true.cpu().numpy(), hp.peaks.cpu().numpy()))},
        "oracle_ae_manifold_floor": {
            "what": "NAE_S of the completion AE re-encoding the fully "
                    "observed true SLF (mask=1): the AE-manifold floor",
            "nae_s_per_emitter": stats(ae_floor(ae_complete, hp.S_true))},
    }


def main(argv=None):
    from quantized_spectrum_cartography_tpu_torch.baselines import (
        load_pretrained_methods, pretrained)
    from quantized_spectrum_cartography_tpu_torch.training.ae_trainer import (
        load_ae, make_ae_completer)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--examples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if os.path.basename(args.out) == "FIGURE_ANCHORS.json":
        p.error("FIGURE_ANCHORS.json is the JAX package's; write the port's "
                "elsewhere (e.g. FIGURE_ANCHORS_TORCH.json)")
    t0 = time.time()

    def log(*a):
        print(f"[{time.time() - t0:7.1f}s]", *a, flush=True)

    if torch.device(args.device).type == "cuda":
        set_card_numerics()
    with open(REFERENCE) as f:
        ref = json.load(f)
    methods = load_pretrained_methods(only=METHODS, device=args.device)
    ae_complete = make_ae_completer(*load_ae(pretrained.AE_CKPT, "selu",
                                             args.device))
    draws, seed = [], args.seed
    pending = list(METHODS)
    while pending:
        d = draw({m: methods[m] for m in pending}, args.examples, seed,
                 args.device)
        rows, gates = {}, {}
        for name in pending:
            r = d["raw"][name]
            rows[name] = method_row(name, r["sre_map"], r["nae_s"],
                                    r["nae_c"])
            rows[name]["seconds"] = round(d["seconds"][name], 3)
            gates[name] = gate(rows[name], ref["methods"][name], r)
            g = gates[name]
            log(f"seed {seed} {name:8s} SRE {g['sre_map']['port']:.4f} "
                f"(JAX {g['sre_map']['jax']:.4f}, z {g['sre_map']['z']:+.2f})"
                f"; NAE_C {g['nae_c']['port']:.4f} (JAX "
                f"{g['nae_c']['jax']:.4f}, z {g['nae_c']['z']:+.2f}); NAE_S "
                f"{g['nae_s']['port']:.4f} (JAX {g['nae_s']['jax']:.4f}); "
                f"{d['seconds'][name]:.2f} s; "
                + ("PASS" if g["pass"] else "OUT"))
        entry = {"seed": seed, "methods": rows, "gate": gates}
        if not draws:
            entry.update(diagnostics(d["hp"], ae_complete))
        draws.append(entry)
        # a method out of band is drawn once more, at seed + 1
        pending = ([m for m in pending if not gates[m]["pass"]]
                   if len(draws) == 1 else [])
        seed += 1
    first = draws[0]
    root = pretrained.REPO_ROOT
    doc = {
        "protocol": "base condition f=0.05 R=2 sigma=5 Xc=50 noiseless, "
                    f"{args.examples} Monte-Carlo examples (seed "
                    f"{args.seed}) in one batch of the PyTorch port; "
                    "Hungarian factor matching; per-factor NAE "
                    "(joint_opt_ae.m NAE with R=1) as the figure computes it",
        "anchor_provenance": "SINGLE-example hardcoded figure titles "
                             "(joint_opt_ae.m:721-826)",
        "config": {
            "ae_checkpoint": os.path.relpath(pretrained.AE_CKPT, root),
            "vae_checkpoint": os.path.relpath(pretrained.VAE_CKPT, root),
        },
        "num_examples": args.examples,
        # the diagnostics sit beside the methods, as in FIGURE_ANCHORS.json
        "methods": {**first["methods"], **{k: first[k] for k in (
            "oracle_s_cfit", "oracle_smooth_naes_floor",
            "oracle_ae_manifold_floor")}},
        "gate": {
            "rule": "per method |mean_port - mean_jax| <= 3 sqrt(se_port^2 "
                    "+ se_jax^2) for the map SRE and the per-emitter NAE_C "
                    "(standard errors from each side's per-example values); "
                    "NAE_S reported with z on the port's standard error "
                    "(FIGURE_ANCHORS.json keeps no per-example NAE_S); a "
                    "method out of band drawn again at seed + 1",
            "reference": os.path.basename(REFERENCE),
            "per_method": first["gate"],
            "redraws": draws[1:],
            "pass": all(first["gate"][m]["pass"] or any(
                d["gate"][m]["pass"] for d in draws[1:] if m in d["gate"])
                for m in METHODS)},
        "device": device_info(args.device),
        "wall_seconds": round(time.time() - t0, 1),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    log(f"wrote {args.out}; gate {'PASS' if doc['gate']['pass'] else 'FAIL'}")
    return doc


if __name__ == "__main__":
    main()
