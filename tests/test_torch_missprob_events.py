"""Per-example detection events: `BatchedHarness` keeps them beside the
counts (whose sums they must give exactly), the miss protocol carries them
into each draw document, and `missprob_pool_seeds.cluster_band` builds a
cluster-robust band from them.  Hand-made events and small CPU runs; no
JAX."""

import json
import math

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu_torch import missprob
from quantized_spectrum_cartography_tpu_torch import missprob_pool_seeds as mps
from quantized_spectrum_cartography_tpu_torch.baselines import harness as th
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig

torch.set_num_threads(1)

SMALL = dict(grid_size=21, num_bands=16)
PAIRS = (("miss", "miss_count"), ("peak", "peak_count"),
         ("false", "false_count"), ("low", "low_count"))


def _noisy(generator, hp):
    """T_true scaled per example by 0.2..1.8: some peaks missed, some
    falsely raised, a few examples over the validity cap."""
    g = 0.2 + 1.6 * torch.rand(hp.T_true.shape[0], generator=generator)
    return {"T_hat": hp.T_true * g[:, None, None, None]}


def _zero(generator, hp):
    return {"T_hat": torch.zeros_like(hp.T_true)}


@pytest.mark.parametrize("cap", [None, 0.3])
def test_per_example_events_sum_to_counts(cap):
    """run's per-example events: one entry per example, the validity flags
    of the cap, and sums over the valid examples equal to the counts."""
    caps = {} if cap is None else {"noisy": cap}
    h = th.BatchedHarness({"noisy": _noisy, "zero": _zero},
                          PhysicsConfig(**SMALL), validity_caps=caps,
                          device="cpu")
    out = h.run(th.condition_grid("fraction", (0.05, 0.2)), num_examples=6,
                seed=1)
    for label, per_method in out.items():
        for name, st in per_method.items():
            valid = np.asarray(st["valid_all"])
            assert valid.tolist() == [s < caps.get(name, np.inf)
                                      for s in st["sre_all"]]
            assert int(valid.sum()) == st["valid"]
            for key, agg in PAIRS:
                per = np.asarray(st[f"{key}_all"])
                assert per.shape == (6,) and per.dtype.kind == "i"
                assert int(per[valid].sum()) == st[agg], (label, name, key)
    assert any(st["miss_all"] != st["peak_all"]
               for st in (r["noisy"] for r in out.values()))
    if cap is not None:
        assert not all(all(r["noisy"]["valid_all"]) for r in out.values())


class _FakeHarness:
    """A harness double: per condition, per-example events given."""

    methods = {"deepcomp": None, "nasdac": None, "dowjons": None}

    def __init__(self, rng, n):
        self.rng, self.n = rng, n

    def run(self, conds, num_examples, seed):
        out = {}
        for c in conds:
            out[c.label()] = {}
            for m in self.methods:
                per = {k: self.rng.integers(0, 20, self.n).tolist()
                       for k in ("miss", "peak", "false", "low")}
                out[c.label()][m] = {
                    **{f"{k}_all": v for k, v in per.items()},
                    "valid_all": [True] * self.n,
                    **{agg: int(sum(per[k])) for k, agg in PAIRS},
                    "sre": 0.1}
        return out


def test_draw_document_carries_per_example_events():
    events = missprob.run_draw(_FakeHarness(np.random.default_rng(0), 5), 5,
                               0)
    doc = json.loads(json.dumps(missprob.draw_document(
        events, 5, {}, 1.0, "cpu")))
    for m, ev in doc["events"].items():
        assert len(ev) == len(missprob.RHOS)
        for e in ev:
            pe = e["per_example"]
            assert set(pe) == {"miss", "peaks", "false", "lows", "valid"}
            for k in ("miss", "peaks", "false", "lows"):
                assert len(pe[k]) == 5 and sum(pe[k]) == e[k]
    assert doc["ours"] == missprob.curves(doc["events"])


def _docs(per_example_miss, per_example_peaks, n_draws=1):
    """Port draw documents with the same per-example events at every
    method and rho, split over n_draws draws."""
    mi = np.array_split(np.asarray(per_example_miss), n_draws)
    ni = np.array_split(np.asarray(per_example_peaks), n_draws)
    docs = []
    for a, b in zip(mi, ni):
        e = {"miss": int(a.sum()), "peaks": int(b.sum()), "false": 0,
             "lows": 10,
             "per_example": {"miss": a.tolist(), "peaks": b.tolist(),
                             "false": [0] * a.size, "lows": [10] * a.size,
                             "valid": [True] * a.size}}
        docs.append({"events": {m: [dict(e) for _ in missprob.RHOS]
                                for m in missprob.PUBLISHED}})
    return docs


def _ref(miss, peaks):
    e = {"miss": miss, "peaks": peaks, "false": 0, "lows": 10}
    return [{"events": {m: [dict(e) for _ in missprob.RHOS]
                        for m in missprob.PUBLISHED}}]


def test_cluster_band_formula():
    """The ratio estimator's variance and the design effect by hand; two
    draws pool their examples."""
    m = [0, 3, 1, 0, 6, 2]
    n = [10, 12, 9, 11, 14, 8]
    rows = mps.cluster_band(_docs(m, n, n_draws=2), _ref(30, 200))
    p = sum(m) / sum(n)
    var = sum((a - p * b) ** 2 for a, b in zip(m, n)) / sum(n) ** 2
    deff = var / (p * (1 - p) / sum(n))
    pj = 30 / 200
    z = (p - pj) / math.sqrt(var + pj * (1 - pj) / 200 * deff)
    assert len(rows) == 3 * len(missprob.RHOS)
    for r in rows:
        assert r["examples"] == 6 and r["n_port"] == sum(n)
        assert r["design_effect"] == pytest.approx(deff, abs=1e-3)
        assert r["z"] == pytest.approx(z, abs=1e-3)
        assert r["se_port"] == pytest.approx(math.sqrt(var), abs=1e-5)


def test_cluster_band_widens_where_misses_cluster():
    """The same 40 misses of 400 peak events, spread over the examples
    (0 to 2 each) or all in four examples: the clustered events have a
    design effect far above 1, so a difference that the binomial band
    flags lies inside the cluster-robust band; spread, the band is no
    wider than the binomial one and flags it too."""
    n = [10] * 40
    spread = [0, 1, 2, 1] * 10
    clustered = [10] * 4 + [0] * 36
    ref = _ref(12, 400)                          # JAX: 3% against 10%
    binom = [r for r in mps.binomial_bands(_docs(clustered, n), ref)]
    assert not any(r["in_band"] for r in binom)
    wide = mps.cluster_band(_docs(clustered, n), ref)
    narrow = mps.cluster_band(_docs(spread, n), ref)
    for w, s in zip(wide, narrow):
        assert w["port"] == s["port"] == 0.1
        assert w["design_effect"] > 5 and s["design_effect"] < 1
        assert w["in_band"] and not s["in_band"]
        assert abs(w["z"]) < 3 < abs(s["z"])


def test_pool_main_writes_cluster_rows(tmp_path):
    """missprob_pool_seeds' main on draw documents with per-example events
    adds the cluster-robust rows and their assumption to the comparison."""
    port = _docs([0, 3, 1, 0, 6, 2], [10, 12, 9, 11, 14, 8], n_draws=2)
    paths = []
    for i, d in enumerate(port):
        d.update(num_examples=3, ours=missprob.curves(d["events"]),
                 all_match_or_beat=False, wall_seconds=1.0)
        paths.append(tmp_path / f"port{i}.json")
        paths[-1].write_text(json.dumps(d))
    ref = _ref(30, 200) * 2
    ref_paths = []
    for i, d in enumerate(ref):
        ref_paths.append(tmp_path / f"ref{i}.json")
        ref_paths[-1].write_text(json.dumps(d))
    out = tmp_path / "pooled.json"
    mps.main([*map(str, paths), "--reference", *map(str, ref_paths),
              "--out", str(out)])
    doc = json.loads(out.read_text())
    cr = doc["comparison"]["cluster_robust"]
    assert cr["assumption"] == mps.CLUSTER_ASSUMPTION
    assert len(cr["rows"]) == 15
    assert cr["all_in_band"] == all(r["in_band"] for r in cr["rows"])


def test_missed_problems_regenerates_the_harness_examples(tmp_path):
    """missed_problems gives, for the examples a method missed, the
    problems BatchedHarness drew for them (same seed and condition
    index); main's --missed-from writes them to an npz."""
    n, seed = 3, 2
    events = {m: [{"miss": 0, "peaks": 0, "false": 0, "lows": 0, "sre": 0.1,
                   "per_example": {"miss": [0] * n, "peaks": [1] * n,
                                   "false": [0] * n, "lows": [1] * n,
                                   "valid": [True] * n}}
                  for _ in missprob.RHOS] for m in missprob.PUBLISHED}
    events["dowjons"][4]["per_example"]["miss"] = [0, 2, 0]     # rho 10%
    events["dowjons"][0]["per_example"]["miss"] = [1, 0, 0]     # rho 1%
    doc = {"config": {"seed": seed}, "num_examples": n,
           "rhos": list(missprob.RHOS), "events": events}
    got = missprob.missed_problems(doc, "dowjons", (0.10,), "cpu")
    h = th.BatchedHarness({}, device="cpu")
    cond = th.condition_grid("fraction", missprob.RHOS)[4]
    hp = th.make_problem(torch.Generator().manual_seed(seed * 100_000
                                                       + 4 * 1_000),
                         cond, h.physics, n, "cpu", h._cholesky(cond.xc))
    assert got["index"].tolist() == [1] and got["misses"].tolist() == [2]
    assert got["rho"].tolist() == [0.10] and got["seed"].tolist() == [seed]
    for k in ("T_true", "T_noisy", "S_true", "C_true", "peaks", "Om"):
        np.testing.assert_array_equal(got[k], getattr(hp, k)[1:2].numpy())
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    out = tmp_path / "missed.npz"
    missprob.main(["--missed-from", str(path), str(path), "--device", "cpu",
                   "--out", str(out)])
    with np.load(out) as z:                     # MISSED_RHOS: not rho 1%
        assert z["index"].tolist() == [1, 1]
        assert z["rho"].tolist() == [0.10, 0.10]
        assert z["T_true"].shape == (2, 64, 51, 51)
