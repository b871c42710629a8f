"""The port's evaluation protocols (condition grid, miss probability) on
the JAX package's committed artifacts: its summaries and pooling reproduce
CONDITIONS.json, CONDITIONS_POOLED.json, MISSPROB.json and
MISSPROB_SEEDS.json from their inputs, and the comparisons with the JAX
grid and curves flag a row out of band.  Reads the committed JSON files
only; runs no harness."""

import copy
import json
from pathlib import Path

import pytest

from quantized_spectrum_cartography_tpu_torch import (
    conditions_pool as cp,
    missprob,
    missprob_pool_seeds as mps,
)

ROOT = Path(__file__).resolve().parents[1]
MISSPROB_FILES = ["MISSPROB.json"] + [f"MISSPROB_seed{s}.json"
                                      for s in range(1, 5)]


def load(name):
    with open(ROOT / name) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def grid():
    return (load("CONDITIONS.json"), load("CONDITIONS_seed1.json"),
            load("CONDITIONS_POOLED.json"))


def same(a, b):
    """Equal as JSON (NaN equal to NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_pooling_reproduces_conditions_pooled(grid):
    d0, d1, pooled = grid
    out = cp.pool_documents([d0, d1], ["CONDITIONS.json",
                                       "CONDITIONS_seed1.json"])
    assert same(out["results"], pooled["results"])
    assert same(out["r_axis_regression_check"],
                pooled["r_axis_regression_check"])
    assert out["seeds"] == pooled["seeds"]
    assert out["num_examples_pooled"] == pooled["num_examples_pooled"]
    with pytest.raises(ValueError):
        cp.pool_documents([d0, d0], ["a", "b"])


@pytest.mark.parametrize("name", ["CONDITIONS.json", "CONDITIONS_seed1.json"])
def test_draw_summaries_reproduce_conditions(name):
    """sre_std and sre_median from each row's sre_all, the stack deltas
    from the unrounded rows, and the R-axis verdict."""
    doc = load(name)
    for label, row in doc["results"].items():
        raw = {m: {k: v for k, v in st.items()
                   if k not in ("sre_std", "sre_median")}
               for m, st in row.items() if not m.endswith("_stack_delta")}
        got = cp.add_stack_deltas(cp.add_spread(copy.deepcopy(raw)))
        assert same(got, row), label
    check = cp.r_axis_check(doc["results"])
    assert check["pass"] == doc["r_axis_regression_check"]["pass"]
    assert check["violations"] == doc["r_axis_regression_check"]["violations"]


def test_missprob_pooling_reproduces_seeds():
    docs = [load(n) for n in MISSPROB_FILES]
    ref = load("MISSPROB_SEEDS.json")
    out = mps.pool(docs)
    for key in ("pooled", "false_pooled", "pooled_all_match_or_beat",
                "pooled_false_guard_pass"):
        assert same(out[key], ref[key]), key
    assert same({str(k): v for k, v in out["per_seed"].items()},
                ref["per_seed"])
    assert same({str(k): v for k, v in
                 out["per_seed_all_match_or_beat"].items()},
                ref["per_seed_all_match_or_beat"])


def test_dump_json_round_trip(tmp_path):
    """The documents' writer gives what json.dump gives, read back (int
    keys as strings, NaN, nested rows)."""
    doc = {"pooled": mps.pool([load(n) for n in MISSPROB_FILES]),
           "grid": load("CONDITIONS_POOLED.json")["results"],
           "empty": {}, "nan": [float("nan")]}
    cp.dump_json(doc, str(tmp_path / "doc.json"))
    with open(tmp_path / "doc.json") as f:
        assert same(json.load(f), json.loads(json.dumps(doc)))


@pytest.mark.parametrize("name", MISSPROB_FILES)
def test_missprob_draw_summaries(name):
    """A draw's curves, false-alarm guard and verdict from its events."""
    doc = load(name)
    assert missprob.curves(doc["events"]) == doc["ours"]
    assert same(missprob.false_guard(doc["events"]), doc["false_match"])
    assert missprob.match_or_beat(doc["ours"]) == doc["all_match_or_beat"]


def test_grid_comparison_flags_out_of_band_row(grid):
    """The JAX grid against itself is in band everywhere (z = 0, BTD's
    valid-only figure from the draws); one hand-moved mean is flagged."""
    d0, d1, pooled = grid
    port = cp.pool_results([d0, d1], keep_sre_all=3)
    rows = cp.compare_grids(port, pooled["results"], [d0, d1])
    assert len(rows) == 25 * 8
    assert all(r["in_band"] for r in rows)
    btd = [r for r in rows if r["method"] == "btd"
           and r["label"] == "f=0.05 R=2 sig=5.0 Xc=50.0 snr=None"][0]
    assert btd["n_ref"] == 61 and btd["ref"] < 1.3       # valid-only
    moved = copy.deepcopy(port)
    label = "f=0.1 R=2 sig=5.0 Xc=50.0 snr=None"
    st = moved[label]["nasdac"]
    st["sre"] += 4 * st["sre_std"] * (2 / st["valid"]) ** 0.5
    out = [r for r in cp.compare_grids(moved, pooled["results"], [d0, d1])
           if not r["in_band"]]
    assert [(r["label"], r["method"]) for r in out] == [(label, "nasdac")]
    assert out[0]["z"] == pytest.approx(4.0, rel=1e-3)


def test_missprob_comparison_flags_out_of_band_rate():
    docs = [load(n) for n in MISSPROB_FILES]
    rows = mps.binomial_bands(docs, docs)
    assert len(rows) == 15 and all(r["in_band"] for r in rows)
    moved = copy.deepcopy(docs)
    for d in moved:                       # dowjons at rho = 5%: 4x misses
        d["events"]["dowjons"][2]["miss"] *= 4
    out = [r for r in mps.binomial_bands(moved, docs) if not r["in_band"]]
    assert [(r["method"], r["rho_index"]) for r in out] == [("dowjons", 2)]


def test_missprob_draw_level_comparison():
    """The draws as samples: JAX against itself t = 0; quadrupled misses
    in every draw flagged; the JAX draws part by more than the binomial
    spread (overdispersion > 1 at rho = 1%)."""
    docs = [load(n) for n in MISSPROB_FILES]
    rows = mps.draw_level(docs, docs)
    assert len(rows) == 15 and all(r["in_band"] and r["t"] == 0
                                   for r in rows)
    assert all(r["overdispersion"] > 1 for r in rows if r["rho_index"] == 0)
    moved = copy.deepcopy(docs)
    for d in moved:
        d["events"]["dowjons"][2]["miss"] *= 4
    out = [r for r in mps.draw_level(moved, docs) if not r["in_band"]]
    assert [(r["method"], r["rho_index"]) for r in out] == [("dowjons", 2)]
