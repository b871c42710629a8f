"""A cell, a configuration and a per-layer metric added as files and
entries only are found by name, with no file of the harness edited."""

import json
import shutil

from port_bench import harness


def test_new_cell_and_metric_are_picked_up(tmp_path):
    base = tmp_path / "bench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(harness.HERE / sub, base / sub)
    spec = harness.load_spec()
    # a new configuration and cell, as data only
    cfg = harness.load_json(base / "configs" / "lowrank-1bit-r2.json")
    cfg["name"] = "lowrank-1bit-r4"
    cfg["physics"]["num_emitters"] = 4
    (base / "configs" / "lowrank-1bit-r4.json").write_text(json.dumps(cfg))
    w = harness.load_json(base / "workloads" /
                          "lowrank-1bit-r2.batch256.json")
    w["config"] = "lowrank-1bit-r4"
    (base / "workloads" / "lowrank-1bit-r4.batch256.json").write_text(
        json.dumps(w))
    spec["configs"].append({"name": "lowrank-1bit-r4", "source": "x",
                            "file": "port_bench/configs/lowrank-1bit-r4.json",
                            "reduced": [], "why": "four emitters"})
    spec["workloads"].append({"name": "lowrank-1bit-r4.batch256",
                              "config": "lowrank-1bit-r4",
                              "traffic": "batch256", "chips": 1,
                              "why": "four emitters"})
    # and a new per-layer metric with its own reader
    (base / "metrics" / "solves_traced.batch.py").write_text(
        'UNIT, LAYER, MOVES = "solves", "solver entry", "maps_per_s"\n'
        "def read(ctx):\n    return float(ctx.units)\n")
    spec["per_layer"].append({"name": "solves_traced.batch",
                              "unit": "solves", "better": "higher",
                              "source": "program_counter",
                              "layer": "solver entry",
                              "moves": "maps_per_s"})
    for e in spec["end_to_end"]:
        if e["name"] == "maps_per_s":
            e["workloads"].append("lowrank-1bit-r4.batch256")
    cell = harness.load_cell("lowrank-1bit-r4.batch256", spec, base)
    assert cell.config["physics"]["num_emitters"] == 4
    assert harness.driver(cell).__name__ == "port_bench.drivers.batch"
    assert {m["name"] for m in cell.end_to_end} == {"maps_per_s",
                                                     "setup_s"}
    # the metric without a `workloads` key goes to every cell that
    # reports what it moves, the new one and the old
    for name in ("lowrank-1bit-r4.batch256", "lowrank-1bit-r2.batch256"):
        got = {m["name"] for m in
               harness.load_cell(name, spec, base).per_layer}
        assert "solves_traced.batch" in got
    assert "solves_traced.batch" not in {
        m["name"] for m in harness.load_cell(
            "mlegan-gen256-4bin.single", spec, base).per_layer}
    reader = harness.metric_reader("solves_traced.batch", base)

    class Ctx:
        units = 2
    assert reader.read(Ctx()) == 2.0


def test_every_metric_file_agrees_with_benchmark_json():
    spec = harness.load_spec()
    names = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        mod = harness.metric_reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["unit"], m["layer"], m["moves"]), m["name"]
        for w in m["workloads"]:
            assert w in names
            assert m["moves"] in {e["name"] for e in
                                  harness.load_cell(w, spec).end_to_end}
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.workload["config"] == w["config"]
        assert cell.workload["chips"] == w["chips"]
        assert cell.workload["why"] == w["why"]
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer


def test_held_cells_stay_out_of_benchmark_json():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    held = harness.load_spec()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[key]]
        extra = [e["name"] for e in held[key]][len(names):]
        assert not set(names) & set(extra), key
    cells = {w["name"] for w in spec["workloads"]}
    for m in held["per_layer"][len(spec["per_layer"]):]:
        assert not cells & set(m["workloads"]), m["name"]
