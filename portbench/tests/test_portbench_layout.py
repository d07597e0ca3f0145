"""The benchmark's files are found by name, and BENCHMARK.json agrees with
them: every cell's configuration, mix and limits, every metric's reader
with its unit, layer and the end-to-end metric it moves."""

import json
import shutil

import pytest

from portbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    lim = harness.limits(cell["name"])
    assert harness.runner(mix["kind"]).Run is not None
    assert set(lim) == {"loss_gap", "grad_gap", "change_gap"}
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"portbench/configs/{cell['config']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    mod = harness.reader(metric["name"])
    assert mod.UNIT == metric["unit"]
    assert mod.MOVES == metric.get("moves", metric["name"])
    if "layer" in metric:
        assert mod.LAYER == metric["layer"]
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))
    assert mod.read({}) is None or metric["name"] == "setup_s"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], False)}
        per_layer = harness.cell_metrics(BENCH, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE / "metrics", base / "metrics")
    (base / "metrics" / "steps_seen.py").write_text(
        'LAYER = "stage-1 step"\nUNIT = "count"\nMOVES = "stage1_step_ms"\n\n\n'
        'def read(ctx):\n    return ctx.get("steps")\n')
    (base / "configs").mkdir()
    (base / "configs" / "other.json").write_text(json.dumps({"arch": {"kind": "zero123"}}))
    (base / "traffic").mkdir()
    (base / "traffic" / "short.json").write_text(json.dumps({"kind": "stage1", "start_step": 1}))
    assert harness.reader("steps_seen", base).read({"steps": 7}) == 7
    assert harness.config("other", base)["arch"]["kind"] == "zero123"
    assert harness.traffic("short", base)["start_step"] == 1
    got = harness.read_metrics([{"name": "stage1_step_ms", "unit": "ms"}],
                               {"kind": "stage1", "steps": 4, "window_s": 2.0})
    assert got == {"stage1_step_ms": {"value": 500.0, "unit": "ms"}}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][-1] == "portbench.run"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in BENCH["workloads"]:
        assert harness.cell(BENCH, c["name"]) is c
