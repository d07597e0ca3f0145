"""A traced run (``--trace 1``) of each cell at a CPU's size goes through
the profiler's stretch, the work counts and the readers: the line carries
per-layer metrics and the breakdown, and ``correct`` as an untraced run."""

import pytest

from portbench import harness, run
from portbench.tests import tiny

BENCH = harness.benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]
                                  if c["chips"] == 1])
def test_a_traced_run_reports_per_layer_metrics(name):
    cell = harness.cell(BENCH, name)
    cfg = tiny.config(cell["config"])
    cfg["precision"]["guidance_networks"] = "float32"
    line = run.run_cell(BENCH, cell, cfg, tiny.traffic(cell["traffic"]), 12, 0.2, True,
                        device="cpu")
    assert line["correct"]
    expected = {m["name"] for m in harness.cell_metrics(BENCH, name, True)}
    assert set(line["metrics"]) <= expected
    # Host-side readings exist on the CPU too; device ones need a card.
    host = {"mfu.stage1", "mfu.refine", "launches_per_step.stage1", "stage1_step_p95_ms",
            "guidance_host_ms.stage1", "refine_target_ms", "refine_grad_ms"}
    assert expected & host <= set(line["metrics"]) | {"launches_per_step.stage1"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
