"""A run whose timed path is broken underneath reads ``correct`` false:
the look for a card skipped, each cell at a CPU's size with the port's
networks in float32, each fault of ``faults.py`` the cell can have planted
(a data mesh's on the cells with several ranks, which run as that many
processes here with gloo); the same run unbroken reads true."""

import pytest

from portbench import faults, harness, run
from portbench.tests import tiny

BENCH = harness.benchmark()


def cell_faults():
    for cell in BENCH["workloads"]:
        ranks = harness.traffic(cell["traffic"]).get("ranks", 1)
        for fault in faults.FAULTS:
            if ranks > 1 or fault not in faults.MESH_FAULTS:
                yield cell["name"], fault


def tiny_run(name: str, fault=None) -> dict:
    cell = harness.cell(BENCH, name)
    cfg = tiny.config(cell["config"])
    cfg["precision"]["guidance_networks"] = "float32"
    return run.run_cell(BENCH, cell, cfg, tiny.traffic(cell["traffic"]), 41, 0.2, False,
                        device="cpu", fault=fault)


@pytest.mark.parametrize("name, fault", list(cell_faults()))
def test_a_broken_step_reads_incorrect(name, fault):
    with faults.plant(fault):
        line = tiny_run(name, fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_the_unbroken_step_reads_correct(name):
    assert tiny_run(name)["correct"]
