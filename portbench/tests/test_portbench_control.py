"""On a card, at the cell's own size: the lower-precision control (the
reference's networks in fp8, ``reference/precision.py``) put in the port's
place reads not correct against the cell's limits, while the port's own
compared steps on the same seed read correct. Runs with ``-m cuda`` on a
card; skips here."""

import pytest

from portbench import calibrate, harness

BENCH = harness.benchmark()
ONE_CARD = [c["name"] for c in BENCH["workloads"] if c["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_reads_incorrect_and_the_port_correct(card, name):
    cell = harness.cell(BENCH, name)
    limits = harness.limits(name)
    got = calibrate.readings(cell, 2**31 + 17, control=True, fault=None, device=str(card))
    assert all(got["port_vs_reference"][k] <= limits[k] for k in limits), got
    assert any(got["control_vs_reference"][k] > limits[k] for k in limits), got
