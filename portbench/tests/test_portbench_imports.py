"""No module the harness or its reference loads has the top-level name
jax, jaxlib, flax or dreamgaussian_tpu (compared whole: the port,
dreamgaussian_tpu_torch, is not the JAX package)."""

import os
import subprocess
import sys

from portbench import harness

SCRIPT = """
import sys
from portbench import harness, run
from portbench.tests import tiny
bench = harness.benchmark()
cell = bench["workloads"][0]
cfg = tiny.config(cell["config"])
run.run_cell(bench, cell, cfg, tiny.traffic(cell["traffic"]), 3, 0.1, False, device="cpu")
import portbench.calibrate, portbench.faults, portbench.trace, portbench.work
print("FOUND", harness.forbidden_modules(), "dreamgaussian_tpu_torch" in sys.modules)
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] True" in out.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dreamgaussian_tpu_torch_lookalike", sys)
    assert "dreamgaussian_tpu" not in harness.forbidden_modules() or \
        "dreamgaussian_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert "flax" in harness.forbidden_modules()
