"""What a run of one cell needs besides its runner: the files found by name,
the metric readers, the comparison's report and the result line.

Files, each found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: a configuration as it is run (``arch``: the
  networks' widths; ``trainer``: the trainer's options);
- ``traffic/<mix>.json``: a traffic mix (``kind`` names the runner,
  ``portbench/<kind>.py``; the rest are its parameters);
- ``metrics/<metric>.py``: one reader per metric, with ``LAYER``,
  ``UNIT``, ``MOVES`` and ``read(ctx) -> float | None``; ``None`` leaves the
  metric out of the line.

A cell is an entry of ``workloads``: a name, a config and a mix.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded by a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "dreamgaussian_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(cell_name: str, base: Path = HERE) -> dict:
    """The comparison's limits of a cell (``limits/<cell>.json``)."""
    return load_json(base / "limits" / f"{cell_name}.json")["limits"]


def runner(kind: str):
    """The runner module of a traffic kind (``portbench/<kind>.py``)."""
    return importlib.import_module(f"portbench.{kind}")


def reader(metric: str, base: Path = HERE):
    """The reader module of a metric (``metrics/<metric>.py``)."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The entries of the metrics a run of the cell reports: the end-to-end
    ones without tracing, the per-layer ones with it; a metric with a
    ``workloads`` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]


def read_metrics(entries: list, ctx: dict) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def checks_text(checks: dict) -> str:
    """One line per compared number: name, value, limit."""
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                     f"({'ok' if v['value'] <= v['limit'] else 'FAIL'})" for k, v in checks.items())
