"""Run one cell of the benchmark of ``dreamgaussian_tpu_torch`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for (``chips`` in ``BENCHMARK.json``). It exits non-zero and prints
no result without them.

A run builds the cell's inputs from ``--seed`` (``inputs.py``), sets up
the port on them, measures ``--seconds`` of its steps (the run length in
``BENCHMARK.json``: ``run_seconds``), then runs the plain reference
(``reference/``) on the same inputs and compares (``limits/<cell>.json``
holds the limits). Its last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``checks`` comes last, each
compared number beside its limit, and the same lines end standard error.

Caches and writes: the port builds its CUDA kernels once into
``build/kernels/`` inside the checkout (``ops/cuda_build.py``, keyed by
the source's hash), so only a checkout's first run compiles; a Triton
cache, should the port use one, goes to ``build/triton/``. A run writes
the start cloud's PLY and, traced, the profiler's trace into a folder of
its own under ``TMPDIR`` and deletes both; it writes nothing else outside
the checkout, ``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR``, and no fixed
``/tmp`` path. It takes no notice of ``BENCH_RUN``. It fails, with no
result, if JAX, flax or the JAX package were loaded.

Tests: ``python -m pytest portbench/tests`` (CPU; the card cases with
``-m cuda`` on a card). The limits' readings: ``python3 -m
portbench.calibrate`` on a card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def checks_of(gaps: dict, limits: dict) -> dict:
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in gaps.items()}


def result_line(ctx: dict, checks: dict, metrics: dict, trace: bool, chips: int, device) -> dict:
    import torch

    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    kind = torch.cuda.get_device_name(0) if str(device).startswith("cuda") else "cpu"
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": ctx["steps"], "failed": 0, "metrics": metrics,
           "device": dev, "card": card_line() if kind != "cpu" else ""}
    if trace:
        t = ctx["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = t["breakdown"]
    out["checks"] = checks
    return out


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device="cuda", limits: dict | None = None,
             t_start: float = T_START, fault: str | None = None) -> dict:
    """One run of a cell after the look for its cards: set-up, window, the
    reference and the comparison; returns the result line's object. A mix
    over several ranks starts the others (``ranks.py``; ``fault`` is
    planted in them, for the tests) and runs rank 0 here."""
    from portbench import ranks

    drv = harness.runner(traffic["kind"])
    workers = None
    if traffic.get("ranks", 1) > 1:
        workers = ranks.start(config, traffic, seed, seconds, trace, str(device), fault)
    try:
        run = (drv.Run(config, traffic, seed, device, trace, rank=0, port=workers.port)
               if workers else drv.Run(config, traffic, seed, device, trace))
        run.setup()
        setup_s = time.perf_counter() - t_start
        run.window(seconds)
        t_after = time.perf_counter()
        run.after()
    finally:
        if workers:
            workers.wait()
    ctx = dict(run.ctx, setup_s=setup_s)
    q = statistics.quantiles(ctx["step_ms_each"], n=10) if len(ctx["step_ms_each"]) > 1 else []
    print(f"portbench: {cell['name']} seed {seed}: set-up {setup_s:.2f} s, window "
          f"{ctx['window_s']:.2f} s ({ctx['steps']} steps; step ms deciles "
          f"{[round(x, 1) for x in q]}), after the window {time.perf_counter() - t_after:.2f} s",
          file=sys.stderr)
    checks = checks_of(ctx["gaps"], limits if limits is not None else harness.limits(cell["name"]))
    metrics = harness.read_metrics(harness.cell_metrics(bench, cell["name"], trace), ctx)
    return result_line(ctx, checks, metrics, trace, cell["chips"], device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(harness.ROOT / "build" / "triton"))
    # Load from one process with few threads: the host dispatches alone.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    import torch

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line = run_cell(bench, cell, harness.config(cell["config"]), harness.traffic(cell["traffic"]),
                    args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(harness.checks_text(line["checks"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
