"""The ranks of a multi-card cell besides rank 0.

``run.py`` runs rank 0 itself and starts ranks 1 .. n-1 with ``start``,
each a process of

    python3 -m portbench.ranks --spec <file> --rank <r>

on its own card (``cuda:r``), given the same configuration, mix, seed and
run length through a JSON file in ``TMPDIR``; they meet rank 0 at a
rendezvous on localhost (a free port) and run the same set-up, window and
stretch without printing a result (``setup_only``: the set-up alone, for
the readings of ``calibrate.py``). ``Workers.wait`` waits for each (and
ends any that outlives the run).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

from portbench import harness

WAIT_S = 300


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Workers:
    def __init__(self, procs: list, port: int, spec: str):
        self.procs, self.port, self.spec = procs, port, spec

    def wait(self) -> None:
        """Wait for every rank; end those still running after WAIT_S; raise
        if one failed."""
        failed = []
        try:
            for rank, p in enumerate(self.procs, start=1):
                try:
                    rc = p.wait(timeout=WAIT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                if rc != 0:
                    failed.append(f"rank {rank} exited with {rc}")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            os.remove(self.spec)
        if failed:
            raise RuntimeError("; ".join(failed))


def start(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
          fault: str | None = None, setup_only: bool = False) -> Workers:
    world = traffic["ranks"]
    port = free_port()
    fd, spec = tempfile.mkstemp(suffix=".json", prefix="portbench-ranks-")
    with os.fdopen(fd, "w") as f:
        json.dump({"config": config, "traffic": traffic, "seed": seed, "seconds": seconds,
                   "trace": trace, "device": device, "port": port, "fault": fault,
                   "setup_only": setup_only}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env.setdefault(var, "1")
    procs = [subprocess.Popen([sys.executable, "-m", "portbench.ranks", "--spec", spec,
                               "--rank", str(r)], cwd=harness.ROOT, env=env,
                              stdout=subprocess.DEVNULL)
             for r in range(1, world)]
    return Workers(procs, port, spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    import contextlib

    from portbench import faults

    drv = harness.runner(spec["traffic"]["kind"])
    run = drv.Run(spec["config"], spec["traffic"], spec["seed"], spec["device"],
                  spec["trace"], rank=args.rank, port=spec["port"])
    with faults.plant(spec["fault"]) if spec["fault"] else contextlib.nullcontext():
        run.setup()
        if spec["setup_only"]:
            run.leave()
            return 0
        run.window(spec["seconds"])
        run.after()
    return 0


if __name__ == "__main__":
    sys.exit(main())
