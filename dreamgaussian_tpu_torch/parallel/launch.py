"""Processes for scripts and tests that start their ranks or their nodes'
launchers themselves: ``run_ranks`` starts a host's ranks as ``torchrun``
starts them (each gets LOCAL_RANK and LOCAL_WORLD_SIZE); ``run_nodes``
starts one ``torchrun`` launcher per node rank (``torchrun_nodes``'s
arguments: a static rendezvous at one address). In both, a process that
fails stops the others."""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable

STOP_GRACE_S = 20.0   # from terminating a process group to killing it


def free_port() -> int:
    """A free TCP port of localhost, for a process group's address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_nodes(nnodes: int, node_rank: int, nproc: int, port: int,
                   addr: str = "127.0.0.1") -> list:
    """The command line of node ``node_rank``'s launcher, up to the program:
    ``torchrun`` with a static rendezvous at ``addr:port``, which node 0's
    launcher hosts."""
    return [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nnodes),
            "--node-rank", str(node_rank), "--nproc-per-node", str(nproc),
            "--master-addr", addr, "--master-port", str(port)]


def run_ranks(cmd: Callable[[int], list], n: int, timeout: float,
              env: dict | None = None) -> list:
    """Start ``n`` processes (``cmd(rank)``, with LOCAL_RANK and
    LOCAL_WORLD_SIZE set) and wait for all; if one fails or the time runs
    out, stop the others and raise with the tail of each one's output.
    Returns the outputs."""
    env = dict(os.environ if env is None else env)
    return _run([cmd(r) for r in range(n)],
                [dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n)) for r in range(n)], timeout)


def run_nodes(cmd: Callable[[int], list], nnodes: int, timeout: float,
              env: dict | None = None) -> list:
    """Start one launcher per node rank (``cmd(node_rank)``, for example
    ``torchrun_nodes(...)`` and the program) and wait for all, as
    ``run_ranks`` does; returns each launcher's output."""
    env = dict(os.environ if env is None else env)
    return _run([cmd(r) for r in range(nnodes)], [env] * nnodes, timeout)


def _run(cmds: list, envs: list, timeout: float) -> list:
    n = len(cmds)
    # Each in a session of its own: stopping one signals its process group.
    # A torchrun launcher stops its ranks (which run in sessions of their
    # own) when it is terminated, so the group is terminated first and
    # killed only after a grace period.
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=e, start_new_session=True) for c, e in zip(cmds, envs)]
    outs = [[] for _ in range(n)]
    t_end = time.monotonic() + timeout

    def drain(i, p):
        for line in p.stdout:
            outs[i].append(line)

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        readers = [pool.submit(drain, i, p) for i, p in enumerate(procs)]
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > t_end:
                    break
                time.sleep(0.1)
        finally:
            for sig, grace in ((signal.SIGTERM, STOP_GRACE_S), (signal.SIGKILL, None)):
                for p in procs:
                    if p.poll() is None:
                        with contextlib.suppress(ProcessLookupError):
                            os.killpg(p.pid, sig)
                for p in procs:
                    with contextlib.suppress(subprocess.TimeoutExpired):
                        p.wait(grace)
            for r in readers:
                r.result()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = "\n".join(f"--- process {i} exit {c} ---\n" + "".join(outs[i][-40:])
                          for i, c in enumerate(codes))
        raise RuntimeError(f"a process failed or timed out: exits {codes}\n{tails}")
    return ["".join(o) for o in outs]
