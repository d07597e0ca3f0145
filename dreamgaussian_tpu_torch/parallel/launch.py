"""Local rank processes for scripts and tests that start their ranks
themselves, as ``torchrun`` starts a host's: each gets LOCAL_RANK and
LOCAL_WORLD_SIZE, and a rank that fails stops the others."""

from __future__ import annotations

import concurrent.futures
import os
import socket
import subprocess
import time
from typing import Callable


def free_port() -> int:
    """A free TCP port of localhost, for a process group's address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmd: Callable[[int], list], n: int, timeout: float,
              env: dict | None = None) -> list:
    """Start ``n`` processes (``cmd(rank)``, with LOCAL_RANK and
    LOCAL_WORLD_SIZE set) and wait for all; if one fails or the time runs
    out, stop the others and raise with the tail of each one's output.
    Returns the outputs."""
    env = dict(os.environ if env is None else env)
    procs = [subprocess.Popen(cmd(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n)))
             for r in range(n)]
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
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for r in readers:
                r.result()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = "\n".join(f"--- process {i} exit {c} ---\n" + "".join(outs[i][-40:])
                          for i, c in enumerate(codes))
        raise RuntimeError(f"a process failed or timed out: exits {codes}\n{tails}")
    return ["".join(o) for o in outs]
