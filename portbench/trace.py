"""A steady stretch of steps under ``torch.profiler``, reduced to numbers.

``profile_stretch(step, n, spans)`` runs ``step(i)`` n times inside one
user range ``portbench.stretch`` (synchronised at both ends) with the
profiler's CPU and CUDA activities on, exports the Kineto trace to the
run's ``TMPDIR``, reads it back and deletes it. ``summarize`` reduces the
trace's events:

- ``busy_s``: the union of device activity (kernels, copies, fills) inside
  the stretch; ``window_s``: the stretch's length;
- ``launches``: runtime calls that start device work (kernel launches,
  graph launches), in total;
- ``kernel_s``: device seconds by kernel name; ``span_kernel_s``: device
  seconds of the kernels launched from inside each named user range (by
  the launches' correlation ids);
- ``breakdown``: the device operations that took most time, and the
  longest idle gaps named by the innermost host operation running at each
  gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

STRETCH = "portbench.stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_NAMES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch"}


def profile_stretch(step, n: int, spans=()) -> dict:
    """Trace ``n`` calls of ``step(i)``; ``spans`` names the user ranges
    whose kernels' device time is summed (``span_kernel_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            for i in range(n):
                step(i)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, spans)


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def summarize(events: list, spans=()) -> dict:
    """Numbers of one traced stretch (times in seconds)."""
    stretch = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch range")
    s = stretch[0]
    w0, w1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
    host_tid = s.get("tid")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    inside = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
              for e in dev if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy_us, merged = _union([iv for iv in inside if iv[1] > iv[0]])
    kernel_s: dict = {}
    by_corr: dict = {}
    for e in dev:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] = by_corr.get(corr, 0.0) + float(e["dur"]) * 1e-6
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = _count_launches([e for e in runtime if e.get("name") in LAUNCH_NAMES
                                and w0 <= float(e["ts"]) <= w1])
    span_kernel_s = {}
    for name in spans:
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                        for e in events if e.get("name") == name
                        and e.get("cat") == "user_annotation")
        total = 0.0
        for e in runtime:
            ts = float(e["ts"])
            if any(a <= ts <= b and tid == e.get("tid") for a, b, tid in ranges):
                total += by_corr.get((e.get("args") or {}).get("correlation"), 0.0)
        span_kernel_s[name] = total
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    if merged:
        gaps = [(w0, merged[0][0])] + gaps + [(merged[-1][1], w1)]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6, "launches": launches,
            "kernel_s": kernel_s, "span_kernel_s": span_kernel_s,
            "breakdown": _breakdown(events, kernel_s, gaps, host_tid)}


def _count_launches(calls) -> int:
    """Launch calls, a driver call made inside a runtime call (the same
    launch seen twice) counted once."""
    outer = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
                   for e in calls if e.get("cat") == "cuda_runtime")
    starts = [o[0] for o in outer]
    n = len(outer)
    for e in calls:
        if e.get("cat") != "cuda_driver":
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if not (i >= 0 and outer[i][1] >= ts and outer[i][2] == e.get("tid")):
            n += 1
    return n


def _breakdown(events, kernel_s: dict, gaps, host_tid) -> dict:
    """Top 10 device operations by time; top 10 idle gaps summed by the
    innermost host operation at each gap's middle on the stretch's thread
    (an operator, else the innermost user range, such as a step or the
    guidance span)."""
    def spans(cats):
        return sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                       if e.get("cat") in cats and e.get("tid") == host_tid and "dur" in e
                       and e.get("name") != STRETCH), key=lambda r: r[0])

    ops, ranges = spans(("cpu_op", "python_function")), spans(("user_annotation",))
    starts = [o[0] for o in ops]
    by_name: dict = {}
    for a, b in gaps:
        if b - a <= 0:
            continue
        mid = 0.5 * (a + b)
        at = bisect.bisect_right(starts, mid)
        inner = [o for o in ops[max(0, at - 400):at] if o[0] <= mid <= o[1]]
        inner = inner or [r for r in ranges if r[0] <= mid <= r[1]]
        name = min(inner, key=lambda o: o[1] - o[0])[2] if inner else "host (no operation)"
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(kernel_s), "idle_gaps": top(by_name)}
