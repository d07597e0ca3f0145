"""Spans and counters inside the port's steps, off unless switched on.

    from dreamgaussian_tpu_torch.utils import trace

    with trace.span("stage1.render"):
        ...
    trace.count("host_read")

Off (the default), ``span`` checks one module flag and returns a shared
no-op context, and ``count`` returns at once: nothing is allocated, no
profiler range is opened and no CUDA event is recorded.

``enable()`` switches both on for the whole process. A span then records
its name, its parent (the index of the enclosing span's record, on the
same thread), the step number and its host start and end. The span that
opens a step passes ``step=``; the spans inside it take that number. While
``torch.profiler`` records, a span also opens a ``record_function`` range
of the same name, so it sits in the Kineto trace on the clock of the
device work it launched. ``device=True`` also records a CUDA event at each
end of the span (no synchronisation); ``records()`` reads the stream time
between them, so keep it to rare spans. ``count=`` adds one to a counter
of that name as the span opens.

Times are integer nanoseconds on the profiler's clock: Unix time, which is
a Kineto trace's ``ts`` (microseconds) plus its ``baseTimeNanoseconds``.
They are read from the host's monotonic clock and shifted by an offset
taken once in ``enable()``.

``records()`` returns ``{"spans": [...], "counters": {...}}`` and clears
both. Call it outside every span, after the stream has finished the work
of any ``device=True`` span (it waits for their end events).
"""

from __future__ import annotations

import threading
import time

import torch

_on = False
_offset_ns = 0
_spans: list = []
_counters: dict = {}
_step = None
_local = threading.local()
_lock = threading.Lock()


class _Off:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "step", "outer_step", "range", "events")

    def __init__(self, name: str, device: bool, step, counter):
        self.rec = {"name": name, "parent": None, "step": None, "start_ns": 0, "end_ns": 0}
        self.step = step
        self.range = self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        if counter is not None:
            count(counter)

    def __enter__(self):
        global _step
        stack = _stack()
        rec = self.rec
        rec["parent"] = stack[-1] if stack else None
        self.outer_step = _step
        if self.step is not None:
            _step = self.step
        rec["step"] = _step
        stack.append(len(_spans))
        _spans.append(rec)
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(rec["name"])
            self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        rec["start_ns"] = time.perf_counter_ns() + _offset_ns
        return None

    def __exit__(self, *exc):
        global _step
        if self.events is not None:
            self.events[1].record()
            self.rec["events"] = self.events
        if self.range is not None:
            self.range.__exit__(*exc)
        # Both ends are read after the range's own calls, which stamp the
        # range inside them: the span then lies within tens of microseconds
        # of its range in the trace.
        self.rec["end_ns"] = time.perf_counter_ns() + _offset_ns
        _stack().pop()
        _step = self.outer_step
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, device: bool = False, step: int | None = None, count: str | None = None):
    """A context manager: a span named ``name`` while tracing is on, a
    shared no-op while it is off."""
    if not _on:
        return _OFF
    return _Span(name, device, step, count)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Switch tracing on (the clock offset is taken here)."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> dict:
    """The spans and counters recorded since the last call, then cleared.
    A ``device=True`` span's record carries ``device_ms``, the stream time
    between its events."""
    spans = list(_spans)
    _spans.clear()
    with _lock:
        counters = dict(_counters)
        _counters.clear()
    for rec in spans:
        events = rec.pop("events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
    return {"spans": spans, "counters": counters}
