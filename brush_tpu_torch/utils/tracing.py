"""Tracing hooks (port of `brush_tpu/utils/tracing.py`).

`stage(name)` marks a pipeline stage. It is always a
`torch.profiler.record_function` range, so stages show up named in
profiler traces, on the trace's clock. Inside a `record_stages()` block
(the recorder) it also records:

* the stage's host start and end (`time.perf_counter_ns()`), its parent
  (the innermost stage open on the same thread: viewer requests run on
  server threads, autograd's backward on its own) and its unit (the top
  stage's `unit=`, a training turn's step or a viewer frame's number,
  inherited by the stages inside it);
* with `device=True`, a timing event pair on the current stream, where
  there is a card and the stream is not being captured into a CUDA graph
  (a capture refuses timing events; the graph's replay is the stage to
  time). `mark_device_start()` on the stage moves its device start to
  where it is called (a turn's first enqueue comes after its host-only
  loading).

`count(name, n)` adds to the recorder's counters. Without a recorder a
stage is its `record_function` and one check, and a count is one check.

Memory is bounded: a stage whose events have completed is folded into
per-name aggregates (count, host, self and device totals and maxima); the
newest `TIMELINE_CAP` stages are kept as a timeline, and `dropped` counts
those pushed out. `snapshot()` synchronises and returns both, every
device mark put on the host clock by an anchor event recorded right after
a synchronise together with its host ns (taken again at each snapshot):
host stages and the card's marks on one timeline, without a profiler.

`stage_ms` sums the recorded device times by stage name; `stages_off()`
records nothing on its thread (a graph's warm-up and capture);
`memory_stats()` reads the card's allocator under the JAX package's key
names.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

# At least a 40 s window of a viewer frame's stages at 20 ms a frame.
TIMELINE_CAP = 1 << 16

_recorder: Recorder | None = None
_local = threading.local()    # .stack: open stages; .off: stages_off depth


class _Span:
    """One recorded stage."""

    __slots__ = ("name", "parent", "unit", "thread", "host", "children_ns",
                 "events", "device")

    def __init__(self, name, parent, unit, events):
        self.name, self.parent, self.unit = name, parent, unit
        self.thread = threading.get_ident()
        self.host = [time.perf_counter_ns(), None]
        self.children_ns = 0
        self.events = events       # (start, end) timing events, or None
        self.device = None         # [start, end] ns on the host clock

    def mark_device_start(self) -> None:
        """Take the stage's device start here, on the current stream."""
        if self.events is not None:
            self.events[0].record()

    def entry(self) -> dict:
        return dict(name=self.name, parent=self.parent, unit=self.unit,
                    thread=self.thread, host=list(self.host),
                    device=None if self.device is None else list(self.device))


class _NoSpan:
    """What a stage yields without a recorder."""

    __slots__ = ()

    def mark_device_start(self) -> None:
        pass


_NO_SPAN = _NoSpan()


class Recorder:
    """What `record_stages()` collects; see the module docstring."""

    def __init__(self):
        self.lock = threading.Lock()
        self.timeline: collections.deque = collections.deque(
            maxlen=TIMELINE_CAP)
        self.dropped = 0
        self.stages: dict[str, dict] = {}
        self.counters: dict[str, int] = {}
        self._pending: collections.deque = collections.deque()
        self.device = None
        self._anchor = None        # (event, host ns)
        if torch.cuda.is_available():
            self.device = torch.cuda.current_device()
            self._take_anchor()

    def _take_anchor(self) -> None:
        torch.cuda.synchronize(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ns = time.perf_counter_ns()
        ev.synchronize()
        self._anchor = (ev, ns)

    def _events(self):
        if (self.device is None or torch.cuda.current_device() != self.device
                or torch.cuda.is_current_stream_capturing()):
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, torch.cuda.Event(enable_timing=True)

    def open(self, name: str, device: bool, unit) -> _Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        if unit is None and parent is not None:
            unit = parent.unit
        span = _Span(name, None if parent is None else parent.name, unit,
                     self._events() if device else None)
        stack.append(span)
        return span

    def close(self, span: _Span) -> None:
        if span.events is not None:
            span.events[1].record()
        with self.lock:
            self._fold(wait=False)
        # The stage's host span holds the recorder's own work.
        span.host[1] = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:    # a generator closed away from its thread
            stack.remove(span)
        if stack:
            stack[-1].children_ns += span.host[1] - span.host[0]
        with self.lock:
            if span.events is None:
                self._commit(span)
            else:
                self._pending.append(span)

    def _fold(self, wait: bool) -> None:
        """Commit the pending stages whose events have completed, oldest
        first (all of them after a synchronise, `wait`)."""
        ev0, ns0 = self._anchor or (None, 0)
        while self._pending:
            span = self._pending[0]
            if not wait and not span.events[1].query():
                return
            self._pending.popleft()
            start, end = span.events
            span.device = [ns0 + round(ev0.elapsed_time(start) * 1e6),
                           ns0 + round(ev0.elapsed_time(end) * 1e6)]
            span.events = None
            self._commit(span)

    def _commit(self, span: _Span) -> None:
        host_ns = span.host[1] - span.host[0]
        a = self.stages.get(span.name)
        if a is None:
            a = self.stages[span.name] = dict(
                count=0, host_ms=0.0, self_ms=0.0, host_max_ms=0.0,
                device_count=0, device_ms=0.0, device_max_ms=0.0)
        a["count"] += 1
        a["host_ms"] += host_ns * 1e-6
        a["self_ms"] += (host_ns - span.children_ns) * 1e-6
        a["host_max_ms"] = max(a["host_max_ms"], host_ns * 1e-6)
        if span.device is not None:
            d = (span.device[1] - span.device[0]) * 1e-6
            a["device_count"] += 1
            a["device_ms"] += d
            a["device_max_ms"] = max(a["device_max_ms"], d)
        if len(self.timeline) == self.timeline.maxlen:
            self.dropped += 1
        self.timeline.append(span)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """Synchronise, fold every stage that has closed, and return the
        aggregates by stage name, the counters, `dropped`, and the
        timeline sorted by host start (entries: name, parent, unit,
        thread, host [start, end] ns, device [start, end] ns on the host
        clock or None)."""
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        with self.lock:
            self._fold(wait=True)
            if self.device is not None:
                self._take_anchor()
            return dict(
                stages={k: dict(v) for k, v in self.stages.items()},
                counters=dict(self.counters), dropped=self.dropped,
                timeline=sorted((s.entry() for s in self.timeline),
                                key=lambda e: e["host"][0]))


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def stage(name: str, device: bool = False, unit=None):
    """Mark a stage; see the module docstring. Yields the recorded stage
    (or a stand-in without a recorder) for `mark_device_start()`."""
    rec = _recorder
    if rec is None or getattr(_local, "off", 0):
        with torch.profiler.record_function(name):
            yield _NO_SPAN
        return
    # The profiler's range inside the recorded span: the span holds its
    # cost, and the host between two stages is the caller's own.
    span = rec.open(name, device, unit)
    try:
        with torch.profiler.record_function(name):
            yield span
    finally:
        rec.close(span)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the open recorder's counter `name`."""
    rec = _recorder
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def record_stages():
    """Open a recorder for the block (synchronises the card first) and
    yield it; read it with `snapshot()` or `stage_ms`."""
    global _recorder
    prev, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = prev


def snapshot() -> dict | None:
    """The open recorder's `snapshot()`, or None without one."""
    rec = _recorder
    return None if rec is None else rec.snapshot()


@contextlib.contextmanager
def stages_off():
    """No stage is recorded on this thread inside the block, even within
    `record_stages()` (a graph's warm-up and its capture)."""
    _local.off = getattr(_local, "off", 0) + 1
    try:
        yield
    finally:
        _local.off -= 1


def stage_ms(rec: Recorder) -> dict[str, float]:
    """Sum of the recorded device times, ms, by stage name."""
    return {k: v["device_ms"] for k, v in rec.snapshot()["stages"].items()
            if v["device_count"]}


def memory_stats() -> dict:
    """The memory of each card from PyTorch's allocator, under the JAX
    package's keys: {"cuda:i": {"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}} (the card's total memory). Empty without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
