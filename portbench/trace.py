"""A device trace of a stretch of the window, and its reduction.

`Tracer` runs `torch.profiler` (host and CUDA activities) over a stretch
that the traffic marks with `begin()` and `end()`; the stretch is a
"portbench.stretch" annotation in the trace, on the clock the device's
events share. `summarize` reads the exported Chrome trace: the device's
operations (kernels, memcpys, memsets) inside the stretch, the union of
their intervals (busy time), the time of the kernels whose names match the
benchmark's list of the program's own kernels (csrc_kernels.json), the
operations that took most time, and the longest idle gaps named by what
the host was doing meanwhile.

`GraphClock` takes what the profiler would distort or cannot see: the
host time of each CUDA graph's `replay()` (the launch) outside the traced
stretch, and the graphs captured inside the window.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation",
             "python_function")
STRETCH = "portbench.stretch"
KERNEL_LIST = Path(__file__).resolve().parent / "csrc_kernels.json"


def kernel_names() -> list[dict]:
    with open(KERNEL_LIST) as f:
        return json.load(f)["kernels"]


def match_kernel(name: str, kernels: list[dict]) -> str | None:
    """The benchmark's name of a device kernel, or None if it is not one
    of the program's own."""
    for k in kernels:
        if k["symbol"] in name and k.get("variant", "") in name:
            return k["name"]
    return None


class GraphClock:
    """Wraps `torch.cuda.CUDAGraph`'s `capture_begin` and, with
    `time_replays`, its `replay`: while `window` is on it counts captures;
    while `timing` is on it adds each replay's host seconds. `restore()`
    puts both back."""

    def __init__(self, torch, time_replays: bool):
        cls = self.cls = torch.cuda.CUDAGraph
        self.real_replay, self.real_begin = cls.replay, cls.capture_begin
        self.window = self.timing = False
        self.captures = self.replays = 0
        self.replay_s = 0.0
        clock = self

        def capture_begin(graph, *args, **kwargs):
            clock.captures += clock.window
            return clock.real_begin(graph, *args, **kwargs)

        def replay(graph):
            if not clock.timing:
                return clock.real_replay(graph)
            t = time.perf_counter()
            clock.real_replay(graph)
            clock.replay_s += time.perf_counter() - t
            clock.replays += 1

        cls.capture_begin = capture_begin
        if time_replays:
            cls.replay = replay

    def restore(self) -> None:
        self.cls.replay = self.real_replay
        self.cls.capture_begin = self.real_begin

    def replays_line(self) -> dict:
        return dict(count=self.replays, s=self.replay_s)


class Tracer:
    """Profile from `begin()` to `end()`; `summary()` after `end()`."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark = None
        self._summary = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(STRETCH)
        self.mark.__enter__()

    def end(self) -> None:
        self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self._summary = summarize(path, kernel_names())
        finally:
            os.unlink(path)
        self.prof = None

    def summary(self) -> dict | None:
        return self._summary


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def summarize(path: str, kernels: list[dict], top: int = 10) -> dict:
    """Reduce a Chrome trace (times in microseconds) to the stretch's
    numbers; see the module docstring."""
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data.get("traceEvents", data)
              if isinstance(e, dict) and e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"{path}: no {STRETCH} annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, host = [], []
    for e in events:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            if s + d > lo and s < hi:
                device.append((max(s, lo), min(s + d, hi), e["name"]))
        elif cat in HOST_CATS and e.get("name") != STRETCH:
            host.append((s, s + d, e["name"], cat))
    own_us, other_us = 0.0, 0.0
    own_by_kernel: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for s, e, name in device:
        d = e - s
        k = match_kernel(name, kernels)
        if k is None:
            other_us += d
        else:
            own_us += d
            own_by_kernel[k] = own_by_kernel.get(k, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
    busy = _union([(s, e) for s, e, _ in device])
    gaps = sorted(_gaps([(s, e) for s, e, _ in device], lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    idle = []
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        over = [(e - s, name) for s, e, name, cat in host
                if s <= mid <= e and cat != "user_annotation"]
        label = min(over)[1] if over else "host outside any traced call"
        idle.append([label, (ge - gs) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy * 1e-6,
        device_ops=len(device),
        own_kernel_s=own_us * 1e-6,
        own_by_kernel_s={k: v * 1e-6 for k, v in own_by_kernel.items()},
        other_device_s=other_us * 1e-6,
        top_ops=[[name[:120], us * 1e-6] for name, us in ops],
        idle_gaps=[[label[:120], s] for label, s in idle],
    )
