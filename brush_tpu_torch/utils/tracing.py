"""Tracing hooks (port of `brush_tpu/utils/tracing.py`).

`stage(name)` marks a pipeline stage. It is always a
`torch.profiler.record_function` range, so stages show up named in
profiler traces; inside a `record_stages()` block it also records a CUDA
event pair on the current stream, so a caller can read each stage's time
on the card after a synchronize. The render's stages are flat; the
trainer's `backward` stage contains the rasterizer's `rasterize_bwd` and
`reduce` stages (a parent's time includes its children's).

`profile_trace(log_dir)` records a `torch.profiler` trace of the block
(host and card) as a Chrome trace; `wall_timer` prints a block's host wall
time; `memory_stats()` reads the card's allocator under the JAX package's
key names.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_recorder: list | None = None


@contextlib.contextmanager
def stage(name: str):
    with torch.profiler.record_function(name):
        if _recorder is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            _recorder.append((name, start, end))


@contextlib.contextmanager
def record_stages():
    """Collect (name, start event, end event) for every stage in the block;
    read the times with `stage_ms` after `torch.cuda.synchronize()`."""
    global _recorder
    prev, _recorder = _recorder, []
    try:
        yield _recorder
    finally:
        _recorder = prev


@contextlib.contextmanager
def stages_off():
    """No stage events inside the block, even within `record_stages()`
    (a CUDA graph capture refuses timing events)."""
    global _recorder
    prev, _recorder = _recorder, None
    try:
        yield
    finally:
        _recorder = prev


def stage_ms(records) -> dict[str, float]:
    """Sum of the recorded stage times on the card, ms, by stage name."""
    out: dict[str, float] = {}
    for name, start, end in records:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a trace of the block: `with profile_trace('/tmp/trace'):
    step()`. The host's ops and, where there is a card, its kernels go to
    `log_dir/trace.json`, a Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def wall_timer(label: str, sink=print):
    """`sink("<label>: <ms> ms")` with the block's host wall time (work the
    block queued on the card and did not wait for is not in it)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {(time.perf_counter() - t0) * 1000:.2f} ms")


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
