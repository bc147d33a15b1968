"""Tracing hooks (port of `brush_tpu/utils/tracing.py`).

`stage(name)` marks a pipeline stage. It is always a
`torch.profiler.record_function` range, so stages show up named in
profiler traces; inside a `record_stages()` block it also records a CUDA
event pair on the current stream, so a caller can read each stage's time
on the card after a synchronize. The render's stages are flat; the
trainer's `backward` stage contains the rasterizer's `rasterize_bwd` and
`reduce` stages (a parent's time includes its children's).
"""

from __future__ import annotations

import contextlib

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


def stage_ms(records) -> dict[str, float]:
    """Sum of the recorded stage times on the card, ms, by stage name."""
    out: dict[str, float] = {}
    for name, start, end in records:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out
