"""Hand-written Hopper kernels: launch counters and the shared library.

`LAUNCHES` holds one plain integer per kernel. A wrapper adds one to its
entry where it launches its kernel on the card, and nowhere else, so a run
can show which kernels the main path went through. While a `capture()`
block is open, every launch also records a `Launch`: the wrapper's inputs
and its module's own replay and compare functions, so the kernels can be
held against their plain versions at the shapes the main path gave them.

Importing this package builds and loads nothing: `build.library()` does
that at the first launch (see build.py).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

# `scan` is the int32 sum of the binning; `scan_f32` and `scan_max` are the
# other two variants of the same kernel (no caller on a render or training
# path yet).
KERNEL_NAMES = ("scan", "stack", "emit", "rasterize_fwd",
                "rasterize_fwd_train", "rasterize_bwd", "scan_f32",
                "scan_max")
# The kernels a forward-only render launches, and those one training step
# launches.
SERVE_PATH = ("scan", "stack", "emit", "rasterize_fwd")
TRAIN_PATH = ("scan", "stack", "emit", "rasterize_fwd_train",
              "rasterize_bwd")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
_captured: list | None = None


class Launch(NamedTuple):
    """One captured launch. `replay(inputs)` gives (kernel, plain): calls
    without arguments that rerun the kernel and its plain PyTorch version
    on these inputs; `compare(got, want)` returns the largest absolute
    difference and raises AssertionError outside the kernel's tolerance."""

    name: str
    inputs: tuple
    replay: Callable
    compare: Callable

    def check(self) -> float:
        kernel, plain = self.replay(self.inputs)
        return self.compare(kernel(), plain())


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0


def note_launch(name: str, replay: Callable, compare: Callable,
                *inputs) -> None:
    """Count one launch of kernel `name` (and record it while a capture is
    open)."""
    LAUNCHES[name] += 1
    if _captured is not None:
        _captured.append(Launch(name, inputs, replay, compare))


@contextlib.contextmanager
def capture():
    """Collect a `Launch` for every kernel launch in the block."""
    global _captured
    prev, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = prev


def same_bits(got, want) -> float:
    """Compare for kernels that must match their plain version bit for bit:
    `got` and `want` are tensors or tuples of tensors, floats compared as
    their int32 words. Returns 0.0, or raises AssertionError."""
    import torch

    got = (got,) if torch.is_tensor(got) else tuple(got)
    want = (want,) if torch.is_tensor(want) else tuple(want)
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs against {len(want)}")
    for g, w in zip(got, want):
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"kernel and plain version differ at shape "
                                 f"{tuple(w.shape)}")
    return 0.0


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device (a wrapper takes
    its plain version only for CPU tensors; anything else is an error)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{what}: kernel inputs must all lie on one CUDA device, got "
            f"{sorted(str(d) for d in devices)}")
