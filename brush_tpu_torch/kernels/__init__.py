"""Hand-written Hopper kernels: their table, launch counters and the shared
library.

`KERNELS` holds each kernel's facts (source, device name, device ops a
call); tests/test_torch_kernels.py holds every row to the tree.

`LAUNCHES` holds one plain integer per kernel. A wrapper adds one to its
entry where it launches its kernel on the card, and nowhere else, so a run
can show which kernels the main path went through. While a `capture()`
block is open, every launch also records a `Launch`: the wrapper's inputs
and its module's own replay and compare functions, so the kernels can be
held against their plain versions at the shapes the main path gave them.
Both record the launches of every thread (autograd runs a CUDA backward
on a thread of its own; the web viewer renders on its server's threads),
so a capture must not overlap a viewer render it does not mean to record.

Importing this package builds and loads nothing: `build.library()` does
that at the first launch (see build.py).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple


class Kernel(NamedTuple):
    """One kernel's facts. `source`: its file under csrc/. `symbol`: (a
    substring of its device name in a profiler trace, a second substring
    where one template serves several kernels, else ""). `launches` and
    `memsets`: the device ops a call of its wrapper runs, its own launches
    and at most that many memsets (scratch cleared: look-back status words,
    work counters, the f64 sums), and nothing else."""

    source: str
    symbol: tuple[str, str]
    launches: int
    memsets: int


# `scan` is the int32 sum of the binning; `scan_f32` and `scan_max` are the
# other two variants of the same kernel.
# `expand` and `fill` lie on no render or training path, as in the JAX
# package since the emission kernel took over the remainder expansion: the
# 30M-slot stress run of the binning primitives drives them.
# `tile_counts` replaces no TPU kernel: it computes the binning's exact tile
# counts, which the JAX package leaves to XLA. Nor do `project_fwd` and
# `project_bwd`, the projection through a pinhole or KB4 lens and its
# backward (XLA's there too; one template each, the lens a parameter).
# The backward's two launches are its gradient kernel and the launch that
# rounds its f64 sums to f32; a trace counts a call of it by its first.
KERNELS = {
    "scan": Kernel("scan.cu", ("scan_rows_kernel", "SumU32"), 1, 1),
    "stack": Kernel("stack.cu", ("stack_rows_kernel", ""), 1, 0),
    "emit": Kernel("emit.cu", ("emit_slots_kernel", ""), 1, 0),
    "rasterize_fwd": Kernel("rasterize.cu",
                            ("rasterize_fwd_kernel<false>", ""), 1, 1),
    "rasterize_fwd_train": Kernel("rasterize.cu",
                                  ("rasterize_fwd_kernel<true>", ""), 1, 1),
    "rasterize_bwd": Kernel("rasterize_bwd.cu", ("rasterize_bwd_kernel", ""),
                            2, 1),
    "scan_f32": Kernel("scan.cu", ("scan_rows_kernel", "SumF32"), 1, 1),
    "scan_max": Kernel("scan.cu", ("scan_rows_kernel", "MaxI32"), 1, 1),
    "expand": Kernel("expand.cu", ("expand_segments_kernel", ""), 1, 0),
    "fill": Kernel("fill.cu", ("fill_rows_kernel", ""), 1, 1),
    "tile_counts": Kernel("tile_counts.cu", ("tile_hits_kernel", ""), 1, 0),
    "project_fwd": Kernel("project.cu", ("project_fwd_kernel", ""), 1, 0),
    "project_bwd": Kernel("project_bwd.cu", ("project_bwd_kernel", ""), 1, 0),
}
KERNEL_NAMES = tuple(KERNELS)
# The kernels a forward-only render launches, and those one training step
# launches (through a pinhole or KB4 lens).
SERVE_PATH = ("project_fwd", "tile_counts", "scan", "stack", "emit",
              "rasterize_fwd")
TRAIN_PATH = ("project_fwd", "tile_counts", "scan", "stack", "emit",
              "rasterize_fwd_train", "rasterize_bwd", "project_bwd")
# The kernels the stress run of the binning primitives launches.
STRESS_PATH = ("scan", "scan_f32", "stack", "expand", "fill")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
_count_lock = threading.Lock()
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
    with _count_lock:
        LAUNCHES[name] += 1
        if _captured is not None:
            _captured.append(Launch(name, inputs, replay, compare))


@contextlib.contextmanager
def capture(record: bool = True):
    """Collect a `Launch` for every kernel launch in the block. With
    `record=False` the block's launches are counted and recorded nowhere,
    not even in a capture open around the block (a `Launch` holds its
    inputs, and with them their memory, as long as its list lives)."""
    global _captured
    prev, _captured = _captured, ([] if record else None)
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
