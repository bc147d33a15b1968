"""Row prefix sums and the row stack, each a CUDA kernel with a plain
PyTorch version beside it (port of `brush_tpu/ops/scan_pallas.py`).

* `cumsum_rows` (int32 or float32 sum along axis 1 of [R, L]) and
  `cummax_1d` (int32 running max). Kernel `csrc/scan.cu`, replacing
  `_scan_kernel` (sum and max ops, scan_pallas.py:43). Bound on the H100:
  bytes (4 read + 4 written per element). The TPU carried the running sum across sequential grid steps;
  Hopper blocks run in no order, so the kernel scans blocks, scans the
  block totals, and adds them back (three passes, ~12 bytes per element).
* `stack_rows`: 1-D rows of 32-bit words -> [total_rows, padded] matrix.
  Kernel `csrc/stack.cu`, replacing `_stack_kernel` (scan_pallas.py:167).
  Bound: bytes (each row read once, the matrix written once). A plain
  coalesced word copy; lanes past each row and rows past n are zeroed
  (the TPU left them unspecified).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.kernels import build

# Output width granule of `stack_rows`, as in the JAX package, so the two
# packages produce matrices of the same shape.
BLK = 8192


# --------------------------------------------------------------------------
# cumsum_rows, cummax_1d
# --------------------------------------------------------------------------

# Kernel-vs-plain rule of the f32 sum: the kernel adds in another order
# than torch.cumsum, so each prefix may differ by rounding, bounded by a
# small multiple of the running sum of |x| (the int32 scans are exact).
F32_SCAN_RTOL = 1e-6


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of [R, L], in x's dtype."""
    return torch.cumsum(x, dim=1, dtype=x.dtype)


def cummax_1d_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D tensor."""
    return torch.cummax(x, dim=0).values


def _launch_scan(x: torch.Tensor, entry: str, what: str) -> torch.Tensor:
    x = x.contiguous()
    rows, length = x.shape
    out = torch.empty_like(x)
    lib = build.library()
    chunk = lib.brush_scan_block_items()
    scratch = torch.empty(rows * max(-(-length // chunk), 1), dtype=x.dtype,
                          device=x.device)
    err = getattr(lib, entry)(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, length,
        build.stream_ptr(x.device))
    build.check(err, what)
    return out


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of an int32 or float32 [R, L] matrix.
    int32 sums wrap modulo 2^32, as they do in XLA; float32 sums are taken
    in the kernel's own order (see F32_SCAN_RTOL)."""
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    kernels.require_cuda("cumsum_rows", x)
    if x.dtype not in (torch.int32, torch.float32) or x.dim() != 2:
        raise ValueError(
            f"cumsum_rows kernel takes int32 or float32 [R, L], got "
            f"{x.dtype} {tuple(x.shape)}")
    if x.dtype == torch.int32:
        out = _launch_scan(x, "brush_scan_rows_i32", "cumsum_rows")
        kernels.note_launch("scan", _replay_cumsum_rows, kernels.same_bits, x)
    else:
        out = _launch_scan(x, "brush_scan_rows_f32", "cumsum_rows")
        kernels.note_launch("scan_f32", _replay_cumsum_rows,
                            functools.partial(compare_f32_scan, x=x), x)
    return out


def _replay_cumsum_rows(inputs):
    (x,) = inputs
    return lambda: cumsum_rows(x), lambda: cumsum_rows_plain(x)


def compare_f32_scan(got, want, x) -> float:
    """Hold the f32 scan of `x` to torch.cumsum: every prefix within
    F32_SCAN_RTOL of the running sum of |x| there. Returns the largest
    absolute difference; raises AssertionError outside the tolerance."""
    if got.shape != want.shape:
        raise AssertionError(f"scan: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    bound = F32_SCAN_RTOL * torch.cumsum(x.abs().double(), dim=1)
    diff = (got.double() - want.double()).abs()
    bad = ~(diff <= bound)            # NaN in either side counts as bad
    if bool(bad.any()):
        raise AssertionError(
            f"scan: {int(bad.sum())} of {want.numel()} prefixes past "
            f"{F32_SCAN_RTOL:g} of the running sum of |x| (max |d| "
            f"{float(diff.max()):.3g})")
    return float(diff.max()) if diff.numel() else 0.0


def cummax_1d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D int32 tensor."""
    if x.device.type == "cpu":
        return cummax_1d_plain(x)
    kernels.require_cuda("cummax_1d", x)
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"cummax_1d kernel takes int32 [L], got {x.dtype} "
                         f"{tuple(x.shape)}")
    out = _launch_scan(x[None, :], "brush_scan_rows_max_i32", "cummax_1d")[0]
    kernels.note_launch("scan_max", _replay_cummax_1d, kernels.same_bits, x)
    return out


def _replay_cummax_1d(inputs):
    (x,) = inputs
    return lambda: cummax_1d(x), lambda: cummax_1d_plain(x)


# --------------------------------------------------------------------------
# stack_rows
# --------------------------------------------------------------------------


def _padded_len(min_len: int) -> int:
    return max(-(-int(min_len) // BLK), 1) * BLK


def _check_rows(rows, total_rows: int):
    rows = list(rows)
    if not rows or len(rows) > total_rows:
        raise ValueError(f"stack_rows: {len(rows)} rows into {total_rows}")
    dtype, length = rows[0].dtype, rows[0].shape[0]
    for r in rows:
        if r.dim() != 1 or r.shape[0] != length or r.dtype != dtype:
            raise ValueError("stack_rows: rows must be 1-D, of one length "
                             "and one dtype")
        if r.element_size() != 4:
            raise ValueError(f"stack_rows: 32-bit rows only, got {r.dtype}")
    return rows, dtype, length


def stack_rows_plain(rows, total_rows: int, min_len: int) -> torch.Tensor:
    rows, dtype, length = _check_rows(rows, total_rows)
    padded = _padded_len(min_len)
    n = min(length, padded)
    out = torch.zeros((total_rows, padded), dtype=torch.int32,
                      device=rows[0].device)
    # Copy as int32 words so bit patterns (NaN payloads, f16 pairs) move
    # unchanged.
    out[:len(rows), :n] = torch.stack(
        [r.view(torch.int32)[:n] for r in rows], dim=0)
    return out.view(dtype)


def stack_rows(rows, total_rows: int, min_len: int) -> torch.Tensor:
    """Stack 1-D rows of 32-bit words (all one dtype) into a
    [total_rows, ceil(min_len / 8192) * 8192] matrix of that dtype. Rows past
    len(rows) and lanes past each row's length are zero."""
    rows, dtype, length = _check_rows(rows, total_rows)
    if rows[0].device.type == "cpu":
        return stack_rows_plain(rows, total_rows, min_len)
    kernels.require_cuda("stack_rows", *rows)
    rows = [r.contiguous() for r in rows]
    padded = _padded_len(min_len)
    out = torch.empty((total_rows, padded), dtype=dtype,
                      device=rows[0].device)
    lib = build.library()
    if len(rows) > lib.brush_stack_max_rows():
        raise ValueError(f"stack_rows kernel takes at most "
                         f"{lib.brush_stack_max_rows()} rows")
    ptrs = (ctypes.c_void_p * len(rows))(*[r.data_ptr() for r in rows])
    err = lib.brush_stack_rows(ptrs, len(rows), length, out.data_ptr(),
                               total_rows, padded,
                               build.stream_ptr(out.device))
    build.check(err, "stack_rows")
    kernels.note_launch("stack", _replay_stack_rows, kernels.same_bits, rows,
                        total_rows, min_len)
    return out


def _replay_stack_rows(inputs):
    return lambda: stack_rows(*inputs), lambda: stack_rows_plain(*inputs)
