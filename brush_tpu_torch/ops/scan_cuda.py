"""Row prefix sums, the segmented fill and the row stack, each a CUDA kernel
with a plain PyTorch version beside it (port of
`brush_tpu/ops/scan_pallas.py`).

* `cumsum_rows` (int32 or float32 sum along axis 1 of [R, L]) and
  `cummax_1d` (int32 running max). Kernel `csrc/scan.cu`, replacing
  `_scan_kernel` (sum and max ops, scan_pallas.py:43). Bound on the H100:
  bytes (4 read + 4 written per element). The TPU carried the running sum
  across sequential grid steps; Hopper blocks run in no order, so the
  kernel is a single-pass chained scan with decoupled look-back: blocks
  take tiles from an atomic counter, publish each tile's aggregate and
  inclusive prefix in a 64-bit status word, and find their own prefix from
  their predecessors' words. One memset of the scratch (status words and
  counter) and one launch a call, 8 bytes moved per element.
* `fill_rows`: segmented forward fill along axis 1 of [R, L] (each lane
  takes the words of the nearest valid lane at or before it). Kernel
  `csrc/fill.cu`, replacing `_fill_kernel` (scan_pallas.py:111). Bound:
  bytes (valid and x read once, the result written once). The TPU dragged
  all R words through a select-combine scan; here one single-pass launch
  with the scan's decoupled look-back (`csrc/lookback.cuh`) carries one
  index a lane (the running max of valid ? lane : -1) and moves each row's
  words from a shared-memory copy of the tile: one memset of the scratch
  and one launch a call, 20 bytes a lane at R = 2.
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
# than torch.cumsum, and adds the tile prefixes in the order its look-back
# met them, which depends on timing; so each prefix may differ by rounding,
# from torch.cumsum and from the kernel's own previous run, bounded by a
# small multiple of the running sum of |x| (the int32 scans are exact).
F32_SCAN_RTOL = 1e-6


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of [R, L], in x's dtype."""
    return torch.cumsum(x, dim=1, dtype=x.dtype)


def cummax_1d_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D tensor."""
    return torch.cummax(x, dim=0).values


@functools.cache
def scan_tile_items() -> int:
    """Lanes one block of the scan kernel covers (asked of the library
    once)."""
    return build.library().brush_scan_tile_items()


def scan_scratch_words(rows: int, length: int, tile: int) -> int:
    """8-byte words of scratch the scan kernel needs for [rows, length]:
    one status word per tile and the tile counter. A row's tiles start at
    the 16-byte boundary at or before its first lane, up to 3 lanes early,
    so a row has ceil((length + 3) / tile) tiles."""
    return rows * -(-(length + 3) // tile) + 1


def _launch_scan(x: torch.Tensor, entry: str, what: str) -> torch.Tensor:
    x = x.contiguous()
    rows, length = x.shape
    out = torch.empty_like(x)
    words = scan_scratch_words(rows, length, scan_tile_items())
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    err = getattr(build.library(), entry)(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), words, rows,
        length, build.stream_ptr(x.device))
    build.check(err, what)
    return out


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of an int32 or float32 [R, L] matrix.
    int32 sums wrap modulo 2^32, as they do in XLA; float32 sums are taken
    in the kernel's own order, which depends on timing, so two runs on the
    same input may differ by rounding (see F32_SCAN_RTOL)."""
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    kernels.require_cuda("cumsum_rows", x)
    if x.dtype not in (torch.int32, torch.float32) or x.dim() != 2:
        raise ValueError(
            f"cumsum_rows kernel takes int32 or float32 [R, L], got "
            f"{x.dtype} {tuple(x.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x)
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
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch_scan(x[None, :], "brush_scan_rows_max_i32", "cummax_1d")[0]
    kernels.note_launch("scan_max", _replay_cummax_1d, kernels.same_bits, x)
    return out


def _replay_cummax_1d(inputs):
    (x,) = inputs
    return lambda: cummax_1d(x), lambda: cummax_1d_plain(x)


# --------------------------------------------------------------------------
# fill_rows
# --------------------------------------------------------------------------


def _check_fill(x, valid):
    if x.dim() != 2 or x.element_size() != 4:
        raise ValueError(f"fill_rows: x must be [R, L] of a 32-bit dtype, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if (valid.shape != (x.shape[1],)
            or valid.dtype not in (torch.int32, torch.bool)):
        raise ValueError(f"fill_rows: valid must be int32 or bool "
                         f"[{x.shape[1]}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")


def fill_rows_plain(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the running max of (valid ? lane : -1) is the
    lane to copy from; a gather and a mask on the int32 words."""
    _check_fill(x, valid)
    lanes = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    marked = torch.where(valid.to(torch.int32) > 0, lanes, -1)
    if marked.numel() == 0:
        return x.clone()
    last = torch.cummax(marked, dim=0).values
    words = x.view(torch.int32)
    out = torch.where((last >= 0)[None, :], words[:, last.clamp_min(0)], 0)
    return out.view(x.dtype)


@functools.cache
def fill_tile_items() -> int:
    """Lanes one block of the fill kernel covers (asked of the library
    once)."""
    return build.library().brush_fill_tile_items()


def fill_scratch_words(length: int, tile: int) -> int:
    """8-byte words of scratch the fill kernel needs for rows of `length`
    lanes: one status word per tile of the lane axis (all rows share it)
    and the tile counter."""
    return -(-length // tile) + 1


def fill_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Carry fill along axis 1 of [R, L]: each lane takes the row values of
    the nearest valid lane at or before it, zeros before the first valid
    lane. `x` is any 32-bit dtype, moved as raw words and returned in that
    dtype; `valid` is [L] int32 (> 0 is valid) or bool (converted to int32
    first, one more launch)."""
    _check_fill(x, valid)
    if x.device.type == "cpu":
        return fill_rows_plain(x, valid)
    kernels.require_cuda("fill_rows", x, valid)
    x = x.contiguous()
    rows, length = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    flags = valid.to(torch.int32).contiguous()
    words = fill_scratch_words(length, fill_tile_items())
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    err = build.library().brush_fill_rows(
        x.data_ptr(), flags.data_ptr(), rows, length, out.data_ptr(),
        scratch.data_ptr(), words, build.stream_ptr(x.device))
    build.check(err, "fill_rows")
    kernels.note_launch("fill", _replay_fill_rows, kernels.same_bits, x,
                        valid)
    return out


def _replay_fill_rows(inputs):
    return lambda: fill_rows(*inputs), lambda: fill_rows_plain(*inputs)


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
