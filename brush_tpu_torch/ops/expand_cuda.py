"""Segmented broadcast (port of `brush_tpu/ops/expand_pallas.py`).

`expand_segments(table, starts, counts, cap)` spreads column g of a
[rows, N] table over the slot run [starts[g], starts[g] + counts[g]) of a
[rows, cap] output: each splat's attributes repeated once per slot it owns.
Slots no run covers are zero, runs crossing `cap` are cut, runs starting
past `cap` write nothing.

Kernel `csrc/expand.cu`, replacing `_expand_kernel` (expand_pallas.py:49).
One thread per output slot: a binary search over the monotone `starts`
finds the slot's owner and a loop over the rows copies its column as raw
32-bit words, so the output is bit-exact and indices are exact up to 2^31
(the TPU's one-hot matrix product, bf16 value limbs and 12-bit start limbs
existed because a TPU gather costs tens of nanoseconds an index). Bound on
the H100: bytes (the table and the two index rows read once, the output
written once).

The JAX package's binning no longer calls its kernel (the emission kernel
took over the remainder expansion); as there, the function is reached
through its public name only.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.kernels import build


def _check_inputs(table, starts, counts, cap: int):
    if table.dim() != 2 or table.element_size() != 4:
        raise ValueError(f"expand_segments: table must be [rows, N] of a "
                         f"32-bit dtype, got {table.dtype} "
                         f"{tuple(table.shape)}")
    n = table.shape[1]
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"expand_segments: {name} must be int32 [{n}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 <= int(cap) < 2 ** 31:
        raise ValueError(f"expand_segments: cap {cap} outside [0, 2^31)")
    return n, int(cap)


def expand_segments_plain(table: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain PyTorch version: owner of slot s = last g with starts[g] <= s
    (a search), covered while s < starts[g] + counts[g], then a gather and
    a mask, on the int32 words."""
    n, cap = _check_inputs(table, starts, counts, cap)
    words = table.view(torch.int32)
    if n == 0:
        return words.new_zeros((table.shape[0], cap)).view(table.dtype)
    slots = torch.arange(cap, dtype=torch.int64, device=table.device)
    starts = starts.to(torch.int64)
    owner = torch.searchsorted(starts, slots, right=True) - 1
    safe = owner.clamp_min(0)
    covered = (owner >= 0) & (slots < starts[safe] + counts[safe])
    out = torch.where(covered[None, :], words[:, safe], 0)
    return out.view(table.dtype)


def expand_segments(table: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, cap: int) -> torch.Tensor:
    """out[:, starts[g] : starts[g] + counts[g]] = table[:, g:g+1] for every
    g, zeros elsewhere.

    table: [rows, N] of a 32-bit dtype (moved as raw words). starts: [N]
    int32, non-decreasing (the exclusive cumsum of counts). counts: [N]
    int32 >= 0. cap: output width below 2^31. Returns [rows, cap] of the
    table's dtype."""
    n, cap = _check_inputs(table, starts, counts, cap)
    if table.device.type == "cpu":
        return expand_segments_plain(table, starts, counts, cap)
    kernels.require_cuda("expand_segments", table, starts, counts)
    if n and table.stride(1) != 1:
        raise ValueError("expand_segments: the table's rows must be "
                         "contiguous (stride 1 along N)")
    rows = table.shape[0]
    out = torch.empty((rows, cap), dtype=table.dtype, device=table.device)
    if rows == 0 or cap == 0:
        return out
    starts_c, counts_c = starts.contiguous(), counts.contiguous()
    err = build.library().brush_expand_segments(
        table.data_ptr(), table.stride(0), rows, starts_c.data_ptr(),
        counts_c.data_ptr(), n, cap, out.data_ptr(),
        build.stream_ptr(table.device))
    build.check(err, "expand_segments")
    kernels.note_launch("expand", _replay_expand, kernels.same_bits, table,
                        starts, counts, cap)
    return out


def _replay_expand(inputs):
    return (lambda: expand_segments(*inputs),
            lambda: expand_segments_plain(*inputs))
