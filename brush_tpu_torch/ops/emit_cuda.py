"""Tile-sort slot emission: per-splat table -> sort operands, one pass
(port of `brush_tpu/ops/emit_pallas.py`).

Kernel `csrc/emit.cu`, replacing `_emit_kernel` (emit_pallas.py:133). The
slot layout is the JAX package's jnp emission (`brush_tpu/ops/tiling.py`
`_emit_jnp`): a dense k-major region [k0, N] (slot k*N + g is splat g's
k-th emitted tile) followed by a remainder region [rem_cap] holding the
later slots of large splats, so s_cap = N*k0 + rem_cap. One launch: the
dense region takes one thread a splat (the table read once, the hit mask
walked bit by bit, each of the k0 slots written by a warp as one coalesced
run); the remainder is block-searched as `expand_segments` is (a block
finds its owner range with two warp searches of `rem_starts` and each
thread finds its 4-slot groups' owners in shared memory; the TPU used a
windowed one-hot matmul). The key leaves the kernel as an int64 holding
the u32 value (the TPU's u16 key limbs existed only because a TPU copy may
canonicalise NaN bits).

Bound on the H100: bytes — the 18-row table is read once, and every slot
writes an 8-byte key and ten 4-byte payload words.

Contract (emit_pallas.py:20-28): the MULTISET of non-sentinel
(key, payload, gid) slots equals `_emit_jnp`'s. The plain version here
follows `_emit_jnp` slot for slot, so the kernel matches it positionally.
"""

from __future__ import annotations

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.kernels import build
from brush_tpu_torch.ops.scan_cuda import stack_rows
from brush_tpu_torch.ops.tiling_key import (
    B_SCAN, combined_key, popcount_u32, tile_key_bits)

TABLE_ROWS = 17       # per-splat rows (layout in ops/tiling.py)
PAYLOAD_ROWS = 10     # xy, conic, opac, rgb, gid


def emit_sizes(n: int, k0: int, rem_cap: int) -> tuple[int, int]:
    """Static emission geometry: (s_cap, rem_cap)."""
    return n * k0 + rem_cap, rem_cap


def _tile_grid(img_size):
    img_w, img_h = img_size
    tile_bw = -(-img_w // TILE_WIDTH)
    num_tiles = tile_bw * (-(-img_h // TILE_WIDTH))
    return tile_bw, num_tiles


def _select_bit(mask: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Position of the j-th (0-based) set bit of each u32 (int64 tensors);
    callers guarantee j < popcount(mask). A 32-step elementwise scan."""
    cnt = torch.zeros_like(j)
    pos = torch.zeros_like(j)
    for b in range(B_SCAN):
        bit = (mask >> b) & 1
        pos = torch.where((bit == 1) & (cnt == j), b, pos)
        cnt = cnt + bit
    return pos


def _check_inputs(table_rows, rem_starts):
    table_rows = list(table_rows)
    if len(table_rows) != TABLE_ROWS:
        raise ValueError(f"emit_slots: {TABLE_ROWS} table rows, got "
                         f"{len(table_rows)}")
    n = rem_starts.shape[0]
    for r in table_rows:
        if r.dtype != torch.float32 or r.shape != (n,):
            raise ValueError(f"emit_slots: table rows must be f32 [{n}], "
                             f"got {r.dtype} {tuple(r.shape)}")
    if rem_starts.dtype != torch.int32 or rem_starts.dim() != 1 or n == 0:
        raise ValueError("emit_slots: rem_starts must be int32 [N], N > 0")
    return table_rows, n


def emit_slots_plain(table_rows, rem_starts, k0: int, rem_cap: int,
                     img_size: tuple[int, int]):
    """Plain PyTorch emission (the JAX package's `_emit_jnp`). Returns
    (key int64 [s_cap], rows f32 [10, s_cap])."""
    table_rows, n = _check_inputs(table_rows, rem_starts)
    tile_bw, num_tiles = _tile_grid(img_size)
    table = torch.stack(table_rows, dim=0)                 # [17, N]
    counts = table[14].to(torch.int64)
    mask = table[15].to(torch.int64) | (table[16].to(torch.int64) << 16)
    pc = popcount_u32(mask)
    depth_bits = table[10].view(torch.int32)
    starts = rem_starts.to(torch.int64)

    def tile_of(tmin_x, tmin_y, bb_w, local, in_range):
        bb_w = torch.clamp_min(bb_w.to(torch.int64), 1)
        tx = tmin_x.to(torch.int64) + local % bb_w
        ty = tmin_y.to(torch.int64) + local // bb_w
        return torch.where(in_range, ty * tile_bw + tx, num_tiles)

    def decode_local(mask, pcnt, j):
        return torch.where(j < pcnt,
                           _select_bit(mask, torch.minimum(j, pcnt)),
                           B_SCAN + j - pcnt)

    # --- dense part: slots k < min(count, k0), a per-splat broadcast ---
    kd = torch.arange(k0, dtype=torch.int64, device=table.device)[:, None]
    dense_in = kd < counts[None, :]
    local_d = decode_local(mask[None, :], pc[None, :], kd)
    tile_d = tile_of(table[11][None], table[12][None], table[13][None],
                     local_d, dense_in)                    # [k0, N]

    # --- remainder: slots k >= k0 of large splats, owner by search ---
    rem_slots = torch.arange(rem_cap, dtype=torch.int64, device=table.device)
    owner = torch.clamp(torch.searchsorted(starts, rem_slots, right=True) - 1,
                        0, n - 1)
    counts_o = counts[owner]
    start_r = torch.where(counts_o - k0 > 0, starts[owner], rem_cap)
    j_r = k0 + (rem_slots - start_r)
    local_r = decode_local(mask[owner], pc[owner], j_r)
    rem_needed = starts[-1] + torch.clamp_min(counts[-1] - k0, 0)
    rem_in = (rem_slots < rem_needed) & (j_r >= 0) & (j_r < counts_o)
    tile_r = tile_of(table[11][owner], table[12][owner], table[13][owner],
                     local_r, rem_in)

    key = combined_key(
        torch.cat([tile_d.reshape(-1), tile_r]),
        torch.cat([depth_bits[None].expand(k0, n).reshape(-1),
                   depth_bits[owner]]), num_tiles)
    payload = table[:PAYLOAD_ROWS]
    rows = torch.cat([payload[:, None, :].expand(PAYLOAD_ROWS, k0, n)
                      .reshape(PAYLOAD_ROWS, -1), payload[:, owner]], dim=1)
    return key, rows


def emit_slots(table_rows, rem_starts, k0: int, rem_cap: int,
               img_size: tuple[int, int]):
    """Emit the tile-sort operands from the per-splat table.

    table_rows: 17 f32 [N] rows (layout in ops/tiling.py; row 10 is the
    depth bit pattern viewed as f32). rem_starts: [N] int32 exclusive
    cumsum of max(counts - k0, 0). Returns (key int64 [s_cap] holding the
    u32 combined key, rows f32 [10, s_cap]: 9 payload rows + gid)."""
    table_rows, n = _check_inputs(table_rows, rem_starts)
    if rem_starts.device.type == "cpu":
        return emit_slots_plain(table_rows, rem_starts, k0, rem_cap,
                                img_size)
    kernels.require_cuda("emit_slots", rem_starts, *table_rows)
    # The kernel reads one [18, stride] table: the 17 rows plus rem_starts
    # as raw int32 words (the stack moves bits, never values).
    table = stack_rows(table_rows + [rem_starts.view(torch.float32)],
                       TABLE_ROWS + 1, n)
    return emit_from_table(table, n, k0, rem_cap, img_size)


def emit_from_table(table: torch.Tensor, n: int, k0: int, rem_cap: int,
                    img_size: tuple[int, int]):
    """Launch the emission kernel on the stacked [18, >= n] f32 table
    (rows 0..16 as in `emit_slots`, row 17 the rem_starts int32 words)."""
    kernels.require_cuda("emit_slots", table)
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[0] < TABLE_ROWS + 1 or table.shape[1] < n
            or not table.is_contiguous()):
        raise ValueError(f"emit_slots: table must be contiguous f32 "
                         f"[>= {TABLE_ROWS + 1}, >= {n}], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if n < 1 or k0 < 1 or rem_cap < 0:
        raise ValueError(f"emit_slots: n={n} k0={k0} rem_cap={rem_cap}")
    tile_bw, num_tiles = _tile_grid(img_size)
    s_cap, _ = emit_sizes(n, k0, rem_cap)
    key = torch.empty(s_cap, dtype=torch.int64, device=table.device)
    rows = torch.empty((PAYLOAD_ROWS, s_cap), dtype=torch.float32,
                       device=table.device)
    err = build.library().brush_emit_slots(
        table.data_ptr(), table.shape[1], n, k0, rem_cap, tile_bw,
        num_tiles, tile_key_bits(num_tiles), s_cap, key.data_ptr(),
        rows.data_ptr(), build.stream_ptr(table.device))
    build.check(err, "emit_slots")
    kernels.note_launch("emit", _replay_emit, kernels.same_bits, table, n, k0,
                        rem_cap, img_size)
    return key, rows


def _replay_emit(inputs):
    """The kernel slot for slot against the plain version on the table it
    read (which implies the same slot multiset)."""
    table, n, k0, rem_cap, img_size = inputs
    rows = [table[r, :n] for r in range(TABLE_ROWS)]
    starts = table[TABLE_ROWS, :n].view(torch.int32)
    return (lambda: emit_from_table(*inputs),
            lambda: emit_slots_plain(rows, starts, k0, rem_cap, img_size))
