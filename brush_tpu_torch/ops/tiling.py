"""Tile binning: exact tile counts -> slot emission -> key sort -> SoA
(port of `brush_tpu/ops/tiling.py`).

Everything runs in global splat order; depth order comes from the sort
key (positive-float bit patterns order as unsigned ints). Each splat's
first k0 exact-hit tiles fill a dense [k0, N] slot region and the rest go
to a remainder region of `isect_cap` slots, so the sorted space has
N*k0 + isect_cap slots. Slots past the true count carry the sentinel tile
id `num_tiles` and sort past every real tile. `num_isects` reports the
remainder slots needed, so a caller can retry with a larger cap.

On this path:
  * `cumsum_rows` (ops/scan_cuda.py) forms the remainder starts;
  * `emit_slots` (ops/emit_cuda.py) writes the sort operands;
  * a stable `torch.sort` on the int64 key + index_select of the payload
    rows is the sort, and `torch.searchsorted` finds the tile ranges;
  * `stack_rows` (ops/scan_cuda.py) assembles the SoA.

Two variants, as in the JAX package. Forward only (`with_bwd_info=False`):
the payload diets to 6 words a slot before the sort and the SoA has 8
int32 rows. Training (`with_bwd_info=True`): the nine f32 payload rows and
the splat id ride the sort as they are, the SoA has 16 f32 rows (0,1 xy
absolute, 2..4 conic, 5 opacity, 6..8 rgb, 9 gid, rest zero), and the
per-splat surviving-slot counts and starts are formed. Binning carries no
gradient: it runs without autograd on detached inputs, and the parameter
gradients come from the rasterizer's backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.emit_cuda import emit_sizes, emit_slots
from brush_tpu_torch.ops.projection import ProjectedSplats
from brush_tpu_torch.ops.scan_cuda import cumsum_rows, stack_rows
from brush_tpu_torch.ops.tiling_key import (
    B_SCAN,
    pack_fwd_rows,
    popcount_u32,
    sort_packed,
    tile_boundary_keys,
)
from brush_tpu_torch.utils.tracing import stage

# The forward-only diet SoA, as in the JAX package: the 6 pack_fwd_rows
# words + 2 zero rows. The training SoA: 9 payload rows + gid + 6 zero rows.
DIET_SOA_ROWS = 8
SOA_ROWS = 16
# Chunk length of the JAX rasterizer; `num_chunks` keeps its meaning (the
# JAX backward's gradient capacity, which the trainer's overflow gate still
# compares), and LANE_PAD keeps the SoA shape.
CK = 256
LANE_PAD = CK + 128


class Intersections(NamedTuple):
    num_visible: torch.Tensor      # [] int32
    num_isects: torch.Tensor       # [] int32 REMAINDER slots needed
    num_bbox_tail: torch.Tensor    # [] int32 slots on bbox-tail semantics
    num_isects_aligned: torch.Tensor  # [] int32 chunk-space slots (NC*CK)
    gid_from_isect: torch.Tensor   # [S] int32 splat id per sorted slot
    #   ([0] forward only)
    tile_ranges: torch.Tensor      # [T,2] int32 raw (start, end)
    soa: torch.Tensor              # [16, S + LANE_PAD] f32 training SoA, or
    #   [8, S + LANE_PAD] int32 diet SoA words forward only
    chunk_starts: torch.Tensor     # [T] int32 exclusive cumsum of chunks
    num_chunks: torch.Tensor       # [] int32 total chunks
    surv_starts_g: torch.Tensor    # [N] int32 exclusive cumsum of the counts
    surv_counts_g: torch.Tensor    # [N] int32 slots each splat emitted
    #   (both [0] forward only)


def will_contribute(tile_x, tile_y, mx, my, c00, c01, c11, power_threshold):
    """Exact (conservative) gaussian-vs-tile test, StopThePop style
    (helpers.rs will_primitive_contribute:223-260). All args broadcast."""
    tw = float(TILE_WIDTH)
    min_x = tile_x.to(torch.float32) * tw
    min_y = tile_y.to(torch.float32) * tw
    max_x = min_x + tw
    max_y = min_y + tw

    x_left = mx < min_x
    x_right = mx > max_x
    in_x = ~(x_left | x_right)
    y_above = my < min_y
    y_below = my > max_y
    in_y = ~(y_above | y_below)

    corner_x = torch.where(x_left, min_x, max_x)
    corner_y = torch.where(y_above, min_y, max_y)
    dxf = torch.where(x_left, tw, -tw)
    dyf = torch.where(y_above, tw, -tw)
    diff_x = mx - corner_x
    diff_y = my - corner_y

    tx_den = dxf * c00 * dxf
    ty_den = dyf * c11 * dyf
    tx_raw = (dxf * c00 * diff_x + dxf * c01 * diff_y) / torch.where(
        tx_den != 0, tx_den, 1.0)
    ty_raw = (dyf * c01 * diff_x + dyf * c11 * diff_y) / torch.where(
        ty_den != 0, ty_den, 1.0)
    tx = torch.where(in_y, 0.0, torch.clamp(tx_raw, 0.0, 1.0))
    ty = torch.where(in_x, 0.0, torch.clamp(ty_raw, 0.0, 1.0))

    px = corner_x + tx * dxf
    py = corner_y + ty * dyf
    ddx = px - mx
    ddy = py - my
    sigma = 0.5 * (c00 * ddx * ddx + c11 * ddy * ddy) + c01 * ddx * ddy
    return (in_x & in_y) | (sigma <= power_threshold)


def _power_threshold(opac):
    """ln(255*opac), the alpha-cutoff iso-level (project_forward.rs:96)."""
    return torch.log(torch.clamp_min(opac, 1e-30) * 255.0)


def exact_tile_counts(proj: ProjectedSplats):
    """Per-splat exact-hit bitmask over the first B_SCAN bbox-local tiles
    and the exact emission count.

    Returns (mask [N] int64 holding a u32, counts_x [N] int32): bit j of
    mask says bbox-local tile j passes the exact test, and
    counts_x = popcount(mask) + max(bbox_count - B_SCAN, 0)."""
    counts_bb = proj.num_tiles_bbox.to(torch.int32)
    dev = counts_bb.device
    jloc = torch.arange(B_SCAN, dtype=torch.int32, device=dev)[None, :]
    bb_w = torch.clamp_min(proj.tile_max[:, 0] - proj.tile_min[:, 0],
                           1)[:, None]
    tx = proj.tile_min[:, 0:1] + jloc % bb_w
    ty = proj.tile_min[:, 1:2] + jloc // bb_w
    hit = will_contribute(
        tx, ty, proj.mean2d[:, 0:1], proj.mean2d[:, 1:2],
        proj.conic[:, 0:1], proj.conic[:, 1:2], proj.conic[:, 2:3],
        _power_threshold(proj.opac)[:, None])
    hit = hit & (jloc < torch.clamp_max(counts_bb, B_SCAN)[:, None])
    bits = torch.arange(B_SCAN, dtype=torch.int64, device=dev)[None, :]
    mask = (hit.to(torch.int64) << bits).sum(dim=1)
    pc = popcount_u32(mask).to(torch.int32)
    counts_x = pc + torch.clamp_min(counts_bb - B_SCAN, 0)
    return mask, counts_x


def _cumsum_flat(x):
    """Inclusive 1-D int32 prefix sum through the scan kernel."""
    return cumsum_rows(x[None, :])[0]


@torch.no_grad()
def build_intersections(
    proj: ProjectedSplats,
    img_size: tuple[int, int],
    isect_cap: int,
    expand_k0: int = 4,
    chunk_cap: int | None = None,
    with_bwd_info: bool = True,
) -> Intersections:
    del chunk_cap  # the JAX backward's gradient capacity: the caller's
    #   business (RenderConfig.resolved_chunk_cap), unused by the binning
    img_w, img_h = img_size
    tile_bw = -(-img_w // TILE_WIDTH)
    tile_bh = -(-img_h // TILE_WIDTH)
    num_tiles = tile_bw * tile_bh
    n = proj.depth.shape[0]
    dev = proj.depth.device
    k0 = max(int(expand_k0), 1)
    rem_cap = int(isect_cap)

    with stage("counts"):
        num_visible = proj.visible.sum().to(torch.int32)
        hit_mask, counts = exact_tile_counts(proj)
        pc = popcount_u32(hit_mask).to(torch.int32)
        num_bbox_tail = (counts - pc).sum().to(torch.int32)
        depth_bits = torch.clamp_min(proj.depth, 0.0).view(torch.int32)
        # Per-splat table rows (layout of the JAX package's emission
        # table). Floats carry the small ints exactly; the depth key rides
        # as a raw bit pattern (row 10).
        table_rows = [
            proj.mean2d[:, 0], proj.mean2d[:, 1],
            proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
            proj.opac,
            proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
            torch.arange(n, dtype=torch.float32, device=dev),   # gid
            depth_bits.view(torch.float32),
            proj.tile_min[:, 0].to(torch.float32),
            proj.tile_min[:, 1].to(torch.float32),
            torch.clamp_min(proj.tile_max[:, 0] - proj.tile_min[:, 0],
                            1).to(torch.float32),
            counts.to(torch.float32),                           # exact count
            (hit_mask & 0xFFFF).to(torch.float32),
            (hit_mask >> 16).to(torch.float32),
        ]
        rem_counts = torch.clamp_min(counts - k0, 0)

    with stage("scan"):
        rem_cum = _cumsum_flat(rem_counts)
        rem_needed = rem_cum[-1].to(torch.int32)
        rem_starts = (rem_cum - rem_counts).to(torch.int32)

    with stage("emit"):
        key, rows10 = emit_slots(table_rows, rem_starts, k0, rem_cap,
                                 img_size)
        s_cap, eff_rem_cap = emit_sizes(n, k0, rem_cap)

    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    if with_bwd_info:
        # The ten f32 rows (9 payload + gid) ride the sort as they are.
        with stage("sort"):
            key_sorted, rows_sorted = sort_packed(
                key, [rows10[r] for r in range(10)])
            gid_from_isect = rows_sorted[9].to(torch.int32)
        soa_rows = SOA_ROWS
    else:
        # The payload diets to 6 words a slot before the sort (tiling_key).
        with stage("pack"):
            packed = pack_fwd_rows(key, [rows10[r] for r in range(9)],
                                   num_tiles, tile_bw)
        with stage("sort"):
            key_sorted, rows_sorted = sort_packed(key, packed)
        gid_from_isect = empty
        soa_rows = DIET_SOA_ROWS

    with stage("stack"):
        soa = stack_rows(rows_sorted, soa_rows, s_cap + LANE_PAD)

    with stage("ranges"):
        bounds = torch.searchsorted(
            key_sorted, tile_boundary_keys(num_tiles, dev),
            side="left").to(torch.int32)
        counts_t = bounds[1:] - bounds[:-1]
        tile_ranges = torch.stack([bounds[:-1], bounds[1:]], dim=-1)
        nchunks = (counts_t + CK - 1) // CK
        ccum = torch.cumsum(nchunks, dim=0, dtype=torch.int32)
        num_chunks = ccum[-1]
        chunk_starts = ccum - nchunks

    # Slots each splat really emitted: its exact count, less the remainder
    # slots cut off where the remainder region overflowed (the emission's
    # remainder width is rem_cap itself in this layout).
    if with_bwd_info:
        with stage("scan"):
            avail_rem = torch.clamp_min(eff_rem_cap - rem_starts, 0)
            emitted = torch.minimum(counts, k0 + avail_rem)
            surv_starts_g = _cumsum_flat(emitted) - emitted
    else:
        emitted = surv_starts_g = empty

    return Intersections(
        num_visible=num_visible,
        num_isects=rem_needed,
        num_bbox_tail=num_bbox_tail,
        num_isects_aligned=num_chunks * CK,
        gid_from_isect=gid_from_isect,
        tile_ranges=tile_ranges,
        soa=soa,
        chunk_starts=chunk_starts,
        num_chunks=num_chunks,
        surv_starts_g=surv_starts_g,
        surv_counts_g=emitted,
    )
