"""Exact tile counts: per splat, the exact-hit mask over its first B_SCAN
bbox-local tiles and its exact emission count, in one pass.

Kernel `csrc/tile_counts.cu`. It replaces no TPU kernel: the JAX package
computes the counts in jnp over an [N, B_SCAN] grid of (splat, tile) pairs
(`brush_tpu/ops/tiling.py` `exact_tile_counts`), which XLA fuses into one
pass. Run as PyTorch operations, the same grid (`tile_counts_plain`) is
about 110 elementwise passes over [N, 32] operands. The kernel takes one
thread a splat: the row is read once, a splat whose bbox holds no tile
leaves after reading its count, and the exact test runs only on the
min(count, B_SCAN) tiles the mask keeps.

Bound on the H100: bytes. A splat whose bbox holds a tile reads 40 bytes
(mean, conic, threshold, tile_min, tile_max's x, bbox count), another its
count alone, and each writes 12 (the mask as int64, the count as int32).

The kernel repeats `will_contribute`'s float32 operations in their order
with round-to-nearest intrinsics (no FMA contraction), so its mask and
count equal the plain version's bit for bit. The power threshold
ln(255 * opac) comes in from the caller, formed by the plain version's
own PyTorch operations.
"""

from __future__ import annotations

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.kernels import build
from brush_tpu_torch.ops.tiling_key import B_SCAN, popcount_u32


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


def _check_inputs(mean2d, conic, power_threshold, tile_min, tile_max,
                  num_tiles_bbox) -> int:
    n = num_tiles_bbox.shape[0]
    want = ((mean2d, torch.float32, (n, 2), "mean2d"),
            (conic, torch.float32, (n, 3), "conic"),
            (power_threshold, torch.float32, (n,), "power_threshold"),
            (tile_min, torch.int32, (n, 2), "tile_min"),
            (tile_max, torch.int32, (n, 2), "tile_max"),
            (num_tiles_bbox, torch.int32, (n,), "num_tiles_bbox"))
    for t, dtype, shape, what in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"tile_counts: {what} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    return n


def tile_counts_plain(mean2d, conic, power_threshold, tile_min, tile_max,
                      num_tiles_bbox):
    """Plain PyTorch counts over the [N, B_SCAN] grid (the JAX package's
    jnp `exact_tile_counts`). Returns (mask [N] int64 holding a u32,
    counts_x [N] int32)."""
    _check_inputs(mean2d, conic, power_threshold, tile_min, tile_max,
                  num_tiles_bbox)
    dev = num_tiles_bbox.device
    jloc = torch.arange(B_SCAN, dtype=torch.int32, device=dev)[None, :]
    bb_w = torch.clamp_min(tile_max[:, 0] - tile_min[:, 0], 1)[:, None]
    tx = tile_min[:, 0:1] + jloc % bb_w
    ty = tile_min[:, 1:2] + jloc // bb_w
    hit = will_contribute(
        tx, ty, mean2d[:, 0:1], mean2d[:, 1:2],
        conic[:, 0:1], conic[:, 1:2], conic[:, 2:3],
        power_threshold[:, None])
    hit = hit & (jloc < torch.clamp_max(num_tiles_bbox, B_SCAN)[:, None])
    bits = torch.arange(B_SCAN, dtype=torch.int64, device=dev)[None, :]
    mask = (hit.to(torch.int64) << bits).sum(dim=1)
    pc = popcount_u32(mask).to(torch.int32)
    counts_x = pc + torch.clamp_min(num_tiles_bbox - B_SCAN, 0)
    return mask, counts_x


def tile_counts(mean2d, conic, power_threshold, tile_min, tile_max,
                num_tiles_bbox):
    """Exact-hit mask and exact emission count of every splat.

    mean2d [N, 2] and conic [N, 3] f32, power_threshold [N] f32
    (ln(255 * opac)), tile_min and tile_max [N, 2] int32, num_tiles_bbox
    [N] int32. Returns (mask [N] int64 holding a u32: bit j says bbox-local
    tile j passes the exact test; counts_x [N] int32 = popcount(mask) +
    max(num_tiles_bbox - B_SCAN, 0)). CPU tensors take the plain version,
    CUDA tensors the kernel."""
    inputs = (mean2d, conic, power_threshold, tile_min, tile_max,
              num_tiles_bbox)
    n = _check_inputs(*inputs)
    if num_tiles_bbox.device.type == "cpu":
        return tile_counts_plain(*inputs)
    kernels.require_cuda("tile_counts", *inputs)
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("tile_counts: the kernel's inputs must be "
                         "contiguous")
    dev = num_tiles_bbox.device
    mask = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return mask, counts
    err = build.library().brush_tile_counts(
        *(t.data_ptr() for t in inputs), n, mask.data_ptr(),
        counts.data_ptr(), build.stream_ptr(dev))
    build.check(err, "tile_counts")
    kernels.note_launch("tile_counts", _replay_tile_counts, kernels.same_bits,
                        *inputs)
    return mask, counts


def _replay_tile_counts(inputs):
    """The kernel against the plain version on the rows it read: mask and
    count bit for bit."""
    return (lambda: tile_counts(*inputs),
            lambda: tile_counts_plain(*inputs))
