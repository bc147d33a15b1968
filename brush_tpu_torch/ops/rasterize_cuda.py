"""Tile rasterizers: three CUDA kernels, each with a plain PyTorch version
beside it (port of `brush_tpu/ops/rasterize_pallas.py`).

* `rasterize_forward` — the forward-only ("diet") blend. Kernel
  `csrc/rasterize.cu`, replacing `_fwd_kernel` with fwd_only=True
  (rasterize_pallas.py:152, entry `rasterize_forward_pallas` :356).
* `rasterize_forward_train` — the training blend on the f32 SoA, which also
  returns each pixel's final transmittance and each tile's `useful_len`,
  and the `TileSchedule` the backward kernel takes (each tile part's own
  useful length). The same kernel source, training
  variant, replacing `_fwd_kernel` with fwd_only=False.
* `rasterize_backward_splats` — per-splat gradients from the image
  cotangent. Kernel `csrc/rasterize_bwd.cu`, replacing `_bwd_kernel`
  (rasterize_pallas.py:431, entry `rasterize_backward_pallas` :737)
  together with the per-splat reduce of `_rasterize_pallas_bwd` (:924,
  `_reduce_grads_sorted` :814). Its plain version is the per-slot
  `rasterize_backward_plain` followed by `reduce_slot_grads`.
* `rasterize_train` — the differentiable rasterizer, a
  `torch.autograd.Function` over the two training kernels (the JAX
  package's `rasterize_pallas` custom VJP, :888).

The unit of work of the forward kernels is one part of a tile, an 8x4
block of 32 pixels (`TILE_PARTS` of them a tile), one a lane of one warp;
of the backward, two parts stacked. A persistent grid takes them from an
atomic counter over the tiles in tile order (longest span first read no
faster: csrc/rasterize.cu has the figures); a warp stages its own
batches of slots in shared memory and leaves its part once its pixels are
done, and every pixel blends front to back with the sequential
T *= (1 - alpha). The backward replays only its parts' useful slots and
adds each slot's 11 warp sums into the splat's gradient row with f64
atomics, which a second launch rounds to f32. Bound on the H100: operations
(about 27 f32 operations per (pixel, slot) pair the forward evaluates; 21
per pair the backward replays up to the pixel's part's useful length and 54
more where the pair was blended).

The TPU formed T as exp(prefix sum of log(1 - alpha)) on the MXU; the
sequential product differs from it by a few ulps, so a pixel near the
T <= 1e-4 or alpha >= 1/255 gates can land on the other side of them.
Comparisons with the JAX package are therefore by quantile, or on scenes
where no pixel sits at a gate. The TPU's per-splat gradient reduce (sort by
gid, f32 prefix sum, boundary differences) existed because a TPU has no
atomics. Here the per-splat sums add in the order the atomics arrive, so on
the card they are not bit-repeatable from run to run (the f64 sums' final
rounding to f32 only; the plain version on the CPU is).

SoA layouts (ops/tiling.py). Diet: int32 [8, S + pad] words, rows 0,1 the
tile-relative f32 x, y bit patterns, rows 2..5 the f16 pairs (c00, c01),
(c11, opac), (r, g), (b, 0), rows 6, 7 zero. Training: f32 [16, S + pad],
rows 0,1 absolute x, y, 2..4 conic, 5 opacity, 6..8 rgb, 9 gid, rest zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.constants import (
    ALPHA_CAP,
    ALPHA_CUTOFF_MID,
    REFINE_ALPHA_FLOOR,
    REFINE_WEIGHT_CLAMP,
    SATURATED_ALPHA_GRAD_CUTOFF,
    TILE_WIDTH,
    TRANSMITTANCE_EPS,
)
from brush_tpu_torch.kernels import build
from brush_tpu_torch.ops.tiling_key import _unpack2f16
from brush_tpu_torch.utils.tracing import stage

TILE_PIX = TILE_WIDTH * TILE_WIDTH  # 1024
OUT_ROWS = 4                        # rgb + alpha
TRAIN_OUT_ROWS = 8                  # + final T, useful_len, two zero rows
DIET_WORDS = 6                      # payload rows the diet kernel reads
TRAIN_ROWS = 9                      # SoA rows the training kernels read
GRAD_ROWS = 11                      # gradient rows (per slot or splat)
GRAD_STRIDE = 12                    # words per splat in the kernel's output
V_ROWS = 4                          # rows of a cotangent tile (rgb, alpha)
TILE_PARTS = 32                     # 8x4-pixel parts of a tile (`_by_part`)
PART_W, PART_H = 8, 4
# Kernel-vs-plain rule of the forward kernels: they round every operation
# as the plain version does, in the same order, so the two agree to the
# last bit wherever expf does. A few ulps are allowed for expf; a gate flip
# (about one splat's contribution, >= 1/255 * T) or a dropped slot is far
# outside. `useful_len` and the zero rows must match exactly.
KERNEL_ULPS = 4
# Kernel-vs-plain rule of the backward kernel, per gradient row of the
# per-splat sums: the warps' tree sums over a row's pixels, the atomics'
# arrival order, expf and the fused multiply-adds differ from the plain
# version's order by rounding only; a dropped slot or a gate flip changes
# a splat's sum by a whole term.
BWD_RTOL = 1e-5
BWD_ATOL = 1e-8


def _tile_grid(img_size):
    img_w, img_h = img_size
    return -(-img_w // TILE_WIDTH), -(-img_h // TILE_WIDTH)


def _check(what, soa, dtype, min_rows, tile_ranges, bg, img_size) -> int:
    tbw, tbh = _tile_grid(img_size)
    n_tiles = tbw * tbh
    if soa.dtype != dtype or soa.dim() != 2 or soa.shape[0] < min_rows:
        raise ValueError(f"{what}: soa must be {dtype} [>= {min_rows}, L], "
                         f"got {soa.dtype} {tuple(soa.shape)}")
    if tile_ranges.dtype != torch.int32 or tuple(tile_ranges.shape) != (
            n_tiles, 2):
        raise ValueError(f"{what}: tile_ranges must be int32 "
                         f"[{n_tiles}, 2], got {tile_ranges.dtype} "
                         f"{tuple(tile_ranges.shape)}")
    if bg.dtype != torch.float32 or tuple(bg.shape) != (3,):
        raise ValueError(f"{what}: bg must be f32 [3]")
    return n_tiles


def _pixel_centres(img_size, device, absolute: bool):
    """Pixel-centre coordinates of every (tile, pixel): [T, 1024] absolute,
    or [1, 1024] relative to the tile's origin."""
    pix = torch.arange(TILE_PIX, device=device)
    px = (pix % TILE_WIDTH)[None, :]
    py = (pix // TILE_WIDTH)[None, :]
    if absolute:
        tbw, tbh = _tile_grid(img_size)
        t = torch.arange(tbw * tbh, device=device)[:, None]
        px = (t % tbw) * TILE_WIDTH + px
        py = (t // tbw) * TILE_WIDTH + py
    return px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5


def _fetch_diet(soa):
    words = soa[:DIET_WORDS]

    def fetch(idx):
        w = words[:, idx]                                       # [6, T]
        c00, c01 = _unpack2f16(w[2])
        c11, opac = _unpack2f16(w[3])
        r, g = _unpack2f16(w[4])
        b = _unpack2f16(w[5])[0]
        return (w[0].view(torch.float32), w[1].view(torch.float32), c00, c01,
                c11, opac, r, g, b)
    return fetch


def _fetch_train(soa):
    rows = soa[:TRAIN_ROWS]
    return lambda idx: tuple(rows[:, idx])


def _blend_step(vals, px, py, trans, done, live):
    """One slot of every tile against every pixel, in the kernels' operation
    order. `vals` are the slot's nine attributes, each [T]. Returns
    (dx, dy, gauss, og, alpha, blend, stop, next_t, weight)."""
    mx, my, c00, c01, c11, opac = (v[:, None] for v in vals[:6])
    dx = px - mx
    dy = py - my
    sigma = 0.5 * (c00 * dx * dx + c11 * dy * dy) + c01 * dx * dy
    gauss = torch.exp(-sigma)
    og = opac * gauss
    alpha = torch.clamp_max(og, ALPHA_CAP)
    gate = live & ~done & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF_MID)
    next_t = trans * (1.0 - alpha)
    stop = gate & (next_t <= TRANSMITTANCE_EPS)
    blend = gate & ~stop
    return dx, dy, gauss, og, alpha, blend, stop, next_t, alpha * trans


def _blend_plain(fetch, tile_ranges, px, py, bg, train: bool):
    """Plain PyTorch blend: every tile and pixel at once, one slot index at
    a time. Returns the tile rows, each tile part's useful length [T, 32]
    int32 (one past the last slot a pixel of that 8x4 part blended,
    counted from the tile's start; training only, else None), and the
    number of (pixel, slot) pairs evaluated before each pixel was done."""
    n_tiles = tile_ranges.shape[0]
    dev = tile_ranges.device
    starts = tile_ranges[:, 0].to(torch.int64)
    spans = (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64)
    trans = torch.ones((n_tiles, TILE_PIX), dtype=torch.float32, device=dev)
    rgb = [torch.zeros_like(trans) for _ in range(3)]
    done = torch.zeros((n_tiles, TILE_PIX), dtype=torch.bool, device=dev)
    part_useful = torch.zeros((n_tiles, TILE_PARTS), dtype=torch.int32,
                              device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    max_span = int(spans.max()) if n_tiles else 0
    for i in range(max_span):
        live = (spans > i)[:, None]
        vals = fetch(torch.where(spans > i, starts + i, 0))
        pairs += (live & ~done).sum()
        _, _, _, _, _, blend, stop, next_t, weight = _blend_step(
            vals, px, py, trans, done, live)
        for c in range(3):
            col = torch.clamp_min(vals[6 + c], 0.0)[:, None]
            rgb[c] = torch.where(blend, rgb[c] + weight * col, rgb[c])
        trans = torch.where(blend, next_t, trans)
        done = done | stop
        if train:
            part_useful = torch.where(_by_part(blend).any(2), i + 1,
                                      part_useful)
        # Every pixel with slots left is done: nothing can change any more.
        if i % 256 == 255 and bool((done | (spans <= i + 1)[:, None]).all()):
            break
    rows = [rgb[c] + trans * bg[c] for c in range(3)] + [1.0 - trans]
    if train:
        zero = torch.zeros_like(trans)
        useful = part_useful.amax(dim=1) if n_tiles else part_useful[:, 0]
        rows += [trans, useful.to(torch.float32)[:, None].expand_as(trans),
                 zero, zero]
    return torch.stack(rows, dim=1), part_useful if train else None, pairs


def _by_part(x):
    """[T, 1024] pixels (row-major in the tile) -> [T, 32, 32]: part q
    covers x in [8 (q % 4), +8), y in [4 (q / 4), +4), its pixels in row
    order (the lane order of the kernels)."""
    t = x.shape[0]
    x = x.view(t, TILE_WIDTH // PART_H, PART_H, TILE_WIDTH // PART_W, PART_W)
    return x.permute(0, 1, 3, 2, 4).reshape(t, TILE_PARTS, PART_W * PART_H)


class TileSchedule(NamedTuple):
    """What the training forward hands the backward kernel: each tile
    part's useful length, int32 [T, 32] (part q the 8x4 pixels at
    x = 8 (q % 4), y = 4 (q / 4)); the tile's `useful_len` (row 5 of its
    forward tile) is the largest of its parts'."""

    part_useful: torch.Tensor


# --------------------------------------------------------------------------
# forward only (diet)
# --------------------------------------------------------------------------


def rasterize_forward_plain(soa, tile_ranges, bg, img_size,
                            count_pairs: bool = False):
    """Plain version of `rasterize_forward`: tiles [T, 4, 1024] (and, with
    count_pairs, the (pixel, slot) pairs evaluated)."""
    _check("rasterize_forward", soa, torch.int32, DIET_WORDS, tile_ranges,
           bg, img_size)
    px, py = _pixel_centres(img_size, soa.device, absolute=False)
    tiles, _, pairs = _blend_plain(_fetch_diet(soa), tile_ranges, px, py, bg,
                                   False)
    return (tiles, pairs) if count_pairs else tiles


def rasterize_forward(soa, tile_ranges, bg, img_size):
    """Rasterize the sorted diet SoA -> tile image [T, 4, 1024] f32: rows
    0..2 rgb + T*bg, row 3 alpha = 1 - T, pixels row-major in the tile.
    `tile_ranges` holds raw [start, end) slot ranges, unaligned."""
    n_tiles = _check("rasterize_forward", soa, torch.int32, DIET_WORDS,
                     tile_ranges, bg, img_size)
    if soa.device.type == "cpu":
        return rasterize_forward_plain(soa, tile_ranges, bg, img_size)
    kernels.require_cuda("rasterize_forward", soa, tile_ranges, bg)
    soa = soa.contiguous()
    tile_ranges = tile_ranges.contiguous()
    bg = bg.contiguous()
    # The tiles and, in the word after them, the kernel's work counter
    # (cleared by the C call): one allocation.
    words = torch.empty(n_tiles * OUT_ROWS * TILE_PIX + 1,
                        dtype=torch.float32, device=soa.device)
    err = build.library().brush_rasterize_fwd_diet(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(), bg.data_ptr(),
        words.data_ptr(), words[-1:].data_ptr(), n_tiles,
        build.stream_ptr(soa.device))
    build.check(err, "rasterize_forward")
    kernels.note_launch("rasterize_fwd", _replay, compare, soa, tile_ranges,
                        bg, img_size)
    return words[:-1].view(n_tiles, OUT_ROWS, TILE_PIX)


def _replay(inputs):
    return (lambda: rasterize_forward(*inputs),
            lambda: rasterize_forward_plain(*inputs))


def compare(got, want) -> float:
    """Hold a forward kernel's tiles to the plain version's: rows 0..4
    within KERNEL_ULPS ulps of max(|want|, 1) at every value, any further
    row (`useful_len`, the zero rows) exactly. Returns the largest absolute
    difference; raises AssertionError outside the tolerance."""
    if got.shape != want.shape:
        raise AssertionError(f"rasterize: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    limit = KERNEL_ULPS * torch.finfo(torch.float32).eps * torch.clamp_min(
        want.abs(), 1.0)
    limit[:, 5:] = 0.0
    bad = ~(diff <= limit)            # NaN in either side counts as bad
    if bool(bad.any()):
        raise AssertionError(
            f"rasterize: {int(bad.sum())} of {want.numel()} values past "
            f"{KERNEL_ULPS} ulps of the plain version, {int(bad[:, 5:].sum())}"
            f" of them in the exact rows (max |d| {float(diff.max()):.3g})")
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------


def rasterize_forward_train_plain(soa, tile_ranges, bg, img_size,
                                  count_pairs: bool = False):
    """Plain version of `rasterize_forward_train`: (tiles [T, 8, 1024],
    schedule) (and, with count_pairs, the (pixel, slot) pairs evaluated)."""
    _check("rasterize_forward_train", soa, torch.float32, TRAIN_ROWS,
           tile_ranges, bg, img_size)
    px, py = _pixel_centres(img_size, soa.device, absolute=True)
    tiles, part_useful, pairs = _blend_plain(_fetch_train(soa), tile_ranges,
                                             px, py, bg, True)
    schedule = TileSchedule(part_useful)
    return (tiles, schedule, pairs) if count_pairs else (tiles, schedule)


def rasterize_forward_train(soa, tile_ranges, bg, img_size):
    """Rasterize the sorted f32 training SoA -> (tiles [T, 8, 1024] f32,
    `TileSchedule`). Tile rows: 0..2 rgb + T*bg, 3 alpha = 1 - T, 4 the
    final T, 5 `useful_len` (one past the last slot any pixel of the tile
    blended, counted from the tile's start, the same value in every lane),
    6, 7 zero. The schedule is what the backward kernel replays by."""
    n_tiles = _check("rasterize_forward_train", soa, torch.float32,
                     TRAIN_ROWS, tile_ranges, bg, img_size)
    if soa.device.type == "cpu":
        return rasterize_forward_train_plain(soa, tile_ranges, bg, img_size)
    kernels.require_cuda("rasterize_forward_train", soa, tile_ranges, bg)
    soa = soa.contiguous()
    tile_ranges = tile_ranges.contiguous()
    bg = bg.contiguous()
    out = torch.empty((n_tiles, TRAIN_OUT_ROWS, TILE_PIX),
                      dtype=torch.float32, device=soa.device)
    # The part lengths, then the kernel's scratch: its work counter and a
    # count of finished parts a tile (cleared by the C call).
    words = torch.empty(n_tiles * (TILE_PARTS + 1) + 1, dtype=torch.int32,
                        device=soa.device)
    part_useful = words[:n_tiles * TILE_PARTS].view(n_tiles, TILE_PARTS)
    err = build.library().brush_rasterize_fwd_train(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(), bg.data_ptr(),
        out.data_ptr(), words.data_ptr(),
        words[n_tiles * TILE_PARTS:].data_ptr(), n_tiles,
        _tile_grid(img_size)[0], build.stream_ptr(soa.device))
    build.check(err, "rasterize_forward_train")
    kernels.note_launch("rasterize_fwd_train", _replay_train, compare_train,
                        soa, tile_ranges, bg, img_size)
    return out, TileSchedule(part_useful)


def _replay_train(inputs):
    return (lambda: rasterize_forward_train(*inputs),
            lambda: rasterize_forward_train_plain(*inputs))


def compare_train(got, want) -> float:
    """Hold the training forward's (tiles, schedule) to the plain
    version's: the tiles by `compare`, every part's useful length
    exactly."""
    err = compare(got[0], want[0])
    for name, g, w in zip(TileSchedule._fields, got[1], want[1]):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"rasterize: schedule {name} differs from "
                                 f"the plain version's ({bad} entries)")
    return err


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------


def _check_bwd(soa, tile_ranges, tiles, v_tiles, bg, img_size) -> int:
    n_tiles = _check("rasterize_backward", soa, torch.float32, TRAIN_ROWS,
                     tile_ranges, bg, img_size)
    for name, x, rows in (("tiles", tiles, TRAIN_OUT_ROWS),
                          ("v_tiles", v_tiles, V_ROWS)):
        if x.dtype != torch.float32 or tuple(x.shape) != (n_tiles, rows,
                                                          TILE_PIX):
            raise ValueError(f"rasterize_backward: {name} must be f32 "
                             f"[{n_tiles}, {rows}, {TILE_PIX}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    return n_tiles


def rasterize_backward_plain(soa, tile_ranges, tiles, v_tiles, bg, img_size,
                             count_pairs: bool = False):
    """Per-slot gradients, the first half of `rasterize_backward_splats`'s
    plain version: the forward replayed one slot index at a time over each
    tile's useful range, with the gradient formulas written out (autograd
    of the forward would sum away the per-(pixel, slot) |v_xy| the refine
    weight needs). Every select sits outside the products with conic and
    dx, so a slot with an infinite conic, which the gate drops, contributes
    0 and never 0 * inf.

    Returns slot gradients [11, L] (and, with count_pairs, the numbers of
    (pixel, slot) pairs replayed and blended; replayed up to each 8x4
    part's own useful length, past which its pixels blend nothing, so these
    are the pairs the backward needs)."""
    n_tiles = _check_bwd(soa, tile_ranges, tiles, v_tiles, bg, img_size)
    dev = soa.device
    img_w, img_h = img_size
    out = torch.zeros((GRAD_ROWS, soa.shape[1]), dtype=torch.float32,
                      device=dev)
    starts = tile_ranges[:, 0].to(torch.int64)
    spans = torch.minimum(
        tiles[:, 5, 0].to(torch.int64),
        (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64))
    px, py = _pixel_centres(img_size, dev, absolute=True)
    fetch = _fetch_train(soa)

    t_fin, final_a = tiles[:, 4], tiles[:, 3]
    v_rgb = [v_tiles[:, c] for c in range(3)]
    f_t = (v_rgb[0] * bg[0] + v_rgb[1] * bg[1] + v_rgb[2] * bg[2]
           - v_tiles[:, 3])
    tf_ft = t_fin * f_t
    r_rem = ((tiles[:, 0] - t_fin * bg[0]) * v_rgb[0]
             + (tiles[:, 1] - t_fin * bg[1]) * v_rgb[1]
             + (tiles[:, 2] - t_fin * bg[2]) * v_rgb[2])
    inv_fa = 1.0 / torch.clamp_min(final_a, REFINE_ALPHA_FLOOR)
    trans = torch.ones_like(t_fin)
    done = torch.zeros_like(t_fin, dtype=torch.bool)
    zero = torch.zeros_like(t_fin)
    evaluated = torch.zeros_like(t_fin, dtype=torch.int64)
    part_len = torch.zeros((n_tiles, TILE_PARTS), dtype=torch.int64,
                           device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(int(spans.max()) if n_tiles else 0):
        live_t = spans > i
        live = live_t[:, None]
        idx = torch.where(live_t, starts + i, 0)
        vals = fetch(idx)
        c00, c01, c11 = (v[:, None] for v in vals[2:5])
        dx, dy, gauss, og, alpha, blend, stop, next_t, weight = _blend_step(
            vals, px, py, trans, done, live)
        if count_pairs:
            evaluated += live & ~done
            blended += blend.sum()
            part_len = torch.where(_by_part(blend).any(2), i + 1, part_len)
        cmax = [torch.clamp_min(vals[6 + c], 0.0)[:, None] for c in range(3)]
        v_w = cmax[0] * v_rgb[0] + cmax[1] * v_rgb[1] + cmax[2] * v_rgb[2]
        r_after = r_rem - weight * v_w
        v_alpha = trans * v_w - (r_after + tf_ft) / (1.0 - alpha)
        mu = blend & (og <= SATURATED_ALPHA_GRAD_CUTOFF)
        v_sigma = -og * v_alpha
        gx = torch.where(mu, -v_sigma * (c00 * dx + c01 * dy), zero)
        gy = torch.where(mu, -v_sigma * (c01 * dx + c11 * dy), zero)
        rows = [
            gx, gy,
            torch.where(mu, 0.5 * v_sigma * dx * dx, zero),
            torch.where(mu, v_sigma * dx * dy, zero),
            torch.where(mu, 0.5 * v_sigma * dy * dy, zero),
            torch.where(mu, gauss * v_alpha, zero),
        ] + [
            # gated by raw rgb > 0: the blend uses max(rgb, 0)
            torch.where(blend & (vals[6 + c] > 0.0)[:, None],
                        weight * v_rgb[c], zero) for c in range(3)
        ] + [
            torch.sqrt((gx * img_w) ** 2 + (gy * img_h) ** 2) * inv_fa,
            torch.where(blend, weight, zero),
        ]
        sums = torch.stack([r.sum(dim=1) for r in rows], dim=0)   # [11, T]
        out[:, idx[live_t]] = sums[:, live_t]
        trans = torch.where(blend, next_t, trans)
        r_rem = torch.where(blend, r_after, r_rem)
        done = done | stop
    if not count_pairs:
        return out
    # A pixel is evaluated min(span, slots until done) times; its part
    # needs min(part length, slots until done), part length <= span.
    replayed = torch.minimum(_by_part(evaluated), part_len[:, :, None]).sum()
    return out, replayed, blended


def _check_gid(gid_from_isect, n: int, width: int) -> None:
    if gid_from_isect.dtype != torch.int32 or gid_from_isect.dim() != 1:
        raise ValueError("rasterize_backward_splats: gid_from_isect must be "
                         "int32 [S]")
    if gid_from_isect.shape[0] > width or n < 0:
        raise ValueError(f"rasterize_backward_splats: "
                         f"{gid_from_isect.shape[0]} slot ids for an SoA "
                         f"{width} wide, n = {n}")


def rasterize_backward_splats_plain(soa, tile_ranges, tiles, v_tiles, bg,
                                    img_size, gid_from_isect, n: int,
                                    schedule=None):
    """Plain version of `rasterize_backward_splats`: the per-slot gradients
    of `rasterize_backward_plain` summed per splat by `reduce_slot_grads`.
    (The schedule only steers the kernel's work; the result does not
    depend on it.)"""
    _check_gid(gid_from_isect, n, soa.shape[1])
    return reduce_slot_grads(
        rasterize_backward_plain(soa, tile_ranges, tiles, v_tiles, bg,
                                 img_size), gid_from_isect, n)


def rasterize_backward_splats(soa, tile_ranges, tiles, v_tiles, bg, img_size,
                              gid_from_isect, n: int, schedule):
    """Per-splat gradients [11, n] f32 from the image cotangent in tile
    layout `v_tiles` [T, 4, 1024] and the training forward's `tiles` and
    `schedule` (`rasterize_forward_train`): rows 0,1 v_xy, 2..4
    v_conic, 5 v_opac, 6..8 v_rgb, 9 the refine weight
    sum_p |v_xy * (W, H)| / max(alpha_p, 1e-5), 10 sum_p w, each summed
    over the sorted slots whose splat id (`gid_from_isect`, int32 [S]) is
    that splat. On the card the result is a view of an [n, 12] buffer (a
    splat's 11 sums side by side for the kernel's atomics); its sums add in
    f64 in atomic order and are rounded to f32 once, so two runs may differ
    by that rounding."""
    n_tiles = _check_bwd(soa, tile_ranges, tiles, v_tiles, bg, img_size)
    _check_gid(gid_from_isect, n, soa.shape[1])
    if soa.device.type == "cpu":
        return rasterize_backward_splats_plain(
            soa, tile_ranges, tiles, v_tiles, bg, img_size, gid_from_isect, n)
    (part_useful,) = schedule
    kernels.require_cuda("rasterize_backward_splats", soa, tile_ranges,
                         tiles, v_tiles, bg, gid_from_isect, part_useful)
    if (part_useful.dtype != torch.int32
            or tuple(part_useful.shape) != (n_tiles, TILE_PARTS)):
        raise ValueError("rasterize_backward_splats: schedule must be int32 "
                         f"[{n_tiles}, {TILE_PARTS}]")
    soa = soa.contiguous()
    tile_ranges = tile_ranges.contiguous()
    tiles = tiles.contiguous()
    v_tiles = v_tiles.contiguous()
    bg = bg.contiguous()
    gid_from_isect = gid_from_isect.contiguous()
    part_useful = part_useful.contiguous()
    # The kernel's f64 sums and work counter (cleared by the C call), and
    # the [n, 12] f32 result its second launch rounds them into.
    scratch = torch.empty(n * GRAD_STRIDE + 2, dtype=torch.float64,
                          device=soa.device)
    out = torch.empty((n, GRAD_STRIDE), dtype=torch.float32,
                      device=soa.device)
    err = build.library().brush_rasterize_bwd(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(),
        part_useful.data_ptr(), gid_from_isect.data_ptr(),
        gid_from_isect.shape[0], tiles.data_ptr(), v_tiles.data_ptr(),
        bg.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, n_tiles,
        _tile_grid(img_size)[0], img_size[0], img_size[1],
        build.stream_ptr(soa.device))
    build.check(err, "rasterize_backward_splats")
    kernels.note_launch("rasterize_bwd", _replay_bwd, compare_bwd, soa,
                        tile_ranges, tiles, v_tiles, bg, img_size,
                        gid_from_isect, n, TileSchedule(part_useful))
    return out[:, :GRAD_ROWS].T


def _replay_bwd(inputs):
    return (lambda: rasterize_backward_splats(*inputs),
            lambda: rasterize_backward_splats_plain(*inputs))


def compare_bwd(got, want) -> float:
    """Hold the backward kernel's gradients to the plain version's: per
    row, every |d| <= BWD_RTOL * max|want row| + BWD_ATOL. Returns the
    largest absolute difference; raises AssertionError outside it."""
    if got.shape != want.shape:
        raise AssertionError(f"rasterize_bwd: shape {tuple(got.shape)} "
                             f"against {tuple(want.shape)}")
    diff = (got - want).abs()
    limit = BWD_RTOL * want.abs().amax(dim=1, keepdim=True) + BWD_ATOL
    bad = ~(diff <= limit)            # NaN in either side counts as bad
    if bool(bad.any()):
        rows = sorted(set(bad.nonzero()[:, 0].tolist()))
        raise AssertionError(
            f"rasterize_bwd: {int(bad.sum())} of {want.numel()} "
            f"gradients past {BWD_RTOL:g} of their row's largest (rows "
            f"{rows}, max |d| {float(diff.max()):.3g})")
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------------------
# the differentiable rasterizer
# --------------------------------------------------------------------------


def tiles_to_image(tiles, img_size):
    """[T, R, 1024] tile rows -> [H, W, 4] image of the first four rows."""
    img_w, img_h = img_size
    tbw, tbh = _tile_grid(img_size)
    img = tiles[:, :4, :].reshape(tbh, tbw, 4, TILE_WIDTH, TILE_WIDTH)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tbh * TILE_WIDTH, tbw * TILE_WIDTH, 4)
    return img[:img_h, :img_w]


def image_to_tiles(img, img_size):
    """[H, W, 4] -> [T, 4, 1024] tile layout, zero past the image's edge."""
    img_w, img_h = img_size
    tbw, tbh = _tile_grid(img_size)
    padded = img.new_zeros((tbh * TILE_WIDTH, tbw * TILE_WIDTH, V_ROWS))
    padded[:img_h, :img_w] = img
    tiles = padded.reshape(tbh, TILE_WIDTH, tbw, TILE_WIDTH, V_ROWS)
    return tiles.permute(0, 2, 4, 1, 3).reshape(tbh * tbw, V_ROWS, TILE_PIX)


def reduce_slot_grads(slot_grads, gid_from_isect, n: int):
    """Sum the per-slot gradient columns per splat: [11, n] (the per-splat
    half of the backward's plain version; the kernel sums in place).
    Sentinel slots carry zero columns, so their (valid) splat ids add
    nothing."""
    s = gid_from_isect.shape[0]
    out = torch.zeros((GRAD_ROWS, n), dtype=torch.float32,
                      device=slot_grads.device)
    return out.index_add_(1, gid_from_isect.to(torch.int64),
                          slot_grads[:, :s])


class _RasterizeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, color, opac, refine_holder,
                visible_holder, soa, tile_ranges, gid_from_isect, bg,
                img_size):
        tiles, schedule = rasterize_forward_train(
            soa, tile_ranges, bg, img_size)
        ctx.save_for_backward(soa, tiles, tile_ranges, gid_from_isect, bg,
                              schedule.part_useful)
        ctx.img_size = img_size
        ctx.n = mean2d.shape[0]
        return tiles_to_image(tiles, img_size)

    @staticmethod
    def backward(ctx, v_img):
        (soa, tiles, tile_ranges, gid_from_isect, bg,
         part_useful) = ctx.saved_tensors
        img_size = ctx.img_size
        with stage("rasterize_bwd", device=True):
            per_splat = rasterize_backward_splats(
                soa, tile_ranges, tiles, image_to_tiles(v_img, img_size), bg,
                img_size, gid_from_isect, ctx.n, TileSchedule(part_useful))
        with stage("reduce", device=True):
            v_refine = torch.clamp(
                torch.nan_to_num(per_splat[9], nan=0.0), 0.0,
                REFINE_WEIGHT_CLAMP)
            v_visible = (per_splat[10] > 0.0).to(torch.float32)
            # v_bg = sum_p T_p * v_rgb_p over the image's pixels.
            t_map = tiles_to_image(tiles[:, 4:], img_size)[..., 0]
            v_bg = (t_map[..., None] * v_img[..., :3]).sum(dim=(0, 1))
        return (per_splat[0:2].T, per_splat[2:5].T, per_splat[6:9].T,
                per_splat[5], v_refine, v_visible, None, None, None, v_bg,
                None)


def rasterize_train(mean2d, conic, color, opac, refine_holder, visible_holder,
                    soa, tile_ranges, gid_from_isect, bg, img_size):
    """The training rasterizer: [H, W, 4] image from the sorted training
    SoA, differentiable w.r.t. mean2d [N,2], conic [N,3], color [N,3],
    opac [N] and bg [3].

    The forward reads only the (detached) `soa`, `tile_ranges` and `bg`;
    the per-splat arrays are arguments so that the backward can hand their
    gradients back in global splat order. The gradients of the zeros-[N]
    `refine_holder` and `visible_holder` carry the densify refine weight
    (clamped to [0, 1e32], NaN scrubbed) and the contributed-visibility
    mask. `gid_from_isect` [S] int32 is each sorted slot's splat id."""
    n = mean2d.shape[0]
    if n >= 1 << 24:
        raise ValueError(f"rasterize_train: {n} splats; splat ids ride the "
                         f"sort as f32 payloads, exact only below 2^24")
    return _RasterizeTrain.apply(
        mean2d, conic, color, opac, refine_holder, visible_holder, soa,
        tile_ranges, gid_from_isect, bg, tuple(img_size))
