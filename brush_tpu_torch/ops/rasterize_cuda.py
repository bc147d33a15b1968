"""Tile rasterizers: three CUDA kernels, each with a plain PyTorch version
beside it (port of `brush_tpu/ops/rasterize_pallas.py`).

* `rasterize_forward` — the forward-only ("diet") blend. Kernel
  `csrc/rasterize.cu`, replacing `_fwd_kernel` with fwd_only=True
  (rasterize_pallas.py:152, entry `rasterize_forward_pallas` :356).
* `rasterize_forward_train` — the training blend on the f32 SoA, which also
  returns each pixel's final transmittance and each tile's `useful_len`.
  The same kernel source, training variant, replacing `_fwd_kernel` with
  fwd_only=False.
* `rasterize_backward` — per-slot gradients from the image cotangent.
  Kernel `csrc/rasterize_bwd.cu`, replacing `_bwd_kernel`
  (rasterize_pallas.py:431, entry `rasterize_backward_pallas` :737).
* `rasterize_train` — the differentiable rasterizer, a
  `torch.autograd.Function` over the two training kernels (the JAX
  package's `rasterize_pallas` custom VJP, :888).

One thread block per 32x32 tile, 4 pixels per thread; the block stages
batches of the tile's slots in shared memory and every pixel blends front
to back with the sequential T *= (1 - alpha). The forward blocks end once
every pixel is done; the backward replays only the first `useful_len`
slots of a tile. Bound on the H100: operations (about 27 f32 operations
per (pixel, slot) pair the forward evaluates; 21 per pair the backward
replays and 54 more where the pair was blended).

The TPU formed T as exp(prefix sum of log(1 - alpha)) on the MXU; the
sequential product differs from it by a few ulps, so a pixel near the
T <= 1e-4 or alpha >= 1/255 gates can land on the other side of them.
Comparisons with the JAX package are therefore by quantile, or on scenes
where no pixel sits at a gate. The TPU's per-splat gradient reduce (sort by
gid, f32 prefix sum, boundary differences) existed because a TPU has no
atomics; here the backward kernel writes one gradient column per sorted
slot and the per-splat sum is an `index_add_` over the slots' splat ids.

SoA layouts (ops/tiling.py). Diet: int32 [8, S + pad] words, rows 0,1 the
tile-relative f32 x, y bit patterns, rows 2..5 the f16 pairs (c00, c01),
(c11, opac), (r, g), (b, 0), rows 6, 7 zero. Training: f32 [16, S + pad],
rows 0,1 absolute x, y, 2..4 conic, 5 opacity, 6..8 rgb, 9 gid, rest zero.
"""

from __future__ import annotations

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
GRAD_ROWS = 11                      # per-slot gradient rows
V_ROWS = 4                          # rows of a cotangent tile (rgb, alpha)
# Kernel-vs-plain rule of the forward kernels: they round every operation
# as the plain version does, in the same order, so the two agree to the
# last bit wherever expf does. A few ulps are allowed for expf; a gate flip
# (about one splat's contribution, >= 1/255 * T) or a dropped slot is far
# outside. `useful_len` and the zero rows must match exactly.
KERNEL_ULPS = 4
# Kernel-vs-plain rule of the backward kernel, per gradient row: the
# block's tree sums over a tile's pixels, expf and the fused multiply-adds
# differ from the plain version's order by rounding only; a dropped slot or
# a gate flip changes a column by a whole term.
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


def _blend_plain(fetch, tile_ranges, px, py, bg, train: bool,
                 count_pairs: bool):
    """Plain PyTorch blend: every tile and pixel at once, one slot index at
    a time. Returns the tile rows (and, with count_pairs, the number of
    (pixel, slot) pairs evaluated before each pixel was done)."""
    n_tiles = tile_ranges.shape[0]
    dev = tile_ranges.device
    starts = tile_ranges[:, 0].to(torch.int64)
    spans = (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64)
    trans = torch.ones((n_tiles, TILE_PIX), dtype=torch.float32, device=dev)
    rgb = [torch.zeros_like(trans) for _ in range(3)]
    done = torch.zeros((n_tiles, TILE_PIX), dtype=torch.bool, device=dev)
    useful = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    max_span = int(spans.max()) if n_tiles else 0
    for i in range(max_span):
        live = (spans > i)[:, None]
        vals = fetch(torch.where(spans > i, starts + i, 0))
        if count_pairs:
            pairs += (live & ~done).sum()
        _, _, _, _, _, blend, stop, next_t, weight = _blend_step(
            vals, px, py, trans, done, live)
        for c in range(3):
            col = torch.clamp_min(vals[6 + c], 0.0)[:, None]
            rgb[c] = torch.where(blend, rgb[c] + weight * col, rgb[c])
        trans = torch.where(blend, next_t, trans)
        done = done | stop
        if train:
            useful = torch.where(blend.any(dim=1), i + 1, useful)
        # Every pixel with slots left is done: nothing can change any more.
        if i % 256 == 255 and bool((done | (spans <= i + 1)[:, None]).all()):
            break
    rows = [rgb[c] + trans * bg[c] for c in range(3)] + [1.0 - trans]
    if train:
        zero = torch.zeros_like(trans)
        rows += [trans, useful.to(torch.float32)[:, None].expand_as(trans),
                 zero, zero]
    tiles = torch.stack(rows, dim=1)
    return (tiles, pairs) if count_pairs else tiles


# --------------------------------------------------------------------------
# forward only (diet)
# --------------------------------------------------------------------------


def rasterize_forward_plain(soa, tile_ranges, bg, img_size,
                            count_pairs: bool = False):
    """Plain version of `rasterize_forward`: tiles [T, 4, 1024]."""
    _check("rasterize_forward", soa, torch.int32, DIET_WORDS, tile_ranges,
           bg, img_size)
    px, py = _pixel_centres(img_size, soa.device, absolute=False)
    return _blend_plain(_fetch_diet(soa), tile_ranges, px, py, bg, False,
                        count_pairs)


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
    out = torch.empty((n_tiles, OUT_ROWS, TILE_PIX), dtype=torch.float32,
                      device=soa.device)
    err = build.library().brush_rasterize_fwd_diet(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(), bg.data_ptr(),
        out.data_ptr(), n_tiles, build.stream_ptr(soa.device))
    build.check(err, "rasterize_forward")
    kernels.note_launch("rasterize_fwd", _replay, compare, soa, tile_ranges,
                        bg, img_size)
    return out


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
    """Plain version of `rasterize_forward_train`: tiles [T, 8, 1024]."""
    _check("rasterize_forward_train", soa, torch.float32, TRAIN_ROWS,
           tile_ranges, bg, img_size)
    px, py = _pixel_centres(img_size, soa.device, absolute=True)
    return _blend_plain(_fetch_train(soa), tile_ranges, px, py, bg, True,
                        count_pairs)


def rasterize_forward_train(soa, tile_ranges, bg, img_size):
    """Rasterize the sorted f32 training SoA -> tiles [T, 8, 1024] f32: rows
    0..2 rgb + T*bg, 3 alpha = 1 - T, 4 the final T, 5 `useful_len` (one
    past the last slot any pixel of the tile blended, counted from the
    tile's start, the same value in every lane), 6, 7 zero."""
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
    err = build.library().brush_rasterize_fwd_train(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(), bg.data_ptr(),
        out.data_ptr(), n_tiles, _tile_grid(img_size)[0],
        build.stream_ptr(soa.device))
    build.check(err, "rasterize_forward_train")
    kernels.note_launch("rasterize_fwd_train", _replay_train, compare, soa,
                        tile_ranges, bg, img_size)
    return out


def _replay_train(inputs):
    return (lambda: rasterize_forward_train(*inputs),
            lambda: rasterize_forward_train_plain(*inputs))


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
    """Plain version of `rasterize_backward`: the forward replayed one slot
    index at a time over each tile's useful range, with the gradient
    formulas written out (autograd of the forward would sum away the
    per-(pixel, slot) |v_xy| the refine weight needs). Every select sits
    outside the products with conic and dx, so a slot with an infinite
    conic, which the gate drops, contributes 0 and never 0 * inf.

    Returns slot gradients [11, L] (and, with count_pairs, the numbers of
    (pixel, slot) pairs replayed and blended)."""
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
    replayed = torch.zeros((), dtype=torch.int64, device=dev)
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
            replayed += (live & ~done).sum()
            blended += blend.sum()
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
    return (out, replayed, blended) if count_pairs else out


def rasterize_backward(soa, tile_ranges, tiles, v_tiles, bg, img_size):
    """Per-slot gradients [11, L] f32 (L the SoA's width) from the image
    cotangent in tile layout `v_tiles` [T, 4, 1024] and the training
    forward's `tiles`: rows 0,1 v_xy, 2..4 v_conic, 5 v_opac, 6..8 v_rgb,
    9 the refine weight sum_p |v_xy * (W, H)| / max(alpha_p, 1e-5), 10
    sum_p w. Columns of slots past a tile's `useful_len`, and of slots in
    no tile range, are zero (the buffer is zero-filled here; the kernel
    writes only the replayed slots)."""
    n_tiles = _check_bwd(soa, tile_ranges, tiles, v_tiles, bg, img_size)
    if soa.device.type == "cpu":
        return rasterize_backward_plain(soa, tile_ranges, tiles, v_tiles, bg,
                                        img_size)
    kernels.require_cuda("rasterize_backward", soa, tile_ranges, tiles,
                         v_tiles, bg)
    soa = soa.contiguous()
    tile_ranges = tile_ranges.contiguous()
    tiles = tiles.contiguous()
    v_tiles = v_tiles.contiguous()
    bg = bg.contiguous()
    out = torch.zeros((GRAD_ROWS, soa.shape[1]), dtype=torch.float32,
                      device=soa.device)
    err = build.library().brush_rasterize_bwd(
        soa.data_ptr(), soa.shape[1], tile_ranges.data_ptr(),
        tiles.data_ptr(), v_tiles.data_ptr(), bg.data_ptr(), out.data_ptr(),
        n_tiles, _tile_grid(img_size)[0], img_size[0], img_size[1],
        build.stream_ptr(soa.device))
    build.check(err, "rasterize_backward")
    kernels.note_launch("rasterize_bwd", _replay_bwd, compare_bwd, soa,
                        tile_ranges, tiles, v_tiles, bg, img_size)
    return out


def _replay_bwd(inputs):
    return (lambda: rasterize_backward(*inputs),
            lambda: rasterize_backward_plain(*inputs))


def compare_bwd(got, want) -> float:
    """Hold the backward kernel's slot gradients to the plain version's:
    per row, every |d| <= BWD_RTOL * max|want row| + BWD_ATOL. Returns the
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
            f"rasterize_bwd: {int(bad.sum())} of {want.numel()} slot "
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
    """Sum the per-slot gradient columns per splat: [11, n]. Sentinel
    slots carry zero columns, so their (valid) splat ids add nothing."""
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
        tiles = rasterize_forward_train(soa, tile_ranges, bg, img_size)
        ctx.save_for_backward(soa, tiles, tile_ranges, gid_from_isect, bg)
        ctx.img_size = img_size
        ctx.n = mean2d.shape[0]
        return tiles_to_image(tiles, img_size)

    @staticmethod
    def backward(ctx, v_img):
        soa, tiles, tile_ranges, gid_from_isect, bg = ctx.saved_tensors
        img_size = ctx.img_size
        with stage("rasterize_bwd"):
            slot_grads = rasterize_backward(
                soa, tile_ranges, tiles, image_to_tiles(v_img, img_size), bg,
                img_size)
        with stage("reduce"):
            per_splat = reduce_slot_grads(slot_grads, gid_from_isect, ctx.n)
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
