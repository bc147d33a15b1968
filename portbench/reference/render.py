"""Plain PyTorch Gaussian splat rendering, written from the method: EWA
projection with Brush's gates, degree-3 spherical harmonics, 32x32 tiles
with Brush's exact tile test, depth order, and front-to-back blending with
the 1/255 alpha cutoff, the 0.999 alpha cap and the 1e-4 transmittance
stop (Brush brush-render kernels; constants as published there).

`dtype` computes everything in another precision (the benchmark's control
runs it in bfloat16); gates, binning and counting always run in float32 on
detached values. The blend runs a chunk of slots at a time over the tiles
still open, and a tile leaves once every pixel in it has stopped, so work
follows what a pixel really evaluates. `rasterize(..., tiles=block)` under
autograd gives the gradients of a block of tiles, so a backward fits in
memory at any image size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.camera import View

TILE = 32
TILE_PIX = TILE * TILE
CHUNK = 32
B_SCAN = 32               # bbox-local tiles given the exact test
ALPHA_MIN = 1.0 / 255.0
ALPHA_CAP = 0.999
T_EPS = 1.0e-4
NEAR = 0.01
COV_BLUR = 0.3
SH_C0 = 0.2820948
COLOR_OFFSET = 0.5
COLOR_CLAMP = 100.0


class Projected(NamedTuple):
    mean2d: torch.Tensor   # [N, 2]
    conic: torch.Tensor    # [N, 3] (c00, c01, c11) of the blurred cov^-1
    color: torch.Tensor    # [N, 3]
    opac: torch.Tensor     # [N]
    depth: torch.Tensor    # [N] float32, detached
    visible: torch.Tensor  # [N] bool
    extent: torch.Tensor   # [N, 2] float32 pixels where alpha >= 1/255


class Bins(NamedTuple):
    gid: torch.Tensor         # [S] splat of each slot, tile-major, by depth
    start: torch.Tensor       # [T] first slot of each tile
    end: torch.Tensor         # [T]
    counts: torch.Tensor      # [N] slots of each splat (exact test)
    tile_grid: tuple          # (tiles across, tiles down)
    tile: torch.Tensor        # [S] tile of each slot
    rank: torch.Tensor        # [S] the slot's place among its splat's slots,
    #                           in the splat's bounding-box order

    @property
    def num_slots(self) -> int:
        return int(self.gid.shape[0])

    def remainder(self, k0: int) -> int:
        """Slots past each splat's first k0 (Brush's remainder region)."""
        return int(torch.clamp_min(self.counts - k0, 0).sum())

    def num_chunks(self, k0: int, rem_cap: int, chunk: int = 256) -> int:
        """Sum over tiles of ceil(slots / chunk), of the slots a space of
        k0 slots a splat and `rem_cap` more holds: splat i's slots past its
        first k0 go to the shared region at the sum of the excess of
        splats 0..i-1, and those past `rem_cap` are lost."""
        rem = torch.clamp_min(self.counts - k0, 0)
        rem_start = torch.cumsum(rem, 0) - rem
        kept = (self.rank < k0) | (
            rem_start[self.gid] + self.rank - k0 < rem_cap)
        n = torch.bincount(self.tile[kept], minlength=self.start.numel())
        return int(((n + chunk - 1) // chunk).sum())


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis to degree 3 of unit directions [N, 3] -> [N, 16]
    (Sloan's normalisation and signs, as Brush's sh.rs)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    z2 = z * z
    fc1 = x * x - y * y
    fs1 = 2.0 * x * y
    fc2 = x * fc1 - y * fs1
    fs2 = x * fs1 + y * fc1
    f0c = -2.285229 * z2 + 0.4570458
    f1b = 1.4453057 * z
    return torch.stack([
        torch.full_like(x, SH_C0),
        -0.4886025 * y, 0.4886025 * z, -0.4886025 * x,
        0.54627424 * fs1, -1.0925485 * z * y, 0.9461747 * z2 - 0.31539157,
        -1.0925485 * z * x, 0.54627424 * fc1,
        -0.5900436 * fs2, f1b * fs1, f0c * y, z * (1.8658817 * z2 - 1.119529),
        f0c * x, f1b * fc1, -0.5900436 * fc2,
    ], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions wxyz [N, 4] -> rotation matrices [N, 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def project(means, log_scales, quats, sh, raw_opac, view: View,
            dtype=torch.float32) -> Projected:
    """Project splats into `view`. Differentiable in the five arrays
    (through mean2d, conic, color, opac); a culled splat has opacity 0."""
    dev = means.device
    means, log_scales, quats, sh, raw_opac = (
        x.to(dtype) for x in (means, log_scales, quats, sh, raw_opac))
    rot = torch.as_tensor(view.rot, dtype=torch.float32).to(dev, dtype)
    trans = torch.as_tensor(view.trans, dtype=torch.float32).to(dev, dtype)
    fx, fy, cx, cy = (float(torch.tensor(v, dtype=torch.float32))
                      for v in (view.fx, view.fy, view.cx, view.cy))
    m0, m1, m2 = means.unbind(-1)
    mean_c = torch.stack([m0 * rot[i, 0] + m1 * rot[i, 1] + m2 * rot[i, 2]
                          + trans[i] for i in range(3)], -1)
    x, y, z = mean_c.unbind(-1)
    scale = torch.exp(log_scales)
    qn = quats / torch.sqrt(torch.clamp_min(
        (quats * quats).sum(-1, keepdim=True), 1e-32))
    m = (rot @ quat_to_rot(qn)) * scale[:, None, :]          # R_cam R_q S
    lx0, lx1, ly0, ly1 = view.clamp_limits()
    xn = torch.clamp(x / z, lx0, lx1)
    yn = torch.clamp(y / z, ly0, ly1)
    zero = torch.zeros_like(z)
    jac = torch.stack([fx / z, zero, -fx * xn / z,
                       zero, fy / z, -fy * yn / z], -1).reshape(-1, 2, 3)
    v = jac @ m                                               # [N, 2, 3]
    cov = v @ v.transpose(1, 2)
    c00 = cov[:, 0, 0] + COV_BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + COV_BLUR
    det = c00 * c11 - c01 * c01
    safe_det = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c11, -c01, c00], -1) / safe_det[:, None]
    mean2d = torch.stack([fx * x / z + cx, fy * y / z + cy], -1)
    cam_pos = torch.as_tensor(view.position, dtype=torch.float32).to(
        dev, dtype)
    d = means - cam_pos
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    color = (sh_basis(d)[:, :, None] * sh[:, :16, :]).sum(1) + COLOR_OFFSET
    color = torch.clamp(color, -COLOR_CLAMP, COLOR_CLAMP)
    opac = torch.sigmoid(raw_opac)

    with torch.no_grad():
        zf, opf = z.float(), opac.float()
        con = conic.float()
        m2 = mean2d.float()
        ok = torch.isfinite(mean_c.float()).all(-1) & (zf >= NEAR)
        ok &= torch.isfinite(scale.float()).all(-1) & (det.float() > 0)
        ok &= opf >= ALPHA_MIN
        power = torch.log(torch.clamp_min(opf, 1e-30) * 255.0)
        cdet = con[:, 0] * con[:, 2] - con[:, 1] * con[:, 1]
        ok &= cdet > 0
        cinv = 1.0 / torch.where(cdet > 0, cdet, torch.ones_like(cdet))
        ex = torch.sqrt(torch.clamp_min(2.0 * power * con[:, 2] * cinv, 0.0))
        ey = torch.sqrt(torch.clamp_min(2.0 * power * con[:, 0] * cinv, 0.0))
        ok &= ((m2[:, 0] + ex > 0) & (m2[:, 0] - ex < view.width)
               & (m2[:, 1] + ey > 0) & (m2[:, 1] - ey < view.height))
        ok &= torch.isfinite(m2).all(-1) & torch.isfinite(con).all(-1)
    opac = torch.where(ok, opac, torch.zeros_like(opac))
    return Projected(mean2d=mean2d, conic=conic, color=color, opac=opac,
                     depth=zf.detach(), visible=ok,
                     extent=torch.stack([ex, ey], -1))


def _tile_hit(tx, ty, mx, my, c00, c01, c11, power):
    """Whether the ellipse sigma <= power reaches tile (tx, ty): the
    closest point of the tile's edge to the centre, along each axis
    (Brush helpers.rs will_primitive_contribute)."""
    tw = float(TILE)
    x0, y0 = tx.float() * tw, ty.float() * tw
    x1, y1 = x0 + tw, y0 + tw
    left, right = mx < x0, mx > x1
    above, below = my < y0, my > y1
    in_x, in_y = ~(left | right), ~(above | below)
    cx = torch.where(left, x0, x1)
    cy = torch.where(above, y0, y1)
    sx = torch.where(left, tw, -tw)
    sy = torch.where(above, tw, -tw)
    dx, dy = mx - cx, my - cy
    den_x, den_y = sx * c00 * sx, sy * c11 * sy
    tx_raw = (sx * c00 * dx + sx * c01 * dy) / torch.where(
        den_x != 0, den_x, torch.ones_like(den_x))
    ty_raw = (sy * c01 * dx + sy * c11 * dy) / torch.where(
        den_y != 0, den_y, torch.ones_like(den_y))
    tx_ = torch.where(in_y, torch.zeros_like(tx_raw), tx_raw.clamp(0.0, 1.0))
    ty_ = torch.where(in_x, torch.zeros_like(ty_raw), ty_raw.clamp(0.0, 1.0))
    px, py = cx + tx_ * sx - mx, cy + ty_ * sy - my
    sigma = 0.5 * (c00 * px * px + c11 * py * py) + c01 * px * py
    return (in_x & in_y) | (sigma <= power)


def slot_counts(p: Projected, width: int, height: int) -> torch.Tensor:
    """[N] slots of each splat, as `bin_splats` makes them."""
    g, _, _ = _slots(p, width, height)
    return torch.bincount(g, minlength=p.depth.shape[0])


def bin_splats(p: Projected, width: int, height: int, k0: int = 4) -> Bins:
    """Tile-splat slots: each visible splat in the tiles of its bounding
    box that pass the exact test (the first B_SCAN tiles of the box; past
    those every tile of the box), sorted by Brush's 32-bit key: the tile
    in the top bits, then the float bits of the depth with as many low
    bits dropped as the tile takes. Equal keys keep the order of emission:
    each splat's first k0 slots, the k-th of every splat in splat order
    for k = 0 .. k0-1, then the rest of each splat's, splat by splat."""
    tw, th = -(-width // TILE), -(-height // TILE)
    n = p.depth.shape[0]
    g, tile, rank = _slots(p, width, height)
    with torch.no_grad():
        counts = torch.bincount(g, minlength=n)
        rem = torch.clamp_min(counts - k0, 0)
        rem_start = torch.cumsum(rem, 0) - rem
        emitted = torch.where(rank < k0, rank * n + g,
                              n * k0 + rem_start[g] + rank - k0)
        by_emission = torch.sort(emitted).indices
        g, tile, rank = g[by_emission], tile[by_emission], rank[by_emission]
        tb = max((tw * th).bit_length(), 1)
        bits = torch.clamp_min(p.depth[g], 0.0).view(torch.int32).to(
            torch.int64) & 0xFFFFFFFF
        key = (tile << 32) | (bits >> tb)
        order = torch.sort(key, stable=True).indices
        gid, tile, rank = g[order], tile[order], rank[order]
        per_tile = torch.bincount(tile, minlength=tw * th)
        end = torch.cumsum(per_tile, 0)
    return Bins(gid=gid, start=end - per_tile, end=end, counts=counts,
                tile_grid=(tw, th), tile=tile, rank=rank)


def _slots(p: Projected, width: int, height: int):
    """The slots of the visible splats, splat by splat and in each
    splat's bounding-box order: their splat, tile, and place among the
    splat's slots."""
    tw, th = -(-width // TILE), -(-height // TILE)
    dev = p.depth.device
    with torch.no_grad():
        m2 = p.mean2d.detach().float()
        con = p.conic.detach().float()
        ext = p.extent
        x0 = torch.clamp(m2[:, 0] / TILE - ext[:, 0] / TILE, 0, tw).to(
            torch.int64)
        y0 = torch.clamp(m2[:, 1] / TILE - ext[:, 1] / TILE, 0, th).to(
            torch.int64)
        x1 = torch.clamp(m2[:, 0] / TILE + ext[:, 0] / TILE + 1, 0, tw).to(
            torch.int64)
        y1 = torch.clamp(m2[:, 1] / TILE + ext[:, 1] / TILE + 1, 0, th).to(
            torch.int64)
        vis = torch.nonzero(p.visible).squeeze(1)
        bw = torch.clamp_min(x1[vis] - x0[vis], 1)
        nbb = ((x1[vis] - x0[vis]) * (y1[vis] - y0[vis])).clamp_min(0)
        owner = torch.repeat_interleave(
            torch.arange(vis.numel(), device=dev), nbb)
        first = torch.cumsum(nbb, 0) - nbb
        j = torch.arange(owner.numel(), device=dev) - first[owner]
        g = vis[owner]
        tx = x0[g] + j % bw[owner]
        ty = y0[g] + j // bw[owner]
        power = torch.log(torch.clamp_min(p.opac.detach().float(), 1e-30)
                          * 255.0)
        hit = _tile_hit(tx, ty, m2[g, 0], m2[g, 1], con[g, 0], con[g, 1],
                        con[g, 2], power[g])
        keep = hit | (j >= B_SCAN)
        g, tile, owner = g[keep], (ty * tw + tx)[keep], owner[keep]
        per_owner = torch.bincount(owner, minlength=vis.numel())
        rank = (torch.arange(g.numel(), device=dev)
                - (torch.cumsum(per_owner, 0) - per_owner)[owner])
    return g, tile, rank


class BlendCounts:
    """What a blend evaluated: (pixel, slot) pairs before each pixel
    stopped, the pairs that added to a pixel, and the splats that did."""

    def __init__(self, n: int, device):
        self.evaluated = 0
        self.blended = 0
        self.contributed = torch.zeros(n, dtype=torch.bool, device=device)


def rasterize(p: Projected, bins: Bins, bg: torch.Tensor,
              tiles: torch.Tensor | None = None,
              counts: BlendCounts | None = None) -> torch.Tensor:
    """Blend the tiles `tiles` (all by default) front to back: [B, 1024, 4]
    of rgb + T * bg and 1 - T, pixels row-major within a tile.
    Differentiable in p.mean2d, p.conic, p.color and p.opac."""
    dev = p.mean2d.device
    dtype = p.mean2d.dtype
    tw, th = bins.tile_grid
    if tiles is None:
        tiles = torch.arange(tw * th, device=dev)
    b = tiles.numel()
    start, end = bins.start[tiles], bins.end[tiles]
    pix = torch.arange(TILE_PIX, device=dev)
    px = ((tiles % tw)[:, None] * TILE + pix % TILE).to(dtype) + 0.5
    py = ((tiles // tw)[:, None] * TILE + pix // TILE).to(dtype) + 0.5
    trans = torch.ones((b, TILE_PIX), dtype=dtype, device=dev)
    done = torch.zeros((b, TILE_PIX), dtype=torch.bool, device=dev)
    rgb = torch.zeros((b, TILE_PIX, 3), dtype=dtype, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    n_slots = max(bins.num_slots, 1)
    act = torch.nonzero(end > start).squeeze(1)
    c0 = 0
    while act.numel():
        idx = start[act, None] + c0 + lane
        valid = idx < end[act, None]
        g = bins.gid[idx.clamp(max=n_slots - 1)] if bins.num_slots else (
            torch.zeros_like(idx))
        xy, con = p.mean2d[g], p.conic[g]                   # [A, C, .]
        dx = px[act, None, :] - xy[..., 0:1]
        dy = py[act, None, :] - xy[..., 1:2]
        sigma = (0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy)
                 + con[..., 1:2] * dx * dy)
        alpha = torch.clamp_max(p.opac[g][..., None] * torch.exp(-sigma),
                                ALPHA_CAP)
        gate = (sigma >= 0) & (alpha >= ALPHA_MIN) & valid[..., None]
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - a
        cp = torch.cumprod(one_minus, dim=1)
        t_in = trans[act][:, None, :]
        s_incl = t_in * cp
        s_excl = t_in * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]],
                                  dim=1)
        done_in = done[act]
        blend = (s_incl > T_EPS) & ~done_in[:, None, :]
        w = torch.where(blend, a * s_excl, torch.zeros_like(a))
        col = torch.clamp_min(p.color[g], 0.0)
        rgb = rgb.index_add(0, act, torch.einsum("ajp,ajc->apc", w, col))
        keep_t = torch.where(blend, one_minus, torch.ones_like(one_minus))
        trans = trans.index_copy(0, act, trans[act] * keep_t.prod(dim=1))
        done_out = done_in | (s_incl <= T_EPS).any(dim=1)
        done = done.index_copy(0, act, done_out)
        if counts is not None:
            with torch.no_grad():
                live = valid[..., None] & ~done_in[:, None, :]
                # A pixel evaluates slots up to the one that stops it.
                stop = (s_incl <= T_EPS).to(torch.int32)
                stop_before = (torch.cumsum(stop, dim=1) - stop) > 0
                counts.evaluated += int((live & ~stop_before).sum())
                added = blend & gate
                counts.blended += int(added.sum())
                counts.contributed[g[added.any(dim=2)]] = True
        c0 += CHUNK
        more = (start[act] + c0 < end[act]) & ~done_out.all(dim=1)
        act = act[more]
    out = torch.cat([rgb + trans[..., None] * bg.to(dtype),
                     (1.0 - trans)[..., None]], dim=-1)
    return out


def tiles_to_image(tiles_px: torch.Tensor, width: int, height: int
                   ) -> torch.Tensor:
    """[T, 1024, C] tile-major pixels -> [H, W, C]."""
    tw, th = -(-width // TILE), -(-height // TILE)
    c = tiles_px.shape[-1]
    img = tiles_px.reshape(th, tw, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(th * TILE, tw * TILE, c)[:height, :width]


def image_to_tiles(img: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [T, 1024, C], zero past the image's edge."""
    h, w, c = img.shape
    tw, th = -(-w // TILE), -(-h // TILE)
    pad = img.new_zeros((th * TILE, tw * TILE, c))
    pad[:h, :w] = img
    return pad.reshape(th, TILE, tw, TILE, c).permute(0, 2, 1, 3, 4).reshape(
        th * tw, TILE_PIX, c)


def render(splats: dict, view: View, bg, dtype=torch.float32,
           counts: BlendCounts | None = None):
    """[H, W, 4] float image of `splats` (means, log_scales, quats,
    sh_coeffs, raw_opacities) in `view`, and its bins."""
    with torch.no_grad():
        p = project(splats["means"], splats["log_scales"], splats["quats"],
                    splats["sh_coeffs"], splats["raw_opacities"], view,
                    dtype)
        bins = bin_splats(p, view.width, view.height)
        bg_t = torch.as_tensor(bg, dtype=dtype, device=p.mean2d.device)
        out = rasterize(p, bins, bg_t, counts=counts)
    return tiles_to_image(out, view.width, view.height).float(), bins


def frame_u8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 4] float render -> [H, W, 3] uint8: clipped to [0, 1], times
    255, truncated (what a viewer hands its client)."""
    return (torch.clamp(img[..., :3], 0.0, 1.0) * 255.0).to(torch.uint8)
