"""The plain rasterizer of `RenderConfig(use_pallas=False)` (port of
`brush_tpu/ops/rasterize_jnp.py`).

The JAX package's oracle rasterizer, in plain PyTorch: no kernel is
involved, on the CPU or on the card. Each tile gathers its first
`max_per_tile` sorted slots (`_gather_tile_isects`) and blends them front
to back a chunk of `chunk` slots at a time: within a chunk the
transmittance prefixes are a cumulative product over the slot axis, and a
carried `done` mask ends a pixel once its transmittance falls to
TRANSMITTANCE_EPS (`_blend_tiles`). `smooth_cutoff` swaps the 1/255 alpha
step for the C^1 smoothstep of the test-only path.

Gradients: `rasterize` is a `torch.autograd.Function` whose backward
recomputes the blend under autograd with each slot's screen position
broadcast per pixel. That gives the per-(slot, pixel) position gradients
the densify refine weight is made of, sum_p |v_xy * img_size| /
max(final_alpha_p, REFINE_ALPHA_FLOOR) clamped to REFINE_WEIGHT_CLAMP
(rasterize_backwards.rs:369-375), which is the cotangent of the zeros-[N]
`refine_holder`; the cotangent of `visible_holder` is the exact
contribution mask of `rasterize_with_visibility`.

A slot past a tile's range contributes exactly nothing, so the gather is
as wide as the longest tile needs (rounded up to a chunk, at most
`max_per_tile`) rather than `max_per_tile` itself: the same image, for one
host read of the longest tile's length.
"""

from __future__ import annotations

import torch

from brush_tpu_torch.constants import (
    ALPHA_CAP,
    ALPHA_CUTOFF_BAND,
    ALPHA_CUTOFF_MID,
    REFINE_ALPHA_FLOOR,
    REFINE_WEIGHT_CLAMP,
    TILE_WIDTH,
    TRANSMITTANCE_EPS,
)

TILE_PIX = TILE_WIDTH * TILE_WIDTH


def _tile_pixel_coords(img_size, device):
    """Pixel-centre coordinates per (tile, pixel in tile): two [T, P]."""
    img_w, img_h = img_size
    tbw = -(-img_w // TILE_WIDTH)
    tbh = -(-img_h // TILE_WIDTH)
    t = torch.arange(tbw * tbh, device=device)
    p = torch.arange(TILE_PIX, device=device)
    px = ((t % tbw)[:, None] * TILE_WIDTH + (p % TILE_WIDTH)[None, :]
          ).to(torch.float32) + 0.5
    py = ((t // tbw)[:, None] * TILE_WIDTH + (p // TILE_WIDTH)[None, :]
          ).to(torch.float32) + 0.5
    return px, py


def _alpha_cutoff_weight(alpha):
    """C^1 smoothstep around the 1/255 cutoff, test-only (helpers.rs:26-33)."""
    t = (alpha - (ALPHA_CUTOFF_MID - 0.5 * ALPHA_CUTOFF_BAND)) / ALPHA_CUTOFF_BAND
    # jnp.clip's gradient: max, then min, each splitting at a tie.
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    return t * t * (3.0 - 2.0 * t)


def _chunk_alpha(xy_c, conic_c, opac_c, valid_c, px, py):
    """sigma and the capped alpha of one chunk: [T, CK, P] each."""
    dx = px[:, None, :] - xy_c[..., 0]
    dy = py[:, None, :] - xy_c[..., 1]
    c00 = conic_c[..., 0:1]
    c01 = conic_c[..., 1:2]
    c11 = conic_c[..., 2:3]
    sigma = 0.5 * (c00 * dx * dx + c11 * dy * dy) + c01 * dx * dy
    alpha = torch.minimum(sigma.new_full((), ALPHA_CAP),
                          opac_c[..., None] * torch.exp(-sigma))
    return sigma, alpha


def _blend_tiles(xy_pp, conic_g, color_g, opac_g, valid, bg, px, py,
                 chunk: int, smooth_cutoff: bool):
    """Front-to-back blend, differentiable. `xy_pp` is [T, M, P | 1, 2]
    (per pixel, or one position a slot), the others [T, M, ...].
    Returns rgb [T, P, 3] and the final transmittance [T, P]."""
    n_tiles, m = valid.shape
    p = px.shape[1]
    t_in = px.new_ones((n_tiles, p))
    done = torch.zeros((n_tiles, p), dtype=torch.bool, device=px.device)
    rgb = px.new_zeros((n_tiles, p, 3))
    for c0 in range(0, m, chunk):
        sl = slice(c0, c0 + chunk)
        valid_c = valid[:, sl]
        sigma, alpha = _chunk_alpha(xy_pp[:, sl], conic_g[:, sl],
                                    opac_g[:, sl], valid_c, px, py)
        if smooth_cutoff:
            w_cut = _alpha_cutoff_weight(alpha)
        else:
            w_cut = (alpha >= ALPHA_CUTOFF_MID).to(alpha.dtype)
        gate = (sigma >= 0.0) & valid_c[..., None]
        a = torch.where(gate, alpha * w_cut, torch.zeros_like(alpha))
        one_minus = 1.0 - a
        cp = torch.cumprod(one_minus, dim=1)
        s_incl = t_in[:, None, :] * cp
        s_excl = t_in[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        blended = (s_incl > TRANSMITTANCE_EPS) & ~done[:, None, :]
        w = torch.where(blended, a * s_excl, torch.zeros_like(a))
        cmax = torch.maximum(color_g[:, sl], color_g.new_zeros(()))
        rgb = rgb + torch.einsum("tjp,tjc->tpc", w, cmax)
        t_in = t_in * torch.prod(
            torch.where(blended, one_minus, torch.ones_like(one_minus)),
            dim=1)
        done = done | (s_incl <= TRANSMITTANCE_EPS).any(dim=1)
    return rgb + t_in[..., None] * bg, t_in


def _gather_width(tile_ranges, max_per_tile: int, chunk: int) -> int:
    """Slots gathered a tile: the longest tile's length rounded up to a
    chunk, at most `max_per_tile` (one host read)."""
    if max_per_tile % chunk:
        raise ValueError(f"max_per_tile {max_per_tile} is not a multiple of "
                         f"chunk {chunk}")
    longest = int((tile_ranges[:, 1] - tile_ranges[:, 0]).max())
    return min(max_per_tile, max(chunk, -(-longest // chunk) * chunk))


def _gather_tile_isects(gid_from_isect, tile_ranges, width: int, n: int):
    """[T, width] splat ids and validity of each tile's first slots. Ids
    outside a tile's range are clamped into [0, n): their slots are
    invalid and contribute nothing."""
    offs = torch.arange(width, dtype=torch.int64, device=tile_ranges.device)
    idx = tile_ranges[:, 0:1].to(torch.int64) + offs[None, :]
    valid = idx < tile_ranges[:, 1:2]
    n_isect = gid_from_isect.shape[0]
    if n_isect == 0 or n == 0:
        return torch.zeros_like(idx), torch.zeros_like(valid)
    gid = gid_from_isect[idx.clamp(0, n_isect - 1)].to(torch.int64)
    return gid.clamp(0, n - 1), valid


def _tiles_to_image(arr, img_size):
    """[T, P, C] tile-major pixels -> [H, W, C] image (cropped)."""
    img_w, img_h = img_size
    tbw = -(-img_w // TILE_WIDTH)
    tbh = -(-img_h // TILE_WIDTH)
    c = arr.shape[-1]
    img = arr.reshape(tbh, tbw, TILE_WIDTH, TILE_WIDTH, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(tbh * TILE_WIDTH,
                                             tbw * TILE_WIDTH, c)
    return img[:img_h, :img_w]


def _image(rgb, t_final, img_size):
    return _tiles_to_image(torch.cat([rgb, 1.0 - t_final[..., None]], dim=-1),
                           img_size)


class _Rasterize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, color, opac, refine_holder,
                visible_holder, gid_from_isect, tile_ranges, bg, img_size,
                max_per_tile, chunk, smooth_cutoff):
        n = mean2d.shape[0]
        width = _gather_width(tile_ranges, max_per_tile, chunk)
        gid, valid = _gather_tile_isects(gid_from_isect, tile_ranges, width,
                                         n)
        px, py = _tile_pixel_coords(img_size, mean2d.device)
        rgb, t_final = _blend_tiles(
            mean2d[gid][:, :, None, :], conic[gid], color[gid], opac[gid],
            valid, bg, px, py, chunk, smooth_cutoff)
        ctx.save_for_backward(mean2d, conic, color, opac, bg, gid, valid)
        ctx.cfg = (img_size, chunk, smooth_cutoff)
        return _image(rgb, t_final, img_size)

    @staticmethod
    def backward(ctx, v_img):
        mean2d, conic, color, opac, bg, gid, valid = ctx.saved_tensors
        img_size, chunk, smooth_cutoff = ctx.cfg
        n = mean2d.shape[0]
        px, py = _tile_pixel_coords(img_size, mean2d.device)
        with torch.enable_grad():
            xy_pp = mean2d.detach()[gid][:, :, None, :].expand(
                gid.shape + (TILE_PIX, 2)).contiguous().requires_grad_(True)
            leaves = [x.detach().requires_grad_(True)
                      for x in (conic, color, opac, bg)]
            conic_l, color_l, opac_l, bg_l = leaves
            rgb, t_final = _blend_tiles(
                xy_pp, conic_l[gid], color_l[gid], opac_l[gid], valid, bg_l,
                px, py, chunk, smooth_cutoff)
            img = _image(rgb, t_final, img_size)
            grads = torch.autograd.grad(img, [xy_pp] + leaves, v_img,
                                        allow_unused=True)
        v_xy_pp, v_conic, v_color, v_opac, v_bg = (
            torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, [xy_pp] + leaves))

        flat = gid.reshape(-1)
        # Per-pixel xy gradients -> per-splat v_mean2d.
        v_xy_isect = torch.where(valid[..., None], v_xy_pp.sum(dim=2),
                                 torch.zeros((), dtype=v_xy_pp.dtype,
                                             device=v_xy_pp.device))
        v_mean2d = mean2d.new_zeros((n, 2)).index_add_(
            0, flat, v_xy_isect.reshape(-1, 2))

        # Refine weight: sum_p ||v_xy * img_size|| / max(final alpha, floor)
        # (rasterize_backwards.rs:369-375), NaN-scrubbed and clamped like
        # project_backwards.rs:186-188.
        final_a = 1.0 - t_final.detach()
        scale = torch.tensor([float(img_size[0]), float(img_size[1])],
                             dtype=torch.float32, device=mean2d.device)
        norm = torch.sqrt(torch.sum((v_xy_pp * scale) ** 2, dim=-1))
        contrib = norm / torch.clamp_min(final_a[:, None, :],
                                         REFINE_ALPHA_FLOOR)
        refine_isect = torch.where(valid[..., None], contrib,
                                   torch.zeros_like(contrib)).sum(dim=2)
        v_refine = mean2d.new_zeros((n,)).index_add_(
            0, flat, refine_isect.reshape(-1))
        v_refine = torch.clamp(torch.nan_to_num(v_refine, nan=0.0), 0.0,
                               REFINE_WEIGHT_CLAMP)

        v_visible = _visibility(mean2d.detach(), conic.detach(),
                                opac.detach(), gid, valid, img_size, chunk)
        return (v_mean2d, v_conic, v_color, v_opac, v_refine, v_visible,
                None, None, v_bg, None, None, None, None)


def rasterize(mean2d, conic, color, opac, refine_holder, visible_holder,
              gid_from_isect, tile_ranges, bg, img_size, max_per_tile: int,
              chunk: int = 32, smooth_cutoff: bool = False) -> torch.Tensor:
    """Rasterize projected splats to an [H, W, 4] image. Differentiable
    w.r.t. mean2d, conic, color, opac and bg; the cotangents of the
    zeros-[N] `refine_holder` / `visible_holder` carry the refine weight
    and the contribution mask."""
    return _Rasterize.apply(mean2d, conic, color, opac, refine_holder,
                            visible_holder, gid_from_isect, tile_ranges, bg,
                            tuple(img_size), int(max_per_tile), int(chunk),
                            bool(smooth_cutoff))


@torch.no_grad()
def rasterize_with_visibility(mean2d, conic, color, opac, gid_from_isect,
                              tile_ranges, img_size, max_per_tile: int,
                              chunk: int = 32) -> torch.Tensor:
    """[N] visibility: 1.0 where the splat blended into some pixel
    (rasterize.rs:141-143 bwd_info). `color` is unused, as in the JAX
    package (the signature is the same)."""
    del color
    width = _gather_width(tile_ranges, max_per_tile, chunk)
    gid, valid = _gather_tile_isects(gid_from_isect, tile_ranges, width,
                                     mean2d.shape[0])
    return _visibility(mean2d, conic, opac, gid, valid, img_size, chunk)


def _visibility(mean2d, conic, opac, gid, valid, img_size, chunk: int):
    """The visibility mask from gathered [T, width] slots."""
    n, width = mean2d.shape[0], gid.shape[1]
    px, py = _tile_pixel_coords(img_size, mean2d.device)
    xy_g, conic_g, opac_g = mean2d[gid][:, :, None, :], conic[gid], opac[gid]
    n_tiles = gid.shape[0]
    t_in = px.new_ones((n_tiles, TILE_PIX))
    done = torch.zeros((n_tiles, TILE_PIX), dtype=torch.bool,
                       device=px.device)
    contrib = []
    for c0 in range(0, width, chunk):
        sl = slice(c0, c0 + chunk)
        sigma, alpha = _chunk_alpha(xy_g[:, sl], conic_g[:, sl],
                                    opac_g[:, sl], valid[:, sl], px, py)
        gate = ((sigma >= 0.0) & (alpha >= ALPHA_CUTOFF_MID)
                & valid[:, sl, None])
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - a
        s_incl = t_in[:, None, :] * torch.cumprod(one_minus, dim=1)
        blended = (s_incl > TRANSMITTANCE_EPS) & ~done[:, None, :]
        contrib.append((blended & (a > 0.0)).any(dim=2))
        t_in = t_in * torch.prod(
            torch.where(blended, one_minus, torch.ones_like(one_minus)),
            dim=1)
        done = done | (s_incl <= TRANSMITTANCE_EPS).any(dim=1)
    hit = (torch.cat(contrib, dim=1) & valid).to(torch.float32)
    return mean2d.new_zeros((n,)).scatter_reduce_(
        0, gid.reshape(-1), hit.reshape(-1), reduce="amax")
