"""The render pipeline (port of `brush_tpu/render.py`).

    project -> exact tile counts -> emit -> key sort -> SoA -> rasterize

Two configurations run:

  * serving: `RenderConfig(use_pallas=True, forward_only=True)`, the
    configuration the viewer, eval and the benchmark render with. The whole
    frame runs without autograd and the image carries no gradients.
  * training: `RenderConfig(use_pallas=True, forward_only=False)`.
    Projection runs under autograd, binning on detached values, and the
    rasterizer is the `torch.autograd.Function` of ops/rasterize_cuda.py,
    whose backward hands the per-splat gradients back to projection.
    `render_with_refine` threads the two holders whose gradients carry the
    densify refine weight and the visibility mask.

`use_pallas=False` (the JAX package's jnp oracle rasterizer) raises
NotImplementedError: its torch twin comes with eval and refine.

PyTorch runs eagerly and nothing in either path reads a value back to the
host, so a frame or a training step is queued on the card without a
synchronize.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from brush_tpu_torch.camera import Camera, CameraModel, Pinhole, is_fisheye
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.projection import CameraInputs, project_splats
from brush_tpu_torch.ops.rasterize_cuda import (
    rasterize_forward,
    rasterize_train,
    tiles_to_image,
)
from brush_tpu_torch.ops.tiling import CK, build_intersections
from brush_tpu_torch.utils.device import resolve_device
from brush_tpu_torch.utils.tracing import stage


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render configuration; field names and defaults are the JAX
    package's, so a config converts one to one."""

    img_size: Tuple[int, int]          # (w, h)
    sh_degree: int = 3
    model: CameraModel = Pinhole()
    mip_splatting: bool = False
    isect_cap: int = 1 << 16           # REMAINDER slot capacity
    expand_k0: int = 4                 # dense expansion width per splat
    chunk_cap: int | None = None       # backward gradient chunk rows
    max_per_tile: int = 1024           # jnp-rasterizer per-tile bound
    chunk: int = 32
    smooth_cutoff: bool = False        # test-only C^1 alpha cutoff
    use_pallas: bool = False           # production kernels
    forward_only: bool = False         # inference specialization

    @property
    def tile_grid(self) -> Tuple[int, int]:
        w, h = self.img_size
        return (-(-w // TILE_WIDTH), -(-h // TILE_WIDTH))

    def resolved_chunk_cap(self, n_splats: int) -> int:
        """Gradient chunk rows of the JAX backward. The port's backward
        has no chunk buffer; the trainer's overflow gate still compares
        against this, so both packages skip the same steps."""
        if self.chunk_cap is not None:
            return self.chunk_cap
        s_cap = n_splats * self.expand_k0 + self.isect_cap
        tw, th = self.tile_grid
        return s_cap // CK + tw * th


@dataclasses.dataclass
class RenderAux:
    """Side outputs of a render (reference: render_aux.rs:73)."""

    num_visible: torch.Tensor       # [] int32
    num_isects: torch.Tensor        # [] int32 remainder slots needed —
    #   compare against isect_cap for overflow/retry!
    num_bbox_tail: torch.Tensor     # [] int32 slots on bbox-tail semantics
    max_isects_per_tile: torch.Tensor  # [] int32
    visible: torch.Tensor           # [N] 1.0 where the splat is visible.
    #   Training path: BINNED visibility (passed every cull gate and emitted
    #   at least one tile slot), a superset of the splats that contributed;
    #   the exact mask is the visible_holder gradient (render_with_refine).
    #   Forward-only path: all zeros.
    max_radius: torch.Tensor        # [N] screen-fraction radius
    final_t: torch.Tensor | None = None
    num_chunks: torch.Tensor | None = None  # [] int32


def camera_inputs(cam: Camera, img_size: Tuple[int, int],
                  device="cuda") -> CameraInputs:
    """Host-side Camera -> per-view tensors on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    return CameraInputs(
        viewmat=t(cam.viewmat()),
        pinhole=t(cam.pinhole_params(img_size)),
        clamp_limits=t(cam.jacobian_clamp_limits(img_size)),
        cam_pos=t(cam.position),
        half_max_render_fov=(cam.half_max_render_fov()
                             if is_fisheye(cam.model) else 0.0),
    )


def _check_config(cfg: RenderConfig) -> None:
    if not cfg.use_pallas:
        raise NotImplementedError(
            "brush_tpu_torch renders through its CUDA kernels only: set "
            "RenderConfig(use_pallas=True). The plain rasterizer of "
            "use_pallas=False (per-tile gather, max_per_tile, smooth_cutoff) "
            "comes with the eval and refine part of the port.")


def render(
    means: torch.Tensor,
    log_scales: torch.Tensor,
    quats: torch.Tensor,
    sh_coeffs: torch.Tensor,
    raw_opacities: torch.Tensor,
    cam: CameraInputs,
    bg: torch.Tensor,
    cfg: RenderConfig,
) -> tuple[torch.Tensor, RenderAux]:
    """Render one view on the device the inputs lie on. Returns
    ([H, W, 4] f32 image, RenderAux). With `forward_only=False` the image
    is differentiable w.r.t. the five splat arrays and `bg`."""
    return _render_impl(means, log_scales, quats, sh_coeffs, raw_opacities,
                        cam, bg, cfg, refine_holder=None)


def render_with_refine(
    means, log_scales, quats, sh_coeffs, raw_opacities, cam, bg, cfg,
    refine_holder: torch.Tensor,
    visible_holder: torch.Tensor | None = None,
):
    """Like `render` (training configuration), but threads zeros-[N]
    holders whose gradients carry the per-splat refine weight and the
    visibility mask."""
    return _render_impl(means, log_scales, quats, sh_coeffs, raw_opacities,
                        cam, bg, cfg, refine_holder=refine_holder,
                        visible_holder=visible_holder)


def _render_impl(means, log_scales, quats, sh_coeffs, raw_opacities, cam, bg,
                 cfg: RenderConfig, refine_holder, visible_holder=None):
    _check_config(cfg)
    fwd_only = cfg.forward_only
    n = means.shape[0]
    bg = bg.to(torch.float32)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not fwd_only):
        with stage("project"):
            proj = project_splats(
                means, log_scales, quats, sh_coeffs, raw_opacities, cam,
                cfg.img_size, sh_degree=cfg.sh_degree, model=cfg.model,
                mip_splatting=cfg.mip_splatting)
        isect = build_intersections(proj, cfg.img_size, cfg.isect_cap,
                                    expand_k0=cfg.expand_k0,
                                    chunk_cap=cfg.chunk_cap,
                                    with_bwd_info=not fwd_only)
        with stage("rasterize"):
            if fwd_only:
                img = tiles_to_image(
                    rasterize_forward(isect.soa, isect.tile_ranges, bg,
                                      cfg.img_size), cfg.img_size)
            else:
                zeros = means.new_zeros(n, dtype=torch.float32)
                img = rasterize_train(
                    proj.mean2d, proj.conic, proj.color, proj.opac,
                    zeros if refine_holder is None else refine_holder,
                    zeros if visible_holder is None else visible_holder,
                    isect.soa, isect.tile_ranges, isect.gid_from_isect, bg,
                    cfg.img_size)
    with torch.no_grad():
        per_tile = isect.tile_ranges[:, 1] - isect.tile_ranges[:, 0]
        if fwd_only:
            visible = torch.zeros(n, dtype=torch.float32,
                                  device=means.device)
        else:
            visible = (isect.surv_counts_g > 0).to(torch.float32)
        aux = RenderAux(
            num_visible=isect.num_visible,
            num_isects=isect.num_isects,
            num_bbox_tail=isect.num_bbox_tail,
            max_isects_per_tile=per_tile.max(),
            visible=visible,
            max_radius=proj.max_radius.detach(),
            num_chunks=isect.num_chunks,
        )
    return img, aux


def pack_image_u8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 4] f32 -> [H, W, 4] u8 (the reference's packed forward
    output, rasterize.rs:172-177)."""
    return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)


def required_isect_cap(aux: RenderAux) -> int:
    """Host helper: padded capacity that would fit this view (pow2)."""
    n = int(aux.num_isects)
    return 1 << max(10, int(np.ceil(np.log2(max(n, 1)))))
