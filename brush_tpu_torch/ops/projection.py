"""Splat projection & culling (port of `brush_tpu/ops/projection.py`).

The vectorized equivalent of the reference's `project_forward` +
`project_visible` kernels (brush-render/src/kernels/project_forward.rs,
project_visible.rs), computed for all N splats with a `visible` mask.

Two-pass NaN safety, kept from the JAX package: pass 1 evaluates every
culling gate on detached inputs (NaN comparisons are just False); pass 2
runs the differentiable math on inputs sanitized by that mask, so a splat
failing ANY gate is an inert unit splat with finite math everywhere. This
slice takes no gradient, but the next one differentiates through it, so
the structure and every field are ported as they are.

`project_splats` is the plain version of the CUDA projection
(ops/project_cuda.py `project`, which the render calls): the CPU's path,
the RT8 and thin-prism fisheye lenses' on the card, and the yardstick the
kernels are held to.

Tracing (utils/tracing.py): the lens's projection and its Jacobian are the
stage `project.lens` (with device marks, so eager paths only; this route
alone has it), and each projection counts `project.lens.<kind>`
(camera.lens_kind: an eager call or a graph's capture; a replay runs no
Python), as the kernels' route does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from brush_tpu_torch.camera import (
    CameraModel,
    Pinhole,
    is_fisheye,
    lens_kind,
)
from brush_tpu_torch.constants import (
    ALPHA_CUTOFF_MID,
    COV2D_ENTRY_CLAMP,
    COV_BLUR_DEFAULT,
    COV_BLUR_MIP,
    COLOR_CLAMP,
    MAX_VIEW_Z,
    NEAR_PLANE,
    QUAT_NORM_SQ_MIN,
    SH_COLOR_OFFSET,
    TILE_WIDTH,
)
from brush_tpu_torch.ops import camera_proj
from brush_tpu_torch.ops.sh import sh_to_color
from brush_tpu_torch.utils.device import device_constant
from brush_tpu_torch.utils.tracing import count, stage


class CameraInputs(NamedTuple):
    """Per-view uniforms (kernels/types.rs:51-108), as tensors on the
    render device."""

    viewmat: torch.Tensor        # [3,4] world-to-camera
    pinhole: torch.Tensor        # [fx, fy, cx, cy]
    clamp_limits: torch.Tensor   # [lim_neg_x, lim_pos_x, lim_neg_y, lim_pos_y]
    cam_pos: torch.Tensor        # [3] world-space camera position
    half_max_render_fov: float = 0.0  # fisheye cull bound


@dataclasses.dataclass
class ProjectedSplats:
    """Per-splat projected state in original splat order."""

    visible: torch.Tensor        # [N] bool
    depth: torch.Tensor          # [N] view-space z
    mean2d: torch.Tensor         # [N,2] pixel coords
    conic: torch.Tensor          # [N,3] (c00, c01, c11) of cov2d^-1
    color: torch.Tensor          # [N,3] SH-evaluated rgb (clamped +-100, +0.5)
    opac: torch.Tensor           # [N] sigmoid(raw) * mip compensation
    power_threshold: torch.Tensor  # [N] ln(opac*255)
    tile_min: torch.Tensor       # [N,2] int32 (tx, ty) inclusive
    tile_max: torch.Tensor       # [N,2] int32 (tx, ty) exclusive
    num_tiles_bbox: torch.Tensor  # [N] int32 tiles in clamped bbox
    max_radius: torch.Tensor     # [N] screen-fraction radius (refine stat)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncation with XLA's NaN -> 0 rule (the callers clip
    to the tile grid first, so only NaN needs handling)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def _project_math(means, log_scales, quats, sh_coeffs, raw_opacities,
                  cam: CameraInputs, img_size, sh_degree, model,
                  mip_splatting):
    """The full projection math + every gate. Returns
    (ProjectedSplats, ok, color_finite)."""
    img_w, img_h = img_size
    tile_bw = -(-img_w // TILE_WIDTH)
    tile_bh = -(-img_h // TILE_WIDTH)

    rot = cam.viewmat[:, :3]
    trans = cam.viewmat[:, 3]
    m0, m1, m2 = means[:, 0], means[:, 1], means[:, 2]
    mean_c = torch.stack([
        m0 * rot[0, 0] + m1 * rot[0, 1] + m2 * rot[0, 2] + trans[0],
        m0 * rot[1, 0] + m1 * rot[1, 1] + m2 * rot[1, 2] + trans[1],
        m0 * rot[2, 0] + m1 * rot[2, 1] + m2 * rot[2, 2] + trans[2],
    ], dim=-1)

    # --- Culling gates (project_forward.rs:44-111) ---
    z = mean_c[..., 2]
    ok = torch.isfinite(mean_c).all(dim=-1) & (z <= MAX_VIEW_Z)
    if is_fisheye(model):
        r = torch.sqrt(mean_c[..., 0] ** 2 + mean_c[..., 1] ** 2)
        theta = torch.atan2(r, z)
        ok &= theta <= cam.half_max_render_fov
    else:
        ok &= z >= NEAR_PLANE

    scale = torch.exp(log_scales)
    ok &= torch.isfinite(scale).all(dim=-1)

    qnorm_sq = torch.sum(quats * quats, dim=-1)
    ok &= (qnorm_sq >= QUAT_NORM_SQ_MIN) & torch.isfinite(qnorm_sq)
    ok &= torch.isfinite(raw_opacities)

    qn = quats / torch.sqrt(torch.clamp_min(qnorm_sq[:, None], 1e-32))

    # --- cov2d (helpers.rs calc_cov2d:142-171), unrolled ---
    qw, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    q_rows = (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )
    s0, s1, s2 = scale[:, 0], scale[:, 1], scale[:, 2]
    # ns[i][k] = (rot @ R_q)[i,k] * scale[k]
    ns = [
        [
            (rot[i, 0] * q_rows[0][k] + rot[i, 1] * q_rows[1][k]
             + rot[i, 2] * q_rows[2][k]) * (s0, s1, s2)[k]
            for k in range(3)
        ]
        for i in range(3)
    ]
    with stage("project.lens", device=True):
        jac = camera_proj.projection_jacobian(mean_c, cam.pinhole,
                                              cam.clamp_limits, model)
        mean2d = camera_proj.project(mean_c, cam.pinhole, model)
    j = [[jac[:, a, b] for b in range(3)] for a in range(2)]
    v = [
        [j[a][0] * ns[0][k] + j[a][1] * ns[1][k] + j[a][2] * ns[2][k]
         for k in range(3)]
        for a in range(2)
    ]
    c00 = v[0][0] * v[0][0] + v[0][1] * v[0][1] + v[0][2] * v[0][2]
    c01 = v[0][0] * v[1][0] + v[0][1] * v[1][1] + v[0][2] * v[1][2]
    c11 = v[1][0] * v[1][0] + v[1][1] * v[1][1] + v[1][2] * v[1][2]
    max_abs = torch.maximum(torch.maximum(c00.abs(), c11.abs()), c01.abs())
    scale_down = torch.where(
        max_abs > COV2D_ENTRY_CLAMP,
        COV2D_ENTRY_CLAMP / torch.clamp_min(max_abs, 1e-30),
        torch.ones_like(max_abs))
    c00, c01, c11 = c00 * scale_down, c01 * scale_down, c11 * scale_down

    # --- Mip blur + compensation (helpers.rs compensate_cov2d:177-191) ---
    blur = COV_BLUR_MIP if mip_splatting else COV_BLUR_DEFAULT
    b00, b11 = c00 + blur, c11 + blur
    if mip_splatting:
        det_raw = torch.clamp_min(c00 * c11 - c01 * c01, 0.0)
        det_blur = b00 * b11 - c01 * c01
        filter_comp = torch.sqrt(det_raw / det_blur)
    else:
        filter_comp = 1.0

    opac = _sigmoid(raw_opacities) * filter_comp
    ok &= torch.isfinite(b00) & torch.isfinite(b11) & torch.isfinite(c01)
    ok &= opac >= ALPHA_CUTOFF_MID

    # --- conic = cov2d^-1, zero when non-PD (brush-cube Sym2::inverse) ---
    det = b00 * b11 - c01 * c01
    pos = det > 0.0
    inv_det = torch.where(
        pos, 1.0 / torch.where(pos, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([b11 * inv_det, -c01 * inv_det, b00 * inv_det],
                        dim=-1)

    # --- bbox extent (helpers.rs compute_bbox_extent:80-90) ---
    power_threshold = torch.log(torch.clamp_min(opac, 1e-30) * 255.0)
    cdet = conic[:, 0] * conic[:, 2] - conic[:, 1] * conic[:, 1]
    degenerate = cdet <= 0.0
    cinv_det = torch.where(
        degenerate, torch.zeros_like(cdet),
        1.0 / torch.where(degenerate, torch.ones_like(cdet), cdet))
    ex = torch.sqrt(torch.clamp_min(
        2.0 * power_threshold * conic[:, 2] * cinv_det, 0.0))
    ey = torch.sqrt(torch.clamp_min(
        2.0 * power_threshold * conic[:, 0] * cinv_det, 0.0))
    ok &= ~degenerate

    on_screen = (
        (mean2d[:, 0] + ex > 0.0)
        & (mean2d[:, 0] - ex < img_w)
        & (mean2d[:, 1] + ey > 0.0)
        & (mean2d[:, 1] - ey < img_h)
    )
    ok &= on_screen

    # --- tile bbox (helpers.rs get_tile_bbox/get_bbox:107-136) ---
    tw = float(TILE_WIDTH)
    min_x = _to_i32(torch.clamp(mean2d[:, 0] / tw - ex / tw, 0.0, tile_bw))
    min_y = _to_i32(torch.clamp(mean2d[:, 1] / tw - ey / tw, 0.0, tile_bh))
    max_x = _to_i32(torch.clamp(mean2d[:, 0] / tw + ex / tw + 1.0, 0.0,
                                tile_bw))
    max_y = _to_i32(torch.clamp(mean2d[:, 1] / tw + ey / tw + 1.0, 0.0,
                                tile_bh))
    num_tiles_bbox = torch.where(ok, (max_x - min_x) * (max_y - min_y),
                                 torch.zeros_like(min_x))

    # --- SH color along viewdir (project_visible.rs:54-71) ---
    viewdir_raw = means - cam.cam_pos
    norm = torch.sqrt(torch.sum(viewdir_raw * viewdir_raw, dim=-1,
                                keepdim=True))
    viewdir = viewdir_raw / torch.where(norm > 1e-12, norm,
                                        torch.ones_like(norm))
    color_raw = sh_to_color(sh_coeffs, viewdir, sh_degree) + SH_COLOR_OFFSET
    color_finite = torch.isfinite(color_raw)
    color = torch.where(color_finite, color_raw, torch.zeros_like(color_raw))
    color = torch.clamp(color, -COLOR_CLAMP, COLOR_CLAMP)

    max_radius = torch.where(ok, torch.maximum(ex / img_w, ey / img_h),
                             torch.zeros_like(ex))

    proj = ProjectedSplats(
        visible=ok,
        depth=z,
        mean2d=mean2d,
        conic=conic,
        color=color,
        opac=opac,
        power_threshold=power_threshold,
        tile_min=torch.stack([min_x, min_y], dim=-1),
        tile_max=torch.stack([max_x, max_y], dim=-1),
        num_tiles_bbox=num_tiles_bbox,
        max_radius=max_radius,
    )
    return proj, ok, color_finite


def project_splats(
    means: torch.Tensor,          # [N,3]
    log_scales: torch.Tensor,     # [N,3]
    quats: torch.Tensor,          # [N,4] wxyz, not necessarily normalized
    sh_coeffs: torch.Tensor,      # [N,K,3]
    raw_opacities: torch.Tensor,  # [N]
    cam: CameraInputs,
    img_size: tuple[int, int],    # (w, h)
    *,
    sh_degree: int,
    model: CameraModel = Pinhole(),
    mip_splatting: bool = False,
) -> ProjectedSplats:
    """Project every splat with PyTorch operations, on any device and
    through any lens, differentiable under autograd: the plain version
    of the CUDA projection (ops/project_cuda.py), and the CPU's path and
    that of the lenses the kernels do not take."""
    return _project_plain(means, log_scales, quats, sh_coeffs, raw_opacities,
                          cam, img_size, sh_degree, model, mip_splatting)[0]


def project_splats_flags(means, log_scales, quats, sh_coeffs, raw_opacities,
                         cam: CameraInputs, img_size, *, sh_degree: int,
                         model: CameraModel = Pinhole(),
                         mip_splatting: bool = False):
    """`project_splats` and what its gates decided, as the CUDA forward
    writes it: (ProjectedSplats, flags [N] uint8 from `gate_flags`)."""
    proj, chan_finite = _project_plain(
        means, log_scales, quats, sh_coeffs, raw_opacities, cam, img_size,
        sh_degree, model, mip_splatting)
    return proj, gate_flags(proj.visible, chan_finite)


def gate_flags(visible: torch.Tensor, chan_finite: torch.Tensor):
    """[N] uint8: bit 0 the splat is visible, bit 1 + c its colour
    channel c's SH sum on the raw coefficients was finite."""
    bits = torch.cat([visible[:, None], chan_finite], dim=1).to(torch.uint8)
    return (bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
            | (bits[:, 3] << 3))


def _project_plain(means, log_scales, quats, sh_coeffs, raw_opacities,
                   cam: CameraInputs, img_size, sh_degree, model,
                   mip_splatting):
    count(f"project.lens.{lens_kind(model)}")
    # Pass 1: gates only, on detached inputs.
    _, ok, chan_finite = _project_math(
        means.detach(), log_scales.detach(), quats.detach(),
        sh_coeffs.detach(), raw_opacities.detach(), cam, img_size,
        sh_degree, model, mip_splatting)

    # Pass 2: the math on sanitized inputs. Culled splats become an inert
    # unit splat in front of the camera with ~zero opacity.
    okc = ok[:, None]
    front = cam.cam_pos + device_constant((0.0, 0.0, 1.0), means.device,
                                          means.dtype)
    means_s = torch.where(okc, means, front)
    ls_s = torch.where(okc, log_scales, torch.zeros_like(log_scales))
    unit_q = device_constant((1.0, 0.0, 0.0, 0.0), quats.device, quats.dtype)
    quats_s = torch.where(okc, quats, unit_q)
    # SH sanitized per coefficient: the gates don't check SH, so poisoned
    # coefficients on visible rows are kept out of the math too.
    sh_s = torch.where(torch.isfinite(sh_coeffs) & ok[:, None, None],
                       sh_coeffs, torch.zeros_like(sh_coeffs))
    opac_s = torch.where(ok, raw_opacities,
                         torch.full_like(raw_opacities, -10.0))

    proj, ok2, _ = _project_math(means_s, ls_s, quats_s, sh_s, opac_s,
                                 cam, img_size, sh_degree, model,
                                 mip_splatting)
    visible = ok & ok2
    # Forward parity with the reference's NaN-scrub: a channel whose true
    # SH sum was non-finite renders as 0.
    color = torch.where(chan_finite, proj.color, torch.zeros_like(proj.color))
    return dataclasses.replace(
        proj,
        visible=visible,
        color=color,
        num_tiles_bbox=torch.where(visible, proj.num_tiles_bbox,
                                   torch.zeros_like(proj.num_tiles_bbox)),
        max_radius=torch.where(visible, proj.max_radius,
                               torch.zeros_like(proj.max_radius)),
    ), chan_finite
