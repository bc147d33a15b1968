"""Splat projection as two CUDA kernels, forward and backward, with their
plain PyTorch versions beside them.

Kernels `csrc/project.cu` (forward) and `csrc/project_bwd.cu` (backward).
They replace no TPU kernel: the JAX package leaves the projection
(`brush_tpu/ops/projection.py`) to XLA, which fuses it into a few passes.
Run as PyTorch operations (`project_splats`, ops/projection.py) the same
work is about 650 passes over the splat rows forward and 550 more under
autograd backward, each reading and writing whole [N] columns. The
kernels take one thread a splat and keep every intermediate in registers.

* `project` — the entry the render calls. CUDA tensors through a
  `Pinhole` or `KannalaBrandt4` lens run the kernels (`_Project`, a
  `torch.autograd.Function`; with grad disabled only the forward runs and
  nothing is saved). CPU tensors, and the RT8 and thin-prism fisheye
  lenses (their Jacobians come from forward-mode AD, ops/camera_proj.py),
  take `project_splats`. Each call counts `project.route.<cuda|torch>` in
  the stage recorder (utils/tracing.py), and a kernel call
  `project.lens.<kind>` as the PyTorch route does.
* `project_forward` — the forward kernel. One pass does the plain
  version's two: the culling gates on the raw row, and the math on the
  sanitised row (a culled splat becomes the unit splat in front of the
  camera, so every output equals the plain version's). Besides the
  `ProjectedSplats` fields it writes `flags` (`gate_flags`: visible, and
  which colour channels' raw SH sums were finite), all the backward needs
  of the gates.
* `project_backward` — the backward kernel: the gradients of the five
  splat arrays from those of mean2d, conic, color and opac. It recomputes
  the forward's intermediates from the saved inputs and stores none. Its
  plain version `project_backward_plain` is the closed-form vector-Jacobian
  product, held to autograd of `project_splats` in the CPU tests; KB4's
  Jacobian and its second derivatives are ops/camera_proj.py
  `kb4_jacobian` and `kb4_jacobian_vjp` (derived in csrc/project.cuh).

Bound on the H100: bytes. The forward reads a live row's 236 bytes (means,
log-scales, quaternion, 48 SH floats at degree 3, raw opacity) and writes
70; the backward reads the row and the 36 bytes of output gradients and
writes 236 bytes of input gradients for every row. The SH rows are staged
through shared memory a warp at a time so that the warp's loads and
stores coalesce.

The forward repeats the plain version's float32 operations in their order
with round-to-nearest intrinsics (no FMA contraction), the row sums of
four and three entries in the order of PyTorch's CUDA reduction, the
pinhole Jacobian's entries, which `jacfwd` forms in float64 from float32
products and rounds, as those float32 products, and KB4's as its float32
closed form. So through either lens `visible`, `depth`, the tile bbox and
every field but `color` equal the plain version bit for bit on the card;
the SH sum adds its terms in order k = 0, 1, ..., which PyTorch's
reduction over k need not do, so `color` agrees within the rounding of
that sum (`compare_forward`). The backward's sums are its own closed
forms, held within `BWD_RTOL` of each array's largest entry.
"""

from __future__ import annotations

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.camera import (
    CameraModel,
    KannalaBrandt4,
    Pinhole,
    lens_kind,
)
from brush_tpu_torch.constants import (
    COLOR_CLAMP,
    COV2D_ENTRY_CLAMP,
    COV_BLUR_DEFAULT,
    COV_BLUR_MIP,
    SH_COLOR_OFFSET,
)
from brush_tpu_torch.kernels import build
from brush_tpu_torch.ops.camera_proj import kb4_jacobian, kb4_jacobian_vjp
from brush_tpu_torch.ops.projection import (
    CameraInputs,
    ProjectedSplats,
    project_splats,
    project_splats_flags,
)
from brush_tpu_torch.ops.sh import num_sh_coeffs, sh_basis
from brush_tpu_torch.utils.device import device_constant
from brush_tpu_torch.utils.tracing import count

# The backward kernel's gradients against the plain version's: within
# this share of each array's largest entry (the two sum the same terms in
# other orders).
BWD_RTOL = 1e-5
# The forward's colour against the plain version's: within 16 roundings
# of this size relative to 1 + |colour|, and 1e-6 absolute (the SH sum's
# order; every other field is bit for bit).
COLOR_RTOL = 1e-6

_GRAD_FIELDS = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacities")
_NON_DIFF = ("visible", "depth", "power_threshold", "tile_min", "tile_max",
             "num_tiles_bbox", "max_radius")
_FIELDS = ("visible", "depth", "mean2d", "conic", "color", "opac",
           "power_threshold", "tile_min", "tile_max", "num_tiles_bbox",
           "max_radius")


# --------------------------------------------------------------------------
# the plain backward
# --------------------------------------------------------------------------


def _sh_basis_vjp(viewdir, w, degree: int):
    """Gradient of sum_k w[:, k] * sh_basis(viewdir)[:, k] w.r.t. the [N, 3]
    view direction, by reverse mode through the basis's own intermediates
    (ops/sh.py)."""
    x, y, z = viewdir[:, 0], viewdir[:, 1], viewdir[:, 2]
    zero = torch.zeros_like(x)
    ax, ay, az = zero, zero, zero
    if degree >= 1:
        f0a = 0.4886025
        ay = ay - f0a * w[:, 1]
        az = az + f0a * w[:, 2]
        ax = ax - f0a * w[:, 3]
    if degree >= 2:
        z2 = z * z
        f0b = -1.0925485 * z
        f1a = 0.54627424
        fc1 = x * x - y * y
        fs1 = 2.0 * x * y
        a_fs1 = f1a * w[:, 4]
        a_f0b = y * w[:, 5] + x * w[:, 7]
        ay = ay + f0b * w[:, 5]
        ax = ax + f0b * w[:, 7]
        a_z2 = 0.9461747 * w[:, 6]
        a_fc1 = f1a * w[:, 8]
    if degree >= 3:
        f0c = -2.285229 * z2 + 0.4570458
        f1b = 1.4453057 * z
        f2a = -0.5900436
        fc2 = x * fc1 - y * fs1
        fs2 = x * fs1 + y * fc1
        a_fs2 = f2a * w[:, 9]
        a_f1b = fs1 * w[:, 10] + fc1 * w[:, 14]
        a_fs1 = a_fs1 + f1b * w[:, 10]
        a_f0c = y * w[:, 11] + x * w[:, 13]
        ay = ay + f0c * w[:, 11]
        ax = ax + f0c * w[:, 13]
        az = az + (1.8658817 * z2 - 1.119529) * w[:, 12]
        a_z2 = a_z2 + 1.8658817 * z * w[:, 12]
        a_fc1 = a_fc1 + f1b * w[:, 14]
        a_fc2 = f2a * w[:, 15]
    if degree >= 4:
        p_sh12 = z * (1.8658817 * z2 - 1.119529)
        f0d = z * (-4.683326 * z2 + 2.0071396)
        f1c = 3.3116114 * z2 - 0.47308735
        f2b = -1.7701308 * z
        f3a = 0.62583575
        a_fs3 = f3a * w[:, 16]
        a_f2b = fs2 * w[:, 17] + fc2 * w[:, 23]
        a_fs2 = a_fs2 + f2b * w[:, 17]
        a_f1c = fs1 * w[:, 18] + fc1 * w[:, 22]
        a_fs1 = a_fs1 + f1c * w[:, 18]
        a_f0d = y * w[:, 19] + x * w[:, 21]
        ay = ay + f0d * w[:, 19]
        ax = ax + f0d * w[:, 21]
        # 1.9843135 * z * p_sh12 - 1.0062306 * p_sh6
        az = az + 1.9843135 * p_sh12 * w[:, 20]
        a_p12 = 1.9843135 * z * w[:, 20]
        a_z2 = a_z2 - 1.0062306 * 0.9461747 * w[:, 20]
        a_fc1 = a_fc1 + f1c * w[:, 22]
        a_fc2 = a_fc2 + f2b * w[:, 23]
        a_fc3 = f3a * w[:, 24]
        az = az + (1.8658817 * z2 - 1.119529) * a_p12
        a_z2 = a_z2 + 1.8658817 * z * a_p12
        # fc3 = x fc2 - y fs2, fs3 = x fs2 + y fc2
        ax = ax + fc2 * a_fc3 + fs2 * a_fs3
        ay = ay - fs2 * a_fc3 + fc2 * a_fs3
        a_fc2 = a_fc2 + x * a_fc3 + y * a_fs3
        a_fs2 = a_fs2 - y * a_fc3 + x * a_fs3
        az = az + (-4.683326 * z2 + 2.0071396) * a_f0d - 1.7701308 * a_f2b
        a_z2 = a_z2 - 4.683326 * z * a_f0d + 3.3116114 * a_f1c
    if degree >= 3:
        # fc2 = x fc1 - y fs1, fs2 = x fs1 + y fc1
        ax = ax + fc1 * a_fc2 + fs1 * a_fs2
        ay = ay - fs1 * a_fc2 + fc1 * a_fs2
        a_fc1 = a_fc1 + x * a_fc2 + y * a_fs2
        a_fs1 = a_fs1 - y * a_fc2 + x * a_fs2
        a_z2 = a_z2 - 2.285229 * a_f0c
        az = az + 1.4453057 * a_f1b
    if degree >= 2:
        ax = ax + 2.0 * x * a_fc1 + 2.0 * y * a_fs1
        ay = ay - 2.0 * y * a_fc1 + 2.0 * x * a_fs1
        az = az - 1.0925485 * a_f0b + 2.0 * z * a_z2
    return torch.stack([ax, ay, az], dim=-1)


def _quat_rot(qn):
    """Rows of the rotation matrix of unit quaternions [N, 4] (w, x, y, z)."""
    qw, qx, qy, qz = qn.unbind(-1)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return ((1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
            (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
            (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)))


def _quat_rot_vjp(qn, g):
    """Gradient w.r.t. the unit quaternion of sum_jk g[j][k] * R(qn)[j][k]."""
    w, x, y, z = qn.unbind(-1)
    gw = 2.0 * (-z * g[0][1] + y * g[0][2] + z * g[1][0] - x * g[1][2]
                - y * g[2][0] + x * g[2][1])
    gx = 2.0 * (y * g[0][1] + z * g[0][2] + y * g[1][0] - 2.0 * x * g[1][1]
                - w * g[1][2] + z * g[2][0] + w * g[2][1]
                - 2.0 * x * g[2][2])
    gy = 2.0 * (-2.0 * y * g[0][0] + x * g[0][1] + w * g[0][2] + x * g[1][0]
                + z * g[1][2] - w * g[2][0] + z * g[2][1]
                - 2.0 * y * g[2][2])
    gz = 2.0 * (-2.0 * z * g[0][0] - w * g[0][1] + x * g[0][2] + w * g[1][0]
                - 2.0 * z * g[1][1] + y * g[1][2] + x * g[2][0]
                + y * g[2][1])
    return torch.stack([gw, gx, gy, gz], dim=-1)


def project_backward_plain(means, log_scales, quats, sh_coeffs,
                           raw_opacities, cam: CameraInputs, img_size,
                           flags, v_mean2d, v_conic, v_color, v_opac, *,
                           sh_degree: int, mip_splatting: bool,
                           model: CameraModel = Pinhole()):
    """Gradients (means, log_scales, quats, sh_coeffs, raw_opacities) of a
    projection through a pinhole or a KannalaBrandt4 lens from the
    cotangents of mean2d [N, 2], conic [N, 3], color [N, 3] and opac [N],
    in closed form: the vector-Jacobian product of `project_splats` that
    autograd forms, written out (KB4's Jacobian and its second derivatives
    by `kb4_jacobian` and `kb4_jacobian_vjp`). `flags` is `gate_flags` of
    the forward. A culled splat, a colour channel whose raw SH sum was not
    finite or that sits past +-COLOR_CLAMP, and a non-finite SH coefficient
    get zero gradient, as under autograd; a splat past the Jacobian's clamp
    limits gets the clamped Jacobian's."""
    del img_size  # the gradients do not depend on the image's size
    dev, dt = means.device, means.dtype
    n = means.shape[0]
    ok = (flags & 1).bool()
    okc = ok[:, None]
    chan = torch.stack([((flags >> (1 + c)) & 1).bool() for c in range(3)],
                       dim=-1) & okc
    # The forward's sanitised row (only visible rows' results are kept).
    front = cam.cam_pos + device_constant((0.0, 0.0, 1.0), dev, dt)
    m = torch.where(okc, means, front)
    s = torch.exp(torch.where(okc, log_scales, torch.zeros_like(log_scales)))
    q = torch.where(okc, quats, device_constant((1.0, 0.0, 0.0, 0.0), dev,
                                                dt))
    ro = torch.where(ok, raw_opacities, torch.full_like(raw_opacities, -10.0))
    k = num_sh_coeffs(sh_degree)
    sh = sh_coeffs[:, :k, :]
    sh_ok = torch.isfinite(sh) & chan[:, None, :]
    sh = torch.where(sh_ok, sh, torch.zeros_like(sh))

    rot = cam.viewmat[:, :3]
    fx, fy = cam.pinhole[0], cam.pinhole[1]
    lim = cam.clamp_limits
    mc = [m[:, 0] * rot[i, 0] + m[:, 1] * rot[i, 1] + m[:, 2] * rot[i, 2]
          + cam.viewmat[i, 3] for i in range(3)]
    z = mc[2]
    iz = 1.0 / z
    rx, ry = mc[0] / z, mc[1] / z
    xn = torch.clamp(rx, lim[0], lim[1])
    yn = torch.clamp(ry, lim[2], lim[3])
    in_x = (rx >= lim[0]) & (rx <= lim[1])
    in_y = (ry >= lim[2]) & (ry <= lim[3])
    xc, yc = xn * z, yn * z
    niz2 = -(iz * iz)
    kb4 = isinstance(model, KannalaBrandt4)
    if kb4:
        j = kb4_jacobian(xc, yc, z, fx, fy, model)
    else:
        j00, j02 = fx * iz, fx * xc * niz2
        j11, j12 = fy * iz, fy * yc * niz2

    qn2 = (q * q).sum(-1)
    qnorm = torch.sqrt(torch.clamp_min(qn2, 1e-32))
    qn = q / qnorm[:, None]
    rq = _quat_rot(qn)
    mm = [[rot[i, 0] * rq[0][kk] + rot[i, 1] * rq[1][kk]
           + rot[i, 2] * rq[2][kk] for kk in range(3)] for i in range(3)]
    ns = [[mm[i][kk] * s[:, kk] for kk in range(3)] for i in range(3)]
    if kb4:
        v0, v1 = ([ja[0] * ns[0][kk] + ja[1] * ns[1][kk] + ja[2] * ns[2][kk]
                   for kk in range(3)] for ja in j)
    else:
        v0 = [j00 * ns[0][kk] + j02 * ns[2][kk] for kk in range(3)]
        v1 = [j11 * ns[1][kk] + j12 * ns[2][kk] for kk in range(3)]
    c00 = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2]
    c01 = v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2]
    c11 = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]
    a00, a01, a11 = c00.abs(), c01.abs(), c11.abs()
    m1 = torch.maximum(a00, a11)
    max_abs = torch.maximum(m1, a01)
    clamped = max_abs > COV2D_ENTRY_CLAMP
    sd = torch.where(clamped,
                     COV2D_ENTRY_CLAMP / torch.clamp_min(max_abs, 1e-30),
                     torch.ones_like(max_abs))
    d00, d01, d11 = c00 * sd, c01 * sd, c11 * sd
    blur = COV_BLUR_MIP if mip_splatting else COV_BLUR_DEFAULT
    b00, b11 = d00 + blur, d11 + blur
    det = b00 * b11 - d01 * d01
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    sig = 1.0 / (1.0 + torch.exp(-ro))

    # conic = (b11, -d01, b00) * inv_det
    gk0, gk1, gk2 = v_conic[:, 0], v_conic[:, 1], v_conic[:, 2]
    g_inv = gk0 * b11 - gk1 * d01 + gk2 * b00
    g_det = -g_inv * inv_det * inv_det
    g_b00 = gk2 * inv_det + g_det * b11
    g_b11 = gk0 * inv_det + g_det * b00
    g_d01 = -gk1 * inv_det - 2.0 * g_det * d01
    if mip_splatting:
        det_raw_u = d00 * d11 - d01 * d01
        det_raw = torch.clamp_min(det_raw_u, 0.0)
        det_blur = b00 * b11 - d01 * d01
        fc = torch.sqrt(det_raw / det_blur)
        g_sig = v_opac * fc
        g_ratio = v_opac * sig / (2.0 * torch.where(ok, fc,
                                                    torch.ones_like(fc)))
        g_dr = torch.where(det_raw_u >= 0.0, g_ratio / det_blur,
                           torch.zeros_like(det_blur))
        g_db = -g_ratio * det_raw / (det_blur * det_blur)
        g_b00 = g_b00 + g_db * b11
        g_b11 = g_b11 + g_db * b00
        g_d01 = g_d01 - 2.0 * (g_db + g_dr) * d01
        g_d00 = g_b00 + g_dr * d11
        g_d11 = g_b11 + g_dr * d00
    else:
        g_sig = v_opac
        g_d00, g_d11 = g_b00, g_b11
    e = torch.exp(-ro)
    g_ro = g_sig * sig * sig * e

    # d = c * sd, sd = CLAMP / max_abs where max_abs passes the clamp.
    g_sd = g_d00 * c00 + g_d01 * c01 + g_d11 * c11
    g_max = torch.where(clamped, -g_sd * sd / max_abs,
                        torch.zeros_like(g_sd))
    # torch.maximum splits a tie's gradient evenly.
    half = torch.where(m1 == a01, 0.5, 1.0)
    g_m1 = torch.where(m1 >= a01, g_max * half, torch.zeros_like(g_max))
    g_a01 = torch.where(a01 >= m1, g_max * half, torch.zeros_like(g_max))
    half = torch.where(a00 == a11, 0.5, 1.0)
    g_a00 = torch.where(a00 >= a11, g_m1 * half, torch.zeros_like(g_m1))
    g_a11 = torch.where(a11 >= a00, g_m1 * half, torch.zeros_like(g_m1))
    g_c00 = g_d00 * sd + g_a00 * torch.sign(c00)
    g_c01 = g_d01 * sd + g_a01 * torch.sign(c01)
    g_c11 = g_d11 * sd + g_a11 * torch.sign(c11)

    g_v0 = [2.0 * g_c00 * v0[kk] + g_c01 * v1[kk] for kk in range(3)]
    g_v1 = [2.0 * g_c11 * v1[kk] + g_c01 * v0[kk] for kk in range(3)]
    if kb4:
        g_j = [[sum(g_va[kk] * ns[i][kk] for kk in range(3))
                for i in range(3)] for g_va in (g_v0, g_v1)]
        g_ns = [[g_v0[kk] * j[0][i] + g_v1[kk] * j[1][i] for kk in range(3)]
                for i in range(3)]
    else:
        g_j00 = sum(g_v0[kk] * ns[0][kk] for kk in range(3))
        g_j02 = sum(g_v0[kk] * ns[2][kk] for kk in range(3))
        g_j11 = sum(g_v1[kk] * ns[1][kk] for kk in range(3))
        g_j12 = sum(g_v1[kk] * ns[2][kk] for kk in range(3))
        g_ns = [[g_v0[kk] * j00 for kk in range(3)],
                [g_v1[kk] * j11 for kk in range(3)],
                [g_v0[kk] * j02 + g_v1[kk] * j12 for kk in range(3)]]
    g_s = torch.stack([sum(g_ns[i][kk] * mm[i][kk] for i in range(3))
                       for kk in range(3)], dim=-1)
    g_ls = g_s * s
    g_rq = [[sum(rot[i, j] * g_ns[i][kk] * s[:, kk] for i in range(3))
             for kk in range(3)] for j in range(3)]
    g_qn = _quat_rot_vjp(qn, g_rq)
    g_q = (g_qn - qn * (qn * g_qn).sum(-1, keepdim=True)) / qnorm[:, None]

    # The Jacobian at the clamped point, and mean2d at the point itself.
    g_u, g_v = v_mean2d[:, 0], v_mean2d[:, 1]
    if kb4:
        g_pc = kb4_jacobian_vjp(xc, yc, z, fx, fy, model, g_j)
        jm = kb4_jacobian(mc[0], mc[1], z, fx, fy, model)
        g_xn, g_yn = g_pc[0] * z, g_pc[1] * z
        g_z = g_pc[2] + g_pc[0] * xn + g_pc[1] * yn
        g_mc0 = g_u * jm[0][0] + g_v * jm[1][0]
        g_mc1 = g_u * jm[0][1] + g_v * jm[1][1]
        g_z = g_z + g_u * jm[0][2] + g_v * jm[1][2]
    else:
        g_iz = (g_j00 * fx + g_j11 * fy + 2.0 * iz * (g_j02 * fx * xc
                                                      + g_j12 * fy * yc)
                * -1.0 + g_u * fx * mc[0] + g_v * fy * mc[1])
        g_xn = g_j02 * fx * niz2 * z
        g_yn = g_j12 * fy * niz2 * z
        g_z = (g_j02 * fx * niz2 * xn + g_j12 * fy * niz2 * yn
               - g_iz * iz * iz)
        g_mc0, g_mc1 = g_u * fx * iz, g_v * fy * iz
    g_rx = torch.where(in_x, g_xn, torch.zeros_like(g_xn))
    g_ry = torch.where(in_y, g_yn, torch.zeros_like(g_yn))
    g_mc0 = g_mc0 + g_rx / z
    g_mc1 = g_mc1 + g_ry / z
    g_z = g_z - (g_rx * mc[0] + g_ry * mc[1]) / (z * z)
    g_mc = (g_mc0, g_mc1, g_z)
    g_m = torch.stack([sum(rot[i, j] * g_mc[i] for i in range(3))
                       for j in range(3)], dim=-1)

    # Colour: SH along the view direction, then +0.5 and the clamp.
    vr = m - cam.cam_pos
    nrm = torch.sqrt(vr[:, 0] * vr[:, 0] + vr[:, 1] * vr[:, 1]
                     + vr[:, 2] * vr[:, 2])[:, None]
    big = nrm > 1e-12
    nrm_s = torch.where(big, nrm, torch.ones_like(nrm))
    vd = vr / nrm_s
    basis = sh_basis(vd, sh_degree)                          # [N, k]
    raw = (basis[:, :, None] * sh).sum(dim=1) + SH_COLOR_OFFSET
    pass_c = chan & (raw >= -COLOR_CLAMP) & (raw <= COLOR_CLAMP)
    g_raw = torch.where(pass_c, v_color, torch.zeros_like(v_color))
    g_sh = basis[:, :, None] * g_raw[:, None, :]
    w = (sh * g_raw[:, None, :]).sum(dim=-1)                 # [N, k]
    g_vd = _sh_basis_vjp(vd, w, sh_degree)
    g_vr = torch.where(
        big, (g_vd - vd * (vd * g_vd).sum(-1, keepdim=True)) / nrm_s, g_vd)
    g_m = g_m + g_vr

    zero = torch.zeros((), dtype=dt, device=dev)
    g_sh_full = torch.zeros_like(sh_coeffs)
    g_sh_full[:, :k, :] = torch.where(sh_ok, g_sh, zero)
    return (torch.where(okc, g_m, zero), torch.where(okc, g_ls, zero),
            torch.where(okc, g_q, zero), g_sh_full,
            torch.where(ok, g_ro, zero))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _check_inputs(what, means, log_scales, quats, sh_coeffs, raw_opacities,
                  cam: CameraInputs, sh_degree: int) -> int:
    """Raise unless the row arrays and the camera are contiguous float32
    arrays of the kernels' shapes on one CUDA device; returns N."""
    n = means.shape[0]
    k = sh_coeffs.shape[1] if sh_coeffs.dim() == 3 else -1
    if not 0 <= sh_degree <= 4 or k < num_sh_coeffs(sh_degree):
        raise ValueError(f"{what}: SH degree {sh_degree} with "
                         f"{tuple(sh_coeffs.shape)} coefficients")
    want = ((means, (n, 3), "means"), (log_scales, (n, 3), "log_scales"),
            (quats, (n, 4), "quats"), (sh_coeffs, (n, k, 3), "sh_coeffs"),
            (raw_opacities, (n,), "raw_opacities"),
            (cam.viewmat, (3, 4), "viewmat"), (cam.pinhole, (4,), "pinhole"),
            (cam.clamp_limits, (4,), "clamp_limits"),
            (cam.cam_pos, (3,), "cam_pos"))
    for t, shape, name in want:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    kernels.require_cuda(what, *(t for t, _, _ in want))
    if n >= 1 << 31:
        raise ValueError(f"{what}: {n} rows")
    return n


def _row_ptrs(means, log_scales, quats, sh_coeffs, raw_opacities):
    """The row arrays as the C entry points take them (K after the SH)."""
    return (means.data_ptr(), log_scales.data_ptr(), quats.data_ptr(),
            sh_coeffs.data_ptr(), sh_coeffs.shape[1],
            raw_opacities.data_ptr())


def _camera_ptrs(cam: CameraInputs):
    return (cam.viewmat.data_ptr(), cam.pinhole.data_ptr(),
            cam.clamp_limits.data_ptr(), cam.cam_pos.data_ptr())


def _lens_args(what, model: CameraModel):
    """(lens, k1, k2, k3, k4) as the C entry points take them."""
    if type(model) is KannalaBrandt4:
        return (1, model.k1, model.k2, model.k3, model.k4)
    if type(model) is Pinhole:
        return (0, 0.0, 0.0, 0.0, 0.0)
    raise ValueError(f"{what}: no kernel for the lens {model!r}")


def _render_field(cam: CameraInputs, device):
    """The fisheye cull's half field as the forward kernel takes it:
    (value, None) for a float, (0.0, its tensor) for a float32 on the
    device (a step graph's camera holds it there, one a view)."""
    fov = cam.half_max_render_fov
    if not torch.is_tensor(fov):
        return float(fov), None
    if fov.numel() != 1:
        raise ValueError(f"project_forward: a render field of shape "
                         f"{tuple(fov.shape)}")
    return 0.0, fov.to(device, torch.float32).contiguous()


def project_forward(means, log_scales, quats, sh_coeffs, raw_opacities,
                    cam: CameraInputs, img_size, *, sh_degree: int,
                    mip_splatting: bool, model: CameraModel = Pinhole()):
    """The forward kernel: (ProjectedSplats, flags [N] uint8) of a
    projection through a pinhole or a KannalaBrandt4 lens, equal to
    `project_splats_flags` within `compare_forward`'s rule. Contiguous
    float32 CUDA tensors only."""
    inputs = (means, log_scales, quats, sh_coeffs, raw_opacities)
    lens = _lens_args("project_forward", model)
    n = _check_inputs("project_forward", *inputs, cam, sh_degree)
    dev = means.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    proj = ProjectedSplats(
        visible=empty(n, dtype=torch.bool), depth=empty(n),
        mean2d=empty(n, 2), conic=empty(n, 3), color=empty(n, 3),
        opac=empty(n), power_threshold=empty(n),
        tile_min=empty(n, 2, dtype=torch.int32),
        tile_max=empty(n, 2, dtype=torch.int32),
        num_tiles_bbox=empty(n, dtype=torch.int32), max_radius=empty(n))
    flags = empty(n, dtype=torch.uint8)
    if n == 0:
        return proj, flags
    img_w, img_h = (int(v) for v in img_size)
    fov, fov_at = (_render_field(cam, dev) if type(model) is KannalaBrandt4
                   else (0.0, None))
    err = build.library().brush_project_fwd(
        *_row_ptrs(*inputs), *_camera_ptrs(cam), n, img_w, img_h,
        sh_degree, int(mip_splatting), *lens, fov,
        None if fov_at is None else fov_at.data_ptr(),
        *(getattr(proj, f).data_ptr() for f in _FIELDS), flags.data_ptr(),
        build.stream_ptr(dev))
    build.check(err, "project_forward")
    kernels.note_launch("project_fwd", _replay_forward, compare_forward,
                        *inputs, cam, (img_w, img_h), sh_degree,
                        bool(mip_splatting), model)
    return proj, flags


def _replay_forward(inputs):
    *rows, cam, img_size, degree, mip, model = inputs

    @torch.no_grad()
    def kernel():
        return project_forward(*rows, cam, img_size, sh_degree=degree,
                               mip_splatting=mip, model=model)

    @torch.no_grad()
    def plain():
        return project_splats_flags(*rows, cam, img_size, sh_degree=degree,
                                    mip_splatting=mip, model=model)
    return kernel, plain


def _check_color(gp, wp) -> float:
    d = (gp.color - wp.color).abs()
    limit = COLOR_RTOL * 16.0 * (1.0 + wp.color.abs()) + 1e-6
    if not bool((d <= limit).all()):
        raise AssertionError(f"project_fwd: color off by {float(d.max()):.3g}")
    return float(d.max()) if d.numel() else 0.0


def _same_field(f, g, w):
    try:
        kernels.same_bits(g, w)
    except AssertionError:
        bad = int((g != w).sum()) if g.shape == w.shape else -1
        raise AssertionError(f"project_fwd: {f} differs from the plain "
                             f"version in {bad} entries") from None


def compare_forward(got, want) -> float:
    """Hold the forward kernel's (ProjectedSplats, flags) to the plain
    version's, through either lens; returns the largest colour
    difference, raises AssertionError otherwise.

    Bit for bit: flags, visible, depth, tile_min, tile_max, num_tiles_bbox
    (the same float32 operations in the same order), and mean2d, conic,
    opac, power_threshold, max_radius, compared as float32 words. Colour:
    within COLOR_RTOL x (1 + |want|) x 16 and 1e-6, the rounding of a sum
    of up to 25 SH terms taken in another order."""
    (gp, gf), (wp, wf) = got, want
    kernels.same_bits(gf, wf)
    for f in _FIELDS:
        if f != "color":
            _same_field(f, getattr(gp, f), getattr(wp, f))
    return _check_color(gp, wp)


def _grad_rows(t, n, width, device):
    """A cotangent as (tensor, row stride in elements) the kernel reads:
    zeros where autograd gave none, a copy where its last axis is
    strided."""
    shape = (n, width) if width else (n,)
    if t is None:
        return torch.zeros(shape, dtype=torch.float32, device=device), 0
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(f"project_backward: cotangent {t.dtype} "
                         f"{tuple(t.shape)}, want float32 {shape}")
    if width and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def project_backward(means, log_scales, quats, sh_coeffs, raw_opacities,
                     cam: CameraInputs, img_size, flags, v_mean2d, v_conic,
                     v_color, v_opac, *, sh_degree: int, mip_splatting: bool,
                     model: CameraModel = Pinhole()):
    """The backward kernel: gradients (means, log_scales, quats, sh_coeffs,
    raw_opacities) from the cotangents of mean2d [N, 2], conic [N, 3],
    color [N, 3] and opac [N] (each may be a strided view; None reads as
    zeros), equal to `project_backward_plain` within `compare_backward`."""
    rows = (means, log_scales, quats, sh_coeffs, raw_opacities)
    lens = _lens_args("project_backward", model)
    n = _check_inputs("project_backward", *rows, cam, sh_degree)
    dev = means.device
    if flags.dtype != torch.uint8 or tuple(flags.shape) != (n,):
        raise ValueError("project_backward: flags must be uint8 [N]")
    cots = []
    for t, width in ((v_mean2d, 2), (v_conic, 3), (v_color, 3),
                     (v_opac, 0)):
        cots.append(_grad_rows(t, n, width, dev))
    kernels.require_cuda("project_backward", flags, *(t for t, _ in cots))
    grads = tuple(torch.empty_like(t) for t in rows)
    if n == 0:
        return grads
    err = build.library().brush_project_bwd(
        *_row_ptrs(*rows), *_camera_ptrs(cam), flags.data_ptr(),
        *(v for t, ld in cots for v in (t.data_ptr(), ld)), n, sh_degree,
        int(mip_splatting), *lens, *(g.data_ptr() for g in grads),
        build.stream_ptr(dev))
    build.check(err, "project_backward")
    kernels.note_launch("project_bwd", _replay_backward, compare_backward,
                        *rows, cam, tuple(img_size), flags,
                        *(t for t, _ in cots), sh_degree,
                        bool(mip_splatting), model)
    return grads


def _replay_backward(inputs):
    *args, degree, mip, model = inputs

    @torch.no_grad()
    def kernel():
        return project_backward(*args, sh_degree=degree, mip_splatting=mip,
                                model=model)

    @torch.no_grad()
    def plain():
        return project_backward_plain(*args, sh_degree=degree,
                                      mip_splatting=mip, model=model)
    return kernel, plain


def compare_backward(got, want) -> float:
    """Hold the backward kernel's five gradients to the plain version's:
    every |d| <= BWD_RTOL x the array's largest |entry| (for the
    quaternions, the larger of theirs and the log-scales': both come from
    the same covariance terms, and an isotropic splat's rotation gradient
    is zero but for their rounding), and zero on every row where all five
    plain gradients are zero (culled splats). Returns the largest
    difference; raises AssertionError otherwise."""
    worst = 0.0
    largest = [float(w.abs().max()) if w.numel() else 0.0 for w in want]
    dead = torch.stack([(w.reshape(w.shape[0], -1) == 0).all(dim=1)
                        for w in want]).all(dim=0)
    for i, (name, g, w) in enumerate(zip(_GRAD_FIELDS, got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"project_bwd: {name} {tuple(g.shape)} "
                                 f"against {tuple(w.shape)}")
        d = (g - w).abs()
        scale = (max(largest[i], largest[1]) if name == "quats"
                 else largest[i])
        if not bool((d <= BWD_RTOL * scale).all()):
            raise AssertionError(
                f"project_bwd: {name} off by {float(d.max()):.3g}, past "
                f"{BWD_RTOL:g} of its largest entry {scale:.3g}")
        if bool(g.reshape(g.shape[0], -1)[dead].any()):
            raise AssertionError(f"project_bwd: {name} not zero on a "
                                 f"culled row")
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


class _Project(torch.autograd.Function):
    """The projection on the card: the forward kernel, and the backward
    kernel from the five inputs, the camera, the lens and the gates'
    flags."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, sh_coeffs, raw_opacities,
                cam, img_size, sh_degree, mip_splatting, model):
        proj, flags = project_forward(
            means, log_scales, quats, sh_coeffs, raw_opacities, cam,
            img_size, sh_degree=sh_degree, mip_splatting=mip_splatting,
            model=model)
        ctx.save_for_backward(means, log_scales, quats, sh_coeffs,
                              raw_opacities, *cam[:4], flags)
        ctx.static = (cam.half_max_render_fov, img_size, sh_degree,
                      mip_splatting, model)
        ctx.mark_non_differentiable(*(getattr(proj, f) for f in _NON_DIFF))
        ctx.set_materialize_grads(False)
        return tuple(getattr(proj, f) for f in _FIELDS)

    @staticmethod
    def backward(ctx, *grads):
        *rows, viewmat, pinhole, clamp_limits, cam_pos, flags = (
            ctx.saved_tensors)
        fov, img_size, sh_degree, mip, model = ctx.static
        cam = CameraInputs(viewmat, pinhole, clamp_limits, cam_pos, fov)
        g = dict(zip(_FIELDS, grads))
        out = project_backward(
            *rows, cam, img_size, flags, g["mean2d"], g["conic"],
            g["color"], g["opac"], sh_degree=sh_degree, mip_splatting=mip,
            model=model)
        return (*(o if need else None
                  for o, need in zip(out, ctx.needs_input_grad)),
                None, None, None, None, None)


def project(means, log_scales, quats, sh_coeffs, raw_opacities,
            cam: CameraInputs, img_size, *, sh_degree: int,
            model: CameraModel = Pinhole(), mip_splatting: bool = False
            ) -> ProjectedSplats:
    """Project every splat (the arguments and result of `project_splats`).
    CUDA tensors through a `Pinhole` or `KannalaBrandt4` lens run the
    kernels, differentiable where autograd records; anything else runs
    `project_splats`."""
    if (means.device.type != "cuda"
            or type(model) not in (Pinhole, KannalaBrandt4)):
        count("project.route.torch")
        return project_splats(means, log_scales, quats, sh_coeffs,
                              raw_opacities, cam, img_size,
                              sh_degree=sh_degree, model=model,
                              mip_splatting=mip_splatting)
    count("project.route.cuda")
    count(f"project.lens.{lens_kind(model)}")
    rows = tuple(t.contiguous() for t in (means, log_scales, quats,
                                          sh_coeffs, raw_opacities))
    cam = cam._replace(**{f: getattr(cam, f).contiguous() for f in (
        "viewmat", "pinhole", "clamp_limits", "cam_pos")})
    img_size = tuple(int(v) for v in img_size)
    if torch.is_grad_enabled() and any(t.requires_grad for t in rows):
        return ProjectedSplats(*_Project.apply(
            *rows, cam, img_size, sh_degree, bool(mip_splatting), model))
    return project_forward(*rows, cam, img_size, sh_degree=sh_degree,
                           mip_splatting=mip_splatting, model=model)[0]
