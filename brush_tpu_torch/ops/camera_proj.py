"""Device-side lens projection for all four camera models.

Port of `brush_tpu/ops/camera_proj.py`, formula for formula (the reference
kernels are brush-render/src/kernels/camera_model/*.rs). The projection
Jacobian is evaluated at the clamp-adjusted point `(clamp(x/z)*z,
clamp(y/z)*z, z)` — the same rule the JAX package uses, which reproduces
the reference's hand-derived clamped Jacobians. KB4's is its closed form
in the input's dtype (`kb4_jacobian`, with `kb4_jacobian_vjp` its second
derivatives): the CUDA projection kernels' specification, which they
repeat bit for bit (csrc/project.cuh, where the forms are derived). Every
other lens's is forward-mode autodiff of the projection function,
`torch.func.vmap(torch.func.jacfwd(...))`, which returns the Jacobians in
float64 for float32 points, so the result is cast back to the input's
dtype. PyTorch keeps forward-mode AD levels process-wide, so two threads
in `jacfwd` at once break each other's levels ("Trying to access a
forward AD level with an invalid index"): the web viewer renders on its
server's threads while a training run projects on its own, and
`_JACFWD_LOCK` lets one thread in at a time.

The model *type* is a Python value; its coefficients are Python floats.
"""

from __future__ import annotations

import threading

import torch

from brush_tpu_torch.camera import (
    CameraModel,
    KannalaBrandt4,
    Pinhole,
    RadialTangential8,
    ThinPrismFisheye,
)


def _project_pinhole(p: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = ph[0], ph[1], ph[2], ph[3]
    inv_z = 1.0 / p[..., 2]
    return torch.stack(
        [fx * p[..., 0] * inv_z + cx, fy * p[..., 1] * inv_z + cy], dim=-1)


def _project_kb4(p: torch.Tensor, ph: torch.Tensor,
                 m: KannalaBrandt4) -> torch.Tensor:
    fx, fy, cx, cy = ph[0], ph[1], ph[2], ph[3]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / z
    pin_u = fx * x * inv_z + cx
    pin_v = fy * y * inv_z + cy

    r2 = x * x + y * y
    near_axis = r2 < 1e-12  # matches r < 1e-6 (kannala_brandt_4.rs:48)
    # Guard the non-selected branch so the Jacobian stays NaN-free.
    r = torch.sqrt(torch.where(near_axis, torch.ones_like(r2), r2))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (m.k1 + t2 * (m.k2 + t2 * (m.k3 + t2 * m.k4))))
    inv_r = 1.0 / r
    fe_u = fx * (d * x * inv_r) + cx
    fe_v = fy * (d * y * inv_r) + cy
    return torch.stack(
        [torch.where(near_axis, pin_u, fe_u),
         torch.where(near_axis, pin_v, fe_v)], dim=-1)


def _project_rt8(p: torch.Tensor, ph: torch.Tensor,
                 m: RadialTangential8) -> torch.Tensor:
    fx, fy, cx, cy = ph[0], ph[1], ph[2], ph[3]
    x_ = p[..., 0] / p[..., 2]
    y_ = p[..., 1] / p[..., 2]
    x2, y2 = x_ * x_, y_ * y_
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r4 * r2
    d = (1.0 + m.k1 * r2 + m.k2 * r4 + m.k3 * r6) / (
        1.0 + m.k4 * r2 + m.k5 * r4 + m.k6 * r6)
    xy = x_ * y_
    xd = x_ * d + 2.0 * m.p1 * xy + m.p2 * (r2 + 2.0 * x2)
    yd = y_ * d + 2.0 * m.p2 * xy + m.p1 * (r2 + 2.0 * y2)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def _project_tpf(p: torch.Tensor, ph: torch.Tensor,
                 m: ThinPrismFisheye) -> torch.Tensor:
    kb4 = KannalaBrandt4(m.k1, m.k2, m.k3, m.k4)
    uv = _project_kb4(p, ph, kb4)
    fx, fy = ph[0], ph[1]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z2 = 1.0 / (z * z)
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    nu = 2.0 * m.p1 * xy + m.p2 * (3.0 * x2 + y2) + m.sx1 * r2
    nv = 2.0 * m.p2 * xy + m.p1 * (x2 + 3.0 * y2) + m.sy1 * r2
    return uv + torch.stack([fx * nu * inv_z2, fy * nv * inv_z2], dim=-1)


def project(mean_c: torch.Tensor, pinhole: torch.Tensor,
            model: CameraModel) -> torch.Tensor:
    """Project camera-space points [..., 3] to pixel coords [..., 2].

    `pinhole` is [fx, fy, cx, cy]; `model` picks the lens type.
    """
    if isinstance(model, Pinhole):
        return _project_pinhole(mean_c, pinhole)
    if isinstance(model, KannalaBrandt4):
        return _project_kb4(mean_c, pinhole, model)
    if isinstance(model, RadialTangential8):
        return _project_rt8(mean_c, pinhole, model)
    if isinstance(model, ThinPrismFisheye):
        return _project_tpf(mean_c, pinhole, model)
    raise TypeError(f"unknown camera model {model!r}")


def _kb4_axis(x, y, z):
    """(rows within 1e-6 of the axis, r^2 with 1 on them, z with 1 off
    them): each branch's inputs kept finite where the other is taken."""
    r2 = x * x + y * y
    axis = r2 < 1e-12
    one = torch.ones_like(r2)
    return axis, torch.where(axis, one, r2), torch.where(axis, z, one)


def _kb4_terms(r2, z, model: KannalaBrandt4):
    """r, rho2 = r^2 + z^2, d'(theta), d''(theta), s = d / r, c = (p - s) /
    r^2 and dz = -d' / rho2 of KB4 at off-axis points (csrc/project.cuh
    `Kb4::terms`); `r2` is 1 on the caller's axis rows, so every term
    stays finite there."""
    k1, k2, k3, k4 = model.k1, model.k2, model.k3, model.k4
    r = torch.sqrt(r2)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    d1 = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                       + t2 * (9.0 * k4))))
    d2 = theta * (6.0 * k1 + t2 * (20.0 * k2 + t2 * (42.0 * k3
                                                     + t2 * (72.0 * k4))))
    rho2 = r2 + z * z
    s = d / r
    c = (d1 * z / rho2 - s) / r2
    return r, rho2, d1, d2, s, c, -d1 / rho2


def kb4_jacobian(x, y, z, fx, fy, model: KannalaBrandt4):
    """d(u, v) / d(x, y, z) of KB4 at camera-space points [...], in closed
    form (`Kb4::jacobian`, the forward kernel's, which repeats these
    operations in their order): rows [[du/dx, du/dy, du/dz], [dv/dx,
    dv/dy, dv/dz]] of tensors; the pinhole's near the axis."""
    axis, r2, zp = _kb4_axis(x, y, z)
    _, _, _, _, s, c, dz = _kb4_terms(r2, z, model)
    iz = 1.0 / zp
    niz2 = -(iz * iz)
    cxy = c * x * y
    zero = torch.zeros_like(z)
    fish = ((fx * (s + c * x * x), fx * cxy, fx * x * dz),
            (fy * cxy, fy * (s + c * y * y), fy * y * dz))
    pin = ((fx * iz, zero, fx * x * niz2), (zero, fy * iz, fy * y * niz2))
    return [[torch.where(axis, p, f) for p, f in zip(prow, frow)]
            for prow, frow in zip(pin, fish)]


def kb4_jacobian_vjp(x, y, z, fx, fy, model: KannalaBrandt4, gj):
    """Gradient w.r.t. the point (x, y, z) of sum_ai gj[a][i] * J[a][i],
    J = `kb4_jacobian`: the Jacobian's second derivatives against a
    cotangent, in closed form (`Kb4::jacobian_vjp`, the backward
    kernel's)."""
    a, b, cc = fx * gj[0][0], fx * gj[0][1], fx * gj[0][2]
    d, e, f = fy * gj[1][0], fy * gj[1][1], fy * gj[1][2]
    axis, r2, zp = _kb4_axis(x, y, z)
    r, rho2, d1, d2, _, c, dz = _kb4_terms(r2, z, model)
    bd = b + d
    q = a * x * x + bd * x * y + e * y * y
    p = cc * x + f * y
    irho4 = 1.0 / (rho2 * rho2)
    eta = (d2 * z / r - 2.0 * d1) * irho4
    wr = (a + e) * c + q * (z * eta - 3.0 * c) / r2 - p * eta
    fish = (wr * x + c * (2.0 * a * x + bd * y) + dz * cc,
            wr * y + c * (bd * x + 2.0 * e * y) + dz * f,
            (a + e) * dz - q * eta + p * (d2 * r + 2.0 * z * d1) * irho4)
    iz = 1.0 / zp
    iz2 = iz * iz
    pin = (-cc * iz2, -f * iz2, -(a + e) * iz2 + 2.0 * p * iz2 * iz)
    return tuple(torch.where(axis, pv, fv) for pv, fv in zip(pin, fish))


_JACFWD_LOCK = threading.Lock()


def projection_jacobian(
    mean_c: torch.Tensor,
    pinhole: torch.Tensor,
    clamp_limits: torch.Tensor,
    model: CameraModel,
) -> torch.Tensor:
    """EWA projection Jacobian d(uv)/d(mean_c): [N, 2, 3].

    Evaluated at the clamp-adjusted point so it matches the reference's
    clamped Jacobians; KB4's in closed form, any other lens's by
    forward-mode AD. `clamp_limits` is
    [lim_neg_x, lim_pos_x, lim_neg_y, lim_pos_y].
    """
    z = mean_c[..., 2]
    xn = torch.clamp(mean_c[..., 0] / z, clamp_limits[0], clamp_limits[1])
    yn = torch.clamp(mean_c[..., 1] / z, clamp_limits[2], clamp_limits[3])
    if isinstance(model, KannalaBrandt4):
        j = kb4_jacobian(xn * z, yn * z, z, pinhole[0], pinhole[1], model)
        return torch.stack([torch.stack(row, dim=-1) for row in j], dim=-2)
    clamped = torch.stack([xn * z, yn * z, z], dim=-1)

    def proj_one(pt):
        return project(pt, pinhole, model)

    with _JACFWD_LOCK:
        jac = torch.func.vmap(torch.func.jacfwd(proj_one))(
            clamped.reshape(-1, 3))
    return jac.to(mean_c.dtype).reshape(mean_c.shape[:-1] + (2, 3))
