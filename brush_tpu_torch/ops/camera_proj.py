"""Device-side lens projection for all four camera models.

Port of `brush_tpu/ops/camera_proj.py`, formula for formula (the reference
kernels are brush-render/src/kernels/camera_model/*.rs). The projection
Jacobian is forward-mode autodiff of the projection function,
`torch.func.vmap(torch.func.jacfwd(...))`, evaluated at the clamp-adjusted
point `(clamp(x/z)*z, clamp(y/z)*z, z)` — the same rule the JAX package
uses, which reproduces the reference's hand-derived clamped Jacobians.
`torch.func.jacfwd` returns these Jacobians in float64 for float32 points,
so the result is cast back to the input's dtype. PyTorch keeps forward-mode
AD levels process-wide, so two threads in `jacfwd` at once break each
other's levels ("Trying to access a forward AD level with an invalid
index"): the web viewer renders on its server's threads while a training
run projects on its own, and `_JACFWD_LOCK` lets one thread in at a time.

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


_JACFWD_LOCK = threading.Lock()


def projection_jacobian(
    mean_c: torch.Tensor,
    pinhole: torch.Tensor,
    clamp_limits: torch.Tensor,
    model: CameraModel,
) -> torch.Tensor:
    """EWA projection Jacobian d(uv)/d(mean_c): [N, 2, 3].

    Evaluated at the clamp-adjusted point so it matches the reference's
    clamped Jacobians. `clamp_limits` is
    [lim_neg_x, lim_pos_x, lim_neg_y, lim_pos_y].
    """
    z = mean_c[..., 2]
    xn = torch.clamp(mean_c[..., 0] / z, clamp_limits[0], clamp_limits[1])
    yn = torch.clamp(mean_c[..., 1] / z, clamp_limits[2], clamp_limits[3])
    clamped = torch.stack([xn * z, yn * z, z], dim=-1)

    def proj_one(pt):
        return project(pt, pinhole, model)

    with _JACFWD_LOCK:
        jac = torch.func.vmap(torch.func.jacfwd(proj_one))(
            clamped.reshape(-1, 3))
    return jac.to(mean_c.dtype).reshape(mean_c.shape[:-1] + (2, 3))
