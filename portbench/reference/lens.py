"""Fisheye views of the Kannala-Brandt model with four coefficients (KB4:
OpenCV's fisheye model, COLMAP's OPENCV_FISHEYE) for the plain reference:
the lens's projection, its 2x3 Jacobian written out by hand, the cull on
the render field of view, and a projection of splats through the lens.

A camera-space point (x, y, z) at r = sqrt(x^2 + y^2) from the axis and
theta = atan2(r, z) off it lands at

    u = fx d(theta) x / r + cx,   v = fy d(theta) y / r + cy,
    d(theta) = theta (1 + k1 theta^2 + k2 theta^4 + k3 theta^6 + k4 theta^8),

and within 1e-6 of the axis at the pinhole's (fx x / z + cx, fy y / z + cy)
(Brush kannala_brandt_4.rs). A splat is culled where theta passes half the
render field, min(1.05 hypot(fov_x, fov_y), 2 pi - 1e-6) / 2 (render.rs),
in place of the pinhole's near plane. Everything else of a splat's
projection (covariance, blur, conic, colour, gates, extent) is the
pinhole's of `render.project`; `through_lens()` hands `FisheyeView`s to
this module's `project` wherever the reference projects (its render,
loss and training step), so binning, blending, the loss and the step are
the reference's own.

Departures from Brush: the field of view is the focal's, found by
bisection of d(theta) = (w / 2) / fx on [0, pi] (Brush and the program
invert d by Newton's method; the two land within 1e-12), and the focal is
taken as given, in float32, where Brush recomputes it from the field of
view. The Jacobian is Brush's: at the point itself, unclamped.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import render as R
from portbench.reference.camera import View

AXIS_R = 1.0e-6     # nearer the axis the lens is taken as a pinhole


class FisheyeView(NamedTuple):
    """A KB4 view: the pinhole view's fields and the four coefficients."""

    rot: np.ndarray      # [3, 3] float64, world to camera
    trans: np.ndarray    # [3] float64
    position: np.ndarray  # [3] float64 camera centre in the world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k: tuple             # (k1, k2, k3, k4)

    def fov(self) -> tuple:
        """(fov_x, fov_y): twice the angle off the axis at the image's
        edge, the image centred."""
        return (2.0 * invert_d(self.width / 2.0 / self.fx, self.k),
                2.0 * invert_d(self.height / 2.0 / self.fy, self.k))

    def half_max_render_fov(self) -> float:
        fx, fy = self.fov()
        return min(1.05 * math.hypot(fx, fy), 2.0 * math.pi - 1e-6) / 2.0

    def pinhole(self) -> View:
        """The same view with the lens dropped: a pinhole of the same
        focal and centre."""
        return View(*self[:9])


def fisheye(view: View, k) -> FisheyeView:
    return FisheyeView(*view, tuple(float(c) for c in k))


def distort(theta, k):
    """d(theta) of KB4 (floats or tensors)."""
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2]
                                                          + t2 * k[3]))))


def distort_slope(theta, k):
    """d'(theta)."""
    t2 = theta * theta
    return 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (
        7.0 * k[2] + t2 * 9.0 * k[3])))


def invert_d(target: float, k) -> float:
    """theta in [0, pi] with d(theta) = target, by bisection (d rises on
    the interval for the coefficients of a real lens)."""
    lo, hi = 0.0, math.pi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if distort(mid, k) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _lens_terms(x, y, z):
    """r^2, the rows on the axis, r and theta, each branch's inputs kept
    finite where the other is taken (a culled splat's gradient is zero,
    and 0 x inf would make it NaN): r is 1 on the axis, and z is 1 off
    it for the pinhole's 1 / z."""
    r2 = x * x + y * y
    axis = r2 < AXIS_R * AXIS_R
    r = torch.sqrt(torch.where(axis, torch.ones_like(r2), r2))
    return (r2, axis, r, torch.atan2(r, z),
            torch.where(axis, z, torch.ones_like(z)))


def kb4_project(x, y, z, fx, fy, cx, cy, k):
    """Pixel coordinates (u, v) of camera-space points."""
    _, axis, r, theta, zp = _lens_terms(x, y, z)
    s = distort(theta, k) / r
    return (torch.where(axis, fx * x / zp, fx * s * x) + cx,
            torch.where(axis, fy * y / zp, fy * s * y) + cy)


def kb4_jacobian(x, y, z, fx, fy, k):
    """d(u, v) / d(x, y, z): [N, 2, 3], by hand. With s = d(theta) / r,
    theta_r = z / (r^2 + z^2) and p = d'(theta) theta_r:

        du/dx = fx (s + (p - s) x^2 / r^2)   du/dy = fx (p - s) x y / r^2
        du/dz = -fx x d'(theta) / (r^2 + z^2), and v alike with y and fy;

    the pinhole's near the axis."""
    r2, axis, r, theta, zp = _lens_terms(x, y, z)
    safe_r2 = torch.where(axis, torch.ones_like(r2), r2)
    s = distort(theta, k) / r
    rho2 = r2 + z * z
    slope = distort_slope(theta, k)
    p = slope * z / rho2
    c = (p - s) / safe_r2
    dz = -slope / rho2
    fish = torch.stack([fx * (s + c * x * x), fx * c * x * y, fx * x * dz,
                        fy * c * x * y, fy * (s + c * y * y), fy * y * dz],
                       -1)
    zero = torch.zeros_like(z)
    pin = torch.stack([fx / zp, zero, -fx * x / (zp * zp),
                       zero, fy / zp, -fy * y / (zp * zp)], -1)
    return torch.where(axis[:, None], pin, fish).reshape(-1, 2, 3)


def project(means, log_scales, quats, sh, raw_opac, view: FisheyeView,
            dtype=torch.float32) -> R.Projected:
    """`render.project` through the view's lens: the same splat math, the
    lens's position and Jacobian, and the render-field cull in place of
    the near plane. Differentiable in the five arrays."""
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
    m = (rot @ R.quat_to_rot(qn)) * scale[:, None, :]
    v = kb4_jacobian(x, y, z, fx, fy, view.k) @ m
    cov = v @ v.transpose(1, 2)
    c00 = cov[:, 0, 0] + R.COV_BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + R.COV_BLUR
    det = c00 * c11 - c01 * c01
    safe_det = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c11, -c01, c00], -1) / safe_det[:, None]
    mean2d = torch.stack(kb4_project(x, y, z, fx, fy, cx, cy, view.k), -1)
    cam_pos = torch.as_tensor(view.position, dtype=torch.float32).to(
        dev, dtype)
    d = means - cam_pos
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    color = (R.sh_basis(d)[:, :, None] * sh[:, :16, :]).sum(1) \
        + R.COLOR_OFFSET
    color = torch.clamp(color, -R.COLOR_CLAMP, R.COLOR_CLAMP)
    opac = torch.sigmoid(raw_opac)

    with torch.no_grad():
        xf, yf, zf = x.float(), y.float(), z.float()
        opf, con, m2d = opac.float(), conic.float(), mean2d.float()
        theta = torch.atan2(torch.sqrt(xf * xf + yf * yf), zf)
        ok = torch.isfinite(mean_c.float()).all(-1)
        ok &= theta <= view.half_max_render_fov()
        ok &= torch.isfinite(scale.float()).all(-1) & (det.float() > 0)
        ok &= opf >= R.ALPHA_MIN
        power = torch.log(torch.clamp_min(opf, 1e-30) * 255.0)
        cdet = con[:, 0] * con[:, 2] - con[:, 1] * con[:, 1]
        ok &= cdet > 0
        cinv = 1.0 / torch.where(cdet > 0, cdet, torch.ones_like(cdet))
        ex = torch.sqrt(torch.clamp_min(2.0 * power * con[:, 2] * cinv, 0.0))
        ey = torch.sqrt(torch.clamp_min(2.0 * power * con[:, 0] * cinv, 0.0))
        ok &= ((m2d[:, 0] + ex > 0) & (m2d[:, 0] - ex < view.width)
               & (m2d[:, 1] + ey > 0) & (m2d[:, 1] - ey < view.height))
        ok &= torch.isfinite(m2d).all(-1) & torch.isfinite(con).all(-1)
    opac = torch.where(ok, opac, torch.zeros_like(opac))
    return R.Projected(mean2d=mean2d, conic=conic, color=color, opac=opac,
                       depth=zf.detach(), visible=ok,
                       extent=torch.stack([ex, ey], -1))


@contextlib.contextmanager
def through_lens():
    """Within the block the reference projects a `FisheyeView` through
    its lens (render, loss and training step alike) and any other view
    as before."""
    pinhole = R.project

    def dispatch(means, log_scales, quats, sh, raw_opac, view,
                 dtype=torch.float32):
        fn = project if isinstance(view, FisheyeView) else pinhole
        return fn(means, log_scales, quats, sh, raw_opac, view, dtype)

    R.project = dispatch
    try:
        yield
    finally:
        R.project = pinhole
