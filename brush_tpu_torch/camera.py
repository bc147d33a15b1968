"""Host-side camera representation and lens-model math.

The parts of `brush_tpu/camera.py` the render needs, copied (plain numpy,
no JAX): the port keeps its own so that it never imports the reference
package.

Mirrors the reference's conventions (brush-render/src/camera.rs): a camera is
a camera-to-world pose (position + wxyz quaternion), horizontal/vertical FOV,
a normalized principal point `center_uv`, and a lens model. The camera looks
down +Z in its local frame (COLMAP convention).

Device-side projection math lives in ops/camera_proj.py; this module
is plain numpy/float64 host math (the RT8 radius inversion is the
fixed-point iteration of camera.rs:183-198).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from brush_tpu_torch.constants import JAC_CLAMP_NEG_MARGIN, JAC_CLAMP_POS_MARGIN


# --------------------------------------------------------------------------
# Lens models. The model *type* is a Python value that picks the projection
# code (like the reference's comptime CameraModel enum); the coefficients are
# Python floats.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pinhole:
    pass


@dataclasses.dataclass(frozen=True)
class KannalaBrandt4:
    """Fisheye: d(theta) = theta(1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8)."""

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0


@dataclasses.dataclass(frozen=True)
class RadialTangential8:
    """OpenCV rational model: radial (1+k1 r2+k2 r4+k3 r6)/(1+k4 r2+k5 r4+k6 r6)
    plus tangential p1/p2 on the undistorted pinhole plane."""

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


@dataclasses.dataclass(frozen=True)
class ThinPrismFisheye:
    """KB4 + tangential p1/p2 + thin-prism sx1/sy1 terms."""

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    sx1: float = 0.0
    sy1: float = 0.0


CameraModel = Pinhole | KannalaBrandt4 | RadialTangential8 | ThinPrismFisheye


def is_fisheye(model: CameraModel) -> bool:
    return isinstance(model, (KannalaBrandt4, RadialTangential8, ThinPrismFisheye))


_LENS_KINDS = {Pinhole: "pinhole", KannalaBrandt4: "kb4",
               RadialTangential8: "rt8", ThinPrismFisheye: "tpf"}


def lens_kind(model: CameraModel) -> str:
    """The lens's short name, as the tracing counters give it."""
    return _LENS_KINDS[type(model)]


# --- KB4 distortion polynomial (camera.rs:118-171) ---


def _kb4_d(theta: float, k1, k2, k3, k4) -> float:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _kb4_dd(theta: float, k1, k2, k3, k4) -> float:
    t2 = theta * theta
    return 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))


def _kb4_invert_d(target: float, k1, k2, k3, k4) -> float:
    """Newton inversion of d(theta) = target on [0, pi]."""
    if target <= 0.0:
        return 0.0
    theta = min(target, math.pi - 1e-6)
    for _ in range(50):
        fp = _kb4_dd(theta, k1, k2, k3, k4)
        if abs(fp) < 1e-12:
            break
        nxt = min(max(theta - (_kb4_d(theta, k1, k2, k3, k4) - target) / fp,
                      0.0), math.pi)
        if abs(nxt - theta) < 1e-12:
            return nxt
        theta = nxt
    return theta


def _rt8_radial(r: float, m: RadialTangential8) -> float:
    r2 = r * r
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + m.k1 * r2 + m.k2 * r4 + m.k3 * r6
    den = 1.0 + m.k4 * r2 + m.k5 * r4 + m.k6 * r6
    return num / den


def rt8_undistort_radius(r_d: float, m: RadialTangential8) -> float:
    """Fixed-point inversion of r * radial(r) = r_d (camera.rs:183-198)."""
    r = r_d
    for _ in range(30):
        factor = _rt8_radial(r, m)
        if abs(factor) < 1e-12:
            break
        r_new = r_d / factor
        if abs(r_new - r) < 1e-12:
            return r_new
        r = r_new
    return r


def fov_to_focal(fov: float, pixels: int, model: CameraModel) -> float:
    """Focal f with r_pix = f * projection(fov/2) (camera.rs:86-103)."""
    half = fov / 2.0
    r_pix = pixels / 2.0
    if isinstance(model, Pinhole):
        projected = math.tan(half)
    elif isinstance(model, KannalaBrandt4):
        projected = _kb4_d(half, model.k1, model.k2, model.k3, model.k4)
    elif isinstance(model, RadialTangential8):
        r = math.tan(half)
        projected = r * _rt8_radial(r, model)
    else:  # ThinPrismFisheye uses its KB4 part
        projected = _kb4_d(half, model.k1, model.k2, model.k3, model.k4)
    return r_pix / projected


def focal_to_fov(focal: float, pixels: int, model: CameraModel) -> float:
    """Inverse of `fov_to_focal` (the dataset readers' intrinsics)."""
    r_norm = (pixels / 2.0) / focal
    if isinstance(model, Pinhole):
        half = math.atan(r_norm)
    elif isinstance(model, RadialTangential8):
        half = math.atan(rt8_undistort_radius(r_norm, model))
    else:  # KannalaBrandt4, and ThinPrismFisheye through its KB4 part
        half = _kb4_invert_d(r_norm, model.k1, model.k2, model.k3, model.k4)
    return 2.0 * half


# --------------------------------------------------------------------------
# Camera
# --------------------------------------------------------------------------


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass
class Camera:
    """Camera-to-world pose + intrinsics (camera.rs:12-40)."""

    position: np.ndarray          # [3] world-space position
    rotation: np.ndarray          # [4] wxyz quaternion, camera-to-world
    fov_x: float
    fov_y: float
    center_uv: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5]))
    model: CameraModel = dataclasses.field(default_factory=Pinhole)

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float64).reshape(3)
        self.rotation = np.asarray(self.rotation, dtype=np.float64).reshape(4)
        self.center_uv = np.asarray(self.center_uv, dtype=np.float64).reshape(2)

    def focal(self, img_size: Tuple[int, int]) -> np.ndarray:
        w, h = img_size
        return np.array(
            [fov_to_focal(self.fov_x, w, self.model),
             fov_to_focal(self.fov_y, h, self.model)])

    def center(self, img_size: Tuple[int, int]) -> np.ndarray:
        w, h = img_size
        return np.array([self.center_uv[0] * w, self.center_uv[1] * h])

    def local_to_world(self) -> np.ndarray:
        """[4,4] affine."""
        m = np.eye(4)
        q = self.rotation / np.linalg.norm(self.rotation)
        m[:3, :3] = _quat_to_rotmat_np(q)
        m[:3, 3] = self.position
        return m

    def world_to_local(self) -> np.ndarray:
        """[4,4] world-to-camera affine (R^T, -R^T t)."""
        q = self.rotation / np.linalg.norm(self.rotation)
        r = _quat_to_rotmat_np(q)
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ self.position
        return m

    def viewmat(self) -> np.ndarray:
        """[3,4] f32 world-to-camera matrix for the device pipeline."""
        return self.world_to_local()[:3].astype(np.float32)

    def pinhole_params(self, img_size: Tuple[int, int]) -> np.ndarray:
        """[fx, fy, cx, cy] as f32 (camera.rs build_pinhole_params)."""
        f = self.focal(img_size)
        c = self.center(img_size)
        return np.array([f[0], f[1], c[0], c[1]], dtype=np.float32)

    def jacobian_clamp_limits(self, img_size: Tuple[int, int]) -> np.ndarray:
        """[lim_neg_x, lim_pos_x, lim_neg_y, lim_pos_y] (camera.rs:200-254).

        Bounds the normalized view coordinate x/z feeding the EWA Jacobian:
        pinhole uses the canonical 3DGS 1.3*tan(fov/2) band expressed as
        margins around the image; RT8 undistorts the pinhole bound; pure
        fisheyes are unclamped (Jacobian doesn't blow up)."""
        w, h = img_size
        fx, fy, cx, cy = self.pinhole_params(img_size)
        model = self.model
        if isinstance(model, Pinhole):
            lim = [
                (JAC_CLAMP_NEG_MARGIN * w - cx) / fx,
                (JAC_CLAMP_POS_MARGIN * w - cx) / fx,
                (JAC_CLAMP_NEG_MARGIN * h - cy) / fy,
                (JAC_CLAMP_POS_MARGIN * h - cy) / fy,
            ]
        elif isinstance(model, RadialTangential8):
            # Distorted pixel bound -> undistorted coordinate bound.
            lim = [
                -rt8_undistort_radius(abs((JAC_CLAMP_NEG_MARGIN * w - cx) / fx), model),
                rt8_undistort_radius(abs((JAC_CLAMP_POS_MARGIN * w - cx) / fx), model),
                -rt8_undistort_radius(abs((JAC_CLAMP_NEG_MARGIN * h - cy) / fy), model),
                rt8_undistort_radius(abs((JAC_CLAMP_POS_MARGIN * h - cy) / fy), model),
            ]
        else:
            big = 1.0e30
            lim = [-big, big, -big, big]
        return np.array(lim, dtype=np.float32)

    def half_max_render_fov(self) -> float:
        """Fisheye render-FOV cull bound (render.rs:69-70)."""
        diag = math.hypot(self.fov_x, self.fov_y)
        return min(1.05 * diag, 2.0 * math.pi - 1e-6) / 2.0
