"""Pinhole cameras of the benchmark's views, built from a position and an
orientation in float64 and handed to the renderer in float32."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

# The Jacobian clamp of the EWA projection: x/z is held to the image widened
# by these margins (Brush camera.rs:220-226).
JAC_CLAMP_NEG = -0.15
JAC_CLAMP_POS = 1.15


class View(NamedTuple):
    """A pinhole view: world-to-camera rotation and translation, intrinsics
    and the image size."""

    rot: np.ndarray      # [3, 3] float64, world to camera
    trans: np.ndarray    # [3] float64
    position: np.ndarray  # [3] float64 camera centre in the world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def clamp_limits(self) -> tuple:
        """(x/z low, x/z high, y/z low, y/z high) of the Jacobian clamp."""
        w, h = self.width, self.height
        f = np.float32
        fx, fy, cx, cy = f(self.fx), f(self.fy), f(self.cx), f(self.cy)
        return (float((JAC_CLAMP_NEG * w - cx) / fx),
                float((JAC_CLAMP_POS * w - cx) / fx),
                float((JAC_CLAMP_NEG * h - cy) / fy),
                float((JAC_CLAMP_POS * h - cy) / fy))


def view_from_c2w(c2w_rot: np.ndarray, position, focal_x: float,
                  focal_y: float, width: int, height: int) -> View:
    """A view from its camera-to-world rotation (columns: right, down,
    forward) and centre; the principal point is the image centre."""
    r = np.asarray(c2w_rot, np.float64)
    pos = np.asarray(position, np.float64)
    return View(rot=r.T.copy(), trans=-r.T @ pos, position=pos,
                fx=float(focal_x), fy=float(focal_y), cx=width / 2.0,
                cy=height / 2.0, width=int(width), height=int(height))


def look_at_origin(position) -> np.ndarray:
    """Camera-to-world rotation of a camera at `position` looking at the
    origin, world +y as the image's down axis."""
    pos = np.asarray(position, np.float64)
    fwd = -pos / max(np.linalg.norm(pos), 1e-9)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)


def orbit_view(position, fov_x: float, width: int, height: int) -> View:
    """A look-at-origin view with a horizontal field of view `fov_x` and
    the vertical one scaled by the aspect."""
    fov_y = fov_x * height / width
    return view_from_c2w(look_at_origin(position), position,
                         (width / 2.0) / math.tan(fov_x / 2.0),
                         (height / 2.0) / math.tan(fov_y / 2.0),
                         width, height)


def arc_views(n: int, step: float, radius: float, focal: float, width: int,
              height: int) -> list[View]:
    """`n` views about the bench camera at (0, 0, -radius): yawed by 0,
    +step, -step, +2 step, ... about the vertical axis, looking at the
    origin, one focal length in both axes."""
    angles = [0.0]
    k = 1
    while len(angles) < n:
        angles += [k * step, -k * step]
        k += 1
    out = []
    for a in angles[:n]:
        c, s = math.cos(a), math.sin(a)
        rot_y = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        pos = np.array([-radius * s, 0.0, -radius * c])
        out.append(view_from_c2w(rot_y, pos, focal, focal, width, height))
    return out
