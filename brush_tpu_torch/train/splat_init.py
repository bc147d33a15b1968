"""Splat initialization: random frustum sampling or from a point cloud (port
of `brush_tpu/train/splat_init.py`).

Host-side (numpy/scipy) counterpart of brush-train/src/splat_init.rs:
scene-scale estimation from camera spacing (:24-47), frustum sampling with
log-uniform depth (:54-128), percentile bounds (:130-165), and KNN-density
scales via a KD-tree (:180-216; scipy's cKDTree in place of the BallTree).
The draws come from the caller's `np.random.Generator` in the JAX package's
order, so both packages build the same arrays from one seed.

As in the JAX package, frustum points are sampled at local z = +depth (the
reference samples -depth, behind its own cameras), so a random init starts
visible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.models.splats import Splats, from_raw
from brush_tpu_torch.ops.sh import num_sh_coeffs


@dataclasses.dataclass
class BoundingBox:
    center: np.ndarray
    extent: np.ndarray

    @classmethod
    def from_min_max(cls, mn, mx):
        mn = np.asarray(mn, np.float32)
        mx = np.asarray(mx, np.float32)
        return cls(center=(mn + mx) / 2.0, extent=(mx - mn) / 2.0)

    def median_size(self) -> float:
        """Middle extent x2 (bounding_box.rs:23-29)."""
        e = np.sort(np.asarray(self.extent, np.float64))
        return float(e[1] * 2.0)


def bounds_from_pos(percentile: float, means: np.ndarray) -> BoundingBox:
    """Per-axis percentile bounding box over the finite coordinates
    (splat_init.rs:130-165)."""
    means = np.asarray(means, np.float32).reshape(-1, 3)
    mins, maxs = [], []
    for axis in range(3):
        v = means[:, axis]
        v = np.sort(v[np.isfinite(v)])
        if v.size == 0:
            return BoundingBox.from_min_max([-1.0] * 3, [1.0] * 3)
        n = v.size
        lo = int((1.0 - percentile) / 2.0 * n)
        hi = min(n - 1, int((1.0 + percentile) / 2.0 * n))
        mins.append(v[lo])
        maxs.append(v[hi])
    return BoundingBox.from_min_max(mins, maxs)


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


def estimate_scene_scale(cameras: Sequence[Camera]) -> float:
    """3x the average camera nearest-neighbor distance, min 1m
    (splat_init.rs:24-47)."""
    if len(cameras) < 2:
        return 1.0
    pos = np.stack([c.position for c in cameras])
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    avg_nn = d.min(axis=1).mean()
    return max(float(avg_nn) * 3.0, 1.0)


def create_random_splats(
    init_count: int,
    cameras: Sequence[Camera],
    rng: np.random.Generator,
    scene_scale_override: float | None = None,
    sh_degree: int = 0,
    capacity: int | None = None,
    device="cuda",
) -> Splats:
    """Frustum-sampled random init (splat_init.rs:54-128): random camera,
    random in-FOV ray, log-uniform depth in [0.05, 1] x scene_scale."""
    scene_scale = (scene_scale_override if scene_scale_override is not None
                   else estimate_scene_scale(cameras))
    near, far = scene_scale * 0.05, scene_scale

    n = init_count
    cam_idx = rng.integers(0, len(cameras), n)
    positions = np.empty((n, 3), np.float32)
    # One splat at a time: the draws interleave per splat, and their order
    # is what makes the arrays equal to the JAX package's.
    for i, ci in enumerate(cam_idx):
        cam = cameras[ci]
        dx = math.tan(rng.uniform(-cam.fov_x / 2, cam.fov_x / 2))
        dy = math.tan(rng.uniform(-cam.fov_y / 2, cam.fov_y / 2))
        depth = math.exp(rng.uniform(math.log(near), math.log(far)))
        local = np.array([dx * depth, dy * depth, depth, 1.0])
        positions[i] = (cam.local_to_world() @ local)[:3]

    k = num_sh_coeffs(sh_degree)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = rng.uniform(0.0, 1.0, (n, 3))

    q = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-6)

    opac = rng.uniform(inverse_sigmoid(0.1), inverse_sigmoid(0.25),
                       n).astype(np.float32)
    default_scale = math.log(scene_scale / n ** (1.0 / 3.0))
    log_scales = np.full((n, 3), default_scale, np.float32)
    return from_raw(positions, log_scales, q, sh, opac, capacity=capacity,
                    device=device)


def compute_knn_scales(means: np.ndarray) -> np.ndarray:
    """Per-point log-scale from the two nearest neighbors:
    ln(clamp((d1+d2)/4, 1e-3, 0.1*median_size)) (splat_init.rs:180-216)."""
    means = np.asarray(means, np.float32).reshape(-1, 3)
    n = means.shape[0]
    if n < 3:
        return np.zeros((n, 3), np.float32)
    median_size = max(bounds_from_pos(0.75, means).median_size(), 0.01)
    tree = cKDTree(means)
    d, _ = tree.query(means, k=3)  # self + 2 NN
    dist = (d[:, 1] + d[:, 2]) / 4.0
    ls = np.log(np.clip(dist, 1e-3, median_size * 0.1)).astype(np.float32)
    return np.repeat(ls[:, None], 3, axis=1)


def to_init_splats(
    means: np.ndarray,
    log_scales: np.ndarray | None = None,
    rotations: np.ndarray | None = None,
    sh_coeffs: np.ndarray | None = None,
    raw_opacities: np.ndarray | None = None,
    capacity: int | None = None,
    device="cuda",
) -> Splats:
    """Point cloud -> splats with defaults for missing fields
    (splat_init.rs to_init_splats:218-243)."""
    means = np.asarray(means, np.float32).reshape(-1, 3)
    n = means.shape[0]
    if log_scales is None:
        log_scales = compute_knn_scales(means)
    if rotations is None:
        rotations = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    if raw_opacities is None:
        raw_opacities = np.full((n,), inverse_sigmoid(0.5), np.float32)
    if sh_coeffs is None:
        sh_coeffs = np.full((n, 1, 3), 0.5, np.float32)
    sh_coeffs = np.asarray(sh_coeffs, np.float32)
    if sh_coeffs.ndim == 2:
        sh_coeffs = sh_coeffs.reshape(n, -1, 3)
    return from_raw(means, np.asarray(log_scales, np.float32),
                    np.asarray(rotations, np.float32), sh_coeffs,
                    np.asarray(raw_opacities, np.float32), capacity=capacity,
                    device=device)
