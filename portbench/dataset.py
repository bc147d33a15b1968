"""A COLMAP dataset on disk for a training run: one PINHOLE camera,
images/view_XX.png and sparse/0/{cameras,images,points3D}.bin (no points;
an init.ply beside them seeds the splats)."""

from __future__ import annotations

import os
import struct

import numpy as np


def _c2w_to_w2c_quat(rot_w2c: np.ndarray) -> np.ndarray:
    """wxyz of a rotation matrix (Shepperd's method)."""
    m = rot_w2c
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def write_colmap(root: str, views, pngs) -> None:
    """`views` (reference.camera.View, one focal, image-centred) and their
    [H, W, 3] uint8 images."""
    from PIL import Image
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    v0 = views[0]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, v0.width, v0.height))  # PINHOLE
        f.write(struct.pack("<4d", v0.fx, v0.fy, v0.cx, v0.cy))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *_c2w_to_w2c_quat(v.rot)))
            f.write(struct.pack("<3d", *v.trans))
            f.write(struct.pack("<i", 1))
            f.write(f"view_{i:02d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))
    for i, rgb in enumerate(pngs):
        Image.fromarray(rgb).save(
            os.path.join(root, "images", f"view_{i:02d}.png"),
            compress_level=1)


def write_ply(path: str, arrays: dict) -> None:
    """The Inria 3DGS binary PLY of host arrays: x, y, z, f_dc_0..2,
    f_rest_* (channel-major; left out where every higher band is zero, as
    a degree-0 export), opacity, scale_0..2, rot_0..3."""
    means = np.asarray(arrays["means"], np.float32)
    sh = np.asarray(arrays["sh_coeffs"], np.float32)
    n = means.shape[0]
    rest = sh[:, 1:, :]
    n_rest = rest.shape[1] if np.any(rest) else 0
    props = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
    props += [f"f_rest_{i}" for i in range(3 * n_rest)]
    props += ["opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]
    cols = [means, sh[:, 0, :]]
    if n_rest:
        cols.append(rest.transpose(0, 2, 1).reshape(n, 3 * n_rest))
    cols += [np.asarray(arrays["raw_opacities"], np.float32)[:, None],
             np.asarray(arrays["log_scales"], np.float32),
             np.asarray(arrays["quats"], np.float32)]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in props] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.concatenate(cols, axis=1).astype("<f4").tobytes())
