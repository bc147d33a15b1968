"""COLMAP reconstruction reader: cameras/images/points3D in .bin and .txt
(port of `brush_tpu/data/colmap.py`). `read_images_bin` and
`read_points3d_bin` use the port's C++ parser (native/colmapio.cpp) once
it is built (`python -m brush_tpu_torch.native.build`), as the JAX package
uses its own, and the Python readers otherwise; the two give the same
records.

Pure-Python/numpy counterpart of crates/colmap-reader (binary/text parsers,
lib.rs:602-833) + the dataset-side mapping of all 11 COLMAP camera models
onto the four internal lens models (brush-dataset/src/formats/colmap.rs:
304-383). Format layouts follow COLMAP's own `src/colmap/sensor/models.h` /
`src/colmap/scene/reconstruction_io.cc` (public format)."""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import BinaryIO

import numpy as np

from brush_tpu_torch.camera import (
    Camera,
    CameraModel,
    KannalaBrandt4,
    Pinhole,
    RadialTangential8,
    ThinPrismFisheye,
    focal_to_fov,
)

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # f64


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # wxyz, world-to-camera rotation
    tvec: np.ndarray
    camera_id: int
    name: str


@dataclasses.dataclass
class ColmapPoints:
    xyz: np.ndarray    # [N,3] f64
    rgb: np.ndarray    # [N,3] u8


def _read(fmt: str, f: BinaryIO):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(f: BinaryIO) -> dict[int, ColmapCamera]:
    (num,) = _read("<Q", f)
    out = {}
    for _ in range(num):
        cam_id, model_id, w, h = _read("<iiQQ", f)
        name, n_params = CAMERA_MODELS[model_id]
        params = np.array(_read(f"<{n_params}d", f))
        out[cam_id] = ColmapCamera(cam_id, name, w, h, params)
    return out


def _native():
    """The C++ parser (native/colmapio.cpp) when built; else None."""
    from brush_tpu_torch.native import build
    return build.load_colmapio()


def read_images_bin(f: BinaryIO) -> dict[int, ColmapImage]:
    nat = _native()
    if nat is not None:
        out = {}
        for img_id, q, t, cam_id, name in nat.parse_images(f.read()):
            out[img_id] = ColmapImage(img_id, np.array(q), np.array(t),
                                      cam_id, name)
        return out
    return _read_images_bin_py(f)


def _read_images_bin_py(f: BinaryIO) -> dict[int, ColmapImage]:
    (num,) = _read("<Q", f)
    out = {}
    for _ in range(num):
        img_id = _read("<i", f)[0]
        qvec = np.array(_read("<4d", f))
        tvec = np.array(_read("<3d", f))
        cam_id = _read("<i", f)[0]
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00" or not c:
                break
            name += c
        (n_pts,) = _read("<Q", f)
        f.seek(n_pts * 24, 1)  # skip (x f64, y f64, point3d_id i64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode("utf-8"))
    return out


def read_points3d_bin(f: BinaryIO) -> ColmapPoints:
    nat = _native()
    if nat is not None:
        n, xyz_b, rgb_b = nat.parse_points3d(f.read())
        xyz = np.frombuffer(xyz_b, np.float64).reshape(n, 3)
        rgb = np.frombuffer(rgb_b, np.uint8).reshape(n, 3)
        return ColmapPoints(xyz=xyz.copy(), rgb=rgb.copy())
    return _read_points3d_bin_py(f)


def _read_points3d_bin_py(f: BinaryIO) -> ColmapPoints:
    (num,) = _read("<Q", f)
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    for i in range(num):
        _read("<Q", f)  # point id
        xyz[i] = _read("<3d", f)
        rgb[i] = _read("<3B", f)
        _read("<d", f)  # error
        (track_len,) = _read("<Q", f)
        f.seek(track_len * 8, 1)
    return ColmapPoints(xyz=xyz, rgb=rgb)


def _txt_lines(f: BinaryIO):
    for raw in f.read().decode("utf-8").splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            yield line


def read_cameras_txt(f: BinaryIO) -> dict[int, ColmapCamera]:
    out = {}
    for line in _txt_lines(f):
        parts = line.split()
        cam_id = int(parts[0])
        model = parts[1]
        w, h = int(parts[2]), int(parts[3])
        params = np.array([float(x) for x in parts[4:]])
        out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_txt(f: BinaryIO) -> dict[int, ColmapImage]:
    out = {}
    lines = list(_txt_lines(f))
    for i in range(0, len(lines), 2):  # every image has a second 2D-points line
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name)
    return out


def read_points3d_txt(f: BinaryIO) -> ColmapPoints:
    xyz, rgb = [], []
    for line in _txt_lines(f):
        parts = line.split()
        xyz.append([float(x) for x in parts[1:4]])
        rgb.append([int(x) for x in parts[4:7]])
    return ColmapPoints(xyz=np.array(xyz, np.float64).reshape(-1, 3),
                        rgb=np.array(rgb, np.uint8).reshape(-1, 3))


def build_camera_model(cam: ColmapCamera) -> CameraModel:
    """All 11 COLMAP models -> the 4 internal lens models
    (colmap.rs:304-383)."""
    p = cam.params
    m = cam.model
    if m in ("SIMPLE_PINHOLE", "PINHOLE"):
        return Pinhole()
    if m == "SIMPLE_RADIAL":
        return RadialTangential8(k1=float(p[3]))
    if m == "RADIAL":
        return RadialTangential8(k1=float(p[3]), k2=float(p[4]))
    if m == "OPENCV":
        return RadialTangential8(k1=float(p[4]), k2=float(p[5]),
                                 p1=float(p[6]), p2=float(p[7]))
    if m == "FULL_OPENCV":
        return RadialTangential8(k1=float(p[4]), k2=float(p[5]),
                                 k3=float(p[8]), k4=float(p[9]),
                                 k5=float(p[10]), k6=float(p[11]),
                                 p1=float(p[6]), p2=float(p[7]))
    if m == "SIMPLE_RADIAL_FISHEYE":
        return KannalaBrandt4(k1=float(p[3]))
    if m == "RADIAL_FISHEYE":
        return KannalaBrandt4(k1=float(p[3]), k2=float(p[4]))
    if m == "OPENCV_FISHEYE":
        return KannalaBrandt4(k1=float(p[4]), k2=float(p[5]),
                              k3=float(p[6]), k4=float(p[7]))
    if m == "THIN_PRISM_FISHEYE":
        return ThinPrismFisheye(k1=float(p[4]), k2=float(p[5]),
                                k3=float(p[8]), k4=float(p[9]),
                                p1=float(p[6]), p2=float(p[7]),
                                sx1=float(p[10]), sy1=float(p[11]))
    # FOV's tan(w r)/w distortion fits neither polynomial; fall back.
    return Pinhole()


def intrinsics(cam: ColmapCamera):
    """(fx, fy, cx, cy) regardless of model parameterization."""
    p = cam.params
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    return float(p[0]), float(p[1]), float(p[2]), float(p[3])


def _qvec_to_rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def to_camera(img: ColmapImage, cam: ColmapCamera) -> Camera:
    """COLMAP world-to-camera pose -> camera-to-world Camera
    (colmap.rs w2c->c2w conversion)."""
    model = build_camera_model(cam)
    fx, fy, cx, cy = intrinsics(cam)
    r_w2c = _qvec_to_rotmat(img.qvec / np.linalg.norm(img.qvec))
    r_c2w = r_w2c.T
    position = -r_c2w @ img.tvec
    # Rotation matrix -> wxyz quaternion.
    q = _rotmat_to_quat(r_c2w)
    fov_x = focal_to_fov(fx, cam.width, model)
    fov_y = focal_to_fov(fy, cam.height, model)
    return Camera(
        position=position,
        rotation=q,
        fov_x=fov_x,
        fov_y=fov_y,
        center_uv=np.array([cx / cam.width, cy / cam.height]),
        model=model,
    )


def _rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q
