"""Splat rows and views on which the projection's backward (and forward)
are held: the CPU tests hold `project_backward_plain` to autograd of
`project_splats` on them, the card tests the kernels to both. Imports no
JAX, so the card's tests can use it.

`case(name, degree)` gives (params, camera, img_size), params the five
float32 numpy arrays (means, log_scales, quats, sh [N, 16, 3], raw
opacities):

  * gsplat:          the gsplat fixtures' splats (tests/data/basic_case and
                     tiny_case) and their camera;
  * bench_half_dead: the benchmark generator's scene in a capacity twice
                     its size (the second half dead rows), with random
                     higher SH bands, seen from the bench's radius;
  * edges:           splats behind and inside the near plane, splats past
                     the Jacobian's clamp limits that still reach the
                     image, and colour channels past and exactly at
                     +-COLOR_CLAMP;
  * fisheye:         the bench case through the fisheye cell's KB4 lens
                     (`fisheye_camera`) at an eighth of its 1752x1168,
                     with rows on the axis (r < 1e-6), rows towards the
                     image's corners 82.7 degrees off the axis, and rows
                     past the render field (culled).

`poisoned(field, value, name)` is the bench case (or the fisheye case)
with rows of one input array set to NaN or +-inf (a whole row, and
single entries).
"""

import json
import math
import pathlib

import numpy as np

from brush_tpu_torch.camera import (
    Camera,
    KannalaBrandt4,
    _kb4_invert_d,
    focal_to_fov,
)
from brush_tpu_torch.constants import COLOR_CLAMP, SH_C0
from brush_tpu_torch.models.splats import DEAD_RAW_OPACITY

CASES = ("gsplat", "bench_half_dead", "edges", "fisheye")
# The fisheye cell's lens, as its configuration gives it: OPENCV_FISHEYE
# coefficients, one focal for both axes, centred.
FISHEYE_LENS = json.loads((
    pathlib.Path(__file__).resolve().parent.parent / "portbench" / "configs"
    / "scannetpp-fisheye-1m-sh3.json").read_text())["camera"]
KB4 = tuple(FISHEYE_LENS["k"])
FISHEYE_FOCAL = FISHEYE_LENS["fx"]
FISHEYE_IMG = (FISHEYE_LENS["width"], FISHEYE_LENS["height"])
FIELDS = ("means", "log_scales", "quats", "sh", "raw_opacities")
POISONS = [(f, v) for f in FIELDS for v in ("nan", "inf", "-inf")]
DATA = pathlib.Path(__file__).parent / "data"
K = 16  # coefficients a row holds (degree 3); a lower degree uses fewer


def _gsplat():
    from safetensors.numpy import load_file
    rows = [load_file(DATA / f"{name}.safetensors")
            for name in ("basic_case", "tiny_case")]
    params = [np.concatenate([d[k] for d in rows]).astype(np.float32)
              for k in ("means", "scales", "quats", "coeffs", "opacities")]
    h, w = rows[0]["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = Camera(position=np.array([0.123, 0.456, -8.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                 fov_x=np.pi / 2.0,
                 fov_y=2.0 * np.arctan((h / 2.0) / focal))
    return params, cam, (w, h)


def bench_rows(count, capacity, seed):
    """The benchmark generator's scene (utils/synthetic.py `bench_splats`)
    in `capacity` rows, the rows past `count` dead, as numpy arrays, with
    random higher SH bands on the live rows."""
    from brush_tpu_torch.utils.synthetic import bench_splats
    s = bench_splats(count, sh_degree=3, seed=seed, capacity=capacity,
                     device="cpu")
    params = [t.numpy().copy() for t in (s.means, s.log_scales, s.quats,
                                         s.sh_coeffs, s.raw_opacities)]
    rng = np.random.default_rng(seed + 1)
    params[3][:count, 1:] = rng.normal(0.0, 0.2, (count, K - 1, 3))
    assert (params[4][count:] == DEAD_RAW_OPACITY).all()
    return params


def bench_camera():
    return Camera(position=np.array([0.0, 0.0, -18.0]),
                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                  fov_x=1.0, fov_y=0.6)


def fisheye_camera(scale=1.0, position=(0.0, 0.0, -8.0), k=KB4):
    """The fisheye cell's KB4 camera, its image and focal scaled by
    `scale`, looking along +z from `position`: (Camera, img_size)."""
    w, h = (round(v * scale) for v in FISHEYE_IMG)
    f = FISHEYE_FOCAL * scale
    model = KannalaBrandt4(*k)
    return Camera(position=np.asarray(position, dtype=np.float64),
                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                  fov_x=focal_to_fov(f, w, model),
                  fov_y=focal_to_fov(f, h, model), model=model), (w, h)


def _fisheye(seed):
    """The bench rows (400 live in 800) seen through `fisheye_camera` at
    an eighth of the cell's size from 8 units; live rows 372-399 replaced:
    372-377 on the axis (camera-space r of 0 to 5e-7), 378-393 towards the
    four image corners (theta 0.97 and 0.995 of the corners' 82.7 degrees;
    1.005 of it, past the image's corner but inside the render field of
    83.4 degrees; 1.012, just past the field: culled), 394-399 past the
    render field (theta 1.6, 2.2 and pi: culled)."""
    params = bench_rows(400, 800, seed)
    cam, img = fisheye_camera(1.0 / 8.0)
    f = FISHEYE_FOCAL / 8.0
    model = cam.model
    pts = [(0.0, 0.0, 3.0), (0.0, 0.0, 6.5), (2e-7, -3e-7, 2.5),
           (-5e-7, 1e-7, 4.0), (3e-7, 3e-7, 1.5), (0.0, -4e-7, 9.0)]
    corner = _kb4_invert_d(math.hypot(img[0] / 2, img[1] / 2) / f,
                           *KB4)
    rng = np.random.default_rng(seed + 3)
    for sx, sy in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
        phi = math.atan2(sy * img[1], sx * img[0])
        for share in (0.97, 0.995, 1.005, 1.012):
            th, rho = share * corner, rng.uniform(2.0, 5.0)
            pts.append((rho * math.sin(th) * math.cos(phi),
                        rho * math.sin(th) * math.sin(phi),
                        rho * math.cos(th)))
    for th in (1.6, 2.2, math.pi):
        for phi in (0.3, 2.0):
            pts.append((3.0 * math.sin(th) * math.cos(phi),
                        3.0 * math.sin(th) * math.sin(phi),
                        3.0 * math.cos(th)))
    rows = slice(400 - len(pts), 400)
    params[0][rows] = np.asarray(pts, np.float32) + cam.position.astype(
        np.float32)
    params[1][rows] = np.log(rng.uniform(0.02, 0.1, (len(pts), 3)))
    params[4][rows] = rng.uniform(1.0, 3.0, len(pts))
    return params, cam, img


def _edges(rng):
    n = 96
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32)
    log_scales = np.log(rng.uniform(0.05, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    sh = rng.normal(0, 0.3, (n, K, 3)).astype(np.float32)
    raw = rng.uniform(0.5, 3.0, n).astype(np.float32)
    # Rows 0-7 behind the camera or inside the near plane.
    means[0:8, 2] = [-3.0, -0.5, 0.0, 0.005, 0.0099, -1e-3, 1e-4, -7.0]
    # Rows 8-39 past the Jacobian's clamp limits (|x/z| up to 3 against
    # about 0.6), large enough to reach the image.
    means[8:40, 0] = rng.choice([-1.0, 1.0], 32) * rng.uniform(1.0, 3.0, 32)
    means[8:40, 2] = rng.uniform(1.0, 2.0, 32)
    means[8:40, 0] *= means[8:40, 2]
    log_scales[8:40] = np.log(rng.uniform(0.8, 2.0, (32, 3)))
    # Rows 40-47: colour channels past the clamp; rows 48-51 exactly at
    # +-COLOR_CLAMP (higher bands zero, so the sum is SH_C0 * c + 0.5).
    sh[40:48, 0] = rng.choice([-1.0, 1.0], (8, 3)) * 500.0
    for r, target in zip(range(48, 52), (COLOR_CLAMP, -COLOR_CLAMP) * 2):
        sh[r, 1:] = 0.0
        sh[r, 0, :] = _dc_at(target)
    means[40:52] = [0.0, 0.0, 4.0] + rng.uniform(-0.3, 0.3, (12, 3))
    cam = Camera(position=np.zeros(3), rotation=np.array([1.0, 0, 0, 0]),
                 fov_x=1.2, fov_y=0.9)
    return [means, log_scales, quats, sh, raw], cam, (120, 90)


def _dc_at(target):
    """A float32 DC coefficient c with fl(fl(SH_C0 * c) + 0.5) == target."""
    b0 = np.float32(SH_C0)
    c = np.float32((target - 0.5) / SH_C0)
    for _ in range(64):
        got = np.float32(np.float32(b0 * c) + np.float32(0.5))
        if got == target:
            return c
        c = np.nextafter(c, np.float32(np.inf if got < target else -np.inf),
                         dtype=np.float32)
    raise AssertionError(f"no DC coefficient gives {target}")


def case(name, degree=3, seed=0):
    """(params, camera, img_size) of case `name`."""
    del degree  # every case holds K = 16 coefficients a row
    if name == "gsplat":
        return _gsplat()
    if name == "bench_half_dead":
        return bench_rows(400, 800, seed), bench_camera(), (192, 108)
    if name == "edges":
        return _edges(np.random.default_rng(seed + 5))
    if name == "fisheye":
        return _fisheye(seed)
    raise KeyError(name)


def poisoned(field, value, seed=0, name="bench_half_dead"):
    """Case `name` (the bench case, or the fisheye case) with rows of
    `field` poisoned by `value` ('nan', 'inf' or '-inf'): rows 0-5 whole,
    rows 6-23 one entry each."""
    params, cam, img = case(name, seed=seed)
    arr = params[FIELDS.index(field)]
    v = np.float32(float(value))
    flat = arr.reshape(arr.shape[0], -1)
    flat[0:6] = v
    rng = np.random.default_rng(seed + 9)
    for r in range(6, 24):
        flat[r, rng.integers(0, flat.shape[1])] = v
    return params, cam, img
