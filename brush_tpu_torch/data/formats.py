"""Dataset facade: COLMAP -> Nerfstudio -> RealityCapture auto-detection
(port of `brush_tpu/data/formats.py`).

Counterpart of brush-dataset/src/formats/{mod,colmap,nerfstudio,
realitycapture}.rs: tries each format against the VFS, discovers per-image
masks, picks an init point cloud, and splits an eval set."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import PurePosixPath
from typing import Optional

import numpy as np

from brush_tpu_torch.camera import (
    Camera, KannalaBrandt4, Pinhole, RadialTangential8, focal_to_fov,
)
from brush_tpu_torch.data import colmap as colmap_reader
from brush_tpu_torch.data.scene import AlphaMode, Scene, SceneView, image_dims, split_eval_every
from brush_tpu_torch.data.vfs import Vfs


@dataclasses.dataclass
class LoadConfig:
    """brush-dataset/src/config.rs LoadDatasetConfig."""

    max_resolution: int = 1920
    max_frames: int | None = None
    eval_split_every: int | None = None
    subsample_frames: int | None = None
    subsample_points: int | None = None
    alpha_mode: AlphaMode = AlphaMode.TRANSPARENT


@dataclasses.dataclass
class Dataset:
    train: Scene
    eval: Scene | None
    init_points: np.ndarray | None = None   # [N,3]
    init_colors: np.ndarray | None = None   # [N,3] in [0,1]
    init_ply: str | None = None             # path of an init .ply if present


def find_mask_path(vfs: Vfs, image_path: str) -> Optional[str]:
    """Mask discovery (formats/mod.rs:150-190): any file under a `masks/`
    directory whose stem matches `img.ext`, `img`, or `img.mask`,
    case-insensitively, with matching nested subdirectories."""
    p = PurePosixPath(image_path)
    name = p.name.lower()
    stem = p.stem.lower()
    mask_stem = stem + ".mask"
    img_dirs = [c.lower() for c in p.parent.parts]

    for cand in vfs.file_names:
        c = PurePosixPath(cand)
        cstem = c.stem.lower()
        if cstem not in (name, stem, mask_stem):
            continue
        parts = [x.lower() for x in c.parts]
        if "masks" not in parts:
            continue
        idx = parts.index("masks")
        sub = parts[idx + 1:-1]
        if not sub or img_dirs[-len(sub):] == sub:
            return cand
    return None


def _apply_frame_limits(views, cfg: LoadConfig):
    if cfg.subsample_frames:
        views = views[:: cfg.subsample_frames]
    if cfg.max_frames:
        views = views[: cfg.max_frames]
    return views


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------


def _colmap_reconstruction_prefixes(vfs: Vfs):
    """Candidate reconstruction dirs, numbered ones first (sparse/0,
    sparse/1, ...). Multiple reconstructions are resolved by registered
    image count in load_colmap (colmap.rs:34-88)."""
    import re
    numbered = sorted({
        m.group(1)
        for n in vfs.names()
        for m in [re.match(r"(?i)((?:.*/)?sparse/\d+/)", n)]
        if m
    })
    return numbered + ["sparse/", "colmap/sparse/0/", ""]


def _colmap_find(vfs: Vfs, base: str, prefixes=None):
    for prefix in (prefixes if prefixes is not None
                   else _colmap_reconstruction_prefixes(vfs)):
        for ext, mode in ((".bin", "bin"), (".txt", "txt")):
            path = prefix + base + ext
            if vfs.exists(path):
                return path, mode
    return None, None


def load_colmap(vfs: Vfs, cfg: LoadConfig) -> Optional[Dataset]:
    # Multiple reconstructions: pick the one registering the most images
    # (colmap.rs:34-88).
    prefixes = _colmap_reconstruction_prefixes(vfs)
    numbered = [p for p in prefixes if p not in ("sparse/", "colmap/sparse/0/", "")]
    if len(numbered) > 1:
        best, best_count = None, -1
        for p in numbered:
            ip, m = _colmap_find(vfs, "images", prefixes=[p])
            if ip is None:
                continue
            with vfs.open(ip) as f:
                imgs = (colmap_reader.read_images_bin(f) if m == "bin"
                        else colmap_reader.read_images_txt(f))
            if len(imgs) > best_count:
                best, best_count = p, len(imgs)
        if best is not None:
            prefixes = [best]

    cam_path, mode = _colmap_find(vfs, "cameras", prefixes=prefixes)
    img_path, _ = _colmap_find(vfs, "images", prefixes=prefixes)
    if cam_path is None or img_path is None:
        return None

    with vfs.open(cam_path) as f:
        cameras = (colmap_reader.read_cameras_bin(f) if mode == "bin"
                   else colmap_reader.read_cameras_txt(f))
    with vfs.open(img_path) as f:
        images = (colmap_reader.read_images_bin(f) if mode == "bin"
                  else colmap_reader.read_images_txt(f))

    views = []
    for img_id in sorted(images, key=lambda i: images[i].name):
        im = images[img_id]
        cam = cameras.get(im.camera_id)
        if cam is None:
            continue
        # Images live in images/ (or a custom dir); resolve leniently.
        img_file = None
        for prefix in ("images/", "", "images_4/", "images_2/", "images_8/"):
            if vfs.exists(prefix + im.name):
                img_file = vfs.resolve(prefix + im.name)
                break
        if img_file is None:
            continue
        camera = colmap_reader.to_camera(im, cam)
        views.append(SceneView(image_path=img_file, camera=camera,
                               mask_path=find_mask_path(vfs, img_file)))
    if not views:
        return None
    views = _apply_frame_limits(views, cfg)

    pts_path, pmode = _colmap_find(vfs, "points3D", prefixes=prefixes)
    init_points = init_colors = None
    if pts_path is not None:
        with vfs.open(pts_path) as f:
            pts = (colmap_reader.read_points3d_bin(f) if pmode == "bin"
                   else colmap_reader.read_points3d_txt(f))
        init_points = pts.xyz.astype(np.float32)
        init_colors = pts.rgb.astype(np.float32) / 255.0
        if cfg.subsample_points:
            init_points = init_points[:: cfg.subsample_points]
            init_colors = init_colors[:: cfg.subsample_points]

    train_v, eval_v = split_eval_every(views, cfg.eval_split_every)
    return Dataset(
        train=Scene(train_v, vfs, cfg.max_resolution),
        eval=Scene(eval_v, vfs, cfg.max_resolution) if eval_v else None,
        init_points=init_points, init_colors=init_colors,
        init_ply=_find_init_ply(vfs),
    )


# ---------------------------------------------------------------------------
# Nerfstudio transforms.json
# ---------------------------------------------------------------------------

# OpenGL camera (-Z forward, +Y up) -> brush camera (+Z forward, +Y down):
# flip the Y and Z columns of the rotation (nerfstudio.rs:126).
_OPENGL_FLIP = np.diag([1.0, -1.0, -1.0])


def _ns_model(scene: dict, frame: dict):
    def g(key):
        return frame.get(key, scene.get(key))

    name = g("camera_model")
    k1, k2, k3, k4 = (g("k1") or 0.0, g("k2") or 0.0, g("k3") or 0.0, g("k4") or 0.0)
    p1, p2 = g("p1") or 0.0, g("p2") or 0.0
    if name in (None, "PERSPECTIVE", "perspective"):
        if any((k1, k2, p1, p2)):
            return RadialTangential8(k1=k1, k2=k2, p1=p1, p2=p2)
        return Pinhole()
    if name.lower() == "opencv":
        return RadialTangential8(k1=k1, k2=k2, p1=p1, p2=p2)
    if name.lower() == "opencv_fisheye":
        return KannalaBrandt4(k1=k1, k2=k2, k3=k3, k4=k4)
    raise ValueError(f"Unsupported nerfstudio camera_model {name!r}")


def _ns_views(vfs: Vfs, scene: dict, cfg: LoadConfig) -> list[SceneView]:
    views = []
    for frame in scene.get("frames", []):
        fp = frame["file_path"]
        img_file = None
        for cand in (fp, fp + ".png", fp + ".jpg", fp.lstrip("./")):
            if vfs.exists(cand):
                img_file = vfs.resolve(cand)
                break
        if img_file is None:
            continue

        def g(key, default=None):
            return frame.get(key, scene.get(key, default))

        w = g("w") or g("width")
        h = g("h") or g("height")
        if w is None or h is None:
            w, h = image_dims(vfs, img_file, 100000)
        w, h = int(w), int(h)
        model = _ns_model(scene, frame)

        fl_x, fl_y = g("fl_x"), g("fl_y")
        if fl_x is None and g("camera_angle_x") is not None:
            fov_x = float(g("camera_angle_x"))
        elif fl_x is not None:
            fov_x = focal_to_fov(float(fl_x), w, model)
        else:
            raise ValueError("nerfstudio frame missing focal/fov")
        if fl_y is not None:
            fov_y = focal_to_fov(float(fl_y), h, model)
        elif g("camera_angle_y") is not None:
            fov_y = float(g("camera_angle_y"))
        else:
            # Square pixels: same focal both axes.
            focal = (w / 2.0) / math.tan(fov_x / 2.0)
            fov_y = focal_to_fov(focal, h, model)

        cx = float(g("cx") or w / 2.0)
        cy = float(g("cy") or h / 2.0)

        m = np.array(frame["transform_matrix"], np.float64)
        r = m[:3, :3] @ _OPENGL_FLIP
        pos = m[:3, 3]
        q = colmap_reader._rotmat_to_quat(r)
        cam = Camera(position=pos, rotation=q, fov_x=fov_x, fov_y=fov_y,
                     center_uv=np.array([cx / w, cy / h]), model=model)
        mask = frame.get("mask_path")
        mask_file = (vfs.resolve(mask) if mask and vfs.exists(mask)
                     else find_mask_path(vfs, img_file))
        views.append(SceneView(image_path=img_file, camera=cam,
                               mask_path=mask_file))
    return views


def load_nerfstudio(vfs: Vfs, cfg: LoadConfig) -> Optional[Dataset]:
    json_files = list(vfs.files_with_extension("json"))
    if len(json_files) == 1:
        main = json_files[0]
    else:
        main = next(iter(vfs.files_ending_in("transforms.json")), None) or \
            next(iter(vfs.files_ending_in("transforms_train.json")), None)
    if main is None:
        return None

    scene = json.loads(vfs.read_bytes(main))
    if "frames" not in scene:
        return None
    train_views = _apply_frame_limits(_ns_views(vfs, scene, cfg), cfg)
    if not train_views:
        return None

    eval_views = []
    eval_file = (next(iter(vfs.files_ending_in("transforms_val.json")), None)
                 or next(iter(vfs.files_ending_in("transforms_test.json")), None))
    if eval_file:
        eval_views = _ns_views(vfs, json.loads(vfs.read_bytes(eval_file)), cfg)
    train_v, split_eval = split_eval_every(train_views, cfg.eval_split_every)
    eval_views = eval_views or split_eval

    init_points = init_colors = None
    ply_path = scene.get("ply_file_path")

    return Dataset(
        train=Scene(train_v, vfs, cfg.max_resolution),
        eval=Scene(eval_views, vfs, cfg.max_resolution) if eval_views else None,
        init_points=init_points, init_colors=init_colors,
        init_ply=(vfs.resolve(ply_path) if ply_path and vfs.exists(ply_path)
                  else _find_init_ply(vfs)),
    )


# ---------------------------------------------------------------------------
# RealityCapture CSV
# ---------------------------------------------------------------------------

RC_REQUIRED = ["name", "x", "y", "alt", "heading", "pitch", "roll", "f"]


def _rc_rotation(heading, pitch, roll):
    """heading/pitch/roll (degrees) -> c2w rotation, RealityCapture export
    convention (realitycapture.rs)."""
    h, p, r = (math.radians(heading), math.radians(pitch), math.radians(roll))
    ch, sh = math.cos(h), math.sin(h)
    cp, sp = math.cos(p), math.sin(p)
    cr, sr = math.cos(r), math.sin(r)
    rz = np.array([[ch, -sh, 0], [sh, ch, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def load_realitycapture(vfs: Vfs, cfg: LoadConfig) -> Optional[Dataset]:
    for csv_path in vfs.files_with_extension("csv"):
        text = vfs.read_bytes(csv_path).decode("utf-8", errors="replace")
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            continue
        header = {name.strip().lstrip("#").lower(): i
                  for i, name in enumerate(lines[0].split(","))}
        if not all(c in header for c in RC_REQUIRED):
            continue

        views = []
        for line in lines[1:]:
            fields = [f.strip() for f in line.split(",")]

            def col(name, default=0.0):
                i = header.get(name)
                if i is None or i >= len(fields) or not fields[i]:
                    return default
                try:
                    return float(fields[i])
                except ValueError:
                    return default

            name = fields[header["name"]]
            img_file = None
            for cand in (name, "images/" + name):
                if vfs.exists(cand):
                    img_file = vfs.resolve(cand)
                    break
            if img_file is None:
                continue
            w, h = image_dims(vfs, img_file, 100000)
            larger = max(w, h)
            # 35mm-unit intrinsics scale by the larger dimension / 36mm.
            f_px = col("f") * larger / 36.0
            cx = w / 2.0 + col("px") * larger / 36.0
            cy = h / 2.0 + col("py") * larger / 36.0
            k1, k2, k3 = col("k1"), col("k2"), col("k3")
            t1, t2 = col("t1"), col("t2")
            # brown3 approximation: RC's k4 (r^8) has no RT8 slot; dropped.
            if any((k1, k2, k3, t1, t2)):
                model = RadialTangential8(k1=k1, k2=k2, k3=k3, p1=t1, p2=t2)
            else:
                model = Pinhole()
            pos = np.array([col("x"), col("y"), col("alt")])
            r = _rc_rotation(col("heading"), col("pitch"), col("roll"))
            q = colmap_reader._rotmat_to_quat(r)
            cam = Camera(position=pos, rotation=q,
                         fov_x=focal_to_fov(f_px, w, model),
                         fov_y=focal_to_fov(f_px, h, model),
                         center_uv=np.array([cx / w, cy / h]), model=model)
            views.append(SceneView(image_path=img_file, camera=cam,
                                   mask_path=find_mask_path(vfs, img_file)))
        if views:
            views = _apply_frame_limits(views, cfg)
            train_v, eval_v = split_eval_every(views, cfg.eval_split_every)
            return Dataset(
                train=Scene(train_v, vfs, cfg.max_resolution),
                eval=Scene(eval_v, vfs, cfg.max_resolution) if eval_v else None,
                init_ply=_find_init_ply(vfs))
    return None


def _find_init_ply(vfs: Vfs) -> Optional[str]:
    """`init.ply` preferred, else the last .ply (formats/mod.rs:56-72)."""
    plys = sorted(vfs.files_with_extension("ply"))
    for p in plys:
        if PurePosixPath(p).name.lower() == "init.ply":
            return p
    return plys[-1] if plys else None


def load_dataset(source: str, cfg: LoadConfig | None = None) -> Dataset:
    """Try colmap -> nerfstudio -> realitycapture (formats/mod.rs:56)."""
    cfg = cfg or LoadConfig()
    vfs = Vfs(source)
    for loader in (load_colmap, load_nerfstudio, load_realitycapture):
        ds = loader(vfs, cfg)
        if ds is not None:
            if not ds.train.views:
                raise ValueError("dataset has no usable training views")
            return ds
    raise ValueError(f"no supported dataset format found in {source}")
