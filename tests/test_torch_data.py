"""The dataset readers of `brush_tpu_torch` (data/*) against the JAX
package's, on the fixtures of tests/test_dataset_formats.py and a text
COLMAP export written here.

  * `load_dataset`: COLMAP bin and txt, a zip, two reconstructions,
    Nerfstudio (with masks), RealityCapture: the views' order, names, mask
    paths and cameras (every field), the train/eval split and the init
    points, colours and ply are equal.
  * `load_image` (with a mask, and resized), `pack_rgba` in every alpha
    mode and `image_dims`: bit-equal.
  * `SceneLoader`: the same view order over two epochs for the same seed
    (one worker thread, whose order is the feeder's).
"""

import dataclasses
import json
import shutil
import struct
import zipfile

import numpy as np
import pytest
from PIL import Image

from brush_tpu.data import dataloader as jloader
from brush_tpu.data import formats as jformats
from brush_tpu.data import scene as jscene
from brush_tpu.data.vfs import Vfs as JVfs
from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch.data import dataloader as tloader
from brush_tpu_torch.data import formats as tformats
from brush_tpu_torch.data import scene as tscene
from brush_tpu_torch.data.vfs import Vfs as TVfs


def _same_camera(t, j, where):
    for name in ("position", "rotation", "center_uv"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=f"{where}.{name}")
    assert (t.fov_x, t.fov_y) == (j.fov_x, j.fov_y), where
    assert type(t.model).__name__ == type(j.model).__name__, where
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model), where


def _same_scene(t, j, where):
    assert (t is None) == (j is None), where
    if t is None:
        return
    assert (t.max_resolution, t.subscale) == (j.max_resolution, j.subscale)
    assert [v.image_path for v in t.views] == [v.image_path for v in j.views]
    assert [v.mask_path for v in t.views] == [v.mask_path for v in j.views]
    for i, (tv, jv) in enumerate(zip(t.views, j.views)):
        _same_camera(tv.camera, jv.camera, f"{where}[{i}] {jv.image_path}")


def _load_both(source, **cfg):
    ds_t = tformats.load_dataset(str(source), tformats.LoadConfig(**cfg))
    ds_j = jformats.load_dataset(str(source), jformats.LoadConfig(**cfg))
    _same_scene(ds_t.train, ds_j.train, "train")
    _same_scene(ds_t.eval, ds_j.eval, "eval")
    for name in ("init_points", "init_colors"):
        a, b = getattr(ds_t, name), getattr(ds_j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ds_t.init_ply == ds_j.init_ply
    return ds_t, ds_j


def _write_colmap_txt(root, n_views=3, w=40, h=30):
    """A text COLMAP export with an OPENCV camera and rotated poses."""
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    (sparse / "cameras.txt").write_text(
        "# Camera list\n"
        f"1 OPENCV {w} {h} 35.0 36.0 {w / 2 + 0.5} {h / 2 - 0.25} "
        "0.01 -0.002 0.001 0.0005\n")
    lines = ["# Image list"]
    rng = np.random.default_rng(4)
    for i in range(n_views):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        lines.append(f"{i + 1} {' '.join(map(repr, q.tolist()))} "
                     f"{' '.join(map(repr, t.tolist()))} 1 view_{i}.png")
        lines.append("1.0 2.0 -1")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(root / "images" / f"view_{i}.png")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    pts = ["# 3D point list"]
    for i in range(7):
        pts.append(f"{i} {0.1 * i} {-0.2 * i} {1.5 + i} {20 * i} 40 60 0.5 "
                   "1 0")
    (sparse / "points3D.txt").write_text("\n".join(pts) + "\n")


def _write_nerfstudio(root):
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    rng = np.random.default_rng(1)
    frames = []
    for i in range(3):
        name = f"images/frame_{i}.png"
        Image.fromarray(rng.integers(0, 255, (40, 60, 4), dtype=np.uint8)
                        ).save(root / name)
        Image.fromarray(rng.integers(0, 255, (40, 60), dtype=np.uint8)
                        ).save(root / "masks" / f"frame_{i}.png")
        m = np.eye(4)
        m[:3, 3] = [0.5 * i, -0.25, 1.0]
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    meta = {"camera_model": "OPENCV", "fl_x": 50.0, "fl_y": 51.0,
            "cx": 30.0, "cy": 20.0, "w": 60, "h": 40, "k1": 0.01,
            "k2": -0.002, "p1": 0.0, "p2": 0.0, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))


def _write_realitycapture(root):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
                        ).save(root / f"shot{i}.jpg")
    csv = "#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
    for i in range(2):
        csv += (f"shot{i}.jpg,{i},0.5,5,{10 * i},-3,2,30,0.1,-0.1,0.01,0,0,"
                "0,0,0\n")
    (root / "cams.csv").write_text(csv)


def _zip(src, dst):
    with zipfile.ZipFile(dst, "w") as z:
        for p in src.rglob("*"):
            if p.is_file():
                z.write(p, p.relative_to(src))
    return dst


def _two_reconstructions(root):
    write_colmap_bin(root / "scene", n_views=2, w=32, h=32)
    big = root / "big"
    write_colmap_bin(big, n_views=4, w=32, h=32)
    shutil.copytree(big / "sparse" / "0", root / "scene" / "sparse" / "1")
    for f in (big / "images").iterdir():
        shutil.copy(f, root / "scene" / "images" / f.name)
    return root / "scene"


def _colmap_bin(root):
    write_colmap_bin(root / "scene")
    return root / "scene"


def _colmap_txt(root):
    _write_colmap_txt(root / "scene")
    return root / "scene"


def _colmap_zip(root):
    write_colmap_bin(root / "scene")
    return _zip(root / "scene", root / "scene.zip")


def _nerfstudio(root):
    _write_nerfstudio(root / "ns")
    return root / "ns"


def _realitycapture(root):
    _write_realitycapture(root / "rc")
    return root / "rc"


FIXTURES = {
    "colmap_bin": (_colmap_bin, dict(eval_split_every=4)),
    "colmap_txt": (_colmap_txt, dict(eval_split_every=2,
                                     subsample_points=2)),
    "colmap_zip": (_colmap_zip, dict(max_frames=3)),
    "colmap_two_reconstructions": (_two_reconstructions, {}),
    "nerfstudio_masks": (_nerfstudio, dict(eval_split_every=3)),
    "realitycapture": (_realitycapture, {}),
}


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_load_dataset_matches_jax(tmp_path, fixture):
    make, cfg = FIXTURES[fixture]
    ds_t, _ = _load_both(make(tmp_path), **cfg)
    assert ds_t.train.views
    if fixture == "nerfstudio_masks":
        assert all(v.mask_path for v in ds_t.train.views)
    if fixture == "colmap_two_reconstructions":
        assert len(ds_t.train.views) == 4


def test_mask_discovery_matches_jax(tmp_path):
    (tmp_path / "images" / "sub").mkdir(parents=True)
    (tmp_path / "masks" / "sub").mkdir(parents=True)
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    img.save(tmp_path / "images" / "sub" / "a.jpg")
    img.convert("L").save(tmp_path / "masks" / "sub" / "a.png")
    img.convert("L").save(tmp_path / "masks" / "c.mask.png")
    for path in ("images/sub/a.jpg", "images/sub/b.jpg", "images/c.jpg"):
        assert (tformats.find_mask_path(TVfs(tmp_path), path)
                == jformats.find_mask_path(JVfs(tmp_path), path))
    assert tformats.find_mask_path(TVfs(tmp_path),
                                   "images/sub/a.jpg") == "masks/sub/a.png"


def test_images_decode_and_pack_bit_equal(tmp_path):
    _write_nerfstudio(tmp_path)
    vfs_t, vfs_j = TVfs(tmp_path), JVfs(tmp_path)
    path, mask = "images/frame_1.png", "masks/frame_1.png"
    for kwargs in (dict(max_resolution=64), dict(max_resolution=45),
                   dict(max_resolution=64, mask_path=mask),
                   dict(max_resolution=64, subscale=2)):
        a_t, alpha_t = tscene.load_image(vfs_t, path, **kwargs)
        a_j, alpha_j = jscene.load_image(vfs_j, path, **kwargs)
        assert alpha_t == alpha_j and a_t.dtype == a_j.dtype
        np.testing.assert_array_equal(a_t, a_j)
        for mode in tscene.AlphaMode:
            p_t = tscene.pack_rgba(a_t, mode)
            p_j = jscene.pack_rgba(a_j, jscene.AlphaMode(mode.value))
            assert p_t.dtype == p_j.dtype == np.uint32
            np.testing.assert_array_equal(p_t, p_j)
        rgb = a_t[..., :3]
        np.testing.assert_array_equal(
            tscene.pack_rgba(rgb, tscene.AlphaMode.NONE),
            jscene.pack_rgba(rgb, jscene.AlphaMode.NONE))
    for res, sub in ((64, 1), (45, 1), (64, 2), (30, 3)):
        assert (tscene.image_dims(vfs_t, path, res, subscale=sub)
                == jscene.image_dims(vfs_j, path, res, subscale=sub))
    views = list(range(7))
    for every in (None, 0, 1, 3):
        assert (tscene.split_eval_every(views, every)
                == jscene.split_eval_every(views, every))


def test_scene_loader_order_matches_jax(tmp_path):
    write_colmap_bin(tmp_path, n_views=5, w=16, h=16)
    ds_t = tformats.load_dataset(str(tmp_path))
    ds_j = jformats.load_dataset(str(tmp_path))
    n = 2 * len(ds_t.train.views)          # two epochs
    lt = tloader.SceneLoader(ds_t.train, seed=9, n_threads=1, prefetch=2)
    lj = jloader.SceneLoader(ds_j.train, seed=9, n_threads=1, prefetch=2)
    try:
        got = [next(lt) for _ in range(n)]
        want = [next(lj) for _ in range(n)]
    finally:
        lt.stop()
        lj.stop()
    order = [v.view_index for v in got]
    assert order == [v.view_index for v in want]
    assert sorted(order[:5]) == sorted(order[5:]) == list(range(5))
    for a, b in zip(got, want):
        assert a.img_size == b.img_size == (16, 16)
        assert a.gt_packed.dtype == np.uint32
        np.testing.assert_array_equal(a.gt_packed, b.gt_packed)


def test_colmap_binary_readers_match_jax(tmp_path):
    """Raw reader output, byte streams of every camera model id."""
    from brush_tpu.data import colmap as jcolmap
    from brush_tpu_torch.data import colmap as tcolmap
    import io
    buf = io.BytesIO()
    models = sorted(tcolmap.CAMERA_MODELS)
    buf.write(struct.pack("<Q", len(models)))
    for mid in models:
        n_params = tcolmap.CAMERA_MODELS[mid][1]
        buf.write(struct.pack("<iiQQ", mid + 1, mid, 64, 48))
        buf.write(struct.pack(f"<{n_params}d",
                              *(40.0 + 0.01 * k for k in range(n_params))))
    cams_t = tcolmap.read_cameras_bin(io.BytesIO(buf.getvalue()))
    cams_j = jcolmap.read_cameras_bin(io.BytesIO(buf.getvalue()))
    img = jcolmap.ColmapImage(1, np.array([0.9, 0.1, -0.3, 0.2]),
                              np.array([0.5, -1.0, 2.0]), 1, "x.png")
    for cid, c in cams_t.items():
        j = cams_j[cid]
        assert (c.model, c.width, c.height) == (j.model, j.width, j.height)
        np.testing.assert_array_equal(c.params, j.params)
        _same_camera(tcolmap.to_camera(img, c), jcolmap.to_camera(img, j),
                     c.model)
