"""The port's C ABI and its native COLMAP parser, on the CPU.

  * Mirrors of tests/test_ffi.py with `"device": "cpu"`: build
    libbrush_tpu_torch_ffi.so (brush_tpu_torch/native/build.py, into the
    git-ignored build/ directory), load it with ctypes and drive a tiny
    training run through `brush_train_and_save`: the progress callback,
    JSON options routing (the `device` key included), error codes,
    cancellation, and the public header compiling as C99.
  * The native COLMAP parser (native/colmapio.cpp, built as a CPython
    extension) gives exactly what the port's Python readers and the JAX
    package's Python readers give, on the fixtures of
    tests/test_dataset_formats.py and on records with 2D points and
    tracks; `read_images_bin` / `read_points3d_bin` use it once it is
    built; a truncated file raises.
"""

import ctypes
import io
import json
import struct
import subprocess

import numpy as np
import pytest

from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch.data import colmap as tcolmap
from brush_tpu_torch.native import build as native

CB_TYPE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p, ctypes.c_void_p)


@pytest.fixture(scope="module")
def lib():
    path = native.build_ffi(verbose=False)
    assert path.parent.parent == native.BUILD_ROOT
    lib = ctypes.CDLL(str(path))
    lib.brush_train_and_save.restype = ctypes.c_int32
    lib.brush_train_and_save.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, CB_TYPE, ctypes.c_void_p]
    lib.brush_last_error.restype = ctypes.c_char_p
    lib.brush_abi_version.restype = ctypes.c_int32
    return lib


def _options(tmp_path, **kw):
    opts = {"total_train_iters": 4, "log_every": 2, "eval_every": 0,
            "export_every": 0, "export_path": str(tmp_path / "ffi_{iter}.ply"),
            "init_count": 0, "sh_degree": 1, "use_pallas": False,
            "max_resolution": 32, "device": "cpu"}
    opts.update(kw)
    return json.dumps(opts).encode()


def test_abi_version(lib):
    assert lib.brush_abi_version() == 1


def test_train_and_save_roundtrip(lib, tmp_path):
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    messages = []

    @CB_TYPE
    def cb(payload, user_data):
        messages.append(json.loads(payload.decode()))
        return 0

    rc = lib.brush_train_and_save(
        str(tmp_path / "scene").encode(), _options(tmp_path), cb, None)
    assert rc == 0, lib.brush_last_error().decode()

    kinds = {m["kind"] for m in messages}
    assert "step" in kinds and "export" in kinds
    assert (tmp_path / "ffi_4.ply").exists()
    assert [m["iter"] for m in messages if m["kind"] == "step"] == [2, 4]


def test_cancellation(lib, tmp_path):
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    seen = []

    @CB_TYPE
    def cb(payload, user_data):
        seen.append(json.loads(payload.decode()))
        return 1  # cancel immediately

    rc = lib.brush_train_and_save(
        str(tmp_path / "scene").encode(),
        _options(tmp_path, total_train_iters=50, log_every=1), cb, None)
    assert rc == 0
    # Only messages up to the first callback were delivered.
    assert len(seen) == 1 and seen[0]["iter"] == 1
    assert not list(tmp_path.glob("ffi_*.ply"))


def test_error_paths(lib, tmp_path):
    # NULL dataset path.
    fn = lib.brush_train_and_save
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    assert fn(None, None, None, None) == 4  # BRUSH_ERR_BAD_ARG

    # Unknown option key -> training error with a message.
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    rc = fn(str(tmp_path / "scene").encode(),
            json.dumps({"not_a_real_option": 1, "device": "cpu"}).encode(),
            None, None)
    assert rc == 3  # BRUSH_ERR_TRAIN
    assert b"not_a_real_option" in lib.brush_last_error()


def test_header_compiles_as_c(tmp_path):
    """The public header must be valid C99."""
    src = tmp_path / "smoke.c"
    src.write_text(
        '#include "brush_tpu_torch_ffi.h"\n'
        "int main(void) { return BRUSH_OK + BRUSH_TPU_TORCH_ABI_VERSION - 1; }\n")
    subprocess.run(
        ["gcc", "-std=c99", "-Wall", "-Werror",
         f"-I{native.HERE / 'include'}", str(src), "-o",
         str(tmp_path / "smoke")], check=True)
    subprocess.run([str(tmp_path / "smoke")], check=True)


# --------------------------------------------------------------------------
# the native COLMAP parser
# --------------------------------------------------------------------------


def _tracked_records():
    """images.bin and points3D.bin bytes with 2D points and tracks, UTF-8
    names and negative ids, which the fixtures of test_dataset_formats.py
    leave out."""
    rng = np.random.default_rng(4)
    img = io.BytesIO()
    img.write(struct.pack("<Q", 3))
    for i, (name, n2d) in enumerate([("a.png", 0), ("sub/b é.jpg", 5),
                                     ("c.png", 300)]):
        img.write(struct.pack("<i", i * 7 - 3))
        img.write(struct.pack("<4d", *rng.normal(size=4)))
        img.write(struct.pack("<3d", *rng.normal(size=3)))
        img.write(struct.pack("<i", i + 1))
        img.write(name.encode() + b"\x00")
        img.write(struct.pack("<Q", n2d))
        for _ in range(n2d):
            img.write(struct.pack("<ddq", *rng.normal(size=2), -1))
    pts = io.BytesIO()
    pts.write(struct.pack("<Q", 40))
    for i in range(40):
        pts.write(struct.pack("<Q", i * 3))
        pts.write(struct.pack("<3d", *rng.normal(size=3)))
        pts.write(struct.pack("<3B", *rng.integers(0, 256, 3)))
        pts.write(struct.pack("<d", rng.uniform()))
        track = int(rng.integers(0, 6))
        pts.write(struct.pack("<Q", track))
        for _ in range(track):
            pts.write(struct.pack("<ii", 1, int(rng.integers(0, 9))))
    return img.getvalue(), pts.getvalue()


def _same_images(a, b):
    assert list(a) == list(b)
    for k in a:
        assert (a[k].image_id, a[k].camera_id, a[k].name) == (
            b[k].image_id, b[k].camera_id, b[k].name)
        for f in ("qvec", "tvec"):
            x, y = getattr(a[k], f), getattr(b[k], f)
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)


def _same_points(a, b):
    for f in ("xyz", "rgb"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_native_colmap_parser_matches_python_readers(tmp_path, monkeypatch):
    from brush_tpu.data import colmap as jcolmap
    native.build(verbose=False)
    mod = native.load_colmapio()
    assert mod is not None and tcolmap._native() is mod
    write_colmap_bin(tmp_path / "scene")
    sparse = tmp_path / "scene" / "sparse" / "0"
    cases = [((sparse / "images.bin").read_bytes(),
              (sparse / "points3D.bin").read_bytes()), _tracked_records()]
    for images, points in cases:
        got = tcolmap.read_images_bin(io.BytesIO(images))
        _same_images(got, tcolmap._read_images_bin_py(io.BytesIO(images)))
        _same_images(got, jcolmap._read_images_bin_py(io.BytesIO(images)))
        pts = tcolmap.read_points3d_bin(io.BytesIO(points))
        _same_points(pts, tcolmap._read_points3d_bin_py(io.BytesIO(points)))
        _same_points(pts, jcolmap._read_points3d_bin_py(io.BytesIO(points)))
    assert len(got) == 3 and got[4].name == "sub/b é.jpg"
    assert pts.xyz.shape == (40, 3)
    with pytest.raises(ValueError, match="truncated"):
        mod.parse_images(images[:-9])
    with pytest.raises(ValueError, match="truncated"):
        mod.parse_points3d(points[:-3])
    # The readers take the native parser only where it is built.
    calls = []
    monkeypatch.setattr(mod, "parse_points3d",
                        lambda b: calls.append(len(b)) or (0, b"", b""))
    assert tcolmap.read_points3d_bin(io.BytesIO(points)).xyz.shape == (0, 3)
    assert calls == [len(points)]
    monkeypatch.setattr(native, "load_colmapio", lambda: None)
    _same_points(tcolmap.read_points3d_bin(io.BytesIO(points)), pts)
