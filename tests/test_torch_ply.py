"""PLY I/O of `brush_tpu_torch` (io/ply.py) against the JAX package's, on
the same numpy arrays.

  * The standard and the SuperSplat-compressed writers give byte-identical
    files; `splats_to_ply_bytes` of the port's `Splats` equals the JAX
    package's bytes for the same splats (live rows only).
  * Each package reads the other's files to equal arrays, metadata
    included; streaming import yields the same prefixes; zero splats, an
    ASCII ply and a plain xyz+rgb point cloud read the same.
"""

import io

import numpy as np
import pytest

from brush_tpu.io import ply as jply
from brush_tpu.models import splats as jsplats

from brush_tpu_torch import convert
from brush_tpu_torch.io import ply as tply

FIELDS = ("means", "log_scales", "rotations", "sh_coeffs", "raw_opacities")


def _params(n, k, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        means=rng.normal(0, 2, (n, 3)).astype(np.float32),
        log_scales=rng.normal(-2, 0.5, (n, 3)).astype(np.float32),
        quats=q,
        sh_coeffs=rng.normal(0, 0.3, (n, k, 3)).astype(np.float32),
        raw_opacities=rng.normal(0, 1, n).astype(np.float32))


def _same_data(a, b):
    assert a.num_splats == b.num_splats
    assert (a.up_axis, a.render_mode) == (b.up_axis, b.render_mode)
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _write(mod, writer, **p):
    buf = io.BytesIO()
    getattr(mod, writer)(buf, **p)
    return buf.getvalue()


@pytest.mark.parametrize("writer,n,k", [
    ("save_splat_ply", 17, 16), ("save_splat_ply", 5, 1),
    ("save_splat_ply", 0, 16), ("save_compressed_ply", 300, 4),
    ("save_compressed_ply", 256, 1), ("save_compressed_ply", 7, 9)])
def test_writers_are_byte_identical_and_read_across(writer, n, k):
    p = _params(n, k)
    got = _write(tply, writer, **p)
    assert got == _write(jply, writer, **p)
    # Each package reads the other's file (the same bytes) to equal arrays.
    _same_data(tply.load_splat_ply(io.BytesIO(got)),
               jply.load_splat_ply(io.BytesIO(got)))
    if writer == "save_splat_ply":
        d = tply.load_splat_ply(io.BytesIO(got))
        assert d.num_splats == n and d.up_axis == "z"
        np.testing.assert_array_equal(d.sh_coeffs, p["sh_coeffs"])
        np.testing.assert_array_equal(d.rotations, p["quats"])


def test_splats_to_ply_bytes_matches_jax():
    p = _params(40, 9, seed=5)
    js = jsplats.from_raw(p["means"], p["log_scales"], p["quats"],
                          p["sh_coeffs"], p["raw_opacities"], capacity=64)
    ts = convert.splats_from_arrays(js, device="cpu")
    assert ts.capacity == 64 and int(ts.n_alive) == 40
    got = tply.splats_to_ply_bytes(ts)
    assert got == jply.splats_to_ply_bytes(js)
    assert tply.load_splat_ply(io.BytesIO(got)).num_splats == 40


def test_stream_import_matches_jax(tmp_path):
    p = _params(1000, 4, seed=6)
    path = str(tmp_path / "s.ply")
    tply.save_splat_ply(path, **p)
    got = list(tply.stream_splat_ply(path, chunk_rows=300))
    want = list(jply.stream_splat_ply(path, chunk_rows=300))
    assert [c.num_splats for c in got] == [300, 600, 900, 1000]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_data(a, b)
    _same_data(got[-1], tply.load_splat_ply(path))
    # Compressed and ASCII files stream as one emission.
    cpath = str(tmp_path / "c.compressed.ply")
    tply.save_compressed_ply(cpath, **p)
    (one,) = tply.stream_splat_ply(cpath)
    _same_data(one, jply.load_splat_ply(cpath))


def test_ascii_and_point_cloud_plys_read_alike():
    ascii_ply = (b"ply\nformat ascii 1.0\ncomment vertical axis: y\n"
                 b"element vertex 2\n"
                 b"property float x\nproperty float y\nproperty float z\n"
                 b"property float opacity\nend_header\n"
                 b"1.0 2.0 3.0 0.5\n4.0 5.0 6.0 -0.5\n")
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property uchar red\nproperty uchar green\n"
              b"property uchar blue\nend_header\n")
    xyz = np.arange(15, dtype="<f4").reshape(5, 3)
    rgb = (np.arange(15, dtype=np.uint8) * 17).reshape(5, 3)
    cloud = header + b"".join(xyz[i].tobytes() + rgb[i].tobytes()
                              for i in range(5))
    big_endian = (b"ply\nformat binary_big_endian 1.0\nelement vertex 3\n"
                  b"property float x\nproperty float y\nproperty float z\n"
                  b"end_header\n" + xyz[:3].astype(">f4").tobytes())
    for raw in (ascii_ply, cloud, big_endian):
        t = tply.load_splat_ply(io.BytesIO(raw))
        _same_data(t, jply.load_splat_ply(io.BytesIO(raw)))
    assert t.num_splats == 3
    cloud_t = tply.load_splat_ply(io.BytesIO(cloud))
    assert cloud_t.sh_coeffs.shape == (5, 1, 3) and cloud_t.log_scales is None
    with pytest.raises(ValueError, match="not a ply"):
        tply.load_splat_ply(io.BytesIO(b"obj\n"))
