"""The forward-only render of `brush_tpu_torch` (plain PyTorch on the CPU)
against the JAX package (jitted on the CPU, its Pallas rasterizer in
interpret mode), on the same numpy inputs carried across with `convert`.

  * tile binning: `exact_tile_counts` and `build_intersections(
    with_bwd_info=False)` fed the SAME ProjectedSplats — counts, tile
    ranges and chunk bookkeeping exact, each tile's diet slots equal as a
    multiset (torch.sort and XLA's sorting network order depth ties
    differently, so slot positions inside a tile may differ).
  * the whole slice: port `render` vs JAX `render(use_pallas=True,
    forward_only=True)` on the gsplat fixture and on a synthetic scene with
    a non-zero background: p99.9 of |d| <= 1e-4 and max <= 2/255 (the two
    projections differ by float ulps and the two rasterizers form
    transmittance differently, so a pixel at the alpha >= 1/255 or
    T <= 1e-4 gate can flip; the mix-case rule of the JAX package's
    cross-backend checks), RenderAux counts exact.
  * the golden gsplat image, at the bar the JAX diet path meets against
    its training kernel: max < 2/255, mean < 2e-4.
  * the scene generator, the capacity planner, the min-scale fold and the
    entry points' device rules.
"""

import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from brush_tpu.camera import Camera as JCamera
from brush_tpu.models import splats as jsplats
from brush_tpu.ops import capacity as jcapacity
from brush_tpu.ops import tiling as jtiling
from brush_tpu.ops import tiling_key as jtk
from brush_tpu.ops.projection import project_splats as j_project_splats
from brush_tpu.utils.synthetic import bench_splats as j_bench_splats

from brush_tpu_torch import convert
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.models import splats as tsplats
from brush_tpu_torch.ops import capacity as tcapacity
from brush_tpu_torch.ops import projection as tprojection
from brush_tpu_torch.ops import tiling as ttiling
from brush_tpu_torch.ops import tiling_key as ttk
from brush_tpu_torch.utils import synthetic as tsynthetic

# The module, not the `render` function that brush_tpu/__init__ re-exports.
jrender = importlib.import_module("brush_tpu.render")

DATA = pathlib.Path(__file__).parent / "data"
CPU = "cpu"


# --------------------------------------------------------------------------
# scenes: (params as numpy, camera kwargs, img, sh_degree, bg)
# --------------------------------------------------------------------------


def _basic_case():
    d = load_file(DATA / "basic_case.safetensors")
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = dict(position=np.array([0.123, 0.456, -8.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    params = [d[k] for k in ("means", "scales", "quats", "coeffs",
                             "opacities")]
    return params, cam, (w, h), 3, np.zeros(3, np.float32), d["out_img"]


def _synthetic():
    """The benchmark's generator at a small size, seen from the benchmark
    camera, with a coloured background."""
    s = j_bench_splats(1500, sh_degree=3, seed=7)
    params = [np.asarray(x) for x in (s.means, s.log_scales, s.quats,
                                      s.sh_coeffs, s.raw_opacities)]
    cam = dict(position=np.array([0.0, 0.0, -18.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=1.0, fov_y=0.62)
    return params, cam, (150, 90), 3, np.array([0.2, 0.4, 0.6], np.float32), None


SCENES = {"basic_case": _basic_case, "synthetic_bg": _synthetic}


def _jax_proj(params, cam, img, deg):
    ci = jrender.camera_inputs(JCamera(**cam), img)
    proj = jax.jit(lambda *p: j_project_splats(*p, ci, img, sh_degree=deg))(
        *params)
    return proj, ci


def _to_torch_proj(jproj) -> tprojection.ProjectedSplats:
    return tprojection.ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(jproj, f.name)))
        for f in dataclasses.fields(tprojection.ProjectedSplats)})


# --------------------------------------------------------------------------
# tile binning
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scene", list(SCENES))
def test_exact_tile_counts_match_jax(scene):
    params, cam, img, deg, _, _ = SCENES[scene]()
    jproj, _ = _jax_proj(params, cam, img, deg)
    mask_j, counts_j = jax.jit(jtiling.exact_tile_counts)(jproj)
    mask_t, counts_t = ttiling.exact_tile_counts(_to_torch_proj(jproj))
    np.testing.assert_array_equal(mask_t.numpy(),
                                  np.asarray(mask_j).astype(np.int64))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert int(np.asarray(counts_j).sum()) > 0


def _tile_slot_multiset(soa_words, ranges):
    """[n_slots, 7] rows (tile, 6 diet words), sorted lexicographically."""
    ranges = np.asarray(ranges)
    tiles = np.repeat(np.arange(ranges.shape[0]), ranges[:, 1] - ranges[:, 0])
    idx = np.concatenate([np.arange(a, b) for a, b in ranges] or [[]]
                         ).astype(np.int64)
    m = np.concatenate([tiles[:, None], soa_words[:6, idx].T], axis=1)
    return m[np.lexsort(tuple(m[:, i] for i in reversed(range(m.shape[1]))))]


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_intersections_fwd_only_matches_jax(scene):
    params, cam, img, deg, _, _ = SCENES[scene]()
    jproj, _ = _jax_proj(params, cam, img, deg)
    cap, k0 = 1 << 13, 2
    want = jax.jit(lambda p: jtiling.build_intersections(
        p, img, cap, expand_k0=k0, with_bwd_info=False))(jproj)
    got = ttiling.build_intersections(_to_torch_proj(jproj), img, cap,
                                      expand_k0=k0, with_bwd_info=False)
    for name in ("num_visible", "num_isects", "num_bbox_tail",
                 "num_isects_aligned", "num_chunks", "chunk_starts",
                 "tile_ranges"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(want.num_isects) <= cap
    soa_t = got.soa.numpy()
    soa_j = np.asarray(want.soa).view(np.int32)
    assert soa_t.dtype == np.int32 and soa_t.shape == soa_j.shape
    a = _tile_slot_multiset(soa_t, got.tile_ranges.numpy())
    b = _tile_slot_multiset(soa_j, want.tile_ranges)
    assert a.shape[0] > 0
    np.testing.assert_array_equal(a, b)
    # No per-splat backward bookkeeping on this variant.
    assert got.gid_from_isect.numel() == 0 == got.surv_counts_g.numel()


def test_tiling_keys_and_diet_rows_match_jax():
    rng = np.random.default_rng(3)
    num_tiles, tile_bw = 45, 9
    tile = rng.integers(0, num_tiles + 1, 4000).astype(np.int32)
    depth = np.abs(rng.normal(0, 5, 4000)).astype(np.float32)
    depth_bits = depth.view(np.int32)
    assert ttk.tile_key_bits(num_tiles) == jtk.tile_key_bits(num_tiles)
    key_j = np.asarray(jtk.combined_key(jnp.asarray(tile),
                                        jnp.asarray(depth_bits), num_tiles))
    key_t = ttk.combined_key(torch.from_numpy(tile),
                             torch.from_numpy(depth_bits), num_tiles)
    np.testing.assert_array_equal(key_t.numpy(), key_j.astype(np.int64))
    np.testing.assert_array_equal(
        ttk.tile_boundary_keys(num_tiles).numpy(),
        np.asarray(jtk.tile_boundary_keys(num_tiles)).astype(np.int64))
    rows9 = [rng.normal(0, 40, 4000).astype(np.float32) for _ in range(9)]
    rows6_j = jtk.pack_fwd_rows(jnp.asarray(key_j), [jnp.asarray(r)
                                                     for r in rows9],
                                num_tiles, tile_bw)
    rows6_t = ttk.pack_fwd_rows(key_t, [torch.from_numpy(r) for r in rows9],
                                num_tiles, tile_bw)
    for g, w in zip(rows6_t, rows6_j):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).view(np.int32))
    back_j = jtk.unpack_fwd_rows(jnp.asarray(key_j), rows6_j, num_tiles,
                                 tile_bw)
    back_t = ttk.unpack_fwd_rows(key_t, rows6_t, num_tiles, tile_bw)
    for g, w in zip(back_t, back_j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# the whole slice
# --------------------------------------------------------------------------


def _both_renders(scene, isect_cap=1 << 13, k0=1):
    params, cam, img, deg, bg, golden = SCENES[scene]()
    cfg = dict(img_size=img, sh_degree=deg, isect_cap=isect_cap,
               expand_k0=k0, use_pallas=True, forward_only=True)
    ci_j = jrender.camera_inputs(JCamera(**cam), img)
    img_j, aux_j = jax.jit(lambda *p: jrender.render(
        *p, ci_j, jnp.asarray(bg), jrender.RenderConfig(**cfg)))(*params)
    ci_t = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    splats = convert.splats_from_arrays(dict(zip(
        convert.SPLAT_FIELDS, params)), device=CPU)
    img_t, aux_t = trender.render(*splats.params().values(), ci_t,
                                  torch.from_numpy(bg),
                                  trender.RenderConfig(**cfg))
    return img_t, aux_t, np.asarray(img_j), aux_j, golden


@pytest.mark.parametrize("scene", list(SCENES))
def test_render_forward_only_matches_jax(scene):
    img_t, aux_t, img_j, aux_j, _ = _both_renders(scene)
    assert img_t.dtype == torch.float32 and img_t.shape == img_j.shape
    diff = np.abs(img_t.numpy() - img_j)
    assert np.quantile(diff, 0.999) <= 1e-4, np.quantile(diff, 0.999)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    for name in ("num_visible", "num_isects", "num_bbox_tail",
                 "max_isects_per_tile", "num_chunks"):
        assert int(getattr(aux_t, name)) == int(getattr(aux_j, name)), name
    assert int(aux_t.num_isects) <= 1 << 13
    np.testing.assert_array_equal(aux_t.visible.numpy(),
                                  np.asarray(aux_j.visible))
    np.testing.assert_allclose(aux_t.max_radius.numpy(),
                               np.asarray(aux_j.max_radius),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        trender.pack_image_u8(torch.from_numpy(img_j)).numpy(),
        np.asarray(jrender.pack_image_u8(jnp.asarray(img_j))))
    assert trender.required_isect_cap(aux_t) == jrender.required_isect_cap(
        aux_j)
    if scene == "synthetic_bg":
        assert int(aux_t.num_isects) > 0 and int(aux_t.max_isects_per_tile) > 50


def test_render_matches_gsplat_golden():
    img_t, _, _, _, golden = _both_renders("basic_case")
    diff = np.abs(img_t.numpy() - golden)
    assert diff.max() < 2.0 / 255.0, diff.max()
    assert diff.mean() < 2e-4, diff.mean()


@pytest.mark.parametrize("cfg", [dict(smooth_cutoff=True),
                                 dict(forward_only=True),
                                 dict()])
def test_render_refuses_the_training_configurations(cfg):
    """The configurations of the JAX package's jnp rasterizer
    (`use_pallas=False`) are not ported: the render goes through the CUDA
    kernels' path or raises. (`use_pallas=True` alone, the training
    configuration, renders: tests/test_torch_train.py.)"""
    params, cam, img, deg, bg, _ = _basic_case()
    ci = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    with pytest.raises(NotImplementedError, match="use_pallas=True"):
        trender.render(*(torch.from_numpy(p) for p in params), ci,
                       torch.from_numpy(bg),
                       trender.RenderConfig(img_size=img, **cfg))


# --------------------------------------------------------------------------
# scene, capacity, splats, device rules
# --------------------------------------------------------------------------


def test_bench_splats_matches_jax_arrays():
    want = j_bench_splats(3000, sh_degree=2, seed=11, capacity=3100)
    got = tsynthetic.bench_splats(3000, sh_degree=2, seed=11, capacity=3100,
                                  device=CPU)
    for name in convert.SPLAT_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.n_alive) == int(want.n_alive) == 3000
    assert got.sh_degree == want.sh_degree == 2
    assert got.capacity == 3100
    np.testing.assert_array_equal(got.alive_mask().numpy(),
                                  np.asarray(want.alive_mask()))


def test_plan_caps_matches_jax():
    params, cam, img, _, _, _ = _synthetic()
    means, log_scales, quats, _, opac = params
    want = jcapacity.plan_caps(means, log_scales, quats, opac,
                               jrender.camera_inputs(JCamera(**cam), img),
                               img)
    got = tcapacity.plan_caps(
        *(torch.from_numpy(x) for x in (means, log_scales, quats, opac)),
        trender.camera_inputs(TCamera(**cam), img, device=CPU), img,
        device=CPU)
    assert got == want
    for n in (1, 5000, 8192, 8193, 12289, 3 << 20):
        assert tcapacity.round_cap(n) == jcapacity.round_cap(n)


def test_fold_min_scale_matches_jax():
    rng = np.random.default_rng(4)
    n = 500
    arrays = dict(
        means=rng.normal(0, 2, (n, 3)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.001, 0.5, (n, 3))).astype(np.float32),
        quats=rng.normal(0, 1, (n, 4)).astype(np.float32),
        sh_coeffs=rng.normal(0, 0.3, (n, 4, 3)).astype(np.float32),
        raw_opacities=rng.normal(0, 2, n).astype(np.float32),
        min_scale=rng.uniform(0.0, 0.05, n).astype(np.float32))
    js = jsplats.from_raw(*(arrays[k] for k in convert.SPLAT_FIELDS))
    js = js.replace(min_scale=jnp.asarray(arrays["min_scale"]))
    want = jax.jit(lambda s: s.fold_min_scale())(js)
    ts = convert.splats_from_arrays(js, device=CPU)
    assert ts.min_scale is not None and int(ts.n_alive) == n
    got = ts.fold_min_scale()
    assert got.min_scale is None and got.fold_min_scale() is got
    for name in ("log_scales", "raw_opacities"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert got.with_sh_degree(3).sh_coeffs.shape == (n, 16, 3)
    assert got.with_sh_degree(0).sh_degree == 0


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Functions that create tensors default to device='cuda' and refuse it
    without a card; there is no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, cam, img, _, _, _ = _synthetic()
    tcam = TCamera(**cam)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynthetic.bench_splats(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsplats.from_raw(*params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender.camera_inputs(tcam, img)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.splats_from_arrays(dict(zip(convert.SPLAT_FIELDS, params)))
    s = tsynthetic.bench_splats(10, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcapacity.plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                            trender.camera_inputs(tcam, img, device=CPU), img)
    assert s.means.device.type == "cpu"
