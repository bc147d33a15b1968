"""The training render of `brush_tpu_torch` (plain PyTorch on the CPU)
against the JAX package (jitted on the CPU), on the same numpy inputs.

  * tile binning with backward info: `build_intersections(
    with_bwd_info=True)` fed the SAME ProjectedSplats: counts, starts,
    chunk bookkeeping and tile ranges exact, the f32 SoA rows (gid
    included) equal per tile as multisets (the two sorts order depth ties
    differently), also when the remainder region overflows.
  * the training forward: `rasterize_forward_train` vs
    `rasterize_forward_pallas(fwd_only=False, interpret=True)` on the same
    SoA: rows 0..4 p99.9 <= 1e-5 and max <= 2/255 (sequential transmittance
    against the TPU's log-space prefix), `useful_len` exact.
  * gradients of a whole render vs the jnp oracle's custom VJP
    (`RenderConfig(use_pallas=False)`, NOT the Pallas backward, which is
    wrong on saturated multi-chunk tiles): every parameter gradient and the
    refine weight within 1e-5 of the array's largest entry (floor 1e-8),
    the visibility mask exact, on the gsplat fixture, on a saturated scene
    and on the saturated multi-chunk scene that breaks the Pallas backward.
  * the committed golden-gradient file equals what the JAX package gives
    today.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops import tiling as jtiling
from brush_tpu.ops.projection import project_splats as j_project_splats
from brush_tpu.ops.rasterize_pallas import rasterize_forward_pallas
from brush_tpu.utils.synthetic import bench_splats as j_bench_splats
from tests import make_torch_train_golden as golden

from brush_tpu_torch import convert
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.ops import projection as tprojection
from brush_tpu_torch.ops import rasterize_cuda
from brush_tpu_torch.ops import tiling as ttiling

jrender = importlib.import_module("brush_tpu.render")

CPU = "cpu"


# --------------------------------------------------------------------------
# scenes: (params as numpy, camera kwargs, img, sh_degree)
# --------------------------------------------------------------------------


def _basic_case():
    params, cam, img = golden.basic_case()
    return params, cam, img, 3


def _synthetic():
    s = j_bench_splats(1500, sh_degree=3, seed=7)
    params = [np.asarray(x) for x in (s.means, s.log_scales, s.quats,
                                      s.sh_coeffs, s.raw_opacities)]
    cam = dict(position=np.array([0.0, 0.0, -18.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=1.0, fov_y=0.62)
    return params, cam, (150, 90), 3


def _saturated(n=256, spread=0.8, opac=6.0, img=(64, 48)):
    """The scene of tests/test_pallas_parity.py
    `test_pallas_backward_with_saturation`."""
    from brush_tpu.ops.sh import rgb_to_sh_dc
    rng = np.random.default_rng(3)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    sh = np.asarray(rgb_to_sh_dc(rng.uniform(0, 1, (n, 1, 3)))).astype(
        np.float32)
    params = [means, np.full((n, 3), np.log(0.2), np.float32),
              np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)), sh,
              np.full(n, opac, np.float32)]
    cam = dict(position=np.array([0.0, 0.0, -5.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=0.9, fov_y=0.9 * img[1] / img[0])
    return params, cam, img, 0


def _saturated_multichunk(n=600):
    """600 tile-covering near-opaque splats with shuffled ids: every tile
    spans more than two 256-slot chunks and saturates early, the regime in
    which the JAX package's Pallas backward is wrong."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.3, 0.3, (n, 2))
    z = np.linspace(0.0, 3.0, n)
    means = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    means = means[rng.permutation(n)]
    sh = rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32)
    params = [means, np.full((n, 3), np.log(0.6), np.float32),
              np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)), sh,
              np.full(n, 6.0, np.float32)]
    cam = dict(position=np.array([0.0, 0.0, -4.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.8, fov_y=0.8)
    return params, cam, (64, 64), 0


def _jax_proj(params, cam, img, deg):
    ci = jrender.camera_inputs(JCamera(**cam), img)
    return jax.jit(lambda *p: j_project_splats(*p, ci, img, sh_degree=deg))(
        *params)


def _to_torch_proj(jproj) -> tprojection.ProjectedSplats:
    return tprojection.ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(jproj, f.name)))
        for f in dataclasses.fields(tprojection.ProjectedSplats)})


# --------------------------------------------------------------------------
# tile binning with backward info
# --------------------------------------------------------------------------


def _tile_slot_multiset(soa, gid, ranges):
    """[n_slots, 12] rows (tile, 10 SoA row bit patterns, gid), sorted."""
    ranges = np.asarray(ranges)
    tiles = np.repeat(np.arange(ranges.shape[0]), ranges[:, 1] - ranges[:, 0])
    idx = np.concatenate([np.arange(a, b) for a, b in ranges] or [[]]
                         ).astype(np.int64)
    m = np.concatenate([tiles[:, None],
                        soa[:10, idx].view(np.int32).T.astype(np.int64),
                        np.asarray(gid)[idx, None]], axis=1)
    return m[np.lexsort(tuple(m[:, i] for i in reversed(range(m.shape[1]))))]


BINNING_CASES = {
    "basic_case": (_basic_case, 1 << 13, 2),
    "synthetic": (_synthetic, 1 << 13, 2),
    # The remainder region overflows: runs are cut at its edge and
    # surv_counts_g counts only what was emitted.
    "synthetic_overflow": (_synthetic, 512, 1),
}


@pytest.mark.parametrize("case", list(BINNING_CASES))
def test_build_intersections_bwd_info_matches_jax(case):
    scene, cap, k0 = BINNING_CASES[case]
    params, cam, img, deg = scene()
    jproj = _jax_proj(params, cam, img, deg)
    want = jax.jit(lambda p: jtiling.build_intersections(
        p, img, cap, expand_k0=k0, with_bwd_info=True))(jproj)
    got = ttiling.build_intersections(_to_torch_proj(jproj), img, cap,
                                      expand_k0=k0, with_bwd_info=True)
    for name in ("num_visible", "num_isects", "num_bbox_tail",
                 "num_isects_aligned", "num_chunks", "chunk_starts",
                 "tile_ranges", "surv_counts_g", "surv_starts_g"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    overflow = case.endswith("overflow")
    assert (int(want.num_isects) > cap) == overflow
    n = params[0].shape[0]
    s_cap = n * k0 + cap
    soa_t, soa_j = got.soa.numpy(), np.asarray(want.soa)
    assert soa_t.dtype == np.float32 and soa_t.shape == soa_j.shape
    assert soa_t.shape[0] == ttiling.SOA_ROWS == jtiling.SOA_ROWS
    assert not soa_t[10:].any() and not soa_t[:, s_cap:].any()
    gid_t = got.gid_from_isect.numpy()
    assert gid_t.dtype == np.int32 and gid_t.shape == (s_cap,)
    np.testing.assert_array_equal(gid_t, soa_t[9, :s_cap].astype(np.int32))
    a = _tile_slot_multiset(soa_t, gid_t, got.tile_ranges.numpy())
    b = _tile_slot_multiset(soa_j, want.gid_from_isect, want.tile_ranges)
    assert a.shape[0] > 0
    np.testing.assert_array_equal(a, b)
    # Every slot inside a tile range belongs to a splat that emitted it.
    per_splat = np.bincount(a[:, -1], minlength=n)
    np.testing.assert_array_equal(per_splat, got.surv_counts_g.numpy())
    if overflow:
        assert int((np.asarray(want.surv_counts_g)
                    < np.asarray(jax.jit(jtiling.exact_tile_counts)(jproj)[1])
                    ).sum()) > 0


# --------------------------------------------------------------------------
# the training forward
# --------------------------------------------------------------------------


def _jax_train_soa(params, cam, img, deg, isect_cap=1 << 13, k0=4):
    ci = jrender.camera_inputs(JCamera(**cam), img)

    @jax.jit
    def binning(*p):
        proj = j_project_splats(*p, ci, img, sh_degree=deg)
        return jtiling.build_intersections(proj, img, isect_cap,
                                           expand_k0=k0, with_bwd_info=True)

    isect = binning(*params)
    assert int(isect.num_isects) <= isect_cap
    return isect


@pytest.mark.parametrize("scene", ["basic_case", "saturated"])
def test_rasterize_forward_train_matches_pallas(scene):
    params, cam, img, deg = (_basic_case() if scene == "basic_case"
                             else _saturated(n=600, opac=8.0, img=(96, 64)))
    isect = _jax_train_soa(params, cam, img, deg)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    want = np.asarray(rasterize_forward_pallas(
        isect.soa, isect.tile_ranges, jnp.asarray(bg), img, interpret=True,
        fwd_only=False))
    soa = torch.from_numpy(np.asarray(isect.soa))
    ranges = torch.from_numpy(np.asarray(isect.tile_ranges))
    got = rasterize_cuda.rasterize_forward_train(
        soa, ranges, torch.from_numpy(bg), img)[0].numpy()
    assert got.shape == want.shape and got.shape[1] == 8
    diff = np.abs(got[:, :5] - want[:, :5])
    assert np.quantile(diff, 0.999) <= 1e-5, np.quantile(diff, 0.999)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    # useful_len: exact, one value per tile in every lane; rows 6, 7 zero.
    np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
    spans = np.diff(np.asarray(isect.tile_ranges), axis=1)[:, 0]
    assert (got[:, 5, 0] <= spans).all() and got[:, 5].max() > 0
    if scene == "saturated":
        # Saturated tiles stop consuming slots long before their range ends.
        assert spans.max() > 256 and (got[:, 5, 0] < spans).any()
    # Final T is 1 - alpha up to rounding.
    np.testing.assert_allclose(got[:, 4], 1.0 - got[:, 3], atol=1e-6)


# --------------------------------------------------------------------------
# gradients of a whole render
# --------------------------------------------------------------------------


def _weighted_sum(h, xp):
    wmap = golden.row_weights(h)
    chan = np.asarray(golden.CHANNEL_WEIGHTS, np.float32)
    if xp is torch:
        return lambda out: (out * torch.from_numpy(wmap)
                            * torch.from_numpy(chan)).sum()
    return lambda out: jnp.sum(out * wmap * chan)


def _port_gradients(params, cam, img, deg, bg, loss_of_image,
                    isect_cap=1 << 14):
    cfg = trender.RenderConfig(img_size=img, sh_degree=deg,
                               isect_cap=isect_cap, use_pallas=True)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    n = params[0].shape[0]
    rh = torch.zeros(n, requires_grad=True)
    vh = torch.zeros(n, requires_grad=True)
    ci = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    out, aux = trender.render_with_refine(*tp, ci, torch.from_numpy(bg), cfg,
                                          rh, vh)
    assert int(aux.num_isects) <= isect_cap
    loss = loss_of_image(out)
    grads = torch.autograd.grad(loss, tp + [rh, vh])
    res = {k: g.numpy() for k, g in zip(golden.PARAM_KEYS, grads[:5])}
    res["refine_weight"] = grads[5].numpy()
    res["visible"] = grads[6].numpy()
    res["loss"] = loss.detach().numpy()
    return res


GRADIENT_CASES = {
    # scene, bg, loss of the image (for torch / for jax), oracle max_per_tile
    "basic_case": (_basic_case, (0.1, 0.25, 0.4), "weighted_sum", 64),
    "saturated": (_saturated, (0.2, 0.2, 0.2), "mean_square", 1024),
    "saturated_multichunk": (_saturated_multichunk, (0.1, 0.25, 0.4),
                             "weighted_sum", 1024),
}


@pytest.mark.parametrize("case", list(GRADIENT_CASES))
def test_render_gradients_match_jnp_oracle(case):
    scene, bg, loss_name, max_per_tile = GRADIENT_CASES[case]
    params, cam, img, deg = scene()
    bg = np.asarray(bg, np.float32)
    if loss_name == "weighted_sum":
        loss_t, loss_j = _weighted_sum(img[1], torch), _weighted_sum(img[1],
                                                                     jnp)
    else:
        loss_t = lambda out: (out ** 2).mean()          # noqa: E731
        loss_j = lambda out: jnp.mean(out ** 2)         # noqa: E731
    want = golden.jax_gradients(params, cam, img, deg, bg, loss_j,
                                max_per_tile=max_per_tile)
    got = _port_gradients(params, cam, img, deg, bg, loss_t)
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    for name in golden.PARAM_KEYS + ("refine_weight",):
        g, w = got[name], want[name]
        assert g.shape == w.shape and np.isfinite(g).all(), name
        tol = max(1e-5 * float(np.abs(w).max()), 1e-8)
        if name == "quats" and case != "basic_case":
            # Isotropic splats: the rotation gradient is analytically zero
            # and both packages return the rounding noise of the scale
            # gradient's terms, so it is held to that noise level.
            tol = max(tol, 1e-7 * float(np.abs(want["scales"]).max()))
        assert np.abs(g - w).max() <= tol, (
            name, float(np.abs(g - w).max()), float(np.abs(w).max()))
    np.testing.assert_array_equal(got["visible"], want["visible"])
    assert 0 < got["visible"].sum()
    assert got["refine_weight"].max() > 0
    if case != "basic_case":
        # Occluded splats: binned but never blended.
        assert got["visible"].sum() < params[0].shape[0]


def test_render_training_config_outputs():
    """`render` with the training configuration: the image equals the
    forward-only image up to the diet's f16 payload, `aux.visible` is the
    binned visibility (a superset of the blended splats), and a NaN-poisoned
    or culled splat gets exactly zero gradient."""
    params, cam, img, deg = _synthetic()
    params = [p.copy() for p in params]
    params[0][5] = np.nan                       # poisoned mean: culled
    params[0][6] = [0.0, 0.0, -40.0]            # behind the camera: culled
    bg = torch.tensor([0.2, 0.4, 0.6])
    ci = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    cfg = trender.RenderConfig(img_size=img, sh_degree=deg, isect_cap=1 << 13,
                               expand_k0=2, use_pallas=True)
    tp = [torch.from_numpy(p).requires_grad_(True) for p in params]
    n = params[0].shape[0]
    vh = torch.zeros(n, requires_grad=True)
    out, aux = trender.render_with_refine(*tp, ci, bg, cfg,
                                          torch.zeros(n), vh)
    assert out.requires_grad and out.shape == (img[1], img[0], 4)
    fwd, aux_f = trender.render(
        *(t.detach() for t in tp), ci, bg,
        dataclasses.replace(cfg, forward_only=True))
    assert not fwd.requires_grad
    assert (out.detach() - fwd).abs().max() < 2.0 / 255.0
    assert int(aux.num_isects) == int(aux_f.num_isects)
    grads = torch.autograd.grad((out ** 2).sum(), tp + [vh])
    for g in grads:
        assert torch.isfinite(g).all()
    for g in grads[:5]:
        assert not g[5].any() and not g[6].any()
    blended = grads[5]
    assert aux.visible[5] == 0 and aux.visible[6] == 0
    assert bool((aux.visible >= blended).all())
    assert 0 < blended.sum() <= aux.visible.sum() < n
    assert not aux_f.visible.any()
    assert cfg.resolved_chunk_cap(n) == jrender.RenderConfig(
        img_size=img, isect_cap=1 << 13, expand_k0=2).resolved_chunk_cap(n)
    assert dataclasses.replace(cfg, chunk_cap=77).resolved_chunk_cap(n) == 77


def test_golden_gradient_file_is_current():
    """tests/data/torch_train_golden.npz (read on the card, where there is
    no JAX) equals what the JAX package computes today, and the port on the
    CPU meets the rule `chip_smoke.py` holds the card to."""
    want = golden.golden_arrays()
    with np.load(golden.GOLDEN) as f:
        stored = {k: f[k] for k in f.files}
    assert sorted(stored) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(stored[k], w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)
    params, cam, img = golden.basic_case()
    got = _port_gradients(params, cam, img, 3,
                          np.asarray(golden.BG, np.float32),
                          _weighted_sum(img[1], torch))
    for k in golden.PARAM_KEYS + ("refine_weight",):
        assert np.abs(got[k] - stored[k]).max() <= 1e-4 * np.abs(
            stored[k]).max(), k
    np.testing.assert_array_equal(got["visible"], stored["visible"])
