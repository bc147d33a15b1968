"""The plain rasterizer of `RenderConfig(use_pallas=False)`
(`brush_tpu_torch/ops/rasterize_torch.py`) against the JAX package's jnp
rasterizer (`brush_tpu/ops/rasterize_jnp.py`, under `jax.jit`), on the same
projected splats and tile binning (the JAX package's, carried across as
numpy).

  * `rasterize`: the image within p99.9 <= 1e-4 and max <= 2/255 (the
    rules of tests/test_torch_render.py: a pixel at the alpha >= 1/255 gate
    can flip between the two packages' roundings); the gradients of
    mean2d, conic, color, opac and bg, and the refine weight (the
    `refine_holder` cotangent), within 1e-4 of each array's largest entry;
    the visibility (the `visible_holder` cotangent and
    `rasterize_with_visibility`) equal. On the gsplat fixtures, on a random
    scene with a coloured background, with `smooth_cutoff=True`, and on a
    scene whose tiles hold more slots than `max_per_tile`.
  * the port's `render(use_pallas=False)`: the gsplat golden image at the
    JAX package's bar (atol 1e-5, rtol 1 %), its gradients against the JAX
    oracle's under the rule above, and its image against the port's kernel
    paths (their plain versions here): the training path's under the image
    rule, the serving path's f16 diet image under its golden rule.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops import rasterize_jnp
from brush_tpu.ops import tiling as jtiling
from brush_tpu.ops.projection import project_splats as j_project_splats
from brush_tpu.utils.synthetic import bench_splats as j_bench_splats
from tests import make_torch_train_golden as golden

from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.ops import rasterize_torch

jrender = importlib.import_module("brush_tpu.render")

CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs several workers on the
    machine's cores at once, and these tests' results do not depend on the
    thread count (the other files' tests run with their own setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
GRAD_NAMES = ("mean2d", "conic", "color", "opac", "refine", "visible", "bg")


def _fixture(name):
    d = load_file(golden.DATA / f"{name}.safetensors")
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = dict(position=np.array([0.123, 0.456, -8.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    return [d[k] for k in golden.PARAM_KEYS], cam, (w, h), 3, d["out_img"]


def _synthetic():
    s = j_bench_splats(1500, sh_degree=3, seed=7)
    params = [np.asarray(x) for x in (s.means, s.log_scales, s.quats,
                                      s.sh_coeffs, s.raw_opacities)]
    cam = dict(position=np.array([0.0, 0.0, -18.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=1.0, fov_y=0.62)
    return params, cam, (150, 90), 3, None


# scene, bg, max_per_tile, smooth_cutoff
CASES = {
    "tiny_case": (lambda: _fixture("tiny_case"), (0.0, 0.0, 0.0), 32, False),
    "basic_case": (lambda: _fixture("basic_case"), (0.1, 0.25, 0.4), 1024,
                   False),
    "basic_case_smooth": (lambda: _fixture("basic_case"), (0.1, 0.25, 0.4),
                          1024, True),
    "synthetic_bg": (_synthetic, (0.3, 0.2, 0.1), 1024, False),
    # Its fullest tile holds more than 64 slots: both packages blend only
    # each tile's first 64.
    "synthetic_past_max_per_tile": (_synthetic, (0.3, 0.2, 0.1), 64, False),
}


def _jax_binning(params, cam, img, deg):
    ci = jrender.camera_inputs(JCamera(**cam), img)
    proj = jax.jit(lambda *p: j_project_splats(*p, ci, img, sh_degree=deg))(
        *params)
    isect = jax.jit(lambda pr: jtiling.build_intersections(
        pr, img, 1 << 14, with_bwd_info=True))(proj)
    assert int(isect.num_isects) <= 1 << 14
    return proj, isect


def _loss_weights(img):
    return golden.row_weights(img[1]) * np.asarray(golden.CHANNEL_WEIGHTS,
                                                   np.float32)


def _jax_twin(proj, isect, bg, img, max_per_tile, smooth):
    wts = _loss_weights(img)
    n = proj.mean2d.shape[0]

    def f(m, c, col, o, rh, vh, bg_):
        out = rasterize_jnp.rasterize(
            m, c, col, o, rh, vh, isect.gid_from_isect, isect.tile_ranges,
            bg_, img, max_per_tile, 32, smooth)
        return jnp.sum(out * wts), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(7)), has_aux=True))(
            proj.mean2d, proj.conic, proj.color, proj.opac, jnp.zeros(n),
            jnp.zeros(n), jnp.asarray(bg))
    vis = jax.jit(lambda: rasterize_jnp.rasterize_with_visibility(
        proj.mean2d, proj.conic, proj.color, proj.opac, isect.gid_from_isect,
        isect.tile_ranges, img, max_per_tile, 32))()
    return (np.asarray(out), {k: np.asarray(g) for k, g in
                              zip(GRAD_NAMES, grads)}, np.asarray(vis))


def _port_twin(proj, isect, bg, img, max_per_tile, smooth):
    ins = [torch.from_numpy(np.array(x)).requires_grad_(True)
           for x in (proj.mean2d, proj.conic, proj.color, proj.opac)]
    n = ins[0].shape[0]
    holders = [torch.zeros(n, requires_grad=True) for _ in range(2)]
    bg_t = torch.tensor(bg, dtype=torch.float32, requires_grad=True)
    gid = torch.from_numpy(np.array(isect.gid_from_isect))
    ranges = torch.from_numpy(np.array(isect.tile_ranges))
    out = rasterize_torch.rasterize(*ins, *holders, gid, ranges, bg_t, img,
                                    max_per_tile, 32, smooth)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(_loss_weights(img))).sum(),
        ins + holders + [bg_t])
    vis = rasterize_torch.rasterize_with_visibility(
        *(x.detach() for x in ins), gid, ranges, img, max_per_tile, 32)
    return (out.detach().numpy(), {k: g.numpy() for k, g in
                                   zip(GRAD_NAMES, grads)}, vis.numpy())


def _assert_image(got, want):
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.999) <= 1e-4, np.quantile(diff, 0.999)
    assert diff.max() <= 2.0 / 255.0, diff.max()


def _assert_grads(got, want, names):
    for name in names:
        g, w = got[name], want[name]
        assert g.shape == w.shape and np.isfinite(g).all(), name
        tol = max(1e-4 * float(np.abs(w).max()), 1e-8)
        assert np.abs(g - w).max() <= tol, (
            name, float(np.abs(g - w).max()), float(np.abs(w).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_rasterizer_matches_jnp(case):
    scene, bg, max_per_tile, smooth = CASES[case]
    params, cam, img, deg, _ = scene()
    proj, isect = _jax_binning(params, cam, img, deg)
    bg = np.asarray(bg, np.float32)
    img_j, grads_j, vis_j = _jax_twin(proj, isect, bg, img, max_per_tile,
                                      smooth)
    img_t, grads_t, vis_t = _port_twin(proj, isect, bg, img, max_per_tile,
                                       smooth)
    _assert_image(img_t, img_j)
    _assert_grads(grads_t, grads_j,
                  ("mean2d", "conic", "color", "opac", "refine", "bg"))
    np.testing.assert_array_equal(grads_t["visible"], grads_j["visible"])
    np.testing.assert_array_equal(vis_t, vis_j)
    np.testing.assert_array_equal(vis_t, grads_t["visible"])
    assert vis_t.sum() > 0 and grads_t["refine"].max() > 0
    longest = int(np.diff(np.asarray(isect.tile_ranges), axis=1).max())
    if case == "synthetic_past_max_per_tile":
        assert longest > max_per_tile
        # Truncated: another image than the full blend.
        full, _, _ = _port_twin(proj, isect, bg, img, 1024, False)
        assert np.abs(full - img_t).max() > 1e-3
    else:
        assert longest <= max_per_tile


def _port_render(params, cam, img, deg, bg, cfg, grads=False):
    tp = [torch.from_numpy(p.copy()).requires_grad_(grads) for p in params]
    ci = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    n = params[0].shape[0]
    holders = [torch.zeros(n, requires_grad=grads) for _ in range(2)]
    out, aux = trender.render_with_refine(*tp, ci, torch.tensor(bg), cfg,
                                          *holders)
    return out, aux, tp + holders


@pytest.mark.parametrize("name", ["tiny_case", "basic_case"])
def test_plain_render_matches_golden_and_the_jax_oracle(name):
    params, cam, img, deg, golden_img = _fixture(name)
    bg = np.asarray(golden.BG, np.float32)
    cfg = trender.RenderConfig(img_size=img, sh_degree=deg,
                               isect_cap=1 << 14, max_per_tile=64)
    # The golden image, at the JAX package's bar (black background).
    black, aux = trender.render(*(torch.from_numpy(p) for p in params),
                                trender.camera_inputs(TCamera(**cam), img,
                                                      device=CPU),
                                torch.zeros(3), cfg)
    np.testing.assert_allclose(black.numpy(), golden_img, atol=1e-5,
                               rtol=1e-2)
    assert int(aux.max_isects_per_tile) <= cfg.max_per_tile
    # Gradients of a whole render against the JAX oracle's.
    wts = _loss_weights(img)
    want = golden.jax_gradients(params, cam, img, deg, bg,
                                lambda out: jnp.sum(out * wts),
                                max_per_tile=64)
    out, _, leaves = _port_render(params, cam, img, deg, bg, cfg, grads=True)
    loss = (out * torch.from_numpy(wts)).sum()
    got = dict(zip(golden.PARAM_KEYS + ("refine_weight", "visible"),
                   (g.numpy() for g in torch.autograd.grad(loss, leaves))))
    assert abs(float(loss.detach()) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    _assert_grads(got, want, golden.PARAM_KEYS + ("refine_weight",))
    np.testing.assert_array_equal(got["visible"], want["visible"])


def test_plain_render_matches_the_kernel_paths():
    """`use_pallas=False` against the port's two kernel paths (their plain
    versions on the CPU): the training path's image under the image rule;
    the serving path's, whose payload rides the sort as f16, under the rule
    its diet image meets against the gsplat golden (max < 2/255, mean
    < 2e-4, tests/test_torch_render.py); the same binning counts. `render`
    reports exact contribution visibility, which the training path's binned
    visibility covers."""
    params, cam, img, deg, _ = _synthetic()
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    base = trender.RenderConfig(img_size=img, sh_degree=deg,
                                isect_cap=1 << 14)
    ci = trender.camera_inputs(TCamera(**cam), img, device=CPU)
    tp = [torch.from_numpy(p.copy()) for p in params]
    plain, aux_p = trender.render(*tp, ci, torch.from_numpy(bg), base)
    for cfg in (dataclasses.replace(base, use_pallas=True, forward_only=True),
                dataclasses.replace(base, use_pallas=True)):
        with torch.no_grad():
            kern, aux_k = trender.render(*tp, ci, torch.from_numpy(bg), cfg)
        if cfg.forward_only:
            diff = np.abs(plain.numpy() - kern.numpy())
            assert diff.max() < 2.0 / 255.0 and diff.mean() < 2e-4, (
                diff.max(), diff.mean())
        else:
            _assert_image(plain.numpy(), kern.numpy())
        for field in ("num_visible", "num_isects", "max_isects_per_tile"):
            assert int(getattr(aux_p, field)) == int(getattr(aux_k, field))
    binned = aux_k.visible
    assert 0 < float(aux_p.visible.sum()) <= float(binned.sum())
    assert bool((binned >= aux_p.visible).all())
    # forward_only does not apply to the plain rasterizer, as in the JAX
    # package: the image is the same and carries gradients.
    same, _ = trender.render(*(t.clone().requires_grad_(True) for t in tp),
                             ci, torch.from_numpy(bg),
                             dataclasses.replace(base, forward_only=True))
    assert same.requires_grad
    np.testing.assert_array_equal(same.detach().numpy(), plain.numpy())
