"""Projection parity: `brush_tpu_torch` (plain PyTorch on the CPU) against
the JAX package (jitted on the CPU), on the same numpy inputs.

Covers SH degrees 0-4, the lens projection and its Jacobian for all four
camera models, and every `ProjectedSplats` field of `project_splats`,
including rows poisoned with NaN/Inf/extremes in the style of
tests/test_fuzz.py. Masks and integer fields must match exactly; floats to
rtol 1e-5, atol 1e-6 (the two frameworks may order a sum differently; the
Jacobian's atol is in units of each point's largest entry, see below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu import camera as jcam
from brush_tpu.ops import camera_proj as jproj
from brush_tpu.ops import projection as jprojection
from brush_tpu.ops import sh as jsh
from brush_tpu.render import camera_inputs as jcamera_inputs

from brush_tpu_torch import camera as tcam
from brush_tpu_torch import convert
from brush_tpu_torch.ops import camera_proj as tproj
from brush_tpu_torch.ops import projection as tprojection
from brush_tpu_torch.ops import sh as tsh

RTOL, ATOL = 1e-5, 1e-6

MODEL_ARGS = [
    ("Pinhole", {}),
    ("KannalaBrandt4", dict(k1=0.05, k2=-0.01, k3=0.002, k4=-0.0005)),
    ("RadialTangential8", dict(k1=0.1, k2=-0.02, p1=0.001, p2=-0.002)),
    ("ThinPrismFisheye", dict(k1=0.05, k2=-0.01, p1=0.001, p2=0.001,
                              sx1=0.0005, sy1=-0.0005)),
]


def _models(name, kw):
    return getattr(jcam, name)(**kw), getattr(tcam, name)(**kw)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, equal_nan=True,
                               err_msg=what)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 257
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    k = jsh.num_sh_coeffs(degree)
    assert tsh.num_sh_coeffs(degree) == k
    coeffs = rng.normal(0, 0.5, (n, k + 2, 3)).astype(np.float32)
    want_b = jax.jit(jsh.sh_basis, static_argnums=1)(v, degree)
    want_c = jax.jit(jsh.sh_to_color, static_argnums=2)(coeffs, v, degree)
    _close(tsh.sh_basis(torch.from_numpy(v), degree), want_b, "basis")
    _close(tsh.sh_to_color(torch.from_numpy(coeffs), torch.from_numpy(v),
                           degree), want_c, "color")
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh_dc(torch.from_numpy(rgb)), jsh.rgb_to_sh_dc(rgb),
           "rgb_to_sh_dc")


@pytest.mark.parametrize("name,kw", MODEL_ARGS, ids=[m[0] for m in MODEL_ARGS])
def test_camera_projection_and_jacobian_match_jax(name, kw):
    jm, tm = _models(name, kw)
    rng = np.random.default_rng(7)
    n = 300
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    pts[:4, :2] = 0.0                      # on the optical axis (KB4 branch)
    pts[4:8, 0] = 40.0                     # far outside the clamp band
    cam = jcam.Camera(position=np.zeros(3), rotation=np.array([1.0, 0, 0, 0]),
                      fov_x=1.2, fov_y=0.9, model=jm)
    img = (160, 120)
    ph = cam.pinhole_params(img)
    lim = cam.jacobian_clamp_limits(img)
    tc = tcam.Camera(position=np.zeros(3), rotation=np.array([1.0, 0, 0, 0]),
                     fov_x=1.2, fov_y=0.9, model=tm)
    np.testing.assert_array_equal(tc.pinhole_params(img), ph)
    np.testing.assert_array_equal(tc.jacobian_clamp_limits(img), lim)
    np.testing.assert_array_equal(tc.viewmat(), cam.viewmat())
    assert tc.half_max_render_fov() == cam.half_max_render_fov()

    want_uv = jax.jit(lambda p: jproj.project(p, jnp.asarray(ph), jm))(pts)
    want_j = jax.jit(lambda p: jproj.projection_jacobian(
        p, jnp.asarray(ph), jnp.asarray(lim), jm))(pts)
    t_ph, t_lim = torch.from_numpy(ph), torch.from_numpy(lim)
    got_uv = tproj.project(torch.from_numpy(pts), t_ph, tm)
    got_j = tproj.projection_jacobian(torch.from_numpy(pts), t_ph, t_lim, tm)
    assert got_j.dtype == torch.float32 and got_j.shape == (n, 2, 3)
    _close(got_uv, want_uv, "project")
    # Jacobian: rtol 1e-5, and atol 1e-6 in units of the point's largest
    # entry. An off-diagonal entry near the optical axis is a difference of
    # terms as large as the diagonal (~25-45 here), so f32 rounding of
    # those terms (ulp ~4e-6) shows in it in either framework; the two
    # autodiff systems order the terms differently.
    g, w = got_j.numpy().astype(np.float64), np.asarray(want_j, np.float64)
    scale = np.maximum(np.abs(w).max(axis=(1, 2), keepdims=True), 1.0)
    err = np.abs(g - w) - (RTOL * np.abs(w) + ATOL * scale)
    assert (err <= 0).all(), f"jacobian off by {np.abs(g - w).max()}"


def _poisoned_params(rng, n=64, k=16):
    means = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.05, 0.6, (n, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    sh = rng.normal(0, 0.3, (n, k, 3)).astype(np.float32)
    opac = rng.normal(0.5, 1.5, n).astype(np.float32)
    params = [means, log_scales, quats, sh, opac]
    poisons = [np.nan, np.inf, -np.inf, 1e38, -1e38, 1e-40, 0.0, -12345.0]
    # Poison the first 12 rows of every array (the rest stay clean, so
    # both the culled and the visible paths are compared).
    for arr in params:
        rows = arr[:12].reshape(12, -1)
        for r in range(12):
            c = rng.integers(0, rows.shape[1])
            rows[r, c] = poisons[(r + c) % len(poisons)]
        arr[:12] = rows.reshape(arr[:12].shape)
    params[2][12:14] = 0.0                 # zero quats
    return params


@pytest.mark.parametrize("name,kw", MODEL_ARGS, ids=[m[0] for m in MODEL_ARGS])
def test_project_splats_every_field_matches_jax(name, kw):
    jm, tm = _models(name, kw)
    rng = np.random.default_rng(11)
    params = _poisoned_params(rng)
    img = (96, 80)
    mip = name == "Pinhole"               # the mip path on one model
    jc = jcam.Camera(position=np.array([0.1, -0.2, -6.0]),
                     rotation=np.array([0.99, 0.05, -0.08, 0.02]),
                     fov_x=1.0, fov_y=0.85, model=jm)
    ci = jcamera_inputs(jc, img)
    want = jax.jit(lambda *p: jprojection.project_splats(
        *p, ci, img, sh_degree=3, model=jm, mip_splatting=mip))(*params)
    got = tprojection.project_splats(
        *(torch.from_numpy(p) for p in params),
        convert.camera_inputs_from_arrays(ci, device="cpu"), img,
        sh_degree=3, model=tm, mip_splatting=mip)
    vis = np.asarray(want.visible)
    assert 5 < vis.sum() < len(vis), "fixture must have culled and visible"
    for f in dataclasses.fields(got):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g.dtype == np.float32, f.name
            _close(g, w, f.name)


@pytest.mark.parametrize("name,kw", MODEL_ARGS, ids=[m[0] for m in MODEL_ARGS])
def test_project_splats_gradients_match_jax_vjp(name, kw):
    """Reverse-mode gradients through the projection (the Jacobian's
    forward-mode `vmap(jacfwd)` inside, the two-pass sanitising selects
    around it) against `jax.vjp`, for the four arrays the rasterizer
    consumes and random cotangents. Each parameter gradient is held to
    1e-5 of its array's largest entry (the two autodiff systems order the
    sums differently). A culled or poisoned splat gets exactly zero
    gradient, never NaN, in both packages."""
    jm, tm = _models(name, kw)
    rng = np.random.default_rng(13)
    params = _poisoned_params(rng)
    img = (96, 80)
    mip = name == "Pinhole"
    jc = jcam.Camera(position=np.array([0.1, -0.2, -6.0]),
                     rotation=np.array([0.99, 0.05, -0.08, 0.02]),
                     fov_x=1.0, fov_y=0.85, model=jm)
    ci = jcamera_inputs(jc, img)
    n = params[0].shape[0]
    outs = ("mean2d", "conic", "color", "opac")
    cots = [rng.normal(0, 1, (n,) + s).astype(np.float32)
            for s in ((2,), (3,), (3,), ())]

    def jfn(*p):
        proj = jprojection.project_splats(*p, ci, img, sh_degree=3, model=jm,
                                          mip_splatting=mip)
        return tuple(getattr(proj, o) for o in outs), proj.visible

    def jgrads(*p):
        (_, visible), vjp = jax.vjp(lambda *q: jfn(*q), *p, has_aux=False)
        return vjp((tuple(jnp.asarray(c) for c in cots),
                    np.zeros(visible.shape, jax.dtypes.float0))), visible

    want, visible = jax.jit(jgrads)(*(jnp.asarray(p) for p in params))
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    proj = tprojection.project_splats(
        *tp, convert.camera_inputs_from_arrays(ci, device="cpu"), img,
        sh_degree=3, model=tm, mip_splatting=mip)
    total = sum((getattr(proj, o) * torch.from_numpy(c)).sum()
                for o, c in zip(outs, cots))
    got = torch.autograd.grad(total, tp)
    vis = np.asarray(visible)
    np.testing.assert_array_equal(proj.visible.numpy(), vis)
    assert 5 < vis.sum() < n
    for g, w, what in zip(got, want, ("means", "log_scales", "quats",
                                      "sh_coeffs", "raw_opacities")):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all() and np.isfinite(w).all(), what
        assert not g[~vis].any() and not w[~vis].any(), what
        assert np.abs(w).max() > 0, what
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (
            what, float(np.abs(g - w).max()), float(np.abs(w).max()))
