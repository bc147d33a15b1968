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
from tests import projection_rows

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


# --------------------------------------------------------------------------
# The closed-form backward (`project_backward_plain`, the specification of
# the CUDA backward kernel) against autograd of `project_splats`.
# --------------------------------------------------------------------------


def _hold_backward_plain(params, cam, img, degree, mip, seed):
    """Every input gradient of `project_backward_plain` within 1e-5 of its
    array's largest entry under autograd's (floor 1e-8): the two sum the
    same terms in other orders. Culled splats get exact zeros in both.
    The camera's lens is a pinhole or KB4. Returns the forward's visible
    mask."""
    from brush_tpu_torch.ops import project_cuda
    from brush_tpu_torch.render import camera_inputs
    ci = camera_inputs(cam, img, device="cpu")
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    proj, flags = tprojection.project_splats_flags(
        *tp, ci, img, sh_degree=degree, mip_splatting=mip, model=cam.model)
    n = params[0].shape[0]
    rng = np.random.default_rng(seed)
    cots = [torch.from_numpy(rng.normal(0, 1, (n,) + s).astype(np.float32))
            for s in ((2,), (3,), (3,), ())]
    total = sum((getattr(proj, o) * c).sum()
                for o, c in zip(("mean2d", "conic", "color", "opac"), cots))
    want = torch.autograd.grad(total, tp)
    got = project_cuda.project_backward_plain(
        *(p.detach() for p in tp), ci, img, flags, *cots, sh_degree=degree,
        mip_splatting=mip, model=cam.model)
    vis = proj.visible.numpy()
    assert np.array_equal(flags.numpy() & 1, vis)
    for g, w, what in zip(got, want, project_cuda._GRAD_FIELDS):
        g, w = g.numpy(), w.numpy()
        assert g.shape == w.shape, what
        assert np.isfinite(g).all() and np.isfinite(w).all(), what
        assert not g[~vis].any() and not w[~vis].any(), what
        tol = max(1e-5 * np.abs(w).max(), 1e-8)
        assert np.abs(g - w).max() <= tol, (
            what, float(np.abs(g - w).max()), float(np.abs(w).max()))
    return vis


@pytest.mark.parametrize("mip", [False, True], ids=["nomip", "mip"])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("case", projection_rows.CASES)
def test_project_backward_plain_matches_autograd(case, degree, mip):
    params, cam, img = projection_rows.case(case)
    vis = _hold_backward_plain(params, cam, img, degree, mip, seed=degree)
    assert 0 < vis.sum() < len(vis) or case == "gsplat"
    if case == "bench_half_dead":
        assert not vis[len(vis) // 2:].any()
    if case == "edges":
        means = params[0]
        assert not vis[0:8].any()                   # behind the near plane
        lim = tcam.Camera.jacobian_clamp_limits(cam, img)
        ratio = means[8:40, 0] / means[8:40, 2]
        past = (ratio < lim[0]) | (ratio > lim[1])
        assert (vis[8:40] & past).sum() >= 8        # past the clamp, seen
        assert vis[48:52].all()                     # colour at the clamp
    if case == "fisheye":
        assert vis[372:378].all()                   # on the axis
        corners = vis[378:394].reshape(4, 4)        # 0.97, 0.995, 1.005,
        assert corners[:, :3].all()                 # 1.012 of the corner
        assert not corners[:, 3].any()              # past the field
        assert not vis[394:].any()


# The poisoned rows through the pinhole (ids as before) and through KB4.
POISON_CASES = [pytest.param(f, v, "bench_half_dead", id=f"{f}-{v}")
                for f, v in projection_rows.POISONS] + [
    pytest.param(f, v, "fisheye", id=f"{f}-{v}-kb4")
    for f, v in projection_rows.POISONS]


@pytest.mark.parametrize("field,value,case", POISON_CASES)
def test_project_backward_plain_matches_autograd_on_poisoned_rows(field,
                                                                  value,
                                                                  case):
    params, cam, img = projection_rows.poisoned(field, value, name=case)
    mip = field in ("log_scales", "quats")
    vis = _hold_backward_plain(params, cam, img, 3, mip, seed=11)
    # A -inf log-scale is a zero scale: finite, and the blur keeps the
    # splat; every other poison culls its rows.
    if field != "sh" and (field, value) != ("log_scales", "-inf"):
        assert not vis[:24].any()
    assert vis.sum() > 100


# --------------------------------------------------------------------------
# KB4 on the kernels: the closed-form Jacobian and its second derivatives
# (`kb4_jacobian`, `kb4_jacobian_vjp`: the plain version's and the CUDA
# kernels' specification), and the compare rules that hold the kernels to
# the plain version.
# --------------------------------------------------------------------------


def _kb4_points(kind, n=512, seed=0):
    """[n, 3] float32 camera-space points: `wide`, random over the fisheye
    cell's render field (theta up to 83 degrees); `axis`, within 1e-6 of
    the axis; `corners`, towards the cell's image corners (82.7 degrees)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.5, 20.0, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    if kind == "wide":
        th = rng.uniform(1e-3, 1.45, n)
    elif kind == "corners":
        w, h = projection_rows.FISHEYE_IMG
        th = np.full(n, tcam._kb4_invert_d(
            np.hypot(w / 2, h / 2) / projection_rows.FISHEYE_FOCAL,
            *projection_rows.KB4)) * rng.uniform(0.98, 1.0, n)
        phi = np.arctan2(rng.choice([-h, h], n), rng.choice([-w, w], n))
    else:
        r = rng.uniform(0.0, 9e-7, n)
        return np.stack([r * np.cos(phi), r * np.sin(phi), rho],
                        -1).astype(np.float32)
    return np.stack([rho * np.sin(th) * np.cos(phi),
                     rho * np.sin(th) * np.sin(phi), rho * np.cos(th)],
                    -1).astype(np.float32)


def _kb4_lens(dtype):
    model = tcam.KannalaBrandt4(*projection_rows.KB4)
    f = projection_rows.FISHEYE_FOCAL
    pinhole = torch.tensor([f, f, 876.0, 584.0], dtype=dtype)
    lim = torch.tensor([-1e30, 1e30, -1e30, 1e30], dtype=dtype)
    return model, pinhole, lim


def _kb4_closed_and_autograd(pts, gj, dtype):
    """(J, its VJP against `gj`) of KB4 at the fisheye cell's focal, in
    `dtype`: by the closed forms (`kb4_jacobian`, `kb4_jacobian_vjp`), and
    by forward-mode AD of the lens's projection (`jacfwd`, as every other
    lens's Jacobian is formed) with `torch.autograd.grad` of it (its second
    derivatives)."""
    model, pinhole, _ = _kb4_lens(dtype)
    p = pts.to(dtype).requires_grad_(True)
    g = gj.to(dtype)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda q: tproj.project(q, pinhole, model)))(p).to(dtype)
    jac_g, = torch.autograd.grad((jac * g).sum(), p)
    x, y, z = p.detach().unbind(-1)
    closed = torch.stack([torch.stack(r, -1) for r in tproj.kb4_jacobian(
        x, y, z, pinhole[0], pinhole[1], model)], -2)
    closed_g = torch.stack(tproj.kb4_jacobian_vjp(
        x, y, z, pinhole[0], pinhole[1], model,
        [[g[:, a, i] for i in range(3)] for a in range(2)]), -1)
    return (closed, closed_g), (jac.detach(), jac_g)


def _closed_form_jacobian(model):
    """`projection_jacobian` written out as the forward kernel forms KB4's,
    through `model`'s coefficients whatever the lens it is called with."""
    def jacobian(mean_c, pinhole, lim, _):
        z = mean_c[..., 2]
        xn = torch.clamp(mean_c[..., 0] / z, lim[0], lim[1])
        yn = torch.clamp(mean_c[..., 1] / z, lim[2], lim[3])
        j = tproj.kb4_jacobian(xn * z, yn * z, z, pinhole[0], pinhole[1],
                               model)
        return torch.stack([torch.stack(r, -1) for r in j], -2)
    return jacobian


@pytest.mark.parametrize("kind", ["wide", "axis", "corners"])
def test_kb4_jacobian_and_its_vjp_match_autograd(kind):
    """`kb4_jacobian` and `kb4_jacobian_vjp` against forward-mode AD of
    KB4's projection and `torch.autograd.grad` of it against a random
    cotangent (its second derivatives), at the fisheye cell's focal; and
    `projection_jacobian`, which `project_splats` takes, is `kb4_jacobian`
    at the clamp-adjusted point bit for bit, with `kb4_jacobian_vjp` the
    VJP that autograd forms of it.
    In float64 the closed forms are autograd's within 1e-9 of each point's
    largest entry. In float32 they sit no further from those float64
    values than autograd in float32 does (the largest distance over the
    points, each in units of the point's largest entry, within twice
    autograd's and 2e-6): off the axis p - s cancels in both, by up to
    3e-5 of a point's VJP at theta = 0.004."""
    pts = torch.from_numpy(_kb4_points(kind))
    gj = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (pts.shape[0], 2, 3)).astype(np.float32))
    (c64, cg64), (a64, ag64) = _kb4_closed_and_autograd(pts, gj,
                                                        torch.float64)
    (c32, cg32), (a32, ag32) = _kb4_closed_and_autograd(pts, gj,
                                                        torch.float32)
    assert c32.dtype == a32.dtype == torch.float32
    for dtype, closed, closed_g in ((torch.float64, c64, cg64),
                                    (torch.float32, c32, cg32)):
        model, pinhole, lim = _kb4_lens(dtype)
        p = pts.to(dtype).requires_grad_(True)
        jac = tproj.projection_jacobian(p, pinhole, lim, model)
        assert torch.equal(jac.detach(), _closed_form_jacobian(model)(
            p.detach(), pinhole, lim, model))
        jac_g, = torch.autograd.grad((jac * gj.to(dtype)).sum(), p)
        if dtype == torch.float64:
            scale = jac_g.abs().amax(1)
            d = (closed_g - jac_g).abs().amax(1)
            assert bool((d <= 1e-9 * scale).all()), float((d / scale).max())
    for got, want in ((c64, a64), (cg64, ag64)):
        scale = want.abs().flatten(1).amax(1)
        d = (got - want).abs().flatten(1).amax(1)
        assert bool((d <= 1e-9 * scale).all()), float((d / scale).max())
    for got, ref, truth in ((c32, a32, a64), (cg32, ag32, ag64)):
        assert bool(torch.isfinite(got).all())
        scale = truth.abs().flatten(1).amax(1)
        d = (got.double() - truth).abs().flatten(1).amax(1)
        d_ref = (ref.double() - truth).abs().flatten(1).amax(1)
        worst, worst_ref = float((d / scale).max()), float(
            (d_ref / scale).max())
        assert worst <= 2.0 * worst_ref + 2e-6, (worst, worst_ref)


@pytest.mark.parametrize("fault", [None, "lens_dropped", "k1_flipped",
                                   "jacobian_k1_flipped", "row_culled"])
@pytest.mark.parametrize("mip", [False, True], ids=["nomip", "mip"])
def test_kb4_compare_rules_fail_faults(monkeypatch, mip, fault):
    """Through KB4 `compare_forward` holds the kernels to the plain version
    bit for bit but the colour, as through a pinhole. On the fisheye rows
    and on strongly anisotropic splats it passes the plain projection with
    KB4's Jacobian written out as the kernel forms it (`None`), and fails a
    lens dropped (projected as a pinhole), k1 with its sign flipped, k1
    flipped in the Jacobian alone (mean2d unchanged on the rows visible to
    both: the conic, opacity and tile bbox carry the fault) and a visible row reported as culled;
    `compare_backward` fails the two lens faults."""
    from brush_tpu_torch.ops import project_cuda
    from brush_tpu_torch.render import camera_inputs
    params, cam, img = projection_rows.case("fisheye")
    aniso = projection_rows.bench_rows(3000, 3000, seed=4)
    rng = np.random.default_rng(4)
    aniso[1] += rng.normal(0, 1.5, aniso[1].shape).astype(np.float32)
    aniso[2][:] = rng.normal(0, 1, aniso[2].shape)
    rows = [torch.from_numpy(np.concatenate([p, q]))
            for p, q in zip(params, aniso)]
    model = cam.model
    flipped = dataclasses.replace(model, k1=-model.k1)
    bad = {"lens_dropped": tcam.Pinhole(), "k1_flipped": flipped}.get(
        fault, model)
    ci = camera_inputs(cam, img, device="cpu")
    kw = dict(sh_degree=3, mip_splatting=mip)
    want = tprojection.project_splats_flags(*rows, ci, img, model=model,
                                            **kw)
    with monkeypatch.context() as m:
        if fault in (None, "jacobian_k1_flipped"):
            m.setattr(tproj, "projection_jacobian", _closed_form_jacobian(
                flipped if fault else model))
        got = tprojection.project_splats_flags(*rows, ci, img, model=bad,
                                               **kw)
    assert int(want[0].visible.sum()) > 2000
    if fault is None:
        project_cuda.compare_forward(got, want)
        return
    if fault == "jacobian_k1_flipped":
        both = got[0].visible & want[0].visible
        assert int(both.sum()) > 2000
        assert torch.equal(got[0].mean2d[both], want[0].mean2d[both])
    if fault == "row_culled":
        # A row visible in both reported as culled: a culled row's unit
        # splat in its fields, its visible flag cleared.
        (gp, gf), vis = got, want[0].visible
        r = int(torch.nonzero(vis)[len(torch.nonzero(vis)) // 2])
        c = int(torch.nonzero(~vis)[0])
        for f in project_cuda._FIELDS:
            getattr(gp, f)[r] = getattr(gp, f)[c]
        gf[r] &= 0xFE
    with pytest.raises(AssertionError):
        project_cuda.compare_forward(got, want)
    if fault in ("row_culled", "jacobian_k1_flipped"):
        return
    n = rows[0].shape[0]
    cots = [torch.from_numpy(rng.normal(0, 1, (n,) + s).astype(np.float32))
            for s in ((2,), (3,), (3,), ())]
    args = (*rows, ci, img, want[1], *cots)
    right = project_cuda.project_backward_plain(*args, model=model, **kw)
    wrong = project_cuda.project_backward_plain(*args, model=bad, **kw)
    with pytest.raises(AssertionError):
        project_cuda.compare_backward(wrong, right)
