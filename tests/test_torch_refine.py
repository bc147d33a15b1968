"""Refine, splat init, capacity growth and the loop around the training
step of `brush_tpu_torch` (plain PyTorch on the CPU) against the JAX package
(jitted on the CPU), on the same numpy inputs.

  * quaternion helpers, `compute_min_scale`, `grow_capacity`, `_grow_state`:
    within 1e-6 (relative to values of order 1) or exact where only copies
    happen.
  * `create_random_splats`, `to_init_splats`: arrays bit-equal (same draws
    from the same numpy generator, same host arithmetic).
  * `refine_step` with the JAX package's Gumbel samples fed in through
    `sample_gumbel`: the seven counters and `n_alive` equal as integers;
    means, scales, rotations, SH and the 3D filter floor within 1e-6
    absolute on values of order 1; opacities within 1e-6 after the sigmoid
    (the raw value is a logit, whose slope 1/(p(1-p)) reaches 250 at the
    1/255 cutoff, so raw is held to 1e-6 times that slope); moments exact
    (they are only permuted, masked and zeroed); the dead tail inert.
  * one short loop through `loop_step` with toy learning rates and two
    refines: the PSNR against the teacher image rises by more than 8 dB;
    capacity overflow grows the tile-sort capacity one step behind, and a
    full splat buffer grows ahead of the refine.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.train import refine as jrefine
from brush_tpu.train import splat_init as jinit
from brush_tpu.train import trainer as jtrainer
from brush_tpu.train.config import TrainConfig as JTrainConfig
from brush_tpu.utils import quat as jquat

from brush_tpu_torch import convert
from brush_tpu_torch import process as tprocess
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.models import splats as tsplats
from brush_tpu_torch.ops import loss as tloss
from brush_tpu_torch.train import eval as teval
from brush_tpu_torch.train import refine as trefine
from brush_tpu_torch.train import splat_init as tinit
from brush_tpu_torch.train import trainer as ttrainer
from brush_tpu_torch.utils import quat as tquat

jprocess = importlib.import_module("brush_tpu.process")

CPU = "cpu"
CAM = dict(position=np.array([0.0, 0.0, -4.0]),
           rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.9, fov_y=0.9)
PARAMS = ("means", "quats", "log_scales", "sh_coeffs", "raw_opacities")


# --------------------------------------------------------------------------
# small helpers
# --------------------------------------------------------------------------


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (50, 4)).astype(np.float32)
    p = rng.normal(0, 1, (50, 4)).astype(np.float32)
    v = rng.normal(0, 2, (50, 3)).astype(np.float32)
    tq, tp, tv = (torch.from_numpy(x) for x in (q, p, v))
    unit = tquat.quat_normalize(tq)
    np.testing.assert_allclose(unit.numpy(),
                               np.asarray(jquat.quat_normalize(q)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(unit.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    jq = jnp.asarray(unit.numpy())
    for got, want in (
            (tquat.quat_to_rotmat(unit), jquat.quat_to_rotmat(jq)),
            (tquat.quat_rotate_vec(unit, tv), jquat.quat_rotate_vec(jq, v)),
            (tquat.quat_multiply(tq, tp), jquat.quat_multiply(q, p))):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    # A rotation: R R^T = 1, and rotating by R equals rotating by q.
    rot = tquat.quat_to_rotmat(unit)
    np.testing.assert_allclose((rot @ rot.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), (50, 3, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(
        (rot @ tv[:, :, None])[..., 0].numpy(),
        tquat.quat_rotate_vec(unit, tv).numpy(), atol=1e-5)


def test_compute_min_scale_matches_jax():
    """11 views: more than one block of the port's loop over views."""
    rng = np.random.default_rng(1)
    means = rng.normal(0, 3, (300, 3)).astype(np.float32)
    centers = rng.normal(0, 5, (11, 3)).astype(np.float32)
    focals = rng.uniform(40, 900, 11).astype(np.float32)
    focals[4] = 0.0                      # clamped to 1e-6
    want = np.asarray(jax.jit(jrefine.compute_min_scale)(means, centers,
                                                         focals))
    got = trefine.compute_min_scale(*(torch.from_numpy(x) for x in
                                      (means, centers, focals)))
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _jax_state(n, cap, seed, sh_degree=1):
    rng = np.random.default_rng(seed)
    splats = jinit.create_random_splats(
        n, [JCamera(**CAM)], rng, scene_scale_override=6.0,
        sh_degree=sh_degree, capacity=cap)
    return jtrainer.init_train_state(splats, jax.random.PRNGKey(seed)), rng


def test_grow_capacity_and_grow_state_match_jax():
    jstate, rng = _jax_state(40, 64, 2)
    floor = rng.uniform(0, 0.1, 64).astype(np.float32)
    jstate = jstate.replace(
        splats=jstate.splats.replace(min_scale=jnp.asarray(floor)),
        refine=jtrainer.RefineRecord(
            *(jnp.asarray(rng.uniform(0, 1, 64).astype(np.float32))
              for _ in range(3))),
        opt={k: st.replace(moment1=st.moment1 + 1.5, moment2=st.moment2 + 2.5)
             for k, st in jstate.opt.items()})
    tstate = convert.train_state_from_arrays(jstate, device=CPU)
    assert torch.equal(tstate.splats.min_scale, torch.from_numpy(floor))
    assert int(tstate.splats.n_alive) == 40
    jgrown = jprocess._grow_state(jstate, 160)
    tgrown = tprocess._grow_state(tstate, 160)
    assert tgrown.splats.capacity == 160
    for name in PARAMS + ("min_scale",):
        np.testing.assert_array_equal(
            getattr(tgrown.splats, name).numpy(),
            np.asarray(getattr(jgrown.splats, name)), err_msg=name)
    for name in PARAMS:
        for which in ("moment1", "moment2"):
            np.testing.assert_array_equal(
                getattr(tgrown.opt[name], which).numpy(),
                np.asarray(getattr(jgrown.opt[name], which)), err_msg=name)
    assert tgrown.opt["sh_coeffs"].moment2.shape == (160, 1, 1)
    for name in ("refine_weight", "visible_count", "max_radius"):
        np.testing.assert_array_equal(
            getattr(tgrown.refine, name).numpy(),
            np.asarray(getattr(jgrown.refine, name)))
    assert int(tgrown.splats.n_alive) == int(jgrown.splats.n_alive) == 40
    # Not growing returns the splats as they are; no floor stays no floor.
    assert tsplats.grow_capacity(tstate.splats, 64) is tstate.splats
    bare = dataclasses.replace(tstate.splats, min_scale=None)
    assert tsplats.grow_capacity(bare, 100).min_scale is None
    # opacities() and scales() fold the floor in, as in the JAX package.
    np.testing.assert_allclose(tstate.splats.opacities().numpy(),
                               np.asarray(jstate.splats.opacities()),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tstate.splats.scales().numpy(),
                               np.asarray(jstate.splats.scales()), rtol=1e-6)
    assert [tprocess._next_pow2(n) for n in (0, 1000, 1025, 1 << 20)] == [
        jprocess._next_pow2(n) for n in (0, 1000, 1025, 1 << 20)]


# --------------------------------------------------------------------------
# splat init
# --------------------------------------------------------------------------


def _cameras(cls):
    return [cls(position=np.array([np.sin(a) * 4, 0.3 * a, -np.cos(a) * 4]),
                rotation=np.array([np.cos(a / 2), 0.0, -np.sin(a / 2), 0.0]),
                fov_x=0.9, fov_y=0.7) for a in (0.0, 0.5, -0.7)]


def _assert_splats_equal(got, want):
    for name in PARAMS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.n_alive) == int(want.n_alive)
    assert got.min_scale is None and want.min_scale is None


@pytest.mark.parametrize("override", [None, 5.0])
def test_create_random_splats_bit_equal(override):
    want = jinit.create_random_splats(
        150, _cameras(JCamera), np.random.default_rng(3),
        scene_scale_override=override, sh_degree=2, capacity=256)
    got = tinit.create_random_splats(
        150, _cameras(TCamera), np.random.default_rng(3),
        scene_scale_override=override, sh_degree=2, capacity=256, device=CPU)
    _assert_splats_equal(got, want)
    assert tinit.estimate_scene_scale(_cameras(TCamera)) == (
        jinit.estimate_scene_scale(_cameras(JCamera)))
    assert tinit.estimate_scene_scale(_cameras(TCamera)[:1]) == 1.0


def test_to_init_splats_bit_equal():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, [2.0, 0.5, 3.0], (500, 3)).astype(np.float32)
    _assert_splats_equal(tinit.to_init_splats(pts[:400], device=CPU),
                         jinit.to_init_splats(pts[:400]))
    colours = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    kw = dict(log_scales=rng.normal(-3, 0.2, (500, 3)).astype(np.float32),
              rotations=rng.normal(0, 1, (500, 4)).astype(np.float32),
              sh_coeffs=colours, raw_opacities=rng.normal(0, 1, 500).astype(
                  np.float32), capacity=512)
    _assert_splats_equal(tinit.to_init_splats(pts, device=CPU, **kw),
                         jinit.to_init_splats(pts, **kw))
    np.testing.assert_array_equal(tinit.compute_knn_scales(pts[:2]),
                                  np.zeros((2, 3), np.float32))
    pts[7] = np.nan                       # the bounds skip it
    b_t, b_j = tinit.bounds_from_pos(0.75, pts), jinit.bounds_from_pos(0.75,
                                                                       pts)
    np.testing.assert_array_equal(b_t.center, b_j.center)
    np.testing.assert_array_equal(b_t.extent, b_j.extent)
    assert b_t.median_size() == b_j.median_size()
    empty = tinit.bounds_from_pos(0.8, np.full((3, 3), np.nan))
    np.testing.assert_array_equal(empty.extent, [1.0, 1.0, 1.0])


# --------------------------------------------------------------------------
# refine_step
# --------------------------------------------------------------------------


def _refine_inputs(n, cap, seed, step):
    """A JAX TrainState with made-up moments and refine statistics: rows
    0..7 barely opaque (pruned), row 8 a non-finite mean and row 9 a
    non-finite SH coefficient (pruned as non-finite), row 10 huge, row 11
    far outside the bounds, rows 12..19 oversized on screen, a third of the
    rest above the gradient threshold, a fifth never visible."""
    jstate, rng = _jax_state(n, cap, seed)
    s = jstate.splats
    raw = np.asarray(s.raw_opacities).copy()
    means = np.asarray(s.means).copy()
    sh = np.asarray(s.sh_coeffs).copy()
    log_scales = np.asarray(s.log_scales).copy()
    log_scales[:n] += rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    raw[:8] = -10.0
    means[8] = np.nan
    sh[9, 1, 2] = np.inf
    log_scales[10] = 12.0
    means[11] = [0.0, 900.0, 0.0]

    def stat(lo, hi):
        x = np.zeros(cap, np.float32)
        x[:n] = rng.uniform(lo, hi, n)
        return x

    visible = (stat(0, 1) > 0.2).astype(np.float32) * 3.0
    weight = stat(0, 0.0075)
    radius = stat(0, 0.4)
    radius[12:20] = 0.9
    visible[12:20] = 1.0

    def moment(x, reduce=False):
        shape = (cap,) + ((1,) * (x.ndim - 1) if reduce else x.shape[1:])
        return jnp.asarray(rng.uniform(0.1, 1.0, shape).astype(np.float32))

    opt = {k: st.replace(moment1=moment(st.moment1),
                         moment2=moment(st.moment2, reduce=k == "sh_coeffs"))
           for k, st in jstate.opt.items()}
    return jstate.replace(
        splats=s.replace(raw_opacities=jnp.asarray(raw),
                         means=jnp.asarray(means), sh_coeffs=jnp.asarray(sh),
                         log_scales=jnp.asarray(log_scales),
                         min_scale=jnp.asarray(stat(0, 0.05))),
        opt=opt, step=jnp.asarray(step, jnp.int32),
        refine=jtrainer.RefineRecord(refine_weight=jnp.asarray(weight),
                                     visible_count=jnp.asarray(visible),
                                     max_radius=jnp.asarray(radius)))


REFINE_CASES = {
    # n, cap, step, TrainConfig overrides, number of views for the filter
    "poisoned": (120, 256, 300, dict(), 2),
    # Growth that would pass the capacity if it were not cut.
    "capacity_limit": (200, 256, 300, dict(growth_grad_threshold=1e-9,
                                           growth_select_fraction=1.0), 1),
    "max_splats_limit": (120, 256, 300, dict(max_splats=120,
                                             growth_select_fraction=1.0), 1),
    "no_screen_split_no_views": (120, 256, 300, dict(
        split_at_screen_size=0.0, opac_decay=0.0), 0),
    # Past 90 % of the run the floor freezes: zeros are attached; past
    # growth_stop_iter nothing grows by gradient.
    "frozen_floor": (120, 256, 950, dict(growth_stop_iter=500), 2),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refine_step_matches_jax_with_its_gumbel_samples(case, monkeypatch):
    n, cap, step, overrides, n_views = REFINE_CASES[case]
    jtcfg = JTrainConfig(total_train_iters=1000, **overrides)
    ttcfg = convert.train_config_from(jtcfg)
    jstate = _refine_inputs(n, cap, 5, step)
    tstate = convert.train_state_from_arrays(jstate, seed=5, device=CPU)
    centers = np.array([[0.0, 0.0, -4.0], [1.0, 0.5, -3.0]],
                       np.float32)[:n_views]
    focals = np.array([70.0, 55.0], np.float32)[:n_views]

    # The JAX package's draws (refine.py:110, :92), in the order the port
    # asks for them: resample, then growth.
    _, k_resample, k_grow = jax.random.split(jstate.rng, 3)
    draws = [np.asarray(jax.random.gumbel(k, (cap,)))
             for k in (k_resample, k_grow)]
    monkeypatch.setattr(trefine, "sample_gumbel",
                        lambda rng, shape, dev: torch.from_numpy(
                            draws.pop(0).copy()))

    js2, jstats = jax.jit(lambda s: jrefine.refine_step(
        s, jtcfg, jnp.asarray(centers), jnp.asarray(focals)))(jstate)
    ts2, tstats = trefine.refine_step(
        tstate, ttcfg, torch.from_numpy(centers), torch.from_numpy(focals))
    assert not draws, "the port drew once per selection"

    want = convert.refine_stats_to_dict(jstats)
    got = convert.refine_stats_to_dict(tstats)
    assert got == want
    assert all(isinstance(v, int) for v in got.values())
    n_alive = int(ts2.splats.n_alive)
    assert n_alive == int(js2.splats.n_alive) == got["total_splats"]
    assert n_alive == n - got["num_pruned"] + got["num_added"] <= cap
    assert got["num_added"] == (got["num_oversized"] + got["num_resampled"]
                                + got["num_grad_grown"])
    assert got["num_pruned"] >= 12 and got["num_pruned_non_finite"] == 2
    if case == "capacity_limit":
        # The room left bounds the growth picks (138 wanted, 48 allowed; a
        # pick that was already selected adds nothing, so the count ends a
        # few short of the capacity).
        assert cap - 10 <= n_alive <= cap and got["num_grad_grown"] < 48
    elif case == "max_splats_limit":
        # 20 resampled and oversized children for 12 free places: the
        # budget cuts the selection itself.
        assert n_alive == 120 and got["num_added"] == 12
        assert got["num_grad_grown"] == 0
    elif case == "no_screen_split_no_views":
        assert got["num_oversized"] == 0 and got["num_grad_grown"] > 0
    elif case == "frozen_floor":
        assert got["num_grad_grown"] == 0 and got["num_oversized"] > 0
    else:
        assert min(got["num_oversized"], got["num_resampled"],
                   got["num_grad_grown"]) > 0

    for name in ("means", "quats", "log_scales", "sh_coeffs"):
        g = getattr(ts2.splats, name).numpy()
        w = np.asarray(getattr(js2.splats, name))
        # Pruned rows keep their (possibly non-finite) values in the dead
        # tail, in the same slots in both packages.
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        ok = np.isfinite(w)
        assert np.isfinite(g[:n_alive]).all(), name
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=1e-6,
                                   err_msg=name)
    raw_t = ts2.splats.raw_opacities.numpy().astype(np.float64)
    raw_j = np.asarray(js2.splats.raw_opacities).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-raw_j))
    assert np.abs(1.0 / (1.0 + np.exp(-raw_t)) - p).max() <= 1e-6
    assert (np.abs(raw_t - raw_j) <= 1e-6 / (p * (1.0 - p)) + 1e-6).all()
    assert (raw_t[n_alive:] == tsplats.DEAD_RAW_OPACITY).all()

    if n_views == 0:
        assert ts2.splats.min_scale is None and js2.splats.min_scale is None
    else:
        floor = ts2.splats.min_scale.numpy()
        np.testing.assert_allclose(floor, np.asarray(js2.splats.min_scale),
                                   rtol=1e-6)
        assert not floor[n_alive:].any()
        assert (floor[:n_alive] > 0).all() == (case != "frozen_floor")
        assert floor[:n_alive].any() == (case != "frozen_floor")

    for name in PARAMS:
        for which in ("moment1", "moment2"):
            g = getattr(ts2.opt[name], which).numpy()
            np.testing.assert_array_equal(
                g, np.asarray(getattr(js2.opt[name], which)),
                err_msg=f"{name}.{which}")
            assert not g[n_alive:].any()
        assert int(ts2.opt[name].time) == int(tstate.opt[name].time)
    # Both halves of a split start from zero moments; untouched rows keep
    # theirs. Parents are the live rows whose first moment is now zero.
    m1 = ts2.opt["means"].moment1.numpy()[:n_alive]
    parents = int((~m1.any(axis=1)).sum()) - got["num_added"]
    assert parents == got["num_added"]
    assert (m1.any(axis=1)).sum() == n_alive - 2 * got["num_added"]

    for name in ("refine_weight", "visible_count", "max_radius"):
        assert not getattr(ts2.refine, name).any()
        assert getattr(ts2.refine, name).shape == (cap,)
    for name in ("median_scale", "bounds_center", "bounds_extent"):
        np.testing.assert_allclose(getattr(ts2, name).numpy(),
                                   np.asarray(getattr(js2, name)), rtol=1e-6,
                                   atol=1e-6)
    assert int(ts2.step) == step and ts2.rng is tstate.rng
    # The old state is untouched.
    assert int(tstate.splats.n_alive) == n
    assert float(tstate.refine.visible_count.max()) == 3.0


def test_split_conserves_center_of_mass():
    """Parent at mean - offset, child at mean + offset: with every live
    splat split and nothing pruned the centroid is preserved
    (tests/test_refine.py), and the children share their parent's rotation,
    scale and colour."""
    rng = np.random.default_rng(8)
    splats = tinit.create_random_splats(
        32, [TCamera(**CAM)], rng, scene_scale_override=6.0, sh_degree=0,
        capacity=128, device=CPU)
    state = ttrainer.init_train_state(splats, 0)
    stat = torch.zeros(128)
    stat[:32] = 1.0
    state = dataclasses.replace(state, refine=ttrainer.RefineRecord(
        refine_weight=stat.clone(), visible_count=stat.clone(),
        max_radius=torch.zeros(128)))
    tcfg = ttrainer.TrainConfig(total_train_iters=1000,
                                growth_grad_threshold=1e-9,
                                growth_select_fraction=1.0, opac_decay=0.0)
    new, stats = trefine.refine_step(state, tcfg, torch.zeros((0, 3)),
                                     torch.zeros(0))
    assert int(stats.num_pruned) == 0 and int(stats.num_added) == 32
    assert int(new.splats.n_alive) == 64
    before = state.splats.means[:32]
    after = new.splats.means[:64]
    np.testing.assert_allclose(after.mean(dim=0).numpy(),
                               before.mean(dim=0).numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(((after[:32] + after[32:]) / 2).numpy(),
                               before.numpy(), atol=1e-5)
    assert (after[:32] - after[32:]).abs().max() > 1e-3
    assert torch.equal(new.splats.log_scales[:32], new.splats.log_scales[32:64])
    assert torch.equal(new.splats.sh_coeffs[:32], new.splats.sh_coeffs[32:64])
    assert (new.splats.log_scales[:32] < state.splats.log_scales[:32]).all()
    assert (new.splats.opacities()[:64] < state.splats.opacities()[:32].max()
            ).all()


def test_sample_gumbel_draws_from_the_state_generator():
    g = torch.Generator(device=CPU)
    g.manual_seed(3)
    a = trefine.sample_gumbel(g, (20000,), CPU)
    g.manual_seed(3)
    assert torch.equal(a, trefine.sample_gumbel(g, (20000,), CPU))
    assert not torch.equal(a, trefine.sample_gumbel(g, (20000,), CPU))
    # Standard Gumbel: mean = Euler's constant, variance = pi^2 / 6.
    assert abs(float(a.mean()) - 0.5772) < 0.03
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.1
    assert torch.isfinite(a).all()
    # Top-k by Gumbel keys picks exactly k of the positive weights.
    w = torch.tensor([0.0, 1.0, 2.0, float("nan"), 3.0, 0.0, 0.5, 4.0])
    sel = trefine._gumbel_topk_select(g, w, torch.tensor(3), 8)
    assert int(sel.sum()) == 3 and not sel[[0, 3, 5]].any()
    assert int(trefine._gumbel_topk_select(g, w, torch.tensor(30),
                                           8).sum()) == 5


# --------------------------------------------------------------------------
# the loop around the step
# --------------------------------------------------------------------------

IMG = (48, 48)


def _teacher(rng):
    """The teacher scene of tests/test_convergence.py, rendered by the
    port."""
    from brush_tpu_torch.ops.sh import rgb_to_sh_dc
    n = 24
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    sh = np.asarray(rgb_to_sh_dc(torch.from_numpy(
        rng.uniform(0.1, 0.9, (n, 1, 3)))), np.float32)
    teacher = tsplats.from_raw(
        means, np.full((n, 3), np.log(0.35), np.float32),
        np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)), sh,
        np.full((n,), 2.5, np.float32), device=CPU)
    cfg = trender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=1 << 12,
                               use_pallas=True, forward_only=True)
    cam = TCamera(**CAM)
    img, _ = trender.render(
        *teacher.params().values(),
        trender.camera_inputs(cam, IMG, device=CPU), torch.zeros(3), cfg)
    return cam, tloss.pack_gt(img[..., :3])


def test_loop_with_refines_gains_psnr():
    rng = np.random.default_rng(7)
    cam, gt = _teacher(rng)
    student = tinit.create_random_splats(
        150, [cam], rng, scene_scale_override=5.0, sh_degree=0,
        capacity=1024, device=CPU)
    # Toy learning rates, as tests/test_convergence.py:54-59 (the
    # production schedule is tuned for 30k-step multi-view runs).
    tcfg = ttrainer.TrainConfig(
        total_train_iters=100000, lr_mean=1e-2, lr_mean_end=1e-2,
        lr_opac=2e-2, lr_scale=2e-2, lr_rotation=2e-2, lr_coeffs_dc=2e-2,
        lr_coeffs_sh_scale=1.0, background_noise_strength=0.0,
        mean_noise_weight=0.0, ssim_weight=0.0, refine_every=30,
        growth_grad_threshold=1e-4)
    rcfg = trender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=1 << 12,
                                use_pallas=True)
    eval_cfg = dataclasses.replace(rcfg, forward_only=True)
    batch = ttrainer.SceneBatch(
        gt_packed=gt, cam=trender.camera_inputs(cam, IMG, device=CPU))
    centers = torch.from_numpy(cam.position.astype(np.float32))[None]
    focals = torch.tensor([float(cam.focal(IMG)[0])])
    loop = tprocess.LoopState(
        state=ttrainer.init_train_state(student, 1, median_scale=2.0),
        rcfg=rcfg)
    before = teval.eval_views(loop.state.splats, [(cam, gt)], eval_cfg)
    refines = []
    for _ in range(75):
        loop, stats, messages = tprocess.loop_step(loop, batch, tcfg, centers,
                                                   focals)
        assert not bool(stats.overflowed)
        refines += [m for m in messages if m.kind == "refine"]
    after = teval.eval_views(loop.state.splats, [(cam, gt)], eval_cfg)
    assert loop.it == 75 and int(loop.state.step) == 75
    assert [m.iter for m in refines] == [30, 60]
    alive = 150
    for m in refines:
        assert m.data["total"] == alive - m.data["pruned"] + m.data["added"]
        assert m.data["added"] == (m.data["oversized"] + m.data["resampled"]
                                   + m.data["grad_grown"])
        alive = m.data["total"]
    assert refines[0].data["added"] > 0
    assert int(loop.state.splats.n_alive) == alive
    assert loop.state.splats.min_scale is not None
    assert np.isfinite(after.psnr) and after.psnr > before.psnr + 8.0, (
        f"PSNR {before.psnr:.2f} -> {after.psnr:.2f}")


def test_loop_grows_capacities():
    """An overflowing step is a no-op that the host notices one step later
    and answers by growing the tile-sort capacity; a splat buffer more than
    80 % full doubles (to at least 1024) ahead of the refine."""
    rng = np.random.default_rng(9)
    cam, gt = _teacher(rng)
    student = tinit.create_random_splats(
        60, [cam], rng, scene_scale_override=5.0, sh_degree=0, capacity=64,
        device=CPU)
    tcfg = ttrainer.TrainConfig(total_train_iters=1000, refine_every=4)
    rcfg = trender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=16,
                                expand_k0=1, use_pallas=True)
    batch = ttrainer.SceneBatch(
        gt_packed=gt, cam=trender.camera_inputs(cam, IMG, device=CPU))
    loop = tprocess.LoopState(state=ttrainer.init_train_state(student, 1),
                              rcfg=rcfg)
    start = loop.state.splats.means.clone()
    kinds, flags = [], []
    for _ in range(4):
        loop, stats, messages = tprocess.loop_step(
            loop, batch, tcfg, torch.zeros((0, 3)), torch.zeros(0))
        flags.append(bool(stats.overflowed))
        kinds.append([m.kind for m in messages])
        if len(flags) == 2:
            # Two lost steps: the first overflowed unseen, the second was
            # enqueued before the first was read.
            assert torch.equal(loop.state.splats.means, start)
    assert flags == [True, True, False, False]
    assert kinds == [[], ["overflow"], [], ["refine"]]
    needed = int(loop.prev_aux.num_isects)
    assert loop.rcfg.isect_cap == tprocess._next_pow2(int(needed * 1.3)) or (
        loop.rcfg.isect_cap >= needed)
    assert loop.rcfg.isect_cap > 16 and loop.rcfg.expand_k0 == 1
    assert not torch.equal(loop.state.splats.means[:60], start[:60])
    # 60 of 64 slots were live at the refine: the buffer grew first.
    assert loop.state.splats.capacity == 1024
    assert loop.state.opt["sh_coeffs"].moment2.shape == (1024, 1, 1)
    assert loop.state.refine.max_radius.shape == (1024,)
    assert int(loop.state.step) == 4
