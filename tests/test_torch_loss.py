"""The loss, the optimizer and one training step of `brush_tpu_torch`
(plain PyTorch on the CPU) against the JAX package (jitted on the CPU), on
the same numpy inputs.

  * `image_loss`, `image_loss_map`, `ssim`, `psnr`: values and the gradient
    w.r.t. the prediction within 1e-6 (absolute, on values of order 1, and
    relative to the gradient's largest entry), for every alpha mode and the
    tensor background `bg_dyn`; `pack_gt`/`unpack_gt` exact.
  * `adam_step` on identical gradients: parameters and moments within 1e-6
    relative, with `scaling` and the reduced second moment, over 3 steps.
  * `train_step` with the noise off against the JAX `train_step` (jnp
    oracle rasterizer): loss within 5e-4 relative (the SSIM of this scene
    is ill-conditioned in float32, see LOSS_RTOL); first
    moment (linear in the gradient) within 5e-5 of each array's largest
    entry, second moment (quadratic) within 1e-4; parameters only where the gradient is not
    rounding noise (|g| > 1e-6 max|g|: Adam's first step is lr * sign(g)),
    within 1e-3 of that step. With the JAX package's noise samples fed in,
    the noisy step matches too. The overflow no-op is bit-exact, and 12
    steps of the port reduce the loss.
  * `train_step_impl(batched=True)` over two stacked views, and the
    `use_pallas=False` step, against the JAX package's under the same
    rules; `forward_only` is still refused.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops import loss as jloss
from brush_tpu.train import adam_scaled as jadam
from brush_tpu.train import refine as jrefine
from brush_tpu.train import trainer as jtrainer
from brush_tpu.train.config import TrainConfig as JTrainConfig
from brush_tpu.train.splat_init import create_random_splats

from brush_tpu_torch import convert
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.ops import loss as tloss
from brush_tpu_torch.train import adam_scaled as tadam
from brush_tpu_torch.train import refine as trefine
from brush_tpu_torch.train import trainer as ttrainer

jrender = importlib.import_module("brush_tpu.render")

CPU = "cpu"


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------


def _loss_inputs(h=37, w=53, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    y, x = np.mgrid[0:h, 0:w]
    gt = np.stack([x / w, y / h, 0.5 + 0.4 * np.sin(x / 5.0)], -1)
    gt = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    alpha = rng.uniform(0, 1, (h, w)).astype(np.float32)
    return pred, tloss.pack_gt(gt, alpha), gt, alpha


def test_pack_and_unpack_gt_match_jax():
    pred, packed, gt, alpha = _loss_inputs()
    np.testing.assert_array_equal(packed, jloss.pack_gt(gt, alpha))
    np.testing.assert_array_equal(tloss.pack_gt(gt), jloss.pack_gt(gt))
    words = tloss.gt_tensor(packed, device=CPU)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), packed)
    # The tensor twin packs the same bits on the device.
    np.testing.assert_array_equal(
        tloss.pack_gt(torch.from_numpy(gt), torch.from_numpy(alpha)).numpy(),
        words.numpy())
    np.testing.assert_array_equal(
        tloss.pack_gt(torch.from_numpy(gt)).numpy().view(np.uint32),
        jloss.pack_gt(gt))
    rgb_j, a_j = jloss.unpack_gt(jnp.asarray(packed))
    for src in (words, words.to(torch.int64) & 0xFFFFFFFF):
        rgb_t, a_t = tloss.unpack_gt(src)
        np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(
        tloss.unpack_gt_rgb(words, (0.2, 0.3, 0.4)).numpy(),
        np.asarray(jloss.unpack_gt_rgb(jnp.asarray(packed), (0.2, 0.3, 0.4))))


LOSS_MODES = {
    "plain": (dict(), False),
    "l1_only": (dict(l1_weight=1.0, ssim_weight=0.0), False),
    "composite_static": (dict(composite_bg=(0.2, 0.5, 0.7)), False),
    "composite_bg_dyn": (dict(), True),
    "mask": (dict(mask=True), True),
    "alpha_match": (dict(alpha_match=True), True),
}


@pytest.mark.parametrize("mode", list(LOSS_MODES))
def test_image_loss_matches_jax(mode):
    kwargs, use_bg_dyn = LOSS_MODES[mode]
    pred, packed, _, _ = _loss_inputs()
    if not kwargs.get("alpha_match"):
        pred = pred[..., :3]
    bg = np.array([0.3, 0.1, 0.6], np.float32)
    jcfg = jloss.ImageLossConfig(**kwargs)
    tcfg = tloss.ImageLossConfig(**kwargs)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    def jfn(p, b):
        return jloss.image_loss(p, jnp.asarray(packed), jcfg, 0.1,
                                bg_dyn=b if use_bg_dyn else None)

    val_j, (gp_j, gb_j) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(pred), jnp.asarray(bg))
    p = torch.from_numpy(pred).requires_grad_(True)
    b = torch.from_numpy(bg).requires_grad_(True)
    val_t = tloss.image_loss(p, tloss.gt_tensor(packed, device=CPU), tcfg,
                             0.1, bg_dyn=b if use_bg_dyn else None)
    assert abs(float(val_t.detach()) - float(val_j)) <= 1e-6
    gp_t, gb_t = torch.autograd.grad(val_t, [p, b], allow_unused=True)
    gp_j = np.asarray(gp_j)
    # The mean spreads the gradient over the pixels (entries of order 1e-4):
    # within 1e-6 absolutely, and within 1e-5 of the largest entry.
    assert np.abs(gp_t.numpy() - gp_j).max() <= min(
        1e-6, 1e-5 * np.abs(gp_j).max())
    if use_bg_dyn:
        gb_j = np.asarray(gb_j)
        assert np.abs(gb_t.numpy() - gb_j).max() <= 1e-6 * max(
            np.abs(gb_j).max(), 1e-3)
        assert np.abs(gb_j).max() > 0
    lmap_j = np.asarray(jax.jit(lambda q: jloss.image_loss_map(
        q, jnp.asarray(packed), jcfg,
        jnp.asarray(bg) if use_bg_dyn else None))(jnp.asarray(pred)))
    lmap_t = tloss.image_loss_map(
        torch.from_numpy(pred), tloss.gt_tensor(packed, device=CPU), tcfg,
        torch.from_numpy(bg) if use_bg_dyn else None).numpy()
    assert lmap_t.shape == lmap_j.shape
    assert np.abs(lmap_t - lmap_j).max() <= 2e-6


def test_ssim_psnr_and_blur_match_jax():
    pred, packed, gt, _ = _loss_inputs(seed=1)
    words = tloss.gt_tensor(packed, device=CPU)
    rgb = pred[..., :3]
    s_j = float(jax.jit(jloss.ssim)(jnp.asarray(rgb), jnp.asarray(packed)))
    s_t = float(tloss.ssim(torch.from_numpy(rgb), words))
    assert abs(s_t - s_j) <= 1e-6
    p_j = float(jax.jit(jloss.psnr)(jnp.asarray(rgb), jnp.asarray(packed)))
    p_t = float(tloss.psnr(torch.from_numpy(rgb), words))
    assert abs(p_t - p_j) <= 1e-5 * abs(p_j)
    # An image against itself: SSIM 1 away from reduced-precision blurs.
    same, _ = tloss.unpack_gt(words)
    assert abs(float(tloss.ssim(same, words)) - 1.0) <= 1e-6
    x = np.random.default_rng(2).normal(0, 1, (5, 23, 31)).astype(np.float32)
    b_j = np.asarray(jax.jit(jloss._blur11)(jnp.asarray(x)))
    b_t = tloss._blur11(torch.from_numpy(x)).numpy()
    assert np.abs(b_t - b_j).max() <= 1e-6
    np.testing.assert_array_equal(tloss._gauss_taps(), jloss._gauss_taps())


def test_loss_gradient_at_flat_images_matches_jax():
    """A constant prediction against a constant GT: variances are exactly 0
    and the maximum's gradient splits at the tie, as XLA's does."""
    h, w = 24, 24
    pred = np.full((h, w, 3), 0.25, np.float32)
    packed = tloss.pack_gt(np.full((h, w, 3), 0.5, np.float32))
    cfg = dict(l1_weight=0.8, ssim_weight=-0.2)
    g_j = np.asarray(jax.jit(jax.grad(lambda p: jloss.image_loss(
        p, jnp.asarray(packed), jloss.ImageLossConfig(**cfg))))(
            jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    (g_t,) = torch.autograd.grad(tloss.image_loss(
        p, tloss.gt_tensor(packed, device=CPU),
        tloss.ImageLossConfig(**cfg)), [p])
    assert np.isfinite(g_t.numpy()).all()
    # The variances here are rounding noise around 0 (m11 - mu1^2 of a
    # constant), so which side of the floor a pixel falls on differs between
    # the two blurs: entries of order 1e-3 agree to 1e-6 absolutely.
    assert np.abs(g_j).max() > 5e-4
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-6


# --------------------------------------------------------------------------
# AdamScaled and the bounds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_adam_step_matches_jax(reduced):
    rng = np.random.default_rng(5)
    shape = (200, 4, 3)
    param = rng.normal(0, 1, shape).astype(np.float32)
    scaling = np.full((1, 4, 1), 0.1, np.float32)
    scaling[:, 0] = 1.0
    js = jadam.init_state(jnp.asarray(param), reduce_moment_2=reduced)
    ts = tadam.init_state(torch.from_numpy(param), reduce_moment_2=reduced)
    assert tuple(ts.moment2.shape) == js.moment2.shape
    assert ts.time.dtype == torch.int32
    jp, tp = jnp.asarray(param), torch.from_numpy(param)
    jstep = jax.jit(jadam.adam_step)
    for i in range(3):
        grad = (rng.normal(0, 1, shape) * 10.0 ** rng.integers(-6, 2, shape)
                ).astype(np.float32)
        lr = 2e-3 * (i + 1)
        jp, js = jstep(jp, jnp.asarray(grad), js, lr, jnp.asarray(scaling))
        tp, ts = tadam.adam_step(tp, torch.from_numpy(grad), ts,
                                 torch.tensor(lr), torch.from_numpy(scaling))
        # 1e-6 relative; entries where 0.9 m + 0.1 g cancels are held to
        # 1e-7 of the array's largest entry instead.
        for g, w in ((tp, jp), (ts.moment1, js.moment1),
                     (ts.moment2, js.moment2)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-7 * np.abs(w).max())
        assert int(ts.time) == int(js.time) == i + 1
    # No scaling: plain Adam.
    jp2, _ = jstep(jp, jnp.asarray(grad), js, 1e-3)
    tp2, _ = tadam.adam_step(tp, torch.from_numpy(grad), ts, 1e-3)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), rtol=1e-6)


def test_percentile_bounds_match_jax():
    rng = np.random.default_rng(6)
    means = rng.normal(0, [3.0, 1.0, 7.0], (500, 3)).astype(np.float32)
    means[3] = np.nan
    means[10, 1] = np.inf
    alive = np.arange(500) < 450
    c_j, e_j = jax.jit(jrefine._percentile_bounds, static_argnums=2)(
        jnp.asarray(means), jnp.asarray(alive), 0.8)
    c_t, e_t = trefine._percentile_bounds(
        torch.from_numpy(means), torch.from_numpy(alive), 0.8)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert float(trefine.median_size(e_t)) == float(jrefine.median_size(e_j))


# --------------------------------------------------------------------------
# one training step
# --------------------------------------------------------------------------

IMG = (64, 64)
CAM = dict(position=np.array([0.0, 0.0, -4.0]),
           rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.9, fov_y=0.9)
JRCFG = jrender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=1 << 13,
                             max_per_tile=512, chunk=32)
PARAMS = ("means", "quats", "log_scales", "sh_coeffs", "raw_opacities")
# The two packages' images of this scene agree to 5e-7, but their losses
# only to 2e-4 relative: over the flat background the SSIM variance of the
# smooth ground truth, m22 - mu2^2, cancels to three digits in float32, and
# the two blurs round it differently. A float64 evaluation lies between
# the two (JAX +1.0e-4, the port -0.7e-4 relative).
LOSS_RTOL = 5e-4


def _setup(log_scale=None, faint=False):
    """The scene of tests/test_train_step.py: 64 random splats, a diagonal
    gradient image as ground truth. `faint` makes every other splat barely
    visible (opacity 0.0067), the splats the mean noise moves."""
    rng = np.random.default_rng(7)
    splats = create_random_splats(64, [JCamera(**CAM)], rng,
                                  scene_scale_override=6.0, sh_degree=0)
    if log_scale is not None:
        splats = splats.replace(
            log_scales=jnp.full_like(splats.log_scales, log_scale))
    if faint:
        splats = splats.replace(
            raw_opacities=splats.raw_opacities.at[::2].set(-5.0))
    y, x = np.mgrid[0:IMG[1], 0:IMG[0]]
    gt = np.stack([x / 64, y / 64, 0.5 * np.ones_like(x)], -1).astype(
        np.float32)
    packed = jloss.pack_gt(gt)
    jbatch = jtrainer.SceneBatch(
        gt_packed=jnp.asarray(packed),
        cam=jrender.camera_inputs(JCamera(**CAM), IMG))
    tbatch = ttrainer.SceneBatch(
        gt_packed=tloss.gt_tensor(packed, device=CPU),
        cam=trender.camera_inputs(TCamera(**CAM), IMG, device=CPU))
    return splats, jbatch, tbatch


def _both_states(splats, key):
    jstate = jtrainer.init_train_state(splats, jax.random.PRNGKey(key),
                                       median_scale=3.0)
    tstate = convert.train_state_from_arrays(jstate, seed=key, device=CPU)
    return jstate, tstate


def _assert_step_matches(js2, ts2, jstate, lrs, check_means=True,
                         rtol=5e-5):
    # The splats are isotropic, so the rotation gradient is analytically
    # zero and both packages return rounding noise of the scale gradient's
    # terms: it is held to that noise level, and Adam's step for it (the
    # sign of noise) is not compared.
    scale_m1 = np.abs(np.asarray(js2.opt["log_scales"].moment1)).max()
    for name in PARAMS:
        m1_j = np.asarray(js2.opt[name].moment1)
        m2_j = np.asarray(js2.opt[name].moment2)
        m1_t = ts2.opt[name].moment1.numpy()
        m2_t = ts2.opt[name].moment2.numpy()
        assert m1_t.shape == m1_j.shape and m2_t.shape == m2_j.shape, name
        # moment1 = 0.1 g and moment2 = 0.001 g^2 after one step. The
        # render's gradients alone agree to 1e-5 (test_torch_train.py); the
        # loss's conditioning (LOSS_RTOL) reaches the gradients at up to
        # 3.5e-5, and moment2 is quadratic in g: twice that.
        if name == "quats":
            assert np.abs(m1_j).max() < 1e-5 * scale_m1
            assert np.abs(m1_t - m1_j).max() <= 1e-6 * scale_m1
            continue
        assert np.abs(m1_t - m1_j).max() <= rtol * np.abs(m1_j).max(), name
        assert np.abs(m2_t - m2_j).max() <= 2 * rtol * np.abs(m2_j).max(), name
        if name == "means" and not check_means:
            continue
        g = m1_j / 0.1
        solid = np.abs(g) > 1e-6 * np.abs(g).max()
        assert solid.mean() > 0.2, name
        p_j = np.asarray(getattr(js2.splats, name))
        p_t = getattr(ts2.splats, name).numpy()
        moved = np.abs(p_j - np.asarray(getattr(jstate.splats, name)))
        assert moved[solid].max() > 0
        assert np.abs(p_t - p_j)[solid].max() <= 1e-3 * lrs[name] + 1e-7, name
    for name in ("refine_weight", "visible_count", "max_radius"):
        w = np.asarray(getattr(js2.refine, name))
        g = getattr(ts2.refine, name).numpy()
        # the refine weight sums gradient magnitudes per pixel: no
        # cancellation of the pixels' errors, so twice the room
        assert np.abs(g - w).max() <= max(2 * rtol * np.abs(w).max(),
                                          1e-8), name


def test_train_step_matches_jax_with_noise_off():
    splats, jbatch, tbatch = _setup()
    jtcfg = JTrainConfig(total_train_iters=100, background_noise_strength=0.0,
                         mean_noise_weight=0.0,
                         background_color=(0.1, 0.2, 0.3))
    ttcfg = convert.train_config_from(jtcfg)
    assert dataclasses.asdict(ttcfg) == dataclasses.asdict(jtcfg)
    trcfg = convert.render_config_from(JRCFG, use_pallas=True)
    assert trcfg.isect_cap == JRCFG.isect_cap and trcfg.chunk == 32
    jstate, tstate = _both_states(splats, 0)
    js2, jstats, jaux = jax.jit(
        lambda s, b: jtrainer.train_step(s, b, jtcfg, JRCFG))(jstate, jbatch)
    ts2, tstats, taux = ttrainer.train_step(tstate, tbatch, ttcfg, trcfg)
    assert abs(float(tstats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
        float(jstats.loss))
    assert not bool(tstats.overflowed) and not bool(jstats.overflowed)
    assert int(tstats.num_visible) == int(jstats.num_visible)
    assert float(tstats.lr_mean) == pytest.approx(float(jstats.lr_mean),
                                                  rel=1e-6)
    assert int(taux.num_isects) == int(jaux.num_isects)
    assert int(ts2.step) == int(js2.step) == 1
    assert int(tstate.step) == 0, "the old state is untouched"
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    _assert_step_matches(js2, ts2, jstate, lrs)
    assert float(ts2.refine.visible_count.max()) == 1.0


def test_train_step_matches_jax_with_its_noise_samples(monkeypatch):
    """Noise on: the two packages' random streams differ, so the port's two
    sampling functions are replaced by the JAX package's samples for the
    same key (trainer.py:162-172, :265-272)."""
    splats, jbatch, tbatch = _setup(faint=True)
    jtcfg = JTrainConfig(total_train_iters=100)
    ttcfg = convert.train_config_from(jtcfg)
    trcfg = convert.render_config_from(JRCFG, use_pallas=True)
    jstate, tstate = _both_states(splats, 3)
    _, k_bg, k_noise = jax.random.split(jstate.rng, 3)
    s = jtcfg.background_noise_strength
    bg_noise = np.asarray(jax.random.uniform(k_bg, (1, 3), minval=-s,
                                             maxval=s))
    mean_noise = np.asarray(jax.random.normal(k_noise,
                                              jstate.splats.means.shape))
    monkeypatch.setattr(ttrainer, "sample_background_noise",
                        lambda rng, n, strength, dev: torch.from_numpy(
                            bg_noise.copy()))
    monkeypatch.setattr(ttrainer, "sample_mean_noise",
                        lambda rng, shape, dev: torch.from_numpy(
                            mean_noise.copy()))
    js2, jstats, _ = jax.jit(
        lambda s, b: jtrainer.train_step(s, b, jtcfg, JRCFG))(jstate, jbatch)
    ts2, tstats, _ = ttrainer.train_step(tstate, tbatch, ttcfg, trcfg)
    assert abs(float(tstats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
        float(jstats.loss))
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    # Faint splats sit just above the 1/255 cutoff, where the loss's
    # conditioning reaches the gradients at 6e-5: twice the usual room.
    _assert_step_matches(js2, ts2, jstate, lrs, check_means=False, rtol=1e-4)
    # The injected noise (far larger than the Adam step here) matches.
    m_j = np.asarray(js2.splats.means)
    m_t = ts2.splats.means.numpy()
    noise_j = m_j - np.asarray(jstate.splats.means)
    assert np.abs(noise_j).max() > 10 * lrs["means"]
    assert np.abs(m_t - m_j).max() <= 1e-5 * np.abs(noise_j).max() + 2.1 * lrs[
        "means"]


def test_train_step_samplers_draw_from_the_state_generator():
    g = torch.Generator(device=CPU)
    g.manual_seed(11)
    a = ttrainer.sample_background_noise(g, 1, 0.1, CPU)
    b = ttrainer.sample_mean_noise(g, (64, 3), CPU)
    g.manual_seed(11)
    a2 = ttrainer.sample_background_noise(g, 1, 0.1, CPU)
    b2 = ttrainer.sample_mean_noise(g, (64, 3), CPU)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert a.shape == (1, 3) and float(a.abs().max()) <= 0.1
    assert b.shape == (64, 3) and 0.5 < float(b.std()) < 1.5
    u = ttrainer.sample_background_noise(g, 4000, 0.3, CPU)
    assert float(u.min()) < -0.29 and float(u.max()) > 0.29
    assert abs(float(u.mean())) < 0.02


def test_train_step_overflow_is_noop():
    """A step whose intersections overflow the capacity touches no
    parameter, moment or refine statistic (bit-exact), in both packages;
    step and generator still advance."""
    splats, jbatch, tbatch = _setup(log_scale=0.3)
    jtcfg = JTrainConfig(total_train_iters=100)
    ttcfg = convert.train_config_from(jtcfg)
    jstate, tstate = _both_states(splats, 2)
    tiny = dict(img_size=IMG, sh_degree=0, isect_cap=32, expand_k0=1,
                max_per_tile=512, chunk=32)
    js2, jstats, jaux = jax.jit(lambda s, b: jtrainer.train_step(
        s, b, jtcfg, jrender.RenderConfig(**tiny)))(jstate, jbatch)
    rng_before = tstate.rng.get_state().clone()
    ts2, tstats, taux = ttrainer.train_step(
        tstate, tbatch, ttcfg, trender.RenderConfig(use_pallas=True, **tiny))
    assert int(taux.num_isects) == int(jaux.num_isects) > 32
    assert bool(tstats.overflowed) and bool(jstats.overflowed)
    for name in PARAMS:
        for got, old in ((getattr(ts2.splats, name),
                          getattr(tstate.splats, name)),
                         (ts2.opt[name].moment1, tstate.opt[name].moment1),
                         (ts2.opt[name].moment2, tstate.opt[name].moment2)):
            assert torch.equal(got, old), name
        assert int(ts2.opt[name].time) == 0
    for name in ("refine_weight", "visible_count", "max_radius"):
        assert torch.equal(getattr(ts2.refine, name),
                           getattr(tstate.refine, name))
    assert int(ts2.step) == 1
    assert not torch.equal(ts2.rng.get_state(), rng_before)

    # The chunk capacity of the JAX backward still gates the port's step.
    chunky = trender.RenderConfig(img_size=IMG, sh_degree=0,
                                  isect_cap=1 << 13, chunk_cap=1,
                                  use_pallas=True)
    ts3, tstats3, taux3 = ttrainer.train_step(tstate, tbatch, ttcfg, chunky)
    assert int(taux3.num_chunks) > 1 and bool(tstats3.overflowed)
    assert torch.equal(ts3.splats.means, tstate.splats.means)

    # Same scene with ample capacity: not flagged, parameters move.
    big = trender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=1 << 13,
                               use_pallas=True)
    ts4, tstats4, _ = ttrainer.train_step(tstate, tbatch, ttcfg, big)
    assert not bool(tstats4.overflowed)
    assert not torch.equal(ts4.splats.means, tstate.splats.means)
    assert int(ts4.opt["means"].time) == 1


def test_train_step_reduces_loss():
    splats, _, tbatch = _setup()
    ttcfg = convert.train_config_from(JTrainConfig(total_train_iters=100))
    trcfg = convert.render_config_from(JRCFG, use_pallas=True)
    state = ttrainer.init_train_state(
        convert.splats_from_arrays(splats, device=CPU), 0, median_scale=3.0)
    losses = []
    for _ in range(12):
        state, stats, aux = ttrainer.train_step(state, tbatch, ttcfg, trcfg)
        losses.append(float(stats.loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 1e-3
    for leaf in state.splats.params().values():
        assert torch.isfinite(leaf).all()
    assert int(state.step) == 12
    assert float(state.refine.visible_count.max()) > 0
    assert float(state.refine.refine_weight.max()) > 0


def test_train_step_refuses_what_is_not_ported():
    splats, jbatch, tbatch = _setup()
    ttcfg = convert.train_config_from(JTrainConfig())
    state = ttrainer.init_train_state(
        convert.splats_from_arrays(splats, device=CPU), 0)
    # Bounds from the live means, as the JAX package forms them.
    jstate = jtrainer.init_train_state(splats, jax.random.PRNGKey(0))
    assert float(state.median_scale) == float(jstate.median_scale)
    np.testing.assert_array_equal(state.bounds_center.numpy(),
                                  np.asarray(jstate.bounds_center))
    cfg = trender.RenderConfig(img_size=IMG, sh_degree=0, use_pallas=True)
    # An LPIPS model was refused too; the term is ported
    # (tests/test_torch_lpips.py), and at the default weight 0 a model
    # changes nothing.
    from brush_tpu_torch.models.lpips import random_lpips
    rng0 = state.rng.get_state()
    plain_step = ttrainer.train_step(state, tbatch, ttcfg, cfg)
    state.rng.set_state(rng0)
    with_model = ttrainer.train_step(state, tbatch, ttcfg, cfg,
                                     lpips_model=random_lpips(device=CPU))
    assert ttcfg.lpips_loss_weight == 0.0
    assert torch.equal(with_model[1].loss, plain_step[1].loss)
    assert torch.equal(with_model[0].splats.means, plain_step[0].splats.means)
    with pytest.raises(ValueError, match="forward_only=False"):
        ttrainer.train_step(state, tbatch, ttcfg,
                            dataclasses.replace(cfg, forward_only=True))
    # `batched=True` (here one stacked view) and `use_pallas=False` were
    # refused too; they now run, each held to the JAX package's step with
    # the noise off, under the rule of test_train_step_matches_jax_with_
    # noise_off.
    jtcfg = JTrainConfig(total_train_iters=100, background_noise_strength=0.0,
                         mean_noise_weight=0.0,
                         background_color=(0.1, 0.2, 0.3))
    jstate, tstate = _both_states(splats, 0)
    js2, jstats, _ = jax.jit(
        lambda s, b: jtrainer.train_step(s, b, jtcfg, JRCFG))(jstate, jbatch)
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    for batched, rcfg in ((True, convert.render_config_from(
            JRCFG, use_pallas=True)), (False, convert.render_config_from(
                JRCFG))):
        assert rcfg.use_pallas is batched
        batch = ttrainer.stack_batches([tbatch]) if batched else tbatch
        ts2, tstats, _ = ttrainer.train_step_impl(
            tstate, batch, convert.train_config_from(jtcfg), rcfg,
            batched=batched)
        assert abs(float(tstats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
            float(jstats.loss))
        _assert_step_matches(js2, ts2, jstate, lrs)


CAM2 = dict(position=np.array([0.4, -0.2, -3.8]),
            rotation=np.array([0.9950042, 0.0, 0.0998334, 0.0]),
            fov_x=0.9, fov_y=0.9)


def test_train_step_batched_matches_jax():
    """`train_step_impl(batched=True)` over two views (the loss the mean of
    the two, the refine statistics those of one view a step) against the
    JAX package's, noise off: loss within LOSS_RTOL, parameters, moments
    and the refine record under `_assert_step_matches`."""
    splats, jbatch0, tbatch0 = _setup()
    y, x = np.mgrid[0:IMG[1], 0:IMG[0]]
    gt = np.stack([0.5 + 0.3 * np.sin(x / 7.0), y / 64, x / 64], -1).astype(
        np.float32)
    packed = jloss.pack_gt(gt)
    jbatch1 = jtrainer.SceneBatch(
        gt_packed=jnp.asarray(packed),
        cam=jrender.camera_inputs(JCamera(**CAM2), IMG))
    tbatch1 = ttrainer.SceneBatch(
        gt_packed=tloss.gt_tensor(packed, device=CPU),
        cam=trender.camera_inputs(TCamera(**CAM2), IMG, device=CPU))
    from brush_tpu.parallel.data_parallel import stack_batches as j_stack
    jtcfg = JTrainConfig(total_train_iters=100, background_noise_strength=0.0,
                         mean_noise_weight=0.0,
                         background_color=(0.1, 0.2, 0.3))
    jstate, tstate = _both_states(splats, 0)
    js2, jstats, jaux = jax.jit(lambda s, b: jtrainer.train_step_impl(
        s, b, jtcfg, JRCFG, batched=True))(jstate, j_stack([jbatch0,
                                                           jbatch1]))
    tbatch = ttrainer.stack_batches([tbatch0, tbatch1])
    assert tbatch.gt_packed.shape == (2,) + IMG[::-1]
    assert tbatch.cam.viewmat.shape == (2, 3, 4)
    ts2, tstats, taux = ttrainer.train_step_impl(
        tstate, tbatch, convert.train_config_from(jtcfg),
        convert.render_config_from(JRCFG, use_pallas=True), batched=True)
    assert abs(float(tstats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
        float(jstats.loss))
    for name in ("num_visible", "num_isects", "max_isects_per_tile"):
        assert int(getattr(taux, name)) == int(getattr(jaux, name)), name
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    _assert_step_matches(js2, ts2, jstate, lrs)
    # Visibility is a 0/1 mask over both views.
    assert float(ts2.refine.visible_count.max()) == 1.0
    # Not the first view's step alone.
    ts1, _, _ = ttrainer.train_step(tstate, tbatch0,
                                    convert.train_config_from(jtcfg),
                                    convert.render_config_from(
                                        JRCFG, use_pallas=True))
    assert not torch.allclose(ts1.splats.raw_opacities,
                              ts2.splats.raw_opacities)
