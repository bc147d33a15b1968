"""Evaluation and LOD scoring of `brush_tpu_torch` (plain PyTorch on the
CPU) against the JAX package (jitted on the CPU, jnp oracle rasterizer), on
the same numpy inputs.

  * `eval_views` on the 64x64 scene of tests/test_torch_loss.py: PSNR
    within 1e-3 dB and SSIM within 1e-4 per view (the port renders through
    the serving configuration, whose f16 colour payload may move a pixel by
    one 8-bit step after the round trip); the overflow retry gives the same
    numbers as ample capacity.
  * `pup_scores`: the accumulated [cap, 6, 6] sums H against the JAX
    package's estimator fed the same probes (through `sample_probes`),
    within 2e-4 of each splat's largest entry (sums of squares of
    gradients that agree to 1e-5); the scores within 1e-2 where H is well
    conditioned (H + 1e-12 I is singular to float32 precision for unseen
    splats, where both packages return rounding noise), and -inf never
    where the JAX package is finite. `exact=True` against the same sums
    taken by autograd with one probe per pixel and channel (tolerance in
    the test).
  * `decimate_to_count` on identical scores: arrays exact.
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
from brush_tpu.train import eval as jeval
from brush_tpu.train import lod as jlod
from brush_tpu.train.splat_init import create_random_splats

from brush_tpu_torch import convert
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.models import splats as tsplats
from brush_tpu_torch.train import eval as teval
from brush_tpu_torch.train import lod as tlod

jrender = importlib.import_module("brush_tpu.render")

CPU = "cpu"
IMG = (64, 64)
CAMS = [dict(position=np.array([0.0, 0.0, -4.0]),
             rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.9, fov_y=0.9),
        dict(position=np.array([-4.0 * np.sin(0.4), 0.0, -4.0 * np.cos(0.4)]),
             rotation=np.array([np.cos(0.2), 0.0, np.sin(0.2), 0.0]),
             fov_x=0.9, fov_y=0.9)]
JRCFG = jrender.RenderConfig(img_size=IMG, sh_degree=0, isect_cap=1 << 13,
                             max_per_tile=512, chunk=32)
PARAMS = ("means", "quats", "log_scales", "sh_coeffs", "raw_opacities")


def _scene(n=64, cap=None, seed=7):
    rng = np.random.default_rng(seed)
    splats = create_random_splats(n, [JCamera(**CAMS[0])], rng,
                                  scene_scale_override=6.0, sh_degree=0,
                                  capacity=cap)
    floor = np.zeros(splats.capacity, np.float32)
    floor[:n] = rng.uniform(0.0, 0.03, n)
    return splats.replace(min_scale=jnp.asarray(floor))


def _ground_truths():
    y, x = np.mgrid[0:IMG[1], 0:IMG[0]]
    a = np.stack([x / 64, y / 64, 0.5 * np.ones_like(x)], -1)
    b = np.stack([0.5 + 0.4 * np.sin(x / 7.0), y / 64, x / 64], -1)
    return [jloss.pack_gt(g.astype(np.float32)) for g in (a, b)]


# --------------------------------------------------------------------------
# eval_views
# --------------------------------------------------------------------------


def test_eval_views_matches_jax():
    splats = _scene()
    gts = _ground_truths()
    want = jeval.eval_views(
        splats, [(JCamera(**c), jnp.asarray(g)) for c, g in zip(CAMS, gts)],
        JRCFG)
    tspl = convert.splats_from_arrays(splats, device=CPU)
    views = [(TCamera(**c), g) for c, g in zip(CAMS, gts)]
    rcfg = convert.render_config_from(JRCFG, use_pallas=True,
                                      forward_only=True)
    got = teval.eval_views(tspl, views, rcfg)
    assert len(got.per_view_psnr) == len(got.per_view_ssim) == 2
    for g, w in zip(got.per_view_psnr, want.per_view_psnr):
        assert np.isfinite(g) and abs(g - w) <= 1e-3, (g, w)
    for g, w in zip(got.per_view_ssim, want.per_view_ssim):
        assert abs(g - w) <= 1e-4, (g, w)
    assert abs(got.psnr - want.psnr) <= 1e-3
    assert abs(got.ssim - want.ssim) <= 1e-4
    assert got.per_view_psnr[0] != got.per_view_psnr[1]

    # A capacity far too small: the retry doubles it until the view fits,
    # and the numbers are those of the ample capacity.
    tiny = dataclasses.replace(rcfg, isect_cap=32, expand_k0=1)
    again = teval.eval_views(tspl, views, tiny)
    assert again.per_view_psnr == pytest.approx(got.per_view_psnr, abs=1e-6)
    assert again.per_view_ssim == pytest.approx(got.per_view_ssim, abs=1e-6)
    # The training configuration (f32 payload) evaluates the same image.
    train = teval.eval_views(tspl, views,
                             dataclasses.replace(rcfg, forward_only=False))
    assert train.psnr == pytest.approx(want.psnr, abs=1e-3)
    empty = teval.eval_views(tspl, [], rcfg)
    assert np.isnan(empty.psnr) and empty.per_view_ssim == []


def test_eval_views_of_own_render_and_png(tmp_path):
    """A scene against its own 8-bit render: the error is the rounding of
    the round trip at most (PSNR above 50 dB, SSIM within 1e-3 of 1); with
    `save_dir` one PNG per view holds the evaluated pixels."""
    tspl = convert.splats_from_arrays(_scene(), device=CPU)
    rcfg = convert.render_config_from(JRCFG, use_pallas=True,
                                      forward_only=True)
    folded = tspl.fold_min_scale()
    views = []
    for c in CAMS:
        cam = TCamera(**c)
        img, _ = trender.render(
            *(getattr(folded, k) for k in ("means", "log_scales", "quats",
                                           "sh_coeffs", "raw_opacities")),
            trender.camera_inputs(cam, IMG, device=CPU), torch.zeros(3), rcfg)
        from brush_tpu_torch.ops.loss import pack_gt
        views.append((cam, pack_gt(img[..., :3])))
    stats = teval.eval_views(tspl, views, rcfg, save_dir=str(tmp_path),
                             step=12)
    assert min(stats.per_view_psnr) > 50.0
    assert abs(stats.ssim - 1.0) < 1e-3
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["eval_000012_view000.png", "eval_000012_view001.png"]
    from PIL import Image
    from brush_tpu_torch.ops.loss import unpack_gt
    px = np.asarray(Image.open(tmp_path / files[1]))
    rgb, _ = unpack_gt(views[1][1])
    assert px.shape == (64, 64, 3)
    assert np.abs(px.astype(int) - np.rint(rgb.numpy() * 255).astype(int)
                  ).max() <= 1


# --------------------------------------------------------------------------
# pup_scores, decimate_to_count
# --------------------------------------------------------------------------

N_PROBES = 4


def _jax_hessians(splats, cams, key):
    """The sums `brush_tpu.train.lod.pup_scores` accumulates before its
    log-determinant (lod.py:77-98), with the same keys."""
    folded = splats.fold_min_scale()
    bg = jnp.zeros(3, jnp.float32)

    @jax.jit
    def view_hessian(cam, kv):
        def render_img(m, ls):
            img, _ = jrender.render(m, ls, folded.quats, folded.sh_coeffs,
                                    folded.raw_opacities, cam, bg, JRCFG)
            return img[..., :3]
        _, vjp_fn = jax.vjp(render_img, folded.means, folded.log_scales)
        acc = jnp.zeros((splats.capacity, 6, 6), jnp.float32)
        for k in range(N_PROBES):
            probe = jax.random.normal(jax.random.fold_in(kv, k),
                                      IMG[::-1] + (3,), jnp.float32)
            j = jnp.concatenate(vjp_fn(probe), axis=1)
            acc = acc + j[:, :, None] * j[:, None, :] / N_PROBES
        return acc

    h = jnp.zeros((splats.capacity, 6, 6), jnp.float32)
    probes = {}
    for i, cam in enumerate(cams):
        key, kv = jax.random.split(key)
        h = h + view_hessian(cam, kv)
        for k in range(N_PROBES):
            probes[i, k] = np.asarray(jax.random.normal(
                jax.random.fold_in(kv, k), IMG[::-1] + (3,), jnp.float32))
    return np.asarray(h), probes


def test_pup_scores_match_jax_with_its_probes(monkeypatch):
    splats = _scene(n=48, cap=64)
    jcams = [jrender.camera_inputs(JCamera(**c), IMG) for c in CAMS]
    key = jax.random.PRNGKey(3)
    h_j, probes = _jax_hessians(splats, jcams, key)
    want = np.asarray(jlod.pup_scores(splats, jcams, JRCFG, key,
                                      n_probes=N_PROBES))
    # The mirror above is the package's own sum: same scores from it.
    mirror = np.linalg.slogdet(h_j.astype(np.float64) + 1e-12 * np.eye(6))[1]
    eig = np.linalg.eigvalsh(h_j.astype(np.float64))
    solid = eig[:, 0] > 1e-3 * eig[:, -1]
    assert 10 < solid.sum() < 64
    np.testing.assert_allclose(want[solid], mirror[solid], atol=1e-2)

    tspl = convert.splats_from_arrays(splats, device=CPU)
    tcams = [trender.camera_inputs(TCamera(**c), IMG, device=CPU)
             for c in CAMS]
    rcfg = convert.render_config_from(JRCFG, use_pallas=True)
    asked = []

    def jax_probe(rng, view, probe, shape, device):
        asked.append((view, probe))
        assert tuple(shape) == probes[view, probe].shape
        return torch.from_numpy(probes[view, probe].copy())

    monkeypatch.setattr(tlod, "sample_probes", jax_probe)
    gen = torch.Generator(device=CPU)
    h_t = tlod.pup_hessians(tspl, tcams, rcfg, gen, n_probes=N_PROBES).numpy()
    assert asked == [(v, k) for v in range(2) for k in range(N_PROBES)]
    assert h_t.shape == h_j.shape == (64, 6, 6)
    scale = np.abs(h_j).max(axis=(1, 2))
    assert (scale[:48] > 0).sum() > 30 and not h_t[48:].any()
    assert (np.abs(h_t - h_j).max(axis=(1, 2)) <= 2e-4 * scale + 1e-12).all()
    np.testing.assert_array_equal(h_t, h_t.transpose(0, 2, 1))

    got = tlod.pup_scores(tspl, tcams, rcfg, gen, n_probes=N_PROBES).numpy()
    assert got.shape == (64,)
    np.testing.assert_allclose(got[solid], want[solid], atol=1e-2)
    assert not np.isnan(got).any()
    assert np.isfinite(got[np.isfinite(want) & (scale > 0)]).all()
    # Halving by score keeps the same well-conditioned splats in front.
    keep = int(solid.sum()) // 2
    top_t = set(np.argsort(-np.where(solid, got, -np.inf))[:keep])
    top_j = set(np.argsort(-np.where(solid, want, -np.inf))[:keep])
    assert len(top_t & top_j) >= keep - 1

    with pytest.raises(ValueError, match="forward_only=False"):
        tlod.pup_scores(tspl, tcams,
                        dataclasses.replace(rcfg, forward_only=True), 0)


def test_sample_probes_draw_from_the_generator():
    g = torch.Generator(device=CPU)
    g.manual_seed(5)
    a = tlod.sample_probes(g, 0, 0, (64, 64, 3), CPU)
    b = tlod.sample_probes(g, 0, 1, (64, 64, 3), CPU)
    g.manual_seed(5)
    assert torch.equal(a, tlod.sample_probes(g, 0, 0, (64, 64, 3), CPU))
    assert not torch.equal(a, b) and a.shape == (64, 64, 3)
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1.0) < 0.05
    # A seed in place of a generator gives the same scores twice.
    tspl = convert.splats_from_arrays(_scene(n=16, cap=16), device=CPU)
    cams = [trender.camera_inputs(TCamera(**CAMS[0]), IMG, device=CPU)]
    rcfg = convert.render_config_from(JRCFG, use_pallas=True)
    one = tlod.pup_hessians(tspl, cams, rcfg, 11, n_probes=2)
    two = tlod.pup_hessians(tspl, cams, rcfg, 11, n_probes=2)
    assert torch.equal(one, two) and one.abs().max() > 0


def test_pup_exact_mode_matches_autograd_outer_products(monkeypatch):
    """`exact=True` builds J by central differences of the forward render;
    the same sum by autograd, one unit probe per pixel and channel (scaled
    by sqrt(n_probes) to undo the estimator's mean). The two agree to the
    differences' truncation and rounding, 1e-3 of a splat's largest entry,
    except where a pixel's alpha crosses the 1/255 gate inside the
    difference step: that jump adds a spurious term of order 1 to the
    splat's finite differences (in either package). Two of the three
    splats are free of it."""
    img = (16, 16)
    rng = np.random.default_rng(2)
    n = 3
    spl = tsplats.from_raw(
        rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        np.full((n, 3), np.log(0.3), np.float32),
        np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
        rng.uniform(0.2, 1.0, (n, 1, 3)).astype(np.float32),
        np.full(n, 1.0, np.float32), device=CPU)
    cam = trender.camera_inputs(TCamera(**CAMS[0]), img, device=CPU)
    rcfg = trender.RenderConfig(img_size=img, sh_degree=0, isect_cap=1 << 10,
                                use_pallas=True)
    exact = tlod.pup_hessians(spl, [cam], rcfg, 0, exact=True).numpy()
    n_px = img[0] * img[1] * 3

    def unit_probe(rng, view, probe, shape, device):
        e = torch.zeros(n_px)
        e[probe] = float(np.sqrt(n_px))
        return e.reshape(tuple(shape))

    monkeypatch.setattr(tlod, "sample_probes", unit_probe)
    auto = tlod.pup_hessians(spl, [cam], rcfg, 0, n_probes=n_px).numpy()
    scale = np.abs(auto).max(axis=(1, 2))
    assert (scale > 0).all()
    rel = np.abs(exact - auto).max(axis=(1, 2)) / scale
    assert (rel <= 1e-3).sum() >= 2 and rel.max() < 1.0, rel
    # One view of isotropic splats leaves H close to singular, so its
    # log-determinant is not compared, only taken.
    scores = tlod.pup_scores(spl, [cam], rcfg, 0, exact=True)
    assert scores.shape == (n,) and torch.isfinite(scores).all()


@pytest.mark.parametrize("keep", [20, 48, 200])
def test_decimate_to_count_matches_jax(keep):
    splats = _scene(n=48, cap=64)
    rng = np.random.default_rng(keep)
    scores = rng.normal(0, 5, 64).astype(np.float32)
    scores[5] = -np.inf                       # an unseen splat
    scores[50:] = 99.0                        # dead slots never win
    want = jlod.decimate_to_count(splats, jnp.asarray(scores), keep)
    tspl = convert.splats_from_arrays(splats, device=CPU)
    got = tlod.decimate_to_count(tspl, torch.from_numpy(scores), keep)
    for name in PARAMS + ("min_scale",):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    n_keep = min(keep, 48)
    assert int(got.n_alive) == int(want.n_alive) == n_keep
    assert got.n_alive.dtype == torch.int32
    assert (got.raw_opacities[n_keep:] == tsplats.DEAD_RAW_OPACITY).all()
    # The kept rows are the top-scoring live rows, best first.
    best = np.argsort(-np.where(np.arange(64) < 48, scores, -np.inf),
                      kind="stable")[:n_keep]
    np.testing.assert_array_equal(got.means[:n_keep].numpy(),
                                  np.asarray(splats.means)[best])
    assert int(tspl.n_alive) == 48              # the input is untouched
