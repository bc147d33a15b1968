"""Multi-device training and rendering of `brush_tpu_torch` (parallel/) on
the CPU: gloo groups of W processes (tests/torch_parallel_ranks.py, one
intra-op thread each, a file store, a 60 s collective timeout and a wall
limit on every group), held to the port's one-process path and to the JAX
package's `parallel/` on the conftest's 8 CPU devices.

  * `strip_camera_inputs`: pinholes, clamp limits and strip height equal
    to the JAX package's.
  * `render_space_parallel` of tests/test_tile_parallel.py's scene at W = 2
    and W = 4 (strips wholly below the image included, and a 64x40 image
    whose last two strips are) against the port's full render (atol 1e-6,
    rtol 1e-5, the JAX test's bar) and the JAX package's
    `render_space_parallel` on a mesh of W devices (p99.9 <= 1e-4, max <=
    2/255, the port-against-JAX image rule of tests/test_torch_render.py).
  * Where depth keys tie, strips blend the tied slots in another order
    than the full frame, in both packages: colours move, coverage stays
    within 1e-3 (the strip's key keeps more depth bits, and the clipped
    bounding boxes change the emission order that the stable sort keeps).
  * The DP step (B = 4, tests/test_data_parallel.py's scene) at W = 2 and
    W = 4 against the port's one-process `train_step_impl(batched=True)`
    and against the JAX package's `make_dp_train_step` on W devices (fed
    the JAX noise samples): loss within rtol 1e-5; means, log-scales, SH,
    opacities, the Adam moments and the refine record within rtol 1e-5,
    atol 1e-6; `quats` by the rotation-noise rule (the splats are
    isotropic, so the rotation gradient is rounding noise whose sign,
    and so Adam's step of +-lr, follows the order of the sums); replicas
    bit-identical.
  * 4 DP steps against 4 one-process steps (rtol 2e-2, atol 1e-2, the bar
    of test_dp_multi_step_with_refine; `quats` within 2 lr a step, the
    noise rule), then a refine and one more step: finite, splats alive,
    replicas identical.
  * `view_share` gives the JAX package's device count gcd(B, W): B / gcd
    views to each of the first gcd processes, none to the rest; a gloo
    group of 2 at B = 3 (one process renders all three, the other adds
    zeros) equals the port's one-process batched step and the JAX
    package's batched `train_step_impl` on the same noise samples, and so
    does `train_process(views_per_batch=3)` at W = 2 the one-process run.
  * The backend rule, and one process joining no group.
  * The CLI under `torchrun --nproc-per-node 2` on the CPU.
  * `train_process(views_per_batch=2)` at W = 2 against the one-process
    batched run on the same views: step losses within rtol 1e-5, one
    export (the first process's), replicas identical.
"""

import dataclasses
import functools
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_parallel import RCFG as DP_RCFG
from tests.test_data_parallel import _make_scene
from tests.test_dataset_formats import write_colmap_bin
from tests.torch_parallel_ranks import run_ranks, state_tensors

from brush_tpu.camera import Camera as JCamera
from brush_tpu.parallel import data_parallel as jdp
from brush_tpu.parallel import tile_parallel as jtp
from brush_tpu.render import RenderConfig as JRenderConfig
from brush_tpu.train import trainer as jtrainer
from brush_tpu.train.config import TrainConfig as JTrainConfig
from brush_tpu.train.splat_init import create_random_splats

from brush_tpu_torch import convert
from brush_tpu_torch import process as tprocess
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.data import dataloader as tloader
from brush_tpu_torch.data.formats import LoadConfig
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.parallel import data_parallel as tdp
from brush_tpu_torch.parallel import tile_parallel as ttp
from brush_tpu_torch.process import ProcessConfig
from brush_tpu_torch.train import trainer as ttrainer
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.refine import refine_step

# The module, not the `render` function that brush_tpu/__init__ re-exports.
jrender = importlib.import_module("brush_tpu.render")

CPU = "cpu"
STRIP_CAM = dict(position=np.array([0.0, 0.0, -5.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                 fov_x=0.9, fov_y=0.7)
# tests/test_tile_parallel.py's image (3 tile rows), and one whose last two
# strips of four lie wholly below it.
STRIP_IMAGES = {"96x80": (96, 80), "64x40": (64, 40)}
BG = np.array([0.1, 0.2, 0.3], np.float32)
B = 4
TCFG = dict(total_train_iters=100)
MULTI_STEPS = 4
PARAMS = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacities")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The ranks run one intra-op thread each; so does the one-process
    reference here (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------


def _strip_scene():
    """192 splats of SH degree 1 (tests/test_tile_parallel.py)."""
    splats = create_random_splats(192, [JCamera(**STRIP_CAM)],
                                  np.random.default_rng(0),
                                  scene_scale_override=6.0, sh_degree=1)
    return splats, convert.splats_from_arrays(splats, device=CPU)


def _plane_scene(tied: bool):
    """3,000 opaque splats in front of the camera: all 8 units away (every
    depth key ties), or 0.01 apart from 2 to 32 units, which no key
    truncates to a tie. Both packages' Splats and the camera."""
    from brush_tpu.models import splats as jsplats
    rng = np.random.default_rng(0)
    n = 3000
    z = np.full(n, 8.0) if tied else 2.0 + 0.01 * rng.permutation(n)
    arrays = (np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), z],
                       -1).astype(np.float32),
              np.full((n, 3), np.log(0.15), np.float32),
              np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
              rng.uniform(0, 1, (n, 1, 3)).astype(np.float32),
              np.full(n, 2.0, np.float32))
    cam = dict(position=np.zeros(3), rotation=np.array([1.0, 0, 0, 0]),
               fov_x=0.9, fov_y=0.9)
    return (jsplats.from_raw(*arrays),
            convert.splats_from_arrays(dict(zip(convert.SPLAT_FIELDS,
                                                arrays)), device=CPU), cam)


PLANE_IMG = (256, 256)
PLANE_RCFG = dict(img_size=PLANE_IMG, sh_degree=0, isect_cap=1 << 16,
                  use_pallas=True, forward_only=True)


def _strip_rcfg(img):
    return dict(img_size=img, sh_degree=1, isect_cap=1 << 13,
                max_per_tile=256, use_pallas=True, forward_only=True)


def _dp_scene():
    """tests/test_data_parallel.py's scene with B views: the JAX state and
    batch, and the port's."""
    splats, jbatch = _make_scene(n_views=B)
    jstate = jtrainer.init_train_state(splats, jax.random.PRNGKey(0),
                                       median_scale=3.0)
    tstate = convert.train_state_from_arrays(jstate, seed=0, device=CPU)
    c = jbatch.cam
    tbatch = ttrainer.SceneBatch(
        gt_packed=torch.from_numpy(np.array(jbatch.gt_packed)),
        cam=CameraInputs(*(torch.from_numpy(np.asarray(getattr(c, f)))
                           for f in convert.CAMERA_FIELDS),
                         half_max_render_fov=torch.from_numpy(np.asarray(
                             c.half_max_render_fov, np.float32))))
    return jstate, jbatch, tstate, tbatch


def _jax_noise(jstate, tcfg, n_views=B):
    """The JAX step's background and mean-noise samples for its key."""
    _, k_bg, k_noise = jax.random.split(jstate.rng, 3)
    s = tcfg.background_noise_strength
    return (torch.from_numpy(np.asarray(jax.random.uniform(
                k_bg, (n_views, 3), minval=-s, maxval=s))),
            torch.from_numpy(np.asarray(jax.random.normal(
                k_noise, jstate.splats.means.shape))))


def _first_views(batch, n):
    """The first `n` views of a stacked batch (the port's or the JAX
    package's)."""
    c = batch.cam
    return type(batch)(gt_packed=batch.gt_packed[:n],
                       cam=type(c)(*(x[:n] for x in c)))


def _trcfg():
    return convert.render_config_from(DP_RCFG, use_pallas=True)


def _refine_inputs():
    return (torch.zeros((8, 3)), torch.full((8,), 30.0))


# --------------------------------------------------------------------------
# the groups: each W runs its tasks in one launch
# --------------------------------------------------------------------------


def _group_tasks(world):
    _, tsplats = _strip_scene()
    tasks = {}
    for name, img in STRIP_IMAGES.items():
        tasks[f"strip_{name}"] = dict(
            kind="strip", splats=tsplats, cam=TCamera(**STRIP_CAM), bg=BG,
            rcfg=trender.RenderConfig(**_strip_rcfg(img)))
    for tied in (True, False):
        _, plane, cam = _plane_scene(tied)
        tasks[f"plane_{tied}"] = dict(
            kind="strip", splats=plane, cam=TCamera(**cam),
            bg=np.zeros(3, np.float32),
            rcfg=trender.RenderConfig(**PLANE_RCFG))
    jstate, _, tstate, tbatch = _dp_scene()
    tcfg = TrainConfig(**TCFG)
    common = dict(kind="dp", state=tstate, batch=tbatch, rcfg=_trcfg())
    tasks["dp"] = dict(common, tcfg=tcfg, steps=1)
    tasks["dp_jax"] = dict(common, tcfg=tcfg, steps=1,
                           noise=_jax_noise(jstate, JTrainConfig(**TCFG)))
    if world == 2:
        tasks["dp_multi"] = dict(
            common, tcfg=TrainConfig(**TCFG, refine_every=2),
            steps=MULTI_STEPS, refine=_refine_inputs())
        tasks["dp_3_views"] = dict(
            common, tcfg=tcfg, steps=1, batch=_first_views(tbatch, 3),
            noise=_jax_noise(jstate, JTrainConfig(**TCFG), 3))
    return tasks


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def group(request, tmp_path_factory):
    """(W, {task: [rank results]}) of one launch of W processes."""
    world = request.param
    tasks = _group_tasks(world)
    results = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world,
                        list(tasks.values()))
    return world, {name: [r[i] for r in results]
                   for i, name in enumerate(tasks)}


# --------------------------------------------------------------------------
# strips
# --------------------------------------------------------------------------


@pytest.mark.parametrize("img,n", [((96, 80), 8), ((64, 64), 4),
                                   ((1920, 1080), 2)])
def test_strip_camera_inputs_match_jax(img, n):
    jstack, jh = jtp.strip_camera_inputs(JCamera(**STRIP_CAM), img, n)
    tstack, th = ttp.strip_camera_inputs(TCamera(**STRIP_CAM), img, n,
                                         device=CPU)
    assert th == jh and th % 32 == 0 and n * th >= img[1]
    for f in ("viewmat", "pinhole", "clamp_limits", "cam_pos",
              "half_max_render_fov"):
        got = getattr(tstack, f).numpy()
        want = np.asarray(getattr(jstack, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # cy walks down one strip a strip; the clamp limits stay the image's.
    np.testing.assert_array_equal(np.diff(tstack.pinhole[:, 3].numpy()),
                                  -float(th))


@pytest.mark.parametrize("img", list(STRIP_IMAGES))
def test_render_space_parallel_matches_full_render_and_jax(group, img):
    world, res = group
    size = STRIP_IMAGES[img]
    jsplats, tsplats = _strip_scene()
    cfg = _strip_rcfg(size)
    got = [r for r in res[f"strip_{img}"]]
    for r in got[1:]:
        assert torch.equal(r, got[0]), "processes assembled other frames"
    got = got[0].numpy()
    assert got.shape == (size[1], size[0], 4)

    full, aux = trender.render(
        *tsplats.params().values(),
        trender.camera_inputs(TCamera(**STRIP_CAM), size, device=CPU),
        torch.from_numpy(BG), trender.RenderConfig(**cfg))
    assert int(aux.num_isects) <= cfg["isect_cap"]
    assert float(full[..., 3].max()) > 0.5, "the scene covers the image"
    np.testing.assert_allclose(got, full.numpy(), atol=1e-6, rtol=1e-5)

    mesh = jtp.space_mesh(jax.devices()[:world])
    want = np.asarray(jtp.render_space_parallel(
        jsplats, JCamera(**STRIP_CAM), jnp.asarray(BG),
        JRenderConfig(**cfg), mesh))
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.999) <= 1e-4, np.quantile(diff, 0.999)
    assert diff.max() <= 2.0 / 255.0, diff.max()


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "spread"])
def test_strips_differ_from_the_full_render_only_by_tied_depth_order(
        group, tied):
    """The depth key keeps 32 - bit_length(num_tiles) bits of the depth
    (a strip of fewer tiles keeps more) and a stable sort leaves tied slots
    in emission order, which a strip's clipped bounding boxes change. So
    where depths tie a strip blends them in another order than the full
    frame: colours move, coverage only through the T < 1e-4 stop (alpha
    within 1e-3, the bar chip_smoke.py's space phase holds the 1M-splat
    strips to). The JAX package's strips do the same; spread depths agree
    under the image rule."""
    world, res = group
    jsplats, tsplats, cam = _plane_scene(tied)
    got = res[f"plane_{tied}"][0]
    full, _ = trender.render(
        *tsplats.params().values(),
        trender.camera_inputs(TCamera(**cam), PLANE_IMG, device=CPU),
        torch.zeros(3), trender.RenderConfig(**PLANE_RCFG))
    mesh = jtp.space_mesh(jax.devices()[:world])
    j_strips = np.asarray(jtp.render_space_parallel(
        jsplats, JCamera(**cam), jnp.zeros(3), JRenderConfig(**PLANE_RCFG),
        mesh))
    j_full = np.asarray(jax.jit(lambda *p: jrender.render(
        *p, jrender.camera_inputs(JCamera(**cam), PLANE_IMG), jnp.zeros(3),
        JRenderConfig(**PLANE_RCFG)))(
        jsplats.means, jsplats.log_scales, jsplats.quats, jsplats.sh_coeffs,
        jsplats.raw_opacities)[0])
    for strips, whole in ((got.numpy(), full.numpy()), (j_strips, j_full)):
        d = np.abs(strips - whole)
        assert float(whole[..., 3].mean()) > 0.5, "the plane covers the image"
        assert d[..., 3].max() <= 1e-3, d[..., 3].max()
        if tied:
            assert d[..., :3].max() > 1e-2, "tied depths blend alike"
        else:
            assert np.quantile(d, 0.999) <= 1e-4 and d.max() <= 2.0 / 255.0


# --------------------------------------------------------------------------
# the DP step
# --------------------------------------------------------------------------


def _assert_replicas_equal(per_rank, key="digests"):
    for r in per_rank[1:]:
        assert r[key] == per_rank[0][key], "replicas differ"


def _assert_state_matches(got: dict, want: dict, lr_rotation: float,
                          steps: int = 1):
    """Every tensor of the state within rtol 1e-5, atol 1e-6; the
    rotation by its noise rule."""
    scale_m1 = float(want["opt.log_scales.moment1"].abs().max())
    scale_m2 = float(want["opt.log_scales.moment2"].abs().max())
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "rng":
            assert torch.equal(g, w), "generators differ"
            continue
        if name.startswith(("splats.quats", "opt.quats")):
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # Isotropic splats: the rotation gradient is rounding noise far below
    # the scale gradient, and so are its moments; Adam moves each rotation
    # entry by about lr a step, whichever sign the noise has.
    m1, m2 = want["opt.quats.moment1"], want["opt.quats.moment2"]
    assert float(m1.abs().max()) < 1e-5 * scale_m1
    assert float((got["opt.quats.moment1"] - m1).abs().max()) <= (
        1e-6 * scale_m1)
    assert float((got["opt.quats.moment2"] - m2).abs().max()) <= (
        1e-6 * scale_m2)
    assert float((got["splats.quats"] - want["splats.quats"]).abs().max()) \
        <= 2 * lr_rotation * steps + 1e-6


def _jax_state_tensors(js) -> dict:
    out = {"step": js.step, "median_scale": js.median_scale,
           "splats.n_alive": js.splats.n_alive}
    for name in PARAMS:
        out[f"splats.{name}"] = getattr(js.splats, name)
        out[f"opt.{name}.moment1"] = js.opt[name].moment1
        out[f"opt.{name}.moment2"] = js.opt[name].moment2
    for name in ("refine_weight", "visible_count", "max_radius"):
        out[f"refine.{name}"] = getattr(js.refine, name)
    for name in ("bounds_center", "bounds_extent"):
        out[name] = getattr(js, name)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def test_dp_step_matches_the_one_process_batched_step(group):
    world, res = group
    _, _, tstate, tbatch = _dp_scene()
    tcfg = TrainConfig(**TCFG)
    ref, stats, _ = ttrainer.train_step_impl(tstate, tbatch, tcfg, _trcfg(),
                                             batched=True)
    want = {k: v.cpu() for k, v in state_tensors(ref).items()}
    assert float((want["splats.means"]
                  - tstate.splats.means).abs().max()) > 0
    ranks = res["dp"]
    _assert_replicas_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(stats.loss),
                               rtol=1e-5)
    _assert_state_matches(ranks[0]["state"], want, tcfg.lr_rotation)


def test_dp_step_matches_jax_make_dp_train_step(group):
    world, res = group
    jstate, jbatch, _, _ = _dp_scene()
    jtcfg = JTrainConfig(**TCFG)
    step = jdp.make_dp_train_step(jdp.view_mesh(jax.devices()[:world]),
                                  jtcfg, DP_RCFG, donate=False)
    js2, jstats, _ = step(jstate, jbatch)
    want = _jax_state_tensors(js2)
    ranks = res["dp_jax"]
    _assert_replicas_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(jstats.loss),
                               rtol=1e-5)
    got = {k: v for k, v in ranks[0]["state"].items() if k in want}
    assert set(got) == set(want)
    _assert_state_matches(got, want, jtcfg.lr_rotation)


@pytest.mark.parametrize("group", [2], ids=["W2"], indirect=True)
def test_dp_multi_step_with_refine(group):
    world, res = group
    _, _, tstate, tbatch = _dp_scene()
    tcfg = TrainConfig(**TCFG, refine_every=2)
    ref = tstate
    for _ in range(MULTI_STEPS):
        ref, stats, _ = ttrainer.train_step_impl(ref, tbatch, tcfg, _trcfg(),
                                                 batched=True)
    ranks = res["dp_multi"]
    _assert_replicas_equal(ranks)
    assert all(np.isfinite(ranks[0]["losses"]))
    np.testing.assert_allclose(ranks[0]["losses"][-1], float(stats.loss),
                               rtol=1e-3)
    for name in PARAMS:
        got = ranks[0]["state"][f"splats.{name}"]
        want = getattr(ref.splats, name)
        if name == "quats":
            # Rotation noise: each step may move an entry by lr either way.
            assert float((got - want).abs().max()) <= (
                2 * tcfg.lr_rotation * MULTI_STEPS + 1e-6)
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                                   atol=1e-2, err_msg=name)
    # The refine and the step after it, on every replica alike.
    _assert_replicas_equal(ranks, "refined_digest")
    after = [r["after_refine"] for r in ranks]
    assert all(a == after[0] for a in after)
    assert after[0]["n_alive"] > 0 and after[0]["finite"]
    assert np.isfinite(after[0]["loss"])
    # The one-process refine of the one-process state runs too.
    refined, _ = refine_step(ref, tcfg, *_refine_inputs())
    assert int(refined.splats.n_alive) > 0


@pytest.mark.parametrize("group", [2], ids=["W2"], indirect=True)
def test_dp_step_refuses_a_world_that_does_not_divide_the_batch(
        group, monkeypatch):
    """A world that does not divide the batch is no longer refused: at
    B = 3, W = 2 the JAX package's gcd(B, W) = 1 process renders the three
    views and the other adds zeros. Both hold the state of the port's
    one-process batched step and of the JAX package's batched
    `train_step_impl`, fed the same noise samples."""
    world, res = group
    ranks = res["dp_3_views"]
    assert all("error" not in r for r in ranks), ranks
    _assert_replicas_equal(ranks)
    jstate, jbatch, tstate, tbatch = _dp_scene()
    jtcfg = JTrainConfig(**TCFG)
    bg, mean = _jax_noise(jstate, jtcfg, 3)
    monkeypatch.setattr(ttrainer, "sample_background_noise",
                        lambda rng, n, s, d: bg.clone().to(d))
    monkeypatch.setattr(ttrainer, "sample_mean_noise",
                        lambda rng, shape, d: mean.clone().to(d))
    tcfg = TrainConfig(**TCFG)
    ref, stats, _ = ttrainer.train_step_impl(
        tstate, _first_views(tbatch, 3), tcfg, _trcfg(), batched=True)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(stats.loss),
                               rtol=1e-5)
    _assert_state_matches(
        {k: v for k, v in ranks[0]["state"].items() if k != "rng"},
        {k: v.cpu() for k, v in state_tensors(ref).items() if k != "rng"},
        tcfg.lr_rotation)
    js2, jstats, _ = jax.jit(lambda s, b: jtrainer.train_step_impl(
        s, b, jtcfg, DP_RCFG, batched=True))(jstate,
                                             _first_views(jbatch, 3))
    np.testing.assert_allclose(ranks[0]["losses"][0], float(jstats.loss),
                               rtol=1e-5)
    want = _jax_state_tensors(js2)
    _assert_state_matches({k: ranks[0]["state"][k] for k in want}, want,
                          jtcfg.lr_rotation)


@pytest.mark.parametrize("views,world", [(3, 2), (6, 4), (4, 2)])
def test_view_share_gives_the_jax_device_count(monkeypatch, views, world):
    """`view_share` of B views over W processes: the JAX package trains on
    gcd(B, devices) devices (brush_tpu/process.py:239); here the first
    gcd processes render B / gcd views each, in order, and the rest none."""
    import math

    class Group:
        rank = 0
    monkeypatch.setattr(tdp.dist, "get_world_size", lambda g: world)
    monkeypatch.setattr(tdp.dist, "get_rank", lambda g: g.rank)
    shares = []
    for r in range(world):
        g = Group()
        g.rank = r
        shares.append(tdp.view_share(g, views))
    sharing = math.gcd(views, world)
    assert sum(1 for s in shares if s.count) == sharing
    rows = []
    for r, s in enumerate(shares):
        assert s.total == views and s.group is not None
        assert s.count == (views // sharing if r < sharing else 0)
        rows += list(range(s.first, s.first + s.count))
    assert rows == list(range(views))
    assert tdp.view_share(None, views) == ttrainer.ViewShare(
        first=0, total=views, count=views)


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo")])
def test_backend_rule(monkeypatch, device, local_world, cards, want):
    """gloo on the CPU and where processes share a card, NCCL where each
    has its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tdp.choose_backend(torch.device(device), local_world) == want


def test_one_process_joins_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tdp.view_group(CPU) == (None, 1, torch.device(CPU))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdp.view_group(CPU) == (None, 1, torch.device(CPU))


# --------------------------------------------------------------------------
# train_process over two processes
# --------------------------------------------------------------------------


def _process_configs(tmp, tag):
    tcfg = TrainConfig(total_train_iters=4, refine_every=1000)
    lcfg = LoadConfig(max_resolution=64)
    pcfg = ProcessConfig(eval_every=0, export_every=0, log_every=1,
                         export_path=str(tmp / f"{tag}_{{iter}}.ply"),
                         sh_degree=1, use_pallas=True, views_per_batch=2,
                         init_isect_cap=1 << 14)
    return tcfg, lcfg, pcfg


def test_train_process_over_two_processes(tmp_path, monkeypatch):
    """B = 2 and B = 3 a step at W = 2 (at B = 3 one process renders the
    three views, gcd(3, 2) = 1), each against the one-process run."""
    scene = tmp_path / "scene"
    write_colmap_bin(scene, n_views=4, w=64, h=64)
    tcfg, lcfg, pcfg = _process_configs(tmp_path, "dp")
    three = dataclasses.replace(pcfg, views_per_batch=3,
                                export_path=str(tmp_path / "dp3_{iter}.ply"))
    ranks = run_ranks(tmp_path / "ranks", 2, [
        dict(kind="process", source=str(scene), tcfg=tcfg, lcfg=lcfg,
             pcfg=three),
        dict(kind="process", source=str(scene), tcfg=tcfg, lcfg=lcfg,
             pcfg=pcfg)])
    ranks_3 = [r[0] for r in ranks]
    ranks = [r[1] for r in ranks]

    monkeypatch.setattr(tprocess, "SceneLoader",
                        functools.partial(tloader.SceneLoader, n_threads=1))
    tcfg1, lcfg1, pcfg1 = _process_configs(tmp_path, "one")
    for got_ranks, views in ((ranks_3, 3), (ranks, 2)):
        one = list(tprocess.train_process(
            str(scene), tcfg1, lcfg1,
            dataclasses.replace(pcfg1, views_per_batch=views), device=CPU))
        want = [m.data["loss"] for m in one if m.kind == "step"]
        for r in got_ranks:
            assert "error" not in r, r
            got = [d["loss"] for k, _, d in r["messages"] if k == "step"]
            assert len(got) == len(want) == 4
            np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ranks_3[0]["digest"] == ranks_3[1]["digest"]
    assert ranks_3[1]["exports"] == []
    assert ranks[0]["exports"] == [pcfg.export_path.format(iter=4)]
    assert ranks[1]["exports"] == []
    assert (tmp_path / "dp_4.ply").is_file()
    assert [k for k, _, _ in ranks[1]["messages"]] == ["step"] * 4
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_cli_under_torchrun_on_the_cpu(tmp_path):
    """`torchrun --nproc-per-node 2 -m brush_tpu_torch.cli <scene>
    --views-per-batch 2 --device cpu`: gloo, one process's output and one
    export, within a wall limit."""
    import os
    import subprocess
    import sys
    scene = tmp_path / "scene"
    write_colmap_bin(scene, n_views=4, w=64, h=64)
    export = tmp_path / "cli_{iter}.ply"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(pathlib.Path(__file__).parent.parent))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "brush_tpu_torch.cli", str(scene),
         "--views-per-batch", "2", "--device", "cpu",
         "--total-train-iters", "2", "--log-every", "1", "--sh-degree", "1",
         "--max-resolution", "64", "--export-path", str(export)],
        capture_output=True, text=True, timeout=180, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("2 processes over gloo, 1 views each") == 1
    assert out.stdout.count("loss=") == 2, out.stdout
    assert out.stdout.count("exported") == 1
    assert (tmp_path / "cli_2.ply").is_file()
