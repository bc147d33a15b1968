"""Training from fisheye views (KannalaBrandt4, COLMAP's OPENCV_FISHEYE)
through `brush_tpu_torch`'s normal path, on the CPU:

  * `train_process` on a tiny OPENCV_FISHEYE COLMAP dataset hands the
    dataset's lens to every turn, to eval and to the LOD bake's scoring
    and steps, and counts `run.lens.kb4` a turn; its first step's loss is
    `train_step` with that lens, and not the step with a pinhole;
  * a pinhole dataset's RenderConfigs and first step are unchanged;
  * the port's KB4 render, loss and gradients equal the benchmark's plain
    reference (`portbench/reference/lens.py` through its renderer and
    training step) on seeded scenes;
  * the reference's hand-written KB4 Jacobian equals the port's
    `projection_jacobian` (forward-mode AD) and autograd on the
    reference's own projection, near the axis and near the cull too.
"""

import dataclasses
import functools
import math
import struct

import numpy as np
import pytest
import torch

from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch import process as tprocess
from brush_tpu_torch.camera import (
    Camera,
    KannalaBrandt4,
    Pinhole,
    focal_to_fov,
)
from brush_tpu_torch.data import dataloader as tloader
from brush_tpu_torch.data.formats import LoadConfig
from brush_tpu_torch.io import ply as tply
from brush_tpu_torch.models import splats as tsplats
from brush_tpu_torch.ops import camera_proj
from brush_tpu_torch.render import RenderConfig, camera_inputs, render
from brush_tpu_torch.train import eval as teval
from brush_tpu_torch.train import lod as tlod
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.trainer import train_step
from brush_tpu_torch.utils import tracing
from portbench.dataset import _c2w_to_w2c_quat
from portbench.reference import camera as C
from portbench.reference import lens as L
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.scene import bench_scene

CPU = "cpu"
K = (-0.03, -0.004, 0.0006, -0.0001)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init_ply(root, n=80):
    """Splats in front of write_colmap_bin's cameras (at z = 4 looking
    down +z), out to 50 degrees off their axis."""
    rng = np.random.default_rng(7)
    z = rng.uniform(6.0, 10.0, (n, 1))
    means = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)) * z * 0.4, z + 4],
                           1)
    splats = tsplats.from_raw(
        means.astype(np.float32),
        np.log(rng.uniform(0.2, 0.5, (n, 3))).astype(np.float32),
        rng.normal(0, 1, (n, 4)).astype(np.float32),
        rng.normal(0, 0.5, (n, 4, 3)).astype(np.float32),
        rng.normal(1.0, 1.0, n).astype(np.float32), device=CPU)
    (root / "init.ply").write_bytes(tply.splats_to_ply_bytes(splats))


def _pinhole_scene(root, w=32, h=32):
    write_colmap_bin(root, w=w, h=h)
    _init_ply(root)


def _fisheye_scene(root, w=32, h=32, focal=20.0):
    """`_pinhole_scene` with its camera an OPENCV_FISHEYE of focal
    `focal` and coefficients K."""
    _pinhole_scene(root, w, h)
    with open(root / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 5, w, h))          # OPENCV_FISHEYE
        f.write(struct.pack("<8d", focal, focal, w / 2, h / 2, *K))


def _spy(monkeypatch, module, name, seen, pick):
    real = getattr(module, name)

    @functools.wraps(real)
    def wrapped(*args, **kwargs):
        seen.append(pick(*args, **kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapped)


def _one_thread_loader(monkeypatch):
    monkeypatch.setattr(tprocess, "SceneLoader", functools.partial(
        tloader.SceneLoader, n_threads=1))


def test_train_process_hands_the_dataset_lens_to_steps_eval_and_lod(
        tmp_path, monkeypatch):
    _fisheye_scene(tmp_path / "scene")
    _one_thread_loader(monkeypatch)
    turns, evals, scoring, lod_steps = [], [], [], []
    _spy(monkeypatch, tprocess, "_step_turn", turns,
         lambda loop, *a, **k: loop.rcfg)
    _spy(monkeypatch, teval, "_eval_step", evals, lambda *a: a[-1])
    _spy(monkeypatch, tlod, "pup_scores", scoring, lambda s, c, rcfg, *a,
         **k: rcfg)
    _spy(monkeypatch, tprocess, "train_step", lod_steps,
         lambda state, batch, tcfg, rcfg: rcfg)
    tcfg = TrainConfig(total_train_iters=4, refine_every=1000, lod_levels=1,
                       lod_refine_steps=2)
    pcfg = tprocess.ProcessConfig(
        eval_every=4, export_every=0, log_every=2, init_count=50,
        sh_degree=1, use_pallas=False,
        export_path=str(tmp_path / "out_{iter}.ply"))
    with tracing.record_stages() as rec:
        msgs = list(tprocess.train_process(
            str(tmp_path / "scene"), tcfg,
            LoadConfig(max_resolution=32, eval_split_every=4), pcfg,
            device=CPU))
        counters = rec.snapshot()["counters"]
    lens = KannalaBrandt4(*K)
    assert [m.kind for m in msgs].count("eval") == 1
    assert len(turns) == 4 and len(evals) == 1
    assert len(scoring) == 1 and len(lod_steps) == 2
    for rcfg in turns + evals + scoring + lod_steps:
        assert rcfg.model == lens
    assert counters["run.lens.kb4"] == 4
    assert "run.lens.pinhole" not in counters
    assert counters["project.lens.kb4"] >= 4


def _first_step(tmp_path, monkeypatch, scene_fn):
    """The first turn of `train_process` on the scene `scene_fn` writes:
    (its loss, the state and batch it started from, its RenderConfig)."""
    scene_fn(tmp_path / "scene")
    _one_thread_loader(monkeypatch)
    got = {}
    real = tprocess._step_turn

    def first(loop, batch, *args, **kwargs):
        if not got:
            state = loop.state
            rng = torch.Generator(device=CPU)
            rng.set_state(state.rng.get_state())
            got.update(state=dataclasses.replace(state, rng=rng),
                       batch=batch, rcfg=loop.rcfg)
        return real(loop, batch, *args, **kwargs)
    monkeypatch.setattr(tprocess, "_step_turn", first)
    pcfg = tprocess.ProcessConfig(
        eval_every=0, export_every=0, log_every=1, init_count=50,
        sh_degree=1, export_path=str(tmp_path / "out_{iter}.ply"))
    msgs = list(tprocess.train_process(
        str(tmp_path / "scene"), TrainConfig(total_train_iters=1,
                                             refine_every=1000),
        LoadConfig(max_resolution=32), pcfg, device=CPU))
    loss = next(m.data["loss"] for m in msgs if m.kind == "step")
    return loss, got


def test_first_step_is_the_kb4_step_and_not_the_pinhole_step(
        tmp_path, monkeypatch):
    loss, got = _first_step(tmp_path, monkeypatch, _fisheye_scene)
    assert got["rcfg"].model == KannalaBrandt4(*K)

    def step(model):
        rng = torch.Generator(device=CPU)
        rng.set_state(got["state"].rng.get_state())
        state = dataclasses.replace(got["state"], rng=rng)
        _, stats, _ = train_step(state, got["batch"], TrainConfig(),
                                 dataclasses.replace(got["rcfg"],
                                                     model=model))
        return float(stats.loss)
    assert step(KannalaBrandt4(*K)) == pytest.approx(loss, rel=1e-6)
    assert abs(step(Pinhole()) - loss) > 1e-4 * abs(loss)


def test_pinhole_dataset_configs_and_first_step_are_unchanged(
        tmp_path, monkeypatch):
    loss, got = _first_step(tmp_path, monkeypatch, _pinhole_scene)
    pcfg = tprocess.ProcessConfig()
    # The RenderConfig the turn had before lenses were carried.
    before = RenderConfig(img_size=(32, 32), sh_degree=1,
                          isect_cap=pcfg.init_isect_cap,
                          chunk_cap=pcfg.init_chunk_cap,
                          use_pallas=pcfg.use_pallas)
    assert got["rcfg"] == before and hash(got["rcfg"]) == hash(before)
    _, stats, _ = train_step(got["state"], got["batch"], TrainConfig(),
                             before)
    assert float(stats.loss) == loss


# --------------------------------------------------------------------------
# the port against the benchmark's plain reference
# --------------------------------------------------------------------------


def _view_and_camera(rad, w=88, h=60, focal=40.0, step=0.3, i=1):
    v = L.fisheye(C.arc_views(3, step, rad, focal, w, h)[i], K)
    fov_x, fov_y = v.fov()
    cam = Camera(position=v.position, rotation=_c2w_to_w2c_quat(v.rot.T),
                 fov_x=fov_x, fov_y=fov_y, model=KannalaBrandt4(*K))
    return v, cam


def _scene(n, seed):
    s = bench_scene(n, seed, 3, CPU)
    s["means"] = s["means"] * 0.5
    return s


@pytest.mark.parametrize("seed,radius", [(3, 9.0), (4, 6.0)])
def test_port_kb4_render_matches_the_reference(seed, radius):
    scene = _scene(600, seed)
    v, cam = _view_and_camera(radius)
    with L.through_lens():
        want, _ = R.render(scene, v, (0.1, 0.2, 0.3))
    rcfg = RenderConfig(img_size=(v.width, v.height), sh_degree=3,
                        model=cam.model, isect_cap=1 << 14, use_pallas=True,
                        forward_only=True)
    got, _ = render(*(scene[k] for k in (
        "means", "log_scales", "quats", "sh_coeffs", "raw_opacities")),
        camera_inputs(cam, rcfg.img_size, device=CPU),
        torch.tensor([0.1, 0.2, 0.3]), rcfg)
    # The two round differently, so a splat whose alpha is at the 1/255
    # cutoff at a pixel may blend there in one and not the other: a pixel
    # may differ by that splat's alpha, about 1/255, and few do.
    diff = (got - want).abs()
    assert float(diff.max()) < 5e-3
    assert float(diff.mean()) < 1e-4
    assert float(want[..., 3].mean()) > 0.05


@pytest.mark.parametrize("seed", [5, 6])
def test_port_kb4_loss_and_gradients_match_the_reference(seed):
    scene = _scene(500, seed)
    v, cam = _view_and_camera(7.0)
    gt = torch.rand((v.height, v.width, 3),
                    generator=torch.Generator().manual_seed(seed))
    bg = torch.tensor([0.05, 0.1, 0.0])
    with L.through_lens():
        ref_loss, ref_grads, _ = RT.loss_and_grads(scene, v, gt, bg)
    leaves = {k: scene[k].clone().requires_grad_(True) for k in RT.NAMES}
    rcfg = RenderConfig(img_size=(v.width, v.height), sh_degree=3,
                        model=cam.model, isect_cap=1 << 14, use_pallas=True)
    img, _ = render(leaves["means"], leaves["log_scales"], leaves["quats"],
                    leaves["sh_coeffs"], leaves["raw_opacities"],
                    camera_inputs(cam, rcfg.img_size, device=CPU), bg, rcfg)
    loss = RT.image_loss(img[..., :3], gt)
    loss.backward()
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for k in RT.NAMES:
        ref = ref_grads[k]
        scale = max(float(ref.norm()), 1e-12)
        assert float((leaves[k].grad - ref).norm()) <= 2e-3 * scale, k


def _points(n, seed):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn((n, 3), generator=g, dtype=torch.float64)
    p[:, 2] = p[:, 2].abs() + 0.3
    return p


def _at_angle(theta, n, seed):
    """Points `theta` off the axis at random azimuths and depths."""
    g = torch.Generator().manual_seed(seed)
    phi = torch.rand(n, generator=g, dtype=torch.float64) * 2 * math.pi
    dist = 0.5 + torch.rand(n, generator=g, dtype=torch.float64) * 5
    r = dist * math.sin(theta)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        dist * math.cos(theta)], -1)


@pytest.mark.parametrize("where", ["spread", "near_axis", "near_cull"])
def test_reference_kb4_jacobian_matches_the_port_and_autograd(where):
    fx, fy, cx, cy = 790.0, 788.0, 876.0, 584.0
    v = L.FisheyeView(np.eye(3), np.zeros(3), np.zeros(3), fx, fy, cx, cy,
                      1752, 1168, K)
    if where == "spread":
        p = _points(400, 1)
    elif where == "near_axis":
        p = _points(200, 2)
        p[:, :2] *= 1e-7
        p[:100, :2] *= 100.0          # just past the pinhole fallback
    else:
        p = _at_angle(v.half_max_render_fov() - 1e-3, 200, 3)
    jac = L.kb4_jacobian(p[:, 0], p[:, 1], p[:, 2], fx, fy, K)

    def proj(q):
        u, w = L.kb4_project(q[0:1], q[1:2], q[2:3], fx, fy, cx, cy, K)
        return torch.cat([u, w])
    auto = torch.stack([torch.autograd.functional.jacobian(proj, q)
                        for q in p])
    scale = jac.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((jac - auto).abs() / scale).max()) < 1e-9
    port = camera_proj.projection_jacobian(
        p.float(), torch.tensor([fx, fy, cx, cy]),
        torch.tensor([-1e30, 1e30, -1e30, 1e30]), KannalaBrandt4(*K))
    assert float(((port.double() - jac).abs() / scale).max()) < 2e-5


def test_reference_field_of_view_is_the_port_camera_s():
    """The reference's field from its focal equals the port's (COLMAP's
    focal through `focal_to_fov`), and so does the render field's cull."""
    v = L.fisheye(C.arc_views(1, 0.3, 8.0, 790.0, 1752, 1168)[0], K)
    fov_x, fov_y = v.fov()
    assert fov_x == pytest.approx(
        focal_to_fov(790.0, 1752, KannalaBrandt4(*K)), abs=1e-9)
    assert fov_y == pytest.approx(
        focal_to_fov(790.0, 1168, KannalaBrandt4(*K)), abs=1e-9)
    cam = Camera(position=v.position, rotation=np.array([1.0, 0, 0, 0]),
                 fov_x=fov_x, fov_y=fov_y, model=KannalaBrandt4(*K))
    assert cam.half_max_render_fov() == pytest.approx(
        v.half_max_render_fov(), abs=1e-9)
    assert fov_x > 1.9
