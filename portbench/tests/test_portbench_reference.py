"""The reference against the port at a tiny size on the CPU (the port's
kernels run their plain versions there), and its bfloat16 control failing
the cells' limits."""

import numpy as np
import pytest
import torch

from portbench import common
from portbench.reference import camera as C
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.scene import bench_scene
from portbench.traffic import train as T
from portbench.traffic import view as V

W, H = 80, 48


@pytest.fixture(scope="module")
def scene():
    return bench_scene(1500, 7, 3, torch.device("cpu"))


def port_frame(scene, pos):
    from brush_tpu_torch.models.splats import Splats
    from brush_tpu_torch.viewer.service import ViewerState
    from brush_tpu_torch.viewer.slot import Slot
    slot = Slot()
    slot.set(0, Splats(**scene, n_alive=torch.tensor(1500)))
    state = ViewerState(slot, 3, isect_cap=1 << 13, device="cpu")
    return state.render_pose(pos, 0.0, 0.0, W, H, 0, fov=1.0)


@pytest.mark.parametrize("pos", [(0.0, 0.0, -18.0), (10.0, 3.0, 14.0)])
def test_frame_matches_port_and_control_fails(scene, pos):
    view = C.orbit_view(np.array(pos), 1.0, W, H)
    want = R.frame_u8(R.render(scene, view, (0.0,) * 3)[0]).numpy()
    got = port_frame(scene, np.array(pos))
    mean_abs, tile_abs = V.compare_frames(got, want)
    assert mean_abs < 0.05 and tile_abs < 2.0
    lim = common.load_cell("view-1m-1080p")[0]["limits"]
    assert mean_abs <= lim["frame_mean_abs"]
    assert tile_abs <= lim["tile_mean_abs_max"]
    ctl = R.frame_u8(R.render(scene, view, (0.0,) * 3,
                              dtype=torch.bfloat16)[0]).numpy()
    c_mean, c_tile = V.compare_frames(ctl, want)
    assert (c_mean > lim["frame_mean_abs"]
            or c_tile > lim["tile_mean_abs_max"])


def test_train_steps_match_port_and_control_fails():
    from brush_tpu_torch.ops.loss import pack_gt
    from brush_tpu_torch.ops.projection import CameraInputs
    from brush_tpu_torch.models.splats import from_raw
    from brush_tpu_torch.render import RenderConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import init_train_state, train_step
    dev = torch.device("cpu")
    arrays = {k: v.numpy() for k, v in bench_scene(1500, 8, 3, dev).items()}
    teacher = bench_scene(1500, 9, 3, dev)
    views = C.arc_views(3, 0.3, 18.0, (W / 2) / np.tan(0.5), W, H)
    gts = [torch.round(R.render(teacher, v, (0.0,) * 3)[0][..., :3]
                       .clamp(0, 1) * 255) / 255 for v in views]
    seed, cap, order = 2 ** 31 + 5, 4096, [2, 0, 1]
    state = init_train_state(from_raw(**{
        k: arrays[k] for k in ("means", "log_scales", "quats",
                               "raw_opacities")},
        sh_coeffs=arrays["sh_coeffs"], capacity=cap, device="cpu"), seed)
    rcfg = RenderConfig(img_size=(W, H), sh_degree=3, isect_cap=1 << 13,
                        use_pallas=True)
    p0 = {k: v.clone() for k, v in state.splats.params().items()}
    losses = []
    for k, i in enumerate(order):
        v = views[i]
        cam = CameraInputs(
            torch.from_numpy(np.concatenate([v.rot, v.trans[:, None]], 1)
                             .astype(np.float32)),
            torch.tensor([v.fx, v.fy, v.cx, v.cy], dtype=torch.float32),
            torch.tensor(v.clamp_limits(), dtype=torch.float32),
            torch.from_numpy(v.position.astype(np.float32)), 0.0)
        from brush_tpu_torch.train.trainer import SceneBatch
        state, stats, _ = train_step(
            state, SceneBatch(pack_gt(gts[i]), cam), TrainConfig(), rcfg)
        losses.append(float(stats.loss))
        if k == 0:
            g1 = {n: s.moment1 / (1 - RT.BETA1) for n, s in state.opt.items()}
    hp = RT.Hyper(init_isect_cap=1 << 13)
    lim = common.load_cell("train-1m-1080p")[0]["limits"]
    readings = {}
    for name, dt in (("ref", torch.float32), ("control", torch.bfloat16)):
        rs = RT.init_state(arrays, cap, dev)
        res = RT.follow(rs, views, gts, order, seed, hp, dt)
        leaves = T.counted_leaves(res[0].grads)
        readings[name] = dict(
            loss_gap=max(T.gap(a, r.loss, RT.SSIM_WEIGHT)
                         for a, r in zip(losses, res)),
            grad_norm_gap=T.leaf_gaps(g1, res[0].grads, leaves)[0],
            change_norm_gap=T.leaf_gaps(
                {k: state.splats.params()[k] - p0[k] for k in RT.NAMES},
                {k: rs.params[k] - p0[k] for k in RT.NAMES}, leaves)[0])
    ref, ctl = readings["ref"], readings["control"]
    assert ref["loss_gap"] < 1e-4 and ref["grad_norm_gap"] < 1e-4
    assert ref["change_norm_gap"] < 1e-3
    for k, v in ref.items():
        assert v <= lim[k], (k, v)
    assert any(v > lim[k] for k, v in ctl.items()), ctl


@pytest.mark.parametrize("name", ["view-1m-1080p", "train-1m-1080p"])
def test_control_and_faults_fail_the_harness_verdict(name):
    """control.py's readings at a tiny size go through `run.verdict` with
    the cell's own limits, and every variant comes out not correct."""
    from portbench import control
    from portbench.run import verdict
    from portbench.tests.tiny import tiny_cell
    cell, config = tiny_cell(name)
    fn = control.view_control if name.startswith("view") else \
        control.train_control
    got = fn(torch, cell, config, 2 ** 32 + 3, "cpu", control.VARIANTS)
    assert set(got) == set(control.VARIANTS)
    for variant, cmp in got.items():
        assert not verdict(cmp), (variant, cmp)
