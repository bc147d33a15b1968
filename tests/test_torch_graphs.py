"""The compiled, donated step and frame of `brush_tpu_torch/graphs.py` on
the CPU, where no graph is captured:

  * `StepGraph` and `RenderGraph` raise on CPU tensors (the CPU path is the
    plain eager functions), and on the plain rasterizer's configuration;
    so do `RefineGraph`, `RefineGraphs` and `FnGraph` (the scoring views,
    the strips) on CPU tensors, and a StepGraph of a step shared over
    gloo, whose collectives a capture cannot hold;
  * `refine_body`, the refine a RefineGraph captures (`refine_step`, its
    new state written into the donated state's own tensors), equals
    `refine_step` bit for bit, the generator too, and hands back the
    donated tensors (the 3D filter floor of a first refine its own);
  * `step_body`, the step a StepGraph captures (`train_step_impl`, then the
    new state copied into the state's own tensors), run eagerly with the
    graph's protocol (`load_into` of a state that is not its own,
    `copy_out` of the statistics and aux) equals `train_step_impl` bit for
    bit over 4 steps: one with the generator's draws, an overflowing one
    (the no-op gate), one after a refine whose new state is copied in, and
    one more; and one such step stays within tests/test_torch_loss.py's
    rules of the JAX package's jitted `train_step_impl`;
  * step k's copied-out aux survives step k+1;
  * `step_key` holds the JAX `step_cache` key's fields and the step's
    share (rank, world, backend), and a key change frees the cached graph
    (`StepGraphs`, `RefineGraphs`, `RenderGraphs`).

The graphs themselves are held to the eager path on the card
(tests/test_torch_cuda.py and `python3 chip_smoke.py`).
"""

import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from brush_tpu.train import trainer as jtrainer
from brush_tpu.train.config import TrainConfig as JTrainConfig
from tests.test_torch_loss import (
    CAM,
    IMG,
    JRCFG,
    LOSS_RTOL,
    _assert_step_matches,
    _both_states,
    _setup,
)

from brush_tpu_torch import convert, graphs
from brush_tpu_torch import render as trender
from brush_tpu_torch.camera import Camera as TCamera
from brush_tpu_torch.ops import loss as tloss
from brush_tpu_torch.train import refine as trefine
from brush_tpu_torch.train import splat_init as tinit
from brush_tpu_torch.train import trainer as ttrainer
from brush_tpu_torch.train.config import TrainConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _scene(seed=4, n=48, cap=128):
    """`n` random splats in a capacity of `cap`, a gradient image as ground
    truth, the state seeded with `seed`."""
    rng = np.random.default_rng(seed)
    splats = tinit.create_random_splats(
        n, [TCamera(**CAM)], rng, scene_scale_override=6.0, sh_degree=0,
        capacity=cap, device=CPU)
    y, x = np.mgrid[0:IMG[1], 0:IMG[0]]
    gt = np.stack([x / 64, y / 64, 0.5 * np.ones_like(x)], -1)
    batch = ttrainer.SceneBatch(
        gt_packed=tloss.gt_tensor(tloss.pack_gt(gt.astype(np.float32)),
                                  device=CPU),
        cam=trender.camera_inputs(TCamera(**CAM), IMG, device=CPU))
    return ttrainer.init_train_state(splats, seed), batch


def _twin(state):
    rng = torch.Generator(device=CPU)
    rng.set_state(state.rng.get_state())
    return dataclasses.replace(graphs.copy_out(state), rng=rng)


def _assert_same_bits(a, b, what):
    la, lb = graphs._leaves(a), graphs._leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, path)
            xi = x.view(torch.int32) if x.dtype == torch.float32 else x
            yi = y.view(torch.int32) if y.dtype == torch.float32 else y
            assert torch.equal(xi, yi), (what, path)
        else:
            assert x == y, (what, path)


def _rcfg(isect_cap=1 << 13, expand_k0=4):
    return trender.RenderConfig(img_size=IMG, sh_degree=0,
                                isect_cap=isect_cap, expand_k0=expand_k0,
                                use_pallas=True)


def test_graphs_raise_on_the_cpu():
    state, batch = _scene()
    tcfg = TrainConfig(total_train_iters=100)
    with pytest.raises(RuntimeError, match="card only"):
        graphs.StepGraph(tcfg, _rcfg())(state, batch)
    with pytest.raises(RuntimeError, match="card only"):
        graphs.StepGraphs(tcfg)(state, batch, _rcfg())
    s = state.splats
    fwd = dataclasses.replace(_rcfg(), forward_only=True)
    with pytest.raises(RuntimeError, match="card only"):
        graphs.RenderGraph(fwd, s.capacity)(
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities,
            batch.cam, torch.zeros(3))
    plain = dataclasses.replace(_rcfg(), use_pallas=False)
    with pytest.raises(ValueError, match="use_pallas=True"):
        graphs.StepGraph(tcfg, plain)
    with pytest.raises(ValueError, match="use_pallas=True"):
        graphs.RenderGraph(plain, s.capacity)
    with pytest.raises(ValueError, match="differentiable"):
        graphs.StepGraph(tcfg, fwd)


def test_step_body_equals_train_step_impl_bit_for_bit():
    """Four steps and a refine, eager against the graph's protocol run
    eagerly: the same bits in every state tensor, statistic, aux field and
    the generator after every step."""
    state0, batch = _scene()
    tcfg = TrainConfig(total_train_iters=100, growth_grad_threshold=1e-9,
                       growth_select_fraction=1.0)
    no_views = (torch.zeros((0, 3)), torch.zeros(0))
    # (render config, refine before the step): the second step overflows
    # its one remainder slot and is a no-op, the third comes after a refine.
    plan = [(_rcfg(), False), (_rcfg(1, 1), False), (_rcfg(), True),
            (_rcfg(), False)]
    eager = _twin(state0)
    own = _twin(state0)                  # the graph's own state
    state = own
    kept = []
    for rcfg, refine in plan:
        if refine:
            eager, _ = trefine.refine_step(eager, tcfg, *no_views)
            state, rstats = trefine.refine_step(state, tcfg, *no_views)
            assert int(rstats.num_added) > 0
        e_state, e_stats, e_aux = ttrainer.train_step_impl(
            eager, batch, tcfg, rcfg)
        # The graph's own state is stepped from as it is; the refine's new
        # state is copied in.
        written = graphs.load_into(dataclasses.replace(own, rng=None),
                                   dataclasses.replace(state, rng=None))
        assert (written > 0) == refine
        stats, aux = graphs.copy_out(graphs.step_body(own, batch, tcfg, rcfg))
        state = own
        kept.append((aux, e_aux, bool(e_stats.overflowed)))
        _assert_same_bits(dataclasses.replace(own, rng=None),
                          dataclasses.replace(e_state, rng=None), "state")
        _assert_same_bits(stats, e_stats, "stats")
        _assert_same_bits(aux, e_aux, "aux")
        assert torch.equal(own.rng.get_state(), e_state.rng.get_state())
        eager = e_state
    assert [o for _, _, o in kept] == [False, True, False, False]
    # Step k's copied-out aux is still step k's after step k+1.
    for aux, e_aux, _ in kept:
        _assert_same_bits(aux, e_aux, "aux kept")
    assert int(own.step) == 4


def test_step_body_matches_jax_train_step_impl():
    """One step of the graph's body, noise off, against the JAX package's
    jitted `train_step_impl`, under test_torch_loss.py's rules."""
    splats, jbatch, tbatch = _setup()
    jtcfg = JTrainConfig(total_train_iters=100, background_noise_strength=0.0,
                         mean_noise_weight=0.0,
                         background_color=(0.1, 0.2, 0.3))
    ttcfg = convert.train_config_from(jtcfg)
    trcfg = convert.render_config_from(JRCFG, use_pallas=True)
    jstate, tstate = _both_states(splats, 0)
    js2, jstats, jaux = jax.jit(lambda s, b: jtrainer.train_step_impl(
        s, b, jtcfg, JRCFG))(jstate, jbatch)
    own = _twin(tstate)
    stats, aux = graphs.copy_out(graphs.step_body(own, tbatch, ttcfg, trcfg))
    assert abs(float(stats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
        float(jstats.loss))
    assert int(aux.num_isects) == int(jaux.num_isects)
    assert int(own.step) == int(js2.step) == 1
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    _assert_step_matches(js2, own, jstate, lrs)


def test_copy_out_and_load_into():
    """`copy_out` gives fresh buffers with the same bits; `load_into` writes
    only where the buffers differ, fills a number into a 0-d tensor and
    refuses another layout."""
    state, batch = _scene()
    fresh = graphs.copy_out(batch)
    for (_, a), (_, b) in zip(graphs._leaves(fresh), graphs._leaves(batch)):
        if torch.is_tensor(a):
            assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    own = graphs._static_batch(batch, CPU)
    assert torch.is_tensor(own.cam.half_max_render_fov)
    assert graphs.load_into(own, own) == 0
    other = batch._replace(cam=batch.cam._replace(half_max_render_fov=0.25))
    assert graphs.load_into(own, other) == 6
    assert float(own.cam.half_max_render_fov) == 0.25
    assert torch.equal(own.gt_packed, batch.gt_packed)
    with pytest.raises(ValueError, match="where the graph holds"):
        graphs.load_into(dataclasses.replace(state, rng=None),
                         dataclasses.replace(state, rng=None,
                                             bounds_center=None))
    with pytest.raises(ValueError, match="against the graph's"):
        graphs.load_into(own, batch._replace(gt_packed=batch.gt_packed[:2]))


def _jax_step_cache_key_fields() -> list:
    """The names in brush_tpu/process.py's `step_cache` key tuple."""
    src = (REPO / "brush_tpu" / "process.py").read_text()
    m = re.search(r"key = \(([^)]*)\)\n\s+if key not in step_cache", src)
    assert m, "the JAX step_cache key was not found"
    return [x.strip().split(".")[-1] for x in m.group(1).split(",")]


def test_step_key_has_the_jax_step_cache_fields(monkeypatch):
    fields = _jax_step_cache_key_fields()
    assert fields == ["img_size", "has_alpha", "alpha_is_mask", "isect_cap",
                      "chunk_cap", "capacity"]
    assert list(graphs.StepKey._fields[:len(fields)]) == fields
    state, batch = _scene()
    rcfg = dataclasses.replace(_rcfg(), chunk_cap=1 << 15)
    key = graphs.step_key(state, rcfg, True, False)
    assert tuple(key[:6]) == (IMG, True, False, 1 << 13, 1 << 15, 128)

    made = []

    class FakeGraph:
        def __init__(self, tcfg, rcfg, has_alpha, alpha_is_mask, batched,
                     lpips_model, share=None):
            made.append(self)

        def __call__(self, state, batch):
            return state, None, None

    monkeypatch.setattr(graphs, "StepGraph", FakeGraph)
    steps = graphs.StepGraphs(TrainConfig())
    steps(state, batch, rcfg)
    first = steps.graph
    steps(state, batch, rcfg)
    assert steps.graph is first and steps.captures == 1
    # Each key change frees the graph for a new one: isect_cap growth, a
    # new image size, capacity growth, the refine's 3D filter floor.
    grown = dataclasses.replace(rcfg, isect_cap=1 << 14)
    steps(state, batch, grown)
    assert steps.graph is not first and steps.key.isect_cap == 1 << 14
    from brush_tpu_torch.process import _grow_state
    steps(_grow_state(state, 256), batch, grown)
    assert steps.key.capacity == 256
    floored = dataclasses.replace(state, splats=dataclasses.replace(
        state.splats, min_scale=torch.zeros(128)))
    steps(floored, batch, grown)
    assert len(made) == steps.captures == 4
    steps.clear()
    assert steps.graph is None and steps.key is None


def test_render_graphs_keep_two():
    cache = graphs.RenderGraphs(2)
    cfgs = [dataclasses.replace(_rcfg(), forward_only=True, isect_cap=c)
            for c in (1 << 10, 1 << 11, 1 << 12)]
    a = cache.get(trender.render, cfgs[0], 128)
    assert cache.get(trender.render, cfgs[0], 128) is a
    cache.get(trender.render, cfgs[1], 128)
    cache.get(trender.render, cfgs[0], 128)     # a is the newest again
    cache.get(trender.render, cfgs[2], 128)     # frees cfgs[1]'s
    assert cache.keys() == [(trender.render, cfgs[0], 128),
                            (trender.render, cfgs[2], 128)]
    assert cache.get(trender.render, cfgs[0], 256) is not a  # splat count
    cache.clear()
    assert cache.keys() == []


def test_refine_and_function_graphs_raise_on_the_cpu(tmp_path):
    state, batch = _scene()
    tcfg = TrainConfig(total_train_iters=100)
    views = (torch.zeros((1, 3)), torch.full((1,), 30.0))
    with pytest.raises(RuntimeError, match="card only"):
        graphs.RefineGraph(tcfg)(state, *views)
    with pytest.raises(RuntimeError, match="card only"):
        graphs.RefineGraphs(tcfg)(state, *views)
    with pytest.raises(RuntimeError, match="card only"):
        graphs.FnGraph(lambda cam: cam.viewmat * 2)(batch.cam)
    assert not graphs.capturable(CPU, True)
    assert not graphs.capturable("cuda", False)
    assert graphs.capturable("cuda", True)
    # A step shared over gloo stays eager: its StepGraph is refused.
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1)
    try:
        share = ttrainer.ViewShare(first=0, total=1, count=1,
                                   group=dist.group.WORLD)
        assert graphs.share_key(share) == (0, 1, "gloo")
        assert not graphs.capturable("cuda", True, dist.group.WORLD)
        with pytest.raises(ValueError, match="gloo"):
            graphs.StepGraph(tcfg, _rcfg(), share=share)
    finally:
        dist.destroy_process_group()


def test_step_key_carries_the_share(monkeypatch):
    """The key differs across the rank, the world and the backend of the
    processes sharing the step, and holds (0, 1, None) for one process."""
    state, _ = _scene()

    class Group:
        def __init__(self, rank, world, backend):
            self.rank, self.world, self.backend = rank, world, backend
    monkeypatch.setattr(graphs.dist, "get_rank", lambda g: g.rank)
    monkeypatch.setattr(graphs.dist, "get_world_size", lambda g: g.world)
    monkeypatch.setattr(graphs.dist, "get_backend", lambda g: g.backend)

    def key(group):
        share = None if group is None else ttrainer.ViewShare(
            first=0, total=4, count=2, group=group)
        return graphs.step_key(state, _rcfg(), False, False, share)
    one = key(None)
    assert (one.rank, one.world, one.backend) == (0, 1, None)
    keys = [key(Group(*g)) for g in ((0, 2, "nccl"), (1, 2, "nccl"),
                                     (0, 4, "nccl"), (0, 2, "gloo"))]
    assert (keys[1].rank, keys[1].world, keys[1].backend) == (1, 2, "nccl")
    assert len({one, *keys}) == 5
    assert all(k[:6] == one[:6] for k in keys)


def test_refine_body_equals_refine_step_bit_for_bit():
    """A step and a refine, twice (the first refine attaches the 3D filter
    floor): `refine_body` on a donated state against `refine_step`, the
    same bits in every state tensor, statistic and the generator; the new
    state's tensors are the donated ones, but for the floor a first refine
    makes; the refine key follows the layout and the capacity."""
    from brush_tpu_torch.process import _grow_state
    tcfg = TrainConfig(total_train_iters=100, growth_grad_threshold=1e-9,
                       growth_select_fraction=1.0)
    state, batch = _scene()
    views = (torch.tensor([[0.0, 0.0, -8.0]]), torch.tensor([40.0]))
    eager, donated = _twin(state), _twin(state)
    keys = []
    for k in range(2):
        eager, _, _ = ttrainer.train_step_impl(eager, batch, tcfg, _rcfg())
        donated, _, _ = ttrainer.train_step_impl(donated, batch, tcfg,
                                                 _rcfg())
        keys.append(graphs.refine_key(donated, *views))
        own = {x.data_ptr() for x in graphs._tensors(
            dataclasses.replace(donated, rng=None))}
        e_state, e_stats = trefine.refine_step(eager, tcfg, *views)
        d_state, d_stats = graphs.refine_body(donated, tcfg, *views)
        assert int(d_stats.num_added) > 0
        _assert_same_bits(dataclasses.replace(d_state, rng=None),
                          dataclasses.replace(e_state, rng=None), "state")
        _assert_same_bits(d_stats, e_stats, "stats")
        assert torch.equal(d_state.rng.get_state(), e_state.rng.get_state())
        for path, x in graphs._leaves(dataclasses.replace(d_state,
                                                          rng=None)):
            if torch.is_tensor(x):
                assert (x.data_ptr() in own) == (
                    k == 1 or path != "splats.min_scale"), path
        eager, donated = e_state, d_state
    assert keys[0] != keys[1]            # the floor is a new layout
    assert graphs.refine_key(_grow_state(donated, 256), *views)[0] == 256
