"""A training run from fisheye captures: `train_process` over a COLMAP
dataset of one OPENCV_FISHEYE camera (KB4), driven as traffic/train.py
drives the pinhole one and judged the same way, with the lens in the
reference (reference/lens.py).

Set-up: the configuration's camera (its size, focal, centre and k1..k4)
at `views` places on the train cell's arc about the bench camera
(`traffic_params`: `arc_step`, `radius`), written under TMPDIR as a
COLMAP dataset with the reference's 8-bit KB4 renders of a teacher scene
from the seed as ground truth and the configuration's scene as
`init.ply`; then `warmup_iters` steps (the step graph's capture at step
1). The program's recorder (`tracing.record_stages()`) is open from the
first step to the window's end: the turns count the lens they train
(`run.lens.<kind>`), and a run whose warm-up trained no KB4 turn stops
there with an error (a program that drops the lens fails at once).

Window: as traffic/train.py's, from a `step` message at or after
`warmup_iters` to the first at or after `seconds` later.
`kb4_turn_share` is the window's `run.lens.kb4` over its steps, held to
at least 1. A traced run profiles the window's first log period; the
rest of the window is its untraced part, whose wall time the per-layer
readers take, and whose recorded stages are `out["stages"]` (the whole
window's in an untraced run). After a
traced run, the 8 views are rendered once more, eagerly, through the
program's own `render` from the run's last state with the recorder open:
`out["lens_stages"]` holds the `project.lens` stages of those renders.

After it the reference follows the recorded turns from the same scene,
views, images and seed, through the lens.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import struct
import tempfile
import time

import numpy as np

from portbench import common
from portbench.dataset import write_colmap, write_ply
from portbench.reference import camera as C
from portbench.reference import lens as L
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.traffic import train as T

OPENCV_FISHEYE = 5          # COLMAP's camera model id


def lens_views(config: dict, tr: dict) -> list:
    """The run's views: the configuration's KB4 camera on the arc."""
    cam = config["camera"]
    views = C.arc_views(config["views"], tr["arc_step"], tr["radius"],
                        cam["fx"], cam["width"], cam["height"])
    return [L.fisheye(v._replace(fy=cam["fy"], cx=cam["cx"], cy=cam["cy"]),
                      cam["k"]) for v in views]


def make_inputs(torch, tr: dict, config: dict, seed: int, dev):
    """The run's views, their ground truths ([H, W, 3] uint8 on the host)
    and the init scene's arrays (on the host), as traffic/train.py makes
    them but through the lens."""
    from portbench.scene import bench_scene
    views = lens_views(config, tr)
    teacher = bench_scene(config["num_splats"], common.seed_stream(seed, 3),
                          config["sh_degree"], dev)
    pngs = []
    with L.through_lens():
        for v in views:
            img, _ = R.render(teacher, v, (0.0, 0.0, 0.0))
            pngs.append(torch.round(torch.clamp(img[..., :3], 0, 1) * 255.0)
                        .to(torch.uint8).cpu().numpy())
    del teacher
    init = {k: v.cpu() for k, v in bench_scene(
        config["num_splats"], common.seed_stream(seed, 0),
        config["sh_degree"], dev).items()}
    return views, pngs, init


def write_fisheye_colmap(root: str, views, pngs) -> None:
    """dataset.write_colmap's files with its camera as OPENCV_FISHEYE:
    fx, fy, cx, cy, k1..k4."""
    write_colmap(root, views, pngs)
    v0 = views[0]
    with open(os.path.join(root, "sparse", "0", "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, OPENCV_FISHEYE, v0.width,
                            v0.height))
        f.write(struct.pack("<8d", v0.fx, v0.fy, v0.cx, v0.cy, *v0.k))


def viewmats(views) -> np.ndarray:
    return np.stack([np.concatenate([v.rot, v.trans[:, None]], 1)
                     for v in views]).astype(np.float32)


class Window:
    """The window of a train run over a `train_process` generator, as
    traffic/train.py measures it: `run(gen)` consumes messages to the
    window's end. `at_start(step)` runs once, at the window's first
    message, and `after_stretch(step)` at the traced stretch's end; the
    window lasts until `until()` holds too."""

    def __init__(self, torch, tr: dict, seconds: float, trace: bool, slot,
                 at_start=None, after_stretch=None, until=None):
        from portbench.trace import GraphClock, Tracer
        self.tr, self.seconds, self.slot = tr, seconds, slot
        self.at_start = at_start or (lambda it: None)
        self.after_stretch = after_stretch or (lambda it: None)
        self.until = until or (lambda: True)
        self.tracer = Tracer(torch) if trace else None
        self.clock = GraphClock(torch, trace)
        self.snaps = []
        self.t0 = self.it0 = self.t_end = self.it_end = None
        self.setup_s = None
        self.failed = 0
        self.trace_steps = 0
        self.stretch_end = None        # the traced stretch's last step
        self.untraced_s, self.untraced_steps = 0.0, 0
        self.periods = []

    def run(self, gen) -> None:
        tr, tracer, clock = self.tr, self.tracer, self.clock
        t_prev, it_prev = time.perf_counter(), 0
        for msg in gen:
            if msg.kind == "overflow" and self.t0 is not None:
                self.failed += 1
            if msg.kind != "step":
                continue
            now = time.perf_counter()
            self.periods.append([msg.iter, round(now - t_prev, 4)])
            if self.t0 is None:
                if msg.iter >= tr["warmup_iters"]:
                    self.setup_s = common.process_age_s()
                    self.at_start(msg.iter)
                    self.t0, self.it0 = now, msg.iter
                    clock.window = clock.timing = True
            elif tracer is not None and tracer.prof is not None:
                tracer.end()
                self.snaps.append(self.slot.get(0))
                self.trace_steps = msg.iter - it_prev
                self.stretch_end = msg.iter
                self.after_stretch(msg.iter)
                clock.timing = True
            else:
                self.untraced_s += now - t_prev
                self.untraced_steps += msg.iter - it_prev
            if (self.t0 is not None and now - self.t0 >= self.seconds
                    and (tracer is None or tracer.prof is None)
                    and self.until()):
                self.t_end, self.it_end = now, msg.iter
                return
            if tracer is not None and self.t0 is not None and not self.snaps:
                clock.timing = False
                tracer.begin()
                self.snaps.append(self.slot.get(0))
            # The tracer's own time falls outside every period.
            t_prev, it_prev = time.perf_counter(), msg.iter
        raise RuntimeError("the run ended before its window did")

    def e2e(self, peak: int) -> dict:
        return dict(step_ms=1e3 * (self.t_end - self.t0)
                    / (self.it_end - self.it0),
                    peak_mem_mib=peak / 2 ** 20, setup_s=self.setup_s)

    def stages(self, snap: dict | None):
        """The recorded stages of the window's untraced part (after the
        stretch, where there is one), as portbench/stages.py reads
        them."""
        if snap is None:
            return None
        lo = self.it0 if self.stretch_end is None else self.stretch_end
        hi = self.it_end
        timeline = [e for e in snap["timeline"]
                    if isinstance(e["unit"], int) and lo < e["unit"] <= hi]
        return dict(snapshot=dict(snap, timeline=timeline), units=hi - lo)

    def out(self, peak: int, compared: list, notes: dict) -> dict:
        trace = self.tracer.summary() if self.tracer is not None else None
        return dict(
            e2e=self.e2e(peak), attempted=self.it_end - self.it0,
            failed=self.failed, peak_bytes=peak,
            window_s=self.t_end - self.t0, units_name="steps", trace=trace,
            trace_units=self.trace_steps if trace else 0, work=None,
            untraced=dict(s=self.untraced_s, units=self.untraced_steps),
            replays=self.clock.replays_line() if trace else None,
            compared=compared,
            notes=dict(notes, window_iters=[self.it0, self.it_end],
                       captures_in_window=self.clock.captures,
                       log_periods_s=self.periods))


def host_ms_by_stage(stages: dict | None) -> dict:
    """Host ms a step of each stage in the recorded part (notes)."""
    if not stages:
        return {}
    out: dict[str, float] = {}
    for e in stages["snapshot"]["timeline"]:
        out[e["name"]] = out.get(e["name"], 0.0) + (
            e["host"][1] - e["host"][0]) * 1e-6
    return {k: v / stages["units"] for k, v in out.items()}


def lens_renders(torch, splats, scene: str, sh_degree: int, dev) -> dict:
    """The `project.lens` stages of an eager training render of each view
    of the dataset at `scene`, as the program loads it, through its own
    `render` from `splats`, with the recorder open: dict(snapshot=...,
    units=views)."""
    from brush_tpu_torch.data.formats import LoadConfig, load_dataset
    from brush_tpu_torch.data.scene import image_dims
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    from brush_tpu_torch.utils import tracing

    lcfg = LoadConfig()
    ds = load_dataset(scene, lcfg)
    folded = splats.fold_min_scale()
    arrays = [x.detach().requires_grad_(True) for x in (
        folded.means, folded.log_scales, folded.quats, folded.sh_coeffs,
        folded.raw_opacities)]
    bg = torch.zeros(3, device=dev)
    cams = []
    for v in ds.train.views:
        rcfg = RenderConfig(
            img_size=image_dims(ds.train.vfs, v.image_path,
                                lcfg.max_resolution),
            sh_degree=sh_degree, model=v.camera.model, isect_cap=1 << 23,
            use_pallas=True)
        cams.append((camera_inputs(v.camera, rcfg.img_size, device=dev),
                     rcfg))
    with tracing.record_stages() as rec:
        for cam, rcfg in cams:
            render(*arrays, cam, bg, rcfg)
        snap = rec.snapshot()
    snap["timeline"] = [e for e in snap["timeline"]
                        if e["name"] == "project.lens"]
    return dict(snapshot=snap, units=len(cams))


def follow_reference(torch, views, pngs, init, rec, config, tr, seed, dev):
    """The reference's followed turns and the train cell's numbers:
    (flags, loss_gap, grad_gap, change_gap, by-leaf notes)."""
    cap = 1 << max(10, math.ceil(math.log2(max(
        2 * config["num_splats"], 1))))
    gts = [torch.from_numpy(p).to(dev).float() / 255.0 for p in pngs]
    state = RT.init_state({k: v.numpy() for k, v in init.items()}, cap, dev)
    p0 = {k: v.clone() for k, v in state.params.items()}
    order = [t[0] for t in rec.turns]
    with L.through_lens():
        res = RT.follow(state, views, gts, order, seed,
                        RT.Hyper(**tr.get("reference", {})))
    flags = sum(int(r.overflowed != t[2]) for r, t in zip(res, rec.turns))
    loss_gap = max([T.gap(t[1], r.loss, RT.SSIM_WEIGHT)
                    for r, t in zip(res, rec.turns) if not r.overflowed]
                   or [math.inf])
    first = next((r for r in res if not r.overflowed), None)
    grad_gap, grad_by_leaf = math.inf, {}
    change_gap, change_by_leaf = math.inf, {}
    if first is not None and rec.grad_m1 is not None:
        leaves = T.counted_leaves(first.grads)
        grad_gap, grad_by_leaf = T.leaf_gaps(
            {k: v.to(dev) / (1.0 - RT.BETA1)
             for k, v in rec.grad_m1.items()}, first.grads, leaves)
        change_gap, change_by_leaf = T.leaf_gaps(
            {k: rec.params[k].to(dev) - p0[k] for k in RT.NAMES},
            {k: state.params[k] - p0[k] for k in RT.NAMES}, leaves)
    return (flags, loss_gap, grad_gap, change_gap,
            dict(grad_by_leaf=grad_by_leaf, change_by_leaf=change_by_leaf))


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    import torch

    from brush_tpu_torch import process as proc
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.utils import tracing
    from brush_tpu_torch.viewer.slot import Slot

    tr = cell["traffic_params"]
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="portbench-")
    marks = {"imported": common.process_age_s()}
    try:
        views, pngs, init = make_inputs(torch, tr, config, seed, dev)
        write_fisheye_colmap(f"{root}/scene", views, pngs)
        write_ply(f"{root}/scene/init.ply",
                  {k: v.numpy() for k, v in init.items()})
        marks["dataset_written"] = common.process_age_s()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        rec = T.Recorder(proc, viewmats(views), tr["follow_real_turns"],
                         tr["follow_max_turns"])
        slot = Slot() if trace else None
        pcfg = proc.ProcessConfig(seed=seed,
                                  export_path=f"{root}/export_{{iter}}.ply",
                                  **tr.get("process", {}))
        gen = proc.train_process(f"{root}/scene",
                                 TrainConfig(**tr.get("train", {})),
                                 LoadConfig(), pcfg, slot=slot, device=dev)
        kb4 = {}
        snap = None
        with tracing.record_stages() as stages_rec:
            def at_start(it):
                kb4["start"] = stages_rec.counters.get("run.lens.kb4", 0)
                if kb4["start"] == 0:
                    raise RuntimeError(
                        f"no KB4 turn in the first {it} steps: the program "
                        f"trained the fisheye views through another lens "
                        f"(counters {stages_rec.counters})")

            win = Window(torch, tr, seconds, trace, slot, at_start)
            try:
                win.run(gen)
                kb4["end"] = stages_rec.counters.get("run.lens.kb4", 0)
                snap = stages_rec.snapshot()
            finally:
                win.clock.restore()
                rec.restore()
                gen.close()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        last = slot.get(0) if trace else None
        del gen, slot
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        share = (kb4["end"] - kb4["start"]) / (win.it_end - win.it0)
        flags, loss_gap, grad_gap, change_gap, leaf_notes = \
            follow_reference(torch, views, pngs, init, rec, config, tr, seed,
                             dev)
        lim = cell["limits"]
        compared = T.compared(lim, flags, loss_gap, grad_gap, change_gap)
        compared.append(["kb4_turn_share", share, lim["kb4_turn_share_min"],
                         "min"])
        stages = win.stages(snap)
        out = win.out(peak, compared, dict(
            turns=rec.turns, setup_marks_s=marks,
            host_ms_by_stage=host_ms_by_stage(stages), **leaf_notes))
        out["stages"] = stages
        if trace and last is not None and dev.type == "cuda":
            out["lens_stages"] = lens_renders(torch, last, f"{root}/scene",
                                              config["sh_degree"], dev)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The control and the faults of this cell (portbench/control_kinds.py):
# the reference in bfloat16 in the program's place, or the float32
# reference with the lens dropped (the views rendered as pinholes of the
# same focal and centre), half the image left out of the loss, or the
# gradient of the first eighth of the rows zeroed.
VARIANTS = ("bf16", "pinhole", "half", "altered")


def follow_numbers(lim: dict, ref, ref_change, ctl, ctl_change, ctl_grads
                   ) -> list:
    """The train cell's numbers of a followed run `ctl` against the
    reference's `ref`, beside the cell's limits."""
    first = next(r for r in ref if not r.overflowed)
    leaves = T.counted_leaves(first.grads)
    flags = sum(int(a.overflowed != b.overflowed) for a, b in zip(ref, ctl))
    loss_gap = max([T.gap(c.loss, r.loss, RT.SSIM_WEIGHT)
                    for r, c in zip(ref, ctl) if not r.overflowed
                    and not c.overflowed] or [math.inf])
    grad_gap = (math.inf if ctl_grads is None else
                T.leaf_gaps(ctl_grads, first.grads, leaves)[0])
    change_gap = T.leaf_gaps(ctl_change, ref_change, leaves)[0]
    return T.compared(lim, flags, loss_gap, grad_gap, change_gap)


def control(torch, cell, config, seed, device, variants) -> dict:
    """{variant: compared list} of this cell's numbers for each variant
    in the program's place."""
    from portbench import control as K
    tr = cell["traffic_params"]
    dev = torch.device(device)
    views, pngs, init = make_inputs(torch, tr, config, seed, dev)
    gts = [torch.from_numpy(p).to(dev).float() / 255.0 for p in pngs]
    order = np.random.default_rng(seed).permutation(len(views))
    order = [int(i) for i in order[:tr["follow_max_turns"]]]
    cap = 1 << max(10, math.ceil(math.log2(2 * config["num_splats"])))
    hp = RT.Hyper(**tr.get("reference", {}))
    arrays = {k: v.numpy() for k, v in init.items()}
    args = (torch, arrays, views, gts, order, seed, tr, hp, cap, dev)
    out = {}
    with L.through_lens():
        ref, ref_change, _ = K._follow(*args, None)
        for variant in variants:
            if variant == "pinhole":
                ctl = K._follow(torch, arrays, [v.pinhole() for v in views],
                                *args[3:], None)
            else:
                ctl = K._follow(*args, variant)
            out[variant] = follow_numbers(cell["limits"], ref, ref_change,
                                          *ctl)
    return out
