"""A training run as its users start it: `train_process` over a COLMAP
dataset with the run's seed and every configuration at its default but
what the cell's `traffic_params` set (a log message every 50 steps; the
train cells set `refine_every` past the run, so the window holds the steps
between refines and no refine: the reference has no refine to judge one).

Set-up: the dataset written under TMPDIR and deleted at exit (PINHOLE
views on an arc about the bench camera, ground truth the reference's 8-bit
renders of a teacher scene drawn from the seed, `init.ply` the
configuration's scene), then the run's first `warmup_iters` steps, which
hold its graph captures. While the first steps run, the turn function of
the process module is wrapped to keep what the comparison needs (each
turn's view, loss and overflow flag, the optimizer's first moments after
the first step that changed the state, the arrays after the last followed
turn), and put back. The first step runs eagerly and captures the step
graph; the followed turns after it replay that graph, the one the window
replays (`captures_in_window` in the notes counts any graph captured
later).

Window: from a `step` message at or after `warmup_iters` to the first at
or after `seconds` later (each message reads the step's loss, so the card
has caught up). A turn with an `overflow` message is a failed step. A
traced run profiles the window's first log period; the rest of the window
is its untraced part, whose wall time a step and graph replays' host time
the per-layer readers take.

After it the generator is closed and the run's memory freed; the
reference then takes the followed turns from the same scene, views,
images and seed.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time

import numpy as np

from portbench import common
from portbench.dataset import write_colmap, write_ply
from portbench.reference import camera as C
from portbench.reference import render as R
from portbench.reference import train as RT


class Recorder:
    """Wraps the process module's turn: keeps each followed turn's view,
    loss and overflow flag, the first moments after the first turn that
    changed the state, and the arrays after `real_turns` such turns (at
    most `max_turns`); then puts the turn function back."""

    def __init__(self, proc, viewmats: np.ndarray, real_turns: int,
                 max_turns: int):
        self.proc, self.real = proc, proc._step_turn
        self.viewmats = viewmats
        self.real_turns, self.max_turns = real_turns, max_turns
        self.turns = []         # (view index, loss, overflowed)
        self.grad_m1 = None     # {name: first moment} after the first real
        self.params = None      # {name: array} after the last turn
        proc._step_turn = self._turn

    def restore(self) -> None:
        self.proc._step_turn = self.real

    def _turn(self, loop, batch, *args, **kwargs):
        out = self.real(loop, batch, *args, **kwargs)
        state, stats = out[0].state, out[1]
        vm = batch.cam.viewmat.detach().cpu().numpy().reshape(1, 3, 4)
        view = int(np.argmin(np.abs(self.viewmats - vm).sum(axis=(1, 2))))
        over = bool(stats.overflowed)
        self.turns.append((view, float(stats.loss), over))
        real = sum(1 for t in self.turns if not t[2])
        if not over and self.grad_m1 is None:
            self.grad_m1 = {k: st.moment1.detach().cpu()
                            for k, st in state.opt.items()}
        if real >= self.real_turns or len(self.turns) >= self.max_turns:
            self.params = {k: v.detach().cpu()
                           for k, v in state.splats.params().items()}
            self.restore()
        return out


def make_inputs(torch, tr: dict, config: dict, seed: int, dev):
    """The run's views, their ground truths ([H, W, 3] uint8 on the host)
    and the init scene's arrays (on the host)."""
    w, h = tr["width"], tr["height"]
    focal = (w / 2.0) / math.tan(tr["fov"] / 2.0)
    views = C.arc_views(tr["views"], tr["arc_step"], tr["radius"], focal,
                        w, h)
    from portbench.scene import bench_scene
    teacher = bench_scene(config["num_splats"], common.seed_stream(seed, 3),
                          config["sh_degree"], dev)
    pngs = []
    for v in views:
        img, _ = R.render(teacher, v, (0.0, 0.0, 0.0))
        pngs.append(torch.round(torch.clamp(img[..., :3], 0, 1) * 255.0)
                    .to(torch.uint8).cpu().numpy())
    del teacher
    init = {k: v.cpu() for k, v in bench_scene(
        config["num_splats"], common.seed_stream(seed, 0),
        config["sh_degree"], dev).items()}
    return views, pngs, init


def make_dataset(torch, root: str, tr: dict, config: dict, seed: int, dev):
    """Write the run's dataset under `root`; returns `make_inputs`'s."""
    views, pngs, init = make_inputs(torch, tr, config, seed, dev)
    write_colmap(root, views, pngs)
    write_ply(f"{root}/init.ply", {k: v.numpy() for k, v in init.items()})
    return views, pngs, init


def gap(p: float, r: float, floor: float) -> float:
    """|p - r| against the larger of |r| and a floor."""
    return abs(p - r) / max(abs(r), floor)


def counted_leaves(grads: dict) -> list[str]:
    """The leaves compared: those whose reference gradient's norm is at
    least a thousandth of the median leaf's (below that a leaf moves under
    Adam by rounding alone)."""
    gn = {k: float(v.norm()) for k, v in grads.items()}
    med = float(np.median(list(gn.values())))
    return [k for k in grads if gn[k] >= 1e-3 * med]


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, dict]:
    """The worst leaf's gap of norms, each against the larger of its own
    reference norm and the median leaf's."""
    rn = {k: float(v.norm()) for k, v in ref.items()}
    med = float(np.median(list(rn.values())))
    out = {k: gap(float(prog[k].norm()), rn[k], med) for k in leaves}
    return max(out.values()), out


def compared(lim: dict, flags: float, loss_gap: float, grad_gap: float,
             change_gap: float) -> list:
    """The numbers of a train cell's comparison beside its limits."""
    return [["overflow_flags_differ", float(flags),
             lim["overflow_flags_differ"]],
            ["loss_gap", loss_gap, lim["loss_gap"]],
            ["grad_norm_gap", grad_gap, lim["grad_norm_gap"]],
            ["change_norm_gap", change_gap, lim["change_norm_gap"]]]


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    import torch

    from brush_tpu_torch import process as proc
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.viewer.slot import Slot

    from portbench.trace import GraphClock, Tracer

    tr = cell["traffic_params"]
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="portbench-")
    marks = {"imported": common.process_age_s()}
    try:
        views, pngs, init = make_dataset(torch, f"{root}/scene", tr, config,
                                         seed, dev)
        marks["dataset_written"] = common.process_age_s()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        viewmats = np.stack([np.concatenate([v.rot, v.trans[:, None]], 1)
                             for v in views]).astype(np.float32)
        rec = Recorder(proc, viewmats, tr["follow_real_turns"],
                       tr["follow_max_turns"])
        slot = Slot() if trace else None
        pcfg = proc.ProcessConfig(seed=seed,
                                  export_path=f"{root}/export_{{iter}}.ply",
                                  **tr.get("process", {}))
        tcfg = TrainConfig(**tr.get("train", {}))
        gen = proc.train_process(f"{root}/scene", tcfg, LoadConfig(), pcfg,
                                 slot=slot, device=dev)
        tracer = Tracer(torch) if trace else None
        clock = GraphClock(torch, trace)
        snaps = []
        t0 = it0 = t_end = it_end = None
        failed = 0
        trace_steps = 0
        untraced_s, untraced_steps = 0.0, 0
        periods, t_prev, it_prev = [], time.perf_counter(), 0
        try:
            for msg in gen:
                if msg.kind == "overflow" and t0 is not None:
                    failed += 1
                if msg.kind != "step":
                    continue
                now = time.perf_counter()
                periods.append([msg.iter, round(now - t_prev, 4)])
                if t0 is None:
                    if msg.iter >= tr["warmup_iters"]:
                        setup_s = common.process_age_s()
                        t0, it0 = now, msg.iter
                        clock.window = clock.timing = True
                elif tracer is not None and tracer.prof is not None:
                    tracer.end()
                    snaps.append(slot.get(0))
                    trace_steps = msg.iter - it_prev
                    clock.timing = True
                else:
                    untraced_s += now - t_prev
                    untraced_steps += msg.iter - it_prev
                if (t0 is not None and now - t0 >= seconds
                        and (tracer is None or tracer.prof is None)):
                    t_end, it_end = now, msg.iter
                    break
                if tracer is not None and t0 is not None and not snaps:
                    clock.timing = False
                    tracer.begin()
                    snaps.append(slot.get(0))
                # The tracer's own time falls outside every period.
                t_prev, it_prev = time.perf_counter(), msg.iter
        finally:
            clock.restore()
            rec.restore()
            gen.close()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        del gen, slot
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        steps = it_end - it0
        window = t_end - t0

        # The reference follows the recorded turns from the same inputs.
        cap = 1 << max(10, math.ceil(math.log2(max(
            2 * config["num_splats"], 1))))
        gts = [torch.from_numpy(p).to(dev).float() / 255.0 for p in pngs]
        state = RT.init_state({k: v.numpy() for k, v in init.items()}, cap,
                              dev)
        p0 = {k: v.clone() for k, v in state.params.items()}
        order = [t[0] for t in rec.turns]
        res = RT.follow(state, views, gts, order, seed,
                        RT.Hyper(**tr.get("reference", {})))
        flags = sum(int(r.overflowed != t[2])
                    for r, t in zip(res, rec.turns))
        # A loss of 0.8 L1 - 0.2 SSIM can pass through 0: its gap is taken
        # against the larger of |loss| and the SSIM term's weight.
        loss_gap = max([gap(t[1], r.loss, RT.SSIM_WEIGHT)
                        for r, t in zip(res, rec.turns) if not r.overflowed]
                       or [math.inf])
        first = next((r for r in res if not r.overflowed), None)
        grad_gap, grad_by_leaf = math.inf, {}
        change_gap, change_by_leaf = math.inf, {}
        if first is not None and rec.grad_m1 is not None:
            leaves = counted_leaves(first.grads)
            grad_gap, grad_by_leaf = leaf_gaps(
                {k: v.to(dev) / (1.0 - RT.BETA1)
                 for k, v in rec.grad_m1.items()}, first.grads, leaves)
            change_gap, change_by_leaf = leaf_gaps(
                {k: rec.params[k].to(dev) - p0[k] for k in RT.NAMES},
                {k: state.params[k] - p0[k] for k in RT.NAMES}, leaves)

        work = None
        if trace and len(snaps) == 2:
            work = _trace_work(torch, snaps, views, config, trace_steps)
        lim = cell["limits"]
        return dict(
            e2e=dict(step_ms=1e3 * window / steps,
                     peak_mem_mib=peak / 2 ** 20, setup_s=setup_s),
            attempted=steps, failed=failed, peak_bytes=peak,
            window_s=window, units_name="steps",
            trace=tracer.summary() if tracer is not None else None,
            trace_units=trace_steps if work else 0, work=work,
            untraced=dict(s=untraced_s, units=untraced_steps),
            replays=clock.replays_line() if trace else None,
            compared=compared(lim, flags, loss_gap, grad_gap, change_gap),
            notes=dict(turns=rec.turns, grad_by_leaf=grad_by_leaf,
                       change_by_leaf=change_by_leaf,
                       window_iters=[it0, it_end], setup_marks_s=marks,
                       captures_in_window=clock.captures,
                       log_periods_s=periods))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _trace_work(torch, snaps, views, config, steps):
    """Work of the traced stretch's steps: the reference's counts over
    the dataset's views at the states of the stretch's two ends, a step
    taken as the mean over views and ends."""
    from portbench.work import step_work
    works = []
    for s in snaps:
        n_live = int(s.n_alive)
        arrays = {k: v for k, v in s.fold_min_scale().params().items()}
        for v in views:
            counts = R.BlendCounts(arrays["means"].shape[0],
                                   arrays["means"].device)
            _, bins = R.render(arrays, v, (0.0, 0.0, 0.0), counts=counts)
            works.append(step_work(dict(
                n_live=n_live, n_visible=int((bins.counts > 0).sum()),
                pixels=v.width * v.height, tiles=bins.start.numel(),
                slots=bins.num_slots, evaluated=counts.evaluated,
                blended=counts.blended)))
    k = steps / len(works)
    return dict(flops=k * sum(x["flops"] for x in works),
                kernel_least_s={
                    kk: k * sum(x["kernel_least_s"][kk] for x in works)
                    for kk in works[0]["kernel_least_s"]},
                units=steps)
