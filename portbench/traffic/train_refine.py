"""A training run at the trainer's own refine cadence: `train_process` over
the train cell's COLMAP dataset (traffic/train.py's `make_dataset`) with
every configuration at its default but what `traffic_params` set, so a
refine every 200 steps, each attaching the Mip 3D filter floor that the
steps after it render with.

Warm-up: `warmup_iters` steps, past the refines whose layouts are new
(the first refine attaches the floor, so the step graph is captured again
after it, and the second refine is the first of a state with a floor), so
the window replays the step and refine graphs it holds. Window: as
traffic/train.py's; it holds about three refines.

Judged: the window's first refine and the `follow_real_turns` steps after
it. Wrappers on the process module's refine and step turns copy, on the
stream and into pinned host buffers taken in the warm-up, the state
before that refine, after it, Adam's first moments after the first real
step and the arrays after the last; each followed turn's view, loss and
overflow flag are kept. After the window the reference
(reference/refine.py) refines the state from before, with the run's
generator reproduced from the seed, and steps on from its own refine with
the floor through the same views. Compared: the live count and the refined
arrays and floor (`refine_gap`: the worst of |program - reference| over
|reference| on the live rows), then the train cell's four numbers of the
steps after it (the gradient as Adam got it: its first moment after the
step less 0.9 of the one after the refine, over 0.1).

A traced run profiles the window's first log period and opens the
program's recorder (`tracing.record_stages()`) for the rest of the
window: `out["stages"]` holds what it recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import shutil
import tempfile
from typing import NamedTuple

import numpy as np

from portbench.reference import refine as RR
from portbench.reference import train as RT
from portbench.traffic import train as T
from portbench.traffic.train_lens import Window, host_ms_by_stage, viewmats

NAMES = RT.NAMES


class HostCopies:
    """Copies of tensors taken on the stream into pinned host buffers (a
    plain copy on the CPU), the buffers reserved ahead by shape."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.free: dict = {}

    def reserve(self, tensors) -> None:
        import torch
        if not self.cuda:
            return
        for x in tensors:
            key = (tuple(x.shape), x.dtype)
            self.free.setdefault(key, []).append(
                torch.empty(x.shape, dtype=x.dtype, pin_memory=self.cuda))

    def take(self, x):
        if not self.cuda:
            return x.detach().clone()
        pool = self.free.get((tuple(x.shape), x.dtype))
        if not pool:
            self.reserve([x])
            pool = self.free[(tuple(x.shape), x.dtype)]
        buf = pool.pop()
        buf.copy_(x.detach(), non_blocking=True)
        return buf

    def take_all(self, tree: dict) -> dict:
        return {k: None if v is None else self.take(v)
                for k, v in tree.items()}


def state_tensors(state) -> dict:
    """What the reference needs of a program's TrainState, flat."""
    out = {f"p.{k}": v for k, v in state.splats.params().items()}
    out["floor"] = state.splats.min_scale
    out["n_alive"] = state.splats.n_alive
    out["step"] = state.step
    for f in ("refine_weight", "visible_count", "max_radius"):
        out[f"r.{f}"] = getattr(state.refine, f)
    for k, st in state.opt.items():
        out[f"m1.{k}"], out[f"m2.{k}"], out[f"t.{k}"] = (
            st.moment1, st.moment2, st.time)
    out["center"], out["extent"] = state.bounds_center, state.bounds_extent
    return out


class Follower:
    """Wraps the process module's `_refine_turn` and `_step_turn`: once
    armed, copies the state around the next refine and follows the steps
    after it (see the module docstring)."""

    def __init__(self, proc, viewmats_: np.ndarray, real_turns: int,
                 max_turns: int, device):
        self.proc = proc
        self.real_refine, self.real_step = proc._refine_turn, proc._step_turn
        self.viewmats = viewmats_
        self.real_turns, self.max_turns = real_turns, max_turns
        self.host = HostCopies(device)
        self.armed = False
        self.before = self.after = None
        self.caps = None
        self.turns = []          # (view index, loss, overflowed)
        self.m1_first = None     # first moments after the first real step
        self.last = None         # arrays after the last followed step
        self.done = False
        proc._refine_turn, proc._step_turn = self._refine, self._step

    def restore(self) -> None:
        self.proc._refine_turn = self.real_refine
        self.proc._step_turn = self.real_step

    def _step(self, loop, batch, *args, **kwargs):
        if not self.host.free:
            # Buffers for two states (with a floor), a set of moments and
            # a set of arrays.
            t = [x for x in state_tensors(loop.state).values()
                 if x is not None] + [loop.state.splats.raw_opacities]
            self.host.reserve(t + t)
            self.host.reserve([st.moment1 for st in loop.state.opt.values()])
            self.host.reserve(list(loop.state.splats.params().values()))
        out = self.real_step(loop, batch, *args, **kwargs)
        if self.after is None or self.done:
            return out
        state, stats = out[0].state, out[1]
        vm = batch.cam.viewmat.detach().cpu().numpy().reshape(1, 3, 4)
        view = int(np.argmin(np.abs(self.viewmats - vm).sum(axis=(1, 2))))
        over = bool(stats.overflowed)
        self.turns.append((view, float(stats.loss), over))
        real = sum(1 for t in self.turns if not t[2])
        if not over and self.m1_first is None:
            self.m1_first = self.host.take_all(
                {k: st.moment1 for k, st in state.opt.items()})
        if real >= self.real_turns or len(self.turns) >= self.max_turns:
            self.last = self.host.take_all(state.splats.params())
            self.done = True
            self.restore()
        return out

    def _refine(self, loop, tcfg, centers, focals):
        due = (loop.it % tcfg.refine_every == 0
               and loop.it < tcfg.total_train_iters * 0.95)
        if not (self.armed and due and self.before is None):
            return self.real_refine(loop, tcfg, centers, focals)
        self.before = self.host.take_all(state_tensors(loop.state))
        cap = loop.state.splats.capacity
        self.caps = dict(isect=loop.rcfg.isect_cap,
                         chunk=loop.rcfg.resolved_chunk_cap(cap))
        out = self.real_refine(loop, tcfg, centers, focals)
        self.after = self.host.take_all(state_tensors(out[0].state))
        return out


class Followed(NamedTuple):
    """A refine and the steps after it, by the program or the reference:
    the live count, the refined arrays and floor, each step's (loss,
    overflowed), the first moments after the refine and after the first
    real step, and the arrays after the last step."""

    n_alive: int
    refined: dict
    turns: list
    m1_refine: dict
    m1_first: dict | None
    last: dict | None


def program_followed(f: Follower, dev) -> Followed:
    a = {k: None if v is None else v.to(dev) for k, v in f.after.items()}
    return Followed(
        n_alive=int(a["n_alive"]),
        refined={**{k: a[f"p.{k}"] for k in NAMES}, "floor": a["floor"]},
        turns=[(t[1], t[2]) for t in f.turns],
        m1_refine={k: a[f"m1.{k}"] for k in NAMES},
        m1_first=(None if f.m1_first is None else
                  {k: v.to(dev) for k, v in f.m1_first.items()}),
        last=None if f.last is None else {k: v.to(dev)
                                          for k, v in f.last.items()})


def reference_followed(torch, before: dict, views, gts, order, caps: dict,
                       seed: int, tr: dict, dev, dtype=None,
                       fault: str | None = None) -> Followed:
    """The reference's refine of the state `before` (host copies) and its
    steps through the views `order`, with the run's generator reproduced
    from the seed; `dtype` computes the steps in another precision, and
    `fault` plants one of FAULTS in the refine."""
    b = {k: None if v is None else v.to(dev) for k, v in before.items()}
    steps_before = int(b["step"])
    fields = {f.name for f in dataclasses.fields(RR.Hyper)}
    rhp = RR.Hyper(**{k: v for k, v in tr.get("train", {}).items()
                      if k in fields}, **FAULTS.get(fault, {}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    RR.advance_to_refine(gen, steps_before, b["p.means"].shape[0], rhp)
    st = RR.RefineState(
        params={k: b[f"p.{k}"] for k in NAMES}, floor=b["floor"],
        n_alive=int(b["n_alive"]), refine_weight=b["r.refine_weight"],
        visible_count=b["r.visible_count"], max_radius=b["r.max_radius"],
        m1={k: b[f"m1.{k}"] for k in NAMES},
        m2={k: b[f"m2.{k}"] for k in NAMES},
        t={k: int(b[f"t.{k}"]) for k in NAMES}, step=steps_before,
        center=b["center"], extent=b["extent"])
    centers = torch.tensor(np.stack([v.position for v in views]),
                           dtype=torch.float32, device=dev)
    focals = torch.tensor([v.fx for v in views], dtype=torch.float32,
                          device=dev)
    out = RR.refine(st, centers, focals, gen, rhp,
                    prune=fault != "noprune")
    refined = {**{k: v.clone() for k, v in out.params.items()},
               "floor": out.floor}
    state = RR.train_state(out)
    m1_refine = {k: v.clone() for k, v in state.m1.items()}
    hp = RT.Hyper(**tr.get("reference", {}))
    caps = dict(caps)
    res, m1_first = [], None
    for i in order:
        r = RR.step(state, out.floor, views[i], gts[i], gen, caps, hp,
                    dtype or torch.float32)
        if res:
            RT.grow_caps(caps, res[-1])
        res.append(r)
        if not r.overflowed and m1_first is None:
            m1_first = {k: v.float().clone() for k, v in state.m1.items()}
    return Followed(n_alive=out.n_alive, refined=refined,
                    turns=[(r.loss, r.overflowed) for r in res],
                    m1_refine=m1_refine, m1_first=m1_first,
                    last={k: v.float() for k, v in state.params.items()})


def _rel(p, r) -> float:
    rn = float(r.float().norm())
    return float((p.float() - r.float()).norm()) / max(rn, 1e-30)


def compared(lim: dict, prog: Followed, ref: Followed) -> list:
    """The refine cell's numbers of `prog` against `ref`, beside the
    limits."""
    n = ref.n_alive
    refine_gap = math.inf
    if prog.n_alive == n:
        refine_gap = max(
            _rel(prog.refined[k][:n], ref.refined[k][:n])
            for k in ref.refined
            if ref.refined[k] is not None and prog.refined[k] is not None)
    flags = sum(int(a[1] != b[1]) for a, b in zip(prog.turns, ref.turns))
    flags += abs(len(prog.turns) - len(ref.turns))
    loss_gap = max([T.gap(p[0], r[0], RT.SSIM_WEIGHT)
                    for p, r in zip(prog.turns, ref.turns)
                    if not r[1] and not p[1]] or [math.inf])
    grad_gap = change_gap = math.inf
    if prog.m1_first is not None and ref.m1_first is not None:
        def grads(f):
            return {k: (f.m1_first[k] - RT.BETA1 * f.m1_refine[k])
                    / (1.0 - RT.BETA1) for k in NAMES}
        g_ref = grads(ref)
        leaves = T.counted_leaves(g_ref)
        grad_gap = T.leaf_gaps(grads(prog), g_ref, leaves)[0]
        if prog.last is not None:
            change_gap = T.leaf_gaps(
                {k: prog.last[k] - prog.refined[k] for k in NAMES},
                {k: ref.last[k] - ref.refined[k] for k in NAMES}, leaves)[0]
    return [["n_alive_differ", float(abs(prog.n_alive - n)),
             lim["n_alive_differ"]],
            ["refine_gap", refine_gap, lim["refine_gap"]],
            *T.compared(lim, flags, loss_gap, grad_gap, change_gap)]


def drive(torch, cell, config, seed, seconds, trace, dev, root,
          to_the_end=False):
    """Write the dataset, run `train_process` through warm-up and window
    with the follower armed at the window's start (and, `to_the_end`, on
    until the follower is done), and return (views,
    images, window, follower, peak bytes, the recorder's snapshot of the
    window after the traced stretch or None)."""
    from brush_tpu_torch import process as proc
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.utils import tracing
    from brush_tpu_torch.viewer.slot import Slot

    tr = cell["traffic_params"]
    views, pngs, _ = T.make_dataset(torch, f"{root}/scene", tr, config,
                                    seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    follower = Follower(proc, viewmats(views), tr["follow_real_turns"],
                        tr["follow_max_turns"], dev)
    slot = Slot() if trace else None
    pcfg = proc.ProcessConfig(seed=seed,
                              export_path=f"{root}/export_{{iter}}.ply",
                              **tr.get("process", {}))
    gen = proc.train_process(f"{root}/scene",
                             TrainConfig(**tr.get("train", {})),
                             LoadConfig(), pcfg, slot=slot, device=dev)
    stack = contextlib.ExitStack()
    recorder = []

    def at_start(it):
        follower.armed = True

    def after_stretch(it):
        recorder.append(stack.enter_context(tracing.record_stages()))

    win = Window(torch, tr, seconds, trace, slot, at_start, after_stretch,
                 until=(lambda: follower.done) if to_the_end else None)
    snap = None
    try:
        with stack:
            win.run(gen)
            if recorder:
                snap = recorder[0].snapshot()
    finally:
        win.clock.restore()
        follower.restore()
        gen.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del gen, slot
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return views, pngs, win, follower, peak, snap


def _follow_inputs(torch, follower, pngs, dev):
    """The ground truths on the device and the followed turns' views; a
    refine that grew the capacity (the reference refines at one) stops
    the run."""
    if follower.after["p.means"].shape != follower.before["p.means"].shape:
        raise RuntimeError("the followed refine grew the splat capacity")
    gts = [torch.from_numpy(p).to(dev).float() / 255.0 for p in pngs]
    return gts, [t[0] for t in follower.turns]


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    import torch

    dev = torch.device(device)
    tr = cell["traffic_params"]
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        views, pngs, win, follower, peak, snap = drive(
            torch, cell, config, seed, seconds, trace, dev, root)
        lim = cell["limits"]
        cmp = [["refines_followed", float(follower.after is not None),
                lim["refines_followed_min"], "min"]]
        notes = {}
        if follower.after is not None:
            gts, order = _follow_inputs(torch, follower, pngs, dev)
            prog = program_followed(follower, dev)
            ref = reference_followed(torch, follower.before, views, gts,
                                     order, follower.caps, seed, tr, dev)
            cmp += compared(lim, prog, ref)
            notes = dict(refine_iter=int(follower.before["step"]),
                         n_alive_before=int(follower.before["n_alive"]),
                         n_alive=[prog.n_alive, ref.n_alive],
                         turns=follower.turns)
        stages = win.stages(snap)
        out = win.out(peak, cmp, dict(
            notes, host_ms_by_stage=host_ms_by_stage(stages)))
        out["stages"] = stages
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The control and the faults of this cell (portbench/control_kinds.py),
# each in the program's place from the program's own state before the
# window's first refine: the reference's steps in bfloat16 after its
# refine, or its refine with the pruning skipped, with no splat grown by
# its refine weight, or with the opacity decay left out.
FAULTS = {"noprune": {}, "nogrowth": dict(growth_select_fraction=0.0),
          "nodecay": dict(opac_decay=0.0)}
VARIANTS = ("bf16", *FAULTS)


def control(torch, cell, config, seed, device, variants) -> dict:
    dev = torch.device(device)
    tr = cell["traffic_params"]
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        views, pngs, _, follower, _, _ = drive(
            torch, cell, config, seed, 0.0, False, dev, root,
            to_the_end=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gts, order = _follow_inputs(torch, follower, pngs, dev)
    args = (torch, follower.before, views, gts, order, follower.caps, seed,
            tr, dev)
    ref = reference_followed(*args)
    out = {}
    for variant in variants:
        ctl = (reference_followed(*args, dtype=torch.bfloat16)
               if variant == "bf16" else
               reference_followed(*args, fault=variant))
        out[variant] = compared(cell["limits"], ctl, ref)
    return out
