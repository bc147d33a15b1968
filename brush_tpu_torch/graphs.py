"""The JAX package's compiled, donated programs as CUDA graphs.

The JAX package never runs its main path op by op. `train_process` keeps a
`step_cache` of `jax.jit(train_step_impl, donate_argnums=0)` keyed by
(img_size, has_alpha, alpha_is_mask, isect_cap, chunk_cap, capacity)
(brush_tpu/process.py:221-258), a multi-device step jitted over a mesh of
gcd(B, devices) devices, a `refine_jit` made again after a capacity
growth, and for the LOD bake a `lod_cache` of donated steps keyed by image
size (:466-478); the PUP scoring jits `view_hessian` and `fd_col`
(brush_tpu/train/lod.py:77, :54), the strip render its `run`
(brush_tpu/parallel/tile_parallel.py:89), eval `_eval_step_fn`
(brush_tpu/train/eval.py:31) and the viewer `_jitted_render`
(brush_tpu/viewer/service.py:30). PyTorch runs eagerly: a frame or a
training step is a few thousand launches the host enqueues one by one. A
CUDA graph captures them once and replays them with one launch.

Every graph here follows one protocol (`_Graph`): its first call runs the
body eagerly on a side stream (the warm-up PyTorch asks for before a
capture; it is the call's real work, so its result is returned), then
captures it; later calls replay it. The inputs are the graph's own
tensors, and an input that is not already the graph's own is copied in
(by data pointer, `load_into`). A generator the body draws from is
registered with the graph, so each replay draws the numbers the eager
body would. Nothing in a body copies from the host or reads a value back
(constants are fills on the card, utils/device.device_constant).

* `StepGraph`: one `step_cache` entry. It captures `step_body`:
  `train_step_impl` followed by copies of the new state into the graph's
  own state tensors, the counterpart of donation. After a replay the
  caller's `TrainState` is the graph's; a state that is not the graph's
  own (after a capacity growth or a checkpoint load) is copied in. The
  step's statistics and render aux are copied out after each replay, since
  the next replay overwrites the graph's own (the training loop reads one
  step's aux after the next step is queued). A step shared among the
  processes of a group (`ViewShare`) captures its NCCL collectives too.
* `RefineGraph`: `refine_jit`. It captures `refine_body`: `refine_step`,
  its new state written into the state's own tensors. The state a
  RefineGraph is first called with is donated: its tensors become the
  graph's, so the state that a StepGraph hands it (the step graph's own)
  is refined in place and handed back with no copy. Its statistics, and
  what the refine adds to the layout (the 3D filter floor), are copied
  out.
* `FnGraph`: a function of tensors (`view_hessian` and `fd_col`, the
  strips' `run`). Its outputs are the graph's own tensors, valid until its
  next call. `RenderGraph` is the FnGraph of a render without gradients:
  `_jitted_render` and `_eval_step_fn`.

The graphs run on the card only: called with CPU tensors they raise, and
the CPU path is the plain eager functions. They need the kernel path
(`use_pallas=True`): the plain rasterizer reads its longest tile's length
to the host, which a capture refuses. A gloo group's collectives go
through the host, which a capture cannot hold either: a step shared over
gloo stays eager (`capturable` says which programs run as graphs).

Caches. `StepGraphs` keeps one StepGraph, keyed as the JAX `step_cache`
plus the share of the step (rank, world, backend), the rest of the
RenderConfig and the state's layout (a refine attaches the 3D filter
floor, which a jit retraces on too); `RefineGraphs` one RefineGraph, keyed
by the capacity and the layouts of the state and the views;
`RENDER_GRAPHS` two RenderGraphs, keyed by the body, the RenderConfig (the
JAX caches' key) and the splat count (which a jit retraces on). The JAX
caches hold up to eight entries (`lru_cache(maxsize=8)`), but a graph
holds its private memory pool, every intermediate of its body (gigabytes
at 1M splats), for as long as it lives: so a key change (capacity growth,
`isect_cap` growth after an overflow, a new image size) frees the old
graph and its pool.

Capture. One capture at a time in the process (a lock). The capture mode
is `thread_local`: autograd runs the rasterizer's backward on a thread of
its own, which launches onto the capture stream, and a viewer's server
threads may go on with eager work while the trainer captures. Freeing a
graph's pool (`torch.cuda.empty_cache`) synchronises the device, which a
capture refuses, so it takes the capture lock too. Stages
(`utils/tracing`) record nothing inside a warm-up and a capture; each
replay is a `graphs.replay` stage with device marks, and the recorder
counts `graphs.capture.<kind>`, `graphs.replay.<kind>` and
`graphs.evict.<kind>` (kind: `step`, `refine`, `render`, `fn`).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

from brush_tpu_torch import kernels
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.render import RenderConfig, render
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.refine import refine_step
from brush_tpu_torch.train.trainer import (
    SceneBatch,
    TrainState,
    ViewShare,
    train_step_impl,
)
from brush_tpu_torch.utils.tracing import count, stage, stages_off

_capture_lock = threading.Lock()


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------


def _map_paths(tree, fn, path=""):
    """`tree` with every tensor x replaced by fn(path, x): dataclasses,
    dicts, NamedTuples and tuples are rebuilt, anything else (None,
    numbers, a generator) is kept. Paths are those of `_leaves`."""
    if torch.is_tensor(tree):
        return fn(path, tree)

    def at(k):
        return f"{path}.{k}" if path else str(k)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_paths(getattr(tree, f.name), fn, at(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, at(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(v, fn, at(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(v, fn, at(i))
                          for i, v in enumerate(tree))
    return tree


def _map(tree, fn):
    """`tree` with every tensor replaced by fn(tensor)."""
    return _map_paths(tree, lambda _, x: fn(x))


def _leaves(tree, path="") -> list:
    """(path, leaf) of every tensor, number and None in `tree`, in field
    order (a generator is no leaf)."""
    if torch.is_tensor(tree) or tree is None or isinstance(tree,
                                                          (int, float)):
        return [(path, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return []
    out = []
    for k, v in items:
        out += _leaves(v, f"{path}.{k}" if path else str(k))
    return out


def _tensors(tree) -> list:
    return [x for _, x in _leaves(tree) if torch.is_tensor(x)]


def layout(tree) -> tuple:
    """(path, shape, dtype) of every tensor of `tree`, and the paths of its
    None fields: what a graph over the tree is fixed to."""
    return tuple((p, None) if x is None else
                 (p, tuple(x.shape), x.dtype) if torch.is_tensor(x) else
                 (p, type(x))
                 for p, x in _leaves(tree))


def copy_out(tree):
    """`tree` with every tensor copied into a fresh one."""
    return _map(tree, torch.clone)


def load_into(own, src) -> int:
    """Copy each tensor of `src` into the tensor of `own` at the same place
    where the two are not one buffer (their data pointers differ); a number
    in `src` is written into `own`'s 0-d tensor there. Returns the number of
    tensors written. Raises ValueError where the layouts differ."""
    mine, theirs = _leaves(own), _leaves(src)
    if [p for p, _ in mine] != [p for p, _ in theirs]:
        raise ValueError("layout differs from the graph's: "
                         f"{[p for p, _ in theirs]}")
    written = 0
    for (path, dst), (_, x) in zip(mine, theirs):
        if not torch.is_tensor(dst):
            if torch.is_tensor(x) or (x is None) != (dst is None):
                raise ValueError(f"{path}: {type(x).__name__} where the "
                                 f"graph holds {type(dst).__name__}")
        elif torch.is_tensor(x):
            if x.shape != dst.shape or x.dtype != dst.dtype:
                raise ValueError(f"{path}: {x.dtype} {tuple(x.shape)} against "
                                 f"the graph's {dst.dtype} "
                                 f"{tuple(dst.shape)}")
            if x.data_ptr() != dst.data_ptr():
                dst.copy_(x)
                written += 1
        elif isinstance(x, (int, float)) and dst.dim() == 0:
            dst.fill_(x)
            written += 1
        else:
            raise ValueError(f"{path}: {x!r} where the graph holds a tensor")
    return written


def _write_back(own, new):
    """`new` with each tensor for which `own` holds one of the same shape
    and dtype at the same place written into that one (where the two are
    not one buffer) and replaced by it: a body's result in the graph's own
    tensors. Every tensor of `new` must be computed before this runs."""
    slots = {p: x for p, x in _leaves(own) if torch.is_tensor(x)}

    def put(path, x):
        dst = slots.get(path)
        if dst is None or dst.shape != x.shape or dst.dtype != x.dtype:
            return x
        if dst.data_ptr() != x.data_ptr():
            dst.copy_(x)
        return dst
    return _map_paths(new, put)


def _static_batch(tree, device):
    """The graph's own copy of its inputs (a batch, a camera, a tuple of
    them): every tensor cloned, a camera's float fisheye bound held as a
    0-d tensor so each call can write it."""
    def own(x):
        if isinstance(x, SceneBatch):
            return x._replace(gt_packed=x.gt_packed.clone(), cam=own(x.cam))
        if isinstance(x, CameraInputs):
            if isinstance(x.half_max_render_fov, float):
                x = x._replace(half_max_render_fov=torch.full(
                    (), x.half_max_render_fov, dtype=torch.float32,
                    device=device))
            return copy_out(x)
        if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
            return type(x)(own(v) for v in x)
        return copy_out(x)
    return own(tree)


def _require_cuda(what: str, tensors) -> torch.device:
    devices = {t.device for t in tensors if torch.is_tensor(t)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(
            f"{what} runs on the card only (got tensors on "
            f"{sorted(str(d) for d in devices)}); the CPU path is the plain "
            f"eager functions (train_step_impl, refine_step, render)")
    return next(iter(devices))


def _require_kernel_path(rcfg: RenderConfig, what: str) -> None:
    if not rcfg.use_pallas:
        raise ValueError(f"{what} needs RenderConfig(use_pallas=True): the "
                         f"plain rasterizer reads its longest tile's length "
                         f"to the host, which a capture refuses")


def capturable(device, use_pallas: bool, group=None) -> bool:
    """Whether a program on `device` runs as a CUDA graph: on the card, on
    the kernel path, and with no gloo group between the processes (gloo's
    collectives go through the host, which a capture cannot hold)."""
    return (torch.device(device).type == "cuda" and use_pallas
            and (group is None or dist.get_backend(group) == "nccl"))


def share_key(share: ViewShare | None) -> tuple:
    """(rank, world, backend) of the processes that share a step: (0, 1,
    None) for a step of one process."""
    group = None if share is None else share.group
    if group is None:
        return 0, 1, None
    return (dist.get_rank(group), dist.get_world_size(group),
            dist.get_backend(group))


# --------------------------------------------------------------------------
# warm-up and capture, shared by every graph
# --------------------------------------------------------------------------


def _capture(graph, body, kind: str, generator=None):
    """Capture `body()` into `graph` and return its outputs (tensors of the
    graph's pool). The launches of the capture go to an open
    `kernels.capture()`, as an eager call's would."""
    count(f"graphs.capture.{kind}")
    if generator is not None:
        graph.register_generator_state(generator)
    with _capture_lock, stages_off():
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            return body()


def free_pools() -> None:
    """Return the pools of freed graphs to the card. The allocator
    synchronises the device to release cached blocks and refuses to while
    a capture runs, so this waits for a capture on another thread (the
    trainer's and a viewer's threads share the process)."""
    with _capture_lock:
        torch.cuda.empty_cache()


def _warm_up(body):
    """Run `body()` once eagerly on a side stream (PyTorch's rule before a
    capture), its kernel launches counted but recorded nowhere: not in an
    open `kernels.capture()` (the capture's own launches go there), and
    not in a list of their own, whose inputs would keep every launch's
    buffers (the binning's, the gradients') alive to the step's end."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), stages_off(), kernels.capture(record=False):
        out = body()
    torch.cuda.current_stream().wait_stream(side)
    return out


class _Graph:
    """A body captured into a CUDA graph: `_run()` is the body's result
    for this call, the eager warm-up's on the first call (which then
    captures the body), a replay's after (the graph's own tensors).
    `kind` names the graph in the recorder's counters."""

    kind = "fn"

    def __init__(self):
        self._graph = None
        self._outs = None

    def _body(self):
        raise NotImplementedError

    def _run(self, generator=None):
        if self._graph is not None:
            self.replay()
            return self._outs
        out = _warm_up(self._body)
        graph = torch.cuda.CUDAGraph()
        self._outs = _capture(graph, self._body, self.kind, generator)
        self._graph = graph
        return out

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def replay(self) -> None:
        """Replay the captured body on the inputs the graph holds."""
        count(f"graphs.replay.{self.kind}")
        with stage("graphs.replay", device=True):
            self._graph.replay()


class _Cache:
    """One graph at a time, made for a key: a key change frees the old
    graph and its pool first. `captures` counts the graphs made; `kind`
    names the graphs in the recorder's counters."""

    kind = "fn"

    def __init__(self):
        self.key = None
        self.graph = None
        self.captures = 0

    def _get(self, key, make):
        if key != self.key:
            if self.graph is not None:
                count(f"graphs.evict.{self.kind}")
            self.clear()
            self.graph = make()
            self.key = key
            self.captures += 1
        return self.graph

    def clear(self) -> None:
        """Free the graph and its pool (a state it holds lives on in the
        caller's)."""
        had = self.graph is not None
        self.graph, self.key = None, None
        if had:
            free_pools()


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------


def step_body(state: TrainState, batch: SceneBatch, tcfg: TrainConfig,
              rcfg: RenderConfig, has_alpha: bool = False,
              alpha_is_mask: bool = False, batched: bool = False,
              lpips_model=None, share: ViewShare | None = None):
    """What a StepGraph captures: `train_step_impl`, then the new state
    copied into `state`'s own tensors (donation). Returns (stats, aux), the
    step's own tensors. Runs eagerly on any device."""
    new, stats, aux = train_step_impl(
        state, batch, tcfg, rcfg, has_alpha=has_alpha,
        alpha_is_mask=alpha_is_mask, batched=batched, lpips_model=lpips_model,
        share=share)
    load_into(dataclasses.replace(state, rng=None),
              dataclasses.replace(new, rng=None))
    return stats, aux


class StepKey(NamedTuple):
    """The JAX `step_cache` key (brush_tpu/process.py:232-233), the step's
    share (the JAX key holds the mesh through `get_step`: rank, world and
    backend of the processes sharing the step; 0, 1, None for one), then
    what else a graph is fixed to: the rest of the RenderConfig and the
    state's layout."""

    img_size: tuple
    has_alpha: bool
    alpha_is_mask: bool
    isect_cap: int
    chunk_cap: int | None
    capacity: int
    rank: int
    world: int
    backend: str | None
    rcfg: RenderConfig
    layout: tuple


def step_key(state: TrainState, rcfg: RenderConfig, has_alpha: bool,
             alpha_is_mask: bool, share: ViewShare | None = None) -> StepKey:
    return StepKey(tuple(rcfg.img_size), has_alpha, alpha_is_mask,
                   rcfg.isect_cap, rcfg.chunk_cap, state.splats.capacity,
                   *share_key(share), rcfg,
                   layout(dataclasses.replace(state, rng=None)))


class StepGraph(_Graph):
    """`train_step_impl` captured into a CUDA graph, with donation: see the
    module docstring. `graph(state, batch) -> (state, stats, aux)`. With a
    `share` over NCCL the step's all_reduces are in the graph; a share over
    gloo is refused."""

    kind = "step"

    def __init__(self, tcfg: TrainConfig, rcfg: RenderConfig,
                 has_alpha: bool = False, alpha_is_mask: bool = False,
                 batched: bool = False, lpips_model=None,
                 share: ViewShare | None = None):
        super().__init__()
        _require_kernel_path(rcfg, "StepGraph")
        if rcfg.forward_only:
            raise ValueError("StepGraph needs a differentiable render: "
                             "RenderConfig(forward_only=False)")
        if share_key(share)[2] not in (None, "nccl"):
            raise ValueError(
                f"StepGraph of a step shared over {share_key(share)[2]}: "
                f"its collectives go through the host, which a capture "
                f"cannot hold; run the step eagerly")
        self.tcfg, self.rcfg = tcfg, rcfg
        self.kw = dict(has_alpha=has_alpha, alpha_is_mask=alpha_is_mask,
                       batched=batched, lpips_model=lpips_model, share=share)
        self.state: TrainState | None = None   # the graph's own
        self._batch = None

    def _body(self):
        return step_body(self.state, self._batch, self.tcfg, self.rcfg,
                         **self.kw)

    def __call__(self, state: TrainState, batch: SceneBatch):
        dev = _require_cuda("StepGraph", _tensors(
            (dataclasses.replace(state, rng=None), batch)))
        if self._graph is None:
            self.state = dataclasses.replace(
                copy_out(dataclasses.replace(state, rng=None)), rng=state.rng)
            self._batch = _static_batch(batch, dev)
        else:
            load_into(dataclasses.replace(self.state, rng=None),
                      dataclasses.replace(state, rng=None))
            if state.rng is not self.state.rng:
                self.state.rng.set_state(state.rng.get_state())
            load_into(self._batch, batch)
        # The warm-up is the first call's step: the graph's state then
        # holds its result, which the first replay steps on from.
        stats, aux = copy_out(self._run(self.state.rng))
        return self.state, stats, aux


class StepGraphs(_Cache):
    """`train_process`'s step cache on the card: one StepGraph, keyed by
    `step_key`. `steps(state, batch, rcfg, has_alpha, alpha_is_mask,
    share)` takes one step."""

    kind = StepGraph.kind

    def __init__(self, tcfg: TrainConfig, batched: bool = False,
                 lpips_model=None):
        super().__init__()
        self.tcfg, self.batched, self.lpips_model = tcfg, batched, lpips_model

    def __call__(self, state, batch, rcfg, has_alpha=False,
                 alpha_is_mask=False, share: ViewShare | None = None):
        graph = self._get(
            step_key(state, rcfg, has_alpha, alpha_is_mask, share),
            lambda: StepGraph(self.tcfg, rcfg, has_alpha, alpha_is_mask,
                              self.batched, self.lpips_model, share))
        return graph(state, batch)


# --------------------------------------------------------------------------
# the refine
# --------------------------------------------------------------------------


def refine_body(state: TrainState, tcfg: TrainConfig,
                view_centers: torch.Tensor, view_focals: torch.Tensor):
    """What a RefineGraph captures: `refine_step`, its new state written
    into `state`'s own tensors where `state` has one of that shape
    (donation; the 3D filter floor a first refine attaches stays the
    body's own). Returns (new state, stats). Runs eagerly on any device."""
    new, stats = refine_step(state, tcfg, view_centers, view_focals)
    new = _write_back(dataclasses.replace(state, rng=None),
                      dataclasses.replace(new, rng=None))
    return dataclasses.replace(new, rng=state.rng), stats


def refine_key(state: TrainState, view_centers, view_focals) -> tuple:
    """What a refine graph is fixed to: the capacity (the JAX `refine_jit`
    retraces on it after a growth) and the layouts of the state and of the
    views."""
    return (state.splats.capacity,
            layout(dataclasses.replace(state, rng=None)),
            layout((view_centers, view_focals)))


class RefineGraph(_Graph):
    """`refine_step` captured into a CUDA graph. `graph(state, centers,
    focals) -> (state, stats)`. The state of the first call is donated (its
    tensors become the graph's and are refined in place); a later state
    that is not the graph's own is copied in. The stats and what the refine
    adds to the layout are copied out."""

    kind = "refine"

    def __init__(self, tcfg: TrainConfig):
        super().__init__()
        self.tcfg = tcfg
        self.state: TrainState | None = None   # the graph's own
        self._views = None

    def _body(self):
        return refine_body(self.state, self.tcfg, *self._views)

    def __call__(self, state: TrainState, view_centers: torch.Tensor,
                 view_focals: torch.Tensor):
        dev = _require_cuda("RefineGraph", _tensors(
            (dataclasses.replace(state, rng=None), view_centers,
             view_focals)))
        if self._graph is None:
            self.state = state
            self._views = _static_batch((view_centers, view_focals), dev)
        else:
            load_into(dataclasses.replace(self.state, rng=None),
                      dataclasses.replace(state, rng=None))
            if state.rng is not self.state.rng:
                self.state.rng.set_state(state.rng.get_state())
            load_into(self._views, (view_centers, view_focals))
        new, stats = self._run(self.state.rng)
        own = {x.data_ptr() for x in _tensors(
            dataclasses.replace(self.state, rng=None))}
        new = _map(new, lambda x: x if x.data_ptr() in own else x.clone())
        return new, copy_out(stats)


class RefineGraphs(_Cache):
    """The loop's refine on the card: one RefineGraph, keyed by
    `refine_key`. `refines(state, centers, focals) -> (state, stats)`."""

    kind = RefineGraph.kind

    def __init__(self, tcfg: TrainConfig):
        super().__init__()
        self.tcfg = tcfg

    def __call__(self, state, view_centers, view_focals):
        graph = self._get(refine_key(state, view_centers, view_focals),
                          lambda: RefineGraph(self.tcfg))
        return graph(state, view_centers, view_focals)


# --------------------------------------------------------------------------
# functions of tensors: renders, scoring views, strips
# --------------------------------------------------------------------------


class FnGraph(_Graph):
    """`fn(*inputs)` captured into a CUDA graph over the graph's own copies
    of its inputs (tensors, batches, cameras); `graph(*inputs)` copies in
    those that are not already the graph's and returns the outputs, the
    graph's own tensors after the first call, valid until the next.
    `generator`: the generator `fn` draws from; `grad`: autograd on in the
    body (off by default)."""

    def __init__(self, fn, generator=None, grad: bool = False,
                 what: str = "FnGraph"):
        super().__init__()
        self.fn, self.generator, self.grad, self.what = (fn, generator, grad,
                                                         what)
        self._inputs = None

    def _body(self):
        with torch.set_grad_enabled(self.grad):
            return self.fn(*self._inputs)

    def __call__(self, *inputs):
        dev = _require_cuda(self.what, _tensors(inputs))
        if self._graph is None:
            self._inputs = _static_batch(inputs, dev)
        else:
            load_into(self._inputs, inputs)
        return self._run(self.generator)


class RenderGraph(FnGraph):
    """A render without gradients captured into a CUDA graph: the counterpart
    of `_jitted_render` and `_eval_step_fn`. `fn(means, log_scales, quats,
    sh_coeffs, raw_opacities, cam, extra, rcfg)` is the body (`render`, with
    `extra` the background; or eval's step, with `extra` the ground truth);
    `graph(means, log_scales, quats, sh_coeffs, raw_opacities, cam, extra)`
    returns its outputs, valid until its next call."""

    kind = "render"

    def __init__(self, rcfg: RenderConfig, n_splats: int, fn=render):
        _require_kernel_path(rcfg, "RenderGraph")
        super().__init__(lambda *inputs: fn(*inputs, rcfg),
                         what="RenderGraph")
        self.rcfg, self.n_splats = rcfg, n_splats

    def __call__(self, means, log_scales, quats, sh_coeffs, raw_opacities,
                 cam: CameraInputs, extra):
        if means.shape[0] != self.n_splats:
            raise ValueError(f"RenderGraph of {self.n_splats} splats given "
                             f"{means.shape[0]}")
        return super().__call__(means, log_scales, quats, sh_coeffs,
                                raw_opacities, cam, extra)


class RenderGraphs:
    """The process's render graphs (eval's and the viewer's): at most
    `size`, the least recently used freed first. `get(fn, rcfg, n_splats)`
    returns the graph for that key, made (not yet captured) if new."""

    def __init__(self, size: int = 2):
        self.size = size
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, fn, rcfg: RenderConfig, n_splats: int) -> RenderGraph:
        key = (fn, rcfg, n_splats)
        evicted = False
        with self._lock:
            graph = self._graphs.pop(key, None)
            if graph is None:
                graph = RenderGraph(rcfg, n_splats, fn)
                while len(self._graphs) >= self.size:
                    self._graphs.popitem(last=False)
                    count("graphs.evict.render")
                    evicted = True
            self._graphs[key] = graph
        if evicted:
            free_pools()
        return graph

    def keys(self) -> list:
        with self._lock:
            return list(self._graphs)

    def clear(self) -> None:
        """Free every graph and its pool."""
        with self._lock:
            had = bool(self._graphs)
            self._graphs.clear()
        if had:
            free_pools()


RENDER_GRAPHS = RenderGraphs(2)
