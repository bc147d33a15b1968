"""The JAX package's compiled, donated programs as CUDA graphs.

The JAX package never runs its main path op by op. `train_process` keeps a
`step_cache` of `jax.jit(train_step_impl, donate_argnums=0)` keyed by
(img_size, has_alpha, alpha_is_mask, isect_cap, chunk_cap, capacity)
(brush_tpu/process.py:221-258); eval renders through `_eval_step_fn`
(brush_tpu/train/eval.py:31) and the viewer through `_jitted_render`
(brush_tpu/viewer/service.py:30), jitted renders cached by RenderConfig.
PyTorch runs eagerly: a frame or a training step is a few thousand
launches the host enqueues one by one. A CUDA graph captures them once and
replays them with one launch.

* `StepGraph`: one `step_cache` entry. Its first call runs the step
  eagerly on a side stream (the warm-up PyTorch asks for before a capture;
  it is the real step, so its result is returned), then captures
  `step_body`: `train_step_impl` followed by copies of the new state into
  the graph's own state tensors, the counterpart of donation. After a
  replay the caller's `TrainState` is the graph's. A state that is not the
  graph's own (after a refine, a capacity growth or a checkpoint load) is
  copied in first, tensor by tensor where the data pointers differ. The
  step's statistics and render aux are copied out into fresh tensors after
  each replay, since the next replay overwrites the graph's own (the
  training loop reads one step's aux after the next step is queued). The
  state's CUDA generator is registered with the graph, so each replay
  draws the numbers the eager step would.
* `RenderGraph`: `_jitted_render` and `_eval_step_fn`. It captures a
  forward-only render (or eval's render, 8-bit round trip and metrics)
  over its own copies of the splat arrays, camera tensors and background
  (or ground truth); arrays that are not already those are copied in. Its
  outputs are the graph's own tensors, valid until its next call.

The graphs run on the card only: called with CPU tensors they raise, and
the CPU path is the plain eager functions (`train_step_impl`, `render`).
They need the kernel path (`use_pallas=True`): the plain rasterizer reads
its longest tile's length to the host, which a capture refuses. Nothing in
a captured step or frame copies from the host or reads a value back (the
constants are fills on the card, utils/device.device_constant).

Caches. `StepGraphs` keeps one StepGraph, keyed as the JAX `step_cache`
plus the rest of the RenderConfig and the state's layout (a refine attaches
the 3D filter floor, which a jit retraces on too); `RENDER_GRAPHS` keeps two
RenderGraphs, keyed by the body, the RenderConfig (the JAX caches' key) and
the splat count (which a jit retraces on). The JAX caches hold up to eight
entries (`lru_cache(maxsize=8)`), but a graph holds its private memory pool,
every intermediate of its step or frame (gigabytes at 1M splats), for as
long as it lives: so a key change (capacity growth, `isect_cap` growth
after an overflow, a new image size) frees the old graph and its pool.

Capture. One capture at a time in the process (a lock). The capture mode
is `thread_local`: autograd runs the rasterizer's backward on a thread of
its own, which launches onto the capture stream, and a viewer's server
threads may go on with eager work while the trainer captures. Freeing a
graph's pool (`torch.cuda.empty_cache`) synchronises the device, which a
capture refuses, so it takes the capture lock too. Stage timing
events (`utils/tracing.record_stages`) are off inside a warm-up and a
capture.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import NamedTuple

import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.render import RenderConfig, render
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.trainer import SceneBatch, TrainState, train_step_impl
from brush_tpu_torch.utils.tracing import stages_off

_capture_lock = threading.Lock()


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------


def _map(tree, fn):
    """`tree` with every tensor replaced by fn(tensor): dataclasses, dicts,
    NamedTuples and tuples are rebuilt, anything else (None, numbers, a
    generator) is kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


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


def _static_batch(batch, device):
    """The graph's own copy of a batch (or camera): every tensor cloned, a
    float fisheye bound held as a 0-d tensor so each call can write it."""
    def own(x):
        return x.clone()
    out = _map(batch, own)
    cam = out.cam if isinstance(out, SceneBatch) else out
    if isinstance(cam.half_max_render_fov, float):
        cam = cam._replace(half_max_render_fov=torch.full(
            (), cam.half_max_render_fov, dtype=torch.float32, device=device))
        out = out._replace(cam=cam) if isinstance(out, SceneBatch) else cam
    return out


def _require_cuda(what: str, tensors) -> torch.device:
    devices = {t.device for t in tensors if torch.is_tensor(t)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(
            f"{what} runs on the card only (got tensors on "
            f"{sorted(str(d) for d in devices)}); the CPU path is the plain "
            f"eager functions, train_step_impl and render")
    return next(iter(devices))


def _require_kernel_path(rcfg: RenderConfig, what: str) -> None:
    if not rcfg.use_pallas:
        raise ValueError(f"{what} needs RenderConfig(use_pallas=True): the "
                         f"plain rasterizer reads its longest tile's length "
                         f"to the host, which a capture refuses")


def _capture(graph, body, generator=None):
    """Capture `body()` into `graph` and return its outputs (tensors of the
    graph's pool). The launches of the capture go to an open
    `kernels.capture()`, as an eager call's would."""
    if generator is not None:
        graph.register_generator_state(generator)
    with _capture_lock, stages_off():
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            return body()


def _free_pools() -> None:
    """Return the pools of freed graphs to the card. The allocator
    synchronises the device to release cached blocks and refuses to while
    a capture runs, so this waits for a capture on another thread (the
    trainer's and a viewer's threads share the process)."""
    with _capture_lock:
        torch.cuda.empty_cache()


def _warm_up(body):
    """Run `body()` once eagerly on a side stream (PyTorch's rule before a
    capture), its kernel launches counted but kept out of any open
    `kernels.capture()` (the capture's own launches go there)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), stages_off(), kernels.capture():
        out = body()
    torch.cuda.current_stream().wait_stream(side)
    return out


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------


def step_body(state: TrainState, batch: SceneBatch, tcfg: TrainConfig,
              rcfg: RenderConfig, has_alpha: bool = False,
              alpha_is_mask: bool = False, batched: bool = False,
              lpips_model=None):
    """What a StepGraph captures: `train_step_impl`, then the new state
    copied into `state`'s own tensors (donation). Returns (stats, aux), the
    step's own tensors. Runs eagerly on any device."""
    new, stats, aux = train_step_impl(
        state, batch, tcfg, rcfg, has_alpha=has_alpha,
        alpha_is_mask=alpha_is_mask, batched=batched, lpips_model=lpips_model)
    load_into(dataclasses.replace(state, rng=None),
              dataclasses.replace(new, rng=None))
    return stats, aux


class StepKey(NamedTuple):
    """The JAX `step_cache` key (brush_tpu/process.py:232-233), then what
    else a graph is fixed to: the rest of the RenderConfig and the state's
    layout."""

    img_size: tuple
    has_alpha: bool
    alpha_is_mask: bool
    isect_cap: int
    chunk_cap: int | None
    capacity: int
    rcfg: RenderConfig
    layout: tuple


def step_key(state: TrainState, rcfg: RenderConfig, has_alpha: bool,
             alpha_is_mask: bool) -> StepKey:
    return StepKey(tuple(rcfg.img_size), has_alpha, alpha_is_mask,
                   rcfg.isect_cap, rcfg.chunk_cap, state.splats.capacity,
                   rcfg, layout(dataclasses.replace(state, rng=None)))


class StepGraph:
    """`train_step_impl` captured into a CUDA graph, with donation: see the
    module docstring. `graph(state, batch) -> (state, stats, aux)`."""

    def __init__(self, tcfg: TrainConfig, rcfg: RenderConfig,
                 has_alpha: bool = False, alpha_is_mask: bool = False,
                 batched: bool = False, lpips_model=None):
        _require_kernel_path(rcfg, "StepGraph")
        if rcfg.forward_only:
            raise ValueError("StepGraph needs a differentiable render: "
                             "RenderConfig(forward_only=False)")
        self.tcfg, self.rcfg = tcfg, rcfg
        self.kw = dict(has_alpha=has_alpha, alpha_is_mask=alpha_is_mask,
                       batched=batched, lpips_model=lpips_model)
        self.state: TrainState | None = None   # the graph's own
        self._batch = None
        self._outs = None
        self._graph = None

    def _body(self):
        return step_body(self.state, self._batch, self.tcfg, self.rcfg,
                         **self.kw)

    def __call__(self, state: TrainState, batch: SceneBatch):
        dev = _require_cuda("StepGraph", [
            x for _, x in _leaves(dataclasses.replace(state, rng=None))
            + _leaves(batch)])
        if self._graph is None:
            self.state = dataclasses.replace(
                copy_out(dataclasses.replace(state, rng=None)), rng=state.rng)
            self._batch = _static_batch(batch, dev)
            # The warm-up is this call's step: the graph's state then holds
            # its result, which the first replay steps on from.
            stats, aux = copy_out(_warm_up(self._body))
            graph = torch.cuda.CUDAGraph()
            self._outs = _capture(graph, self._body, generator=state.rng)
            self._graph = graph
            return self.state, stats, aux
        load_into(dataclasses.replace(self.state, rng=None),
                  dataclasses.replace(state, rng=None))
        if state.rng is not self.state.rng:
            self.state.rng.set_state(state.rng.get_state())
        load_into(self._batch, batch)
        self._graph.replay()
        stats, aux = copy_out(self._outs)
        return self.state, stats, aux


class StepGraphs:
    """`train_process`'s step cache on the card: one StepGraph, keyed by
    `step_key`; a key change frees the old graph and its pool first.
    `steps(state, batch, rcfg, has_alpha, alpha_is_mask)` takes one step."""

    def __init__(self, tcfg: TrainConfig, batched: bool = False,
                 lpips_model=None):
        self.tcfg, self.batched, self.lpips_model = tcfg, batched, lpips_model
        self.key: StepKey | None = None
        self.graph: StepGraph | None = None
        self.captures = 0

    def __call__(self, state, batch, rcfg, has_alpha=False,
                 alpha_is_mask=False):
        key = step_key(state, rcfg, has_alpha, alpha_is_mask)
        if key != self.key:
            self.clear()
            self.graph = StepGraph(self.tcfg, rcfg, has_alpha, alpha_is_mask,
                                   self.batched, self.lpips_model)
            self.key = key
            self.captures += 1
        return self.graph(state, batch)

    def clear(self) -> None:
        """Free the graph and its pool (the state it holds lives on in the
        caller's TrainState)."""
        had = self.graph is not None
        self.graph, self.key = None, None
        if had:
            _free_pools()


# --------------------------------------------------------------------------
# renders
# --------------------------------------------------------------------------


class RenderGraph:
    """A render without gradients captured into a CUDA graph: the counterpart
    of `_jitted_render` and `_eval_step_fn`. `fn(means, log_scales, quats,
    sh_coeffs, raw_opacities, cam, extra, rcfg)` is the body (`render`, with
    `extra` the background; or eval's step, with `extra` the ground truth);
    `graph(means, log_scales, quats, sh_coeffs, raw_opacities, cam, extra)`
    returns its outputs, the graph's own tensors, valid until its next
    call."""

    def __init__(self, rcfg: RenderConfig, n_splats: int, fn=render):
        _require_kernel_path(rcfg, "RenderGraph")
        self.rcfg, self.n_splats, self.fn = rcfg, n_splats, fn
        self._inputs = None
        self._outs = None
        self._graph = None

    def _body(self):
        with torch.no_grad():
            return self.fn(*self._inputs, self.rcfg)

    def __call__(self, means, log_scales, quats, sh_coeffs, raw_opacities,
                 cam: CameraInputs, extra):
        inputs = (means, log_scales, quats, sh_coeffs, raw_opacities, cam,
                  extra)
        dev = _require_cuda("RenderGraph", [
            x for _, x in _leaves(inputs)])
        if means.shape[0] != self.n_splats:
            raise ValueError(f"RenderGraph of {self.n_splats} splats given "
                             f"{means.shape[0]}")
        if self._graph is None:
            self._inputs = tuple(x.clone() for x in inputs[:5]) + (
                _static_batch(cam, dev), extra.clone())
            _warm_up(self._body)
            graph = torch.cuda.CUDAGraph()
            self._outs = _capture(graph, self._body)
            self._graph = graph
        else:
            load_into(self._inputs, inputs)
        self._graph.replay()
        return self._outs


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
                    evicted = True
            self._graphs[key] = graph
        if evicted:
            _free_pools()
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
            _free_pools()


RENDER_GRAPHS = RenderGraphs(2)
