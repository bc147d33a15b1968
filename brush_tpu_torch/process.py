"""Process orchestration: dataset -> init -> train loop -> eval/export
(port of `brush_tpu/process.py`; the reference is brush-process,
crates/brush-process/src/{lib,train_stream}.rs).

`train_process` is the whole training run as a stream of typed messages
a consumer (the CLI) reads: it loads a dataset, initialises the splats
(init ply > point cloud > random), and drives `loop_step` over the
loader's views, with periodic evaluation, PLY export, full-state
checkpoints, resume, telemetry and the LOD bake. Within an iteration the
messages come in the JAX package's order: `overflow`, `step`, `refine`,
`eval`, `export`, `checkpoint`.

`loop_step` is one turn of the training loop: a `train_step`, then the
host's policy between steps. On the card, `train_process` takes the step
from a `graphs.StepGraphs` cache (the JAX package's jitted, donated
`step_cache`) and the refine from a `graphs.RefineGraphs` (its
`refine_jit`): one CUDA graph a key, replayed, the state the graphs' own
(a `LoopState` carries the caches; without them the turn runs eagerly, as
on the CPU and in a step shared over gloo):

* the previous step's `num_isects` and `num_chunks` are read one step
  behind (so the read never stalls the queue of the step just enqueued)
  and the tile-sort capacities grow on overflow; the overflowing steps
  themselves were no-ops on the device (the trainer's gate);
* every `refine_every` steps, until 95 % of the run: the splat capacity
  doubles ahead of demand once it is 80 % full, then `refine_step`.

With a live viewer (`slot=`), the dataset's views and a lazy decode of
their ground truth are attached to the slot, and a copy of the splats is
published to it at every log step (a graphed step writes into the state's
own tensors). `tcfg.lpips_loss_weight > 0` with
`pcfg.lpips_weights` adds the LPIPS term (models/lpips.py) to every step.

With a process `group` of W processes (parallel/data_parallel.py), each
batched step is shared: the first process runs the loader and picks the
step's B views, broadcasts their indices over a gloo group of host
integers (no wait on the card's stream), and the first gcd(B, W)
processes load, upload and render B / gcd of them each (the others
render none). The gradients and statistics are combined inside the step
(in its graph, over NCCL), so every process holds the same state, grows
the same capacities at the same turn (the overflow read follows the
MAX-combined statistics, so every process captures and replays the same
graphs in the same order) and refines alike. Only the first process
evaluates, exports, checkpoints, logs telemetry and publishes to a
viewer; the others yield their `step` and `refine` messages.

The LOD bake runs after the loop's graphs are freed: its scoring views
(train/lod.py) and its steps (a `StepGraphs` of its own, the JAX
`lod_cache`) are graphs too.

Stages (utils/tracing.py): each turn of the loop is a `run.turn` of unit
its step, with device marks from its first enqueue to its end; inside it
`run.load` (the loader and the batch's views; `run.loader_empty` counts
the turns that found no view ready), `run.upload` (the pinned uploads),
`run.readback` (the overflow read one step behind) and, at a log step,
`run.message` (its reads, telemetry and the slot's copy); each turn counts
`run.lens.<kind>`, the lens of the view it trains.

Every render of a dataset view goes through that view's own lens
(`RenderConfig.model` from `camera.model`): the turn's step, the LOD
steps and, in `eval_views`, each eval view; the LOD scoring renders its
views through the first one's. A step graph is keyed by its RenderConfig,
so a dataset of one lens captures one step graph, and one that mixes
lenses gets a graph of each lens in turn (the cache holds one).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from brush_tpu_torch.camera import fov_to_focal, lens_kind
from brush_tpu_torch.data.dataloader import SceneLoader
from brush_tpu_torch.data.formats import Dataset, LoadConfig, load_dataset
from brush_tpu_torch.data.scene import AlphaMode, image_dims
from brush_tpu_torch import graphs
from brush_tpu_torch.graphs import RefineGraphs, StepGraphs, copy_out
from brush_tpu_torch.io import ply as ply_io
from brush_tpu_torch.models.splats import Splats, grow_capacity
from brush_tpu_torch.ops.sh import rgb_to_sh_dc
from brush_tpu_torch.parallel.data_parallel import view_share
from brush_tpu_torch.render import (
    RenderAux,
    RenderConfig,
    camera_arrays,
    camera_inputs,
)
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.refine import refine_step
from brush_tpu_torch.train.splat_init import (
    create_random_splats,
    to_init_splats,
)
from brush_tpu_torch.train.trainer import (
    SceneBatch,
    TrainState,
    TrainStepStats,
    ViewShare,
    init_train_state,
    stack_batches,
    train_step,
    train_step_impl,
)
from brush_tpu_torch.utils.device import resolve_device
from brush_tpu_torch.utils.tracing import count, stage

# Host-byte budget for cached packed eval views (the reference byte-budgets
# its packed-batch cache at 6 GiB, brush-dataset/src/config.rs:8; eval
# splits are smaller, and these live in host memory, not on the card).
EVAL_CACHE_BUDGET = 2 << 30


@dataclasses.dataclass
class ProcessConfig:
    """brush-process/src/config.rs ProcessArgs (flattened); the JAX
    package's fields and defaults."""

    total_iters: int | None = None       # overrides tcfg when set
    eval_every: int = 1000
    export_every: int = 5000
    export_path: str = "./export_{iter}.ply"
    start_iter: int = 0
    seed: int = 42
    init_count: int = 10000              # random-init splat count
    use_pallas: bool = True              # False: the plain rasterizer
    sh_degree: int = 3
    log_every: int = 50
    ckpt_every: int = 0                  # full-state checkpoint cadence
    ckpt_dir: str = "./ckpt"
    resume_from: str | None = None       # checkpoint dir to resume from
    lpips_weights: str | None = None     # VGG-LPIPS weights (.npz)
    eval_save_to_disk: str | None = None  # dir for per-view eval PNGs
    views_per_batch: int = 1             # >1: batched multi-view steps
    init_isect_cap: int = 1 << 21        # starting capacities; grown on
    init_chunk_cap: int = 1 << 15        # overflow (tests set these tiny)


@dataclasses.dataclass
class TrainMessage:
    kind: str    # "overflow" | "step" | "refine" | "eval" | "export" |
    #              "checkpoint" | "report" | "warning"
    iter: int
    data: dict


@dataclasses.dataclass
class LoopState:
    """What the loop carries from one step to the next."""

    state: TrainState
    rcfg: RenderConfig                   # isect_cap / chunk_cap grow here
    it: int = 0                          # steps taken (host side)
    prev_aux: RenderAux | None = None    # the last step's aux, still unread
    graphs: StepGraphs | None = None     # the step's CUDA graphs, or eager
    refines: RefineGraphs | None = None  # the refine's, or eager


def _next_pow2(n: int) -> int:
    return 1 << max(10, int(math.ceil(math.log2(max(n, 1)))))


def _grow_state(state: TrainState, new_cap: int) -> TrainState:
    """Geometric capacity growth: pad splats, moments, refine record."""
    pad = new_cap - state.splats.capacity

    def pad0(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)

    opt = {name: dataclasses.replace(st, moment1=pad0(st.moment1),
                                     moment2=pad0(st.moment2))
           for name, st in state.opt.items()}
    refine = dataclasses.replace(
        state.refine, **{f.name: pad0(getattr(state.refine, f.name))
                         for f in dataclasses.fields(state.refine)})
    return dataclasses.replace(
        state, splats=grow_capacity(state.splats, new_cap), opt=opt,
        refine=refine)


def _step_turn(loop: LoopState, batch: SceneBatch, tcfg: TrainConfig,
               has_alpha: bool, alpha_is_mask: bool, batched: bool = False,
               lpips_model=None, share: ViewShare | None = None):
    """The training step of a turn and the overflow check of the step
    before it: (LoopState, stats, ["overflow"] or [])."""
    rcfg = loop.rcfg
    if loop.graphs is not None:
        state, stats, aux = loop.graphs(loop.state, batch, rcfg,
                                        has_alpha=has_alpha,
                                        alpha_is_mask=alpha_is_mask,
                                        share=share)
    else:
        state, stats, aux = train_step_impl(
            loop.state, batch, tcfg, rcfg, has_alpha=has_alpha,
            alpha_is_mask=alpha_is_mask, batched=batched,
            lpips_model=lpips_model, share=share)
    it = loop.it + 1
    messages = []

    # Overflow check, one step behind. On overflow grow the capacities; the
    # one or two no-op steps in the detection window are lost views, not
    # corrupt updates.
    if loop.prev_aux is not None:
        with stage("run.readback"):
            p_isects = int(loop.prev_aux.num_isects)
            p_chunks = (int(loop.prev_aux.num_chunks)
                        if loop.prev_aux.num_chunks is not None else 0)
        grown = {}
        if p_isects > rcfg.isect_cap:
            grown["isect_cap"] = _next_pow2(int(p_isects * 1.3))
        if p_chunks > rcfg.resolved_chunk_cap(state.splats.capacity):
            grown["chunk_cap"] = _next_pow2(int(p_chunks * 1.3))
        if grown:
            rcfg = dataclasses.replace(rcfg, **grown)
            messages.append(TrainMessage("overflow", it - 1, dict(
                isects=p_isects, chunks=p_chunks, isect_cap=rcfg.isect_cap,
                chunk_cap=rcfg.resolved_chunk_cap(state.splats.capacity))))
    return (dataclasses.replace(loop, state=state, rcfg=rcfg, it=it,
                                prev_aux=aux), stats, messages)


def _memory_mb(dev: torch.device) -> dict:
    """The card's memory in use and its size, MiB (none on the CPU)."""
    if dev.type != "cuda":
        return {}
    total = torch.cuda.get_device_properties(dev).total_memory
    return dict(mem_used_mb=round(torch.cuda.memory_allocated(dev) / 2**20, 1),
                mem_limit_mb=round(total / 2**20, 1))


def _refine_turn(loop: LoopState, tcfg: TrainConfig,
                 view_centers: torch.Tensor, view_focals: torch.Tensor):
    """The refine of a turn, on its cadence: every refine_every until 95 %
    progress (train_stream.rs:321-327), on the loop's RefineGraphs where it
    has them (the statistics are read after the graph, from its copies).
    Returns (LoopState, ["refine"] or [])."""
    it, state = loop.it, loop.state
    if not (it % tcfg.refine_every == 0
            and it < tcfg.total_train_iters * 0.95):
        return loop, []
    cap = state.splats.capacity
    if int(state.splats.n_alive) > 0.8 * cap and cap < tcfg.max_splats:
        state = _grow_state(state, min(_next_pow2(cap * 2),
                                       _next_pow2(tcfg.max_splats)))
    with stage("refine", device=True):
        if loop.refines is not None:
            state, rstats = loop.refines(state, view_centers, view_focals)
        else:
            state, rstats = refine_step(state, tcfg, view_centers,
                                        view_focals)
    msg = TrainMessage("refine", it, dict(
        added=int(rstats.num_added), pruned=int(rstats.num_pruned),
        oversized=int(rstats.num_oversized),
        resampled=int(rstats.num_resampled),
        grad_grown=int(rstats.num_grad_grown),
        total=int(rstats.total_splats),
        **_memory_mb(state.splats.means.device)))
    return dataclasses.replace(loop, state=state), [msg]


def loop_step(
    loop: LoopState,
    batch: SceneBatch,
    tcfg: TrainConfig,
    view_centers: torch.Tensor,
    view_focals: torch.Tensor,
    has_alpha: bool = False,
    alpha_is_mask: bool = False,
) -> tuple[LoopState, TrainStepStats, list[TrainMessage]]:
    """One training step and the host policy after it (process.py's loop
    body). `view_centers` [V, 3] and `view_focals` [V] feed the refine's 3D
    filter. Returns the next LoopState, the step's statistics and the
    messages of this turn ("overflow", "refine")."""
    loop, stats, messages = _step_turn(loop, batch, tcfg, has_alpha,
                                       alpha_is_mask)
    loop, refined = _refine_turn(loop, tcfg, view_centers, view_focals)
    return loop, stats, messages + refined


# --------------------------------------------------------------------------
# the dataset-to-PLY run
# --------------------------------------------------------------------------


def _export_splats(path: str, splats: Splats) -> None:
    """Write a ply export; a `.compressed.ply` suffix selects SuperSplat
    chunk-quantized output (export.rs picks by the same convention)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    folded = splats.fold_min_scale()
    if path.endswith(".compressed.ply"):
        n = int(folded.n_alive)

        def rows(x):
            return x[:n].detach().cpu().numpy()

        ply_io.save_compressed_ply(
            path, means=rows(folded.means), log_scales=rows(folded.log_scales),
            quats=rows(folded.quats), sh_coeffs=rows(folded.sh_coeffs),
            raw_opacities=rows(folded.raw_opacities))
    else:
        Path(path).write_bytes(ply_io.splats_to_ply_bytes(folded))


def _attach_scene_to_slot(slot, ds: Dataset) -> None:
    """Expose dataset view poses + lazy GT decode to a live viewer
    (nearest-view snapping / training-view compare, SURVEY Appendix F)."""
    views = []
    all_views = []
    for split, scene in (("train", ds.train), ("eval", ds.eval)):
        if scene is None:
            continue
        for v in scene.views:
            views.append(dict(
                name=v.image_path.rsplit("/", 1)[-1], split=split,
                position=[float(x) for x in v.camera.position],
                rotation=[float(x) for x in v.camera.rotation],
                fov_x=float(v.camera.fov_x), fov_y=float(v.camera.fov_y)))
            all_views.append((scene.vfs, v))

    def gt_fn(i: int, max_dim: int = 640):
        from brush_tpu_torch.data.scene import load_image
        vfs, v = all_views[i]
        arr, _ = load_image(vfs, v.image_path, min(max_dim, 4096),
                            mask_path=v.mask_path)
        return (np.clip(np.asarray(arr[..., :3], np.float32), 0, 1)
                * 255).astype(np.uint8)

    slot.scene_views = views
    slot.gt_fn = gt_fn


def init_splats_for_dataset(ds: Dataset, tcfg: TrainConfig,
                            pcfg: ProcessConfig, device="cuda") -> Splats:
    """ply init > point-cloud init > random init (train_stream.rs:102-143)."""
    rng = np.random.default_rng(pcfg.seed)
    cams = [v.camera for v in ds.train.views]
    if ds.init_ply is not None:
        data = ply_io.load_splat_ply(ds.train.vfs.open(ds.init_ply))
        splats = to_init_splats(
            data.means, data.log_scales, data.rotations, data.sh_coeffs,
            data.raw_opacities,
            capacity=_next_pow2(int(data.num_splats * 2)), device=device)
    elif ds.init_points is not None and len(ds.init_points) > 0:
        sh = None
        if ds.init_colors is not None:
            sh = np.asarray(rgb_to_sh_dc(ds.init_colors),
                            np.float32)[:, None, :]
        splats = to_init_splats(
            ds.init_points, sh_coeffs=sh,
            capacity=_next_pow2(int(len(ds.init_points) * 2)), device=device)
    else:
        splats = create_random_splats(
            pcfg.init_count, cams, rng,
            scene_scale_override=tcfg.random_init_scene_scale,
            capacity=_next_pow2(pcfg.init_count * 4), device=device)
    return splats.with_sh_degree(pcfg.sh_degree)


def view_camera_arrays(ds: Dataset, max_resolution: int, device="cuda"):
    """(centers [V,3], focal_px [V]) for the Mip 3D filter
    (train_stream.rs per-view center/focal)."""
    dev = resolve_device(device)
    centers, focals = [], []
    for v in ds.train.views:
        w, h = image_dims(ds.train.vfs, v.image_path, max_resolution)
        centers.append(v.camera.position)
        focals.append(fov_to_focal(v.camera.fov_x, w, v.camera.model))
    return (torch.as_tensor(np.stack(centers), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.array(focals), dtype=torch.float32,
                            device=dev))


class PinnedUpload:
    """Host arrays -> tensors on the device. On the card each array goes
    through a pinned staging buffer, two a shape, each reused once its
    last copy has finished, and is copied with `non_blocking=True`: a copy
    from pageable memory would wait for all the work queued on the card
    (PyTorch synchronises the stream after it), so the host could not run
    ahead of the step before."""

    def __init__(self, device):
        self.dev = resolve_device(device)
        self._slots: dict = {}   # (shape, dtype) -> [[pinned buffer, event]]

    def __call__(self, host: np.ndarray) -> torch.Tensor:
        host = np.ascontiguousarray(host)
        if self.dev.type != "cuda":
            return torch.from_numpy(host).to(self.dev)
        slots = self._slots.setdefault((host.shape, host.dtype.str), [])
        if len(slots) < 2:
            slot = [torch.from_numpy(host).pin_memory(), None]
        else:
            slot = slots.pop(0)            # the least recently used buffer
            slot[1].synchronize()
            slot[0].numpy()[...] = host
        slots.append(slot)
        out = slot[0].to(self.dev, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out


def _scene_batch(view, upload: PinnedUpload) -> SceneBatch:
    """A loaded view on the device (its packed ground truth as int32
    words), ground truth and camera through the pinned uploads."""
    words = np.ascontiguousarray(view.gt_packed, np.uint32).view(np.int32)
    cam = camera_arrays(view.camera, view.img_size)
    return SceneBatch(gt_packed=upload(words), cam=cam._replace(**{
        f: upload(getattr(cam, f))
        for f in ("viewmat", "pinhole", "clamp_limits", "cam_pos")}))


def train_process(
    source: str,
    tcfg: TrainConfig | None = None,
    lcfg: LoadConfig | None = None,
    pcfg: ProcessConfig | None = None,
    on_message: Callable[[TrainMessage], None] | None = None,
    slot=None,
    telemetry_dir: str | None = None,
    device="cuda",
    group=None,
) -> Iterator[TrainMessage]:
    """Full training run as a message stream (train_stream.rs:34-503), on
    `device`. `slot` (viewer.slot.Slot) receives live splat snapshots.
    `group` (a torch.distributed process group, every process of the run
    calling with its own device) shares each batched step among its
    processes: gcd(W, `pcfg.views_per_batch`) of them render."""
    dev = resolve_device(device)
    tcfg = tcfg or TrainConfig()
    lcfg = lcfg or LoadConfig()
    pcfg = pcfg or ProcessConfig()
    world = 1 if group is None else dist.get_world_size(group)
    lead = group is None or dist.get_rank(group) == 0
    if not lead:
        # The first process alone writes, logs and serves.
        slot, telemetry_dir = None, None
    telem = None
    if telemetry_dir:
        from brush_tpu_torch.utils.telemetry import TelemetryLogger
        telem = TelemetryLogger(telemetry_dir)
    if pcfg.total_iters:
        tcfg = dataclasses.replace(tcfg, total_train_iters=pcfg.total_iters)

    def emit(msg: TrainMessage) -> TrainMessage:
        if on_message:
            on_message(msg)
        return msg

    ds = load_dataset(source, lcfg)
    if telem:
        telem.log_scene(ds)
    if slot is not None:
        _attach_scene_to_slot(slot, ds)
    splats = init_splats_for_dataset(ds, tcfg, pcfg, device=dev)
    state = init_train_state(splats, pcfg.seed)

    if pcfg.resume_from:
        # Full-state resume (params + Adam moments + refine record + the
        # generator) — more than the reference's ply + --start-iter (§5.4).
        from brush_tpu_torch.train.checkpoint import (
            checkpoint_meta,
            load_checkpoint,
        )
        meta = checkpoint_meta(pcfg.resume_from)
        if meta["sh_degree"] != pcfg.sh_degree:
            raise ValueError(
                f"checkpoint sh_degree {meta['sh_degree']} != "
                f"configured {pcfg.sh_degree}")
        if meta["capacity"] != state.splats.capacity:
            if meta["capacity"] > state.splats.capacity:
                state = _grow_state(state, meta["capacity"])
            else:
                raise ValueError(
                    f"checkpoint capacity {meta['capacity']} smaller than "
                    f"init capacity {state.splats.capacity}; lower "
                    "init_count or re-export")
        state = load_checkpoint(pcfg.resume_from, state)
        pcfg = dataclasses.replace(pcfg, start_iter=meta["iteration"])

    loader = SceneLoader(ds.train, seed=pcfg.seed,
                         alpha_mode=lcfg.alpha_mode)
    host_group = None
    if world > 1:
        if not lead:
            # The first process picks the views; the others load theirs
            # by index (`load_view` and its cache need no thread).
            loader.stop()
        host_group = (group if dist.get_backend(group) == "gloo"
                      else dist.new_group(backend="gloo"))
    upload = PinnedUpload(dev)
    centers, focals = view_camera_arrays(ds, lcfg.max_resolution, device=dev)
    eval_cache: dict = {}  # packed eval views, decoded once per run
    lpips_model = None
    if tcfg.lpips_loss_weight > 0.0 and pcfg.lpips_weights:
        from brush_tpu_torch.models.lpips import load_lpips
        lpips_model = load_lpips(pcfg.lpips_weights, device=dev)
    # A step shared by several processes is batched, even of one view: the
    # processes without a view take the batched step's zeros.
    batched = pcfg.views_per_batch > 1 or world > 1
    alpha_is_mask = lcfg.alpha_mode == AlphaMode.MASKED

    # Initial intersection / gradient-chunk capacities, grown on overflow
    # (replaces the reference's exact-count readback, SURVEY.md §7). The
    # image size follows each view; the grown capacities carry over.
    first = ds.train.views[0]
    # The JAX package's jitted, donated step and its refine_jit: CUDA graphs
    # on the card (the kernel path, one process or NCCL; a step shared over
    # gloo stays eager, as on the CPU).
    graphed = graphs.capturable(dev, pcfg.use_pallas, group)
    steps = (StepGraphs(tcfg, batched=batched, lpips_model=lpips_model)
             if graphed else None)
    refines = RefineGraphs(tcfg) if graphed else None
    loop = LoopState(
        state=state, it=pcfg.start_iter, graphs=steps, refines=refines,
        rcfg=RenderConfig(
            img_size=image_dims(ds.train.vfs, first.image_path,
                                lcfg.max_resolution),
            sh_degree=pcfg.sh_degree, model=first.camera.model,
            isect_cap=pcfg.init_isect_cap, chunk_cap=pcfg.init_chunk_cap,
            use_pallas=pcfg.use_pallas))
    t_start = time.perf_counter()
    try:
        while loop.it < tcfg.total_train_iters:
            with stage("run.turn", device=True,
                       unit=loop.it + 1) as turn:
                with stage("run.load"):
                    views = []
                    if lead:
                        if loader.empty():
                            count("run.loader_empty")
                        views = [next(loader)]
                    if lead and batched:
                        # B views of one size and lens (datasets are near-
                        # uniform; odd ones fall back to repeating until the
                        # batch fills).
                        view = views[0]
                        tries = 0
                        while (len(views) < pcfg.views_per_batch
                               and tries < 4 * pcfg.views_per_batch):
                            v = next(loader)
                            tries += 1
                            if (v.img_size == view.img_size
                                    and v.has_alpha == view.has_alpha
                                    and v.camera.model == view.camera.model):
                                views.append(v)
                        if len(views) < pcfg.views_per_batch:
                            # Padding by repetition biases the mean-loss
                            # gradient toward the repeated view: surface it.
                            yield emit(TrainMessage("warning", loop.it, dict(
                                message=f"batch padded by repeating a view "
                                        f"({len(views)}/"
                                        f"{pcfg.views_per_batch} distinct; "
                                        f"mixed image sizes or lenses in "
                                        f"dataset?) — "
                                        f"the mean-loss gradient is biased "
                                        f"toward the repeat")))
                        while len(views) < pcfg.views_per_batch:
                            views.append(views[0])
                    share = None
                    if world > 1:
                        share = view_share(group, pcfg.views_per_batch)
                        views, view = _my_views(views, share, loader,
                                                host_group)
                    else:
                        view = views[0]
                # The turn's device span starts at its first enqueue.
                turn.mark_device_start()
                with stage("run.upload"):
                    if batched:
                        batch = stack_batches([_scene_batch(v, upload)
                                               for v in views or [view]])
                        if not views:
                            # None of this step's views: an empty batch of
                            # their shape (the step adds zeros).
                            batch = SceneBatch(
                                gt_packed=batch.gt_packed[:0],
                                cam=type(batch.cam)(
                                    *(x[:0] for x in batch.cam)))
                    else:
                        batch = _scene_batch(view, upload)
                loop = dataclasses.replace(loop, rcfg=dataclasses.replace(
                    loop.rcfg, img_size=view.img_size,
                    model=view.camera.model))
                count(f"run.lens.{lens_kind(view.camera.model)}")
                loop, stats, overflows = _step_turn(
                    loop, batch, tcfg, view.has_alpha, alpha_is_mask,
                    batched=batched, lpips_model=lpips_model, share=share)
                it, state = loop.it, loop.state
                for msg in overflows:
                    yield emit(msg)

                if it % pcfg.log_every == 0 or it == tcfg.total_train_iters:
                    with stage("run.message"):
                        aux = loop.prev_aux
                        msg = TrainMessage("step", it, dict(
                            loss=float(stats.loss),
                            num_visible=int(stats.num_visible),
                            splats=int(state.splats.n_alive),
                            isects=int(aux.num_isects),
                            # Slots emitted under bbox-tail semantics
                            # (exact tile test bypassed past B_SCAN).
                            bbox_tail_isects=int(aux.num_bbox_tail),
                            sps=pcfg.log_every / max(
                                time.perf_counter() - t_start, 1e-9),
                        ))
                        t_start = time.perf_counter()
                        if telem:
                            telem.log_scalars(it, **{
                                k: v for k, v in msg.data.items()
                                if isinstance(v, (int, float))})
                        if slot is not None:
                            slot.set(0, copy_out(state.splats))
                    yield emit(msg)

                loop, refined = _refine_turn(loop, tcfg, centers, focals)
                state = loop.state
                for msg in refined:
                    if telem:
                        d = msg.data
                        telem.log_scalars(
                            it, refine_added=d["added"],
                            refine_pruned=d["pruned"],
                            refine_oversized=d["oversized"],
                            refine_resampled=d["resampled"],
                            refine_grad_grown=d["grad_grown"],
                            splats_total=d["total"],
                            **{k: d[k] for k in ("mem_used_mb", "mem_limit_mb")
                               if k in d})
                        telem.log_splat_distribution(it, state.splats)
                        telem.log_memory(it)
                    yield emit(msg)

                if not lead:
                    continue
                if pcfg.eval_every and it % pcfg.eval_every == 0 and ds.eval:
                    emsg = _run_eval(state, ds, lcfg, pcfg, it,
                                     loop.rcfg.isect_cap, cache=eval_cache)
                    if telem:
                        telem.log_scalars(it, **emsg.data)
                    yield emit(emsg)

                if pcfg.export_every and it % pcfg.export_every == 0:
                    path = pcfg.export_path.format(iter=it)
                    _export_splats(path, state.splats)
                    yield TrainMessage("export", it, dict(path=path))

                if pcfg.ckpt_every and it % pcfg.ckpt_every == 0:
                    from brush_tpu_torch.train.checkpoint import (
                        save_checkpoint,
                    )
                    save_checkpoint(pcfg.ckpt_dir, state, iteration=it)
                    yield TrainMessage("checkpoint", it,
                                       dict(path=pcfg.ckpt_dir))
    finally:
        loader.stop()
        # The loop's graphs and their pools go before the LOD bake, which
        # steps at another capacity and image size.
        for cache in (steps, refines):
            if cache is not None:
                cache.clear()
        if host_group is not None and host_group is not group:
            dist.destroy_process_group(host_group)

    if not lead:
        return
    it, state = loop.it, loop.state
    isect_cap, chunk_cap = loop.rcfg.isect_cap, loop.rcfg.chunk_cap
    # Final export.
    path = pcfg.export_path.format(iter=it)
    _export_splats(path, state.splats)
    yield TrainMessage("export", it, dict(path=path, final=True))

    if telem:
        from brush_tpu_torch.utils.report import write_report
        rpath = write_report(telem.dir)
        yield TrainMessage("report", it, dict(path=str(rpath)))

    # --- LOD baking phases (train_stream.rs:220-291, lod.rs) ---
    for level in range(1, tcfg.lod_levels + 1):
        state = _bake_lod_level(state, ds, lcfg, pcfg, tcfg, level,
                                isect_cap, chunk_cap, upload)
        lod_path = path.replace(".ply", f"_lod{level}.ply")
        _export_splats(lod_path, state.splats)
        yield TrainMessage("export", it, dict(
            path=lod_path, lod_level=level,
            splats=int(state.splats.n_alive)))
    if telem:
        telem.close()


def _my_views(views: list, share: ViewShare, loader: SceneLoader,
              host_group) -> tuple[list, object]:
    """This process's views of a shared step and one view of the step: the
    first process's picks (`views`, its own loaded) go to every process as
    indices over the host group, and each loads its rows of them; a
    process with no rows loads the first pick for the step's image size
    and ground-truth shape."""
    idx = torch.tensor([v.view_index for v in views] if views
                       else [0] * share.total, dtype=torch.int64)
    dist.broadcast(idx, src=dist.get_global_rank(host_group, 0),
                   group=host_group)
    rows = range(share.first, share.first + share.count)
    if views:
        mine = [views[i] for i in rows]
        return mine, views[0]
    mine = [loader.load_view(int(idx[i])) for i in rows]
    return mine, mine[0] if mine else loader.load_view(int(idx[0]))


def _bake_lod_level(state: TrainState, ds: Dataset, lcfg: LoadConfig,
                    pcfg: ProcessConfig, tcfg: TrainConfig, level: int,
                    isect_cap: int, chunk_cap: int,
                    upload: PinnedUpload) -> TrainState:
    """One LOD level: PUP scores over a handful of training views at half
    resolution, decimation to `lod_decimation_keep` percent, then
    `lod_refine_steps` steps on downscaled images with growth off; on the
    card the scoring views and the steps are graphs (the steps' a
    `StepGraphs` of their own, the JAX `lod_cache` keyed by image size,
    freed at the end)."""
    from brush_tpu_torch.train.lod import decimate_to_count, pup_scores

    score_views = ds.train.views[::max(1, len(ds.train.views) // 8)]
    w, h = image_dims(ds.train.vfs, score_views[0].image_path,
                      lcfg.max_resolution, subscale=2)
    score_rcfg = RenderConfig(
        img_size=(w, h), sh_degree=pcfg.sh_degree,
        model=score_views[0].camera.model, isect_cap=isect_cap,
        chunk_cap=chunk_cap, use_pallas=pcfg.use_pallas)
    cams = [camera_inputs(v.camera, (w, h), device=upload.dev)
            for v in score_views]
    scores = pup_scores(state.splats, cams, score_rcfg, level, n_probes=4)
    keep = int(int(state.splats.n_alive)
               * (tcfg.lod_decimation_keep / 100.0))
    state = init_train_state(decimate_to_count(state.splats, scores, keep),
                             state.rng)

    sub = max(1, round(100 / max(tcfg.lod_image_scale, 1)))
    lod_loader = SceneLoader(dataclasses.replace(ds.train, subscale=sub),
                             seed=pcfg.seed + level,
                             alpha_mode=lcfg.alpha_mode)
    lod_tcfg = dataclasses.replace(tcfg, growth_stop_iter=0,
                                   total_train_iters=tcfg.lod_refine_steps)
    steps = (StepGraphs(lod_tcfg)
             if graphs.capturable(upload.dev, pcfg.use_pallas) else None)
    try:
        for _ in range(tcfg.lod_refine_steps):
            view = next(lod_loader)
            rcfg = RenderConfig(img_size=view.img_size,
                                sh_degree=pcfg.sh_degree,
                                model=view.camera.model, isect_cap=isect_cap,
                                use_pallas=pcfg.use_pallas)
            batch = _scene_batch(view, upload)
            if steps is not None:
                state, _, _ = steps(state, batch, rcfg)
            else:
                state, _, _ = train_step(state, batch, lod_tcfg, rcfg)
    finally:
        lod_loader.stop()
        if steps is not None:
            steps.clear()
    return state


def _run_eval(state, ds, lcfg, pcfg, it, isect_cap, cache=None):
    """Evaluate on the eval split. `cache` (a dict owned by the caller's
    run) keeps the decoded and packed eval views across evals, byte-
    budgeted like the reference's packed-batch cache (scene_loader.rs:
    57-163, config.rs:8): host numpy up to EVAL_CACHE_BUDGET bytes, copied
    to the device each eval; views past the budget are decoded each eval."""
    from brush_tpu_torch.data.scene import load_image, pack_rgba
    from brush_tpu_torch.train.eval import eval_views

    key = ("eval_pairs", lcfg.max_resolution, lcfg.alpha_mode)
    if cache is None or key not in cache:
        cached_pairs = []   # (camera, packed ndarray) within budget
        tail_views = []     # views past the budget: re-decode per eval
        img_size = None
        budget = EVAL_CACHE_BUDGET
        for v in ds.eval.views:
            if budget <= 0:
                tail_views.append(v)
                continue
            arr, _ = load_image(ds.eval.vfs, v.image_path,
                                lcfg.max_resolution, mask_path=v.mask_path)
            packed = pack_rgba(arr, lcfg.alpha_mode)
            budget -= packed.nbytes
            cached_pairs.append((v.camera, packed))
            img_size = (packed.shape[1], packed.shape[0])
        if cache is not None:
            cache[key] = (cached_pairs, tail_views, img_size)
    else:
        cached_pairs, tail_views, img_size = cache[key]
    pairs = list(cached_pairs)
    for v in tail_views:
        arr, _ = load_image(ds.eval.vfs, v.image_path,
                            lcfg.max_resolution, mask_path=v.mask_path)
        packed = pack_rgba(arr, lcfg.alpha_mode)
        pairs.append((v.camera, packed))
        img_size = img_size or (packed.shape[1], packed.shape[0])
    rcfg = RenderConfig(img_size=img_size, sh_degree=pcfg.sh_degree,
                        isect_cap=isect_cap, use_pallas=pcfg.use_pallas,
                        forward_only=pcfg.use_pallas)
    stats = eval_views(state.splats, pairs, rcfg,
                       save_dir=pcfg.eval_save_to_disk, step=it)
    return TrainMessage("eval", it, dict(psnr=stats.psnr, ssim=stats.ssim))
