"""Multi-device training over camera views (port of
`brush_tpu/parallel/data_parallel.py`).

The natural multi-device axis of 3DGS is the view batch: every process
holds the same full `TrainState` (splats, moments, refine record and
generator, as the JAX package's replicated sharding does), renders and
backpropagates its own rows of the step's B views, and the gradients are
summed across the processes before the optimizer, which then runs alike
everywhere. JAX gets the sum from the sharding (XLA inserts the psum);
here it is `torch.distributed`:

* one `all_reduce` (SUM) of one flat buffer: the five parameter
  gradients, the refine-weight and visibility holder gradients, and this
  process's part of the loss (its view losses over B);
* one `all_reduce` (MAX) of the render statistics that the one-device
  batched step max-combines: the counts, `visible` and `max_radius`. It
  runs before the overflow gate, so every process takes the same branch.

The step is `train_step_impl` with a `ViewShare` (train/trainer.py): the
one-device batched step is the same function with a share that covers
every view and reduces nothing. The views go to g = gcd(B, W) processes,
as the JAX package trains on gcd(B, devices) devices: process r < g
renders views [r * B / g, (r + 1) * B / g); the others render none, add
zeros to the SUM and to the MAX (every statistic there is >= 0) and take
the same update, so every process still holds the same state.

On the card, over NCCL (or one process), the step runs as a CUDA graph
(`graphs.StepGraphs`, the JAX package's jitted, donated step) with the
collectives captured in it; NCCL builds its communicator at the first
collective, which the graph's eager warm-up step makes. Over gloo the
step stays eager: gloo's collectives go through the host, which a capture
cannot hold. `step.graphs` is the graph cache, or None for an eager step.

Usage, one process a device (`torchrun --nproc-per-node N`):

    group, world, device = view_group()      # None, 1, cuda for one
    step = make_dp_train_step(group, tcfg, rcfg)
    state, stats, aux = step(state, batch)   # batch leaves have leading [B]
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from brush_tpu_torch import graphs
from brush_tpu_torch.render import RenderAux, RenderConfig
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.trainer import (  # noqa: F401  (re-exported)
    SceneBatch,
    TrainState,
    ViewShare,
    stack_batches,
    train_step_impl,
)
from brush_tpu_torch.utils.device import resolve_device

# The render statistics the step max-combines across processes, besides
# the per-splat `visible` and `max_radius`.
_COUNTS = ("num_visible", "num_isects", "num_bbox_tail",
           "max_isects_per_tile", "num_chunks")


def choose_backend(device: torch.device, local_world: int) -> str:
    """gloo on the CPU; NCCL when every process of a host has a card of its
    own; gloo when processes share a card (NCCL refuses two processes on
    one device)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def view_group(device="cuda"):
    """Join the processes of a multi-device run from the environment that
    `torchrun` sets (WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). Returns (process group, world size W, this
    process's device): (None, 1, device) for one process. On the card a
    process takes `cuda:LOCAL_RANK` (modulo the cards present, when
    processes share one)."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None, 1, dev
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, int(os.environ.get(
        "LOCAL_WORLD_SIZE", str(world))))
    dist.init_process_group(backend, init_method="env://")
    return dist.group.WORLD, world, dev


def view_share(group, n_views: int) -> ViewShare:
    """This process's share of a step of `n_views` views: its rows and the
    reduction across `group` (None: every view, no reduction). The views
    go to the first gcd(B, W) processes, B / gcd each; the rest render
    none."""
    if group is None:
        return ViewShare(first=0, total=n_views, count=n_views)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    sharing = math.gcd(n_views, world)
    count = n_views // sharing if rank < sharing else 0
    return ViewShare(first=min(rank * count, n_views), total=n_views,
                     count=count, group=group,
                     reduce=lambda g, loss, aux: reduce_step(group, g, loss,
                                                             aux))


def reduce_step(group, grads: list, loss: torch.Tensor, aux: RenderAux):
    """One SUM of the gradients and the loss, one MAX of the render
    statistics, across `group`: the `ViewShare.reduce` of a process."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    parts = torch.split(flat, [g.numel() for g in grads] + [1])
    grads = [p.view_as(g) for p, g in zip(parts, grads)]

    # float64 holds every int32 count and float32 statistic exactly.
    names = [k for k in _COUNTS if getattr(aux, k) is not None]
    per_splat = (aux.visible, aux.max_radius)
    stats = torch.cat([torch.stack([getattr(aux, k) for k in names]).to(
        torch.float64)] + [x.reshape(-1).to(torch.float64)
                           for x in per_splat])
    dist.all_reduce(stats, op=dist.ReduceOp.MAX, group=group)
    counts, visible, max_radius = torch.split(
        stats, [len(names)] + [x.numel() for x in per_splat])
    aux = dataclasses.replace(
        aux, **{k: counts[i].to(getattr(aux, k).dtype)
                for i, k in enumerate(names)},
        visible=visible.to(aux.visible.dtype).view_as(aux.visible),
        max_radius=max_radius.to(aux.max_radius.dtype).view_as(
            aux.max_radius))
    return grads, parts[-1].reshape(()), aux


def make_dp_train_step(group, tcfg: TrainConfig, rcfg: RenderConfig,
                       has_alpha: bool = False, alpha_is_mask: bool = False,
                       lpips_model=None):
    """The batched train step over the processes of `group` (None: one
    process). The returned `step(state, batch) -> (state, stats, aux)`
    takes every process's same state and the step's whole batch of B
    views (leading [B] axis, `stack_batches`); each process renders its
    own rows (`view_share`), and all return the same new state: that of
    `train_step_impl(batched=True)` on one device, up to the order of the
    cross-process sums. On the card over NCCL the step is a graph's
    replay and the state it returns the graph's own (donation)."""
    steps = None
    if graphs.capturable("cuda", rcfg.use_pallas, group):
        steps = graphs.StepGraphs(tcfg, batched=True,
                                  lpips_model=lpips_model)

    def step(state: TrainState, batch: SceneBatch):
        share = view_share(group, batch.gt_packed.shape[0])
        rows = slice(share.first, share.first + share.count)
        c = batch.cam
        mine = SceneBatch(gt_packed=batch.gt_packed[rows], cam=type(c)(
            *(x[rows] for x in c)))
        if steps is not None and state.splats.means.is_cuda:
            return steps(state, mine, rcfg, has_alpha=has_alpha,
                         alpha_is_mask=alpha_is_mask, share=share)
        return train_step_impl(state, mine, tcfg, rcfg, has_alpha=has_alpha,
                               alpha_is_mask=alpha_is_mask, batched=True,
                               lpips_model=lpips_model, share=share)

    step.graphs = steps
    return step
