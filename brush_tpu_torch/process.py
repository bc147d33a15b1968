"""The loop around the training step (the part of `brush_tpu/process.py`
that needs no dataset; the reference is train_stream.rs:34-503).

`loop_step` is one turn of the training loop: a `train_step`, then the
host's policy between steps:

* the previous step's `num_isects` and `num_chunks` are read one step
  behind (so the read never stalls the queue of the step just enqueued)
  and the tile-sort capacities grow on overflow; the overflowing steps
  themselves were no-ops on the device (the trainer's gate);
* every `refine_every` steps, until 95 % of the run: the splat capacity
  doubles ahead of demand once it is 80 % full, then `refine_step`.

The caller owns the views and their order. `train_process`,
`ProcessConfig`, the dataset loaders, evaluation cadence, export and
checkpoints belong to the part of the port that brings the data and IO
modules.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from brush_tpu_torch.models.splats import grow_capacity
from brush_tpu_torch.render import RenderAux, RenderConfig
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.refine import refine_step
from brush_tpu_torch.train.trainer import (
    SceneBatch,
    TrainState,
    TrainStepStats,
    train_step,
)
from brush_tpu_torch.utils.tracing import stage


@dataclasses.dataclass
class TrainMessage:
    kind: str                            # "overflow" | "refine"
    iter: int
    data: dict


@dataclasses.dataclass
class LoopState:
    """What the loop carries from one step to the next."""

    state: TrainState
    rcfg: RenderConfig                   # isect_cap / chunk_cap grow here
    it: int = 0                          # steps taken (host side)
    prev_aux: RenderAux | None = None    # the last step's aux, still unread


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
    rcfg = loop.rcfg
    state, stats, aux = train_step(loop.state, batch, tcfg, rcfg,
                                   has_alpha=has_alpha,
                                   alpha_is_mask=alpha_is_mask)
    it = loop.it + 1
    messages = []

    # Overflow check, one step behind. On overflow grow the capacities; the
    # one or two no-op steps in the detection window are lost views, not
    # corrupt updates.
    if loop.prev_aux is not None:
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

    # Refine cadence: every refine_every until 95 % progress
    # (train_stream.rs:321-327).
    if (it % tcfg.refine_every == 0
            and it < tcfg.total_train_iters * 0.95):
        cap = state.splats.capacity
        if int(state.splats.n_alive) > 0.8 * cap and cap < tcfg.max_splats:
            state = _grow_state(state, min(_next_pow2(cap * 2),
                                           _next_pow2(tcfg.max_splats)))
        with stage("refine"):
            state, rstats = refine_step(state, tcfg, view_centers,
                                        view_focals)
        messages.append(TrainMessage("refine", it, dict(
            added=int(rstats.num_added), pruned=int(rstats.num_pruned),
            oversized=int(rstats.num_oversized),
            resampled=int(rstats.num_resampled),
            grad_grown=int(rstats.num_grad_grown),
            total=int(rstats.total_splats))))

    return (LoopState(state=state, rcfg=rcfg, it=it, prev_aux=aux), stats,
            messages)
