"""Refinement: prune / resample / split under a fixed capacity (port of
`brush_tpu/train/refine.py`; the reference is SplatTrainer::refine and
refine_splats, brush-train/src/train.rs:414-807).

One refine changes no array shape and reads nothing back to the host:

* prune -> stable-sort compaction keeping live rows as a prefix;
* multinomial sampling without replacement -> the Gumbel top-k trick, on
  the device. The draw sits in `sample_gumbel`, which a test can replace
  with the JAX package's samples (the two packages' generators give
  different numbers from one seed);
* `cat` of split children -> scatter into the dead region past `n_alive`.
  Rows that are not selected, and children past the budget, are sent to
  index `cap`: the scatter writes into a [cap + 1, ...] buffer whose last
  row is dropped (an out-of-range index raises in PyTorch, where JAX's
  `mode="drop"` ignores it);
* optimizer-moment surgery (both halves of a split start from zero
  moments, train.rs map_splats_and_opt:810) -> masked where.

`refine_step` runs under `torch.no_grad()`: state in, new state out.
`_percentile_bounds` and `median_size` also serve `init_train_state`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from brush_tpu_torch.constants import ALPHA_CUTOFF_MID
from brush_tpu_torch.models.splats import DEAD_RAW_OPACITY
from brush_tpu_torch.train.config import (
    BOUND_PERCENTILE,
    MIN_SCALE_FACTOR,
    MIN_SCALE_FREEZE_FRAC,
    TrainConfig,
)
from brush_tpu_torch.utils.quat import quat_rotate_vec

FRAC_1_SQRT_2 = 0.7071067811865476
# Views per block of `compute_min_scale`: bounds the [cap, V, 3] temporary.
_MIN_SCALE_VIEW_BLOCK = 8


class RefineStats(NamedTuple):
    num_added: torch.Tensor
    num_pruned: torch.Tensor
    num_pruned_non_finite: torch.Tensor
    total_splats: torch.Tensor
    # Selection decomposition of num_added (the reference streams these as
    # per-refine histograms, visualize_tools.rs:86-707):
    num_oversized: torch.Tensor   # forced screen-size splits
    num_resampled: torch.Tensor   # opacity-weighted resample of pruned budget
    num_grad_grown: torch.Tensor  # gradient-growth selections


def _inv_sigmoid(x):
    return torch.log(x) - torch.log1p(-x)


def _percentile_bounds(means, alive, percentile):
    """Per-axis index-percentile bounds over live, finite means
    (splat_init.rs bounds_from_pos:130-165), on the device. Returns
    (center [3], extent [3])."""
    big = 1.0e30
    ok = alive[:, None] & torch.isfinite(means)
    n_ok = torch.clamp_min(ok.sum(dim=0), 1).to(torch.float32)      # [3]
    lo_idx = ((1.0 - percentile) / 2.0 * n_ok).to(torch.int64)
    hi_idx = torch.minimum(n_ok.to(torch.int64) - 1,
                           ((1.0 + percentile) / 2.0 * n_ok).to(torch.int64))
    asc = torch.sort(torch.where(ok, means, big), dim=0).values
    mins = torch.gather(asc, 0, lo_idx[None, :])[0]
    maxs = torch.gather(asc, 0, hi_idx[None, :])[0]
    return (mins + maxs) / 2.0, (maxs - mins) / 2.0


def median_size(extent):
    """Middle extent * 2 (bounding_box.rs:23-29)."""
    return torch.sort(extent).values[1] * 2.0


def compute_min_scale(means, view_centers, view_focals):
    """Mip-Splatting 3D-filter floor: sqrt(0.1) * min_v(dist / focal)
    (train.rs compute_min_scale:82-105). The views go through in blocks so
    the [cap, V, 3] difference never exists at once."""
    best = means.new_full((means.shape[0],), float("inf"))
    for v0 in range(0, view_centers.shape[0], _MIN_SCALE_VIEW_BLOCK):
        centers = view_centers[v0:v0 + _MIN_SCALE_VIEW_BLOCK]
        focals = view_focals[v0:v0 + _MIN_SCALE_VIEW_BLOCK]
        d = torch.linalg.norm(means[:, None, :] - centers[None, :, :], dim=-1)
        ratio = d / torch.clamp_min(focals[None, :], 1e-6)
        best = torch.minimum(best, ratio.min(dim=1).values)
    return math.sqrt(MIN_SCALE_FACTOR) * best


def sample_gumbel(rng: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel samples, -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand(tuple(shape), generator=rng, dtype=torch.float32,
                   device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def _gumbel_topk_select(rng, weights, k, cap):
    """Selection mask over `weights` equivalent to multinomial sampling of
    `k` items without replacement (Gumbel top-k; replaces the reference's
    host-side multinomial, brush-train/src/multinomial.rs). `k` is a
    tensor."""
    w = torch.nan_to_num(weights, nan=0.0)
    g = sample_gumbel(rng, w.shape, w.device)
    neg_inf = torch.full_like(w, float("-inf"))
    score = torch.where(w > 0.0, torch.log(w) + g, neg_inf)
    order = torch.argsort(-score, stable=True)
    rank = torch.empty(cap, dtype=torch.int64, device=w.device)
    rank[order] = torch.arange(cap, dtype=torch.int64, device=w.device)
    return (rank < k) & (w > 0.0)


def _bmask(mask, arr):
    """Broadcast a [cap] bool mask against arr's leading axis."""
    return mask.reshape((-1,) + (1,) * (arr.dim() - 1))


def _scatter_drop(arr, slot, vals):
    """arr with row slot[i] <- vals[i]; rows sent to index cap are dropped."""
    buf = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])], dim=0)
    buf.index_copy_(0, slot, vals)
    return buf[:-1]


@torch.no_grad()
def refine_step(state, tcfg: TrainConfig, view_centers: torch.Tensor,
                view_focals: torch.Tensor):
    """One refine of a TrainState. `view_centers` [V, 3] and `view_focals`
    [V] (focal px at native resolution) feed the 3D filter; V = 0 disables
    it. Consumes state.refine. Returns (new state, RefineStats)."""
    from brush_tpu_torch.train.trainer import RefineRecord

    splats = state.splats.fold_min_scale()  # bake the floor (train.rs:420)
    cap = splats.capacity
    dev = splats.means.device
    i32 = torch.int32
    lanes = torch.arange(cap, device=dev)
    progress = state.step.to(torch.float32) / max(tcfg.total_train_iters, 1)

    alive = lanes < state.splats.n_alive
    refiner = state.refine

    # --- Prune (train.rs:468-519) ---
    max_allowed = state.bounds_extent.max() * 100.0
    alpha_low = torch.sigmoid(splats.raw_opacities) < ALPHA_CUTOFF_MID
    scale_big = (torch.exp(splats.log_scales) > max_allowed).any(dim=1)
    out_of_bounds = (torch.abs(splats.means - state.bounds_center)
                     > max_allowed).any(dim=1)
    row_bad = (
        ~torch.isfinite(splats.means).all(dim=1)
        | ~torch.isfinite(splats.log_scales).all(dim=1)
        | ~torch.isfinite(splats.quats).all(dim=1)
        | ~torch.isfinite(splats.sh_coeffs.reshape(cap, -1)).all(dim=1)
        | ~torch.isfinite(splats.raw_opacities)
    )
    prune = alive & (alpha_low | scale_big | out_of_bounds | row_bad)
    keep = alive & ~prune
    pruned_count = prune.sum().to(i32)
    pruned_non_finite = (alive & row_bad).sum().to(i32)

    # --- Compact: kept rows to the front. The sort must be stable, or the
    # live rows come out permuted. ---
    perm = torch.argsort((~keep).to(torch.int8), stable=True)
    n_alive = keep.sum().to(i32)

    params = {k: v[perm] for k, v in splats.params().items()}
    alive2 = lanes < n_alive
    # Dead slots: inert parameters and no stale moments.
    params["raw_opacities"] = torch.where(
        alive2, params["raw_opacities"],
        torch.full_like(params["raw_opacities"], DEAD_RAW_OPACITY))

    def moments(st, fn):
        return dataclasses.replace(st, moment1=fn(st.moment1),
                                   moment2=fn(st.moment2))

    opt = {name: moments(st, lambda m: torch.where(
        _bmask(alive2, m), m[perm], torch.zeros_like(m)))
        for name, st in state.opt.items()}
    refine_w = refiner.refine_weight[perm]
    vis_cnt = refiner.visible_count[perm]
    max_ss = refiner.max_radius[perm]
    vis2 = alive2 & (vis_cnt > 0.0)

    # --- Select split candidates (train.rs:521-612) ---
    zeros = torch.zeros_like(refine_w)
    opac2 = torch.sigmoid(params["raw_opacities"])
    sel_resample = _gumbel_topk_select(
        state.rng, torch.where(vis2, opac2, zeros), pruned_count, cap)

    headroom_budget = min(tcfg.max_splats, cap)
    sel_oversized = torch.zeros(cap, dtype=torch.bool, device=dev)
    if tcfg.split_at_screen_size > 0.0:
        sel_oversized = vis2 & (max_ss > tcfg.split_at_screen_size)
    sel = sel_resample | sel_oversized

    above = vis2 & (refine_w > tcfg.growth_grad_threshold)
    grow_target = torch.round(
        above.sum().to(torch.float32) * tcfg.growth_select_fraction).to(i32)
    grow_count = torch.clamp_min(grow_target - pruned_count, 0)
    cur = n_alive + sel.sum().to(i32)
    grow_count = torch.minimum(grow_count,
                               torch.clamp_min(headroom_budget - cur, 0))
    grow_count = torch.where(state.step < tcfg.growth_stop_iter, grow_count,
                             torch.zeros_like(grow_count))
    sel = sel | _gumbel_topk_select(
        state.rng, torch.where(above, refine_w, zeros), grow_count, cap)

    # Children take the dead slots in selection order; anything past the
    # budget (capacity or max_splats) is dropped.
    sel_rank = torch.cumsum(sel.to(torch.int64), dim=0) - 1
    child_slot = n_alive.to(torch.int64) + sel_rank
    sel = sel & (child_slot < headroom_budget)
    child_slot = torch.where(sel, child_slot, torch.full_like(child_slot, cap))
    n_added = sel.sum().to(i32)

    # --- Covariance-aware split (train.rs:651-807) ---
    q_mag = torch.clamp_min(
        torch.linalg.norm(params["quats"], dim=1, keepdim=True), 1e-32)
    rots = params["quats"] / q_mag
    cur_scales = torch.exp(params["log_scales"])
    cur_opac = torch.sigmoid(params["raw_opacities"])
    new_opac = 1.0 - (1.0 - cur_opac) ** FRAC_1_SQRT_2
    new_raw_opac = _inv_sigmoid(torch.clamp(
        new_opac, ALPHA_CUTOFF_MID, 1.0 - ALPHA_CUTOFF_MID))

    scales_sq = cur_scales ** 2
    max_sq = torch.clamp_min(scales_sq.max(dim=1, keepdim=True).values, 1e-30)
    ratio = scales_sq / max_sq
    if tcfg.split_at_screen_size > 0.0:
        k_max = torch.clamp_max(
            tcfg.split_at_screen_size
            / torch.clamp_min(max_ss[:, None], 1e-6), FRAC_1_SQRT_2)
    else:
        k_max = torch.full((cap, 1), FRAC_1_SQRT_2, device=dev)
    k_axis = 1.0 - ratio * (1.0 - k_max)
    offset = torch.sqrt(torch.clamp_min(1.0 - k_axis ** 2, 0.0)) * cur_scales
    offset_world = quat_rotate_vec(rots, offset)
    new_log_scales = params["log_scales"] + torch.log(k_axis)

    selc = sel[:, None]
    # Parent in place: mean - offset, shrunk scales, reduced opacity. Child
    # scattered into the dead region.
    new_params = {
        "means": _scatter_drop(
            torch.where(selc, params["means"] - offset_world,
                        params["means"]),
            child_slot, params["means"] + offset_world),
        "log_scales": _scatter_drop(
            torch.where(selc, new_log_scales, params["log_scales"]),
            child_slot, new_log_scales),
        "quats": _scatter_drop(params["quats"], child_slot, rots),
        "sh_coeffs": _scatter_drop(params["sh_coeffs"], child_slot,
                                   params["sh_coeffs"]),
        "raw_opacities": _scatter_drop(
            torch.where(sel, new_raw_opac, params["raw_opacities"]),
            child_slot, new_raw_opac),
    }

    # Both halves of a split start with zero Adam moments
    # (train.rs:755-795); the child slots were zeroed above.
    opt = {name: moments(st, lambda m: torch.where(
        _bmask(sel, m), torch.zeros_like(m), m)) for name, st in opt.items()}

    n_alive_out = n_alive + n_added

    # --- Global opacity decay (train.rs:795-803) ---
    t_shrink = tcfg.opac_decay * (1.0 - torch.clamp(progress, 0.0, 1.0))
    alive3 = lanes < n_alive_out
    decayed = _inv_sigmoid(torch.clamp(
        torch.sigmoid(new_params["raw_opacities"]) - t_shrink,
        1e-12, 1.0 - 1e-12))
    new_params["raw_opacities"] = torch.where(alive3, decayed,
                                              new_params["raw_opacities"])

    # --- New bounds and a fresh 3D-filter floor (train.rs:619-634) ---
    center, extent = _percentile_bounds(new_params["means"], alive3,
                                        BOUND_PERCENTILE)
    floor = None
    if view_focals.shape[0] > 0:
        # Recomputed and attached until the freeze point; past it the bake
        # at the top of this function has folded it for good, and a zero
        # floor (a no-op in fold_min_scale) is attached (train.rs:627-634).
        floor = compute_min_scale(new_params["means"], view_centers,
                                  view_focals)
        floor = torch.where(alive3 & (progress < MIN_SCALE_FREEZE_FRAC),
                            floor, torch.zeros_like(floor))
    new_splats = dataclasses.replace(
        state.splats.with_params(new_params), n_alive=n_alive_out,
        min_scale=floor)

    new_state = dataclasses.replace(
        state,
        splats=new_splats,
        opt=opt,
        refine=RefineRecord.zeros(cap, device=dev),
        median_scale=median_size(extent),
        bounds_center=center,
        bounds_extent=extent,
    )
    # The final selection (after the budget cut) by source; overlaps
    # resolve in the order oversized > resampled.
    n_over = (sel & sel_oversized).sum().to(i32)
    n_res = (sel & sel_resample & ~sel_oversized).sum().to(i32)
    stats = RefineStats(
        num_added=n_added,
        num_pruned=pruned_count,
        num_pruned_non_finite=pruned_non_finite,
        total_splats=n_alive_out,
        num_oversized=n_over,
        num_resampled=n_res,
        num_grad_grown=n_added - n_over - n_res,
    )
    return new_state, stats
