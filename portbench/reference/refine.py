"""Brush's refine in plain PyTorch, and the training step after it with
the Mip-Splatting 3D filter floor (Brush brush-train train.rs:414-807,
compute_min_scale :82-105; gaussian_splats.rs fold_min_scale :86-111).

A refine, from a training state and the views' centres and focals:

* the floor is folded into the splats: s <- sqrt(s^2 + f^2), the opacity
  times sqrt(det_old / det_new);
* prune: a live splat below the 1/255 opacity, larger than 100 x the
  bounds' largest half extent, that far from their centre, or not finite;
  the kept ones move to the front in order, and the moments of the rest
  are zeroed;
* select: as many as were pruned, drawn without replacement by opacity
  among the splats seen since the last refine; those whose largest screen
  radius passed half the image; and by the refine weight among those
  above the growth threshold, a quarter of them less the pruned, within
  the capacity (Gumbel top-k, one uniform draw a row of the run's
  generator for each of the two draws);
* split each selected splat into two along its axes, the child in the
  next dead row, both with opacity 1 - (1 - a)^(1/sqrt 2) and zero
  moments;
* decay every live opacity by 0.004 x (1 - progress);
* new bounds of the live means (the 0.1 and 0.9 index percentiles per
  axis) and a new floor: sqrt(0.1) x the least distance to a view centre
  over its focal.

Where a selection depends on it, the arithmetic is in Brush's order, so a
refine on the same state selects the same splats: the fold, the sigmoid
of the folded opacity, the Gumbel score log(w) + g and a stable ranking.

`advance_to_refine` reproduces the run's generator from its seed: every
step draws a [1, 3] uniform and a [capacity, 3] normal, every refine two
[capacity] uniforms.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from portbench.reference import render as R
from portbench.reference import train as RT

ALPHA_MIN = 1.0 / 255.0
SQRT_HALF = 0.7071067811865476
MIN_SCALE_FACTOR = 0.1
FLOOR_FREEZE = 0.9
PERCENTILE = 0.8


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Brush's TrainConfig defaults that a refine uses."""

    total_iters: int = 30_000
    refine_every: int = 200
    max_splats: int = 10_000_000
    growth_grad_threshold: float = 0.0025
    growth_select_fraction: float = 0.25
    growth_stop_iter: int = 15_000
    split_at_screen_size: float = 0.5
    opac_decay: float = 0.004


@dataclasses.dataclass
class RefineState:
    """What a refine reads and writes: the five arrays, the floor, the
    live count, the refine record, Adam's moments and step counts, the
    step and the bounds."""

    params: dict
    floor: torch.Tensor | None
    n_alive: int
    refine_weight: torch.Tensor
    visible_count: torch.Tensor
    max_radius: torch.Tensor
    m1: dict
    m2: dict
    t: dict
    step: int
    center: torch.Tensor
    extent: torch.Tensor
    median_scale: torch.Tensor | None = None
    pruned: int = 0
    added: int = 0


def advance_to_refine(gen: torch.Generator, steps: int, capacity: int,
                      hp: Hyper = Hyper()) -> None:
    """Draw what a run drew before the refine after its step `steps`:
    its first `steps` steps and the refines between them."""
    dev = gen.device
    small = torch.empty((1, 3), device=dev)
    rows = torch.empty((capacity, 3), device=dev)
    lanes = torch.empty((capacity,), device=dev)
    for it in range(1, steps + 1):
        torch.rand((1, 3), generator=gen, out=small)
        torch.randn((capacity, 3), generator=gen, out=rows)
        if (it < steps and it % hp.refine_every == 0
                and it < hp.total_iters * 0.95):
            torch.rand((capacity,), generator=gen, out=lanes)
            torch.rand((capacity,), generator=gen, out=lanes)


def fold(log_scales, raw_opac, floor):
    """The arrays with the floor folded in (differentiable)."""
    if floor is None:
        return log_scales, raw_opac
    s2 = torch.exp(2.0 * log_scales)
    f2 = (floor ** 2)[:, None]
    n2 = s2 + f2
    comp = torch.sqrt((s2[:, 0] * s2[:, 1] * s2[:, 2])
                      / (n2[:, 0] * n2[:, 1] * n2[:, 2]))
    sig = torch.clamp(torch.sigmoid(raw_opac) * comp, 1e-12, 1.0 - 1e-7)
    return 0.5 * torch.log(n2), torch.log(sig) - torch.log1p(-sig)


def _logit(x):
    return torch.log(x) - torch.log1p(-x)


def _gumbel_pick(gen, weights, k: int):
    """k rows drawn without replacement in proportion to `weights` (of
    those above 0): the k largest log(w) + Gumbel noise."""
    u = torch.rand(weights.shape, generator=gen, dtype=torch.float32,
                   device=weights.device)
    g = -torch.log(-torch.log(torch.clamp_min(
        u, torch.finfo(torch.float32).tiny)))
    w = torch.nan_to_num(weights, nan=0.0)
    score = torch.where(w > 0, torch.log(w) + g,
                        torch.full_like(w, float("-inf")))
    order = torch.argsort(-score, stable=True)
    pick = torch.zeros_like(w, dtype=torch.bool)
    pick[order[:k]] = True
    return pick & (w > 0)


def _bounds(means):
    """(centre, half extent) of the means between the 0.1 and 0.9 index
    percentiles of each axis (the indices taken in float32, as Brush
    takes them)."""
    n = torch.tensor(float(means.shape[0]), device=means.device)
    lo = int(((1.0 - PERCENTILE) / 2.0 * n).to(torch.int64))
    hi = int(torch.minimum(n.to(torch.int64) - 1, ((1.0 + PERCENTILE) / 2.0
                                                    * n).to(torch.int64)))
    asc = torch.sort(means, dim=0).values
    return (asc[lo] + asc[hi]) / 2.0, (asc[hi] - asc[lo]) / 2.0


def _rotate(q, v):
    return (R.quat_to_rot(q) @ v[:, :, None])[:, :, 0]


def refine(st: RefineState, centers, focals, gen: torch.Generator,
           hp: Hyper = Hyper(), prune: bool = True) -> RefineState:
    """One refine; `prune=False` leaves every splat in (a planted fault
    for the benchmark's control)."""
    with torch.no_grad():
        return _refine(st, centers, focals, gen, hp, prune)


def _refine(st, centers, focals, gen, hp, prune_on):
    p = dict(st.params)
    p["log_scales"], p["raw_opacities"] = fold(
        p["log_scales"], p["raw_opacities"], st.floor)
    cap = p["means"].shape[0]
    dev = p["means"].device
    lanes = torch.arange(cap, device=dev)
    alive = lanes < st.n_alive

    lim = st.extent.max() * 100.0
    bad = ~(torch.isfinite(p["means"]).all(1)
            & torch.isfinite(p["log_scales"]).all(1)
            & torch.isfinite(p["quats"]).all(1)
            & torch.isfinite(p["sh_coeffs"].reshape(cap, -1)).all(1)
            & torch.isfinite(p["raw_opacities"]))
    prune = alive & ((torch.sigmoid(p["raw_opacities"]) < ALPHA_MIN)
                     | (torch.exp(p["log_scales"]) > lim).any(1)
                     | ((p["means"] - st.center).abs() > lim).any(1) | bad)
    if not prune_on:
        prune = torch.zeros_like(prune)
    keep = alive & ~prune
    n_pruned = int(prune.sum())
    order = torch.cat([torch.nonzero(keep).squeeze(1),
                       torch.nonzero(~keep).squeeze(1)])
    n = int(keep.sum())
    live = lanes < n
    p = {k: v[order] for k, v in p.items()}
    p["raw_opacities"] = torch.where(
        live, p["raw_opacities"],
        torch.full_like(p["raw_opacities"], RT.DEAD_RAW_OPACITY))

    def kept(m):
        m = m[order]
        return torch.where(live.reshape((-1,) + (1,) * (m.dim() - 1)), m,
                           torch.zeros_like(m))
    m1 = {k: kept(v) for k, v in st.m1.items()}
    m2 = {k: kept(v) for k, v in st.m2.items()}
    weight = st.refine_weight[order]
    seen = live & (st.visible_count[order] > 0)
    radius = st.max_radius[order]

    zero = torch.zeros_like(weight)
    sel = _gumbel_pick(gen, torch.where(
        seen, torch.sigmoid(p["raw_opacities"]), zero), n_pruned)
    sel |= seen & (radius > hp.split_at_screen_size)
    budget = min(hp.max_splats, cap)
    above = seen & (weight > hp.growth_grad_threshold)
    grow = max(round(int(above.sum()) * hp.growth_select_fraction)
               - n_pruned, 0)
    grow = min(grow, max(budget - n - int(sel.sum()), 0))
    if st.step >= hp.growth_stop_iter:
        grow = 0
    sel |= _gumbel_pick(gen, torch.where(above, weight, zero), grow)
    parents = torch.nonzero(sel).squeeze(1)[:max(budget - n, 0)]
    sel = torch.zeros_like(sel)
    sel[parents] = True
    children = n + torch.arange(parents.numel(), device=dev)

    quats = p["quats"]
    rots = quats / torch.clamp_min(
        torch.linalg.norm(quats, dim=1, keepdim=True), 1e-32)
    scales = torch.exp(p["log_scales"])
    opac = torch.sigmoid(p["raw_opacities"])
    split_raw = _logit(torch.clamp(1.0 - (1.0 - opac) ** SQRT_HALF,
                                   ALPHA_MIN, 1.0 - ALPHA_MIN))
    s2 = scales ** 2
    ratio = s2 / torch.clamp_min(s2.max(1, keepdim=True).values, 1e-30)
    k_max = torch.clamp_max(hp.split_at_screen_size / torch.clamp_min(
        radius[:, None], 1e-6), SQRT_HALF)
    k_axis = 1.0 - ratio * (1.0 - k_max)
    offset = _rotate(rots, torch.sqrt(torch.clamp_min(
        1.0 - k_axis ** 2, 0.0)) * scales)
    split_ls = p["log_scales"] + torch.log(k_axis)

    new = {k: v.clone() for k, v in p.items()}
    new["means"][parents] = p["means"][parents] - offset[parents]
    new["means"][children] = p["means"][parents] + offset[parents]
    for name, vals in (("log_scales", split_ls),
                       ("raw_opacities", split_raw)):
        new[name][parents] = vals[parents]
        new[name][children] = vals[parents]
    new["quats"][children] = rots[parents]
    new["sh_coeffs"][children] = p["sh_coeffs"][parents]
    for m in (m1, m2):
        for v in m.values():
            v[parents] = 0.0

    n_out = n + parents.numel()
    live = lanes < n_out
    progress = st.step / max(hp.total_iters, 1)
    shrink = hp.opac_decay * (1.0 - min(max(progress, 0.0), 1.0))
    decayed = _logit(torch.clamp(torch.sigmoid(new["raw_opacities"])
                                 - shrink, 1e-12, 1.0 - 1e-12))
    new["raw_opacities"] = torch.where(live, decayed, new["raw_opacities"])

    center, extent = _bounds(new["means"][:n_out])
    floor = None
    if focals.numel():
        dist = torch.linalg.norm(new["means"][:, None, :]
                                 - centers[None, :, :], dim=-1)
        floor = math.sqrt(MIN_SCALE_FACTOR) * (
            dist / torch.clamp_min(focals[None, :], 1e-6)).min(1).values
        floor = torch.where(live & (progress < FLOOR_FREEZE), floor,
                            torch.zeros_like(floor))
    return RefineState(
        params=new, floor=floor, n_alive=n_out,
        refine_weight=torch.zeros_like(weight), visible_count=zero.clone(),
        max_radius=zero.clone(), m1=m1, m2=m2, t=dict(st.t), step=st.step,
        center=center, extent=extent,
        median_scale=torch.sort(extent).values[1] * 2.0,
        pruned=n_pruned, added=int(parents.numel()))


@contextlib.contextmanager
def floor_folded(floor):
    """Within the block the reference renders every splat with `floor`
    folded into its scale and opacity (its gradients go through the
    fold to the arrays)."""
    project = R.project

    def folded(means, log_scales, quats, sh, raw_opac, view,
               dtype=torch.float32):
        ls, raw = fold(log_scales, raw_opac, floor)
        return project(means, ls, quats, sh, raw, view, dtype)

    R.project = folded
    try:
        yield
    finally:
        R.project = project


def train_state(st: RefineState) -> RT.State:
    """The reference training state after a refine."""
    return RT.State(params=dict(st.params), m1=dict(st.m1),
                    m2=dict(st.m2), t=dict(st.t), step=st.step,
                    median_scale=st.median_scale)


def step(state: RT.State, floor, view, gt_rgb, gen, caps: dict,
         hp: RT.Hyper = RT.Hyper(), dtype=torch.float32) -> RT.StepResult:
    """`train.step` with the floor: rendered with it folded in, and the
    mean noise gated by the folded opacity."""
    dev = state.params["means"].device
    u = torch.rand((1, 3), generator=gen, dtype=torch.float32, device=dev)
    bg = torch.clamp((2.0 * u - 1.0) * hp.background_noise, 0.0, 1.0)[0]
    with floor_folded(floor):
        with torch.no_grad():
            p = R.project(*(state.params[k] for k in (
                "means", "log_scales", "quats", "sh_coeffs",
                "raw_opacities")), view, dtype)
            bins = R.bin_splats(p, view.width, view.height)
        rem = bins.remainder(hp.expand_k0)
        chunks = bins.num_chunks(hp.expand_k0, caps["isect"])
        del p, bins
        overflowed = rem > caps["isect"] or chunks > caps["chunk"]
        counts = R.BlendCounts(state.params["means"].shape[0], dev)
        loss, grads = float("nan"), None
        if not overflowed:
            loss, grads, _ = RT.loss_and_grads(state.params, view, gt_rgb,
                                               bg, dtype, counts=counts)
    decay = (hp.lr_mean_end / hp.lr_mean) ** (1.0 / hp.total_iters)
    lr_mean = (hp.lr_mean * decay ** torch.tensor(
        float(state.step), device=dev)) * state.median_scale
    samples = torch.randn(state.params["means"].shape, generator=gen,
                          dtype=torch.float32, device=dev)
    if not overflowed:
        k = state.params["sh_coeffs"].shape[1]
        sh_scale = torch.full((1, k, 1), 1.0 / hp.lr_coeffs_sh_scale,
                              device=dev)
        sh_scale[:, 0] = 1.0
        lrs = dict(means=lr_mean, quats=hp.lr_rotation,
                   log_scales=hp.lr_scale, raw_opacities=hp.lr_opac,
                   sh_coeffs=hp.lr_coeffs_dc)
        for name in RT.NAMES:
            (state.params[name], state.m1[name], state.m2[name],
             state.t[name]) = RT._adam(
                state.params[name], grads[name], state.m1[name],
                state.m2[name], state.t[name], lrs[name],
                sh_scale if name == "sh_coeffs" else None)
        _, raw = fold(state.params["log_scales"],
                      state.params["raw_opacities"], floor)
        inv = 1.0 - torch.sigmoid(raw)
        weight = torch.clamp(inv ** 150.0, 0.0, 1.0) * counts.contributed
        noise = samples * (weight * lr_mean * hp.mean_noise_weight)[:, None]
        noise = torch.maximum(torch.minimum(noise, state.median_scale),
                              -state.median_scale)
        state.params["means"] = state.params["means"] + noise
    state.step += 1
    return RT.StepResult(loss=loss, grads=grads, remainder=rem,
                         chunks=chunks, overflowed=overflowed)
