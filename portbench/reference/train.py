"""Brush's training step in plain PyTorch, from the scene a training run
starts from (its PLY rows in a capacity of rows): render with a noisy
background, the L1 + SSIM loss, gradients by autograd, the AdamScaled
update of the five arrays, the opacity-gated mean noise (Brush
brush-train train.rs:157-412, adam_scaled.rs:94-213, config.rs defaults),
and the overflow rule of a training loop that sizes its tile-sort space
ahead of the view: a step whose slots pass the space changes nothing, and
the space grows one step late.

The random draws follow the run's seed through a `torch.Generator` on the
device, in the order the step makes them: a [1, 3] uniform for the
background, then a [capacity, 3] normal for the mean noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import render as R
from portbench.reference.camera import View
from portbench.reference.loss import SSIM_WEIGHT, image_loss  # noqa: F401

DEAD_RAW_OPACITY = -20.0
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
NAMES = ("means", "quats", "log_scales", "sh_coeffs", "raw_opacities")


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Brush's TrainConfig defaults that the first steps use."""

    total_iters: int = 30_000
    lr_mean: float = 2e-5
    lr_mean_end: float = 2e-7
    mean_noise_weight: float = 50.0
    lr_coeffs_dc: float = 2e-3
    lr_coeffs_sh_scale: float = 10.0
    lr_opac: float = 0.012
    lr_scale: float = 5e-3
    lr_rotation: float = 2e-3
    background_noise: float = 0.1
    bound_percentile: float = 0.8
    init_isect_cap: int = 1 << 21
    init_chunk_cap: int = 1 << 15
    expand_k0: int = 4


def next_pow2(n: int) -> int:
    return 1 << max(10, int(math.ceil(math.log2(max(n, 1)))))


@dataclasses.dataclass
class State:
    params: dict
    m1: dict
    m2: dict
    t: dict
    step: int
    median_scale: torch.Tensor


def init_state(arrays: dict, capacity: int, device) -> State:
    """The first state of a run from its scene's rows: padded to
    `capacity` with dead rows, zero moments, and the median scale of the
    live means' per-axis percentile bounds."""
    n = arrays["means"].shape[0]

    def pad(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=device)
        out[:n] = x
        return out

    quats = pad(arrays["quats"])
    quats[n:, 0] = 1.0
    params = dict(means=pad(arrays["means"]), quats=quats,
                  log_scales=pad(arrays["log_scales"]),
                  sh_coeffs=pad(arrays["sh_coeffs"]),
                  raw_opacities=pad(arrays["raw_opacities"],
                                    DEAD_RAW_OPACITY))
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2["sh_coeffs"] = torch.zeros((capacity, 1, 1), device=device)
    t = {k: 0 for k in params}
    return State(params=params, m1=m1, m2=m2, t=t, step=0,
                 median_scale=_median_scale(params["means"][:n]))


def _median_scale(means: torch.Tensor) -> torch.Tensor:
    """2 x the middle of the three per-axis half extents between the
    index percentiles (1 -+ 0.8) / 2 of the sorted live means."""
    p = Hyper.bound_percentile
    n_ok = torch.tensor(float(means.shape[0]), device=means.device)
    lo = int(((1.0 - p) / 2.0 * n_ok).to(torch.int64))
    hi = int(torch.minimum(n_ok.to(torch.int64) - 1,
                           ((1.0 + p) / 2.0 * n_ok).to(torch.int64)))
    asc = torch.sort(means, dim=0).values
    extent = (asc[hi] - asc[lo]) / 2.0
    return torch.sort(extent).values[1] * 2.0


def _adam(param, grad, m1, m2, t, lr, scaling=None):
    g2 = grad * grad
    if m2.shape != param.shape:
        g2 = g2.reshape(g2.shape[0], -1).mean(dim=1).reshape(m2.shape)
    t = t + 1
    m1 = BETA1 * m1 + (1.0 - BETA1) * grad
    m2 = BETA2 * m2 + (1.0 - BETA2) * g2
    upd = (m1 / (1.0 - BETA1 ** t)) / (
        torch.sqrt(m2 / (1.0 - BETA2 ** t)) + EPS)
    upd = upd * (lr if scaling is None else scaling * lr)
    return param - upd, m1, m2, t


@dataclasses.dataclass
class StepResult:
    loss: float
    grads: dict
    remainder: int
    chunks: int
    overflowed: bool


def loss_and_grads(params: dict, view: View, gt_rgb: torch.Tensor,
                   bg: torch.Tensor, dtype=torch.float32,
                   block_tiles: int = 256, counts=None):
    """Loss of one view and the gradients of the five arrays, with the
    bins of the render. The blend's gradients go a block of tiles at a
    time: the image once without them, the loss's gradient in the image,
    then each block again under autograd."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    p = R.project(leaves["means"], leaves["log_scales"], leaves["quats"],
                  leaves["sh_coeffs"], leaves["raw_opacities"], view, dtype)
    bins = R.bin_splats(p, view.width, view.height)
    flat = [p.mean2d, p.conic, p.color, p.opac]
    held = [x.detach().requires_grad_(True) for x in flat]
    hp = p._replace(mean2d=held[0], conic=held[1], color=held[2],
                    opac=held[3])
    bgd = bg.to(dtype)
    with torch.no_grad():
        tiles_px = R.rasterize(hp, bins, bgd, counts=counts)
    img = R.tiles_to_image(tiles_px, view.width, view.height
                           ).detach().requires_grad_(True)
    loss = image_loss(img[..., :3], gt_rgb)
    (v_img,) = torch.autograd.grad(loss, [img])
    v_tiles = R.image_to_tiles(v_img)
    n_tiles = v_tiles.shape[0]
    for b0 in range(0, n_tiles, block_tiles):
        block = torch.arange(b0, min(b0 + block_tiles, n_tiles),
                             device=v_tiles.device)
        out = R.rasterize(hp, bins, bgd, tiles=block)
        torch.autograd.backward(out, v_tiles[block])
    torch.autograd.backward(flat, [h.grad if h.grad is not None
                                   else torch.zeros_like(h) for h in held])
    grads = {k: (leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k])).float() for k in NAMES}
    return float(loss.detach()), grads, bins


def step(state: State, view: View, gt_rgb: torch.Tensor,
         gen: torch.Generator, caps: dict, hp: Hyper = Hyper(),
         dtype=torch.float32) -> StepResult:
    """One training step in place on `state`; `caps` holds the loop's
    tile-sort capacities ("isect", "chunk") this step runs with."""
    dev = state.params["means"].device
    u = torch.rand((1, 3), generator=gen, dtype=torch.float32, device=dev)
    bg = torch.clamp((2.0 * u - 1.0) * hp.background_noise, 0.0, 1.0)[0]
    with torch.no_grad():
        p = R.project(*(state.params[k] for k in (
            "means", "log_scales", "quats", "sh_coeffs", "raw_opacities")),
            view, dtype)
        bins = R.bin_splats(p, view.width, view.height)
    rem = bins.remainder(hp.expand_k0)
    chunks = bins.num_chunks(hp.expand_k0, caps["isect"])
    del p, bins
    overflowed = rem > caps["isect"] or chunks > caps["chunk"]
    counts = R.BlendCounts(state.params["means"].shape[0], dev)
    loss, grads = float("nan"), None
    if not overflowed:
        loss, grads, _ = loss_and_grads(state.params, view, gt_rgb, bg,
                                        dtype, counts=counts)
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
        for name in NAMES:
            (state.params[name], state.m1[name], state.m2[name],
             state.t[name]) = _adam(
                state.params[name], grads[name], state.m1[name],
                state.m2[name], state.t[name], lrs[name],
                sh_scale if name == "sh_coeffs" else None)
        inv = 1.0 - torch.sigmoid(state.params["raw_opacities"])
        weight = torch.clamp(inv ** 150.0, 0.0, 1.0) * counts.contributed
        noise = samples * (weight * lr_mean * hp.mean_noise_weight)[:, None]
        noise = torch.maximum(torch.minimum(noise, state.median_scale),
                              -state.median_scale)
        state.params["means"] = state.params["means"] + noise
    state.step += 1
    return StepResult(loss=loss, grads=grads, remainder=rem, chunks=chunks,
                      overflowed=overflowed)


def follow(state: State, views: list, gts: list, order: list, seed: int,
           hp: Hyper = Hyper(), dtype=torch.float32) -> list:
    """The run's first len(order) steps on views `order`, with the loop's
    capacities (grown one step late, to the power of two above 1.3 x what
    the step before needed). Returns the StepResults."""
    dev = state.params["means"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    caps = dict(isect=hp.init_isect_cap, chunk=hp.init_chunk_cap)
    out = []
    for i in order:
        res = step(state, views[i], gts[i], gen, caps, hp, dtype)
        if out:
            grow_caps(caps, out[-1])
        out.append(res)
    return out


def grow_caps(caps: dict, prev: StepResult) -> None:
    """The loop's growth after a step, from the step before it: to the
    power of two above 1.3 x what that step needed."""
    if prev.remainder > caps["isect"]:
        caps["isect"] = next_pow2(int(prev.remainder * 1.3))
    if prev.chunks > caps["chunk"]:
        caps["chunk"] = next_pow2(int(prev.chunks * 1.3))
