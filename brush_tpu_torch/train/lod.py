"""LOD baking: PUP importance scores and decimation (port of
`brush_tpu/train/lod.py`; the reference is brush-train/src/lod.rs).

After the main training each LOD level keeps the top share of splats by PUP
score: the log-determinant of the per-splat 6x6 sensitivity Hessian
sum(J J^T) of [d_mean(3), d_log_scale(3)] over the scoring views
(compute_pup_scores:78, log_det_6x6:44).

The per-view Jacobian products come from reverse-mode autodiff of the
rendered image: one render per view, then one `torch.autograd.grad` per
random image-space probe on the retained graph (a Hutchinson estimate of
sum(J J^T) with K probes), accumulated as 6x6 outer products per splat. The
probes come from `sample_probes`, which a test can replace with the JAX
package's samples.

On the card (the kernel path) a view runs as a CUDA graph, as the JAX
package jits `view_hessian` and `fd_col`: one graph a call of
`pup_hessians` (its views share a shape and a capacity), captured at the
first view and replayed for the others, the probes' generator registered
with it; the exact mode replays one graph a column pair. A replaced
`sample_probes` runs at the capture only.
"""

from __future__ import annotations

import dataclasses

import torch

from brush_tpu_torch import graphs
from brush_tpu_torch.models.splats import DEAD_RAW_OPACITY, Splats
from brush_tpu_torch.render import RenderConfig, render

FD_EPS = 1e-3    # central-difference step of the exact mode
H_EPS = 1e-12    # ridge added to H before the log-determinant


def sample_probes(rng: torch.Generator, view: int, probe: int, shape,
                  device) -> torch.Tensor:
    """Standard normal image-space probe number `probe` of view `view`."""
    del view, probe     # the generator's stream orders them
    return torch.randn(tuple(shape), generator=rng, dtype=torch.float32,
                       device=device)


def _render_rgb(folded: Splats, means, log_scales, cam, rcfg):
    bg = torch.zeros(3, dtype=torch.float32, device=means.device)
    img, _ = render(means, log_scales, folded.quats, folded.sh_coeffs,
                    folded.raw_opacities, cam, bg, rcfg)
    return img[..., :3]


def _view_hessian(folded, cam, rcfg, rng, view, n_probes):
    """Hutchinson estimate of one view's sum(J J^T): [cap, 6, 6]."""
    means = folded.means.detach().requires_grad_(True)
    log_scales = folded.log_scales.detach().requires_grad_(True)
    with torch.enable_grad():
        img = _render_rgb(folded, means, log_scales, cam, rcfg)
    acc = torch.zeros((folded.capacity, 6, 6), dtype=torch.float32,
                      device=means.device)
    for k in range(n_probes):
        probe = sample_probes(rng, view, k, img.shape, means.device)
        gm, gs = torch.autograd.grad(img, [means, log_scales],
                                     grad_outputs=probe, retain_graph=True)
        j = torch.cat([gm, gs], dim=1)                     # [cap, 6]
        acc += j[:, :, None] * j[:, None, :] / n_probes
    return acc


def _fd_col(folded, cam, rcfg, dm, ds):
    """One Jacobian column by central differences: dm / ds carry the step
    in exactly one (splat, parameter) entry."""
    up = _render_rgb(folded, folded.means + dm, folded.log_scales + ds, cam,
                     rcfg)
    dn = _render_rgb(folded, folded.means - dm, folded.log_scales - ds, cam,
                     rcfg)
    return (up - dn).reshape(-1) / (2.0 * FD_EPS)


@torch.no_grad()
def _view_hessian_exact(folded, cam, rcfg, fd_col=None):
    """One view's sum(J J^T) with J built column by column from central
    differences of the forward render: 2 * 6 * capacity renders, for tiny
    scenes only (the oracle the estimate is tested against). `fd_col(cam,
    dm, ds)` computes a column (eager `_fd_col` by default, or a graph's
    replay, copied out before the next)."""
    fd_col = fd_col or (lambda c, dm, ds: _fd_col(folded, c, rcfg, dm, ds))
    cap = folded.capacity
    cols = []
    for g in range(cap):
        for which in range(6):
            dm = torch.zeros_like(folded.means)
            ds = torch.zeros_like(folded.log_scales)
            (dm if which < 3 else ds)[g, which % 3] = FD_EPS
            cols.append(fd_col(cam, dm, ds).clone())
    j = torch.stack(cols, dim=1).reshape(-1, cap, 6)       # [P, cap, 6]
    return torch.einsum("pgi,pgj->gij", j, j)


def _graphed_views(folded, rcfg, rng, n_probes, exact):
    """`view(i, cam) -> [cap, 6, 6]` of one view through a CUDA graph over
    `folded` (fixed for the call), `view.graph`: the Hutchinson body
    (render, probes, their products) captured at the first view, or the
    exact mode's column."""
    if exact:
        graph = graphs.FnGraph(
            lambda cam, dm, ds: _fd_col(folded, cam, rcfg, dm, ds),
            what="fd_col")

        def view(i, cam):
            return _view_hessian_exact(folded, cam, rcfg, graph)
    else:
        graph = graphs.FnGraph(
            lambda cam: _view_hessian(folded, cam, rcfg, rng, 0, n_probes),
            generator=rng, grad=True, what="view_hessian")

        def view(i, cam):
            return graph(cam)
    view.graph = graph
    return view


def pup_hessians(splats: Splats, cams: list, rcfg: RenderConfig,
                 rng: torch.Generator | int, n_probes: int = 8,
                 exact: bool = False) -> torch.Tensor:
    """The accumulated [cap, 6, 6] sums H = sum_views J J^T that
    `pup_scores` takes the log-determinant of."""
    folded = splats.fold_min_scale()
    dev = folded.means.device
    if not isinstance(rng, torch.Generator):
        seed = int(rng)
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
    if not exact and rcfg.forward_only:
        raise ValueError("pup_scores needs a differentiable render: "
                         "RenderConfig(forward_only=False)")
    h_acc = torch.zeros((folded.capacity, 6, 6), dtype=torch.float32,
                        device=dev)
    graphed = graphs.capturable(dev, rcfg.use_pallas)
    if graphed:
        view = _graphed_views(folded, rcfg, rng, n_probes, exact)
    elif exact:
        def view(i, cam):
            return _view_hessian_exact(folded, cam, rcfg)
    else:
        def view(i, cam):
            return _view_hessian(folded, cam, rcfg, rng, i, n_probes)
    for i, cam in enumerate(cams):
        h_acc += view(i, cam)
    if graphed:
        del view            # the graph and its pool
        graphs.free_pools()
    return h_acc


@torch.no_grad()
def scores_from_hessians(h_acc: torch.Tensor) -> torch.Tensor:
    h = h_acc + H_EPS * torch.eye(6, dtype=h_acc.dtype, device=h_acc.device)
    _, logdet = torch.linalg.slogdet(h)
    return torch.where(torch.isfinite(logdet), logdet,
                       torch.full_like(logdet, float("-inf")))


def pup_scores(splats: Splats, cams: list, rcfg: RenderConfig,
               rng: torch.Generator | int, n_probes: int = 8,
               exact: bool = False) -> torch.Tensor:
    """Per-splat PUP score: log|det(H + eps I)| with H = sum_views J J^T
    over [d_mean, d_log_scale] (lod.rs:44-112). `cams` is a list of
    CameraInputs; `rng` a generator on the splats' device, or a seed.

    The default mode estimates J J^T with `n_probes` random image-space
    probes per view (E[J^T v v^T J] = J^T J for unit-variance v).
    `exact=True` accumulates the per-pixel Jacobian outer products like the
    reference (lod.rs:78), by finite differences of the forward render."""
    return scores_from_hessians(
        pup_hessians(splats, cams, rcfg, rng, n_probes, exact))


@torch.no_grad()
def decimate_to_count(splats: Splats, scores: torch.Tensor,
                      keep_count: int) -> Splats:
    """Keep the `keep_count` highest-scoring live splats (lod.rs:13-42),
    compacted to the front; the rest become dead slots."""
    cap = splats.capacity
    lanes = torch.arange(cap, device=scores.device)
    key = torch.where(lanes < splats.n_alive, scores,
                      torch.full_like(scores, float("-inf")))
    order = torch.argsort(-key, stable=True)             # best first
    n_keep = torch.clamp_max(splats.n_alive, keep_count).to(torch.int32)
    raw = splats.raw_opacities[order]
    return dataclasses.replace(
        splats,
        means=splats.means[order],
        log_scales=splats.log_scales[order],
        quats=splats.quats[order],
        sh_coeffs=splats.sh_coeffs[order],
        raw_opacities=torch.where(lanes < n_keep, raw,
                                  torch.full_like(raw, DEAD_RAW_OPACITY)),
        min_scale=(None if splats.min_scale is None
                   else splats.min_scale[order]),
        n_alive=n_keep,
    )
