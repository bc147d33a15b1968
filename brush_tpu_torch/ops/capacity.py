"""Capacity planning: size the tile-sort slot space from the scene
(port of `brush_tpu/ops/capacity.py`).

A counting pass (projection geometry only, no SH) gives the remainder
slots each candidate dense width k0 would need, and the plan picks

  * ``expand_k0`` — the dense per-splat expansion width minimizing the JAX
    package's per-slot cost model (one sort visit per slot, plus an
    expansion cost per remainder-capacity slot);
  * ``isect_cap`` — the remainder capacity, rounded up to a coarse
    {2^k, 1.5*2^k} grid.

The cost constants are the JAX package's, kept so both packages plan the
same capacities for a scene; they are not measurements of the H100.
"""

from __future__ import annotations

import numpy as np
import torch

from brush_tpu_torch.camera import Pinhole
from brush_tpu_torch.ops.project_cuda import project
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.ops.tiling import exact_tile_counts
from brush_tpu_torch.utils.device import resolve_device

_SORT_NS_PER_SLOT = 11.0
_EXPAND_NS_PER_CAP = 3.5

_K0_CANDIDATES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def round_cap(n: int, minimum: int = 1 << 13) -> int:
    """Round up to the {2^k, 1.5*2^k} grid (padding waste <= 1.26x)."""
    n = max(int(n), minimum)
    p = 1 << max(int(np.ceil(np.log2(n))) - 1, 0)
    for cap in (p, p + p // 2, 2 * p, 3 * p):
        if cap >= n:
            return cap
    return 4 * p


def plan_caps(
    means,
    log_scales,
    quats,
    raw_opacities,
    cam_inputs: CameraInputs,
    img_size: tuple[int, int],
    *,
    model=None,
    mip_splatting: bool = False,
    margin: float = 1.1,
    device="cuda",
) -> tuple[int, int]:
    """Pick (expand_k0, isect_cap) for this scene and view, counting on
    `device`. The margin covers view-to-view variation; callers that sweep
    cameras plan on the worst view or retry on overflow."""
    dev = resolve_device(device)
    model = Pinhole() if model is None else model
    means, log_scales, quats, raw_opacities = (
        x.to(dev) for x in (means, log_scales, quats, raw_opacities))
    cam = CameraInputs(*(x.to(dev) if torch.is_tensor(x) else x
                         for x in cam_inputs))
    with torch.no_grad():
        sh0 = torch.zeros((means.shape[0], 1, 3), dtype=torch.float32,
                          device=dev)
        proj = project(means, log_scales, quats, sh0, raw_opacities, cam,
                       img_size, sh_degree=0, model=model,
                       mip_splatting=mip_splatting)
        _, cnt = exact_tile_counts(proj)
        cnt = cnt.to(torch.int64)
        rems = torch.stack([torch.clamp_min(cnt - k, 0).sum()
                            for k in _K0_CANDIDATES]).cpu().numpy()

    n = means.shape[0]
    best_k0, best_cost, best_cap = 1, float("inf"), 0
    for k0, rem in zip(_K0_CANDIDATES, rems):
        cap = round_cap(int(rem * margin))
        cost = (_SORT_NS_PER_SLOT * (n * k0 + cap)
                + _EXPAND_NS_PER_CAP * cap)
        if cost < best_cost:
            best_k0, best_cost, best_cap = k0, cost, cap
    return best_k0, best_cap
