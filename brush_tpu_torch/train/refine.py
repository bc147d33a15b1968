"""Scene bounds for the trainer (the part of `brush_tpu/train/refine.py`
that `init_train_state` needs; prune, resample and split are still to be
ported)."""

from __future__ import annotations

import torch


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
