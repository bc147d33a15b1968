"""Splat parameter container (port of `brush_tpu/models/splats.py`).

A small dataclass of tensors: the five trained arrays, the live count
`n_alive`, and the Mip-Splatting 3D filter floor `min_scale`, folded as
s <- sqrt(s^2 + f^2) with opacity energy compensation before rendering
(gaussian_splats.rs:86-111 `fold_min_scale`; the viewer folds first).
Arrays are padded to a capacity; dead slots carry a raw opacity whose
sigmoid is far below 1/255, so the projection gates cull them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from brush_tpu_torch.ops.sh import num_sh_coeffs, sh_degree_from_coeffs
from brush_tpu_torch.utils.device import resolve_device

DEAD_RAW_OPACITY = -20.0  # sigmoid ~ 2e-9 << 1/255 -> culled everywhere


@dataclasses.dataclass
class Splats:
    means: torch.Tensor          # [cap, 3]
    log_scales: torch.Tensor     # [cap, 3]
    quats: torch.Tensor          # [cap, 4] wxyz
    sh_coeffs: torch.Tensor      # [cap, K, 3]
    raw_opacities: torch.Tensor  # [cap]
    n_alive: torch.Tensor | None = None     # [] int32
    min_scale: torch.Tensor | None = None   # [cap] or None

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return sh_degree_from_coeffs(self.sh_coeffs.shape[1])

    def params(self) -> dict:
        """The five trained arrays."""
        return dict(means=self.means, log_scales=self.log_scales,
                    quats=self.quats, sh_coeffs=self.sh_coeffs,
                    raw_opacities=self.raw_opacities)

    def with_params(self, p: dict) -> "Splats":
        return dataclasses.replace(
            self, means=p["means"], log_scales=p["log_scales"],
            quats=p["quats"], sh_coeffs=p["sh_coeffs"],
            raw_opacities=p["raw_opacities"])

    def alive_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.means.device) < self.n_alive

    def opacities(self) -> torch.Tensor:
        """Rendered opacity, the 3D filter's compensation included
        (gaussian_splats.rs opacities())."""
        return torch.sigmoid(self.fold_min_scale().raw_opacities)

    def scales(self) -> torch.Tensor:
        return torch.exp(self.fold_min_scale().log_scales)

    def fold_min_scale(self) -> "Splats":
        """Fold the frozen 3D filter floor: s <- sqrt(s^2 + f^2), with
        opacity compensation sqrt(det_old / det_new) in raw-opacity space."""
        if self.min_scale is None:
            return self
        s2 = torch.exp(2.0 * self.log_scales)
        f2 = (self.min_scale ** 2)[:, None]
        new_s2 = s2 + f2
        new_log_scales = 0.5 * torch.log(new_s2)
        # The products written out: `torch.prod`'s backward reads a count of
        # zeros back to the host, which stalls the stream and which a CUDA
        # graph capture refuses (the same bits on the CPU).
        comp = torch.sqrt((s2[:, 0] * s2[:, 1] * s2[:, 2])
                          / (new_s2[:, 0] * new_s2[:, 1] * new_s2[:, 2]))
        sig = torch.sigmoid(self.raw_opacities) * comp
        sig = torch.clamp(sig, 1e-12, 1.0 - 1e-7)
        new_raw = torch.log(sig) - torch.log1p(-sig)
        return dataclasses.replace(self, log_scales=new_log_scales,
                                   raw_opacities=new_raw, min_scale=None)

    def with_sh_degree(self, degree: int) -> "Splats":
        """Pad or truncate SH bands."""
        k = num_sh_coeffs(degree)
        cur = self.sh_coeffs.shape[1]
        if k == cur:
            return self
        if k < cur:
            return dataclasses.replace(self, sh_coeffs=self.sh_coeffs[:, :k])
        pad = self.sh_coeffs.new_zeros((self.capacity, k - cur, 3))
        return dataclasses.replace(
            self, sh_coeffs=torch.cat([self.sh_coeffs, pad], dim=1))


def from_raw(
    means: np.ndarray,
    log_scales: np.ndarray,
    quats: np.ndarray,
    sh_coeffs: np.ndarray,
    raw_opacities: np.ndarray,
    capacity: int | None = None,
    device="cuda",
) -> Splats:
    """Build a padded Splats on `device` from host arrays."""
    dev = resolve_device(device)
    n = means.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < n {n}")

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    quats_p = np.zeros((cap, 4), np.float32)
    quats_p[:, 0] = 1.0
    quats_p[:n] = quats
    return Splats(
        means=pad(means),
        log_scales=pad(log_scales),
        quats=torch.from_numpy(quats_p).to(dev),
        sh_coeffs=pad(sh_coeffs),
        raw_opacities=pad(raw_opacities, fill=DEAD_RAW_OPACITY),
        n_alive=torch.tensor(n, dtype=torch.int32, device=dev),
    )


def grow_capacity(s: Splats, new_cap: int) -> Splats:
    """Geometric capacity growth at refine time, the only shape change of a
    training run: the new slots are dead (identity rotation,
    DEAD_RAW_OPACITY, zero elsewhere, a zero 3D filter floor)."""
    if new_cap <= s.capacity:
        return s
    extra = new_cap - s.capacity

    def pad(x, fill=0.0):
        return torch.cat([x, x.new_full((extra,) + x.shape[1:], fill)], dim=0)

    quat_fill = s.quats.new_zeros((extra, 4))
    quat_fill[:, 0] = 1.0
    return dataclasses.replace(
        s,
        means=pad(s.means),
        log_scales=pad(s.log_scales),
        quats=torch.cat([s.quats, quat_fill], dim=0),
        sh_coeffs=pad(s.sh_coeffs),
        raw_opacities=pad(s.raw_opacities, DEAD_RAW_OPACITY),
        min_scale=None if s.min_scale is None else pad(s.min_scale),
    )
