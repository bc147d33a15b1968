"""The training loss of 3DGS as Brush takes it: per pixel and channel
0.8 |pred - gt| - 0.2 SSIM(pred, gt), averaged (Brush brush-loss lib.rs;
train.rs:209-241). SSIM uses an 11-tap Gaussian window of sigma 1.5,
normalised, zero-padded at the borders, variances floored at 0, the ratio
clamped to [-1, 1], C1 = 0.01^2, C2 = 0.03^2."""

from __future__ import annotations

import math

import torch

L1_WEIGHT = 0.8
SSIM_WEIGHT = 0.2
WINDOW = 11
SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gauss_taps() -> list[float]:
    xs = [i - WINDOW // 2 for i in range(WINDOW)]
    w = [math.exp(-x * x / (2.0 * SIGMA * SIGMA)) for x in xs]
    s = sum(w)
    return [v / s for v in w]


def blur(x: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded Gaussian over the last two axes of [C, H, W],
    as shifted multiply-adds (no library convolution, so no TF32)."""
    taps = gauss_taps()
    pad = WINDOW // 2
    for dim in (1, 2):
        n = x.shape[dim]
        widths = [0, 0, 0, 0]
        widths[2 * (2 - dim)] = widths[2 * (2 - dim) + 1] = pad
        xp = torch.nn.functional.pad(x, widths)
        out = taps[0] * xp.narrow(dim, 0, n)
        for k in range(1, WINDOW):
            out = out + taps[k] * xp.narrow(dim, k, n)
        x = out
    return x


def image_loss(pred_rgb: torch.Tensor, gt_rgb: torch.Tensor) -> torch.Tensor:
    """Scalar loss of [H, W, 3] images."""
    p = pred_rgb.movedim(-1, 0)
    g = gt_rgb.to(p.dtype).movedim(-1, 0)
    b = blur(torch.cat([p, p * p, g, g * g, p * g], dim=0))
    mu1, m11, mu2, m22, m12 = b[0:3], b[3:6], b[6:9], b[9:12], b[12:15]
    s1 = torch.clamp_min(m11 - mu1 * mu1, 0.0)
    s2 = torch.clamp_min(m22 - mu2 * mu2, 0.0)
    s12 = m12 - mu1 * mu2
    ssim = ((2.0 * mu1 * mu2 + C1) * (2.0 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    ssim = torch.clamp(ssim, -1.0, 1.0)
    return (L1_WEIGHT * (p - g).abs() - SSIM_WEIGHT * ssim).mean()
