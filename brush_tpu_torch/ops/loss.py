"""Fused L1 + SSIM image loss (port of `brush_tpu/ops/loss.py`; the
reference is brush-loss/src/lib.rs).

Per pixel `l1_w * |pred - gt_eff| + ssim_w * ssim(pred, gt_eff)` where
`gt_eff = gt + (1 - gt.a) * bg` when compositing, the map is multiplied by
`gt.a` when masking, and channel 3 (when pred is RGBA) carries
`|pred.a - gt.a|` for alpha-match training.

Numerical contract (lib.rs:55-68, 334-346): 11-tap sigma = 1.5 normalized
Gaussian window, zero-padded at the image borders, variances floored at 0,
SSIM clamped to [-1, 1], C1 = 0.01^2, C2 = 0.03^2.

Plain PyTorch, as the JAX package computes the loss outside any Pallas
kernel. Two choices of the port:

  * The separable blur is written as 11 shifted multiply-adds per axis on a
    zero-padded tensor, not as a library convolution: a float32 `conv2d`
    goes through cuDNN in TF32 by default, and reduced precision wrecks the
    x^2 / xy moment differences (SSIM of identical images read 0.55 with
    bf16 convolutions on the TPU). The shifted sums are exact float32 on
    every device and depend on no global flag.
  * The JAX package recomputes the blurred moments in the backward
    (`jax.checkpoint`); the port lets autograd keep them. At 1920x1080 that
    is the 15 moment maps (124 MB), their 15 blurred maps and about a dozen
    3-channel intermediates (25 MB each): one forward and backward of the
    loss peaks 745 MiB above its inputs on an NVIDIA H100 80GB HBM3,
    freed after the backward. That is
    little on an 80 GB card, and it saves the second blur.

The maximum and clamp gradients split evenly at ties, as XLA's do (a flat
image has variances of exactly 0).

GT stays packed as 32-bit RGBA words (R in the low byte). PyTorch's uint32
support is partial, so the port's tensors are int32 holding the same bits;
`unpack_gt` also takes uint32 and int64 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from brush_tpu_torch.constants import (
    SSIM_C1,
    SSIM_C2,
    SSIM_SIGMA,
    SSIM_WINDOW,
)
from brush_tpu_torch.utils.device import device_constant, resolve_device


def _gauss_taps() -> np.ndarray:
    x = np.arange(SSIM_WINDOW, dtype=np.float32) - (SSIM_WINDOW // 2)
    w = np.exp(-x * x / (2.0 * SSIM_SIGMA * SSIM_SIGMA))
    return (w / w.sum()).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ImageLossConfig:
    l1_weight: float = 0.8
    ssim_weight: float = -0.2      # negative: maximizing SSIM (train.rs:209-212)
    composite_bg: tuple | None = None  # fold gt + (1-a)*bg when set
    mask: bool = False             # multiply loss map by gt.a
    alpha_match: bool = False      # pred is RGBA; emit |pred.a-gt.a| channel


def unpack_gt(gt_packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[H, W] packed RGBA words -> ([H, W, 3] rgb, [H, W] alpha) in [0, 1]."""
    if gt_packed.dtype == torch.uint32:
        gt_packed = gt_packed.view(torch.int32)
    g = gt_packed.to(torch.int64)
    rgb = torch.stack([(g >> (8 * c)) & 0xFF for c in range(3)],
                      dim=-1).to(torch.float32)
    a = ((g >> 24) & 0xFF).to(torch.float32)
    return rgb / 255.0, a / 255.0


def unpack_gt_rgb(gt_packed: torch.Tensor, composite_bg=None) -> torch.Tensor:
    """f32 RGB ground truth (lib.rs unpack_gt_rgb:1126), LPIPS path only."""
    rgb, a = unpack_gt(gt_packed)
    if composite_bg is not None:
        bg = device_constant(composite_bg, rgb.device)
        rgb = rgb + (1.0 - a[..., None]) * bg
    return rgb


def pack_gt(rgb, alpha=None):
    """[H, W, 3] + optional [H, W] alpha in [0, 1] -> [H, W] packed words:
    numpy arrays give a uint32 array on the host (as the JAX package's
    `pack_gt`), tensors an int32 tensor with the same bits on their
    device."""
    if not torch.is_tensor(rgb):
        q = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint32)
        a = (np.full(rgb.shape[:2], 255, np.uint32) if alpha is None
             else np.clip(np.rint(alpha * 255.0), 0, 255).astype(np.uint32))
        return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (a << 24)
    q = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.int64)
    a = (torch.full(rgb.shape[:2], 255, dtype=torch.int64, device=rgb.device)
         if alpha is None
         else torch.clamp(torch.round(alpha * 255.0), 0, 255).to(torch.int64))
    word = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (a << 24)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def gt_tensor(gt_packed: np.ndarray, device="cuda") -> torch.Tensor:
    """Host uint32 packed GT -> int32 tensor with the same bits."""
    words = np.ascontiguousarray(gt_packed, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(resolve_device(device))


def _blur_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    pad = SSIM_WINDOW // 2
    n = x.shape[dim]
    widths = [0, 0, 0, 0]
    widths[2 * (x.dim() - 1 - dim)] = widths[2 * (x.dim() - 1 - dim) + 1] = pad
    xp = torch.nn.functional.pad(x, widths)
    out = taps[0] * xp.narrow(dim, 0, n)
    for k in range(1, SSIM_WINDOW):
        out = out + taps[k] * xp.narrow(dim, k, n)
    return out


def _blur11(x: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 11-tap Gaussian over [C, H, W], in exact
    float32 (no library convolution)."""
    taps = [float(t) for t in _gauss_taps()]
    return _blur_axis(_blur_axis(x, taps, 1), taps, 2)


def _max0(x):
    return torch.maximum(torch.zeros_like(x), x)


def _loss_map(pred, gt_packed, cfg: ImageLossConfig, bg_dyn=None):
    gt_rgb, gt_a = unpack_gt(gt_packed)
    bg = (device_constant(cfg.composite_bg, pred.device)
          if cfg.composite_bg is not None else bg_dyn)
    if bg is not None:
        gt_rgb = gt_rgb + (1.0 - gt_a[..., None]) * bg

    p = pred[..., :3].movedim(-1, 0)   # [3, H, W]
    g = gt_rgb.movedim(-1, 0)

    b = _blur11(torch.cat([p, p * p, g, g * g, p * g], dim=0))  # [15, H, W]
    mu1, m11, mu2, m22, m12 = b[0:3], b[3:6], b[6:9], b[9:12], b[12:15]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    sigma1_sq = _max0(m11 - mu1_sq)
    sigma2_sq = _max0(m22 - mu2_sq)
    sigma12 = m12 - mu1 * mu2
    a_t = mu1_sq + mu2_sq + SSIM_C1
    b_t = sigma1_sq + sigma2_sq + SSIM_C2
    c_t = 2.0 * mu1 * mu2 + SSIM_C1
    d_t = 2.0 * sigma12 + SSIM_C2
    ratio = (c_t * d_t) / (a_t * b_t)
    ssim_map = torch.minimum(torch.maximum(ratio, torch.full_like(ratio, -1.0)),
                             torch.ones_like(ratio))

    loss = cfg.l1_weight * torch.abs(p - g) + cfg.ssim_weight * ssim_map
    loss = loss.movedim(0, -1)  # [H, W, 3]

    if cfg.alpha_match:
        if pred.shape[-1] != 4:
            raise ValueError("alpha_match requires RGBA pred")
        amatch = torch.abs(pred[..., 3] - gt_a)
        loss = torch.cat([loss, amatch[..., None]], dim=-1)

    if cfg.mask:
        loss = loss * gt_a[..., None]
    return loss


def image_loss_map(pred, gt_packed, cfg: ImageLossConfig, bg_dyn=None):
    """Per-pixel loss map [H, W, 3|4]; differentiable w.r.t. pred (and
    bg_dyn, a tensor composite background overriding cfg.composite_bg)."""
    return _loss_map(pred, gt_packed, cfg, bg_dyn)


def image_loss(pred, gt_packed, cfg: ImageLossConfig,
               match_alpha_weight: float = 0.0, bg_dyn=None):
    """Scalar training loss, combined like SplatTrainer::step
    (train.rs:235-241)."""
    lmap = image_loss_map(pred, gt_packed, cfg, bg_dyn)
    if cfg.alpha_match:
        return lmap[..., :3].mean() + lmap[..., 3].mean() * match_alpha_weight
    return lmap.mean()


def ssim(pred_rgb, gt_packed, composite_bg=None, mask: bool = False):
    """Mean SSIM via the fused map with (l1, ssim) weights (0, 1), the
    reference's eval path (eval.rs:44-49)."""
    cfg = ImageLossConfig(l1_weight=0.0, ssim_weight=1.0,
                          composite_bg=composite_bg, mask=mask)
    return image_loss_map(pred_rgb[..., :3], gt_packed, cfg).mean()


def psnr(pred_rgb, gt_packed):
    """PSNR = 10*log10(1 / mean(|p-g|^2)) on the decoded GT (eval.rs:36-54)."""
    gt_rgb, _ = unpack_gt(gt_packed)
    mse = ((pred_rgb[..., :3] - gt_rgb) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)
