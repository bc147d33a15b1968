"""Evaluation: PSNR / SSIM over eval views (port of
`brush_tpu/train/eval.py`; the reference is brush-train/src/eval.rs:22-63):
render on a black background, simulate the 8-bit round trip,
PSNR = 10*log10(1 / mean(err^2)), SSIM via the fused loss map.

On the card with the kernel path, each view's render, round trip and
metrics run as one CUDA graph (`graphs.RENDER_GRAPHS`, the counterpart of
the JAX package's jitted `_eval_step_fn`); elsewhere they run eagerly."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from brush_tpu_torch.graphs import RENDER_GRAPHS
from brush_tpu_torch.models.splats import Splats
from brush_tpu_torch.ops import loss as loss_mod
from brush_tpu_torch.render import RenderConfig, camera_inputs, render


@dataclasses.dataclass
class EvalStats:
    psnr: float
    ssim: float
    per_view_psnr: list
    per_view_ssim: list


@torch.no_grad()
def _eval_step(means, log_scales, quats, sh_coeffs, raw_opacities, cam,
               gt_packed, rcfg: RenderConfig):
    """Render, 8-bit round trip and metrics for one view. Returns (rgb,
    psnr, ssim, remainder slots needed)."""
    black = torch.zeros(3, dtype=torch.float32, device=means.device)
    img, aux = render(means, log_scales, quats, sh_coeffs, raw_opacities,
                      cam, black, rcfg)
    # 8-bit round trip (eval.rs:36-43); round is half-to-even as in JAX.
    rgb = torch.round(torch.clamp(img[..., :3], 0.0, 1.0) * 255.0) / 255.0
    over = aux.num_isects
    if not rcfg.use_pallas:
        over = torch.maximum(over, torch.where(
            aux.max_isects_per_tile > rcfg.max_per_tile,
            torch.full_like(over, rcfg.isect_cap + 1),
            torch.zeros_like(over)))
    return (rgb, loss_mod.psnr(rgb, gt_packed), loss_mod.ssim(rgb, gt_packed),
            over)


def eval_views(splats: Splats, views, rcfg: RenderConfig,
               save_dir: str | None = None, step: int = 0) -> EvalStats:
    """`views`: iterable of (camera, gt_packed [H, W] packed words) pairs;
    the ground truth is a tensor on the splats' device or a host array.
    Each view renders through its camera's own lens (`rcfg.model` is
    replaced by `camera.model`).
    With `save_dir`, each rendered view is saved as a PNG (eval.rs:56-63)."""
    psnrs, ssims = [], []
    folded = splats.fold_min_scale()
    arrays = (folded.means, folded.log_scales, folded.quats,
              folded.sh_coeffs, folded.raw_opacities)
    dev = folded.means.device

    def view_step(cam, gt_packed, rcfg):
        if dev.type == "cuda" and rcfg.use_pallas:
            return RENDER_GRAPHS.get(_eval_step, rcfg, folded.capacity)(
                *arrays, cam, gt_packed)
        return _eval_step(*arrays, cam, gt_packed, rcfg)

    for i, (camera, gt_packed) in enumerate(views):
        rcfg = dataclasses.replace(rcfg, model=camera.model)
        cam = camera_inputs(camera, rcfg.img_size, device=dev)
        if not torch.is_tensor(gt_packed):
            gt_packed = loss_mod.gt_tensor(gt_packed, device=dev)
        rgb, p, s, num_isects = view_step(cam, gt_packed, rcfg)
        # An overflow would silently drop contributions and corrupt the
        # PSNR: retry with doubled capacity (the training loop's
        # grow-on-overflow policy). The host reads the count here.
        while int(num_isects) > rcfg.isect_cap:
            rcfg = dataclasses.replace(
                rcfg, isect_cap=rcfg.isect_cap * 2,
                max_per_tile=rcfg.max_per_tile * 2)
            rgb, p, s, num_isects = view_step(cam, gt_packed, rcfg)
        psnrs.append(float(p))
        ssims.append(float(s))
        if save_dir is not None:
            from pathlib import Path

            from PIL import Image
            d = Path(save_dir)
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(
                (rgb.cpu().numpy() * 255.0).astype(np.uint8)).save(
                    d / f"eval_{step:06d}_view{i:03d}.png")
    return EvalStats(
        psnr=float(np.mean(psnrs)) if psnrs else float("nan"),
        ssim=float(np.mean(ssims)) if ssims else float("nan"),
        per_view_psnr=psnrs,
        per_view_ssim=ssims,
    )
