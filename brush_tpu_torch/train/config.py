"""Training configuration (a copy of `brush_tpu/train/config.py`), mirroring
the reference's TrainConfig defaults (brush-train/src/config.rs:7-132;
catalogued in SURVEY.md §5.6)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class TrainConfig:
    total_train_iters: int = 30_000

    # Learning rates.
    lr_mean: float = 2e-5            # scaled by median scene extent per step
    lr_mean_end: float = 2e-7        # exponential decay target
    mean_noise_weight: float = 50.0
    lr_coeffs_dc: float = 2e-3
    lr_coeffs_sh_scale: float = 10.0  # higher SH bands get lr/this
    lr_opac: float = 0.012
    lr_scale: float = 5e-3
    lr_rotation: float = 2e-3

    # Refine.
    max_splats: int = 10_000_000
    refine_every: int = 200
    growth_grad_threshold: float = 0.0025
    growth_select_fraction: float = 0.25
    growth_stop_iter: int = 15_000
    split_at_screen_size: float = 0.5

    # Loss.
    ssim_weight: float = 0.2
    opac_decay: float = 0.004
    match_alpha_weight: float = 0.1
    lpips_loss_weight: float = 0.0

    # Background.
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    background_noise_strength: float = 0.1

    # LOD baking.
    lod_levels: int = 0
    lod_refine_steps: int = 5000
    lod_decimation_keep: int = 50
    lod_image_scale: int = 50

    random_init_scene_scale: float | None = None

    def mean_lr_decay(self) -> float:
        """Per-step exponential decay factor (train.rs:121-123)."""
        return (self.lr_mean_end / self.lr_mean) ** (1.0 / self.total_train_iters)


# Constants pinned by the reference trainer (train.rs:34-49).
BOUND_PERCENTILE = 0.8
MIN_OPACITY = 1.0 / 255.0
MIN_SCALE_FREEZE_FRAC = 0.9
MIN_SCALE_FACTOR = 0.1
