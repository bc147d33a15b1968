"""Adam with per-element LR scaling and optional reduced second moment
(port of `brush_tpu/train/adam_scaled.py`; the reference is
brush-train/src/adam_scaled.rs:94-213).

Standard bias-corrected Adam (beta1 = 0.9, beta2 = 0.999, eps = 1e-15) with

* `scaling`: a broadcastable per-element learning-rate multiplier (the
  trainer uses a per-SH-band scale for the coefficients);
* a reduced second moment: when `moment2` has shape [N, 1, ...], the
  squared gradient is averaged over all trailing dims (one scalar per splat
  row, Adam-mini style), used for the SH coefficients.

The state is explicit and the step is functional (new tensors out), as in
the JAX package: refine has to cut and paste moment rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from brush_tpu_torch.constants import ADAM_EPS


@dataclasses.dataclass
class AdamParamState:
    moment1: torch.Tensor
    moment2: torch.Tensor        # full shape, or [N,1,..] when reduced
    time: torch.Tensor           # [] int32


def init_state(param: torch.Tensor,
               reduce_moment_2: bool = False) -> AdamParamState:
    m2_shape = ((param.shape[0],) + (1,) * (param.dim() - 1)
                if reduce_moment_2 else tuple(param.shape))
    return AdamParamState(
        moment1=torch.zeros(param.shape, dtype=torch.float32,
                            device=param.device),
        moment2=torch.zeros(m2_shape, dtype=torch.float32,
                            device=param.device),
        time=torch.zeros((), dtype=torch.int32, device=param.device),
    )


def adam_step(
    param: torch.Tensor,
    grad: torch.Tensor,
    state: AdamParamState,
    lr: torch.Tensor | float,
    scaling: Optional[torch.Tensor] = None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = ADAM_EPS,
) -> tuple[torch.Tensor, AdamParamState]:
    """One AdamScaled update. `scaling` broadcasts against `param` and
    multiplies the learning rate per element (adam_scaled.rs:125-130)."""
    g2 = grad * grad
    if state.moment2.shape != param.shape:
        g2 = g2.reshape(g2.shape[0], -1).mean(dim=1).reshape(
            state.moment2.shape)

    t = state.time + 1
    m1 = beta1 * state.moment1 + (1.0 - beta1) * grad
    m2 = beta2 * state.moment2 + (1.0 - beta2) * g2
    tf = t.to(torch.float32)
    m1_hat = m1 / (1.0 - beta1 ** tf)
    m2_hat = m2 / (1.0 - beta2 ** tf)
    update = m1_hat / (torch.sqrt(m2_hat) + eps)
    update = update * (lr if scaling is None else scaling * lr)
    return param - update, AdamParamState(moment1=m1, moment2=m2, time=t)
