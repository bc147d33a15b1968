"""Device selection for the functions that create tensors.

The port runs on the card unless the caller asks for the CPU: every such
function takes `device="cuda"` by default, and this helper refuses a CUDA
device when PyTorch has none (there is no silent CPU fallback).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "brush_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant (a flat sequence of numbers) as a 1-D tensor on
    `device`, written there by one fill an entry: no copy from the host, so
    the stream never waits for it (PyTorch synchronises after a copy from
    pageable memory) and a CUDA graph can capture it. The entries round as
    `torch.tensor(values, dtype=dtype)` rounds them. A tensor is returned as
    `torch.as_tensor(values, dtype=dtype, device=device)` returns it."""
    if torch.is_tensor(values):
        return torch.as_tensor(values, dtype=dtype, device=device)
    values = list(values)
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
