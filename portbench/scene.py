"""Synthetic splat scenes of the reference's bench (brush-bench-test
benches.rs:23-95): positions uniform in [-5,5] x [-3,3] x [-10,10],
log-scales ln U[0.01, 0.1] with a per-axis factor U[0.8, 1.2] on two axes,
uniform random rotations (Shoemake), DC colour coefficients U[0.1, 0.9]
and the higher SH bands zero, raw opacities U[0.05, 1.0] (pre-sigmoid).

Made on the device from the seed with a `torch.Generator`, a few large
draws, in float32."""

from __future__ import annotations

import math

import torch


def bench_scene(count: int, seed: int, sh_degree: int, device) -> dict:
    """The five arrays of a bench scene of `count` splats."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g,
                                            dtype=torch.float32,
                                            device=device)

    box = torch.tensor([5.0, 3.0, 10.0], device=device)
    means = (2.0 * u((count, 3), 0.0, 1.0) - 1.0) * box
    base = torch.log(u((count,), 0.01, 0.1))
    var = u((count, 2), 0.8, 1.2)
    log_scales = torch.stack([base, base * var[:, 0], base * var[:, 1]], -1)
    u1, u2, u3 = u((3, count), 0.0, 1.0)
    quats = torch.stack([
        torch.sqrt(1 - u1) * torch.sin(2 * math.pi * u2),
        torch.sqrt(1 - u1) * torch.cos(2 * math.pi * u2),
        torch.sqrt(u1) * torch.sin(2 * math.pi * u3),
        torch.sqrt(u1) * torch.cos(2 * math.pi * u3),
    ], -1)
    sh = torch.zeros((count, (sh_degree + 1) ** 2, 3), dtype=torch.float32,
                     device=device)
    sh[:, 0] = u((count, 3), 0.1, 0.9)
    raw = u((count,), 0.05, 1.0)
    return dict(means=means, log_scales=log_scales, quats=quats,
                sh_coeffs=sh, raw_opacities=raw)
