"""brush_tpu_torch: the PyTorch + CUDA port of brush_tpu for NVIDIA Hopper.

The JAX package `brush_tpu` is the frozen reference; this package never
imports it (nor JAX). Module paths and function names follow the JAX
package, with `_pallas` replaced by `_cuda` in kernel modules. Plain tensor
code is PyTorch; every TPU kernel on the ported path is a CUDA C++ kernel
under `csrc/`, built with nvcc at its first launch (`kernels/build.py`).

Ported so far: the forward-only render (the viewer / serving path),
`render(...)` with `RenderConfig(use_pallas=True, forward_only=True)`, and
one single-view training step, `train.trainer.train_step(...)` with
`RenderConfig(use_pallas=True)` (differentiable render, fused L1 + SSIM
loss, AdamScaled, the overflow no-op gate).
Importing the package builds and loads nothing CUDA-specific.
"""

__version__ = "0.1.0"
