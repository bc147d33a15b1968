"""brush_tpu_torch: the PyTorch + CUDA port of brush_tpu for NVIDIA Hopper.

The JAX package `brush_tpu` is the frozen reference; this package never
imports it (nor JAX). Module paths and function names follow the JAX
package, with `_pallas` replaced by `_cuda` in kernel modules. Plain tensor
code is PyTorch; every TPU kernel on the ported path is a CUDA C++ kernel
under `csrc/`, built with nvcc at its first launch (`kernels/build.py`).

Ported so far: the forward-only render (the serving path), the
training step (differentiable render, fused L1 + SSIM loss, the optional
LPIPS term, AdamScaled, the overflow no-op gate; single-view or
`batched=True` on one device), refine, splat init, eval and the LOD bake,
the run from a dataset to a PLY: the dataset readers (COLMAP, Nerfstudio,
RealityCapture), PLY I/O, full-state checkpoints, `process.train_process`
and the CLI (`python -m brush_tpu_torch.cli <dataset>`); the web viewer
(`viewer/`, `--view`, a live view of training), and the C ABI with its
native COLMAP parser (`native/`, built with g++ by
`python -m brush_tpu_torch.native.build`). `RenderConfig(use_pallas=
False)` renders through the plain twin of the JAX package's jnp rasterizer
(ops/rasterize_torch.py). Multi-device training and rendering
(`parallel/`) run over `torch.distributed`: views of a step shared among
processes (`torchrun ... -m brush_tpu_torch.cli --views-per-batch B`),
and an image rendered in strips.
Importing the package builds and loads nothing: no kernel, no native
library.
"""

__version__ = "0.1.0"
