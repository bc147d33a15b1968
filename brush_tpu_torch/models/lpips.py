"""LPIPS perceptual metric (VGG16 backbone + 1x1 linear heads); port of
`brush_tpu/models/lpips.py`.

Counterpart of crates/lpips (lib.rs:73-215): VGG16 feature extraction at the
five standard taps, unit-normalized feature differences, 1x1 linear heads,
spatial mean, summed across taps. Weights come from a `.npz` in the JAX
package's layout (`conv_{b}_{i}/w` HWIO, `conv_{b}_{i}/b`, `lin_{b}/w`
[1, 1, C, 1]), which `load_lpips` reads and turns into PyTorch's OIHW; see
`convert_torch_lpips` for producing one from the public `lpips` PyPI package.
The repository ships no weights.

The model computes in NCHW; it takes and compares images as the JAX one
does, [B, H, W, 3] in [0, 1], at least 64 px a side (four 2x2 poolings
before the last tap). Every convolution, and the convolution that carries
its gradient back to the image, runs in full float32: PyTorch would let
cuDNN use TF32 on the card (`torch.backends.cudnn.allow_tf32` is True by
default), where the JAX package asks for `Precision.HIGHEST`, so both run
under `torch.backends.cudnn.flags(allow_tf32=False)` (`_Conv2d`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from brush_tpu_torch.utils.device import resolve_device

# VGG16 conv layout: (out_channels, n_convs) per block; taps after each block's
# final ReLU (torchvision feature indices 3, 8, 15, 22, 29).
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# Input normalization used by the lpips package (its `scaling_layer`).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class _Conv2d(torch.autograd.Function):
    """`F.conv2d` of an image with fixed weights, forward and backward (the
    gradient w.r.t. the image only) under cuDNN flags that allow TF32 only
    when `allow_tf32` is set."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int, allow_tf32: bool):
        ctx.save_for_backward(w)
        ctx.conf = (x.shape, padding, allow_tf32)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=allow_tf32):
            return F.conv2d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        shape, padding, allow_tf32 = ctx.conf
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=allow_tf32):
            gx = torch.nn.grad.conv2d_input(shape, w, g, padding=padding)
        return gx, None, None, None, None


class LpipsModel(torch.nn.Module):
    """LPIPS with fixed weights: `conv_{b}_{i}` weights [cout, cin, 3, 3]
    and biases [cout], `lin_{b}` weights [1, C, 1, 1], as buffers (nothing
    here is trained; gradients flow to the images only).

    `allow_tf32` False (the default) keeps the convolutions in float32 as
    the JAX package's `Precision.HIGHEST` does; True lets cuDNN take TF32
    on the card, only to show what that would change."""

    def __init__(self, params: dict, allow_tf32: bool = False):
        super().__init__()
        self.allow_tf32 = allow_tf32
        for name, value in params.items():
            self.register_buffer(name.replace("/", "_"), value)
        dev = next(iter(params.values())).device
        self.register_buffer("shift", torch.from_numpy(_SHIFT).to(dev)
                             .reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).to(dev)
                             .reshape(1, 3, 1, 1))

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name.replace("/", "_"))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [B, H, W, 3] in [0, 1] -> the five tap activations, NCHW."""
        h = (x.permute(0, 3, 1, 2) * 2.0 - 1.0 - self.shift) / self.scale
        taps = []
        for b, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for i in range(n_convs):
                h = F.relu(_Conv2d.apply(h, self._p(f"conv_{b}_{i}/w"),
                                         self._p(f"conv_{b}_{i}/b"), 1,
                                         self.allow_tf32))
            taps.append(h)
            if b < len(_VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2)
        return taps

    def forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """LPIPS distance between [B, H, W, 3] images in [0, 1] (lpips:73):
        the mean over the batch."""
        fp = self.features(pred)
        fg = self.features(gt)
        total = 0.0
        for b, (p, g) in enumerate(zip(fp, fg)):
            pn = p / torch.sqrt(torch.sum(p * p, dim=1, keepdim=True) + 1e-10)
            gn = g / torch.sqrt(torch.sum(g * g, dim=1, keepdim=True) + 1e-10)
            diff = (pn - gn) ** 2
            val = _Conv2d.apply(diff, self._p(f"lin_{b}/w"), None, 0,
                                self.allow_tf32)
            total = total + torch.mean(val, dim=(1, 2, 3))
        return torch.mean(total)


def _param_names():
    for b, (_, n) in enumerate(_VGG_BLOCKS):
        for i in range(n):
            yield f"conv_{b}_{i}/w"
            yield f"conv_{b}_{i}/b"
        yield f"lin_{b}/w"


def lpips_from_numpy(params: dict, device="cuda") -> LpipsModel:
    """A model from arrays in the JAX package's layout:
    {"conv_{b}_{i}": {"w": [kh, kw, cin, cout], "b": [cout]},
     "lin_{b}": {"w": [1, 1, cin, 1]}} (HWIO), turned into OIHW float32
    tensors on `device`."""
    dev = resolve_device(device)
    out = {}
    for key in _param_names():
        group, leaf = key.rsplit("/", 1)
        a = np.asarray(params[group][leaf], np.float32)
        if leaf == "w":
            a = a.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return LpipsModel(out)


def load_lpips(path: str | Path, device="cuda") -> LpipsModel:
    """Load converted weights (.npz produced by convert_torch_lpips, the
    JAX package's layout) onto `device`."""
    params: dict = {}
    with np.load(path) as data:
        for key in data.files:
            group, leaf = key.rsplit("/", 1)
            params.setdefault(group, {})[leaf] = data[key]
    return lpips_from_numpy(params, device=device)


def convert_torch_lpips(out_path: str) -> None:
    """One-off converter from the public `lpips` PyPI package (run on a
    machine with the package + weights; mirrors crates/lpips-convert).
    Writes the JAX package's `.npz` layout (HWIO), which `load_lpips`
    reads. The package is not installed here, so this stays untested."""
    import lpips as lpips_pkg  # type: ignore

    net = lpips_pkg.LPIPS(net="vgg")
    out = {}
    convs = [m for m in net.net.slice1] + [m for m in net.net.slice2] + \
            [m for m in net.net.slice3] + [m for m in net.net.slice4] + \
            [m for m in net.net.slice5]
    convs = [m for m in convs if isinstance(m, torch.nn.Conv2d)]
    idx = 0
    for b, (_, n) in enumerate(_VGG_BLOCKS):
        for i in range(n):
            m = convs[idx]
            idx += 1
            out[f"conv_{b}_{i}/w"] = m.weight.detach().numpy().transpose(2, 3, 1, 0)
            out[f"conv_{b}_{i}/b"] = m.bias.detach().numpy()
    for b, lin in enumerate(net.lins):
        w = lin.model[-1].weight.detach().numpy()  # [1, C, 1, 1]
        out[f"lin_{b}/w"] = w.transpose(2, 3, 1, 0)
    np.savez(out_path, **out)


def random_lpips_arrays(seed: int = 0) -> dict:
    """The random weights of `random_lpips`, as numpy arrays in the JAX
    package's layout (HWIO): the draws of its `random_lpips(seed)` in its
    order, so both packages hold the same weights."""
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    for b, (ch, n) in enumerate(_VGG_BLOCKS):
        for i in range(n):
            params[f"conv_{b}_{i}"] = {
                "w": rng.normal(0, 0.05, (3, 3, cin, ch)).astype(np.float32),
                "b": np.zeros((ch,), np.float32),
            }
            cin = ch
        params[f"lin_{b}"] = {
            "w": np.abs(rng.normal(0, 0.05, (1, 1, ch, 1))).astype(
                np.float32)}
    return params


def random_lpips(seed: int = 0, device="cuda") -> LpipsModel:
    """Random-weight model for architecture/shape tests only."""
    return lpips_from_numpy(random_lpips_arrays(seed), device=device)


def save_lpips_npz(params: dict, path: str | Path) -> None:
    """Write arrays in the JAX package's layout as the `.npz` that
    `load_lpips` (and the JAX package's `load_lpips`) read."""
    np.savez(path, **{f"{group}/{leaf}": np.asarray(value)
                      for group, leaves in params.items()
                      for leaf, value in leaves.items()})
