"""Scene, views, image loading, and packed GT batches (port of
`brush_tpu/data/scene.py`).

Counterparts of brush-dataset/src/{scene.rs,load_image.rs}: views carry a
camera + lazily-decoded image; ground truth is packed to [H, W] u32 RGBA
(scene.rs:117-129 — ~4x less pixel memory, decoded in-kernel by the loss);
masks merge into the alpha channel; `Transparent` alpha premultiplies
(scene.rs:90-110); images Lanczos-downscale to max_resolution
(load_image.rs:193-226).

Pillow is imported inside the functions that decode, so the package
imports on a machine without it. Ground truth stays host numpy: the
training step copies it to the device."""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.data.vfs import Vfs


class AlphaMode(enum.Enum):
    NONE = "none"              # no alpha in source
    TRANSPARENT = "transparent"  # alpha = transparency; premultiply
    MASKED = "masked"          # alpha = loss mask


@dataclasses.dataclass
class SceneView:
    image_path: str
    camera: Camera
    mask_path: str | None = None


@dataclasses.dataclass
class Scene:
    views: list[SceneView]
    vfs: Vfs
    max_resolution: int = 1920
    subscale: int = 1          # extra integer downscale (LOD phases)

    def __len__(self):
        return len(self.views)


def load_image(vfs: Vfs, path: str, max_resolution: int,
               mask_path: str | None = None, subscale: int = 1):
    """Decode + downscale an image; merge mask into alpha
    (load_image.rs:193-226). Returns (rgb_or_rgba f32 [H,W,3|4], has_alpha)."""
    from PIL import Image
    with vfs.open(path) as f:
        img = Image.open(f)
        w0, h0 = img.size
        scale = min(1.0, max_resolution / max(w0, h0)) / subscale
        tw, th = max(1, round(w0 * scale)), max(1, round(h0 * scale))
        if img.format == "JPEG" and scale < 1.0:
            # IDCT scale-on-decode: decode near the target resolution
            # instead of full-res (load_image.rs:193-226 does the same
            # via zune-jpeg). PIL picks the nearest 1/1..1/8 DCT scale;
            # the Lanczos pass below lands on the exact target.
            img.draft(img.mode, (tw, th))
        img.load()
    has_alpha = img.mode in ("RGBA", "LA", "PA")
    img = img.convert("RGBA" if has_alpha else "RGB")

    if img.size != (tw, th):
        img = img.resize((tw, th), Image.LANCZOS)

    arr = np.asarray(img, np.float32) / 255.0

    if mask_path is not None:
        with vfs.open(mask_path) as f:
            m = Image.open(f)
            m.load()
        m = m.convert("L")
        if m.size != img.size:
            m = m.resize(img.size, Image.LANCZOS)
        mask = np.asarray(m, np.float32) / 255.0
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, mask[..., None]], axis=-1)
        else:
            arr[..., 3] = arr[..., 3] * mask
        has_alpha = True
    return arr, has_alpha


def pack_rgba(arr: np.ndarray, alpha_mode: AlphaMode) -> np.ndarray:
    """[H,W,3|4] f32 -> [H,W] u32 packed RGBA GT (scene.rs:117-129).
    Transparent mode premultiplies rgb by alpha (scene.rs:90-110)."""
    rgb = arr[..., :3]
    if arr.shape[-1] == 4:
        a = arr[..., 3]
        if alpha_mode == AlphaMode.TRANSPARENT:
            rgb = rgb * a[..., None]
    else:
        a = np.ones(arr.shape[:2], np.float32)
    q = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint32)
    qa = np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (qa << 24)


def image_dims(vfs: Vfs, path: str, max_resolution: int, subscale: int = 1):
    """Header-only dimension probe + downscale math (load_image.rs)."""
    from PIL import Image
    with vfs.open(path) as f:
        img = Image.open(f)
        w, h = img.size
    scale = min(1.0, max_resolution / max(w, h)) / subscale
    if scale < 1.0:
        return max(1, round(w * scale)), max(1, round(h * scale))
    return w, h


def split_eval_every(views: Sequence[SceneView], eval_every: int | None):
    """Train/eval split: every-nth view to eval (formats/mod.rs:135)."""
    if not eval_every or eval_every <= 0:
        return list(views), []
    train, evals = [], []
    for i, v in enumerate(views):
        (evals if i % eval_every == 0 else train).append(v)
    return train, evals
