"""Write tests/data/torch_train_golden.npz: the JAX package's gradients of
one render of the gsplat fixture, for machines that have no JAX.

    python tests/make_torch_train_golden.py        # runs JAX on the CPU

The scene is tests/data/basic_case.safetensors seen from the fixture's
camera over the background (0.1, 0.25, 0.4); the loss is
sum(img * linspace(0.5, 1.5, H)[:, None, None] * (1, 0.8, 0.6, 0.4)) (the
loss of tests/test_pallas_parity.py). The file holds the jnp oracle
rasterizer's (`RenderConfig(use_pallas=False)`, under `jax.jit`) gradients
of the five parameter arrays, the refine weight and the visibility mask
(the gradients of the two holders of `render_with_refine`), and the loss.
`chip_smoke.py` computes the same through the port's CUDA kernels and holds
it to the file; tests/test_torch_train.py regenerates the arrays and
compares them with the file, so it cannot go stale unnoticed.
"""

from __future__ import annotations

import importlib
import pathlib
import sys

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / "data"
GOLDEN = DATA / "torch_train_golden.npz"
BG = (0.1, 0.25, 0.4)
CHANNEL_WEIGHTS = (1.0, 0.8, 0.6, 0.4)
PARAM_KEYS = ("means", "scales", "quats", "coeffs", "opacities")


def basic_case():
    """(the five parameter arrays, camera keywords, (w, h)) of the fixture."""
    from safetensors.numpy import load_file
    d = load_file(DATA / "basic_case.safetensors")
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = dict(position=np.array([0.123, 0.456, -8.0]),
               rotation=np.array([1.0, 0.0, 0.0, 0.0]),
               fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    return [d[k] for k in PARAM_KEYS], cam, (w, h)


def row_weights(h: int) -> np.ndarray:
    return np.linspace(0.5, 1.5, h).astype(np.float32)[:, None, None]


def jax_gradients(params, cam, img, sh_degree, bg, loss_of_image,
                  isect_cap=1 << 14, max_per_tile=64):
    """Loss and gradients of the JAX package's oracle render: a dict of
    the five parameter gradients (by PARAM_KEYS), `refine_weight`,
    `visible` and `loss`, as numpy arrays."""
    import jax
    import jax.numpy as jnp
    from brush_tpu.camera import Camera
    jrender = importlib.import_module("brush_tpu.render")

    cfg = jrender.RenderConfig(img_size=img, sh_degree=sh_degree,
                               isect_cap=isect_cap,
                               max_per_tile=max_per_tile)
    ci = jrender.camera_inputs(Camera(**cam), img)
    n = params[0].shape[0]

    def loss(p, rh, vh):
        out, _ = jrender.render_with_refine(*p, ci, jnp.asarray(bg), cfg,
                                            rh, vh)
        return loss_of_image(out)

    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        tuple(jnp.asarray(p) for p in params), jnp.zeros(n), jnp.zeros(n))
    out = {k: np.asarray(g) for k, g in zip(PARAM_KEYS, grads[0])}
    out["refine_weight"] = np.asarray(grads[1])
    out["visible"] = np.asarray(grads[2])
    out["loss"] = np.asarray(value)
    return out


def golden_arrays():
    import jax.numpy as jnp
    params, cam, img = basic_case()
    wmap = row_weights(img[1])
    chan = np.asarray(CHANNEL_WEIGHTS, np.float32)
    return jax_gradients(params, cam, img, 3, np.asarray(BG, np.float32),
                         lambda out: jnp.sum(out * wmap * chan))


def main() -> int:
    sys.path.insert(0, str(DATA.parent.parent))
    import jax
    jax.config.update("jax_platforms", "cpu")
    arrays = golden_arrays()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: " + ", ".join(
        f"{k}{tuple(v.shape)}" for k, v in arrays.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
