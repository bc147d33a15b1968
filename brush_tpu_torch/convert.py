"""Carry the JAX package's parameters, training state and configurations
across into the port.

The JAX package is never imported: each function takes its arrays as
anything `numpy.asarray` reads (numpy arrays, or JAX arrays, which convert
on the host), from a mapping or an object with the fields as attributes —
a `brush_tpu` Splats or CameraInputs can be passed as it is.
"""

from __future__ import annotations

from collections.abc import Mapping

import dataclasses

import numpy as np
import torch

from brush_tpu_torch.models.splats import Splats
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.render import RenderConfig
from brush_tpu_torch.train.adam_scaled import AdamParamState
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.train.trainer import RefineRecord, TrainState
from brush_tpu_torch.utils.device import resolve_device

SPLAT_FIELDS = ("means", "log_scales", "quats", "sh_coeffs", "raw_opacities")
CAMERA_FIELDS = ("viewmat", "pinhole", "clamp_limits", "cam_pos")


def _get(src, name):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def _tensor(x, dtype, dev):
    return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)


def splats_from_arrays(src, device="cuda") -> Splats:
    """Splats from the JAX package's `means`, `log_scales`, `quats`,
    `sh_coeffs`, `raw_opacities`, `n_alive` and `min_scale` (the last two
    optional)."""
    dev = resolve_device(device)
    fields = {k: _tensor(_get(src, k), np.float32, dev) for k in SPLAT_FIELDS}
    n_alive = _get(src, "n_alive")
    min_scale = _get(src, "min_scale")
    return Splats(
        **fields,
        n_alive=_tensor(fields["means"].shape[0] if n_alive is None
                        else n_alive, np.int32, dev),
        min_scale=None if min_scale is None else _tensor(min_scale,
                                                         np.float32, dev))


def camera_inputs_from_arrays(src, device="cuda") -> CameraInputs:
    """CameraInputs from the JAX package's `viewmat`, `pinhole`,
    `clamp_limits`, `cam_pos` and `half_max_render_fov`."""
    dev = resolve_device(device)
    fov = _get(src, "half_max_render_fov")
    return CameraInputs(
        *(_tensor(_get(src, k), np.float32, dev) for k in CAMERA_FIELDS),
        half_max_render_fov=0.0 if fov is None else float(np.asarray(fov)))


def _copy_config(cls, src, overrides):
    """Field-for-field copy of a configuration dataclass of the JAX package
    into the port's class of the same fields. A camera model converts by
    its class name and fields."""
    from brush_tpu_torch import camera
    values = {}
    for f in dataclasses.fields(cls):
        v = _get(src, f.name)
        if f.name == "model":
            v = getattr(camera, type(v).__name__)(**dataclasses.asdict(v))
        values[f.name] = v
    values.update(overrides)
    return cls(**values)


def render_config_from(src, **overrides) -> RenderConfig:
    """RenderConfig from the JAX package's RenderConfig, field for field."""
    return _copy_config(RenderConfig, src, overrides)


def train_config_from(src, **overrides) -> TrainConfig:
    """TrainConfig from the JAX package's TrainConfig, field for field."""
    return _copy_config(TrainConfig, src, overrides)


def train_state_from_arrays(src, seed: int = 0, device="cuda") -> TrainState:
    """TrainState from the JAX package's: the splats, the five
    AdamParamStates (the reduced `[N, 1, 1]` second moment of `sh_coeffs`
    keeps its shape), the RefineRecord, `step`, `median_scale` and the
    bounds. The JAX PRNG key is not carried: the port's state holds a
    `torch.Generator` on `device`, seeded with `seed`."""
    dev = resolve_device(device)

    def f32(x):
        return _tensor(x, np.float32, dev)

    opt = {}
    for name, st in _get(src, "opt").items():
        opt[name] = AdamParamState(
            moment1=f32(_get(st, "moment1")), moment2=f32(_get(st, "moment2")),
            time=_tensor(_get(st, "time"), np.int32, dev))
    rec = _get(src, "refine")
    rng = torch.Generator(device=dev)
    rng.manual_seed(int(seed))
    center, extent = _get(src, "bounds_center"), _get(src, "bounds_extent")
    return TrainState(
        splats=splats_from_arrays(_get(src, "splats"), device=dev),
        opt=opt,
        refine=RefineRecord(
            refine_weight=f32(_get(rec, "refine_weight")),
            visible_count=f32(_get(rec, "visible_count")),
            max_radius=f32(_get(rec, "max_radius"))),
        step=_tensor(_get(src, "step"), np.int32, dev),
        rng=rng,
        median_scale=f32(_get(src, "median_scale")),
        bounds_center=None if center is None else f32(center),
        bounds_extent=None if extent is None else f32(extent))
