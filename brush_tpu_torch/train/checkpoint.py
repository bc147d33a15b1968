"""Checkpoint / resume (port of `brush_tpu/train/checkpoint.py`).

The whole train state is saved: parameters, Adam moments, the refine
record, the step, the bounds and the generator's state, so a resumed run
draws the same noise as an uninterrupted one (the reference keeps only a
ply and `--start-iter`, SURVEY.md §5.4). `torch.save` of plain tensors
replaces orbax; the directory holds `state.pt` and, with an iteration,
`meta.json` with the keys of the JAX package (`iteration`, `capacity`,
`sh_degree`). PLY export remains for interop.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from brush_tpu_torch.train.trainer import TrainState

STATE_FILE = "state.pt"


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _state_dict(state: TrainState) -> dict:
    """Plain tensors, dicts and None (what `weights_only` loading takes)."""
    out = {k: v for k, v in _fields(state).items()
           if k not in ("splats", "opt", "refine", "rng")}
    out["splats"] = _fields(state.splats)
    out["opt"] = {name: _fields(st) for name, st in state.opt.items()}
    out["refine"] = _fields(state.refine)
    out["rng"] = state.rng.get_state()
    return out


def save_checkpoint(path: str | Path, state: TrainState,
                    iteration: int | None = None) -> None:
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(_state_dict(state), tmp)
    tmp.replace(path / STATE_FILE)
    if iteration is not None:
        meta = dict(iteration=int(iteration),
                    capacity=int(state.splats.capacity),
                    sh_degree=int(state.splats.sh_degree))
        (path / "meta.json").write_text(json.dumps(meta))


def checkpoint_meta(path: str | Path) -> dict:
    return json.loads((Path(path).absolute() / "meta.json").read_text())


def _restore(template, saved: dict, where: str, skip=()):
    """`template` (a dataclass of tensors) with the saved tensors, which
    must have its shapes and dtypes where it has a tensor."""
    values = {}
    for name, have in _fields(template).items():
        if name in skip:
            continue
        got = saved[name]
        if torch.is_tensor(have) and torch.is_tensor(got) and (
                got.shape != have.shape or got.dtype != have.dtype):
            raise ValueError(
                f"checkpoint {where}.{name} is {tuple(got.shape)} "
                f"{got.dtype}, the template {tuple(have.shape)} {have.dtype}")
        values[name] = got
    return dataclasses.replace(template, **values)


def load_checkpoint(path: str | Path, template: TrainState) -> TrainState:
    """Restore into the structure of `template` (same capacity and SH
    degree: read `checkpoint_meta` first to build it) on the template's
    device, the generator included."""
    dev = template.splats.means.device
    saved = torch.load(Path(path).absolute() / STATE_FILE, map_location=dev,
                       weights_only=True)
    rng = torch.Generator(device=template.rng.device)
    rng.set_state(saved["rng"].cpu())
    state = _restore(template, saved, "state",
                     skip=("splats", "opt", "refine", "rng"))
    return dataclasses.replace(
        state,
        splats=_restore(template.splats, saved["splats"], "splats"),
        opt={name: _restore(st, saved["opt"][name], f"opt.{name}")
             for name, st in template.opt.items()},
        refine=_restore(template.refine, saved["refine"], "refine"),
        rng=rng)
