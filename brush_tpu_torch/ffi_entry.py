"""Python side of the port's C API (native/ffi.cpp); port of
`brush_tpu/ffi_entry.py`.

Mirrors the reference's C FFI semantics (apps/brush-c/src/lib.rs:109):
blocking train-and-save driven by a JSON options object, progress messages
delivered to a raw C callback, nonzero callback return = cancel.

The C layer passes the callback as a raw function-pointer address; we
re-materialise it with ctypes so no custom extension module is needed.
Besides the fields of TrainConfig, ProcessConfig and LoadConfig, the
options take `device` (default "cuda"): where `train_process` runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json

_CB_TYPE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p, ctypes.c_void_p)


class _Cancelled(Exception):
    pass


def _split_options(options_json: str):
    """Route JSON fields to TrainConfig / ProcessConfig / LoadConfig by
    field name (the reference flattens all config groups the same way,
    brush-process/src/config.rs:50-68). Returns (tcfg, pcfg, lcfg,
    device)."""
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.process import ProcessConfig
    from brush_tpu_torch.train.config import TrainConfig

    opts = json.loads(options_json) if options_json else {}
    if not isinstance(opts, dict):
        raise ValueError("options_json must be a JSON object")
    device = opts.pop("device", "cuda")

    groups = [TrainConfig, ProcessConfig, LoadConfig]
    fields = {cls: {f.name for f in dataclasses.fields(cls)}
              for cls in groups}
    kwargs: dict = {cls: {} for cls in groups}
    for key, value in opts.items():
        for cls in groups:
            if key in fields[cls]:
                kwargs[cls][key] = value
                break
        else:
            raise ValueError(f"unknown option {key!r}")

    lcfg_kw = kwargs[LoadConfig]
    if "alpha_mode" in lcfg_kw:
        from brush_tpu_torch.data.scene import AlphaMode
        lcfg_kw["alpha_mode"] = AlphaMode(lcfg_kw["alpha_mode"])
    return (TrainConfig(**kwargs[TrainConfig]),
            ProcessConfig(**kwargs[ProcessConfig]),
            LoadConfig(**lcfg_kw), device)


def train_and_save(dataset_path: str, options_json: str,
                   cb_addr: int, user_data_addr: int) -> int:
    """Blocking full training run; returns the number of iterations run."""
    from brush_tpu_torch.process import train_process

    cb = _CB_TYPE(cb_addr) if cb_addr else None
    user_data = ctypes.c_void_p(user_data_addr or None)

    tcfg, pcfg, lcfg, device = _split_options(options_json)
    last_iter = 0
    try:
        for msg in train_process(dataset_path, tcfg=tcfg, lcfg=lcfg,
                                 pcfg=pcfg, device=device):
            last_iter = msg.iter
            if cb is not None:
                payload = json.dumps(
                    {"kind": msg.kind, "iter": msg.iter, **msg.data},
                    default=float).encode()
                if cb(payload, user_data):
                    raise _Cancelled
    except _Cancelled:
        pass
    return last_iter
