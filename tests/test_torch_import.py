"""The PyTorch port must stand alone: importing every module of
`brush_tpu_torch` (and `chip_smoke.py`) loads no JAX, no Flax and nothing of
the JAX package `brush_tpu`, and builds or loads no CUDA kernel."""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import brush_tpu_torch
mods = ["brush_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(brush_tpu_torch.__path__,
                                          "brush_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from brush_tpu_torch.kernels import build
bad = sorted(m for m in sys.modules
             if m.startswith(("jax", "flax")) or m == "brush_tpu"
             or m.startswith("brush_tpu."))
print(json.dumps({"modules": mods, "bad": bad,
                  "kernels_loaded": build._lib is not None}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "brush_tpu_torch.render" in res["modules"]
    assert "brush_tpu_torch.ops.rasterize_cuda" in res["modules"]
    assert "brush_tpu_torch.train.trainer" in res["modules"]
    assert "brush_tpu_torch.ops.loss" in res["modules"]
    for name in ("ops.expand_cuda", "utils.quat", "train.refine",
                 "train.splat_init", "train.eval", "train.lod", "process"):
        assert f"brush_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == [], f"port pulled in {res['bad']}"
    assert res["kernels_loaded"] is False
