"""The PyTorch port must stand alone: importing every module of
`brush_tpu_torch` (and `chip_smoke.py`) loads no JAX, no Flax, no orbax
and nothing of the JAX package `brush_tpu`, and builds or loads no CUDA
kernel and no native library (the COLMAP parser, the C ABI). Every module
also imports where Pillow is missing (it is imported only inside the
functions that decode or write images)."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
if "--no-pil" in sys.argv:
    sys.modules["PIL"] = None       # `import PIL` raises ImportError
import brush_tpu_torch
mods = ["brush_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(brush_tpu_torch.__path__,
                                          "brush_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from brush_tpu_torch.kernels import build
from brush_tpu_torch.native import build as native
bad = sorted(m for m in sys.modules
             if m.startswith(("jax", "flax", "orbax")) or m == "brush_tpu"
             or m.startswith("brush_tpu."))
with open("/proc/self/maps") as f:
    maps = f.read()
native_loaded = (native.BUILT != [] or native._colmapio is not None
                 or native.MODULE in sys.modules
                 or native.FFI_LIB in maps or "_colmapio" in maps)
print(json.dumps({"modules": mods, "bad": bad,
                  "pil": sys.modules.get("PIL") is not None,
                  "kernels_loaded": build._lib is not None,
                  "native_loaded": native_loaded}))
"""

MODULES = (
    "render", "ops.rasterize_cuda", "train.trainer", "ops.loss",
    "ops.expand_cuda", "utils.quat", "train.refine", "train.splat_init",
    "train.eval", "train.lod", "process",
    # the dataset-to-PLY run
    "data.vfs", "data.scene", "data.colmap", "data.formats",
    "data.dataloader", "io.ply", "train.checkpoint", "ops.rasterize_torch",
    "utils.telemetry", "utils.report", "cli",
    # the viewer, LPIPS and the C ABI
    "viewer.slot", "viewer.service", "models.lpips", "ffi_entry",
    "native.build",
    # multi-device training and rendering
    "parallel.data_parallel", "parallel.tile_parallel",
    # the compiled, donated steps
    "graphs")


def _probe(*args) -> dict:
    out = subprocess.run([sys.executable, "-c", _PROBE, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_package():
    res = _probe()
    for name in MODULES:
        assert f"brush_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == [], f"port pulled in {res['bad']}"
    assert res["kernels_loaded"] is False
    assert res["native_loaded"] is False


def test_port_imports_without_pillow():
    res = _probe("--no-pil")
    assert res["pil"] is False
    for name in MODULES:
        assert f"brush_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == [] and res["kernels_loaded"] is False
    assert res["native_loaded"] is False


def test_image_decoding_names_pillow_when_it_is_missing(tmp_path,
                                                        monkeypatch):
    """Without Pillow, decoding an image raises ImportError (nothing falls
    back silently)."""
    from brush_tpu_torch.data.scene import load_image
    from brush_tpu_torch.data.vfs import Vfs
    (tmp_path / "a.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        load_image(Vfs(tmp_path), "a.png", 64)
