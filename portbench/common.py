"""What every run of the benchmark shares: where its caches go, the look for
the cards, the check that nothing of JAX or the JAX package was loaded,
the process clock, and the cell and configuration files."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names a run may not load, compared whole (the port's
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "brush_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def cache_env() -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port builds its kernels into build/ at the checkout's root by itself),
    and no JAX through a library that would load it."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} found")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    """The cell `name` and its configuration, from their files."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, config


def seed_stream(seed: int, salt: int) -> int:
    """A second seed derived from the run's seed."""
    return (int(seed) * 1_000_003 + salt) % (1 << 62)
