"""Build the CUDA kernels of `csrc/` into one shared library and load it.

Route: `nvcc` by hand into a library with a plain C interface, loaded with
`ctypes` (no PyTorch headers, so a build takes seconds, not minutes). Each
`.cu` file compiles in its own `nvcc` process, all started together, and
one more `nvcc` links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o libbrush_tpu_torch_kernels.so *.o

The library goes to `build/brush_tpu_torch/<hash>/` at the repository root
(listed in .gitignore), keyed by a hash of the sources and flags, and is
built at the first kernel launch. Nothing here runs at import time, and a
missing `nvcc` is an error only when a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2]
              / "build" / "brush_tpu_torch")
LIB_NAME = "libbrush_tpu_torch_kernels.so"

# No --use_fast_math: the kernels are held to their plain PyTorch versions,
# and expf/division must round as PyTorch's do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
# A projection's lens: its kind (0 pinhole, 1 KB4) and k1-k4 (doubles: the
# kernels round them, and their products, to float32 as PyTorch does).
_LENS = [_I, _D, _D, _D, _D]
# C entry points: name -> argument types. Every function returns the
# cudaError_t of its launches as an int (0 = success).
SIGNATURES = {
    "brush_scan_tile_items": [],
    "brush_scan_rows_i32": [_P, _P, _P, _L, _I, _L, _P],
    "brush_scan_rows_f32": [_P, _P, _P, _L, _I, _L, _P],
    "brush_scan_rows_max_i32": [_P, _P, _P, _L, _I, _L, _P],
    "brush_stack_rows": [_P, _I, _L, _P, _I, _L, _P],
    "brush_stack_max_rows": [],
    "brush_emit_slots": [_P, _L, _I, _I, _I, _I, _I, _I, _L, _P, _P, _P],
    "brush_rasterize_fwd_diet": [_P, _L, _P, _P, _P, _P, _I, _P],
    "brush_rasterize_fwd_train": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _P],
    "brush_rasterize_bwd": [_P, _L, _P, _P, _P, _I, _P, _P, _P, _P, _P, _L,
                            _I, _I, _I, _I, _P],
    "brush_expand_segments": [_P, _L, _I, _P, _P, _I, _L, _P, _P],
    "brush_fill_tile_items": [],
    "brush_fill_rows": [_P, _P, _I, _L, _P, _P, _L, _P],
    "brush_tile_counts": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P],
    "brush_project_fwd": [_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _L, _I,
                          _I, _I, _I] + _LENS + [_F] + [_P] * 14,
    "brush_project_bwd": [_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P,
                          _P, _L, _P, _L, _P, _L, _P, _L, _L, _I, _I]
    + _LENS + [_P] * 6,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None   # wall time of the build, if one ran
BUILD_LOG: str = ""                   # nvcc's output (ptxas -v register use)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "brush_tpu_torch are built from csrc/ at their first launch")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, out_dir: pathlib.Path) -> str:
    nvcc = _nvcc()
    tmp = out_dir.parent / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / (s.stem + ".o")) for s in sources]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    text = "\n".join(log)
    (tmp / "build.log").write_text(text)
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/ if not built yet."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
        so = out_dir / LIB_NAME
        if not so.exists():
            t0 = time.perf_counter()
            BUILD_LOG = _compile(sources, out_dir)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on the CUDA device `device` (a
    tensor's device, so its index is set). Building the stream object
    instead (`torch.cuda.current_stream`) costs the host several
    microseconds a launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
