"""Build the port's native components: `python -m brush_tpu_torch.native.build`.

- colmapio.cpp -> _colmapio.<abi>.so (CPython extension, COLMAP parser)
- ffi.cpp      -> libbrush_tpu_torch_ffi.so (C ABI: embed-Python
                  train_and_save, header at include/brush_tpu_torch_ffi.h)

Plain g++ + the CPython C API, no pybind11 and no PyTorch headers. The
artifacts go to `build/brush_tpu_torch_native/<hash>/` at the repository
root (listed in .gitignore), keyed by a hash of the sources, the flags and
the Python ABI, never into the source tree. Nothing is built unless asked:
importing the package builds and loads nothing, and `data/colmap.py` uses
the parser only once it is built (`load_colmapio`), reading with the
Python readers until then."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "brush_tpu_torch_native"
FFI_LIB = "libbrush_tpu_torch_ffi.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
MODULE = "brush_tpu_torch.native._colmapio"

# Paths of the artifacts this process compiled (none until a build is
# asked for).
BUILT: list[str] = []
_lock = threading.Lock()
_colmapio = None


def _out_dir() -> Path:
    """The build directory of these sources for this interpreter."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((sysconfig.get_config_var("EXT_SUFFIX") or "").encode())
    h.update(sysconfig.get_paths()["include"].encode())
    for f in sorted(HERE.rglob("*")):
        if f.suffix in (".cpp", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(src: Path, out: Path, extra: list[str], verbose: bool) -> Path:
    with _lock:
        if out.exists():
            return out
        include = sysconfig.get_paths()["include"]
        if not (Path(include) / "Python.h").is_file():
            raise RuntimeError(
                f"Python.h not found in {include} (sysconfig's include "
                "path): install the Python development headers")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, f"-I{include}", str(src), "-o", str(tmp),
               *extra]
        if verbose:
            print(" ".join(cmd))
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)   # another process's equal build may win
        BUILT.append(str(out))
        return out


def colmapio_path() -> Path:
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _out_dir() / f"_colmapio{ext}"


def ffi_path() -> Path:
    return _out_dir() / FFI_LIB


def build(verbose: bool = True) -> Path:
    """Build the COLMAP parser extension; returns its path."""
    return _compile(HERE / "colmapio.cpp", colmapio_path(), [], verbose)


def build_ffi(verbose: bool = True) -> Path:
    """Build the C-ABI library; returns its path.

    Linked against libpython so a plain C host can embed the interpreter;
    when loaded into an existing Python process (ctypes) the symbols are
    already present and only the GIL is taken."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    version = sysconfig.get_config_var("LDVERSION") or ""
    extra = [f"-L{libdir}", f"-lpython{version}", f"-Wl,-rpath,{libdir}"]
    return _compile(HERE / "ffi.cpp", ffi_path(), extra, verbose)


def load_colmapio():
    """The built COLMAP parser module, or None where it is not built (this
    builds nothing)."""
    global _colmapio
    if _colmapio is None:
        path = colmapio_path()
        if not path.is_file():
            return None
        spec = importlib.util.spec_from_file_location(MODULE, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[MODULE] = mod
        _colmapio = mod
    return _colmapio


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    print(f"built {build_ffi()}")
    print("import OK:", load_colmapio().__doc__)
