"""Virtual file system over a directory, a zip archive, or a URL (port of
`brush_tpu/data/vfs.py`, a copy).

Counterpart of brush-vfs (crates/brush-vfs/src/lib.rs + data_source.rs
DataSource::{Path,Url}): one uniform, case-insensitive read layer the
dataset loaders share, so a zipped COLMAP export, an unpacked folder, and
an `http(s)://...` download behave identically. (The reference's wasm
file-picker arm doesn't apply on a TPU host.)"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path, PurePosixPath
from typing import Iterator


def _fetch_url(url: str) -> tuple[str, bytes]:
    """Download a source URL fully into memory (data_source.rs Url arm —
    the reference also buffers: zips need random access)."""
    import urllib.request
    with urllib.request.urlopen(url) as r:
        data = r.read()
    name = PurePosixPath(url.split("?")[0]).name or "download"
    return name, data


class Vfs:
    def __init__(self, root: str | Path):
        self._zip: zipfile.ZipFile | None = None
        self._mem: dict[str, bytes] | None = None
        if isinstance(root, str) and root.startswith(("http://", "https://")):
            name, data = _fetch_url(root)
            if name.lower().endswith(".zip") or data[:4] == b"PK\x03\x04":
                self._zip = zipfile.ZipFile(io.BytesIO(data))
                self._names = [n for n in self._zip.namelist()
                               if not n.endswith("/")]
            else:
                self._mem = {name: data}
                self._names = [name]
            self._lower = {n.lower(): n for n in self._names}
            return
        root = Path(root)
        if root.is_file() and root.suffix.lower() == ".zip":
            self._zip = zipfile.ZipFile(root)
            self._names = [n for n in self._zip.namelist() if not n.endswith("/")]
        elif root.is_file():
            self._dir = root.parent
            self._names = [root.name]
        else:
            self._dir = root
            self._names = [
                str(p.relative_to(root)).replace("\\", "/")
                for p in sorted(root.rglob("*")) if p.is_file()
            ]
        self._lower = {n.lower(): n for n in self._names}

    @property
    def file_names(self) -> list[str]:
        return list(self._names)

    def resolve(self, path: str) -> str | None:
        """Case-insensitive exact-path lookup (vfs lib.rs case-insensitive)."""
        p = str(PurePosixPath(path)).lower().lstrip("./")
        if p in self._lower:
            return self._lower[p]
        # Also allow matching by suffix when the archive has a root folder.
        for lower, orig in self._lower.items():
            if lower.endswith("/" + p):
                return orig
        return None

    def exists(self, path: str) -> bool:
        return self.resolve(path) is not None

    def open(self, path: str) -> io.BufferedIOBase:
        real = self.resolve(path)
        if real is None:
            raise FileNotFoundError(path)
        if self._zip is not None:
            return io.BytesIO(self._zip.read(real))
        if self._mem is not None:
            return io.BytesIO(self._mem[real])
        return open(self._dir / real, "rb")

    def read_bytes(self, path: str) -> bytes:
        with self.open(path) as f:
            return f.read()

    def names(self) -> list[str]:
        """All file paths in the source."""
        return list(self._names)

    def files_with_extension(self, ext: str) -> Iterator[str]:
        ext = ext.lower().lstrip(".")
        for n in self._names:
            if n.lower().endswith("." + ext):
                yield n

    def files_ending_in(self, suffix: str) -> Iterator[str]:
        s = suffix.lower()
        for n in self._names:
            if n.lower().endswith(s):
                yield n
