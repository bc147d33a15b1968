"""PLY splat import/export (Inria 3DGS format + SuperSplat compressed;
port of `brush_tpu/io/ply.py`, numpy code as there, writing the same bytes).

Counterpart of brush-serde (crates/brush-serde/src/{import,export}.rs):

* standard 3DGS ply: x/y/z, f_dc_0..2, f_rest_* (channel-major on disk,
  [n, coeffs, channels] in memory — import.rs:132 interleave), opacity,
  scale_0..2, rot_0..3 (wxyz); rgb-only fallback for plain point clouds;
* SuperSplat `.compressed.ply`: per-chunk min/max quantization with 11-10-11
  packed position/scale and packed quat/color (import.rs:407+,
  ply_gaussian.rs:24-60);
* header comments carry the vertical axis and SplatRenderMode
  (import.rs:193-237; export.rs writes `comment vertical axis: z`).

Written from the public format specs; no external ply library needed.
"""

from __future__ import annotations

import dataclasses
import io as _io
import re
from typing import BinaryIO

import numpy as np

from brush_tpu_torch.constants import SH_C0

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class SplatData:
    """Raw parsed splat fields; None where the ply lacks them
    (brush-serde SplatData)."""

    means: np.ndarray                  # [N,3]
    log_scales: np.ndarray | None = None
    rotations: np.ndarray | None = None   # wxyz
    sh_coeffs: np.ndarray | None = None   # [N,K,3]
    raw_opacities: np.ndarray | None = None
    up_axis: str | None = None
    render_mode: str | None = None

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]


def _parse_header(f: BinaryIO):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a ply file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype)])
    comments = []
    cur = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated ply header")
        parts = line.decode("ascii", errors="replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment":
            comments.append(" ".join(parts[1:]))
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("list properties unsupported for splat plys")
            cur[2].append((parts[2], _DTYPES[parts[1]]))
        elif parts[0] == "end_header":
            break
    return fmt, elements, comments


def _read_element(f: BinaryIO, fmt: str, count: int, props):
    if fmt == "binary_little_endian":
        dt = np.dtype([(n, "<" + t) for n, t in props])
        return np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
    if fmt == "binary_big_endian":
        dt = np.dtype([(n, ">" + t) for n, t in props])
        return np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
    if fmt == "ascii":
        dt = np.dtype([(n, "<" + t) for n, t in props])
        rows = []
        for _ in range(count):
            vals = f.readline().split()
            rows.append(tuple(np.dtype(t).type(v) for v, (n, t) in zip(vals, props)))
        return np.array(rows, dtype=dt)
    raise ValueError(f"unknown ply format {fmt}")


def _header_meta(comments):
    up_axis = render_mode = None
    for c in comments:
        m = re.match(r"vertical axis:\s*(\w+)", c, re.I)
        if m:
            up_axis = m.group(1).lower()
        m = re.match(r"splat render mode:\s*(\w+)", c, re.I)
        if m:
            render_mode = m.group(1)
    return up_axis, render_mode


def load_splat_ply(f: BinaryIO | str) -> SplatData:
    """Parse a 3DGS / SuperSplat-compressed / plain-point ply
    (import.rs load_splat_from_ply:170)."""
    if isinstance(f, str):
        with open(f, "rb") as fh:
            return load_splat_ply(fh)

    fmt, elements, comments = _parse_header(f)
    up_axis, render_mode = _header_meta(comments)
    names = [e[0] for e in elements]

    if "chunk" in names and "vertex" in names:
        data = {name: _read_element(f, fmt, count, props)
                for name, count, props in elements}
        out = _decode_supersplat(data["chunk"], data["vertex"],
                                 data.get("sh"))
    else:
        vertex = None
        for name, count, props in elements:
            arr = _read_element(f, fmt, count, props)
            if name == "vertex":
                vertex = arr
        if vertex is None:
            raise ValueError("ply has no vertex element")
        out = _decode_standard(vertex)

    out.up_axis = up_axis
    out.render_mode = render_mode
    return out


def stream_splat_ply(f: BinaryIO | str, chunk_rows: int = 65536):
    """Progressive import: yield SplatData prefixes as vertex rows arrive
    (import.rs stream_splat_from_ply:183, which emits a SplatMessage every
    1.5 s while parsing). Standard binary little/big-endian plys stream
    row-chunked; ascii and SuperSplat-compressed fall back to one emission.

    Each yield is a *complete decode of everything read so far* — cheap,
    since decode is vectorized numpy over the accumulated buffer.
    """
    if isinstance(f, str):
        with open(f, "rb") as fh:
            yield from stream_splat_ply(fh, chunk_rows)
            return

    fmt, elements, comments = _parse_header(f)
    up_axis, render_mode = _header_meta(comments)
    names = [e[0] for e in elements]

    streamable = (fmt in ("binary_little_endian", "binary_big_endian")
                  and "chunk" not in names)
    if not streamable:
        # One-shot path (ascii / compressed): re-dispatch on the parsed
        # header by decoding elements directly.
        if "chunk" in names and "vertex" in names:
            data = {name: _read_element(f, fmt, count, props)
                    for name, count, props in elements}
            out = _decode_supersplat(data["chunk"], data["vertex"],
                                     data.get("sh"))
        else:
            vertex = next(_read_element(f, fmt, count, props)
                          for name, count, props in elements
                          if name == "vertex")
            out = _decode_standard(vertex)
        out.up_axis, out.render_mode = up_axis, render_mode
        yield out
        return

    endian = "<" if fmt == "binary_little_endian" else ">"
    for name, count, props in elements:
        dt = np.dtype([(n, endian + t) for n, t in props])
        if name != "vertex":
            f.read(dt.itemsize * count)  # skip non-vertex elements
            continue
        read = 0
        buf = []
        while read < count:
            take = min(chunk_rows, count - read)
            raw = f.read(dt.itemsize * take)
            got = len(raw) // dt.itemsize
            if got == 0:
                break
            buf.append(np.frombuffer(raw, dtype=dt, count=got))
            read += got
            out = _decode_standard(np.concatenate(buf) if len(buf) > 1
                                   else buf[0])
            out.up_axis, out.render_mode = up_axis, render_mode
            yield out
        return


def _decode_standard(v: np.ndarray) -> SplatData:
    fields = set(v.dtype.names)
    n = v.shape[0]
    means = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)

    log_scales = rotations = raw_opac = sh = None
    if {"scale_0", "scale_1", "scale_2"} <= fields:
        log_scales = np.stack([v["scale_0"], v["scale_1"], v["scale_2"]],
                              -1).astype(np.float32)
    if {"rot_0", "rot_1", "rot_2", "rot_3"} <= fields:
        rotations = np.stack([v[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)
    if "opacity" in fields:
        raw_opac = v["opacity"].astype(np.float32)

    if {"f_dc_0", "f_dc_1", "f_dc_2"} <= fields:
        dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)
        rest_names = sorted(
            (f for f in fields if f.startswith("f_rest_")),
            key=lambda s: int(s.split("_")[-1]))
        if rest_names:
            n_rest = len(rest_names) // 3
            rest = np.stack([v[f] for f in rest_names], -1).astype(np.float32)
            # Disk layout is channel-major [3, n_rest]; we use [n_rest, 3]
            # (import.rs:132 interleave).
            rest = rest.reshape(n, 3, n_rest).transpose(0, 2, 1)
            sh = np.concatenate([dc[:, None, :], rest], axis=1)
        else:
            sh = dc[:, None, :]
    elif {"red", "green", "blue"} <= fields:
        rgb = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
        sh = ((rgb - 0.5) / SH_C0)[:, None, :]

    return SplatData(means=means, log_scales=log_scales, rotations=rotations,
                     sh_coeffs=sh, raw_opacities=raw_opac)


def _unpack_111011(packed: np.ndarray):
    """u32 -> three [0,1] floats with 11/10/11 bits (SuperSplat packing)."""
    x = ((packed >> 21) & 0x7FF).astype(np.float32) / 2047.0
    y = ((packed >> 11) & 0x3FF).astype(np.float32) / 1023.0
    z = (packed & 0x7FF).astype(np.float32) / 2047.0
    return x, y, z


def _unpack_8888(packed: np.ndarray):
    return [((packed >> s) & 0xFF).astype(np.float32) / 255.0
            for s in (24, 16, 8, 0)]


def _decode_supersplat(chunks: np.ndarray, verts: np.ndarray,
                       sh_elem: np.ndarray | None) -> SplatData:
    """SuperSplat compressed ply: 256 splats per chunk, per-chunk min/max
    (import.rs:407+, format per playcanvas/supersplat)."""
    n = verts.shape[0]
    chunk_idx = np.arange(n) // 256

    def lerp(lo_name, hi_name, t):
        lo = chunks[lo_name][chunk_idx].astype(np.float32)
        hi = chunks[hi_name][chunk_idx].astype(np.float32)
        return lo + (hi - lo) * t

    px, py, pz = _unpack_111011(verts["packed_position"].astype(np.uint32))
    means = np.stack([lerp("min_x", "max_x", px),
                      lerp("min_y", "max_y", py),
                      lerp("min_z", "max_z", pz)], -1).astype(np.float32)

    sx, sy, sz = _unpack_111011(verts["packed_scale"].astype(np.uint32))
    log_scales = np.stack([lerp("min_scale_x", "max_scale_x", sx),
                           lerp("min_scale_y", "max_scale_y", sy),
                           lerp("min_scale_z", "max_scale_z", sz)],
                          -1).astype(np.float32)

    # Quat: largest component omitted; 2 bits say which, 3x10 bits the
    # rest, each stored as (comp/sqrt2 + 0.5) in 10 bits.
    pr = verts["packed_rotation"].astype(np.uint32)
    which = (pr >> 30) & 0x3
    sqrt2 = np.float32(np.sqrt(2.0))
    a = (((pr >> 20) & 0x3FF).astype(np.float32) / 1023.0 - 0.5) * sqrt2
    b = (((pr >> 10) & 0x3FF).astype(np.float32) / 1023.0 - 0.5) * sqrt2
    c = ((pr & 0x3FF).astype(np.float32) / 1023.0 - 0.5) * sqrt2
    m = np.sqrt(np.clip(1.0 - (a * a + b * b + c * c), 0.0, 1.0))
    quats = np.empty((n, 4), np.float32)
    for w in range(4):
        sel = which == w
        order = [(w + 1 + i) % 4 for i in range(3)]
        quats[sel, w] = m[sel]
        quats[sel, order[0]] = a[sel]
        quats[sel, order[1]] = b[sel]
        quats[sel, order[2]] = c[sel]

    cr, cg, cb, ca = _unpack_8888(verts["packed_color"].astype(np.uint32))
    if "min_r" in (chunks.dtype.names or ()):
        rgb = np.stack([lerp("min_r", "max_r", cr),
                        lerp("min_g", "max_g", cg),
                        lerp("min_b", "max_b", cb)], -1)
    else:
        rgb = np.stack([cr, cg, cb], -1)
    dc = (rgb - 0.5) / SH_C0
    sh = dc[:, None, :].astype(np.float32)
    if sh_elem is not None and sh_elem.dtype.names:
        rest_names = sorted(sh_elem.dtype.names,
                            key=lambda s: int(s.split("_")[-1]))
        rest = np.stack([sh_elem[f].astype(np.float32) / 255.0 * 8.0 - 4.0
                         for f in rest_names], -1)
        n_rest = rest.shape[-1] // 3
        rest = rest.reshape(n, 3, n_rest).transpose(0, 2, 1)
        sh = np.concatenate([sh, rest], axis=1).astype(np.float32)

    eps = 1e-6
    ca = np.clip(ca, eps, 1.0 - eps)
    raw_opac = np.log(ca / (1.0 - ca)).astype(np.float32)
    return SplatData(means=means, log_scales=log_scales, rotations=quats,
                     sh_coeffs=sh, raw_opacities=raw_opac)


def save_splat_ply(f: BinaryIO | str, means, log_scales, quats, sh_coeffs,
                   raw_opacities, up_axis: str = "z") -> None:
    """Write the Inria 3DGS ply layout (export.rs splat_to_ply:180):
    x,y,z, f_dc_0..2, f_rest_0..N (channel-major), opacity, scale_0..2,
    rot_0..3, plus the `vertical axis` header comment."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            save_splat_ply(fh, means, log_scales, quats, sh_coeffs,
                           raw_opacities, up_axis)
            return

    means = np.asarray(means, np.float32)
    log_scales = np.asarray(log_scales, np.float32)
    quats = np.asarray(quats, np.float32)
    sh = np.asarray(sh_coeffs, np.float32)
    opac = np.asarray(raw_opacities, np.float32)
    n, k = sh.shape[0], sh.shape[1]
    n_rest = k - 1

    props = ["x", "y", "z"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(n_rest * 3)]
    props += ["opacity"] + [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]

    header = ["ply", "format binary_little_endian 1.0",
              f"comment vertical axis: {up_axis}",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in props]
    header += ["end_header"]
    f.write(("\n".join(header) + "\n").encode("ascii"))

    cols = [means]
    cols.append(sh[:, 0, :])                       # dc
    if n_rest:
        # [n, n_rest, 3] -> channel-major [n, 3, n_rest] flat. Explicit
        # width: reshape(n, -1) can't infer from a zero-splat export.
        cols.append(
            sh[:, 1:, :].transpose(0, 2, 1).reshape(n, 3 * n_rest))
    cols.append(opac[:, None])
    cols.append(log_scales)
    cols.append(quats)
    f.write(np.concatenate(cols, axis=1).astype("<f4").tobytes())


def splats_to_ply_bytes(splats, up_axis: str = "z") -> bytes:
    """Export the live rows of a `Splats` (tensors on any device)."""
    n = int(splats.n_alive)

    def rows(x):
        return x[:n].detach().cpu().numpy()

    buf = _io.BytesIO()
    save_splat_ply(buf, rows(splats.means), rows(splats.log_scales),
                   rows(splats.quats), rows(splats.sh_coeffs),
                   rows(splats.raw_opacities), up_axis=up_axis)
    return buf.getvalue()


def _pack_111011(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Three [0,1] floats -> u32 with 11/10/11 bits."""
    xi = np.clip(np.rint(x * 2047.0), 0, 2047).astype(np.uint32)
    yi = np.clip(np.rint(y * 1023.0), 0, 1023).astype(np.uint32)
    zi = np.clip(np.rint(z * 2047.0), 0, 2047).astype(np.uint32)
    return (xi << 21) | (yi << 11) | zi


def save_compressed_ply(f: BinaryIO | str, means, log_scales, quats,
                        sh_coeffs, raw_opacities) -> None:
    """Write a SuperSplat-style `.compressed.ply`: 256-splat chunks with
    per-chunk min/max quantization, 11-10-11 packed position/scale, packed
    smallest-three quaternion and RGBA color, plus a u8 `sh` element for
    higher bands. Round-trips through `load_splat_ply`'s compressed decoder
    (the reference only *imports* this format, import.rs:407+; export is an
    extension for SuperSplat-ecosystem interop)."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            save_compressed_ply(fh, means, log_scales, quats, sh_coeffs,
                                raw_opacities)
            return

    means = np.asarray(means, np.float32)
    log_scales = np.asarray(log_scales, np.float32)
    quats = np.asarray(quats, np.float32)
    sh = np.asarray(sh_coeffs, np.float32)
    opac = np.asarray(raw_opacities, np.float32)
    n = means.shape[0]
    n_chunks = -(-n // 256)
    pad = n_chunks * 256 - n

    def padded(x):
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0) \
            if pad else x

    means_p, ls_p, quats_p = padded(means), padded(log_scales), padded(quats)
    sh_p, opac_p = padded(sh), padded(opac)

    cm = means_p.reshape(n_chunks, 256, 3)
    cs = ls_p.reshape(n_chunks, 256, 3)
    mn_p, mx_p = cm.min(1), cm.max(1)
    mn_s, mx_s = cs.min(1), cs.max(1)

    def norm(x, lo, hi):
        rng = np.maximum(hi - lo, 1e-12)
        return (x - lo[:, None]) / rng[:, None]

    tp = norm(cm, mn_p, mx_p)
    ts = norm(cs, mn_s, mx_s)
    packed_pos = _pack_111011(tp[..., 0].ravel(), tp[..., 1].ravel(),
                              tp[..., 2].ravel())
    packed_scale = _pack_111011(ts[..., 0].ravel(), ts[..., 1].ravel(),
                                ts[..., 2].ravel())

    # Smallest-three quaternion packing (which = index of largest |comp|).
    q = quats_p / np.maximum(np.linalg.norm(quats_p, axis=1, keepdims=True),
                             1e-12)
    which = np.argmax(np.abs(q), axis=1)
    sign = np.sign(q[np.arange(len(q)), which])
    q = q * sign[:, None]  # largest component positive
    norm_c = np.sqrt(2.0) * 0.5
    rest = np.empty((len(q), 3), np.float32)
    for w in range(4):
        sel = which == w
        order = [(w + 1 + i) % 4 for i in range(3)]
        rest[sel] = q[sel][:, order]
    # components in [-1/sqrt2, 1/sqrt2] -> [0,1] 10-bit
    t = np.clip(rest / (2.0 * norm_c) + 0.5, 0.0, 1.0)
    ti = np.clip(np.rint(t * 1023.0), 0, 1023).astype(np.uint32)
    packed_rot = (which.astype(np.uint32) << 30) | (ti[:, 0] << 20) | \
        (ti[:, 1] << 10) | ti[:, 2]

    rgb = np.clip(sh_p[:, 0, :] * SH_C0 + 0.5, 0.0, 1.0)
    a = 1.0 / (1.0 + np.exp(-opac_p))
    col = np.stack([rgb[:, 0], rgb[:, 1], rgb[:, 2], a], axis=1)
    ci = np.clip(np.rint(col * 255.0), 0, 255).astype(np.uint32)
    packed_col = (ci[:, 0] << 24) | (ci[:, 1] << 16) | (ci[:, 2] << 8) | ci[:, 3]

    n_rest = sh.shape[1] - 1
    header = ["ply", "format binary_little_endian 1.0",
              f"element chunk {n_chunks}"]
    for ax in "xyz":
        header.append(f"property float min_{ax}")
        header.append(f"property float max_{ax}")
    for ax in "xyz":
        header.append(f"property float min_scale_{ax}")
        header.append(f"property float max_scale_{ax}")
    header += [f"element vertex {n_chunks * 256}",
               "property uint packed_position",
               "property uint packed_rotation",
               "property uint packed_scale",
               "property uint packed_color"]
    if n_rest:
        header.append(f"element sh {n_chunks * 256}")
        header += [f"property uchar coeff_{i}" for i in range(n_rest * 3)]
    header.append("end_header")
    f.write(("\n".join(header) + "\n").encode("ascii"))

    chunk_rows = np.concatenate(
        [mn_p[:, 0:1], mx_p[:, 0:1], mn_p[:, 1:2], mx_p[:, 1:2],
         mn_p[:, 2:3], mx_p[:, 2:3],
         mn_s[:, 0:1], mx_s[:, 0:1], mn_s[:, 1:2], mx_s[:, 1:2],
         mn_s[:, 2:3], mx_s[:, 2:3]], axis=1).astype("<f4")
    f.write(chunk_rows.tobytes())

    verts = np.stack([packed_pos, packed_rot, packed_scale, packed_col],
                     axis=1).astype("<u4")
    f.write(verts.tobytes())

    if n_rest:
        rest_cm = sh_p[:, 1:, :].transpose(0, 2, 1).reshape(len(sh_p), -1)
        q8 = np.clip(np.rint((rest_cm + 4.0) / 8.0 * 255.0), 0, 255
                     ).astype(np.uint8)
        f.write(q8.tobytes())
