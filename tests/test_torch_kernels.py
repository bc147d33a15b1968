"""The port's kernel modules, plain versions on the CPU, against the JAX
package's kernels (Pallas in interpret mode, or the package's own jnp
path), on the same numpy inputs. The CUDA kernels themselves are held to
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py. Each row of `kernels.KERNELS` is held to the sources.

  * scan    `cumsum_rows`   vs `cumsum_rows(..., interpret=True)`: exact
            for int32; the f32 sum within 1e-6 of the running sum of |x|
            (both add in their own order); `cummax_1d` exact.
  * stack   `stack_rows`    vs the JAX `stack_rows`: exact bits on the
            valid lanes; the port zeroes the rest.
  * expand  `expand_segments` vs `expand_segments(..., interpret=True)` on
            every case of tests/test_expand_pallas.py: exact bits.
  * fill    `fill_rows`     vs `fill_rows(..., interpret=True)` on the cases
            of tests/test_scan_pallas.py: exact bits, int32 patterns carried
            through f32; and the fill of a table scattered to its starts
            equals the expansion of that table.
  * emit    `emit_slots`    vs `_emit_jnp` and `emit_slots(interpret=True)`
            on the inputs of tests/test_emit_pallas.py: the same multiset
            of non-sentinel (key, payload bits, gid) slots.
  * raster  `rasterize_forward` vs `rasterize_forward_pallas(interpret=True,
            fwd_only=True)` on the SAME diet SoA and ranges: p99.9 of |d|
            <= 1e-5 and max <= 2/255. The TPU kernel forms transmittance as
            exp(prefix sum of log(1 - alpha)), the port as the sequential
            product; the few-ulp difference can flip a pixel's
            T <= 1e-4 or alpha >= 1/255 gate, which moves that pixel by at
            most about one splat's contribution.
  * f16     the diet pair packing, exhaustively over all 65536 patterns.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from brush_tpu.camera import Camera as JCamera
from brush_tpu.ops import tiling as jtiling
from brush_tpu.ops import tiling_key as jtk
from brush_tpu.ops.emit_pallas import emit_slots as j_emit_slots
from brush_tpu.ops.expand_pallas import BLKS as J_BLKS
from brush_tpu.ops.expand_pallas import expand_segments as j_expand_segments
from brush_tpu.ops.projection import project_splats as j_project_splats
from brush_tpu.ops.rasterize_pallas import rasterize_forward_pallas
from brush_tpu.ops.scan_pallas import cummax_1d as j_cummax_1d
from brush_tpu.ops.scan_pallas import BLK as J_BLK
from brush_tpu.ops.scan_pallas import cumsum_rows as j_cumsum_rows
from brush_tpu.ops.scan_pallas import fill_rows as j_fill_rows
from brush_tpu.ops.scan_pallas import stack_rows as j_stack_rows
from brush_tpu.render import camera_inputs as j_camera_inputs
from tests.test_emit_pallas import _emission_inputs, _real_slot_rows

from brush_tpu_torch import kernels
from brush_tpu_torch.ops import (
    emit_cuda, expand_cuda, rasterize_cuda, scan_cuda)
from brush_tpu_torch.ops import tiling_key as ttk

DATA = pathlib.Path(__file__).parent / "data"


# --------------------------------------------------------------------------
# scan / stack
# --------------------------------------------------------------------------


def _scan_input(rng, rows=2, length=17000):
    x = rng.integers(0, 8, (rows, length)).astype(np.int32)
    x[-1, ::7] = 100_000            # running sums pass 2^24 (f32-inexact)
    return x


def test_cumsum_rows_plain_matches_jax_scan_kernel():
    x = _scan_input(np.random.default_rng(0))
    want = np.asarray(j_cumsum_rows(jnp.asarray(x), interpret=True))
    got = scan_cuda.cumsum_rows(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert want[-1, -1] > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)


def test_cumsum_rows_f32_matches_jax_scan_kernel():
    """The [11, L] shape of the JAX package's gradient reduce. Each package
    adds in its own order, so each prefix is held to 1e-6 of the running
    sum of |x| (the rule the CUDA kernel is held to on the card)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (11, 17000))
         * 10.0 ** rng.integers(-3, 3, (11, 17000))).astype(np.float32)
    want = np.asarray(j_cumsum_rows(jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    got = scan_cuda.cumsum_rows(xt)
    assert got.dtype == torch.float32
    assert scan_cuda.compare_f32_scan(got, torch.from_numpy(want), xt) < 1.0
    exact = np.cumsum(x.astype(np.float64), axis=1)
    assert scan_cuda.compare_f32_scan(got, torch.from_numpy(exact).float(),
                                      xt) < 1.0
    # The rule catches one (large) element added twice or dropped.
    j = int(xt[3].abs().argmax())
    wrong = got.clone()
    wrong[3, j:] += xt[3, j]
    with pytest.raises(AssertionError, match="running sum"):
        scan_cuda.compare_f32_scan(wrong, got, xt)


def test_cummax_1d_matches_jax_scan_kernel():
    rng = np.random.default_rng(5)
    x = rng.integers(-2 ** 31, 2 ** 31, 17000, dtype=np.int64).astype(
        np.int32)
    x[:9000] //= 1000
    want = np.asarray(j_cummax_1d(jnp.asarray(x), interpret=True))
    got = scan_cuda.cummax_1d(torch.from_numpy(x))
    assert got.dtype == torch.int32 and len(np.unique(want)) > 10
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_scratch_covers_every_tile_the_kernel_takes():
    """The scan kernel starts each row's tiles at the 16-byte boundary at or
    before the row's first lane (0 to 3 lanes early, by the row's offset in
    a 16-byte-aligned matrix) and keeps one 8-byte status word a tile, rows
    after rows, behind its tile counter: the wrapper's scratch must hold
    them for every row of any length."""
    tile = 10_240
    for rows in (1, 3, 11):
        for length in (1, 3, 4, 10_237, 10_238, 10_240, 10_241, 20_477,
                       9_000_001):
            words = scan_cuda.scan_scratch_words(rows, length, tile)
            assert (words - 1) % rows == 0
            per_row = (words - 1) // rows
            heads = [(r * length) % 4 for r in range(rows)]
            assert max(-(-(length + h) // tile) for h in heads) <= per_row
            # No more than one tile a row to spare.
            assert per_row <= -(-length // tile) + 1
    assert scan_cuda.scan_scratch_words(1, 10_237, tile) == 2
    assert scan_cuda.scan_scratch_words(2, 10_238, tile) == 5


def test_scan_asks_the_library_for_its_tile_once(monkeypatch):
    from brush_tpu_torch.kernels import build

    calls = []

    class Library:
        def brush_scan_tile_items(self):
            calls.append(1)
            return 4096

    scan_cuda.scan_tile_items.cache_clear()
    monkeypatch.setattr(build, "library", Library)
    try:
        assert [scan_cuda.scan_tile_items() for _ in range(3)] == [4096] * 3
        assert len(calls) == 1
    finally:
        scan_cuda.scan_tile_items.cache_clear()


@pytest.mark.parametrize("length", [1, 4095, 4096, 4097, 1_000_003,
                                    17_000_003])
def test_fill_scratch_covers_every_tile_the_kernel_takes(length):
    """The fill kernel's tiles start at lane 0 and every row reads the same
    look-back over the lane axis: one 8-byte status word a tile, behind the
    tile counter, whatever the number of rows."""
    tile = 4096
    words = scan_cuda.fill_scratch_words(length, tile)
    assert (words - 2) * tile < length <= (words - 1) * tile


def test_fill_asks_the_library_for_its_tile_once(monkeypatch):
    from brush_tpu_torch.kernels import build

    calls = []

    class Library:
        def brush_fill_tile_items(self):
            calls.append(1)
            return 4096

    scan_cuda.fill_tile_items.cache_clear()
    monkeypatch.setattr(build, "library", Library)
    try:
        assert [scan_cuda.fill_tile_items() for _ in range(3)] == [4096] * 3
        assert len(calls) == 1
    finally:
        scan_cuda.fill_tile_items.cache_clear()


def _stack_input(rng, n_rows=6, length=9000):
    words = rng.integers(-2 ** 31, 2 ** 31, (n_rows, length), dtype=np.int64)
    words = words.astype(np.int32)
    words[0] = np.float32(rng.normal(size=length)).view(np.int32)
    words[1, :5] = np.float32(np.nan).view(np.int32)   # NaN patterns
    return words


def test_stack_rows_plain_matches_jax_stack():
    words = _stack_input(np.random.default_rng(1))
    rows = [torch.from_numpy(w).view(torch.float32) for w in words]
    got = scan_cuda.stack_rows(rows, 8, words.shape[1] + 384)
    want = np.asarray(j_stack_rows(
        [jnp.asarray(w.view(np.float32)) for w in words], 8,
        words.shape[1] + 384))
    assert tuple(got.shape) == want.shape == (8, 16384)
    n, length = words.shape
    got_w = got.view(torch.int32).numpy()
    np.testing.assert_array_equal(got_w[:n, :length],
                                  want.view(np.int32)[:n, :length])
    np.testing.assert_array_equal(got_w[:n, :length], words)
    assert not got_w[n:].any() and not got_w[:, length:].any()


# --------------------------------------------------------------------------
# expand / fill
# --------------------------------------------------------------------------


def _expand_case(name):
    """(table, starts, counts, cap): the cases of tests/test_expand_pallas.py."""
    rng = np.random.default_rng(3)
    if name == "value_exactness":
        return (np.array([[1.0000001, 3.141592653], [1e-30, 65504.123]],
                         np.float32),
                np.array([0, 2], np.int32), np.array([2, 3], np.int32), 5)
    many = rng.integers(0, 9, 400)
    counts, cap = {
        "basic_runs": ([3, 0, 5, 1, 0, 2], 16),
        "truncation": ([10, 10, 10], 15),
        "large_single_owner": ([3, 2 * J_BLKS + 100, 4], 2 * J_BLKS + 512),
        "empty": ([0, 0, 0], 8),
        "many_owners_random": (many, int(many.sum()) + 37),
    }[name]
    counts = np.asarray(counts, np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    table = rng.standard_normal((5, len(counts))).astype(np.float32)
    return table, starts, counts, cap


@pytest.mark.parametrize("case", ["basic_runs", "truncation",
                                  "large_single_owner", "empty",
                                  "many_owners_random", "value_exactness"])
def test_expand_segments_plain_matches_jax_expand_kernel(case):
    table, starts, counts, cap = _expand_case(case)
    want = np.asarray(j_expand_segments(
        jnp.asarray(table), jnp.asarray(starts), jnp.asarray(counts), cap,
        interpret=True))
    got = expand_cuda.expand_segments(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(counts), cap)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()       # bit for bit
    if case != "empty":
        assert np.abs(want).sum() > 0


def test_expand_segments_edges():
    """What the JAX kernel's tests do not reach: no owners at all, int32
    bit patterns (NaN payloads) as the table, a strided table, and inputs
    the wrapper refuses."""
    none = expand_cuda.expand_segments(
        torch.zeros((3, 0)), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), 7)
    assert tuple(none.shape) == (3, 7) and not none.any()
    bits = np.array([[0x7FC00001, -1, 0x7F800000, 5]], np.int32)
    counts = torch.tensor([2, 0, 1, 3], dtype=torch.int32)
    starts = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    got = expand_cuda.expand_segments(
        torch.from_numpy(bits).view(torch.float32), starts, counts, 8)
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy()[0],
        [0x7FC00001, 0x7FC00001, 0x7F800000, 5, 5, 5, 0, 0])
    wide = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    sub = expand_cuda.expand_segments(wide[1:3, :4], starts, counts, 6)
    np.testing.assert_array_equal(
        sub.numpy(), [[6, 6, 8, 9, 9, 9], [12, 12, 14, 15, 15, 15]])
    with pytest.raises(ValueError, match="int32"):
        expand_cuda.expand_segments(wide.float(), starts.long(), counts, 6)
    with pytest.raises(ValueError, match="32-bit"):
        expand_cuda.expand_segments(wide[:, :4].double(), starts, counts, 6)
    with pytest.raises(ValueError, match="cap"):
        expand_cuda.expand_segments(wide[:, :4], starts, counts, 2 ** 31)


def test_expand_segments_plain_takes_gaps_and_zero_count_crowds():
    """What the CUDA kernel's windows must reproduce: gaps between runs,
    500 zero-count owners on one start, owners that mostly own nothing, a
    last run cut at a width that is not a multiple of 4."""
    rng = np.random.default_rng(13)
    counts = np.array([5] * 30 + [0] * 500 + [7] * 30 + ([1] + [0] * 9) * 50,
                      np.int32)
    starts = (np.cumsum(counts + rng.integers(0, 4, len(counts)))
              - counts).astype(np.int32)
    cap = int(starts[545]) + 3                 # inside a run of 7
    cap += cap % 4 == 0
    assert cap % 4 != 0 and cap < starts[545] + counts[545]
    words = rng.integers(-2 ** 31, 2 ** 31, (3, len(counts)),
                         dtype=np.int64).astype(np.int32)
    got = expand_cuda.expand_segments(
        torch.from_numpy(words).view(torch.float32), torch.from_numpy(starts),
        torch.from_numpy(counts), cap)
    want = np.zeros((3, cap), np.int32)
    for g in range(len(counts)):
        s, c = int(starts[g]), int(counts[g])
        if c > 0 and s < cap:
            want[:, s:min(s + c, cap)] = words[:, g:g + 1]
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), want)
    assert (want[:, -1] == words[:, 545]).all()       # the cut run's tail


def _fill_case(name):
    rng = np.random.default_rng(11)
    if name == "bit_patterns":
        length = J_BLK
        starts = np.array([0, 5, 129, 4000], np.int32)
        vals = np.array([[0x7FC00001, 0x7F800000, -1, 123456789]], np.int32)
    else:
        length = J_BLK + 700
        starts = np.sort(rng.choice(length, 37, replace=False)).astype(
            np.int32)
        if name == "late_first_lane":
            starts = starts[starts > 300]
        vals = rng.standard_normal((5, len(starts))).astype(np.float32).view(
            np.int32)
    x = np.zeros((vals.shape[0], length), np.int32)
    valid = np.zeros(length, np.int32)
    x[:, starts] = vals
    valid[starts] = 1
    return x, valid


@pytest.mark.parametrize("case", ["random_segments", "late_first_lane",
                                  "bit_patterns"])
def test_fill_rows_plain_matches_jax_fill_kernel(case):
    x, valid = _fill_case(case)
    xf = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.float32)
    want = np.asarray(jax.lax.bitcast_convert_type(
        j_fill_rows(xf, jnp.asarray(valid), interpret=True), jnp.int32))
    got = scan_cuda.fill_rows(torch.from_numpy(x).view(torch.float32),
                              torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), want)
    # The dtype goes through unchanged, and a bool mask means the same.
    as_int = scan_cuda.fill_rows(torch.from_numpy(x),
                                 torch.from_numpy(valid > 0))
    assert as_int.dtype == torch.int32
    np.testing.assert_array_equal(as_int.numpy(), want)
    assert len(np.unique(want[0])) >= 4
    if case == "late_first_lane":
        assert not want[:, :300].any()


def test_fill_of_scatter_equals_expand():
    """Scatter each owner's column to its start, mark owners that have
    slots valid, fill: the expansion of the same table (below the total;
    the fill goes on past it, the expansion writes zeros there)."""
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 6, 300).astype(np.int32)
    counts[0] = 0                                  # lanes before any owner
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    table = torch.from_numpy(rng.standard_normal((3, 300)).astype(np.float32))
    counts_t, starts_t = torch.from_numpy(counts), torch.from_numpy(starts)
    expanded = expand_cuda.expand_segments(table, starts_t, counts_t,
                                           total + 9)
    owners = counts_t > 0
    x = torch.zeros((3, total + 9))
    x[:, starts_t[owners].long()] = table[:, owners]
    valid = torch.zeros(total + 9, dtype=torch.int32)
    valid[starts_t[owners].long()] = 1
    filled = scan_cuda.fill_rows(x, valid)
    assert torch.equal(filled[:, :total].view(torch.int32),
                       expanded[:, :total].view(torch.int32))
    assert not expanded[:, total:].any()
    assert torch.equal(filled[:, total:],
                       filled[:, total - 1:total].expand(3, 9))
    with pytest.raises(ValueError, match="32-bit"):
        scan_cuda.fill_rows(x.double(), valid)
    with pytest.raises(ValueError, match="valid"):
        scan_cuda.fill_rows(x, valid[:-1])
    empty = scan_cuda.fill_rows(torch.zeros((2, 0)),
                                torch.zeros(0, dtype=torch.int32))
    assert tuple(empty.shape) == (2, 0)


# --------------------------------------------------------------------------
# emit
# --------------------------------------------------------------------------


EMIT_CASES = [dict(seed=0, k0=2, rem_cap=4096),
              dict(seed=1, k0=1, rem_cap=8192),
              dict(seed=2, k0=4, rem_cap=4096),
              dict(n=40, seed=3, img=(512, 512), k0=1, rem_cap=1 << 14)]


def _port_emit(inputs, img):
    (table, hit_mask, counts, pc, depth_bits, rem_starts, rem_needed,
     n, k0, rem_cap, tile_bw, num_tiles) = inputs
    rows = [torch.from_numpy(np.asarray(table[i])) for i in range(17)]
    key, out = emit_cuda.emit_slots(
        rows, torch.from_numpy(np.asarray(rem_starts)), k0, rem_cap, img)
    assert key.dtype == torch.int64 and out.shape == (10, key.shape[0])
    assert key.shape[0] == n * k0 + rem_cap
    return key.numpy().astype(np.uint32), list(out.numpy())


@pytest.mark.parametrize("case", EMIT_CASES,
                         ids=["seed0", "seed1", "seed2", "giant_tail"])
def test_emit_plain_matches_emit_jnp(case):
    inputs = _emission_inputs(**case)
    (table, hit_mask, counts, pc, depth_bits, rem_starts, rem_needed,
     n, k0, rem_cap, tile_bw, num_tiles) = inputs
    img = case.get("img", (160, 128))
    key_j, rows_j, _, _ = jax.jit(jtiling._emit_jnp,
                                  static_argnums=(7, 8, 9, 10, 11))(*inputs)
    key_t, rows_t = _port_emit(inputs, img)
    a = _real_slot_rows(key_j, rows_j, num_tiles)
    b = _real_slot_rows(key_t, rows_t, num_tiles)
    assert a.shape[0] > 0 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    # The port follows _emit_jnp's layout slot for slot.
    np.testing.assert_array_equal(key_t, np.asarray(key_j))
    if case.get("img"):
        assert int(jnp.max(counts)) > jtk.B_SCAN, "no bbox-tail splat"


@pytest.mark.parametrize("case", [EMIT_CASES[0], EMIT_CASES[3]],
                         ids=["seed0", "giant_tail"])
def test_emit_plain_matches_pallas_emit_kernel(case):
    inputs = _emission_inputs(**case)
    table, rem_starts, k0, rem_cap = inputs[0], inputs[5], inputs[8], inputs[9]
    num_tiles = inputs[11]
    img = case.get("img", (160, 128))
    emat = j_emit_slots([table[i] for i in range(17)], rem_starts, k0,
                        rem_cap, img, interpret=True)
    key_k = np.asarray(emat[0].astype(jnp.uint32)
                       | (emat[11].astype(jnp.uint32) << jnp.uint32(16)))
    rows_k = [np.asarray(emat[r]) for r in range(1, 11)]
    key_t, rows_t = _port_emit(inputs, img)
    np.testing.assert_array_equal(_real_slot_rows(key_t, rows_t, num_tiles),
                                  _real_slot_rows(key_k, rows_k, num_tiles))


# --------------------------------------------------------------------------
# rasterizer (diet, forward only)
# --------------------------------------------------------------------------


def _basic_case():
    d = load_file(DATA / "basic_case.safetensors")
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = JCamera(position=np.array([0.123, 0.456, -8.0]),
                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                  fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    params = [d[k] for k in ("means", "scales", "quats", "coeffs",
                             "opacities")]
    return params, cam, (w, h), 3


def _opaque_wall(n=600, img=(96, 64)):
    """Stacked near-opaque splats: a quarter of the pixels or more saturate
    mid-tile, and tiles span several 256-slot chunks (the TPU kernel's
    early exit)."""
    rng = np.random.default_rng(2)
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    sh = rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32)
    params = [means, np.full((n, 3), np.log(0.2), np.float32),
              np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)), sh,
              np.full(n, 8.0, np.float32)]
    cam = JCamera(position=np.array([0.0, 0.0, -5.0]),
                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                  fov_x=0.9, fov_y=0.9 * img[1] / img[0])
    return params, cam, img, 0


def _digest(**arrays):
    """Short hashes of arrays, for assertion messages: a run on fixed
    inputs that reads differently names the array that changed."""
    import hashlib
    return {k: hashlib.sha256(np.ascontiguousarray(np.asarray(v)).tobytes())
            .hexdigest()[:12] for k, v in arrays.items()}


def _jax_diet_soa(params, cam, img, sh_degree, isect_cap=1 << 13, k0=4):
    ci = j_camera_inputs(cam, img)

    @jax.jit
    def binning(*p):
        proj = j_project_splats(*p, ci, img, sh_degree=sh_degree)
        return jtiling.build_intersections(proj, img, isect_cap,
                                           expand_k0=k0, with_bwd_info=False)

    isect = binning(*params)
    assert int(isect.num_isects) <= isect_cap
    return isect


@pytest.mark.parametrize("scene", ["basic_case", "opaque_wall"])
def test_rasterize_plain_matches_pallas_fwd_only(scene):
    params, cam, img, deg = (_basic_case() if scene == "basic_case"
                             else _opaque_wall())
    isect = _jax_diet_soa(params, cam, img, deg)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    want = np.asarray(rasterize_forward_pallas(
        isect.soa, isect.tile_ranges, jnp.asarray(bg), img, interpret=True,
        fwd_only=True))
    soa = torch.from_numpy(np.asarray(isect.soa).view(np.int32))
    ranges = torch.from_numpy(np.asarray(isect.tile_ranges))
    got = rasterize_cuda.rasterize_forward(soa, ranges, torch.from_numpy(bg),
                                           img).numpy()
    assert got.shape == want.shape
    if scene == "opaque_wall":
        spans = np.diff(np.asarray(isect.tile_ranges), axis=1)
        assert spans.max() > 256 and (want[:, 3] > 0.999).mean() > 0.25
    diff = np.abs(got - want)
    arrays = _digest(soa=isect.soa, ranges=isect.tile_ranges, want=want,
                     got=got)
    assert np.quantile(diff, 0.999) <= 1e-5, (np.quantile(diff, 0.999),
                                              arrays)
    assert diff.max() <= 2.0 / 255.0, (diff.max(), arrays)
    # The image layout of the JAX package.
    from brush_tpu.ops.rasterize_pallas import tiles_to_image as j_tti
    np.testing.assert_array_equal(
        rasterize_cuda.tiles_to_image(torch.from_numpy(want), img).numpy(),
        np.asarray(j_tti(jnp.asarray(want), img)))


def test_kernel_compares_catch_one_wrong_slot():
    """The rules that hold each CUDA kernel to its plain version on the
    card: a rasterizer that drops one slot of one tile changes under 0.1%
    of the values, each by less than 2/255 (so the port-vs-JAX quantile
    rule above would pass it), and must still fail; a stack or emission
    off by one bit must fail."""
    params, cam, img, deg = _basic_case()
    isect = _jax_diet_soa(params, cam, img, deg)
    soa = torch.from_numpy(np.asarray(isect.soa).view(np.int32).copy())
    ranges = torch.from_numpy(np.asarray(isect.tile_ranges).copy())
    bg = torch.tensor([0.3, 0.2, 0.1])
    full = rasterize_cuda.rasterize_forward_plain(soa, ranges, bg, img)
    dropped = ranges.clone()
    dropped[int((ranges[:, 1] - ranges[:, 0]).argmax()), 1] -= 1
    wrong = rasterize_cuda.rasterize_forward_plain(soa, dropped, bg, img)
    diff = (wrong - full).abs().flatten().numpy()
    arrays = _digest(soa=soa, ranges=ranges, full=full)
    assert 0 < (diff > 0).mean() < 1e-3 and diff.max() < 2.0 / 255.0, (
        (diff > 0).mean(), diff.max(), arrays)
    assert np.quantile(diff, 0.999) <= 1e-5, arrays
    assert rasterize_cuda.compare(full.clone(), full) == 0.0
    with pytest.raises(AssertionError, match="ulps"):
        rasterize_cuda.compare(wrong, full)

    rows = scan_cuda.stack_rows([soa[r] for r in range(6)], 8, soa.shape[1])
    flipped = rows.clone()
    flipped[3, 5] ^= 1
    assert kernels.same_bits(rows.clone(), rows) == 0.0
    with pytest.raises(AssertionError, match="differ"):
        kernels.same_bits(flipped, rows)
    key = torch.arange(8, dtype=torch.int64)
    payload = torch.zeros((10, 8))
    with pytest.raises(AssertionError, match="differ"):
        kernels.same_bits((key, payload), (key, payload.clone().fill_(-0.0)))
    # The expansion and the fill: one slot given to the neighbouring owner,
    # or one word off by a bit (+0.0 against -0.0), must fail.
    table, starts, counts, cap = _expand_case("many_owners_random")
    expanded = expand_cuda.expand_segments(
        torch.from_numpy(table), torch.from_numpy(starts),
        torch.from_numpy(counts), cap)
    assert kernels.same_bits(expanded.clone(), expanded) == 0.0
    edge = int(starts[np.nonzero(counts)[0][5]])
    shifted = expanded.clone()
    shifted[:, edge] = expanded[:, edge - 1]
    with pytest.raises(AssertionError, match="differ"):
        kernels.same_bits(shifted, expanded)
    x, valid = _fill_case("random_segments")
    filled = scan_cuda.fill_rows(torch.from_numpy(x).view(torch.float32),
                                 torch.from_numpy(valid))
    assert kernels.same_bits(filled.clone(), filled) == 0.0
    first = int(np.nonzero(valid)[0][0])
    leaked = filled.clone()
    leaked[:, first - 1] = filled[:, first]      # filled backwards by a lane
    with pytest.raises(AssertionError, match="differ"):
        kernels.same_bits(leaked, filled)
    signed = filled.clone()
    signed[2, :first] = -0.0                     # zeros before the first lane
    with pytest.raises(AssertionError, match="differ"):
        kernels.same_bits(signed, filled)


def test_training_kernel_compares_catch_one_wrong_slot():
    """The rules that hold the two training kernels to their plain
    versions: a forward that drops one slot, or reports a `useful_len` one
    short, must fail; a backward that drops one slot's gradient column, or
    zeroes one gradient row, must fail, while rounding-level noise passes."""
    params, cam, img, deg = _opaque_wall()
    ci = j_camera_inputs(cam, img)

    @jax.jit
    def binning(*p):
        proj = j_project_splats(*p, ci, img, sh_degree=deg)
        return jtiling.build_intersections(proj, img, 1 << 13, expand_k0=4,
                                           with_bwd_info=True)

    isect = binning(*params)
    soa = torch.from_numpy(np.asarray(isect.soa).copy())
    ranges = torch.from_numpy(np.asarray(isect.tile_ranges).copy())
    bg = torch.tensor([0.3, 0.2, 0.1])
    full, _ = rasterize_cuda.rasterize_forward_train_plain(soa, ranges, bg,
                                                           img)
    assert rasterize_cuda.compare(full.clone(), full) == 0.0
    # Drop the first slot of the fullest tile: it is blended.
    fullest = int((ranges[:, 1] - ranges[:, 0]).argmax())
    dropped = ranges.clone()
    dropped[fullest, 0] += 1
    wrong, _ = rasterize_cuda.rasterize_forward_train_plain(soa, dropped, bg,
                                                            img)
    with pytest.raises(AssertionError, match="ulps"):
        rasterize_cuda.compare(wrong, full)
    short = full.clone()
    short[fullest, 5] -= 1.0
    with pytest.raises(AssertionError, match="exact rows"):
        rasterize_cuda.compare(short, full)

    v_img = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (img[1], img[0], 4)).astype(np.float32))
    v_tiles = rasterize_cuda.image_to_tiles(v_img, img)
    grads = rasterize_cuda.rasterize_backward_plain(soa, ranges, full,
                                                    v_tiles, bg, img)
    assert grads.shape == (11, soa.shape[1])
    # Slots past a tile's useful range, and outside every range, are zero.
    start, useful = int(ranges[fullest, 0]), int(full[fullest, 5, 0])
    assert 0 < useful < int(ranges[fullest, 1]) - start
    assert not grads[:, start + useful:int(ranges[fullest, 1])].any()
    assert not grads[:, int(ranges[:, 1].max()):].any()
    assert grads[:, start:start + useful].abs().sum() > 0
    noisy = grads * (1.0 + 1e-6 * torch.randn(grads.shape))
    assert rasterize_cuda.compare_bwd(noisy, grads) > 0.0
    # The column a kernel would lose by dropping one blended slot.
    col = start + int(grads[10, start:start + useful].argmax())
    lost = grads.clone()
    lost[:, col] = 0.0
    with pytest.raises(AssertionError, match="gradients past"):
        rasterize_cuda.compare_bwd(lost, grads)
    for row in range(11):
        zeroed = grads.clone()
        zeroed[row] = 0.0
        with pytest.raises(AssertionError, match=f"rows \\[{row}\\]"):
            rasterize_cuda.compare_bwd(zeroed, grads)


# --------------------------------------------------------------------------
# f16 pair packing (the diet SoA)
# --------------------------------------------------------------------------


def test_f16_pack_unpack_exhaustive():
    """Every f16 bit pattern: the port's unpack is bit-exact against numpy
    float16 and the JAX `_unpack2f16` (NaN patterns decode to a NaN), and
    packing the exact values back gives the same words as the JAX
    `_pack2f16`. f32 values between f16 steps and past the f16 range round
    as numpy and XLA do (nearest even, overflow to inf)."""
    bits = np.arange(65536, dtype=np.int64)
    ref = bits.astype(np.uint16).view(np.float16).astype(np.float32)
    nan = np.isnan(ref)
    words = (bits | (bits[::-1] << 16)).astype(np.uint32).view(np.int32)
    lo, hi = ttk._unpack2f16(torch.from_numpy(words))
    j_lo, j_hi = jax.jit(jtk._unpack2f16)(jnp.asarray(words.view(np.float32)))
    for got, want, jgot in ((lo.numpy(), ref, np.asarray(j_lo)),
                            (hi.numpy(), ref[::-1], np.asarray(j_hi))):
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m].view(np.int32),
                                      want[m].view(np.int32))
        np.testing.assert_array_equal(got[m].view(np.int32),
                                      jgot[m].view(np.int32))
        assert np.isnan(got[~m]).all()

    a, b = ref[~nan], ref[~nan][::-1].copy()
    packed = ttk._pack2f16(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    j_packed = np.asarray(jax.jit(jtk._pack2f16)(a, b)).view(np.int32)
    np.testing.assert_array_equal(packed, j_packed)
    np.testing.assert_array_equal(
        packed.view(np.uint32) & 0xFFFF, bits[~nan].astype(np.uint32))

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 1, 20000), rng.normal(0, 3e4, 5000),
                        rng.uniform(-1e-7, 1e-7, 5000),
                        [65504.0, 65519.0, 65520.0, 1e9, -1e9]]
                       ).astype(np.float32)
    y = x[::-1].copy()
    packed = ttk._pack2f16(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jax.jit(jtk._pack2f16)(x, y)).view(np.int32))
    np.testing.assert_array_equal(
        packed.view(np.uint32) & 0xFFFF,
        x.astype(np.float16).view(np.uint16).astype(np.uint32))


CSRC = pathlib.Path(rasterize_cuda.__file__).resolve().parents[1] / "csrc"


def _with_headers(path, seen=()):
    """The text of a csrc/ file and of the local headers it includes."""
    text = path.read_text()
    for header in re.findall(r'#include "([^"]+)"', text):
        if header not in seen:
            seen = (*seen, header)
            text += _with_headers(CSRC / header, seen)
    return text


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_kernel_table_matches_the_sources(name):
    """A row of `kernels.KERNELS` against the tree: its source exists, it
    defines the kernel a trace names (and the variant, where one template
    serves several), one wrapper under ops/ counts its launches, and a
    call runs at least one launch of its own."""
    row = kernels.KERNELS[name]
    source = CSRC / row.source
    assert source.is_file()
    text = _with_headers(source)
    symbol, variant = row.symbol
    assert re.search(r"__global__[^;{]*\b" + re.escape(symbol.split("<")[0])
                     + r"\(", text)
    assert variant in text
    counting = [
        path.name for path in sorted((CSRC.parent / "ops").glob("*.py"))
        for _ in re.finditer(r'note_launch\(\s*"' + re.escape(name) + '"',
                             path.read_text())]
    assert len(counting) == 1, counting
    assert row.launches >= 1 and row.memsets >= 0
