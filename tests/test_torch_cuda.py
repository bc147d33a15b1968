"""The CUDA kernels of `brush_tpu_torch` against their plain PyTorch
versions, on the card. This file imports no JAX and nothing of the JAX
package, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py pins JAX to the CPU and so needs
JAX.) Every test is marked `cuda` and skips where torch.cuda.is_available()
is false. `python3 chip_smoke.py` makes the same comparisons at full width;
the cases here are small and pick the edges: scan lengths around 4096
lanes and the kernel's 10,240-lane tile, rows not a multiple of 4 lanes
long, a row whose look-back crosses hundreds of tiles, identity inputs and
sums past 2^31 (wrapping), its f32 sum (run twice: its order depends on
timing) and int32 max variants, stacks that pad and truncate, expansions
and fills on empty, single-owner, cut, gapped and ragged shapes, 5,000
zero-count owners inside one tile (past its shared-memory window), widths
not a multiple of 4, strided tables, and three scenes, each rendered
forward only and through one training render with its backward, whose
launches are captured (`kernels.capture`) and each replayed kernel against
plain under its own module's compare (`kernels.Launch.check`):

  * bench:        the benchmark generator, capacities from `plan_caps`;
  * opaque_wall:  stacked near-opaque splats, k0 = 1, tiles of several
                  hundred slots where whole blocks finish early;
  * giant_splats: splats whose bbox passes 32 tiles (the untested bbox
                  tail of the emission).

The rasterizers' work split (one warp an 8x4-pixel part of a tile, parts
from an atomic counter, longest tiles first) and the backward's per-splat
atomics are also held to their plain versions on SoAs built here slot by
slot: one tile of 2,500 unsaturated slots among short tiles, one splat in
every tile of a 1080p grid (every warp adds into the same gradient row),
empty tiles and tiles nothing blends in, NaN and infinite conics, a single
splat, and a capacity whose second half is dead.

`train_process` runs on the card over a 32x32 COLMAP scene, with the
kernels and with the plain rasterizer, each held to the same run on the
CPU; a checkpoint restores a CUDA generator on the card. The web viewer's
frame on the card is held to the CPU's, LPIPS on the card to the CPU's (a
bar TF32 convolutions miss), and the C ABI trains 2 steps on the card.
The DP step over a one-process NCCL group is held to the batched step,
and the strip render of two gloo processes sharing the card to the full
render.

The compiled programs (`graphs.py`): a frame, a step and a loop turn run
under sync debug mode "error"; a RenderGraph's frames equal eager ones bit
for bit; StepGraphs steps (plain, with the LPIPS term, over two stacked
views) and `train_process` on StepGraphs (with LPIPS weights, with two
views a batch) are held to the eager ones; freeing graphs on one thread
waits for a capture on another; StepGraphs steps through a
KannalaBrandt4 lens equal eager ones, and `train_process` over an
OPENCV_FISHEYE scene trains every turn through the lens on one step
graph, held to its eager run. The refine on a RefineGraph equals the
eager refine bit for bit (the generator too, after a refine that
resamples); the DP step on a graph over a one-process NCCL group (its
all_reduces captured) is held to the eager DP step and to the graphed
batched step; the PUP scoring views on graphs to the eager ones (the
exact mode bit for bit); the strip render on a graph equals the eager one
bit for bit, alone and over a one-process NCCL group; and `train_process`
with refines, capacity growths and a LOD level runs no eager step,
refine or scoring view on the card, alone and over a one-process NCCL
group, and is held to its eager run.

The stage recorder (utils/tracing.py): a device stage records no event
inside a capture, the anchor puts device marks on the host clock (a 10 ms
host sleep between two stages reads its length within 1 ms), and
`train_process` and a RenderGraph count their captures, replays and
evictions, each replay and turn with device marks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.models.splats import from_raw
from brush_tpu_torch.ops import (
    emit_cuda, expand_cuda, rasterize_cuda, scan_cuda, tile_counts_cuda)
from brush_tpu_torch.ops.capacity import plan_caps
from brush_tpu_torch.ops.tiling_key import _pack2f16, tile_key_bits
from brush_tpu_torch.render import (
    RenderConfig,
    camera_inputs,
    render,
    render_with_refine,
)
from brush_tpu_torch.utils.synthetic import bench_splats
from tile_count_rows import CASES as TILE_COUNT_CASES
from tile_count_rows import tile_count_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same(fn, *args):
    """Capture the one launch of `fn(*args)` and hold it to its plain
    version."""
    with kernels.capture() as launches:
        fn(*args)
    assert len(launches) == 1
    return launches[0].check()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(1, 1), (1, 4096), (2, 4097),
                                         (5, 4099), (2, 10_241),
                                         (3, 300_001), (1, 5_000_000),
                                         (3, 9_000_001)])
def test_scan_kernel_matches_plain(rows, length, cuda):
    rng = np.random.default_rng(length)
    x = rng.integers(-1000, 100_000, (rows, length)).astype(np.int32)
    _same(scan_cuda.cumsum_rows, torch.from_numpy(x).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(1, 1), (11, 4096), (2, 4097),
                                         (11, 300_001), (1, 5_000_000)])
def test_f32_scan_kernel_matches_plain(rows, length, cuda):
    """Sums in the kernel's order against torch.cumsum: within 1e-6 of the
    running sum of |x| (mixed signs, so the sums themselves cancel)."""
    rng = np.random.default_rng(length)
    x = (rng.normal(0, 1, (rows, length))
         * 10.0 ** rng.integers(-3, 3, (rows, length))).astype(np.float32)
    # Twice: the tile prefixes add in the order the look-back met them.
    for _ in range(2):
        err = _same(scan_cuda.cumsum_rows, torch.from_numpy(x).to(cuda))
        assert np.isfinite(err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int32_zeros", "f32_zeros", "max_int_min",
                                  "int32_wraps", "input_off_the_grid"])
def test_scan_kernel_edge_values(case, cuda):
    """Inputs that are all the identity of their scan, int32 sums that wrap
    past 2^31 many times, in rows whose lengths are not a multiple of 4
    lanes (so the rows after the first start off the 16-byte grid); and
    inputs that are views starting 1 and 3 lanes past a 16-byte boundary,
    where the output is on it (the kernel's scalar path)."""
    rows, length = 3, 100_003
    if case == "input_off_the_grid":
        rng = np.random.default_rng(10)
        base = torch.from_numpy(rng.integers(-9, 99, 300_007).astype(
            np.int32)).to(cuda)
        _same(scan_cuda.cumsum_rows, base[1:][None, :])
        _same(scan_cuda.cummax_1d, base[3:])
        return
    if case == "int32_zeros":
        x = np.zeros((rows, length), np.int32)
    elif case == "f32_zeros":
        x = np.zeros((rows, length), np.float32)
    elif case == "max_int_min":
        x = np.full(length, np.iinfo(np.int32).min, np.int32)
    else:
        rng = np.random.default_rng(9)
        x = (2 ** 30 + rng.integers(0, 2 ** 29, (rows, length))).astype(
            np.int32)
    t = torch.from_numpy(x).to(cuda)
    if case == "max_int_min":
        _same(scan_cuda.cummax_1d, t)
        out = scan_cuda.cummax_1d(t)
    else:
        _same(scan_cuda.cumsum_rows, t)
        out = scan_cuda.cumsum_rows(t)
    if case == "int32_wraps":
        want = np.cumsum(x.astype(np.int64), axis=1).astype(np.uint32)
        assert want.max() < np.cumsum(x.astype(np.int64), axis=1).max()
        np.testing.assert_array_equal(out.cpu().numpy(), want.view(np.int32))
    else:
        np.testing.assert_array_equal(out.cpu().numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 4096, 4097, 300_001, 5_000_000])
def test_max_scan_kernel_matches_plain(length, cuda):
    rng = np.random.default_rng(length)
    x = rng.integers(-2 ** 31, 2 ** 31, length, dtype=np.int64).astype(
        np.int32)
    x[: length // 2] //= 1000           # the running max keeps rising
    _same(scan_cuda.cummax_1d, torch.from_numpy(x).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,total_rows,length,min_len",
                         [(6, 8, 50_000, 60_000), (19, 24, 8192, 8192),
                          (3, 3, 20_000, 10_000)])
def test_stack_kernel_matches_plain(n_rows, total_rows, length, min_len,
                                    cuda):
    rng = np.random.default_rng(n_rows)
    words = rng.integers(-2 ** 31, 2 ** 31, (n_rows, length), dtype=np.int64)
    words = words.astype(np.int32)
    words[0, :7] = np.float32(np.nan).view(np.int32)   # NaN bit patterns
    rows = [torch.from_numpy(w).to(cuda).view(torch.float32) for w in words]
    _same(scan_cuda.stack_rows, rows, total_rows, min_len)


EXPAND_CASES = {
    # counts, cap (None: the last run's end + 37), rows, largest gap before
    # a run (runs start at the exclusive cumsum of counts + gaps)
    "basic": ([3, 0, 5, 1, 0, 2], 16, 5, 0),
    "all_empty": ([0, 0, 0], 8, 3, 0),
    "one_owner_spans_everything": ([0, 100_000, 0], 100_000, 17, 0),
    "cut_at_cap": ([10, 10, 10], 15, 2, 0),
    "starts_past_cap": ([5, 3000, 7, 9], 1000, 2, 0),
    "ragged_random": (None, None, 17, 0),
    "one_slot": ([1], 1, 1, 0),
    "gaps_between_runs": (None, None, 3, 6),
    # 5,000 zero-count owners sharing one start inside the first tile, and
    # 8,000 owners over 800 slots (nine of ten own nothing): owner ranges
    # past the kernel's 1,024-owner shared-memory window.
    "zero_count_crowd": ([5] * 300 + [0] * 5000 + [7] * 300, None, 3, 0),
    "zero_counts_interleaved": (([1] + [0] * 9) * 800, None, 2, 0),
    # Widths not a multiple of 4: rows after the first start off the
    # 16-byte grid.
    "cap_not_multiple_of_4": (None, 160_003, 5, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_kernel_matches_plain(case, cuda):
    counts, cap, rows, max_gap = EXPAND_CASES[case]
    rng = np.random.default_rng(len(case))
    if counts is None:
        counts = rng.integers(0, 9, 40_001)
    counts = np.asarray(counts, np.int32)
    gaps = rng.integers(0, max_gap + 1, len(counts))
    starts = (np.cumsum(counts + gaps) - counts).astype(np.int32)
    cap = int((starts + counts).max()) + 37 if cap is None else cap
    words = rng.integers(-2 ** 31, 2 ** 31, (rows, len(counts)),
                         dtype=np.int64).astype(np.int32)   # NaNs included
    table = torch.from_numpy(words).to(cuda).view(torch.float32)
    args = (table, torch.from_numpy(starts).to(cuda),
            torch.from_numpy(counts).to(cuda), cap)
    _same(expand_cuda.expand_segments, *args)
    out = expand_cuda.expand_segments(*args)
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows, cap)
    # Against the loop of tests/test_expand_pallas.py, on the host.
    want = np.zeros((rows, cap), np.int32)
    for g in range(len(counts)):
        s, c = int(starts[g]), int(counts[g])
        if c > 0 and s < cap:
            want[:, s:min(s + c, cap)] = words[:, g:g + 1]
    np.testing.assert_array_equal(out.view(torch.int32).cpu().numpy(), want)


@pytest.mark.cuda
def test_expand_kernel_takes_a_strided_table_and_no_owners(cuda):
    wide = torch.arange(18 * 50, dtype=torch.int32, device=cuda).reshape(18, 50)
    counts = torch.full((40,), 3, dtype=torch.int32, device=cuda)
    starts = torch.arange(40, dtype=torch.int32, device=cuda) * 3
    _same(expand_cuda.expand_segments, wide[:17, :40], starts, counts, 130)
    # A strided table over many tiles, with gaps and a width not a multiple
    # of 4.
    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (18, 20_000),
                                        dtype=np.int64).astype(np.int32))
    n_counts = rng.integers(0, 9, 15_000).astype(np.int32)
    n_starts = np.cumsum(n_counts + rng.integers(0, 3, 15_000)) - n_counts
    _same(expand_cuda.expand_segments, big.to(cuda)[1:, 7:15_007],
          torch.from_numpy(n_starts.astype(np.int32)).to(cuda),
          torch.from_numpy(n_counts).to(cuda),
          int(n_starts[-1] + n_counts[-1]) + 1)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    with kernels.capture() as launches:
        out = expand_cuda.expand_segments(
            torch.zeros((3, 0), device=cuda), none, none, 300)
    assert len(launches) == 1 and not out.any()
    launches[0].check()
    before = kernels.LAUNCHES["expand"]
    assert expand_cuda.expand_segments(wide[:, :40], starts, counts,
                                       0).shape == (18, 0)
    assert kernels.LAUNCHES["expand"] == before       # nothing to launch


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,n_valid", [
    (1, 1, 1), (5, 255, 0), (5, 256, 3), (17, 257, 257), (3, 8892, 37),
    (2, 1_000_003, 5000), (1, 5_000_000, 1)])
def test_fill_kernel_matches_plain(rows, length, n_valid, cuda):
    """Lengths around the 256-thread block and the kernel's 4096-lane
    tile, no valid lane, every lane valid, one valid lane late in a long
    row; one launch a call (the look-back scan of the valid lanes is the
    fill kernel's own)."""
    rng = np.random.default_rng(length)
    words = rng.integers(-2 ** 31, 2 ** 31, (rows, length),
                         dtype=np.int64).astype(np.int32)
    valid = np.zeros(length, np.int32)
    valid[rng.choice(length, n_valid, replace=False)] = 1
    if length == 5_000_000:
        valid[:] = 0
        valid[4_000_001] = 7                # any positive value is valid
        valid[17] = -3                      # a negative one is not
    x = torch.from_numpy(words).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    with kernels.capture() as launches:
        out = scan_cuda.fill_rows(x.view(torch.float32), v)
    assert [launch.name for launch in launches] == ["fill"]
    launches[0].check()
    assert out.dtype == torch.float32
    as_bool = scan_cuda.fill_rows(x, v > 0)
    assert as_bool.dtype == torch.int32
    assert torch.equal(as_bool, out.view(torch.int32))
    first = int(np.nonzero(valid > 0)[0][0]) if (valid > 0).any() else length
    assert not as_bool[:, :first].any()
    if first < length:
        assert torch.equal(as_bool[:, first], x[:, first])
        last = int(np.nonzero(valid > 0)[0][-1])
        assert torch.equal(as_bool[:, -1], x[:, last])


# Fill cases: (rows, length, valid lanes, words). The kernel's tile is 4096
# lanes; 1,000,003 lanes with valid lanes at 5 and 900,000 leave a run of
# 219 tiles with none; 17,000,003 lanes put valid lanes past 2^24.
FILL_CASES = {
    "no_valid_lane": (2, 100_003, "none", "int"),
    "first_lane_only": (17, 50_001, "first", "int"),
    "last_lane_only": (2, 123_457, "last", "int"),
    "gap_over_100_tiles": (2, 1_000_003, "gap", "int"),
    "length_4097": (1, 4097, "random", "int"),
    "length_8191": (2, 8191, "random", "int"),
    "length_12289": (17, 12_289, "random", "int"),
    "starts_past_2_24": (1, 17_000_003, "sparse", "int"),
    "nan_words": (2, 70_001, "random", "nan"),
    "valid_off_the_grid": (2, 40_001, "offset", "int"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FILL_CASES))
def test_fill_kernel_edges_match_plain(case, cuda):
    """Bit for bit against the plain version, through the wrapper's
    capture and against the whole plain call on the CPU: empty and
    one-lane valid sets, a look-back across more than 100 tiles with no
    valid lane, lengths that are neither a multiple of the tile nor of 4,
    valid lanes past 2^24, R = 1, 2 and 17, NaN bit patterns, and a valid
    row that starts one lane past a 16-byte boundary (the kernel's scalar
    loads)."""
    rows, length, where, words = FILL_CASES[case]
    rng = np.random.default_rng(length)
    if words == "nan":
        nans = np.array([0x7FC00001, 0x7F800001, -0x400000, 0x7F800000, 0],
                        np.int64).astype(np.int32)
        x = rng.choice(nans, (rows, length))
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, (rows, length),
                         dtype=np.int64).astype(np.int32)
    valid = np.zeros(length + 1, np.int32)
    if where == "first":
        valid[0] = 1
    elif where == "last":
        valid[length - 1] = 1
    elif where == "gap":
        valid[[5, 900_000]] = 1
    elif where == "sparse":
        valid[np.sort(rng.choice(length, 2000, replace=False))] = 1
        valid[2 ** 24 + 3] = 1
    elif where in ("random", "offset"):
        valid[:length] = rng.random(length) < 0.05
    v = torch.from_numpy(valid).to(cuda)
    # Lane 0 of `v[1:]` lies 4 bytes past the allocation's 16-byte boundary.
    v = v[1:] if where == "offset" else v[:length]
    xt = torch.from_numpy(x).to(cuda).view(torch.float32)
    assert _same(scan_cuda.fill_rows, xt, v) == 0.0
    got = scan_cuda.fill_rows(xt, v)
    want = scan_cuda.fill_rows_plain(xt.cpu(), v.cpu())
    assert kernels.same_bits(got.cpu(), want) == 0.0
    flags = v.cpu().numpy() > 0
    first = int(np.argmax(flags)) if flags.any() else length
    assert not got[:, :first].view(torch.int32).any()
    if flags.any():
        last = int(np.nonzero(flags)[0][-1])
        assert torch.equal(got[:, -1].view(torch.int32),
                           xt[:, last].view(torch.int32))


@pytest.mark.cuda
def test_fill_of_scatter_equals_expand_on_the_card(cuda):
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 40, 50_000).astype(np.int32)
    starts = torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32)
                              ).to(cuda)
    total = int(counts.sum())
    counts = torch.from_numpy(counts).to(cuda)
    table = torch.randn((4, 50_000), device=cuda)
    expanded = expand_cuda.expand_segments(table, starts, counts, total)
    owners = counts > 0
    x = torch.zeros((4, total), device=cuda)
    x[:, starts[owners].long()] = table[:, owners]
    valid = torch.zeros(total, dtype=torch.int32, device=cuda)
    valid[starts[owners].long()] = 1
    assert kernels.same_bits(scan_cuda.fill_rows(x, valid), expanded) == 0.0


# Emission cases: (splats, k0, seed). The image is 4096x2048 (128 x 64
# tiles), large enough that every tile an emitted slot names lies in the
# grid.
EMIT_IMG = (4096, 2048)
EMIT_CASES = {
    "one_splat_no_remainder": (1, 1, 0),
    "remainder_over_blocks": (300, 4, 1),
    "zero_remainder_crowd": (12_000, 4, 2),
    "counts_past_popcount": (2_000, 2, 3),
    "nan_depth_and_payload": (3_000, 4, 4),
    "past_rem_needed": (2_500, 4, 5),
    "overflowed": (4_000, 4, 6),
    "half_dead": (1 << 14, 4, 7),
    "ragged_dense": (1_001, 3, 8),
}


def _emit_case(case):
    """The 17 f32 table rows (as numpy words), rem_starts, k0 and rem_cap of
    an emission case. Splats emit 0-40 slots into a bbox 4-8 tiles wide
    under a random 32-bit hit mask (so counts often pass the mask's
    popcount), each case adding its edge: one splat and no remainder slot;
    one splat whose 2,996 remainder slots cross three 1,024-slot blocks;
    5,000 splats in a row with no remainder (one start, inside one block's
    owner range); masks of at most 3 bits; NaN depth and payload words;
    remainder capacity past what the splats need, or a quarter of it (the
    overflowing step); a dead second half (no slots, garbage words); and a
    dense region whose length is not a multiple of 4."""
    n, k0, seed = EMIT_CASES[case]
    rng = np.random.default_rng(seed)
    tile_bw, tile_bh = EMIT_IMG[0] // TILE_WIDTH, EMIT_IMG[1] // TILE_WIDTH
    counts = rng.integers(0, 41, n)
    masks = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    bb_w = rng.integers(4, 9, n)
    if case == "one_splat_no_remainder":
        counts[:] = 3
    elif case == "remainder_over_blocks":
        counts[150], masks[150], bb_w[150] = 3000, 2 ** 32 - 1, tile_bw
    elif case == "zero_remainder_crowd":
        counts[3000:8000] = rng.integers(0, k0 + 1, 5000)
    elif case == "counts_past_popcount":
        masks = np.bitwise_or.reduce(
            [np.int64(1) << rng.integers(0, 32, n) for _ in range(3)])
        masks[::2] = 0
        counts = rng.integers(10, 41, n)
    elif case == "half_dead":
        counts[n // 2:], masks[n // 2:] = 0, 0
    local_max = 32 + counts
    tmin_x = (rng.random(n) * (tile_bw - bb_w + 1)).astype(np.int64)
    tmin_y = (rng.random(n) * (tile_bh - local_max // bb_w)).astype(np.int64)
    words = rng.integers(-2 ** 31, 2 ** 31, (17, n), dtype=np.int64)
    table = np.zeros((17, n), np.float32)
    table[:9] = rng.normal(0, 3, (9, n))
    table[9] = np.arange(n)
    table[10] = np.abs(rng.normal(0, 5, n)).astype(np.float32)
    if case in ("nan_depth_and_payload", "half_dead"):
        bits = words.astype(np.int32)
        bits[:, ::7] = np.int32(0x7FC00001)
        bits[:, 3::7] = np.int32(-0x400000)            # 0xffc00000
        rows = slice(0, 11) if case == "nan_depth_and_payload" else slice(
            0, 9)
        dead = slice(None) if case == "nan_depth_and_payload" else slice(
            n // 2, None)
        table[rows, dead] = bits[rows, dead].view(np.float32)
    table[11], table[12], table[13] = tmin_x, tmin_y, bb_w
    table[14] = counts
    table[15], table[16] = masks & 0xFFFF, masks >> 16
    rem = np.maximum(counts - k0, 0)
    starts = (np.cumsum(rem) - rem).astype(np.int32)
    needed = int(rem.sum())
    rem_cap = {"one_splat_no_remainder": 0, "past_rem_needed": 4 * needed + 5,
               "overflowed": needed // 4}.get(case, needed + 37)
    return table, starts, k0, rem_cap


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EMIT_CASES))
def test_emit_kernel_matches_plain(case, cuda):
    """The emission kernel bit for bit against its plain version, through
    the wrapper (stack, then emit: two launches) and against the whole
    plain call on the CPU."""
    table, starts, k0, rem_cap = _emit_case(case)
    rows = [torch.from_numpy(r) for r in table]
    starts_t = torch.from_numpy(starts)
    with kernels.capture() as launches:
        got = emit_cuda.emit_slots([r.to(cuda) for r in rows],
                                   starts_t.to(cuda), k0, rem_cap, EMIT_IMG)
    assert [launch.name for launch in launches] == ["stack", "emit"]
    for launch in launches:
        assert launch.check() == 0.0
    want = emit_cuda.emit_slots(rows, starts_t, k0, rem_cap, EMIT_IMG)
    assert kernels.same_bits(tuple(t.cpu() for t in got), want) == 0.0
    n = table.shape[1]
    num_tiles = (EMIT_IMG[0] // TILE_WIDTH) * (EMIT_IMG[1] // TILE_WIDTH)
    tiles = want[0].numpy() >> (32 - tile_key_bits(num_tiles))
    assert tiles.max() <= num_tiles            # num_tiles: a sentinel slot
    real = tiles < num_tiles
    needed = int(np.maximum(table[14] - k0, 0).sum())
    if case == "remainder_over_blocks":
        assert real[n * k0:].sum() == min(needed, rem_cap) > 2 * 1024
    elif case == "past_rem_needed":
        assert not real[n * k0 + needed:].any()
    elif case == "overflowed":
        assert rem_cap < needed and real[n * k0:].all()
    elif case == "counts_past_popcount":
        pc = np.array([bin(int(m)).count("1") for m in
                       (table[15].astype(np.int64)
                        | table[16].astype(np.int64) << 16)])
        assert (table[14] > pc).mean() > 0.9
    elif case == "half_dead":
        dense = real[:n * k0].reshape(k0, n)
        assert not dense[:, n // 2:].any() and dense[:, :n // 2].any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    i32 = dict(dtype=torch.int32, device=cuda)
    table = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError, match="32-bit"):
        expand_cuda.expand_segments(table.double(), torch.zeros(8, **i32),
                                    torch.zeros(8, **i32), 4)
    with pytest.raises(ValueError, match="32-bit"):
        expand_cuda.expand_segments(table.half(), torch.zeros(8, **i32),
                                    torch.zeros(8, **i32), 4)
    with pytest.raises(ValueError, match="int32"):
        expand_cuda.expand_segments(table, torch.zeros(8, device=cuda),
                                    torch.zeros(8, **i32), 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        expand_cuda.expand_segments(table, torch.zeros(8, dtype=torch.int32),
                                    torch.zeros(8, **i32), 4)
    with pytest.raises(ValueError, match="stride 1"):
        expand_cuda.expand_segments(torch.zeros((8, 2), device=cuda).T,
                                    torch.zeros(8, **i32),
                                    torch.zeros(8, **i32), 4)
    with pytest.raises(ValueError, match="32-bit"):
        scan_cuda.fill_rows(table.double(), torch.zeros(8, **i32))
    with pytest.raises(ValueError, match="valid"):
        scan_cuda.fill_rows(table, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_cuda.fill_rows(table, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 or float32"):
        scan_cuda.cumsum_rows(torch.zeros((1, 8), device=cuda,
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        scan_cuda.cummax_1d(torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_cuda.stack_rows([torch.zeros(8, device=cuda), torch.zeros(8)],
                             2, 8)
    with pytest.raises(ValueError, match="at most"):
        scan_cuda.stack_rows([torch.zeros(8, device=cuda)] * 33, 33, 8)


def _bench(dev):
    s = bench_splats(20_000, sh_degree=3, seed=1, device=dev)
    cam = Camera(position=np.array([0.0, 0.0, -18.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=1.0,
                 fov_y=0.62)
    img = (320, 192)
    k0, cap = plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                        camera_inputs(cam, img, device=dev), img, device=dev)
    return s, cam, img, 3, k0, cap


def _opaque_wall(dev, n=600):
    rng = np.random.default_rng(2)
    s = from_raw(rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
                 np.full((n, 3), np.log(0.2), np.float32),
                 np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
                 rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32),
                 np.full(n, 8.0, np.float32), device=dev)
    img = (96, 64)
    cam = Camera(position=np.array([0.0, 0.0, -5.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.9,
                 fov_y=0.9 * img[1] / img[0])
    return s, cam, img, 0, 1, 1 << 14


def _giant_splats(dev, n=40):
    rng = np.random.default_rng(3)
    s = from_raw(rng.normal(0, 3, (n, 3)).astype(np.float32),
                 np.log(rng.uniform(0.03, 1.2, (n, 3))).astype(np.float32),
                 rng.normal(0, 1, (n, 4)).astype(np.float32),
                 rng.normal(0, 0.3, (n, 1, 3)).astype(np.float32),
                 rng.normal(0.5, 1.5, n).astype(np.float32), device=dev)
    cam = Camera(position=np.array([0.0, 0.0, -9.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=1.1,
                 fov_y=0.9)
    return s, cam, (512, 512), 0, 1, 1 << 14


SCENES = {"bench": _bench, "opaque_wall": _opaque_wall,
          "giant_splats": _giant_splats}


def _render(s, cam, img, deg, k0, cap, dev):
    cfg = RenderConfig(img_size=img, sh_degree=deg, isect_cap=cap,
                       expand_k0=k0, use_pallas=True, forward_only=True)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    params = [x.to(dev) for x in s.params().values()]
    return render(*params, camera_inputs(cam, img, device=dev), bg, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_render_kernels_match_plain(scene, cuda):
    s, cam, img, deg, k0, cap = SCENES[scene](cuda)
    with kernels.capture() as launches:
        out, aux = _render(s, cam, img, deg, k0, cap, cuda)
    torch.cuda.synchronize()
    assert int(aux.num_isects) <= cap
    assert sorted({launch.name for launch in launches}) == sorted(
        kernels.SERVE_PATH)
    for launch in launches:
        launch.check()
    if scene == "giant_splats":
        assert int(aux.num_bbox_tail) > 0
    else:
        assert int(aux.max_isects_per_tile) > 256
    # The whole frame on the card against the same frame on the CPU (plain
    # versions throughout). Tied sort keys keep emission order on both (the
    # sort is stable); exp, log and sqrt may differ by float ulps between
    # the two, so a pixel at the alpha or transmittance gate may flip.
    ref, aux_ref = _render(s, cam, img, deg, k0, cap, torch.device("cpu"))
    diff = (out.cpu() - ref).abs().flatten().numpy()
    p999, worst = np.quantile(diff, 0.999), diff.max()
    assert p999 <= 1e-4 and worst <= 2.0 / 255.0, (
        f"p99.9 {p999:.3g}, max {worst:.3g}, "
        f"{int((diff > 2.0 / 255.0).sum())} values past 2/255")
    assert int(aux.num_visible) == int(aux_ref.num_visible)


def _train_render(s, cam, img, deg, k0, cap, dev):
    """One training render and its backward; the gradients of the five
    parameter arrays, the refine weight and the visibility mask."""
    cfg = RenderConfig(img_size=img, sh_degree=deg, isect_cap=cap,
                       expand_k0=k0, use_pallas=True)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    params = [x.to(dev).detach().requires_grad_(True)
              for x in s.params().values()]
    n = params[0].shape[0]
    holders = [torch.zeros(n, device=dev, requires_grad=True)
               for _ in range(2)]
    out, aux = render_with_refine(*params, camera_inputs(cam, img, device=dev),
                                  bg, cfg, *holders)
    rows = torch.linspace(0.5, 1.5, img[1], device=dev)[:, None, None]
    chan = torch.tensor([1.0, 0.8, 0.6, 0.4], device=dev)
    grads = torch.autograd.grad((out * rows * chan).sum(), params + holders)
    return out.detach(), aux, grads


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_train_render_kernels_match_plain(scene, cuda):
    s, cam, img, deg, k0, cap = SCENES[scene](cuda)
    with kernels.capture() as launches:
        out, aux, grads = _train_render(s, cam, img, deg, k0, cap, cuda)
    torch.cuda.synchronize()
    assert int(aux.num_isects) <= cap
    assert sorted({launch.name for launch in launches}) == sorted(
        kernels.TRAIN_PATH)
    for launch in launches:
        launch.check()
    for g in grads:
        assert bool(torch.isfinite(g).all())
    # The same render and backward on the CPU (plain versions throughout).
    # exp, log and sqrt may differ by float ulps between the two devices, so
    # a pixel at a gate may flip and move a few gradients by a whole term:
    # p99.9 of |d| within 1e-4 of each array's largest entry.
    ref_out, _, ref = _train_render(s, cam, img, deg, k0, cap,
                                    torch.device("cpu"))
    diff = (out.cpu() - ref_out).abs().flatten().numpy()
    assert np.quantile(diff, 0.999) <= 1e-4 and diff.max() <= 2.0 / 255.0
    # (An array whose gradient is analytically zero, the rotations of
    # isotropic splats, holds rounding noise of the other arrays' terms.)
    noise = 1e-7 * max(float(r.abs().max()) for r in ref[:5])
    for g, r in zip(grads[:6], ref[:6]):
        d = (g.cpu() - r).abs().flatten().numpy()
        scale = float(r.abs().max())
        assert np.quantile(d, 0.999) <= 1e-4 * scale + noise + 1e-8, (
            f"p99.9 {np.quantile(d, 0.999):.3g} max {d.max():.3g} of "
            f"{scale:.3g}")
    flips = int((grads[6].cpu() != ref[6]).sum())
    assert flips <= max(2, grads[6].numel() // 1000), flips


def _look_at(pos, img, fov=1.0):
    """A camera at `pos` looking at the origin, world +y down the image
    (the viewer's orbit pose)."""
    from brush_tpu_torch.data.colmap import _rotmat_to_quat
    fwd = -np.asarray(pos, np.float64) / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return Camera(position=np.asarray(pos, np.float64),
                  rotation=_rotmat_to_quat(rot), fov_x=fov,
                  fov_y=fov * img[1] / img[0])


def _orbit(k, n, radius=18.0, elevation=0.3):
    """Pose k of n on the benchmark's orbit: yaw evenly over the circle,
    elevation by the golden ratio's sequence."""
    yaw = 2.0 * np.pi * k / n
    el = elevation * (2.0 * ((k * 0.6180339887498949) % 1.0) - 1.0)
    return np.array([radius * np.cos(el) * np.sin(yaw), radius * np.sin(el),
                     -radius * np.cos(el) * np.cos(yaw)])


def _random_splats(n, seed, dev):
    """Splats of scales log-uniform in [0.002, 0.5] in a 12 x 12 x 12 box:
    most cover a few tiles, and near the camera the largest far more than
    32."""
    rng = np.random.default_rng(seed)
    return from_raw(
        rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32),
        rng.uniform(np.log(0.002), np.log(0.5), (n, 3)).astype(np.float32),
        rng.normal(0, 1, (n, 4)).astype(np.float32),
        rng.normal(0, 0.3, (n, 1, 3)).astype(np.float32),
        rng.normal(0.0, 2.0, n).astype(np.float32), device=dev)


def _project(s, cam, img, dev):
    from brush_tpu_torch.ops.projection import project_splats
    with torch.no_grad():
        return project_splats(s.means, s.log_scales, s.quats,
                              s.sh_coeffs[:, :1], s.raw_opacities,
                              camera_inputs(cam, img, device=dev), img,
                              sh_degree=0)


def _hold_counts(proj):
    """The kernel's mask and count against the plain version on the same
    projected rows, bit for bit; returns the counts."""
    from brush_tpu_torch.ops import tiling
    with kernels.capture() as launches:
        mask, counts = tiling.exact_tile_counts(proj)
    assert [launch.name for launch in launches] == ["tile_counts"]
    assert launches[0].check() == 0.0
    want = tiling.exact_tile_counts_plain(proj)
    assert kernels.same_bits((mask, counts), want) == 0.0
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("img", [(1920, 1080), (3200, 1800)])
def test_tile_counts_kernel_matches_plain_on_random_scenes(img, cuda):
    """300,007 random splats (not a multiple of the kernel's block) seen
    from three poses between 6 and 18 units out: some splats pass 32 tiles,
    and many lie behind the camera or off screen (count 0)."""
    s = _random_splats(300_007, 11, cuda)
    seen_tail = False
    for k, radius in enumerate((6.0, 10.0, 18.0)):
        counts = _hold_counts(_project(s, _look_at(_orbit(k, 3, radius),
                                                   img), img, cuda))
        assert int((counts > 0).sum()) > 1000
        seen_tail |= bool((counts > 32).any())
    assert seen_tail


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["1m_1080p", "2m_1800p"])
def test_tile_counts_kernel_matches_plain_on_bench_scenes(scene, cuda):
    """The benchmark's scenes (the bench generator, 1M splats at 1920x1080
    and 2M at 3200x1800) at four poses of its orbit."""
    n, img = {"1m_1080p": (1_000_000, (1920, 1080)),
              "2m_1800p": (2_000_000, (3200, 1800))}[scene]
    s = bench_splats(n, sh_degree=0, seed=7, device=cuda)
    for k in (0, 31, 62, 93):
        counts = _hold_counts(_project(s, _look_at(_orbit(k, 120), img), img,
                                       cuda))
        assert int((counts > 0).sum()) > n // 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILE_COUNT_CASES)
def test_tile_counts_kernel_matches_plain_on_edge_rows(case, cuda):
    """The edge rows of tests/tile_count_rows.py (bbox counts 0-150, bbox
    widths 1 and 40-60, means on tile edges, zero denominators, non-finite
    conics on culled rows, every row dead; 1001 rows): bit for bit against
    the plain version on the card, and against the plain version on the
    CPU from the same threshold words, which tests/test_torch_render.py
    holds to the JAX package. Then the first 0, 1, 255 and 257 rows."""
    rows = {k: torch.from_numpy(v) for k, v in tile_count_rows(case).items()}
    host = (rows["mean2d"], rows["conic"],
            torch.log(torch.clamp_min(rows["opac"], 1e-30) * 255.0),
            rows["tile_min"], rows["tile_max"], rows["num_tiles_bbox"])
    dev = tuple(x.to(cuda) for x in host)
    assert _same(tile_counts_cuda.tile_counts, *dev) == 0.0
    got = tile_counts_cuda.tile_counts(*dev)
    want = tile_counts_cuda.tile_counts_plain(*host)
    assert kernels.same_bits(tuple(t.cpu() for t in got), want) == 0.0
    for m in (0, 1, 255, 257):
        got = tile_counts_cuda.tile_counts(*(x[:m] for x in dev))
        assert got[0].shape == (m,) and kernels.same_bits(
            tuple(t.cpu() for t in got),
            tile_counts_cuda.tile_counts_plain(*(x[:m] for x in host))) == 0.0
    with pytest.raises(ValueError, match="contiguous"):
        tile_counts_cuda.tile_counts(
            torch.zeros((2, 8), device=cuda).T, *(x[:8] for x in dev[1:]))


@pytest.mark.cuda
def test_tile_counts_kernel_replays_in_a_captured_graph(cuda):
    """`exact_tile_counts` (the threshold's operations and the kernel)
    captured once in a CUDA graph, then replayed on the rows of three
    poses copied into its inputs: each replay's mask and count equal the
    plain version's on those rows."""
    from brush_tpu_torch.ops import tiling
    img = (1920, 1080)
    s = _random_splats(100_003, 12, cuda)
    projs = [_project(s, _look_at(_orbit(k, 3, 10.0), img), img, cuda)
             for k in range(3)]
    names = ("mean2d", "conic", "opac", "tile_min", "tile_max",
             "num_tiles_bbox")
    static = dataclasses.replace(
        projs[0], **{f: getattr(projs[0], f).clone() for f in names})
    tiling.exact_tile_counts(static)          # builds the library
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tiling.exact_tile_counts(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tiling.exact_tile_counts(static)
    for p in projs[1:] + projs[:1]:
        for f in names:
            getattr(static, f).copy_(getattr(p, f))
        graph.replay()
        want = tiling.exact_tile_counts_plain(p)
        torch.cuda.synchronize()
        assert kernels.same_bits(out, want) == 0.0
    del graph


@pytest.mark.cuda
def test_frame_and_step_with_plain_tile_counts_equal_the_kernels(
        monkeypatch, cuda):
    """A forward frame and a training step on the card, with the counts
    from the kernel and then from the plain version (forced here alone, by
    patching `tiling.exact_tile_counts`): the frame, the step's loss and
    both renders' aux bit for bit; the state after the step within the
    backward's BWD_RTOL rule (`chip_smoke.hold_steps`), which two runs of
    the same step need too (its per-splat sums are f64 atomics)."""
    from chip_smoke import hold_steps
    from brush_tpu_torch.ops import tiling
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import train_step_impl
    state, views, rcfg, fwd, _, _ = _graph_case(cuda)
    params = tuple(state.splats.params().values())
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    tcfg = TrainConfig()

    def run():
        with kernels.capture() as launches:
            frame, aux = render(*params, views[0][0], bg, fwd)
            stepped, stats, s_aux = train_step_impl(
                _twin_state(state), views[1][1], tcfg, rcfg)
        torch.cuda.synchronize()
        return frame, aux, stepped, stats, s_aux, {x.name for x in launches}

    k_frame, k_aux, k_state, k_stats, k_saux, k_names = run()
    monkeypatch.setattr(tiling, "exact_tile_counts",
                        tiling.exact_tile_counts_plain)
    p_frame, p_aux, p_state, p_stats, p_saux, p_names = run()
    assert "tile_counts" in k_names and "tile_counts" not in p_names
    assert torch.equal(p_frame.view(torch.int32), k_frame.view(torch.int32))
    assert torch.equal(p_stats.loss.view(torch.int32),
                       k_stats.loss.view(torch.int32))
    for got, want in ((p_aux, k_aux), (p_saux, k_saux)):
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if torch.is_tensor(w):
                assert kernels.same_bits(g, w) == 0.0, f.name
    lrs = dict(means=tcfg.lr_mean * float(state.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    hold_steps(torch, p_state, k_state, lrs, 1)


def _slot_soas(spans, img, n, rng, gid=None):
    """Training and diet SoAs whose tile t holds spans[t] slots: splats of
    1.5-3 px near their tile, opacity 0.05-0.2 (a pixel sees tens of them
    before it saturates), colours with negative entries, splat ids drawn
    from [0, n) unless given. Returns (soa [16, L] f32, diet [8, L] int32,
    ranges [T, 2] int32, gid [S] int32), on the CPU."""
    tbw = -(-img[0] // 32)
    spans = np.asarray(spans, np.int64)
    starts = np.cumsum(spans) - spans
    s_len = int(spans.sum())
    width = s_len + 128
    tile = np.repeat(np.arange(len(spans)), spans)
    ox = (tile % tbw) * 32.0
    oy = (tile // tbw) * 32.0
    x = ox + rng.uniform(-4, 36, s_len)
    y = oy + rng.uniform(-4, 36, s_len)
    inv = 1.0 / rng.uniform(1.5, 3.0, s_len) ** 2
    rows = np.zeros((16, width), np.float32)
    rows[0, :s_len], rows[1, :s_len] = x, y
    rows[2, :s_len] = inv
    rows[3, :s_len] = rng.uniform(-0.2, 0.2, s_len) * inv
    rows[4, :s_len] = inv * rng.uniform(0.7, 1.4, s_len)
    rows[5, :s_len] = rng.uniform(0.05, 0.2, s_len)
    rows[6:9, :s_len] = rng.normal(0.4, 0.5, (3, s_len))
    if gid is None:
        gid = rng.integers(0, n, s_len)
    gid = np.asarray(gid, np.int32)
    rows[9, :s_len] = gid
    ranges = np.stack([starts, starts + spans], 1).astype(np.int32)
    soa, diet = _with_diet(torch.from_numpy(rows), ranges, tbw)
    return soa, diet, torch.from_numpy(ranges), torch.from_numpy(gid)


def _with_diet(soa, ranges, tbw):
    """(training SoA, its diet SoA: tile-relative centres, f16 pairs)."""
    width = soa.shape[1]
    origin = torch.zeros((2, width))
    for t, (a, b) in enumerate(ranges):
        origin[0, a:b] = (t % tbw) * 32.0
        origin[1, a:b] = (t // tbw) * 32.0
    diet = torch.zeros((8, width), dtype=torch.int32)
    diet[0] = (soa[0] - origin[0]).view(torch.int32)
    diet[1] = (soa[1] - origin[1]).view(torch.int32)
    diet[2] = _pack2f16(soa[2], soa[3])
    diet[3] = _pack2f16(soa[4], soa[5])
    diet[4] = _pack2f16(soa[6], soa[7])
    diet[5] = _pack2f16(soa[8], torch.zeros(width))
    return soa, diet


def _slot_case(case):
    """(soa, diet, ranges, gid, n, img) of one card case."""
    rng = np.random.default_rng(len(case))
    if case == "long_tile_among_short":
        img, n = (128, 96), 3000
        spans = rng.integers(5, 60, 12)
        spans[7] = 2500
        return (*_slot_soas(spans, img, n, rng), n, img)
    if case == "one_splat_in_every_tile":
        img, n = (1920, 1080), 5000
        spans = rng.integers(1, 12, 60 * 34)
        soa, _, ranges, gid = _slot_soas(spans, img, n, rng)
        first = ranges[:, 0].long()
        gid[first] = 0                     # the same splat first in each tile
        soa[0:9, first] = torch.tensor([960.0, 540.0, 1e-6, 0.0, 1e-6, 0.3,
                                        0.2, 0.5, 0.8])[:, None]
        soa[9, first] = 0.0
        return (*_with_diet(soa, ranges.numpy(), 60), ranges, gid, n, img)
    if case == "empty_and_unblended_tiles":
        img, n = (160, 96), 400
        spans = rng.integers(0, 80, 15)
        spans[[0, 4, 9]] = 0
        soa, _, ranges, gid = _slot_soas(spans, img, n, rng)
        for t in (2, 6):                   # every slot under the alpha gate
            a, b = ranges[t].tolist()
            soa[5, a:b] = 1e-3
        return (*_with_diet(soa, ranges.numpy(), 5), ranges, gid, n, img)
    if case == "nan_and_inf_conics":
        img, n = (96, 64), 50
        soa, _, ranges, gid = _slot_soas([90] * 6, img, n, rng)
        soa[2:5, torch.nonzero(gid == 5)[:, 0]] = float("nan")
        soa[2:5, torch.nonzero(gid == 6)[:, 0]] = float("inf")
        return (*_with_diet(soa, ranges.numpy(), 3), ranges, gid, n, img)
    if case == "single_splat":
        img, n = (64, 64), 1
        spans = [40, 0, 7, 300]
        return (*_slot_soas(spans, img, n, rng,
                            gid=np.zeros(sum(spans))), n, img)
    assert case == "dead_second_half"
    img, n = (256, 160), 2 ** 12              # ids only below n / 2
    spans = rng.integers(0, 200, 40)
    return (*_slot_soas(spans, img, n // 2, rng), n, img)


SLOT_CASES = ["long_tile_among_short", "one_splat_in_every_tile",
              "empty_and_unblended_tiles", "nan_and_inf_conics",
              "single_splat", "dead_second_half"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLOT_CASES)
def test_rasterizer_kernels_match_plain_on_built_slots(case, cuda):
    soa, diet, ranges, gid, n, img = _slot_case(case)
    soa, diet, ranges, gid = (x.to(cuda) for x in (soa, diet, ranges, gid))
    bg = torch.tensor([0.3, 0.2, 0.1], device=cuda)
    _same(rasterize_cuda.rasterize_forward, diet, ranges, bg, img)
    with kernels.capture() as launches:
        tiles, schedule = rasterize_cuda.rasterize_forward_train(soa, ranges,
                                                                 bg, img)
    launches[0].check()
    spans = (ranges[:, 1] - ranges[:, 0]).cpu()
    useful = tiles[:, 5, 0].cpu()
    v = np.random.default_rng(1).normal(0, 1, (img[1], img[0], 4))
    v_tiles = rasterize_cuda.image_to_tiles(
        torch.from_numpy(v.astype(np.float32)).to(cuda), img)
    args = (soa, ranges, tiles, v_tiles, bg, img, gid, n, schedule)
    # Twice: the per-splat sums add in atomic order.
    for _ in range(2):
        err = _same(rasterize_cuda.rasterize_backward_splats, *args)
        assert np.isfinite(err)
    got = rasterize_cuda.rasterize_backward_splats(*args).cpu()
    assert got.shape == (rasterize_cuda.GRAD_ROWS, n)
    assert bool(torch.isfinite(got).all())
    if case == "long_tile_among_short":
        assert int(useful[7]) >= 2000 and int(useful.max()) == int(useful[7])
    elif case == "one_splat_in_every_tile":
        assert float(got[10, 0]) > 100 * float(got[10, 1:].max())
    elif case == "empty_and_unblended_tiles":
        assert not useful[[0, 4, 9, 2, 6]].any() and spans[[2, 6]].all()
    elif case == "nan_and_inf_conics":
        assert not got[:, 5:7].any() and int(got[10].count_nonzero()) > 40
    elif case == "single_splat":
        assert got[10, 0] > 0
    else:
        assert not got[:, n // 2:].any() and got[10, :n // 2].any()


# --------------------------------------------------------------------------
# the dataset-to-PLY run on the card
# --------------------------------------------------------------------------


def _card_scene(root):
    """A 32x32 COLMAP scene of 4 views (one held out) and an init.ply of
    160 splats in front of them, written with chip_smoke's writer."""
    from chip_smoke import write_colmap_scene
    from brush_tpu_torch.camera import Pinhole, focal_to_fov
    from brush_tpu_torch.io import ply
    rng = np.random.default_rng(12)
    cams = [Camera(position=np.array([-0.1 * i, 0.0, 4.0]),
                   rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                   fov_x=focal_to_fov(50.0, 32, Pinhole()),
                   fov_y=focal_to_fov(50.0, 32, Pinhole()))
            for i in range(4)]
    pngs = [rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
            for _ in cams]
    write_colmap_scene(str(root), cams, 50.0, pngs)
    n = 160
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            rng.uniform(7.0, 10.0, (n, 1))], 1)
    splats = from_raw(
        means.astype(np.float32),
        np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
        rng.normal(0, 1, (n, 4)).astype(np.float32),
        rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        rng.normal(0.5, 1.0, n).astype(np.float32), device="cpu")
    (root / "init.ply").write_bytes(ply.splats_to_ply_bytes(splats))


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_process_on_the_card_matches_the_cpu(tmp_path, monkeypatch,
                                                   use_pallas, cuda):
    """`train_process` on `cuda` (the kernels, or the plain rasterizer)
    against the same run on the CPU (the plain versions), noise and refine
    off, one loader thread: per-step losses within 1e-3 relative, eval
    PSNR within 0.05 dB, exported parameters within 2 * lr * steps + 1e-5
    (the rule the CPU run meets against the JAX package,
    tests/test_torch_process.py)."""
    import functools

    from brush_tpu_torch import process
    from brush_tpu_torch.data import dataloader
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.train.config import TrainConfig
    _card_scene(tmp_path / "scene")
    monkeypatch.setattr(process, "SceneLoader", functools.partial(
        dataloader.SceneLoader, n_threads=1))
    steps = 6
    tcfg = TrainConfig(total_train_iters=steps, refine_every=1000,
                       background_noise_strength=0.0, mean_noise_weight=0.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        pcfg = process.ProcessConfig(
            eval_every=steps, export_every=0, log_every=1, init_count=0,
            sh_degree=1, use_pallas=use_pallas,
            export_path=str(tmp_path / f"{dev}_{{iter}}.ply"))
        msgs = list(process.train_process(
            str(tmp_path / "scene"), tcfg,
            LoadConfig(max_resolution=32, eval_split_every=4), pcfg,
            device=dev))
        runs[dev] = (
            [m.data["loss"] for m in msgs if m.kind == "step"],
            [m.data["psnr"] for m in msgs if m.kind == "eval"],
            ply.load_splat_ply(str(tmp_path / f"{dev}_{steps}.ply")))
    (l_c, p_c, d_c), (l_g, p_g, d_g) = runs["cpu"], runs["cuda"]
    assert len(l_g) == steps and np.isfinite(l_g).all()
    np.testing.assert_allclose(l_g, l_c, rtol=1e-3)
    assert abs(p_g[0] - p_c[0]) <= 0.05, (p_g, p_c)
    t = TrainConfig()
    for name, lr in (("means", t.lr_mean * 3.0), ("log_scales", t.lr_scale),
                     ("rotations", t.lr_rotation),
                     ("sh_coeffs", t.lr_coeffs_dc),
                     ("raw_opacities", t.lr_opac)):
        g, c = getattr(d_g, name), getattr(d_c, name)
        assert np.abs(g - c).max() <= 2 * lr * steps + 1e-5, name


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_cuda_generator(tmp_path, cuda):
    """The generator of a state on the card is saved and restored into a
    generator on the card: the draws after a load are the draws the saved
    generator makes next."""
    from brush_tpu_torch.train import checkpoint
    from brush_tpu_torch.train.trainer import init_train_state
    splats = bench_splats(300, sh_degree=1, seed=3, device=cuda)
    state = init_train_state(splats, 5)
    assert state.rng.device.type == "cuda"
    torch.rand(1000, generator=state.rng, device=cuda)
    checkpoint.save_checkpoint(tmp_path / "ck", state, iteration=9)
    restored = checkpoint.load_checkpoint(tmp_path / "ck",
                                          init_train_state(splats, 0))
    assert restored.rng.device.type == "cuda"
    assert restored.splats.means.device.type == "cuda"
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert torch.equal(torch.randn(64, generator=restored.rng, device=cuda),
                       torch.randn(64, generator=state.rng, device=cuda))
    for name, st in state.opt.items():
        assert torch.equal(restored.opt[name].moment1, st.moment1), name
    assert checkpoint.checkpoint_meta(tmp_path / "ck")["iteration"] == 9


@pytest.mark.cuda
def test_pinned_upload_keeps_each_array(cuda):
    """`PinnedUpload` reuses its two staging buffers a shape: every upload
    still arrives whole, behind queued work and while earlier ones are in
    use."""
    from brush_tpu_torch.process import PinnedUpload
    up = PinnedUpload(cuda)
    rng = np.random.default_rng(0)
    arrays = [rng.integers(-2**31, 2**31 - 1, (1080, 1920), dtype=np.int32)
              for _ in range(5)] + [rng.normal(size=23).astype(np.float32)]
    got = []
    for a in arrays:
        torch.cuda._sleep(20_000_000)
        got.append(up(a))
    for a, g in zip(arrays, got):
        assert g.device.type == "cuda" and g.dtype == torch.from_numpy(a).dtype
        assert torch.equal(g.cpu(), torch.from_numpy(a))


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True])
def test_batched_step_on_the_card_matches_the_cpu(use_pallas, cuda):
    """`train_step_impl(batched=True)` over two stacked views on the card
    against the same step on the CPU (noise off): loss within 1e-4
    relative, the binning counts equal, every parameter within 2 * lr of
    the CPU's (an Adam step moves it by about lr at most)."""
    from brush_tpu_torch.ops.loss import pack_gt
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import (
        SceneBatch, init_train_state, stack_batches, train_step_impl)
    img = (96, 64)
    tcfg = TrainConfig(background_noise_strength=0.0, mean_noise_weight=0.0)
    cams = [Camera(position=np.array([x, 0.0, -18.0]),
                   rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                   fov_x=1.0, fov_y=0.7) for x in (0.0, 0.8)]
    out = {}
    for dev in ("cpu", "cuda"):
        truth = bench_splats(1500, sh_degree=1, seed=5, device=dev)
        splats = bench_splats(1500, sh_degree=1, seed=6, device=dev)
        rcfg = RenderConfig(img_size=img, sh_degree=1, isect_cap=1 << 14,
                            use_pallas=use_pallas)
        views = []
        for cam in cams:
            ci = camera_inputs(cam, img, device=dev)
            with torch.no_grad():
                gt, _ = render(*truth.params().values(), ci,
                               torch.zeros(3, device=dev), rcfg)
            views.append(SceneBatch(gt_packed=pack_gt(gt[..., :3]), cam=ci))
        state = init_train_state(splats, 0)
        new, stats, aux = train_step_impl(state, stack_batches(views), tcfg,
                                          rcfg, batched=True)
        out[dev] = (new, float(stats.loss), int(aux.num_isects))
    (s_c, l_c, n_c), (s_g, l_g, n_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c) and n_g == n_c
    lrs = dict(means=tcfg.lr_mean * float(s_c.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    for name, lr in lrs.items():
        g = getattr(s_g.splats, name).cpu()
        c = getattr(s_c.splats, name)
        assert torch.isfinite(g).all(), name
        assert (g - c).abs().max() <= 2 * lr + 1e-6, name
    assert float(s_g.refine.visible_count.max()) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [True, False])
def test_viewer_frame_on_the_card_matches_the_cpu(tmp_path, use_pallas,
                                                  cuda):
    """`ViewerState.render_pose` of one PLY on `cuda` (the kernels, or the
    plain rasterizer) against the CPU's frame, for the orbit pose and a
    quaternion pose with splat scale and background: the uint8 rule of
    tests/test_torch_viewer.py (p99.9 of the level difference <= 1, max
    <= 2). The HTTP server renders the same frame on the card."""
    import io
    import urllib.request

    from PIL import Image

    from brush_tpu_torch.io import ply
    from brush_tpu_torch.viewer.service import (
        Slot, ViewerState, load_source_into_slot, serve)
    (tmp_path / "scene.ply").write_bytes(ply.splats_to_ply_bytes(
        bench_splats(3000, sh_degree=1, seed=9, device="cpu")))
    poses = [([0.0, 1.0, -18.0], {}),
             ([1.0, 0.0, -17.0], dict(quat=(0.9961947, 0.0, -0.0871557, 0.0),
                                      fov_y=0.7, splat_scale=1.5,
                                      bg=(0.2, 0.5, 0.9)))]
    frames = {}
    for dev in ("cpu", "cuda"):
        slot = Slot()
        load_source_into_slot(str(tmp_path / "scene.ply"), slot,
                              sh_degree=1, device=dev)
        state = ViewerState(slot, 1, use_pallas=use_pallas, device=dev)
        frames[dev] = [state.render_pose(p, 0.0, 0.0, 160, 96, 0, **kw)
                       for p, kw in poses]
    for name, got, want in zip(("orbit", "quat"), frames["cuda"],
                               frames["cpu"]):
        assert got.shape == want.shape == (96, 160, 3) and want.max() > 20
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert np.quantile(d, 0.999) <= 1 and d.max() <= 2, (name, d.max())
    server = serve(str(tmp_path / "scene.ply"), host="127.0.0.1", port=0,
                   sh_degree=1, use_pallas=use_pallas, blocking=False,
                   device="cuda")
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.server_address[1]}/render?px=0&py=1"
            f"&pz=-18&w=160&h=96", timeout=300).read()
        frame = server.viewer_state.render_pose(poses[0][0], 0.0, 0.0, 160,
                                                96, 0)
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, "JPEG", quality=88)
        assert body == buf.getvalue()
        np.testing.assert_array_equal(frame, frames["cuda"][0])
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.cuda
def test_lpips_on_the_card_matches_the_cpu(cuda):
    """LPIPS of two 128x128 images, its five VGG taps and its gradient
    w.r.t. the first on the card against the CPU: the value within 1e-6
    relative (about 9 float32 ulps), each tap and the gradient within 1e-4
    of its largest entry.
    The model's convolutions run in float32 whatever the global TF32
    switch says; with TF32 allowed the taps miss their bar."""
    from brush_tpu_torch.models.lpips import random_lpips
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
            for _ in range(2))
    out = {}
    for dev in ("cpu", "cuda"):
        m = random_lpips(0, device=dev)
        x = torch.from_numpy(a).to(dev).requires_grad_(True)
        v = m(x, torch.from_numpy(b).to(dev))
        (g,) = torch.autograd.grad(v, x)
        with torch.no_grad():
            taps = [t.cpu() for t in m.features(x)]
        out[dev] = (float(v.detach()), g.cpu().numpy(), taps, m)
    (v_c, g_c, t_c, _), (v_g, g_g, t_g, m) = out["cpu"], out["cuda"]

    def tap_err(taps):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(taps, t_c))

    assert abs(v_g - v_c) <= 1e-6 * v_c, (v_g, v_c)
    assert tap_err(t_g) <= 1e-4
    assert np.abs(g_g - g_c).max() <= 1e-4 * np.abs(g_c).max()
    x = torch.from_numpy(a).cuda()
    torch.backends.cudnn.allow_tf32 = True      # the global switch alone
    try:
        with torch.no_grad():
            global_taps = [t.cpu() for t in m.features(x)]
            m.allow_tf32 = True
            tf32_taps = [t.cpu() for t in m.features(x)]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        m.allow_tf32 = False
    assert tap_err(global_taps) <= 1e-4
    assert tap_err(tf32_taps) > 1e-4, tap_err(tf32_taps)


@pytest.mark.cuda
def test_c_abi_trains_on_the_card(tmp_path, cuda):
    """`brush_train_and_save` with {"device": "cuda"} for 2 steps of a
    32x32 scene: step and export messages, the export written."""
    import ctypes
    import json

    from brush_tpu_torch.native import build as native
    _card_scene(tmp_path / "scene")
    lib = ctypes.CDLL(str(native.build_ffi(verbose=False)))
    cb_type = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p,
                               ctypes.c_void_p)
    lib.brush_train_and_save.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         cb_type, ctypes.c_void_p]
    lib.brush_last_error.restype = ctypes.c_char_p
    msgs = []

    @cb_type
    def cb(payload, user_data):
        msgs.append(json.loads(payload.decode()))
        return 0

    opts = dict(device="cuda", total_train_iters=2, log_every=1,
                eval_every=0, export_every=0, init_count=0, sh_degree=1,
                max_resolution=32, export_path=str(tmp_path / "c_{iter}.ply"))
    kernels.reset_launches()
    rc = lib.brush_train_and_save(str(tmp_path / "scene").encode(),
                                  json.dumps(opts).encode(), cb, None)
    assert rc == 0, lib.brush_last_error().decode()
    assert [m["iter"] for m in msgs if m["kind"] == "step"] == [1, 2]
    assert "export" in {m["kind"] for m in msgs}
    assert (tmp_path / "c_2.ply").exists()
    for name in kernels.TRAIN_PATH:
        assert kernels.LAUNCHES[name] > 0, name


def _dp_card_scene(dev, n_views=2, img=(96, 64)):
    """Two views of a 1,500-splat scene on `dev`, ground truth rendered
    from a second scene: (state, stacked batch, RenderConfig)."""
    from brush_tpu_torch.ops.loss import pack_gt
    from brush_tpu_torch.train.trainer import (
        SceneBatch, init_train_state, stack_batches)
    truth = bench_splats(1500, sh_degree=1, seed=5, device=dev)
    splats = bench_splats(1500, sh_degree=1, seed=6, device=dev)
    rcfg = RenderConfig(img_size=img, sh_degree=1, isect_cap=1 << 14,
                        use_pallas=True)
    views = []
    for x in np.linspace(0.0, 0.8, n_views):
        ci = camera_inputs(Camera(position=np.array([x, 0.0, -18.0]),
                                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                                  fov_x=1.0, fov_y=0.7), img, device=dev)
        with torch.no_grad():
            gt, _ = render(*truth.params().values(), ci,
                           torch.zeros(3, device=dev), rcfg)
        views.append(SceneBatch(gt_packed=pack_gt(gt[..., :3]), cam=ci))
    return init_train_state(splats, 0), stack_batches(views), rcfg


@pytest.mark.cuda
def test_dp_step_over_a_world_1_nccl_group_matches_the_batched_step(
        tmp_path, cuda):
    """`make_dp_train_step` over a one-process NCCL group (its all_reduces
    run on the card) against `train_step_impl(batched=True)` from the same
    state and generator: loss within 1e-5 relative; first moments within
    1e-5 of each array's largest, second moments within 2e-5 (the
    backward's per-splat sums are not bit-repeatable on the card,
    `BWD_RTOL`); every parameter within 2 * lr (an Adam step moves it by
    about lr at most); the refine record within 1e-5 of its largest."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from brush_tpu_torch.parallel.data_parallel import make_dp_train_step
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import train_step_impl
    state, batch, rcfg = _dp_card_scene(cuda)
    tcfg = TrainConfig()
    rng = torch.Generator(device=cuda)
    rng.set_state(state.rng.get_state())
    twin = dataclasses.replace(state, rng=rng)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got, g_stats, _ = make_dp_train_step(dist.group.WORLD, tcfg,
                                             rcfg)(state, batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    want, w_stats, _ = train_step_impl(twin, batch, tcfg, rcfg,
                                       batched=True)
    assert abs(float(g_stats.loss) - float(w_stats.loss)) <= 1e-5 * abs(
        float(w_stats.loss))
    assert torch.equal(got.rng.get_state(), want.rng.get_state())
    lrs = dict(means=float(w_stats.lr_mean), log_scales=tcfg.lr_scale,
               quats=tcfg.lr_rotation, sh_coeffs=tcfg.lr_coeffs_dc,
               raw_opacities=tcfg.lr_opac)
    for name, lr in lrs.items():
        g, w = getattr(got.splats, name), getattr(want.splats, name)
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 2 * lr + 1e-6, name
        for which, rtol in (("moment1", 1e-5), ("moment2", 2e-5)):
            a = getattr(got.opt[name], which)
            b = getattr(want.opt[name], which)
            assert float((a - b).abs().max()) <= rtol * float(
                b.abs().max()), (name, which)
    for name in ("refine_weight", "visible_count", "max_radius"):
        a, b = getattr(got.refine, name), getattr(want.refine, name)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


@pytest.mark.cuda
def test_space_parallel_render_over_two_processes_on_one_card(tmp_path,
                                                              cuda):
    """`render_space_parallel` over two gloo processes sharing the card
    (tests/torch_parallel_ranks.py), the strips assembled by an
    all_reduce of CUDA tensors, against the full render on the card, by
    the port's image rule (p99.9 <= 1e-4, max <= 2/255). The scene's
    depths lie 0.01 apart, so no two depth keys tie: where they tie a
    strip may blend them in another order (tests/test_torch_parallel.py)."""
    # tests/ is on sys.path (pytest's import of this file puts it there).
    from torch_parallel_ranks import run_ranks
    rng = np.random.default_rng(0)
    n = 3000
    arrays = (np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                        2.0 + 0.01 * rng.permutation(n)], -1).astype(
                            np.float32),
              np.full((n, 3), np.log(0.15), np.float32),
              np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
              rng.uniform(0, 1, (n, 1, 3)).astype(np.float32),
              np.full(n, 2.0, np.float32))
    cam = Camera(position=np.zeros(3), rotation=np.array([1.0, 0, 0, 0]),
                 fov_x=0.9, fov_y=0.9)
    img = (256, 256)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    rcfg = RenderConfig(img_size=img, sh_degree=0, isect_cap=1 << 16,
                        use_pallas=True, forward_only=True)
    ranks = run_ranks(tmp_path, 2, [dict(
        kind="strip", device="cuda", splats=from_raw(*arrays, device="cpu"),
        cam=cam, bg=bg, rcfg=rcfg)])
    got = [r[0] for r in ranks]
    assert torch.equal(got[0], got[1])
    s = from_raw(*arrays, device=cuda)
    with torch.no_grad():
        want, aux = render(*s.params().values(),
                           camera_inputs(cam, img, device=cuda),
                           torch.from_numpy(bg).to(cuda), rcfg)
    assert int(aux.num_isects) <= rcfg.isect_cap
    d = (got[0] - want.cpu()).abs()
    assert float(want[..., 3].mean()) > 0.5
    assert float(torch.quantile(d.flatten(), 0.999)) <= 1e-4
    assert float(d.max()) <= 2.0 / 255.0


# --------------------------------------------------------------------------
# the compiled, donated step and frame (graphs.py)
# --------------------------------------------------------------------------


def _graph_case(dev, fisheye=False, model=None):
    """1,500 splats at 96x64 over two views with a rendered ground truth:
    (splat state seeded 3, [(CameraInputs, SceneBatch)], training and
    forward-only RenderConfigs, the view centres and focals). `fisheye`:
    the views a KannalaBrandt4 lens (or `model`) of a 2.2 rad field,
    nearer."""
    import projection_rows
    from brush_tpu_torch.camera import KannalaBrandt4, Pinhole
    from brush_tpu_torch.ops.loss import pack_gt
    from brush_tpu_torch.train.trainer import SceneBatch, init_train_state
    img = (96, 64)
    model = model or (KannalaBrandt4(*projection_rows.KB4) if fisheye
                      else Pinhole())
    rcfg = RenderConfig(img_size=img, sh_degree=1, model=model,
                        isect_cap=1 << 14, use_pallas=True)
    fwd = dataclasses.replace(rcfg, forward_only=True)
    truth = bench_splats(1500, sh_degree=1, seed=5, device=dev)
    fov, z = ((2.2, 1.5), -9.0) if fisheye else ((1.0, 0.7), -18.0)
    cams = [Camera(position=np.array([x, 0.0, z]),
                   rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                   fov_x=fov[0], fov_y=fov[1], model=model)
            for x in (0.0, 0.8)]
    views = []
    for cam in cams:
        ci = camera_inputs(cam, img, device=dev)
        gt, _ = render(*truth.params().values(), ci,
                       torch.zeros(3, device=dev), fwd)
        views.append((ci, SceneBatch(gt_packed=pack_gt(gt[..., :3]),
                                     cam=ci)))
    state = init_train_state(bench_splats(1500, sh_degree=1, seed=6,
                                          device=dev), 3)
    centers = torch.tensor(np.stack([c.position for c in cams]),
                           dtype=torch.float32, device=dev)
    focals = torch.tensor([c.focal(img)[0] for c in cams],
                          dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    return state, views, rcfg, fwd, centers, focals


def _twin_state(state):
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    return dataclasses.replace(state, rng=rng)


@pytest.mark.cuda
def test_frame_step_and_loop_turn_do_not_synchronise(cuda):
    """A warmed-up render (diet and training configurations), one
    `train_step_impl` (also of splats with a 3D filter floor, which a
    refine attaches) and one `loop_step` turn (its first: the overflow
    read one step behind comes a turn later) under sync debug mode
    "error": no copy from pageable memory, no read back."""
    from brush_tpu_torch.process import LoopState, loop_step
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import train_step_impl
    state, views, rcfg, fwd, centers, focals = _graph_case(cuda)
    ci, batch = views[0]
    args = (*state.splats.params().values(), ci, torch.zeros(3, device=cuda))
    tcfg = TrainConfig()
    floored = dataclasses.replace(state, splats=dataclasses.replace(
        state.splats, min_scale=torch.full((state.splats.capacity,), 0.01,
                                           device=cuda)))
    render(*args, fwd)
    render(*args, rcfg)
    train_step_impl(_twin_state(state), batch, tcfg, rcfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render(*args, fwd)
        render(*args, rcfg)
        train_step_impl(_twin_state(state), batch, tcfg, rcfg)
        train_step_impl(_twin_state(floored), batch, tcfg, rcfg)
        loop_step(LoopState(state=_twin_state(state), rcfg=rcfg), batch,
                  tcfg, centers, focals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_render_graph_frame_equals_the_eager_frame(cuda):
    """A RenderGraph's frames of two views, twice each, equal eager
    `render` bit for bit, and so do its aux counts; replays do not
    synchronise."""
    from brush_tpu_torch import graphs
    state, views, _, fwd, _, _ = _graph_case(cuda)
    params = tuple(state.splats.params().values())
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    graph = graphs.RenderGraph(fwd, params[0].shape[0])
    for ci, _ in views * 2:
        want, w_aux = render(*params, ci, bg, fwd)
        got, aux = graph(*params, ci, bg)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert int(aux.num_isects) == int(w_aux.num_isects)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph(*params, views[1][0], bg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "lpips", "batched", "kb4"])
def test_step_graph_steps_match_eager_steps(kind, cuda):
    """3 steps on StepGraphs (the warm-up step, then 2 replays) against 3
    eager `train_step_impl` steps from the same state and generator, plain,
    with the LPIPS term (weight 0.5, `random_lpips`), over two stacked
    views (`batched=True`) or through a KannalaBrandt4 lens: losses and every state tensor within the
    backward's BWD_RTOL rule (`chip_smoke.hold_steps`), the generator's
    state equal, one capture; the donated state is the graph's own, and
    the copied-out aux of a step survives the next. With LPIPS the rule's
    relative part is `LPIPS_TAP_RTOL` (1e-4), the rule of the card's LPIPS
    image gradient against the CPU's: that gradient comes from cuDNN's
    backward-data convolutions, which sum in an order of their own, and a
    second eager run is held to the same rule."""
    from chip_smoke import LPIPS_TAP_RTOL, hold_steps
    from brush_tpu_torch import graphs
    from brush_tpu_torch.models.lpips import random_lpips
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import stack_batches, train_step_impl
    from brush_tpu_torch.utils import tracing
    state, views, rcfg, _, _, _ = _graph_case(cuda, fisheye=kind == "kb4")
    tcfg, kw = TrainConfig(), {}
    batches = [views[k % 2][1] for k in range(3)]
    if kind == "lpips":
        tcfg = TrainConfig(lpips_loss_weight=0.5)
        kw = dict(lpips_model=random_lpips(0, device=cuda))
    elif kind == "batched":
        kw = dict(batched=True)
        batches = [stack_batches([views[k % 2][1], views[(k + 1) % 2][1]])
                   for k in range(3)]
    rtol = LPIPS_TAP_RTOL if kind == "lpips" else rasterize_cuda.BWD_RTOL
    steps = graphs.StepGraphs(tcfg, **kw)
    eager, again, graphed = (_twin_state(state) for _ in range(3))
    auxes = []
    with tracing.record_stages() as rec:
        for batch in batches:
            eager, e_stats, e_aux = train_step_impl(eager, batch, tcfg, rcfg,
                                                    **kw)
            again, _, _ = train_step_impl(again, batch, tcfg, rcfg, **kw)
            graphed, g_stats, g_aux = steps(graphed, batch, rcfg)
            assert graphed is steps.graph.state
            auxes.append((g_aux, e_aux))
            assert abs(float(g_stats.loss) - float(e_stats.loss)) <= (
                rtol * abs(float(e_stats.loss)))
        c = rec.snapshot()["counters"]
    # Every lens here projects on the kernels, KB4 too.
    assert c["project.route.cuda"] >= 3 and "project.route.torch" not in c
    for g_aux, e_aux in auxes:
        assert int(g_aux.num_isects) == int(e_aux.num_isects)
        assert torch.equal(g_aux.max_radius, e_aux.max_radius) or float(
            (g_aux.max_radius - e_aux.max_radius).abs().max()) <= (
                rtol * float(e_aux.max_radius.max()))
    lrs = dict(means=tcfg.lr_mean * float(state.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    for name, run in (("eager again", again), ("graphed", graphed)):
        d = hold_steps(torch, run, eager, lrs, 3, rtol=rtol)
        print(f"{kind}: {name} against eager, largest |d| by path:",
              {k: v for k, v in d.items() if v})
    assert torch.equal(graphed.rng.get_state(), eager.rng.get_state())
    assert steps.captures == 1 and int(graphed.step) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lpips", "batched"])
def test_train_process_with_lpips_or_batches_on_graphs_matches_eager(
        tmp_path, monkeypatch, kind, cuda):
    """`train_process` on the card with LPIPS weights (`pcfg.lpips_weights`,
    weight 0.5) or with `views_per_batch=2`, its steps on StepGraphs (one
    capture), against the same run with the steps eager (no StepGraphs),
    noise and refine off, one loader thread: per-step losses within 1e-3
    relative, eval PSNR within 0.05 dB, exported parameters within
    2 * lr * steps + 1e-5 (the rule of the card run against the CPU's,
    `test_train_process_on_the_card_matches_the_cpu`)."""
    import functools

    from brush_tpu_torch import graphs, process
    from brush_tpu_torch.data import dataloader
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.models.lpips import (
        random_lpips_arrays, save_lpips_npz)
    from brush_tpu_torch.train.config import TrainConfig
    _card_scene(tmp_path / "scene")
    monkeypatch.setattr(process, "SceneLoader", functools.partial(
        dataloader.SceneLoader, n_threads=1))
    steps = 6
    tcfg = TrainConfig(total_train_iters=steps, refine_every=1000,
                       background_noise_strength=0.0, mean_noise_weight=0.0)
    if kind == "lpips":
        save_lpips_npz(random_lpips_arrays(0), tmp_path / "lpips.npz")
        extra = dict(lpips_weights=str(tmp_path / "lpips.npz"))
        tcfg = dataclasses.replace(tcfg, lpips_loss_weight=0.5)
    else:
        extra = dict(views_per_batch=2)
    made = []

    def spy(*args, **kw):
        made.append(graphs.StepGraphs(*args, **kw))
        return made[-1]

    runs = {}
    for mode in ("graphs", "eager"):
        monkeypatch.setattr(process, "StepGraphs", spy if mode == "graphs"
                            else lambda *args, **kw: None)
        pcfg = process.ProcessConfig(
            eval_every=steps, export_every=0, log_every=1, init_count=0,
            sh_degree=1, use_pallas=True,
            export_path=str(tmp_path / f"{mode}_{{iter}}.ply"), **extra)
        msgs = list(process.train_process(
            str(tmp_path / "scene"), tcfg,
            LoadConfig(max_resolution=32, eval_split_every=4), pcfg,
            device="cuda"))
        runs[mode] = (
            [m.data["loss"] for m in msgs if m.kind == "step"],
            [m.data["psnr"] for m in msgs if m.kind == "eval"],
            ply.load_splat_ply(str(tmp_path / f"{mode}_{steps}.ply")))
    assert len(made) == 1 and made[0].captures == 1
    assert made[0].batched == (kind == "batched")
    assert (made[0].lpips_model is not None) == (kind == "lpips")
    (l_g, p_g, d_g), (l_e, p_e, d_e) = runs["graphs"], runs["eager"]
    assert len(l_g) == steps and np.isfinite(l_g).all()
    np.testing.assert_allclose(l_g, l_e, rtol=1e-3)
    assert abs(p_g[0] - p_e[0]) <= 0.05, (p_g, p_e)
    t = TrainConfig()
    for name, lr in (("means", t.lr_mean * 3.0), ("log_scales", t.lr_scale),
                     ("rotations", t.lr_rotation),
                     ("sh_coeffs", t.lr_coeffs_dc),
                     ("raw_opacities", t.lr_opac)):
        g, e = getattr(d_g, name), getattr(d_e, name)
        assert np.abs(g - e).max() <= 2 * lr * steps + 1e-5, name


@pytest.mark.cuda
def test_freeing_graphs_waits_for_a_capture_on_another_thread(cuda):
    """While this thread captures six RenderGraphs, another evicts graphs
    from a cache of its own in a loop (each eviction frees pools, which
    synchronises the device, something a capture refuses): every capture
    succeeds and its frame equals the eager frame bit for bit."""
    import threading

    from brush_tpu_torch import graphs
    state, views, _, fwd, _, _ = _graph_case(cuda)
    params = tuple(state.splats.params().values())
    n = params[0].shape[0]
    bg = torch.zeros(3, device=cuda)
    other = graphs.RenderGraphs(1)
    keys = [fwd, dataclasses.replace(fwd, isect_cap=fwd.isect_cap * 2)]
    stop, errors, evictions = threading.Event(), [], [0]

    def evict():
        try:
            while not stop.is_set():
                other.get(render, keys[evictions[0] % 2], n)
                evictions[0] += 1
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)

    thread = threading.Thread(target=evict)
    thread.start()
    try:
        for k in range(6):
            ci = views[k % 2][0]
            got, _ = graphs.RenderGraph(fwd, n)(*params, ci, bg)
            want, _ = render(*params, ci, bg, fwd)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    finally:
        stop.set()
        thread.join()
    assert not errors, errors
    assert evictions[0] > 6


# --------------------------------------------------------------------------
# the refine, the DP step, the scoring views and the strips on graphs
# --------------------------------------------------------------------------


def _nccl_world_1(path):
    import datetime

    import torch.distributed as dist
    dist.init_process_group(
        "nccl", init_method=f"file://{path}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    return dist.group.WORLD


def _same_state_bits(a, b):
    from brush_tpu_torch import graphs
    la = graphs._leaves(dataclasses.replace(a, rng=None))
    lb = graphs._leaves(dataclasses.replace(b, rng=None))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            xi = x.view(torch.int32) if x.dtype == torch.float32 else x
            yi = y.view(torch.int32) if y.dtype == torch.float32 else y
            assert torch.equal(xi, yi), path
        else:
            assert x == y, path
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def _donated_copy(state):
    from brush_tpu_torch import graphs
    return dataclasses.replace(graphs.copy_out(dataclasses.replace(
        state, rng=None)), rng=_twin_state(state).rng)


@pytest.mark.cuda
def test_refine_graph_equals_the_eager_refine(cuda):
    """Two steps, then a refine of a state whose first 100 splats are too
    faint to live (pruned, so the refine resamples): the RefineGraph's
    first call (warm-up and capture), then two replays from copies of the
    same state, each equal to the eager `refine_step` bit for bit, the
    statistics and the generator's state too; the replays do not
    synchronise, and the refined state is the graph's own."""
    from brush_tpu_torch import graphs
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.refine import refine_step
    from brush_tpu_torch.train.trainer import train_step_impl
    state, views, rcfg, _, centers, focals = _graph_case(cuda)
    tcfg = TrainConfig(refine_every=2)
    for _, batch in views:
        state, _, _ = train_step_impl(state, batch, tcfg, rcfg)
    raw = state.splats.raw_opacities.clone()
    raw[:100] = -12.0
    state = dataclasses.replace(state, splats=dataclasses.replace(
        state.splats, raw_opacities=raw))
    want, w_stats = refine_step(_twin_state(state), tcfg, centers, focals)
    assert int(w_stats.num_resampled) > 0
    refines = graphs.RefineGraphs(tcfg)
    for k in range(3):
        torch.cuda.synchronize()
        if k == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got, g_stats = refines(_donated_copy(state), centers, focals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        _same_state_bits(got, want)
        for name in w_stats._fields:
            assert int(getattr(g_stats, name)) == int(
                getattr(w_stats, name)), name
        assert got.splats.means is refines.graph.state.splats.means
    assert refines.captures == 1


@pytest.mark.cuda
def test_dp_step_graph_over_nccl_matches_the_eager_dp_step(tmp_path, cuda):
    """`make_dp_train_step` over a one-process NCCL group runs on a
    StepGraph (the all_reduces captured): 3 steps held to 3 eager DP steps
    (`train_step_impl` with the same share) and to 3 steps of the graphed
    batched step by the backward's BWD_RTOL rule (`chip_smoke.hold_steps`),
    the generator equal, one capture."""
    import torch.distributed as dist

    from chip_smoke import hold_steps
    from brush_tpu_torch import graphs
    from brush_tpu_torch.parallel.data_parallel import (
        make_dp_train_step, view_share)
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import train_step_impl
    state, batch, rcfg = _dp_card_scene(cuda)
    tcfg = TrainConfig()
    group = _nccl_world_1(tmp_path / "store")
    try:
        step = make_dp_train_step(group, tcfg, rcfg)
        assert step.graphs is not None
        share = view_share(group, 2)
        eager, graphed = _twin_state(state), _donated_copy(state)
        for _ in range(3):
            eager, e_stats, _ = train_step_impl(eager, batch, tcfg, rcfg,
                                                batched=True, share=share)
            graphed, g_stats, _ = step(graphed, batch)
            assert abs(float(g_stats.loss) - float(e_stats.loss)) <= (
                rasterize_cuda.BWD_RTOL * abs(float(e_stats.loss)))
        torch.cuda.synchronize()
        assert step.graphs.captures == 1
        assert step.graphs.key.backend == "nccl"
        step.graphs.clear()
    finally:
        dist.destroy_process_group()
    batched, steps = _donated_copy(state), graphs.StepGraphs(tcfg,
                                                             batched=True)
    for _ in range(3):
        batched, _, _ = steps(batched, batch, rcfg)
    lrs = dict(means=tcfg.lr_mean * float(state.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    for what, want in (("eager dp", eager), ("graphed batched", batched)):
        d = hold_steps(torch, graphed, want, lrs, 3)
        print(f"graphed dp against {what}, largest |d| by path:",
              {k: v for k, v in d.items() if v})
        assert torch.equal(graphed.rng.get_state(), want.rng.get_state())


def _eager(monkeypatch):
    """Every program eager in the block: no graph is capturable."""
    from brush_tpu_torch import graphs
    monkeypatch.setattr(graphs, "capturable", lambda *a, **k: False)


@pytest.mark.cuda
def test_pup_scoring_views_on_graphs_match_eager(cuda, monkeypatch):
    """`pup_hessians` over two views on the card: the Hutchinson views on
    a graph (captured at the first, replayed for the second) against the
    eager views from the same seed, within 2 * BWD_RTOL of the largest
    entry (a product of two per-splat gradients); the exact mode's
    columns on a graph equal the eager ones bit for bit."""
    from brush_tpu_torch.train import lod
    state, views, _, _, _, _ = _graph_case(cuda)
    rcfg = RenderConfig(img_size=(96, 64), sh_degree=1, isect_cap=1 << 14,
                        use_pallas=True)
    cams = [ci for ci, _ in views]
    got = lod.pup_hessians(state.splats, cams, rcfg, 7, n_probes=3)
    small = bench_splats(12, sh_degree=1, seed=8, device=cuda)
    exact_got = lod.pup_hessians(small, cams[:1], rcfg, 0, exact=True)
    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        _eager(m)
        want = lod.pup_hessians(state.splats, cams, rcfg, 7, n_probes=3)
        exact_want = lod.pup_hessians(small, cams[:1], rcfg, 0, exact=True)
    top = float(want.abs().max())
    assert top > 0 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= (
        2 * rasterize_cuda.BWD_RTOL * top + rasterize_cuda.BWD_ATOL)
    assert float(exact_want.abs().max()) > 0
    assert torch.equal(exact_got, exact_want)


@pytest.mark.cuda
def test_strip_render_on_a_graph_equals_the_eager_strips(tmp_path, cuda,
                                                         monkeypatch):
    """`make_space_parallel_render`'s `run` on a graph, alone and over a
    one-process NCCL group (the frame's all_reduce captured), twice each,
    equal to the eager `run` bit for bit; a replay does not
    synchronise."""
    import torch.distributed as dist

    from brush_tpu_torch.parallel.tile_parallel import (
        make_space_parallel_render, strip_camera_inputs)
    state, _, _, fwd, _, _ = _graph_case(cuda)
    params = tuple(state.splats.fold_min_scale().params().values())
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    cam = Camera(position=np.array([0.3, 0.0, -18.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=1.0,
                 fov_y=0.7)
    stack, _ = strip_camera_inputs(cam, fwd.img_size, 1, device=cuda)
    with monkeypatch.context() as m:
        _eager(m)
        want = make_space_parallel_render(None, fwd)(*params, stack, bg)
    group = _nccl_world_1(tmp_path / "store")
    try:
        for g in (None, group):
            run = make_space_parallel_render(g, fwd)
            for k in range(3):
                torch.cuda.synchronize()
                if k == 2:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    got = run(*params, stack, bg)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                assert torch.equal((got + 0.0).view(torch.int32),
                                   (want + 0.0).view(torch.int32)), (g, k)
            assert run.graph.captured
            del run, got
    finally:
        dist.destroy_process_group()


def _eager_calls(monkeypatch):
    """Calls of the eager step, refine and scoring view made on the
    default stream outside a capture (a graph's warm-up runs on a side
    stream), by name."""
    from brush_tpu_torch import process
    from brush_tpu_torch.train import lod
    calls = {}

    def spy(module, name):
        real = getattr(module, name)

        def run(*a, **k):
            if (torch.cuda.current_stream() == torch.cuda.default_stream()
                    and not torch.cuda.is_current_stream_capturing()):
                calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, run)
    for module, name in ((process, "train_step_impl"),
                         (process, "train_step"), (process, "refine_step"),
                         (lod, "_view_hessian")):
        spy(module, name)
    return calls


@pytest.mark.cuda
def test_train_process_with_growth_and_lod_on_graphs_matches_eager(
        tmp_path, monkeypatch, cuda):
    """`train_process` on the card, 12 steps, a refine every 2 that grows
    the live count until the capacity doubles twice (1,024 -> 4,096), one
    LOD level of 2 steps: on graphs (no eager step, refine or scoring view
    on the default stream), alone and over a one-process NCCL group,
    against the same run with every program eager, noise off, one loader
    thread: the refines' messages equal, per-step losses within 1e-3
    relative, eval PSNR within 0.05 dB, the exported parameters of the
    run and of the LOD level within 2 * lr * steps + 1e-5 (the card-
    against-CPU rule of `test_train_process_on_the_card_matches_the_cpu`).
    """
    import functools

    import torch.distributed as dist

    from brush_tpu_torch import process
    from brush_tpu_torch.data import dataloader
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.train.config import TrainConfig
    _card_scene(tmp_path / "scene")
    monkeypatch.setattr(process, "SceneLoader", functools.partial(
        dataloader.SceneLoader, n_threads=1))
    steps = 12
    tcfg = TrainConfig(total_train_iters=steps, refine_every=2,
                       growth_grad_threshold=0.0, growth_select_fraction=1.0,
                       background_noise_strength=0.0, mean_noise_weight=0.0,
                       lod_levels=1, lod_refine_steps=2)
    runs = {}
    for mode in ("eager", "graphs", "nccl"):
        group = None
        with monkeypatch.context() as m:
            if mode == "eager":
                _eager(m)
            else:
                calls = _eager_calls(m)
            if mode == "nccl":
                group = _nccl_world_1(tmp_path / "store")
            pcfg = process.ProcessConfig(
                eval_every=steps, export_every=0, log_every=1, init_count=0,
                sh_degree=1, use_pallas=True,
                export_path=str(tmp_path / f"{mode}_{{iter}}.ply"))
            try:
                msgs = list(process.train_process(
                    str(tmp_path / "scene"), tcfg,
                    LoadConfig(max_resolution=32, eval_split_every=4), pcfg,
                    device="cuda", group=group))
            finally:
                if group is not None:
                    dist.destroy_process_group()
        if mode != "eager":
            assert calls == {}, (mode, calls)
        runs[mode] = (
            [m.data["loss"] for m in msgs if m.kind == "step"],
            [m.data["psnr"] for m in msgs if m.kind == "eval"],
            [m.data["total"] for m in msgs if m.kind == "refine"],
            [ply.load_splat_ply(str(tmp_path / f"{mode}_{steps}{s}.ply"))
             for s in ("", "_lod1")])
    l_e, p_e, r_e, d_e = runs["eager"]
    assert r_e[-1] > 2048, r_e           # the capacity doubled twice
    t = TrainConfig()
    for mode in ("graphs", "nccl"):
        l_g, p_g, r_g, d_g = runs[mode]
        assert r_g == r_e, (mode, r_g, r_e)
        assert len(l_g) == steps and np.isfinite(l_g).all()
        np.testing.assert_allclose(l_g, l_e, rtol=1e-3)
        assert abs(p_g[0] - p_e[0]) <= 0.05, (p_g, p_e)
        for g, e in zip(d_g, d_e):
            assert g.num_splats == e.num_splats
            for name, lr in (("means", t.lr_mean * 3.0),
                             ("log_scales", t.lr_scale),
                             ("rotations", t.lr_rotation),
                             ("sh_coeffs", t.lr_coeffs_dc),
                             ("raw_opacities", t.lr_opac)):
                d = np.abs(getattr(g, name) - getattr(e, name)).max()
                assert d <= 2 * lr * (steps + 2) + 1e-5, (mode, name, d)


# --------------------------------------------------------------------------
# the stage recorder's device marks
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_stage_device_marks_skip_a_capture_and_share_the_host_clock(cuda):
    """A stage with `device=True` records no event inside a CUDA graph
    capture (its host times are kept), and one around the graph's replay;
    the anchor puts a 10 ms sleep of the host between two device stages
    on the host clock within 1 ms of the sleep's own length, and each
    device mark within 1 ms of its own host mark on an idle card."""
    import time

    from brush_tpu_torch.utils import tracing
    x = torch.zeros(1024, device=cuda)
    with tracing.record_stages() as rec:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1.0)                                  # the warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with tracing.stage("captured", device=True):
                x.add_(1.0)
        with tracing.stage("replayed", device=True):
            graph.replay()
        torch.cuda.synchronize()
        with tracing.stage("a", device=True):
            x.add_(1.0)
        t0 = time.perf_counter_ns()
        time.sleep(0.01)
        slept_ms = (time.perf_counter_ns() - t0) * 1e-6
        with tracing.stage("b", device=True):
            x.add_(1.0)
        snap = rec.snapshot()
    stages = snap["stages"]
    assert stages["captured"]["count"] == 1
    assert stages["captured"]["device_count"] == 0
    assert stages["replayed"]["device_count"] == 1
    assert float(x[0]) == 4.0
    a, = [e for e in snap["timeline"] if e["name"] == "a"]
    b, = [e for e in snap["timeline"] if e["name"] == "b"]
    # The sleep itself may overrun on a loaded host: the gap is held to
    # what the host clock read around it.
    gap_ms = (b["device"][0] - a["device"][1]) * 1e-6
    host_gap_ms = (b["host"][0] - a["host"][1]) * 1e-6
    assert slept_ms >= 10.0
    assert abs(gap_ms - slept_ms) <= 1.0, (gap_ms, slept_ms, host_gap_ms)
    assert abs(gap_ms - host_gap_ms) <= 1.0, (gap_ms, host_gap_ms)
    for e in (a, b):
        assert abs(e["device"][0] - e["host"][0]) < 1_000_000, e


@pytest.mark.cuda
def test_recorder_counts_graphs_and_times_turns_on_the_card(tmp_path,
                                                            monkeypatch,
                                                            cuda):
    """`train_process` on StepGraphs with the recorder open: one capture
    and a replay a step after the first, each replay a `graphs.replay`
    with device marks inside its `run.turn`, every turn with device marks
    whose spans come in order; a RenderGraph's frames count `render`
    captures and replays, and an eviction, and project the pinhole lens
    only in a capture's warm-up and the capture."""
    import functools

    from brush_tpu_torch import graphs, process
    from brush_tpu_torch.data import dataloader
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.utils import tracing
    _card_scene(tmp_path / "scene")
    monkeypatch.setattr(process, "SceneLoader", functools.partial(
        dataloader.SceneLoader, n_threads=1))
    steps = 5
    pcfg = process.ProcessConfig(
        eval_every=0, export_every=0, log_every=steps, init_count=0,
        sh_degree=1, export_path=str(tmp_path / "out_{iter}.ply"))
    with tracing.record_stages() as rec:
        list(process.train_process(
            str(tmp_path / "scene"), TrainConfig(total_train_iters=steps,
                                                 refine_every=1000),
            LoadConfig(max_resolution=32, eval_split_every=4), pcfg,
            device="cuda"))
        snap = rec.snapshot()
    c = snap["counters"]
    assert c["graphs.capture.step"] == 1
    assert c["graphs.replay.step"] == steps - 1
    turns = [e for e in snap["timeline"] if e["name"] == "run.turn"]
    assert [e["unit"] for e in turns] == list(range(1, steps + 1))
    assert all(e["device"][0] <= e["device"][1] for e in turns)
    assert all(t0["device"][1] <= t1["device"][0] + 1_000_000
               for t0, t1 in zip(turns, turns[1:]))
    replays = [e for e in snap["timeline"] if e["name"] == "graphs.replay"]
    assert [e["unit"] for e in replays] == list(range(2, steps + 1))
    for r in replays:
        turn = turns[r["unit"] - 1]
        assert r["parent"] == "run.turn" and r["device"] is not None
        assert turn["device"][0] <= r["device"][0] + 1_000_000
        assert r["device"][1] <= turn["device"][1] + 1_000_000

    state, views, _, fwd, _, _ = _graph_case(cuda)
    params = tuple(state.splats.params().values())
    bg = torch.zeros(3, device=cuda)
    cache = graphs.RenderGraphs(1)
    with tracing.record_stages() as rec:
        for n in (params[0].shape[0], params[0].shape[0] // 2):
            for ci, _ in views:
                cache.get(render, fwd, n)(*(p[:n] for p in params), ci, bg)
        snap = rec.snapshot()
    # Each capture's warm-up and the capture itself project (and count
    # the lens); a replay runs no Python.
    assert snap["counters"] == {"graphs.capture.render": 2,
                                "graphs.replay.render": 2,
                                "graphs.evict.render": 1,
                                "project.lens.pinhole": 4,
                                "project.route.cuda": 4}
    assert snap["stages"]["graphs.replay"]["device_count"] == 2


@pytest.mark.cuda
def test_fisheye_dataset_trains_on_one_step_graph(tmp_path, monkeypatch,
                                                  cuda):
    """`train_process` over an OPENCV_FISHEYE COLMAP scene on the card:
    every turn trains through the lens (`run.lens.kb4`), projected by the
    kernels (`project.route.cuda`, never `project.route.torch`), on one
    captured step graph replayed after the first step, and the run's
    losses are those of the same run with every program eager, within 1e-3
    relative (the rule of `test_train_process_with_growth_and_lod_on_graphs_matches_
    eager`)."""
    import functools
    import struct

    from brush_tpu_torch import process
    from brush_tpu_torch.data import dataloader
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.utils import tracing
    root = tmp_path / "scene"
    _card_scene(root)
    with open(root / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 5, 32, 32))         # OPENCV_FISHEYE
        f.write(struct.pack("<8d", 20.0, 20.0, 16.0, 16.0,
                            -0.03, -0.004, 0.0006, -0.0001))
    monkeypatch.setattr(process, "SceneLoader", functools.partial(
        dataloader.SceneLoader, n_threads=1))
    steps = 6

    def losses():
        pcfg = process.ProcessConfig(
            eval_every=0, export_every=0, log_every=1, init_count=0,
            sh_degree=1, export_path=str(tmp_path / "out_{iter}.ply"))
        with tracing.record_stages() as rec:
            msgs = list(process.train_process(
                str(root), TrainConfig(total_train_iters=steps,
                                       refine_every=1000),
                LoadConfig(max_resolution=32), pcfg, device="cuda"))
            counters = rec.snapshot()["counters"]
        return [m.data["loss"] for m in msgs if m.kind == "step"], counters

    graphed, c = losses()
    assert c["graphs.capture.step"] == 1
    assert c["graphs.replay.step"] == steps - 1
    assert c["run.lens.kb4"] == steps and "run.lens.pinhole" not in c
    # The lens projects on the kernels (the capture and its warm-up).
    assert c["project.route.cuda"] >= 2 and "project.route.torch" not in c
    _eager(monkeypatch)
    eager, c = losses()
    assert "graphs.capture.step" not in c and c["run.lens.kb4"] == steps
    assert c["project.route.cuda"] >= steps and "project.route.torch" not in c
    assert all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(graphed, eager))


# --------------------------------------------------------------------------
# The projection's kernels (csrc/project.cu, csrc/project_bwd.cu)
# --------------------------------------------------------------------------


def _proj_rows(params, cam, img, dev, degree=3):
    """The five row arrays on `dev` (SH padded to 25 coefficients for
    degree 4) and the view's CameraInputs."""
    params = list(params)
    if degree == 4:
        params[3] = np.pad(params[3], ((0, 0), (0, 9), (0, 0)))
    return ([torch.from_numpy(np.ascontiguousarray(p)).to(dev)
             for p in params], camera_inputs(cam, img, device=dev))


def _hold_projection(rows, ci, img, degree, mip, seed, model=None):
    """The forward kernel against `project_splats_flags` (compare_forward:
    bit for bit but the colour, through either lens), the backward kernel against `project_backward_plain`
    (compare_backward) and against autograd of `project_splats` on the
    card (within 1e-5 of each array's largest entry), for random
    cotangents. Returns the visible mask."""
    from brush_tpu_torch.camera import Pinhole
    from brush_tpu_torch.ops import project_cuda, projection
    model = model or Pinhole()
    with kernels.capture() as launches:
        got = project_cuda.project_forward(*rows, ci, img, sh_degree=degree,
                                           mip_splatting=mip, model=model)
    assert [x.name for x in launches] == ["project_fwd"]
    launches[0].check()
    proj, flags = got
    n = rows[0].shape[0]
    gen = torch.Generator(device=rows[0].device).manual_seed(seed)
    cots = [torch.randn((n,) + s, generator=gen, device=rows[0].device)
            for s in ((2,), (3,), (3,), ())]
    with kernels.capture() as launches:
        grads = project_cuda.project_backward(
            *rows, ci, img, flags, *cots, sh_degree=degree,
            mip_splatting=mip, model=model)
    assert [x.name for x in launches] == ["project_bwd"]
    launches[0].check()
    tp = [r.clone().requires_grad_(True) for r in rows]
    plain = projection.project_splats(*tp, ci, img, sh_degree=degree,
                                      mip_splatting=mip, model=model)
    total = sum((getattr(plain, o) * c).sum()
                for o, c in zip(("mean2d", "conic", "color", "opac"), cots))
    want = torch.autograd.grad(total, tp)
    for g, w, name in zip(grads, want, project_cuda._GRAD_FIELDS):
        d = float((g - w).abs().max())
        assert d <= max(1e-5 * float(w.abs().max()), 1e-8), (name, d)
    return proj.visible


@pytest.mark.cuda
@pytest.mark.parametrize("mip", [False, True], ids=["nomip", "mip"])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", ["gsplat", "bench_half_dead", "edges",
                                  "fisheye"])
def test_project_kernels_match_plain_and_autograd(case, degree, mip, cuda):
    """Both projection kernels on the cases of tests/projection_rows.py
    (the gsplat fixtures; the bench scene with half its rows dead; splats
    behind the near plane, past the Jacobian's clamp and at the colour
    clamp; the bench scene through the fisheye cell's KB4 lens, with rows
    on its axis, at its corners and past its field), SH degrees 0-4, mip
    compensation on and off."""
    import projection_rows
    params, cam, img = projection_rows.case(case)
    rows, ci = _proj_rows(params, cam, img, cuda, degree)
    vis = _hold_projection(rows, ci, img, degree, mip, seed=degree,
                           model=cam.model)
    assert bool(vis.any())
    if case == "fisheye":
        assert bool(vis[372:378].all()) and not bool(vis[394:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("field,value,case", [
    pytest.param(f, v, c, id=f"{f}-{v}" + ("-kb4" if c == "fisheye" else ""))
    for c in ("bench_half_dead", "fisheye")
    for f in ("means", "log_scales", "quats", "sh", "raw_opacities")
    for v in ("nan", "inf", "-inf")])
def test_project_kernels_match_plain_on_poisoned_rows(field, value, case,
                                                      cuda):
    """Rows of one input set to NaN or +-inf, whole and entry by entry,
    through a pinhole and through KB4: the kernels' gates, unit splats,
    colour scrub and zero gradients against the plain version and
    autograd."""
    import projection_rows
    params, cam, img = projection_rows.poisoned(field, value, name=case)
    rows, ci = _proj_rows(params, cam, img, cuda)
    vis = _hold_projection(rows, ci, img, 3, field == "quats", seed=7,
                           model=cam.model)
    assert int(vis.sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("mip", [False, True], ids=["nomip", "mip"])
@pytest.mark.parametrize("shape", ["cell", "odd"])
def test_project_kernels_match_plain_through_kb4_at_the_fisheye_cells_rows(
        shape, mip, cuda):
    """The fisheye cell's projection: 2^21 rows of the bench scene at SH
    degree 3, the second half dead, through its KB4 camera at 1752x1168
    from 8 units (`cell`); and 1,001 rows, 601 live, at an eighth of that
    (`odd`: the last warp part full). The forward bit for bit but the
    colour (compare_forward), the backward within compare_backward and
    1e-5 of autograd's largest entries."""
    import projection_rows
    live, cap, scale = ((1 << 20, 1 << 21, 1.0) if shape == "cell"
                        else (601, 1001, 0.125))
    params = projection_rows.bench_rows(live, cap, seed=3)
    cam, img = projection_rows.fisheye_camera(scale)
    rows, ci = _proj_rows(params, cam, img, cuda)
    vis = _hold_projection(rows, ci, img, 3, mip, seed=5, model=cam.model)
    assert 0 < int(vis.sum()) <= live
    assert not bool(vis[live:].any())
    if shape == "cell":
        assert int(vis.sum()) > 100_000


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["lens_dropped", "k1_flipped"])
def test_kb4_kernel_compare_rules_fail_planted_faults(fault, cuda):
    """The kernels run with a faulty lens (KB4 projected as a pinhole, or
    k1 with its sign flipped) against the plain version through the right
    one: compare_forward and compare_backward both fail."""
    import dataclasses as dc

    import projection_rows
    from brush_tpu_torch.camera import Pinhole
    from brush_tpu_torch.ops import project_cuda, projection
    params = projection_rows.bench_rows(1 << 16, 1 << 17, seed=3)
    cam, img = projection_rows.fisheye_camera(0.5)
    rows, ci = _proj_rows(params, cam, img, cuda)
    model = cam.model
    bad = Pinhole() if fault == "lens_dropped" else dc.replace(
        model, k1=-model.k1)
    kw = dict(sh_degree=3, mip_splatting=False)
    got = project_cuda.project_forward(*rows, ci, img, model=bad, **kw)
    want = projection.project_splats_flags(*rows, ci, img, model=model,
                                           **kw)
    with pytest.raises(AssertionError):
        project_cuda.compare_forward(got, want)
    n = rows[0].shape[0]
    gen = torch.Generator(device=cuda).manual_seed(2)
    cots = [torch.randn((n,) + s, generator=gen, device=cuda)
            for s in ((2,), (3,), (3,), ())]
    args = (*rows, ci, img, want[1], *cots)
    wrong = project_cuda.project_backward(*args, model=bad, **kw)
    right = project_cuda.project_backward_plain(*args, model=model, **kw)
    with pytest.raises(AssertionError):
        project_cuda.compare_backward(wrong, right)


@pytest.mark.cuda
@pytest.mark.parametrize("mip", [False, True], ids=["nomip", "mip"])
def test_project_kernels_match_plain_at_the_train_cells_rows(mip, cuda):
    """2^21 rows of the bench scene at SH degree 3, the second half dead
    (the train cells' capacity), from the bench camera at 1920x1080:
    visible, depth, the tile bbox and count, mean2d, conic, opac, the
    threshold, max_radius and the flags bit for bit, the colour within the
    SH sum's rounding (compare_forward); the backward as above."""
    import projection_rows
    params = projection_rows.bench_rows(1 << 20, 1 << 21, seed=3)
    img = (1920, 1080)
    rows, ci = _proj_rows(params, projection_rows.bench_camera(), img, cuda)
    vis = _hold_projection(rows, ci, img, 3, mip, seed=5)
    assert 100_000 < int(vis.sum()) <= 1 << 20
    assert not bool(vis[1 << 20:].any())


@pytest.mark.cuda
def test_project_kernels_replay_in_a_captured_graph(cuda):
    """`project` forward and its backward (autograd's thread launches the
    backward kernel onto the capture stream) captured once in a CUDA
    graph, then replayed on two other scenes copied into its inputs: each
    replay's outputs and gradients equal the eager call's bit for bit."""
    import projection_rows
    from brush_tpu_torch.ops import project_cuda
    img = (640, 360)
    cam = projection_rows.bench_camera()
    scenes = [_proj_rows(projection_rows.bench_rows(20_000, 32_768, s),
                         cam, img, cuda)[0] for s in range(3)]
    ci = camera_inputs(cam, img, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cots = [torch.randn((32_768,) + s, generator=gen, device=cuda)
            for s in ((2,), (3,), (3,), ())]
    outs = ("mean2d", "conic", "color", "opac")

    def run(rows):
        proj = project_cuda.project(*rows, ci, img, sh_degree=3)
        total = sum((getattr(proj, o) * c).sum() for o, c in zip(outs, cots))
        return (proj.visible, proj.depth, proj.mean2d, proj.conic,
                proj.color, proj.opac, proj.tile_min, proj.tile_max,
                proj.num_tiles_bbox, *torch.autograd.grad(total, rows))

    static = [r.clone().requires_grad_(True) for r in scenes[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = run(static)
    for rows in scenes[1:] + scenes[:1]:
        with torch.no_grad():
            for s, r in zip(static, rows):
                s.copy_(r)
        graph.replay()
        want = run([r.clone().requires_grad_(True) for r in rows])
        torch.cuda.synchronize()
        assert kernels.same_bits(got, want) == 0.0
    del graph


@pytest.mark.cuda
def test_train_step_and_viewer_frame_project_through_the_kernels(tmp_path,
                                                                 cuda):
    """One `train_process` step on a pinhole COLMAP scene launches both
    projection kernels and counts `project.route.cuda` only; one
    `render_pose` frame launches the forward alone."""
    from brush_tpu_torch import process
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.utils import tracing
    from brush_tpu_torch.viewer.service import Slot, ViewerState
    root = tmp_path / "scene"
    _card_scene(root)
    pcfg = process.ProcessConfig(
        eval_every=0, export_every=0, log_every=1, init_count=0,
        sh_degree=1, export_path=str(tmp_path / "out_{iter}.ply"))
    kernels.reset_launches()
    with tracing.record_stages() as rec:
        list(process.train_process(
            str(root), TrainConfig(total_train_iters=1, refine_every=1000),
            LoadConfig(max_resolution=32), pcfg, device="cuda"))
        c = rec.snapshot()["counters"]
    assert kernels.LAUNCHES["project_fwd"] >= 1
    assert kernels.LAUNCHES["project_bwd"] >= 1
    assert c["project.route.cuda"] >= 1 and "project.route.torch" not in c
    slot = Slot()
    slot.set(0, bench_splats(5000, sh_degree=1, seed=2, device="cuda"))
    state = ViewerState(slot, 1, device="cuda")
    kernels.reset_launches()
    with tracing.record_stages() as rec:
        frame = state.render_pose(np.array([0.0, 0.0, -18.0]), 0.0, 0.0, 160,
                                  96, 0)
        c = rec.snapshot()["counters"]
    assert frame.shape == (96, 160, 3) and frame.max() > 0
    assert kernels.LAUNCHES["project_fwd"] >= 1
    assert kernels.LAUNCHES["project_bwd"] == 0
    assert c["project.route.cuda"] >= 1 and "project.route.torch" not in c


@pytest.mark.cuda
def test_fisheye_view_projects_through_pytorch(cuda):
    """A ThinPrismFisheye view on the card (a lens the kernels do not
    take; KB4 does since it has its closed-form Jacobian) runs
    `project_splats` (its Jacobian is forward-mode AD):
    `project.route.torch`, no launch of the projection's kernels, forward
    or backward."""
    from brush_tpu_torch.camera import ThinPrismFisheye
    from brush_tpu_torch.utils import tracing
    state, views, rcfg, _, _, _ = _graph_case(cuda, fisheye=True, model=(
        ThinPrismFisheye(-0.03, -0.004, 0.0006, -0.0001, 1e-3, -1e-3, 5e-4,
                         -5e-4)))
    s = state.splats
    params = [p.detach().requires_grad_(True) for p in (
        s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities)]
    kernels.reset_launches()
    with tracing.record_stages() as rec:
        img, _ = render(*params, views[0][0], torch.zeros(3, device=cuda),
                        rcfg)
        img.sum().backward()
        c = rec.snapshot()["counters"]
    assert c["project.route.torch"] == 1 and "project.route.cuda" not in c
    assert c["project.lens.tpf"] == 1
    assert kernels.LAUNCHES["project_fwd"] == 0
    assert kernels.LAUNCHES["project_bwd"] == 0
    assert all(p.grad is not None and bool(p.grad.isfinite().all())
               for p in params)
