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
"""

import numpy as np
import pytest
import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.models.splats import from_raw
from brush_tpu_torch.ops import expand_cuda, rasterize_cuda, scan_cuda
from brush_tpu_torch.ops.capacity import plan_caps
from brush_tpu_torch.ops.tiling_key import _pack2f16
from brush_tpu_torch.render import (
    RenderConfig,
    camera_inputs,
    render,
    render_with_refine,
)
from brush_tpu_torch.utils.synthetic import bench_splats


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
    """Lengths around the 256-thread block and the scan's 4096 chunk, no
    valid lane, every lane valid, one valid lane late in a long row."""
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
    assert [launch.name for launch in launches] == ["scan_max", "fill"]
    for launch in launches:
        launch.check()
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
