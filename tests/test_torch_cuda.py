"""The CUDA kernels of `brush_tpu_torch` against their plain PyTorch
versions, on the card. This file imports no JAX and nothing of the JAX
package, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py pins JAX to the CPU and so needs
JAX.) Every test is marked `cuda` and skips where torch.cuda.is_available()
is false. `python3 chip_smoke.py` makes the same comparisons at full width;
the cases here are small and pick the edges: scan lengths around the
kernel's 4096-element chunk and past 2^31 (wrapping sums), its f32 sum and
int32 max variants, stacks that pad and truncate, expansions and fills on
empty, single-owner, cut and ragged shapes, and three scenes, each
rendered forward only and through one training render with its backward,
whose launches are captured
(`kernels.capture`) and each replayed kernel against plain under its own
module's compare (`kernels.Launch.check`):

  * bench:        the benchmark generator, capacities from `plan_caps`;
  * opaque_wall:  stacked near-opaque splats, k0 = 1, tiles of several
                  hundred slots where whole blocks finish early;
  * giant_splats: splats whose bbox passes 32 tiles (the untested bbox
                  tail of the emission).
"""

import numpy as np
import pytest
import torch

from brush_tpu_torch import kernels
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.models.splats import from_raw
from brush_tpu_torch.ops import expand_cuda, scan_cuda
from brush_tpu_torch.ops.capacity import plan_caps
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
                                         (3, 300_001), (1, 5_000_000)])
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
    err = _same(scan_cuda.cumsum_rows, torch.from_numpy(x).to(cuda))
    assert np.isfinite(err)


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
    # counts, cap (None: the total + 37), rows
    "basic": ([3, 0, 5, 1, 0, 2], 16, 5),
    "all_empty": ([0, 0, 0], 8, 3),
    "one_owner_spans_everything": ([0, 100_000, 0], 100_000, 17),
    "cut_at_cap": ([10, 10, 10], 15, 2),
    "starts_past_cap": ([5, 3000, 7, 9], 1000, 2),
    "ragged_random": (None, None, 17),
    "one_slot": ([1], 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_kernel_matches_plain(case, cuda):
    counts, cap, rows = EXPAND_CASES[case]
    rng = np.random.default_rng(len(case))
    if counts is None:
        counts = rng.integers(0, 9, 40_001)
    counts = np.asarray(counts, np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    cap = int(counts.sum()) + 37 if cap is None else cap
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
