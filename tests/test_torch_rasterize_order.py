"""The rasterizer kernels' work order and per-splat backward, on the CPU
(plain versions):

  * the per-splat backward's plain version is the per-slot plain backward
    summed per splat (`reduce_slot_grads`), and it is what the CPU route of
    `rasterize_backward_splats` and the training rasterizer's autograd
    return;
  * the per-splat compare rule fails a backward that drops one blended slot
    or zeroes one gradient row, and passes rounding noise;
  * each tile part's useful length (the schedule the training forward
    hands the backward) bounds the slots that 8x4 part of the tile blends,
    and the tile's `useful_len` (row 5) is the largest of its parts'; the
    backward's count of replayed (pixel, slot) pairs, which its bound
    reads, stops at each part's useful length.

The scenes are binned by the port itself; the JAX comparisons of the same
functions are in test_torch_kernels.py and test_torch_train.py.
"""

import numpy as np
import pytest
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.models.splats import from_raw
from brush_tpu_torch.ops import rasterize_cuda as rc
from brush_tpu_torch.ops.projection import project_splats
from brush_tpu_torch.ops.tiling import build_intersections
from brush_tpu_torch.render import camera_inputs

BG = torch.tensor([0.3, 0.2, 0.1])


def _scene(kind):
    """(soa, tile_ranges, gid_from_isect, n, img) of a small binned scene:
    `opaque_wall` (stacked near-opaque splats over the whole view),
    `thin` (faint splats: nothing saturates, every slot of a range is
    blended) or `nan_conic` (the wall with one splat's conic NaN and
    another's infinite in the SoA)."""
    rng = np.random.default_rng(5)
    thin = kind == "thin"
    n = 160 if thin else 200
    # The wall covers the whole view many times over.
    means = rng.uniform(-0.8, 0.8, (n, 3)) * ([1, 1, 1] if thin
                                              else [3.2, 3.2, 0.6])
    means = means.astype(np.float32)
    scale = 0.12 if thin else 0.5
    opac = -2.5 if thin else 8.0
    s = from_raw(means, np.full((n, 3), np.log(scale), np.float32),
                 np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
                 rng.normal(0, 0.6, (n, 1, 3)).astype(np.float32),
                 np.full(n, opac, np.float32), device="cpu")
    img = (64, 64)
    cam = Camera(position=np.array([0.0, 0.0, -5.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=0.9,
                 fov_y=0.9 * img[1] / img[0])
    proj = project_splats(s.means, s.log_scales, s.quats, s.sh_coeffs,
                          s.raw_opacities, camera_inputs(cam, img, "cpu"),
                          img, sh_degree=0)
    isect = build_intersections(proj, img, 1 << 14, expand_k0=4)
    assert int(isect.num_isects) <= 1 << 14
    soa = isect.soa.clone()
    if kind == "nan_conic":
        gid = isect.gid_from_isect
        for splat, value in ((int(gid[isect.tile_ranges[0, 0]]), np.nan),
                             (int(gid[isect.tile_ranges[1, 0]]), np.inf)):
            cols = torch.nonzero(gid == splat)[:, 0]
            soa[2:5, cols] = value
    return soa, isect.tile_ranges, isect.gid_from_isect, n, img


def _cotangent(img, seed=0):
    v = np.random.default_rng(seed).normal(0, 1, (img[1], img[0], 4))
    return rc.image_to_tiles(torch.from_numpy(v.astype(np.float32)), img)


@pytest.mark.parametrize("kind", ["opaque_wall", "thin", "nan_conic"])
def test_splat_backward_plain_is_the_reduced_slot_backward(kind):
    soa, ranges, gid, n, img = _scene(kind)
    tiles, schedule = rc.rasterize_forward_train(soa, ranges, BG, img)
    v_tiles = _cotangent(img)
    slots = rc.rasterize_backward_plain(soa, ranges, tiles, v_tiles, BG, img)
    want = rc.reduce_slot_grads(slots, gid, n)
    # The wrapper's CPU route: its plain version.
    got = rc.rasterize_backward_splats(soa, ranges, tiles, v_tiles, BG, img,
                                       gid, n, schedule)
    assert got.shape == (rc.GRAD_ROWS, n)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(want).all())
    assert float(want[10].max()) > 0
    if kind == "nan_conic":
        for t in (0, 1):
            splat = int(gid[ranges[t, 0]])
            assert not want[:, splat].any(), (t, want[:, splat])
    # The autograd function hands back the same sums per splat.
    leaves = [torch.zeros(shape, requires_grad=True)
              for shape in ((n, 2), (n, 3), (n, 3), (n,), (n,), (n,))]
    out = rc.rasterize_train(*leaves, soa, ranges, gid, BG, img)
    grads = torch.autograd.grad(
        out, leaves, rc.tiles_to_image(v_tiles, img))
    assert torch.equal(grads[0], want[0:2].T)
    assert torch.equal(grads[1], want[2:5].T)
    assert torch.equal(grads[2], want[6:9].T)
    assert torch.equal(grads[3], want[5])
    assert torch.equal(grads[5], (want[10] > 0).to(torch.float32))


def test_splat_compare_catches_a_dropped_slot_and_a_zeroed_row():
    soa, ranges, gid, n, img = _scene("opaque_wall")
    tiles, _ = rc.rasterize_forward_train(soa, ranges, BG, img)
    v_tiles = _cotangent(img, seed=1)
    slots = rc.rasterize_backward_plain(soa, ranges, tiles, v_tiles, BG, img)
    want = rc.reduce_slot_grads(slots, gid, n)
    noisy = want * (1.0 + 1e-6 * torch.randn(want.shape))
    assert rc.compare_bwd(noisy, want) > 0.0
    # A kernel that loses one blended slot: the fullest tile's slot with
    # the largest blend weight.
    fullest = int((ranges[:, 1] - ranges[:, 0]).argmax())
    start, useful = int(ranges[fullest, 0]), int(tiles[fullest, 5, 0])
    col = start + int(slots[10, start:start + useful].argmax())
    lost = slots.clone()
    lost[:, col] = 0.0
    with pytest.raises(AssertionError, match="gradients past"):
        rc.compare_bwd(rc.reduce_slot_grads(lost, gid, n), want)
    for row in range(rc.GRAD_ROWS):
        zeroed = want.clone()
        zeroed[row] = 0.0
        with pytest.raises(AssertionError, match=f"rows \\[{row}\\]"):
            rc.compare_bwd(zeroed, want)


@pytest.mark.parametrize("kind", ["opaque_wall", "thin"])
def test_part_useful_lengths_bound_what_each_part_blends(kind):
    soa, ranges, _, _, img = _scene(kind)
    tiles, schedule = rc.rasterize_forward_train(soa, ranges, BG, img)
    part_useful = schedule.part_useful
    n_tiles = ranges.shape[0]
    assert part_useful.dtype == torch.int32
    assert tuple(part_useful.shape) == (n_tiles, rc.TILE_PARTS)
    # Row 5 holds the tile's maximum over its parts, in every lane.
    tile_len = part_useful.amax(dim=1).to(torch.float32)
    assert torch.equal(tiles[:, 5], tile_len[:, None].expand(-1, 1024))
    spans = ranges[:, 1] - ranges[:, 0]
    assert (part_useful <= spans[:, None]).all()
    assert bool((part_useful != part_useful[:, :1]).any())  # parts differ
    if kind == "opaque_wall":
        assert bool((tile_len < spans).any())     # saturated before the end
    # Part q is the 8x4 block at x = 8 (q % 4), y = 4 (q / 4).
    ids = torch.arange(1024)[None, :].float()
    part_of_pixel = rc._by_part(ids)[0].long()      # [32 parts, 32 pixels]
    assert sorted(part_of_pixel.flatten().tolist()) == list(range(1024))
    q = 13
    assert part_of_pixel[q].tolist() == [(4 * (q // 4) + k // 8) * 32
                                         + 8 * (q % 4) + k % 8
                                         for k in range(32)]
    # Cut every tile's range at part q's length: part q's pixels are the
    # same, and one slot shorter they differ wherever that length is > 0.
    for q in (0, 13, 31):
        pix = part_of_pixel[q]
        cut = ranges.clone()
        cut[:, 1] = ranges[:, 0] + part_useful[:, q]
        same, _ = rc.rasterize_forward_train(soa, cut, BG, img)
        assert torch.equal(same[:, :5, pix], tiles[:, :5, pix])
        shorter = cut.clone()
        shorter[:, 1] = torch.clamp_min(cut[:, 1] - 1, ranges[:, 0])
        less, _ = rc.rasterize_forward_train(soa, shorter, BG, img)
        moved = (less[:, :4, pix] != tiles[:, :4, pix]).flatten(1).any(1)
        assert torch.equal(moved, part_useful[:, q] > 0)


@pytest.mark.parametrize("kind", ["opaque_wall", "thin"])
def test_backward_pair_count_stops_at_each_part_length(kind):
    soa, ranges, _, _, img = _scene(kind)
    tiles, schedule = rc.rasterize_forward_train(soa, ranges, BG, img)
    _, replayed, blended = rc.rasterize_backward_plain(
        soa, ranges, tiles, _cotangent(img), BG, img, count_pairs=True)
    per_part = rc.PART_W * rc.PART_H * int(schedule.part_useful.sum())
    per_tile = rc.TILE_PIX * int(tiles[:, 5, 0].sum())
    assert 0 < int(blended) <= int(replayed) <= per_part < per_tile
    if kind == "thin":
        # No pixel is ever done: each pixel replays its part's whole length.
        assert int(replayed) == per_part


def test_backward_splats_refuses_what_the_kernel_does_not_take():
    soa, ranges, gid, n, img = _scene("thin")
    tiles, schedule = rc.rasterize_forward_train(soa, ranges, BG, img)
    v_tiles = _cotangent(img)
    with pytest.raises(ValueError, match="int32"):
        rc.rasterize_backward_splats(soa, ranges, tiles, v_tiles, BG, img,
                                     gid.long(), n, schedule)
    too_many = torch.zeros(soa.shape[1] + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot ids"):
        rc.rasterize_backward_splats(soa, ranges, tiles, v_tiles, BG, img,
                                     too_many, n, schedule)
    with pytest.raises(ValueError, match="v_tiles"):
        rc.rasterize_backward_splats(soa, ranges, tiles, v_tiles[:, :3], BG,
                                     img, gid, n, schedule)
