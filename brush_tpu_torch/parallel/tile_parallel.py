"""Multi-device rendering of one image in horizontal strips (port of
`brush_tpu/parallel/tile_parallel.py`).

Each process renders one strip of tile rows with the whole splat set; no
process talks to another until the strips are assembled. A strip render
is exactly the full render restricted to a sub-image: the same camera with
the principal point shifted by the strip's y-offset. The cull gates drop
the splats outside the strip, and the blend is the full render's because
the EWA Jacobian's clamp limits come from the FULL image and pass through
unchanged.

The strips are assembled with one SUM `all_reduce` of a zero frame into
which each process writes its own rows (adding zeros is exact), which
gloo and NCCL both take for CPU and CUDA tensors alike (gloo's
`all_gather` takes CPU tensors only).

On the card (the kernel path) `run` is a CUDA graph, the JAX package's
`@jax.jit run`: captured at its first call, replayed after. Over NCCL the
frame's `all_reduce` is in the graph; over gloo the render is captured and
the `all_reduce` (through the host) runs eagerly on the graph's frame.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from brush_tpu_torch import graphs
from brush_tpu_torch.camera import Camera
from brush_tpu_torch.constants import TILE_WIDTH
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.render import RenderConfig, camera_inputs, render


def strip_height(img_h: int, n_strips: int) -> int:
    """Rows of a strip: whole tile rows, the tile rows spread evenly."""
    tile_rows = -(-img_h // TILE_WIDTH)
    return -(-tile_rows // n_strips) * TILE_WIDTH


def strip_camera_inputs(cam: Camera, img_size, n_strips: int,
                        device="cuda"):
    """Per-strip CameraInputs, stacked on a leading [n_strips] axis, and the
    tile-aligned strip height. Strip i sees the image rows
    [i * h_strip, (i + 1) * h_strip) through a cy shift; the clamp limits
    stay the full image's."""
    h_strip = strip_height(img_size[1], n_strips)
    full = camera_inputs(cam, img_size, device=device)
    pins = full.pinhole.repeat(n_strips, 1)
    pins[:, 3] -= torch.arange(n_strips, dtype=torch.float32,
                               device=pins.device) * h_strip
    stack = CameraInputs(
        viewmat=full.viewmat.expand((n_strips,) + full.viewmat.shape),
        pinhole=pins,
        clamp_limits=full.clamp_limits.expand(
            (n_strips,) + full.clamp_limits.shape),
        cam_pos=full.cam_pos.expand(n_strips, 3),
        half_max_render_fov=torch.full(
            (n_strips,), float(full.half_max_render_fov),
            dtype=torch.float32, device=pins.device))
    return stack, h_strip


def make_space_parallel_render(group, rcfg: RenderConfig):
    """`run(means, log_scales, quats, sh, opac, cam_stack, bg) -> [H, W, 4]`
    on every process of `group` (None: one process renders every strip's
    rows as one). `rcfg.img_size` is the FULL image; `rcfg.isect_cap` is
    a strip's capacity. Process r renders strip r of `cam_stack`. On the
    card the frame `run` returns is the graph's own, valid until its next
    call."""
    w, h = rcfg.img_size
    n = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    h_strip = strip_height(h, n)
    rcfg_strip = dataclasses.replace(rcfg, img_size=(w, h_strip))
    # The frame's all_reduce runs in the graph over NCCL, eagerly over gloo.
    in_graph = graphs.capturable("cuda", True, group)

    def strips(means, log_scales, quats, sh, opac, cam_stack, bg,
               reduce=True):
        cam = CameraInputs(*(x[rank] for x in cam_stack))
        img, _ = render(means, log_scales, quats, sh, opac, cam, bg,
                        rcfg_strip)
        if group is None:
            return img
        frame = img.new_zeros((n * h_strip, w, img.shape[-1]))
        frame[rank * h_strip:(rank + 1) * h_strip] = img
        if reduce:
            dist.all_reduce(frame, op=dist.ReduceOp.SUM, group=group)
        return frame

    graph = graphs.FnGraph(lambda *a: strips(*a, reduce=in_graph),
                           what="strip render")

    def run(means, log_scales, quats, sh, opac, cam_stack, bg):
        args = (means, log_scales, quats, sh, opac, cam_stack, bg)
        if not graphs.capturable(means.device, rcfg.use_pallas):
            return strips(*args)[:h]
        frame = graph(*args)
        if group is not None and not in_graph:
            dist.all_reduce(frame, op=dist.ReduceOp.SUM, group=group)
        return frame[:h]

    run.graph = graph
    return run


def render_space_parallel(splats, cam: Camera, bg, rcfg: RenderConfig,
                          group):
    """One-shot: render `splats` in strips over the processes of `group`."""
    n = 1 if group is None else dist.get_world_size(group)
    dev = splats.means.device
    cam_stack, _ = strip_camera_inputs(cam, rcfg.img_size, n, device=dev)
    fn = make_space_parallel_render(group, rcfg)
    return fn(splats.means, splats.log_scales, splats.quats,
              splats.sh_coeffs, splats.raw_opacities, cam_stack,
              torch.as_tensor(bg, dtype=torch.float32, device=dev))
