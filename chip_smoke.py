#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`brush_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: 1M splats at 1920x1080

Phases, each of which must pass (any failure exits non-zero):

1. build   — compiles the CUDA kernels of brush_tpu_torch/csrc with nvcc
             (one process per source, all at once) and loads them.
2. serve   — the port's serving path through its user entry points:
             `bench_splats` -> `fold_min_scale` -> `plan_caps` ->
             `render(RenderConfig(use_pallas=True, forward_only=True))`
             over 3 views; asserts no capacity overflow and a finite,
             non-empty image; prints the median ms per frame (CUDA events,
             untraced frames), the host's time to enqueue a frame, and the
             per-stage split (separate traced frames). The launch counters
             are zeroed just before this phase and read just after it:
             every kernel of the path must have launched.
3. golden  — renders the gsplat golden fixture tests/data/basic_case
             through the same CUDA path and holds it to the fixture image.
4. train   — the training path: `init_train_state` on the same 1M scene,
             a ground truth rendered from a second scene, and
             `train_step(state, batch, TrainConfig(), RenderConfig(
             use_pallas=True))`: one warm-up step, then timed steps with no
             synchronize inside; asserts no overflow, finite loss,
             parameters and moments, the step count, refine statistics
             and that every parameter array moved; prints step ms, host
             enqueue ms, the stage split and peak memory. Counters zeroed
             before, read after: every kernel of the training path must
             have launched.
5. golden-train — gradients of a render of the golden fixture through the
             CUDA path, held to tests/data/torch_train_golden.npz (the JAX
             package's oracle gradients; the card's machine has no JAX).
6. direct  — the scan kernel's f32-sum and int32-max variants, driven once
             at the width of the training scene's slot space.
7. stress  — the 30M-slot stress of the binning primitives
             (benches/tpu_smoke.py `scale_stress_30m`): Poisson(30) counts
             over 1M owners scaled to 30M slots; `cumsum_rows` at [1, 30M]
             (int32 exact, f32 within its rule); `expand_segments` of a
             2-row table with starts past 2^24, checked at sampled owners;
             `stack_rows` of the result at 30M lanes; `fill_rows` of the
             table scattered to its starts, which must equal the expansion;
             then `expand_segments` and `fill_rows` once at the binning
             shape (the served scene's 17-row table, remainder starts and
             counts, `isect_cap` slots), held to the emission's remainder
             rows. Every launch of the phase is replayed against its plain
             version bit for bit. Counters zeroed before, read after.
8. loop    — the training loop at full width: the 1M scene in a capacity of
             2^21, three views with rendered ground truth,
             `TrainConfig(refine_every=8)`, 24 turns of `process.loop_step`
             (a `train_step`, the one-step-behind overflow check, capacity
             growth, `refine_step` at steps 8, 16 and 24). Asserts each
             refine's
             bookkeeping, an inert dead tail, a zero refine record after a
             refine, finite parameters, moments and losses, `step == 24`,
             and that no step overflowed once the host had grown the
             capacities. Prints step and refine times and peak memory. The
             launches of step 1 and of step 9 (the first after a refine)
             are kept for the kernel phase.
9. eval    — `eval_views` over the three views before and after the loop,
             and of the ground truth's own scene (PSNR above 60 dB, SSIM
             within 1e-3 of 1).
10. init-lod — `create_random_splats(10_000)` and `to_init_splats` of
             100,000 random points, each rendered once; `pup_scores` of the
             trained scene over 2 views x 2 probes and `decimate_to_count`
             to half: finite scores, the live count halved, the kept set
             the top-scoring set. One scoring view's launches are kept for
             the kernel phase, as are those of one view of the evaluation
             after the loop.
11. kernels — each kernel against its plain PyTorch version, on the card,
             on the inputs the serving frame, the training step, the direct
             calls, the stress run, two loop steps, an evaluation view and
             a LOD scoring view gave it (scan, stack, emit, expand
             and fill bit-exact; the forward rasterizers within a few ulps;
             the backward within 1e-5 of each gradient row's largest entry;
             the f32 scan within 1e-6 of the running sum of |x|), with its
             time (CUDA events over back-to-back calls, `ms`, which a small
             kernel's host call rate can set), its device time (the device
             ops of the same calls under torch.profiler, `device_ms`; a scan
             call and a diet forward call must run one kernel and a
             backward call its two, and at most one memset), the plain
             version's time, a library call's where one computes the same
             function, and its bound on the card; the int32 scan's and the
             diet forward's wrapper host time a call, piece by piece
             (`wrapper_us`); the diet kernel's device time in tile order
             and longest tile first; and, for each backward launch, the
             per-slot reduce the backward used to need after it (an
             [11, S] zero-fill and `index_add_` of the plain per-slot
             gradients), timed at the same shapes beside the fused kernel.
12. profile — frames, training steps, loop steps and refines (of the
             state one step before the loop's last refine, so the refine
             selects and splits) under torch.profiler: the device's busy
             time, its idle share and the top device ops.

The last lines are the `kernels` JSON, the card's name and power limit
from nvidia-smi, and the result JSON. No GPU, or no brush_tpu_torch next to
this script: exit 2 with no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The headline serving scene (bench.py:40-54): 1M random splats of SH
# degree 3 from seed 42 at 1920x1080; the bench camera and two copies
# yawed by +-0.3 rad.
N_SPLATS = 1_000_000
IMG_SIZE = (1920, 1080)
SH_DEGREE = 3
SEED = 42
N_VIEWS = 3
YAW = 0.3
FRAMES = 12          # timed frames after the warm-up
TRAIN_STEPS = 5      # timed training steps after the warm-up step
ITERS = 20           # launches per kernel timing
STRESS_SLOTS = 30_000_000   # slots of the stress run (over N_SPLATS owners)
LOOP_CAPACITY = 1 << 21     # splat capacity of the loop phase
LOOP_STEPS = 24
REFINE_EVERY = 8
INIT_RANDOM = 10_000        # the default init_count of a training run
INIT_POINTS = 100_000       # point-cloud init (the KD-tree path)
LOD_VIEWS, LOD_PROBES = 2, 2

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations the blend spends on one (pixel, slot) pair: 2 sub, 7 mul,
# 2 add for sigma; negate, exp, mul, min for alpha; 2 gate compares; sub,
# mul, compare for the next T; 1 mul for the weight; 3 mul + 3 add for
# colour (max(rgb, 0) is taken once per slot, not per pair).
RASTER_OPS_PER_PAIR = 27
# The backward replays the forward for every (pixel, slot) pair of a tile's
# useful range until the pixel is done: the 27 above less the 6 of colour,
# 21. Where the pair was blended it does about 54 more: 3 mul + 2 add for
# v_w; mul + sub for r_after; mul, add, sub, div, sub for v_alpha; 1
# compare with the saturation cutoff; negate + mul for v_sigma; 3 + 3 for
# the two conic-times-offset sums and 2 + 2 for v_xy; 3 + 2 + 3 mul for
# v_conic; 1 mul for v_opac; 3 mul for v_rgb; 2 mul, 2 squares, add, sqrt,
# mul for the refine weight; 11 adds into the slot's sums.
BWD_REPLAY_OPS_PER_PAIR = 21
BWD_BLEND_OPS_PER_PAIR = 54

# Device ops a call of these kernels' wrappers may run: their own launches
# (the scan and the diet forward: one; the backward: its gradient kernel
# and the launch that rounds its f64 sums to f32) and at most one memset.
OWN_LAUNCHES = {"scan": 1, "scan_f32": 1, "scan_max": 1, "rasterize_fwd": 1,
                "rasterize_bwd": 2}

KERNEL_META = {
    "scan": ("brush_tpu_torch/csrc/scan.cu",
             "brush_tpu/ops/scan_pallas.py:43", "ops/scan_pallas.py:_scan_kernel"),
    "stack": ("brush_tpu_torch/csrc/stack.cu",
              "brush_tpu/ops/scan_pallas.py:167",
              "ops/scan_pallas.py:_stack_kernel"),
    "emit": ("brush_tpu_torch/csrc/emit.cu",
             "brush_tpu/ops/emit_pallas.py:133", "ops/emit_pallas.py:_emit_kernel"),
    "rasterize_fwd": ("brush_tpu_torch/csrc/rasterize.cu",
                      "brush_tpu/ops/rasterize_pallas.py:152",
                      "ops/rasterize_pallas.py:_fwd_kernel(fwd_only=True)"),
    "rasterize_fwd_train": ("brush_tpu_torch/csrc/rasterize.cu",
                            "brush_tpu/ops/rasterize_pallas.py:152",
                            "ops/rasterize_pallas.py:_fwd_kernel"
                            "(fwd_only=False)"),
    "rasterize_bwd": ("brush_tpu_torch/csrc/rasterize_bwd.cu",
                      "brush_tpu/ops/rasterize_pallas.py:431",
                      "ops/rasterize_pallas.py:_bwd_kernel with "
                      "_reduce_grads_sorted (:814)"),
    "scan_f32": ("brush_tpu_torch/csrc/scan.cu",
                 "brush_tpu/ops/scan_pallas.py:43",
                 "ops/scan_pallas.py:_scan_kernel (f32 sum)"),
    "scan_max": ("brush_tpu_torch/csrc/scan.cu",
                 "brush_tpu/ops/scan_pallas.py:43",
                 "ops/scan_pallas.py:_scan_kernel (int32 max)"),
    "expand": ("brush_tpu_torch/csrc/expand.cu",
               "brush_tpu/ops/expand_pallas.py:49",
               "ops/expand_pallas.py:_expand_kernel"),
    "fill": ("brush_tpu_torch/csrc/fill.cu",
             "brush_tpu/ops/scan_pallas.py:111",
             "ops/scan_pallas.py:_fill_kernel"),
}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, iters: int, warm: bool = True) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events, after one warm-up call unless `warm` is False: the caller has
    just run it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(torch, fn, iters: int, traces: int = 3) -> dict:
    """Device time of one call of `fn`: every device op (kernels, memsets,
    copies) that `iters` back-to-back calls launched, under torch.profiler,
    summed and divided by `iters` (after one warm-up call); and the ops a
    call launched, by kind. Unlike `time_ms` it leaves out the time the
    card waits for the host between launches. A trace on the H100 now and
    then drops ops or reads short durations, so each op's mean time counts
    the nearest whole number of times a call (every call launches the same
    ops), at least once, and of `traces` traces the median one is kept;
    `ops_by_trace` lists every trace's (kernels, memsets, copies) a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        # Device ops only: not the host's events, nor record_function
        # ranges mirrored on the device.
        host = {e.name for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA}
        per_op: dict = {}
        for e in events:
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)
                    or e.name in host):
                continue
            t, c = per_op.get(e.name, (0.0, 0))
            per_op[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        reading = dict(ms=0.0, kernels=0.0, memsets=0.0, copies=0.0)
        for name, (t, c) in per_op.items():
            per_call = float(max(1, round(c / iters)))
            reading["ms"] += t / c * per_call / 1e3
            reading["memsets" if name.startswith("Memset") else
                    "copies" if name.startswith("Memcpy") else
                    "kernels"] += per_call
        readings.append(reading)
    median = dict(sorted(readings, key=lambda r: r["ms"])[len(readings) // 2])
    median["ops_by_trace"] = [(r["kernels"], r["memsets"], r["copies"])
                              for r in readings]
    return median


def scan_wrapper_us(torch, x, calls: int = 200, repeats: int = 5) -> dict:
    """Host time, in microseconds a call, of the int32 scan's wrapper
    (`cumsum_rows`) on `x` and of its pieces: the checks and `contiguous`,
    the output's and the scratch's allocations, the stream handle and the
    C call (memset and launch, on buffers made once); `rest` (the dtype
    check, the scratch size, the library lookup, the launch count) is the
    call less those. Beside them, two alternatives (output and scratch as
    views of one allocation; the stream object in place of the raw handle)
    and `torch.cumsum` with int32 output. Each is run `calls` times back to
    back, few enough that the launch queue never fills, so the host's time
    is read; the median of `repeats` runs."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.kernels import build
    from brush_tpu_torch.ops import scan_cuda

    rows, length = x.shape
    n = rows * length
    words = scan_cuda.scan_scratch_words(rows, length,
                                         scan_cuda.scan_tile_items())
    out = torch.empty_like(x)
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    lib = build.library()
    stream = build.stream_ptr(x.device)

    def one_allocation():
        buf = torch.empty(-(-n // 4) * 4 + 2 * words, dtype=x.dtype,
                          device=x.device)
        return buf[:n].view(rows, length), buf.data_ptr()

    pieces = {
        "call": lambda: scan_cuda.cumsum_rows(x),
        "checks": lambda: (kernels.require_cuda("cumsum_rows", x),
                           x.contiguous()),
        "empty_out": lambda: torch.empty_like(x),
        "empty_scratch": lambda: torch.empty(words, dtype=torch.int64,
                                             device=x.device),
        "stream": lambda: build.stream_ptr(x.device),
        "c_call": lambda: lib.brush_scan_rows_i32(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), words, rows,
            length, stream),
        "one_allocation": one_allocation,
        "stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "torch_cumsum": lambda: torch.cumsum(x, dim=1, dtype=x.dtype),
    }
    us = host_us(torch, pieces, calls, repeats)
    us["rest"] = us["call"] - sum(us[k] for k in (
        "checks", "empty_out", "empty_scratch", "stream", "c_call"))
    return us


def diet_wrapper_us(torch, inputs, calls: int = 200,
                    repeats: int = 5) -> dict:
    """Host time, in microseconds a call, of the diet forward's wrapper
    (`rasterize_forward`) on a launch's inputs and of its pieces: the
    checks and `contiguous`, the one allocation (tiles and work counter),
    the stream handle and the C call (memset and launch); `rest` is the
    call less those. Beside them, `tile_order` (the sort and int32 cast a
    longest-first order would add). Timed as `scan_wrapper_us` does."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.kernels import build
    from brush_tpu_torch.ops import rasterize_cuda as rc

    soa, ranges, bg, img_size = inputs
    n_tiles = ranges.shape[0]
    words = torch.empty(n_tiles * rc.OUT_ROWS * rc.TILE_PIX + 1,
                        dtype=torch.float32, device=soa.device)
    lib = build.library()
    stream = build.stream_ptr(soa.device)
    pieces = {
        "call": lambda: rc.rasterize_forward(*inputs),
        "checks": lambda: (
            rc._check("rasterize_forward", soa, torch.int32, rc.DIET_WORDS,
                      ranges, bg, img_size),
            kernels.require_cuda("rasterize_forward", soa, ranges, bg),
            soa.contiguous(), ranges.contiguous(), bg.contiguous()),
        "empty": lambda: torch.empty(n_tiles * rc.OUT_ROWS * rc.TILE_PIX + 1,
                                     dtype=torch.float32, device=soa.device),
        "stream": lambda: build.stream_ptr(soa.device),
        "c_call": lambda: lib.brush_rasterize_fwd_diet(
            soa.data_ptr(), soa.shape[1], ranges.data_ptr(), None,
            bg.data_ptr(), words.data_ptr(), words[-1:].data_ptr(), n_tiles,
            stream),
        "tile_order": lambda: rc.tile_order(ranges),
    }
    us = host_us(torch, pieces, calls, repeats)
    us["rest"] = us["call"] - sum(us[k] for k in (
        "checks", "empty", "stream", "c_call"))
    return us


def diet_order_ms(torch, launch) -> dict:
    """Device ms a call of the diet kernel on a launch's inputs with its
    parts handed out in tile order (as the wrapper does) and longest tile
    first (`tile_order`), this with and without the sort that forms the
    order; the longest-first tiles held to the plain version too."""
    from brush_tpu_torch.ops import rasterize_cuda as rc

    soa, ranges, bg, _ = launch.inputs
    n_tiles = ranges.shape[0]
    order = rc.tile_order(ranges)
    sorted_first = rc._launch_diet(soa, ranges, bg, n_tiles, order)
    launch.compare(sorted_first, rc.rasterize_forward_plain(*launch.inputs))
    del sorted_first
    ms = {
        "tile_order": lambda: rc._launch_diet(soa, ranges, bg, n_tiles, None),
        "longest_first": lambda: rc._launch_diet(soa, ranges, bg, n_tiles,
                                                 order),
        "longest_first_with_sort": lambda: rc._launch_diet(
            soa, ranges, bg, n_tiles, rc.tile_order(ranges)),
    }
    return {k: device_time(torch, fn, ITERS)["ms"] for k, fn in ms.items()}


def host_us(torch, pieces, calls: int, repeats: int) -> dict:
    """Median over `repeats` runs of each piece's host time, microseconds a
    call over `calls` back-to-back calls."""
    us = {}
    for name, fn in pieces.items():
        runs = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
        us[name] = sorted(runs)[repeats // 2]
    torch.cuda.synchronize()
    return us


def read_safetensors(path: str) -> dict:
    """Minimal reader of the safetensors format (f32 tensors)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] != "F32":
            raise ValueError(f"{name}: unsupported dtype {meta['dtype']}")
        b, e = meta["data_offsets"]
        out[name] = np.frombuffer(data[b:e], dtype="<f4").reshape(meta["shape"])
    return out


def first_run(captured, n_runs: int):
    """The launches of the first of `n_runs` equal runs captured in a row
    (one view of an evaluation, one view of the LOD scoring)."""
    return list(captured[:len(captured) // n_runs])


def held_mib(torch, captured) -> float:
    """MiB of device memory the captured launches' inputs keep alive."""
    seen, todo = {}, [launch.inputs for launch in captured]
    while todo:
        x = todo.pop()
        if torch.is_tensor(x):
            store = x.untyped_storage()
            seen[store.data_ptr()] = store.nbytes()
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
    return sum(seen.values()) / 2 ** 20


def views(n_views: int, yaw: float):
    """The bench camera (bench.py:35-37) and copies orbited about the scene
    by +-yaw, +-2*yaw, ... around the vertical axis, looking at the origin."""
    from brush_tpu_torch.camera import Camera
    angles = [0.0]
    k = 1
    while len(angles) < n_views:
        angles += [k * yaw, -k * yaw]
        k += 1
    cams = []
    for a in angles[:n_views]:
        pos = np.array([-18.0 * np.sin(a), 0.0, -18.0 * np.cos(a)])
        rot = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0])
        cams.append((a, Camera(position=pos, rotation=rot, fov_x=1.0,
                               fov_y=0.62)))
    return cams


def phase_build():
    from brush_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] kernels ready in {secs:.3f} s "
        f"(nvcc build: {build.BUILD_SECONDS}); sources {build.CSRC}")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")
    return secs


def phase_serve(torch):
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    from brush_tpu_torch.utils.synthetic import bench_splats
    from brush_tpu_torch.utils.tracing import record_stages, stage_ms

    img = IMG_SIZE
    t0 = time.perf_counter()
    splats = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED)
    s = splats.fold_min_scale()
    params = (s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities)
    bg = torch.zeros(3, dtype=torch.float32, device="cuda")
    plans = []
    for angle, cam in views(N_VIEWS, YAW):
        ci = camera_inputs(cam, img)
        k0, cap = plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                            ci, img)
        cfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                           isect_cap=cap, expand_k0=k0, use_pallas=True,
                           forward_only=True)
        plans.append((angle, ci, cfg))
        log(f"[serve] view yaw={angle:+.2f} rad: expand_k0={k0} "
            f"isect_cap={cap} slots={N_SPLATS * k0 + cap}")
    torch.cuda.synchronize()
    log(f"[serve] scene {N_SPLATS} splats sh{SH_DEGREE} at "
        f"{img[0]}x{img[1]}, set-up {time.perf_counter() - t0:.3f} s")

    kernels.reset_launches()
    captured = None
    n_frames = 0
    # Warm-up: one frame per view (the first also records every kernel's
    # inputs for the kernel phase), then the timed frames.
    for i, (angle, ci, cfg) in enumerate(plans):
        if i == 0:
            with kernels.capture() as cap_list:
                out, aux = render(*params, ci, bg, cfg)
            captured = list(cap_list)
        else:
            out, aux = render(*params, ci, bg, cfg)
        n_frames += 1
        torch.cuda.synchronize()
        num_isects = int(aux.num_isects)
        check(num_isects <= cfg.isect_cap,
              f"capacity overflow at yaw {angle}: {num_isects} > {cfg.isect_cap}")
        check(tuple(out.shape) == (img[1], img[0], 4),
              f"image shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite pixels")
        alpha = out[..., 3]
        cover = float((alpha > 1.0 / 255.0).float().mean())
        check(cover > 0.01, f"image is empty (coverage {cover})")
        log(f"[serve] yaw={angle:+.2f}: visible={int(aux.num_visible)} "
            f"remainder={num_isects}/{cfg.isect_cap} "
            f"bbox_tail={int(aux.num_bbox_tail)} "
            f"max_per_tile={int(aux.max_isects_per_tile)} "
            f"alpha_mean={float(alpha.mean()):.4f} coverage={cover:.4f}")
    def frame(f):
        _, ci, cfg = plans[f % len(plans)]
        return render(*params, ci, bg, cfg)

    # Timed frames, untraced: device time from CUDA events around each
    # frame, and the host's time to enqueue it (nothing in a frame waits
    # for the card, so a host that enqueues slower than the card runs
    # leaves the card idle).
    events, host_ms = [], []
    for f in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out, _ = frame(f)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    n_frames += FRAMES
    check(bool(torch.isfinite(out).all()), "non-finite pixels (timed run)")
    ms = [a.elapsed_time(b) for a, b in events]
    # Traced frames: one CUDA event pair per stage gives the stage split.
    traced = 2 * len(plans)
    with record_stages() as recs:
        for f in range(traced):
            frame(f)
        torch.cuda.synchronize()
        stages = {k: v / traced for k, v in stage_ms(recs).items()}
    n_frames += traced
    launches = dict(kernels.LAUNCHES)
    log(f"[serve] frames={FRAMES} median_ms={statistics.median(ms):.4f} "
        f"min_ms={min(ms):.4f} max_ms={max(ms):.4f} "
        f"fps={1000.0 / statistics.median(ms):.3f} "
        f"host_enqueue_median_ms={statistics.median(host_ms):.4f}")
    log(f"[serve] per-stage ms/frame over {traced} traced frames (CUDA "
        f"events on the stream; sum {sum(stages.values()):.4f}): "
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"[serve] launches over {n_frames} frames: {json.dumps(launches)}")
    for name in kernels.SERVE_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(median_ms=statistics.median(ms), stages=stages,
                host_ms=statistics.median(host_ms), launches=launches,
                frames=n_frames, captured=captured, frame=frame,
                splats=splats, plans=plans)


def phase_golden(torch):
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    path = os.path.join(REPO, "tests", "data", "basic_case.safetensors")
    d = read_safetensors(path)
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = Camera(position=np.array([0.123, 0.456, -8.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                 fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    cfg = RenderConfig(img_size=(w, h), sh_degree=3, isect_cap=1 << 14,
                       use_pallas=True, forward_only=True)
    args = [torch.from_numpy(d[k].copy()).cuda()
            for k in ("means", "scales", "quats", "coeffs", "opacities")]
    img, aux = render(*args, camera_inputs(cam, (w, h)),
                      torch.zeros(3, device="cuda"), cfg)
    diff = np.abs(img.cpu().numpy() - d["out_img"])
    log(f"[golden] basic_case {w}x{h}: max_abs={diff.max():.6g} "
        f"mean_abs={diff.mean():.6g} (bar: max < 2/255, mean < 2e-4)")
    check(diff.max() < 2.0 / 255.0 and diff.mean() < 2e-4,
          "golden image mismatch")


def phase_train(torch, serve):
    """The training path at full width: a few `train_step`s on the served
    scene against a ground truth rendered from a second scene."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops import loss as loss_mod
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import (
        SceneBatch, init_train_state, train_step)
    from brush_tpu_torch.utils.synthetic import bench_splats
    from brush_tpu_torch.utils.tracing import record_stages, stage_ms

    img = IMG_SIZE
    _, ci, serve_cfg = serve["plans"][0]
    t0 = time.perf_counter()
    # Ground truth: another random scene through the forward-only render,
    # so the gradients are those of a real image and not of noise.
    other = bench_splats(N_SPLATS, sh_degree=SH_DEGREE,
                         seed=SEED + 1).fold_min_scale()
    k0, cap = plan_caps(other.means, other.log_scales, other.quats,
                        other.raw_opacities, ci, img)
    gt_img, _ = render(
        other.means, other.log_scales, other.quats, other.sh_coeffs,
        other.raw_opacities, ci, torch.zeros(3, device="cuda"),
        RenderConfig(img_size=img, sh_degree=SH_DEGREE, isect_cap=cap,
                     expand_k0=k0, use_pallas=True, forward_only=True))
    gt_packed = loss_mod.pack_gt(gt_img[..., :3])
    del other, gt_img
    batch = SceneBatch(gt_packed=gt_packed, cam=ci)
    # SSIM of an image against itself reads 1 only if the blur is exact
    # float32 (a TF32 or bf16 convolution reads far lower).
    gt_rgb, _ = loss_mod.unpack_gt(gt_packed)
    self_ssim = float(loss_mod.ssim(gt_rgb, gt_packed))
    check(abs(self_ssim - 1.0) < 1e-5, f"ssim(x, x) = {self_ssim}")
    # What autograd keeps for the loss: peak over one forward + backward.
    pred = torch.rand((img[1], img[0], 3), device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss_mod.image_loss(pred, gt_packed, loss_mod.ImageLossConfig()).backward()
    torch.cuda.synchronize()
    loss_peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    del pred, gt_rgb

    tcfg = TrainConfig()
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                        isect_cap=serve_cfg.isect_cap,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    state0 = init_train_state(serve["splats"], SEED)
    torch.cuda.synchronize()
    log(f"[train] scene {N_SPLATS} splats sh{SH_DEGREE} at {img[0]}x{img[1]}"
        f", expand_k0={rcfg.expand_k0} isect_cap={rcfg.isect_cap}, ground "
        f"truth from seed {SEED + 1}, ssim(gt, gt)={self_ssim:.7f}, loss "
        f"forward+backward peak {loss_peak_mb:.1f} MiB, median_scale="
        f"{float(state0.median_scale):.4f}, set-up "
        f"{time.perf_counter() - t0:.3f} s")

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with kernels.capture() as cap_list:
        state, stats, aux = train_step(state0, batch, tcfg, rcfg)
    captured = list(cap_list)
    torch.cuda.synchronize()
    all_stats = [stats]
    events, host_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        state, stats, aux = train_step(state, batch, tcfg, rcfg)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        events.append((start, end))
        all_stats.append(stats)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_steps = 1 + TRAIN_STEPS
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [a.elapsed_time(b) for a, b in events]

    losses = [float(st.loss) for st in all_stats]
    check(not any(bool(st.overflowed) for st in all_stats),
          f"a step overflowed: num_isects={int(aux.num_isects)} of "
          f"{rcfg.isect_cap}, num_chunks={int(aux.num_chunks)} of "
          f"{rcfg.resolved_chunk_cap(N_SPLATS)}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(int(state.step) == n_steps, f"step {int(state.step)}")
    moved = {}
    for name, new in state.splats.params().items():
        check(bool(torch.isfinite(new).all()), f"{name} not finite")
        for which in ("moment1", "moment2"):
            check(bool(torch.isfinite(getattr(state.opt[name], which)).all()),
                  f"{name}.{which} not finite")
        moved[name] = int((new != getattr(state0.splats, name)).sum())
        check(moved[name] > 0, f"no entry of {name} changed")
    check(float(state.refine.visible_count.max()) > 0, "nothing visible")
    check(float(state.refine.refine_weight.max()) > 0, "no refine weight")
    log(f"[train] steps={TRAIN_STEPS} median_ms={statistics.median(ms):.4f} "
        f"min_ms={min(ms):.4f} max_ms={max(ms):.4f} "
        f"host_enqueue_median_ms={statistics.median(host_ms):.4f} "
        f"peak_memory_MiB={peak_mb:.1f}")
    log(f"[train] losses {[round(x, 6) for x in losses]} visible="
        f"{int(aux.num_visible)} remainder={int(aux.num_isects)}/"
        f"{rcfg.isect_cap} num_chunks={int(aux.num_chunks)} "
        f"splats_blended_in_some_step="
        f"{int((state.refine.visible_count > 0).sum())} entries moved "
        + json.dumps(moved))

    def step_fn(_):
        return train_step(state, batch, tcfg, rcfg)

    traced = 2
    with record_stages() as recs:
        for i in range(traced):
            step_fn(i)
        torch.cuda.synchronize()
        stages = {k: v / traced for k, v in stage_ms(recs).items()}
    log(f"[train] per-stage ms/step over {traced} traced steps (CUDA events; "
        f"`backward` contains `rasterize_bwd` and `reduce`): "
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"[train] launches over {n_steps} steps: {json.dumps(launches)}")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(median_ms=statistics.median(ms), stages=stages,
                host_ms=statistics.median(host_ms), launches=launches,
                steps=n_steps, captured=captured, step=step_fn,
                peak_mb=peak_mb, loss_peak_mb=loss_peak_mb, losses=losses)


def phase_golden_train(torch):
    """Gradients of the golden fixture's render through the CUDA path
    against the JAX package's oracle gradients, stored by
    tests/make_torch_train_golden.py (same scene, camera, background and
    loss)."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.render import (
        RenderConfig, camera_inputs, render_with_refine)
    d = read_safetensors(os.path.join(REPO, "tests", "data",
                                      "basic_case.safetensors"))
    with np.load(os.path.join(REPO, "tests", "data",
                              "torch_train_golden.npz")) as f:
        want = {k: f[k] for k in f.files}
    h, w = d["out_img"].shape[:2]
    focal = (w / 2.0) / np.tan(np.pi / 4.0)
    cam = Camera(position=np.array([0.123, 0.456, -8.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                 fov_x=np.pi / 2, fov_y=2 * np.arctan((h / 2.0) / focal))
    cfg = RenderConfig(img_size=(w, h), sh_degree=3, isect_cap=1 << 14,
                       use_pallas=True)
    keys = ("means", "scales", "quats", "coeffs", "opacities")
    params = [torch.from_numpy(d[k].copy()).cuda().requires_grad_(True)
              for k in keys]
    n = params[0].shape[0]
    holders = [torch.zeros(n, device="cuda", requires_grad=True)
               for _ in range(2)]
    img, _ = render_with_refine(
        *params, camera_inputs(cam, (w, h)),
        torch.tensor([0.1, 0.25, 0.4], device="cuda"), cfg, *holders)
    rows = torch.linspace(0.5, 1.5, h, device="cuda")[:, None, None]
    chan = torch.tensor([1.0, 0.8, 0.6, 0.4], device="cuda")
    loss = (img * rows * chan).sum()
    grads = torch.autograd.grad(loss, params + holders)
    got = dict(zip(keys + ("refine_weight", "visible"),
                   (g.cpu().numpy() for g in grads)))
    worst = 0.0
    for k in keys + ("refine_weight",):
        rel = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
        worst = max(worst, rel)
        check(rel <= 1e-4, f"golden gradient {k}: max|d| {rel:.3g} of the "
              f"largest entry (bar 1e-4)")
    flips = int((got["visible"] != want["visible"]).sum())
    rel_loss = abs(float(loss.detach()) - float(want["loss"])) / abs(
        float(want["loss"]))
    log(f"[golden-train] basic_case {w}x{h}: loss rel diff {rel_loss:.3g}, "
        f"worst gradient max|d| {worst:.3g} of its array's largest entry "
        f"(bar 1e-4), visibility flips {flips} of {n} (bar 0)")
    check(rel_loss <= 1e-5 and flips == 0, "golden training render mismatch")


def phase_direct(torch, train):
    """The scan kernel's two other variants at the width of the training
    scene's slot space: an [11, S] f32 sum (the shape the per-slot
    gradient matrix had, and the JAX reduce's scan) and a [S] int32 running
    max."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops import scan_cuda
    bwd = next(launch for launch in train["captured"]
               if launch.name == "rasterize_bwd")
    width = bwd.inputs[0].shape[1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((11, width), generator=gen, device="cuda")
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (width,), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    kernels.reset_launches()
    with kernels.capture() as cap_list:
        sums = scan_cuda.cumsum_rows(x)
        tops = scan_cuda.cummax_1d(keys)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(bool(torch.isfinite(sums).all()), "f32 scan not finite")
    check(int(tops[-1]) == int(keys.max()), "running max does not end at max")
    log(f"[direct] scan_f32 [11, {width}] and scan_max [{width}] launched: "
        f"{launches['scan_f32']}, {launches['scan_max']}")
    check(launches["scan_f32"] > 0 and launches["scan_max"] > 0,
          "a scan variant was not launched")
    return dict(launches=launches, captured=list(cap_list))


def phase_stress(torch, serve):
    """The 30M-slot stress of the binning primitives, then one expansion
    and one fill at the binning shape of the served scene."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops import emit_cuda, expand_cuda, scan_cuda

    n, m = N_SPLATS, STRESS_SLOTS
    rng = np.random.default_rng(5)
    counts_np = rng.poisson(30.0, n).astype(np.int32)
    counts_np = (counts_np * (m / counts_np.sum())).astype(np.int32)
    vals_np = rng.standard_normal(n).astype(np.float32)
    counts = torch.from_numpy(counts_np).cuda()
    vals = torch.from_numpy(vals_np).cuda()

    def scattered(table, starts, run_counts, width):
        """The table's columns written at their owners' starts, and the
        lanes so written marked valid: what `fill_rows` expands."""
        owners = run_counts > 0
        at = starts[owners].long()
        x = torch.zeros((table.shape[0], width), dtype=table.dtype,
                        device=table.device)
        x[:, at] = table[:, owners]
        valid = torch.zeros(width, dtype=torch.int32, device=table.device)
        valid[at] = 1
        return x, valid

    kernels.reset_launches()
    with kernels.capture() as cap_list:
        # Prefix sums at 30M lanes. The exact check is the int32 scan's: the
        # true prefix at lane 2^24 is 2^24 + 1, which float32 cannot hold.
        ones_i = torch.ones((1, m), dtype=torch.int32, device="cuda")
        cs_i = scan_cuda.cumsum_rows(ones_i)
        check(bool(torch.equal(cs_i[0], torch.arange(
            1, m + 1, dtype=torch.int32, device="cuda"))),
            "int32 cumsum of 30M ones is not 1..30M")
        ones_f = torch.ones((1, m), dtype=torch.float32, device="cuda")
        cs_f = scan_cuda.cumsum_rows(ones_f)
        probes = [0, 12345, 2 ** 24 - 1, m - 1]
        got = [float(cs_f[0, i]) for i in probes]
        log(f"[stress] cumsum [1, {m}]: int32 exact; f32 at lanes {probes}: "
            f"{got}")
        del ones_i, cs_i, cs_f, ones_f

        cum = scan_cuda.cumsum_rows(counts[None, :])[0]
        check(bool(torch.equal(cum.cpu(), torch.from_numpy(
            np.cumsum(counts_np, dtype=np.int64).astype(np.int32)))),
            "cumsum of the counts differs from numpy's")
        total = int(cum[-1])
        starts = cum - counts
        check(total > 2 ** 24, f"total {total} does not pass 2^24")

        # Expansion with starts past 2^24.
        table = torch.stack([vals, counts.to(torch.float32)])
        out = expand_cuda.expand_segments(table, starts, counts, total)
        starts_np = starts.cpu().numpy()
        for g in (0, n // 3, n - 1):
            if counts_np[g] == 0:
                continue
            s0 = int(starts_np[g])
            seg = out[0, s0:s0 + int(counts_np[g])]
            check(bool((seg == float(vals_np[g])).all()),
                  f"expansion of owner {g} at start {s0} is wrong")
        check(int(starts_np[n - 1]) > 2 ** 24, "no start past 2^24")

        # The row stack at 30M lanes.
        soa = scan_cuda.stack_rows([out[0], out[1]], 4, m)
        check(float(soa[0, 123456]) == float(out[0, 123456])
              and tuple(soa.shape) == (4, -(-m // scan_cuda.BLK)
                                       * scan_cuda.BLK),
              "stack at 30M lanes is wrong")
        del soa

        # The fill of the scattered table is the expansion.
        x, valid = scattered(table, starts, counts, total)
        filled = scan_cuda.fill_rows(x, valid)
        kernels.same_bits(filled, out)
        del x, valid, filled, out

        # The binning shape: the served scene's 17-row table, remainder
        # starts and counts, isect_cap slots.
        emit = next(launch for launch in serve["captured"]
                    if launch.name == "emit")
        tbl, n_b, k0, rem_cap, _ = emit.inputs
        table_b = tbl[:emit_cuda.TABLE_ROWS, :n_b]
        rem_starts = tbl[emit_cuda.TABLE_ROWS, :n_b].view(torch.int32)
        rem_counts = torch.clamp_min(tbl[14, :n_b].to(torch.int32) - k0, 0)
        rem_needed = int(rem_counts.sum())
        check(0 < rem_needed <= rem_cap, f"remainder {rem_needed}/{rem_cap}")
        exp_b = expand_cuda.expand_segments(table_b, rem_starts, rem_counts,
                                            rem_cap)
        x, valid = scattered(table_b, rem_starts, rem_counts, rem_cap)
        fill_b = scan_cuda.fill_rows(x, valid)
        kernels.same_bits(fill_b[:, :rem_needed], exp_b[:, :rem_needed])
        check(not bool(exp_b[:, rem_needed:].any()),
              "expansion wrote past the last run")
        # The emission spreads the same ten payload rows over its remainder
        # region (its plain version: no launch in this phase's counts).
        _, rows10 = emit.replay(emit.inputs)[1]()
        kernels.same_bits(
            exp_b[:emit_cuda.PAYLOAD_ROWS, :rem_needed],
            rows10[:, n_b * k0:n_b * k0 + rem_needed])
        del x, valid, fill_b, exp_b, rows10
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    captured = list(cap_list)
    for launch in captured:
        launch.check()
    torch.cuda.synchronize()
    log(f"[stress] {n} owners, {total} slots (last start "
        f"{int(starts_np[n - 1])} > 2^24): expand [2, {total}], stack "
        f"[4, {m}] and fill agree; binning shape [17, {rem_cap}] "
        f"(remainder {rem_needed}) agrees with the emission's rows; "
        f"{len(captured)} launches replayed against their plain versions "
        f"bit for bit (f32 scan within its rule); launches "
        f"{json.dumps(launches)}")
    for name in kernels.STRESS_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(launches=launches, captured=captured, total=total)


def _ground_truths(torch, scene, cams):
    """One forward-only render of `scene` per camera, packed as ground
    truth words; returns [(camera, CameraInputs, gt_packed)]."""
    from brush_tpu_torch.ops import loss as loss_mod
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    s = scene.fold_min_scale()
    out = []
    for _, cam in cams:
        ci = camera_inputs(cam, IMG_SIZE)
        k0, cap = plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                            ci, IMG_SIZE)
        img, aux = render(
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities, ci,
            torch.zeros(3, device="cuda"),
            RenderConfig(img_size=IMG_SIZE, sh_degree=SH_DEGREE,
                         isect_cap=cap, expand_k0=k0, use_pallas=True,
                         forward_only=True))
        check(int(aux.num_isects) <= cap, "ground truth render overflowed")
        out.append((cam, ci, loss_mod.pack_gt(img[..., :3])))
    return out


def phase_eval(torch, what, splats, truths, rcfg, bar=None, keep=False):
    """`eval_views` of `splats` over the views of `truths`. With `bar`
    (min PSNR dB, max |1 - SSIM|) the scene is held to it. With `keep` the
    first view's launches are returned for the kernel phase."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.train.eval import eval_views
    kernels.reset_launches()
    t0 = time.perf_counter()
    with kernels.capture() as cap_list:
        stats = eval_views(splats, [(cam, gt) for cam, _, gt in truths], rcfg)
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    captured = first_run(cap_list, len(truths)) if keep else []
    del cap_list
    log(f"[eval] {what}: psnr={stats.psnr:.4f} dB ssim={stats.ssim:.6f} "
        f"per view psnr {[round(x, 4) for x in stats.per_view_psnr]} ssim "
        f"{[round(x, 6) for x in stats.per_view_ssim]} "
        f"({secs * 1e3 / len(truths):.1f} ms a view with its host reads)")
    check(len(stats.per_view_psnr) == len(truths), "a view is missing")
    check(not any(np.isnan(stats.per_view_psnr + stats.per_view_ssim)),
          "eval metric is NaN")
    check(all(0.0 < x <= 1.0 + 1e-6 for x in stats.per_view_ssim),
          f"ssim out of range: {stats.per_view_ssim}")
    if bar is not None:
        min_psnr, max_ssim_gap = bar
        check(min(stats.per_view_psnr) > min_psnr
              and abs(stats.ssim - 1.0) < max_ssim_gap,
              f"{what}: psnr {stats.per_view_psnr} ssim {stats.ssim} outside "
              f"the bar (> {min_psnr} dB, |1 - ssim| < {max_ssim_gap})")
    for name in kernels.SERVE_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(psnr=stats.psnr, ssim=stats.ssim, launches=launches,
                captured=captured)


def phase_loop(torch, serve):
    """The training loop at full width: 24 turns of `loop_step` over three
    views, a refine every 8 steps, evaluation before and after."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.models.splats import DEAD_RAW_OPACITY
    from brush_tpu_torch.process import LoopState, loop_step
    from brush_tpu_torch.render import RenderConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.refine import refine_step
    from brush_tpu_torch.train.trainer import SceneBatch, init_train_state
    from brush_tpu_torch.utils.synthetic import bench_splats
    from brush_tpu_torch.utils.tracing import record_stages, stage_ms

    img = IMG_SIZE
    t0 = time.perf_counter()
    cams = views(N_VIEWS, YAW)
    teacher = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED + 1)
    truths = _ground_truths(torch, teacher, cams)
    student = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED,
                           capacity=LOOP_CAPACITY)
    _, _, serve_cfg = serve["plans"][0]
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                        isect_cap=serve_cfg.isect_cap,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    eval_cfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                            isect_cap=serve_cfg.isect_cap,
                            expand_k0=serve_cfg.expand_k0, use_pallas=True,
                            forward_only=True)
    tcfg = TrainConfig(refine_every=REFINE_EVERY)
    batches = [SceneBatch(gt_packed=gt, cam=ci) for _, ci, gt in truths]
    centers = torch.tensor(np.stack([cam.position for cam, _, _ in truths]),
                           dtype=torch.float32, device="cuda")
    focals = torch.tensor([cam.focal(img)[0] for cam, _, _ in truths],
                          dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"[loop] scene {N_SPLATS} splats in a capacity of {LOOP_CAPACITY}, "
        f"sh{SH_DEGREE}, {img[0]}x{img[1]}, {N_VIEWS} views, refine every "
        f"{REFINE_EVERY}, expand_k0={rcfg.expand_k0} isect_cap="
        f"{rcfg.isect_cap}; set-up {time.perf_counter() - t0:.3f} s")

    # The ground truth's own scene evaluates to itself: the same render and
    # the same 8-bit rounding on both sides. The bar (60 dB, 1e-3) leaves
    # room for a pixel at a rounding edge; the first run read inf and 1.
    ev_teacher = phase_eval(torch, "teacher against its own ground truth",
                            teacher, truths, eval_cfg, bar=(60.0, 1e-3))
    del teacher
    ev_before = phase_eval(torch, "student before the loop", student, truths,
                           eval_cfg)

    loop = LoopState(state=init_train_state(student, SEED), rcfg=rcfg)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    events, all_stats, messages, alive_before = [], [], [], {}
    # The kernel phase replays the launches of the first step (a capacity
    # whose second half is dead) and of the first step after a refine (a
    # scene the refine has permuted and grown).
    captured_steps = (1, REFINE_EVERY + 1)
    captured = []
    with record_stages() as recs:
        for i in range(LOOP_STEPS):
            if (i + 1) % REFINE_EVERY == 0:
                alive_before[i + 1] = loop.state.splats.n_alive
            if i + 1 == LOOP_STEPS:
                # One train_step short of the state the last refine sees:
                # its record holds the steps since the refine before.
                before_last_refine = loop.state
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with (kernels.capture() if i + 1 in captured_steps
                  else contextlib.nullcontext([])) as cap_list:
                loop, stats, msgs = loop_step(loop, batches[i % N_VIEWS],
                                              tcfg, centers, focals)
            captured += cap_list
            end.record()
            events.append((start, end))
            all_stats.append(stats)
            messages += msgs
            if any(m.kind == "refine" for m in msgs):
                rec = loop.state.refine
                check(not bool(rec.refine_weight.any() | rec.visible_count.any()
                               | rec.max_radius.any()),
                      "refine record not zero after a refine")
        torch.cuda.synchronize()
        stages = stage_ms(recs)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    held_mb = held_mib(torch, captured)
    ms = [a.elapsed_time(b) for a, b in events]
    state = loop.state

    refines = [m for m in messages if m.kind == "refine"]
    overflows = [m for m in messages if m.kind == "overflow"]
    refine_steps = list(range(REFINE_EVERY, LOOP_STEPS + 1, REFINE_EVERY))
    check([m.iter for m in refines] == refine_steps,
          f"refines at {[m.iter for m in refines]}")
    for m in refines:
        d = m.data
        before = int(alive_before[m.iter])
        check(d["total"] == before - d["pruned"] + d["added"],
              f"refine at {m.iter}: {d} from {before} live")
        check(d["added"] == d["oversized"] + d["resampled"] + d["grad_grown"],
              f"refine at {m.iter}: selection counts {d}")
        log(f"[loop] refine at step {m.iter}: {before} live -> "
            + json.dumps(d))
    for m in overflows:
        log(f"[loop] overflow seen after step {m.iter}: "
            + json.dumps(m.data))
    flags = [bool(st.overflowed) for st in all_stats]
    settled = max([m.iter + 1 for m in overflows], default=0)
    check(not any(flags[settled:]),
          f"a step overflowed after the capacities were grown: steps "
          f"{[i + 1 for i, f in enumerate(flags) if f]}, grown after "
          f"{[m.iter for m in overflows]}")
    losses = [float(st.loss) for st in all_stats]
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(int(state.step) == LOOP_STEPS and loop.it == LOOP_STEPS,
          f"step {int(state.step)}")
    n_alive = int(state.splats.n_alive)
    check(n_alive == refines[-1].data["total"], "live count moved")
    cap = state.splats.capacity
    check(bool((state.splats.raw_opacities[n_alive:]
                == DEAD_RAW_OPACITY).all()), "dead tail is not inert")
    for name, new in state.splats.params().items():
        check(bool(torch.isfinite(new[:n_alive]).all()),
              f"{name} not finite")
        for which in ("moment1", "moment2"):
            mom = getattr(state.opt[name], which)
            check(bool(torch.isfinite(mom).all()),
                  f"{name}.{which} not finite")
            check(not bool(mom[n_alive:].any()),
                  f"{name}.{which} not zero in the dead tail")
    plain = [t for i, t in enumerate(ms) if (i + 1) % REFINE_EVERY]
    log(f"[loop] steps={LOOP_STEPS} step_median_ms="
        f"{statistics.median(plain):.4f} (steps without a refine; min "
        f"{min(plain):.4f} max {max(plain):.4f}) refine_steps_ms="
        f"{[round(ms[i - 1], 4) for i in refine_steps]} refine_ms="
        f"{stages.get('refine', 0.0) / len(refines):.4f} (device time of "
        f"`refine_step`, mean of {len(refines)}) peak_memory_MiB="
        f"{peak_mb:.1f} (of it {held_mb:.1f} MiB are kernel inputs of steps "
        f"{list(captured_steps)}, kept for the kernel phase) "
        f"capacity={cap} live={n_alive} overflowed_steps="
        f"{[i + 1 for i, f in enumerate(flags) if f]} isect_cap="
        f"{loop.rcfg.isect_cap}")
    log(f"[loop] losses {[round(x, 6) for x in losses]}")
    log(f"[loop] launches over {LOOP_STEPS} steps: {json.dumps(launches)}")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")

    ev_after = phase_eval(torch, "student after the loop", state.splats,
                          truths, dataclasses.replace(
                              eval_cfg, isect_cap=loop.rcfg.isect_cap),
                          keep=True)
    # The refine the profile phase runs: it must select something.
    _, rstats = refine_step(before_last_refine, tcfg, centers, focals)
    profiled_refine = dict(
        live=int(before_last_refine.splats.n_alive),
        added=int(rstats.num_added), pruned=int(rstats.num_pruned),
        grad_grown=int(rstats.num_grad_grown), total=int(rstats.total_splats))
    check(profiled_refine["added"] > 0, "the profiled refine selects nothing")
    log(f"[loop] the refine the profile phase runs (the state one step "
        f"before the last refine, its record of steps "
        f"{LOOP_STEPS - REFINE_EVERY + 1}-{LOOP_STEPS - 1}): "
        + json.dumps(profiled_refine))
    return dict(step_median_ms=statistics.median(plain),
                refine_ms=stages.get("refine", 0.0) / len(refines),
                refine_step_ms=[ms[i - 1] for i in refine_steps],
                peak_mb=peak_mb, held_mb=held_mb,
                launches=launches, captured=captured,
                eval_launches=ev_after["launches"],
                eval_captured=ev_after["captured"],
                profiled_refine=profiled_refine,
                steps=LOOP_STEPS, losses=losses,
                refines=[m.data for m in refines],
                overflows=[m.data for m in overflows],
                psnr=dict(teacher=ev_teacher["psnr"],
                          before=ev_before["psnr"], after=ev_after["psnr"]),
                ssim=dict(teacher=ev_teacher["ssim"],
                          before=ev_before["ssim"], after=ev_after["ssim"]),
                state=state, rcfg=loop.rcfg, truths=truths,
                step=lambda i: loop_step(loop, batches[i % N_VIEWS], tcfg,
                                         centers, focals),
                refine=lambda _: refine_step(before_last_refine, tcfg,
                                             centers, focals))


def phase_init_lod(torch, loop):
    """Both splat initialisations rendered once; PUP scores of the trained
    scene and its decimation to half."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, render
    from brush_tpu_torch.train.lod import decimate_to_count, pup_scores
    from brush_tpu_torch.train.splat_init import (
        create_random_splats, to_init_splats)

    truths = loop["truths"]
    cams = [cam for cam, _, _ in truths]
    _, ci, _ = truths[0]
    kernels.reset_launches()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    random_init = create_random_splats(INIT_RANDOM, cams, rng,
                                       sh_degree=SH_DEGREE)
    t_random = time.perf_counter() - t0
    points = rng.normal(0.0, [3.0, 2.0, 5.0], (INIT_POINTS, 3)).astype(
        np.float32)
    t0 = time.perf_counter()
    cloud_init = to_init_splats(points).with_sh_degree(SH_DEGREE)
    t_cloud = time.perf_counter() - t0
    for what, s, secs in (("create_random_splats", random_init, t_random),
                          ("to_init_splats", cloud_init, t_cloud)):
        k0, cap = plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                            ci, IMG_SIZE)
        img, aux = render(
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities, ci,
            torch.zeros(3, device="cuda"),
            RenderConfig(img_size=IMG_SIZE, sh_degree=SH_DEGREE,
                         isect_cap=cap, expand_k0=k0, use_pallas=True,
                         forward_only=True))
        visible = int(aux.num_visible)
        check(int(aux.num_isects) <= cap and visible > 0
              and bool(torch.isfinite(img).all()),
              f"{what}: visible={visible} remainder={int(aux.num_isects)}"
              f"/{cap}")
        log(f"[init-lod] {what}: {int(s.n_alive)} splats in {secs:.3f} s on "
            f"the host, visible={visible} coverage="
            f"{float((img[..., 3] > 1.0 / 255.0).float().mean()):.4f}")

    # LOD scoring of the trained scene, as the process bakes a level.
    splats = loop["state"].splats
    n_alive = int(splats.n_alive)
    score_cams = [ci for _, ci, _ in truths[:LOD_VIEWS]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernels.capture() as cap_list:
        scores = pup_scores(splats, score_cams, loop["rcfg"], SEED,
                            n_probes=LOD_PROBES)
    torch.cuda.synchronize()
    t_scores = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # The first view's launches (a render and one backward a probe) go to
    # the kernel phase.
    captured = first_run(cap_list, LOD_VIEWS)
    held_mb = held_mib(torch, cap_list)
    del cap_list
    # H + 1e-12 I is positive definite, so every live splat scores finite;
    # a splat no probe touched sits at the floor 6 ln(1e-12) = -165.8.
    live = scores[:n_alive]
    seen = live > 6.0 * np.log(1e-12) + 1.0
    check(tuple(scores.shape) == (splats.capacity,), "score shape")
    check(bool(torch.isfinite(live).all()) and int(seen.sum()) > 0,
          "PUP score not finite on a live splat, or no splat seen")
    keep = n_alive // 2
    kept = decimate_to_count(splats, scores, keep)
    check(int(kept.n_alive) == keep, f"kept {int(kept.n_alive)} of {keep}")
    # The kept rows are the live rows in falling order of score (ties in
    # row order), and their scores are the `keep` largest live scores.
    order = torch.argsort(-live, stable=True)[:keep]
    check(bool(torch.equal(kept.means[:keep], splats.means[order])),
          "the kept rows are not the best-scoring rows in order")
    top = torch.topk(live, keep).values
    check(bool(torch.equal(live[order], top)),
          "the kept set is not the top-scoring set")
    launches = dict(kernels.LAUNCHES)
    log(f"[init-lod] pup_scores over {LOD_VIEWS} views x {LOD_PROBES} "
        f"probes on {n_alive} live splats: {t_scores:.3f} s, peak "
        f"{peak_mb:.1f} MiB; {int(seen.sum())} splats score above the "
        f"floor (the peak includes {held_mb:.1f} MiB of "
        f"kernel inputs kept for the kernel phase), min "
        f"{float(live[seen].min()):.3f} max "
        f"{float(live.max()):.3f}; kept {keep} "
        f"(lowest kept score {float(top[-1]):.3f}); launches "
        f"{json.dumps(launches)}")
    for name in kernels.TRAIN_PATH + ("rasterize_fwd",):
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(launches=launches, captured=captured, pup_seconds=t_scores,
                pup_peak_mb=peak_mb)


def plain_counted(launch, plain):
    """The plain version's result on a launch's inputs, from one run, with
    what `kernel_work` counts from that run: for the rasterizers the
    (pixel, slot) pairs, for the backward also its per-slot gradients
    (before the per-splat sum). (result, pairs or None, slot gradients or
    None)."""
    from brush_tpu_torch.ops import rasterize_cuda as rc
    name, inputs = launch.name, launch.inputs
    if name == "rasterize_fwd":
        tiles, pairs = rc.rasterize_forward_plain(*inputs, count_pairs=True)
        return tiles, (pairs,), None
    if name == "rasterize_fwd_train":
        tiles, schedule, pairs = rc.rasterize_forward_train_plain(
            *inputs, count_pairs=True)
        return (tiles, schedule), (pairs,), None
    if name == "rasterize_bwd":
        slot_grads, replayed, blended = rc.rasterize_backward_plain(
            *inputs[:6], count_pairs=True)
        return (rc.reduce_slot_grads(slot_grads, inputs[6], inputs[7]),
                (replayed, blended), slot_grads)
    return plain(), None, None


def kernel_work(launch, got, pairs):
    """(bytes the function must move, f32 operations it must do, shape) for
    one launch on these inputs: each input read once, each output written
    once; the rasterizers' operations count the (pixel, slot) pairs this
    run's data needs, `pairs` from `plain_counted` (forward: before each
    pixel is done; backward: pairs replayed, up to each 8x4 part's own
    useful length, and pairs blended)."""
    import torch

    from brush_tpu_torch.ops import emit_cuda, rasterize_cuda
    name, inputs = launch.name, launch.inputs
    if name.startswith("scan"):
        (x,) = inputs
        return 2 * x.numel() * 4, x.numel(), list(x.shape)
    if name == "stack":
        rows, _, _ = inputs
        return (len(rows) * rows[0].numel() * 4 + got.numel() * 4, 0,
                [len(rows), rows[0].numel(), *got.shape])
    if name == "expand":
        table, starts, _, cap = inputs
        rows, n = table.shape
        return rows * n * 4 + 8 * n + rows * cap * 4, 0, [rows, n, cap]
    if name == "fill":
        x, valid = inputs
        return 2 * x.numel() * 4 + valid.numel() * 4, 0, list(x.shape)
    if name == "emit":
        _, n, k0, rem_cap, _ = inputs
        s_cap = got[0].numel()
        return ((emit_cuda.TABLE_ROWS + 1) * n * 4
                + s_cap * (8 + 4 * emit_cuda.PAYLOAD_ROWS), 0,
                [n, k0, rem_cap, s_cap])
    ranges = inputs[1]
    spans = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    n_tiles = ranges.shape[0]
    tile_bytes = rasterize_cuda.TILE_PIX * 4
    if name == "rasterize_fwd":
        return (int(spans.sum()) * rasterize_cuda.DIET_WORDS * 4
                + n_tiles * (8 + rasterize_cuda.OUT_ROWS * tile_bytes) + 12,
                int(pairs[0]) * RASTER_OPS_PER_PAIR,
                [n_tiles, int(spans.sum()), int(spans.max())])
    if name == "rasterize_fwd_train":
        return (int(spans.sum()) * rasterize_cuda.TRAIN_ROWS * 4
                + n_tiles * (8 + rasterize_cuda.TRAIN_OUT_ROWS * tile_bytes)
                + 12,
                int(pairs[0]) * RASTER_OPS_PER_PAIR,
                [n_tiles, int(spans.sum()), int(spans.max())])
    # rasterize_bwd: reads the replayed slots' nine attributes and splat
    # ids, the saved and cotangent tiles and the schedule (tile order, part
    # lengths); writes the [11, n] per-splat sums.
    replayed, blended = pairs
    useful = inputs[2][:, 5, 0].to(torch.int64)
    return (int(useful.sum()) * (rasterize_cuda.TRAIN_ROWS + 1) * 4
            + n_tiles * (8 + (rasterize_cuda.TRAIN_OUT_ROWS
                              + rasterize_cuda.V_ROWS) * tile_bytes) + 12
            + n_tiles * (1 + rasterize_cuda.TILE_PARTS) * 4
            + got.numel() * 4,
            int(replayed) * BWD_REPLAY_OPS_PER_PAIR
            + int(blended) * BWD_BLEND_OPS_PER_PAIR,
            [n_tiles, int(useful.sum()), int(useful.max()), int(replayed),
             int(blended)])


def slot_reduce_ms(torch, inputs, slot_grads) -> float:
    """Device time of what the backward ran besides its kernel before it
    summed per splat itself: the memset of the [11, S] per-slot
    buffer, and `reduce_slot_grads` (a zeroed [11, n] and the `index_add_`
    over the slots' splat ids) of the per-slot gradients (here the plain
    version's, `plain_counted`'s), on a backward launch's inputs."""
    from brush_tpu_torch.ops import rasterize_cuda
    gid, n = inputs[6], inputs[7]

    def reduce():
        torch.zeros_like(slot_grads)      # the per-slot buffer's memset
        return rasterize_cuda.reduce_slot_grads(slot_grads, gid, n)
    return device_time(torch, reduce, ITERS)["ms"]


def phase_kernels(torch, serve, train, direct, stress, loop, init_lod):
    """Replay every launch of the first served frame, of the first training
    step, of the direct calls, of the stress run, of two loop steps (the
    first, and the first after a refine), of one view of the evaluation
    after the loop and of one view of the LOD scoring: kernel against plain
    version on the same inputs (each kernel module's own `compare` holds
    them), then the kernel's, the plain version's and the library call's
    times. A kernel is listed under the first of those paths that launched
    it; where a later one did too (scan, stack and emit in the training
    step; the scans and the stack in the stress run; every render and
    training kernel in the loop, the evaluation and the LOD scoring, over a
    capacity whose second half is dead) it is held and timed at those
    shapes as well, as `<path>_ms`, the sum over that path's replayed
    launches. `launches_by_path` holds the counters of every path driven,
    each read after that path's own run."""
    from brush_tpu_torch import kernels

    def repeat_columns(inputs):
        table, _, counts, cap = inputs
        total = int(counts.sum())
        check(total <= cap, "repeat_interleave computes the expansion only "
              "where no run is cut")
        return lambda: torch.repeat_interleave(table, counts, dim=1,
                                               output_size=total)

    # One PyTorch call that computes the same function, where there is one
    # (the cumsum in the input's dtype: int32 in, int32 out). No single call
    # computes the stack, whose [total_rows, padded] output is zero-padded:
    # `torch.stack` writes only the rows' own n x L words.
    library = {
        "scan": lambda inp: lambda: torch.cumsum(inp[0], dim=1,
                                                 dtype=inp[0].dtype),
        "scan_f32": lambda inp: lambda: torch.cumsum(inp[0], dim=1,
                                                     dtype=inp[0].dtype),
        "scan_max": lambda inp: lambda: torch.cummax(inp[0], dim=0),
        "expand": repeat_columns,
    }
    # The plain rasterizers and emission are slow at full width, the plain
    # expansion and fill at 30M slots: time them over fewer calls.
    plain_iters = {"emit": 2, "rasterize_fwd": 1, "rasterize_fwd_train": 1,
                   "rasterize_bwd": 1, "expand": 2, "fill": 2}

    def measure(name, launches):
        r = dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                 library_ms=0.0 if name in library else None,
                 library_device_ms=0.0 if name in library else None,
                 err=0.0, bytes=0, ops=0, shape=[], parts=[])
        for launch in launches:
            kernel, plain = launch.replay(launch.inputs)
            got = kernel()
            want, pairs, slot_grads = plain_counted(launch, plain)
            torch.cuda.synchronize()
            err = launch.compare(got, want)
            del want
            nbytes, ops, shape = kernel_work(launch, got, pairs)
            del got
            dev = device_time(torch, kernel, ITERS)
            lib = (library[name](launch.inputs) if name in library
                   else None)
            part = dict(
                shape=shape, ms=time_ms(torch, kernel, ITERS),
                device_ms=dev["ms"],
                device_ops={k: dev[k] for k in ("kernels", "memsets",
                                                "copies")},
                plain_ms=time_ms(torch, plain, plain_iters.get(name, ITERS),
                                 warm=False),
                library_ms=(time_ms(torch, lib, ITERS) if lib else None),
                library_device_ms=(device_time(torch, lib, ITERS)["ms"]
                                   if lib else None),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3)
            if name in OWN_LAUNCHES:
                # The kernel's own launches a call and at most the memset of
                # its scratch, nothing else, in some trace (a trace may drop
                # ops, never add).
                check(any(k == OWN_LAUNCHES[name] and m <= 1 and c == 0
                          for k, m, c in dev["ops_by_trace"]),
                      f"{name} {shape}: (kernels, memsets, copies) a call "
                      f"by trace {dev['ops_by_trace']}")
            if name == "rasterize_bwd":
                part["slot_reduce_device_ms"] = slot_reduce_ms(
                    torch, launch.inputs, slot_grads)
                r["slot_reduce_device_ms"] = (
                    r.get("slot_reduce_device_ms", 0.0)
                    + part["slot_reduce_device_ms"])
            del slot_grads
            r["err"] = max(r["err"], err)
            r["bytes"] += nbytes
            r["ops"] += ops
            r["shape"].append(shape)
            r["parts"].append(part)
            for key in ("ms", "device_ms", "plain_ms", "library_ms",
                        "library_device_ms"):
                if part[key] is not None:
                    r[key] += part[key]
        return r

    def by_name(captured):
        out: dict = {}
        for launch in captured:
            out.setdefault(launch.name, []).append(launch)
        return out

    # path -> (its counters, its captured launches by kernel, runs counted)
    paths = {
        "serve": (serve["launches"], by_name(serve["captured"]),
                  serve["frames"]),
        "train": (train["launches"], by_name(train["captured"]),
                  train["steps"]),
        "direct": (direct["launches"], by_name(direct["captured"]), 1),
        "stress": (stress["launches"], by_name(stress["captured"]), 1),
        "loop": (loop["launches"], by_name(loop["captured"]), loop["steps"]),
        "eval": (loop["eval_launches"], by_name(loop["eval_captured"]),
                 N_VIEWS),
        "init-lod": (init_lod["launches"], by_name(init_lod["captured"]), 1)}
    counters = {p: c for p, (c, _, _) in paths.items()}
    line = []
    for name in kernels.KERNEL_NAMES:
        path = next(p for p, (_, caps, _) in paths.items() if name in caps)
        counts, caps, n_runs = paths[path]
        r = measure(name, caps[name])
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / F32_OPS_PER_S * 1e3
        src, replaces, tpu = KERNEL_META[name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces, tpu=tpu,
            path=path, launches=counts[name],
            launches_per_run=counts[name] / n_runs,
            launches_by_path={p: c[name] for p, c in counters.items()},
            max_abs_err=r["err"], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"], shape=r["shape"],
            device_ops=[part["device_ops"] for part in r["parts"]])
        if len(r["parts"]) > 1:
            entry["per_launch"] = r["parts"]
        if "slot_reduce_device_ms" in r:
            entry["slot_reduce_device_ms"] = r["slot_reduce_device_ms"]
        also = ""
        for other, (o_counts, o_caps, o_runs) in paths.items():
            if other == path or name not in o_caps:
                continue
            # Also on this path: hold those launches to their plain versions
            # too, and time them at their shapes.
            ro = measure(name, o_caps[name])
            entry["max_abs_err"] = max(entry["max_abs_err"], ro["err"])
            entry.update({
                f"{other}_launches": o_counts[name],
                f"{other}_launches_per_run": o_counts[name] / o_runs,
                f"{other}_replayed": len(o_caps[name]),
                f"{other}_ms": ro["ms"], f"{other}_device_ms": ro["device_ms"],
                f"{other}_plain_ms": ro["plain_ms"],
                f"{other}_library_ms": ro["library_ms"],
                f"{other}_library_device_ms": ro["library_device_ms"],
                f"{other}_bound_ms": max(ro["bytes"] / HBM_BYTES_PER_S,
                                         ro["ops"] / F32_OPS_PER_S) * 1e3,
                f"{other}_shape": ro["shape"]})
            if "slot_reduce_device_ms" in ro:
                entry[f"{other}_slot_reduce_device_ms"] = ro[
                    "slot_reduce_device_ms"]
            also += (f"; on the {other} path: ms={ro['ms']:.5f} device_ms="
                     f"{ro['device_ms']:.5f} plain_ms={ro['plain_ms']:.5f} "
                     f"library_ms={ro['library_ms']} library_device_ms="
                     f"{ro['library_device_ms']} "
                     f"bound_ms={entry[f'{other}_bound_ms']:.5f} launches="
                     f"{o_counts[name]} replayed={len(o_caps[name])} "
                     f"shape={ro['shape']}")
            if len(ro["parts"]) > 1:
                entry[f"{other}_per_launch"] = ro["parts"]
                also += " per launch ms=" + json.dumps(
                    [round(part["ms"], 5) for part in ro["parts"]])
                also += " device_ms=" + json.dumps(
                    [round(part["device_ms"], 5) for part in ro["parts"]])
        line.append(entry)
        log(f"[kernels] {name} ({path}): agrees with plain (max_abs="
            f"{entry['max_abs_err']:.6g}); ms={r['ms']:.5f} device_ms="
            f"{r['device_ms']:.5f} (device ops a call "
            f"{json.dumps(entry['device_ops'][0])}) plain_ms="
            f"{r['plain_ms']:.5f} library_ms={r['library_ms']} "
            f"library_device_ms={r['library_device_ms']} bound_ms="
            f"{entry['bound_ms']:.5f} ({entry['bound_by']}) launches="
            f"{entry['launches']} by path "
            f"{json.dumps(entry['launches_by_path'])} shape={r['shape']}"
            + also)
        for part in r["parts"] if len(r["parts"]) > 1 else []:
            log(f"[kernels]   {name} {part['shape']}: ms={part['ms']:.5f} "
                f"device_ms={part['device_ms']:.5f} plain_ms="
                f"{part['plain_ms']:.5f} library_ms={part['library_ms']} "
                f"library_device_ms={part['library_device_ms']} bound_ms="
                f"{part['bound_ms']:.5f}")
    # The backward against what the per-slot design ran besides its kernel,
    # path by path (ms a path's replayed launches together).
    bwd = next(e for e in line if e["name"] == "rasterize_bwd")
    yard = {bwd["path"]: (bwd["device_ms"], bwd["slot_reduce_device_ms"])}
    for other in paths:
        if f"{other}_device_ms" in bwd:
            yard[other] = (bwd[f"{other}_device_ms"],
                           bwd[f"{other}_slot_reduce_device_ms"])
    log("[kernels] rasterize_bwd yardstick, device ms by path: the fused "
        "kernel with its memset and rounding launch, and the per-slot "
        "design's [11, S] memset "
        "+ `index_add_` reduce at the same shapes (its kernel aside): "
        + json.dumps({p: {"fused": round(a, 5), "slot_reduce": round(b, 5)}
                      for p, (a, b) in yard.items()}))
    # Which of the scan wrapper's pieces sets its host time a call, at the
    # served frame's binning shape.
    scan_entry = next(e for e in line if e["name"] == "scan")
    scan_entry["wrapper_us"] = scan_wrapper_us(
        torch, paths["serve"][1]["scan"][0].inputs[0])
    log("[kernels] scan wrapper at the served frame's shape, host us a "
        "call: " + json.dumps({k: round(v, 3)
                               for k, v in scan_entry["wrapper_us"].items()}))
    # The diet forward: its wrapper's host pieces at the served frame, and
    # what a longest-first tile order would change at the served frame and
    # at an evaluation view after the loop.
    diet = next(e for e in line if e["name"] == "rasterize_fwd")
    diet["wrapper_us"] = diet_wrapper_us(
        torch, paths["serve"][1]["rasterize_fwd"][0].inputs)
    diet["order_device_ms"] = {
        p: diet_order_ms(torch, paths[p][1]["rasterize_fwd"][0])
        for p in ("serve", "eval") if "rasterize_fwd" in paths[p][1]}
    log("[kernels] rasterize_fwd wrapper at the served frame, host us a "
        "call: " + json.dumps({k: round(v, 3)
                               for k, v in diet["wrapper_us"].items()})
        + "; device ms a call by tile order: "
        + json.dumps({p: {k: round(v, 5) for k, v in o.items()}
                      for p, o in diet["order_device_ms"].items()}))
    return line


def phase_profile(torch, what: str, run, stage_names, n_frames: int) -> dict:
    """Device busy time and idle share of `run(i)` (a serving frame or a
    training step), from a torch.profiler trace of `n_frames` runs (the
    profiler's own overhead lengthens the wall time the busy time is
    divided by)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(n_frames):
            run(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    # Device ops only: kernels, copies and fills, without the stage ranges
    # (record_function names), which the trace also shows on the device.
    stage_names = set(stage_names)
    per_op: dict = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in stage_names):
            continue
        t, c = per_op.get(e.name, (0.0, 0))
        per_op[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy_ms = sum(t for t, _ in per_op.values()) / n_frames
    n_ops = sum(c for _, c in per_op.values()) / n_frames
    log(f"[profile] {what}, {n_frames} runs: wall {wall_ms:.4f} ms each, "
        f"device busy {busy_ms:.4f} ms, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {n_ops:.1f} device ops each")
    for name, (t, c) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[profile]   {t / n_frames:9.4f} ms x{c / n_frames:6.1f}  "
            f"{name[:100]}")
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, device_ops=n_ops)


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "brush_tpu_torch", "csrc")):
        print("chip_smoke: brush_tpu_torch/ not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # Float32 stays float32: no TF32 in any matmul or convolution.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 off")

    t_all = time.perf_counter()
    phase_build()
    serve = phase_serve(torch)
    phase_golden(torch)
    train = phase_train(torch, serve)
    phase_golden_train(torch)
    direct = phase_direct(torch, train)
    stress = phase_stress(torch, serve)
    loop = phase_loop(torch, serve)
    init_lod = phase_init_lod(torch, loop)
    kernel_line = phase_kernels(torch, serve, train, direct, stress, loop,
                                init_lod)
    profiled = phase_profile(torch, "serving frame", serve["frame"],
                             serve["stages"], N_VIEWS)
    profiled_train = phase_profile(torch, "training step", train["step"],
                                   train["stages"], 2)
    profiled_loop = phase_profile(torch, "loop step (no refine)",
                                  loop["step"], train["stages"], 2)
    profiled_refine = phase_profile(torch, "refine_step", loop["refine"],
                                    ["refine"], 2)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"frame_median_ms": serve["median_ms"],
                      "host_enqueue_median_ms": serve["host_ms"],
                      "stages_ms": serve["stages"], **profiled}))
    print(json.dumps({"train_step_median_ms": train["median_ms"],
                      "train_host_enqueue_median_ms": train["host_ms"],
                      "train_stages_ms": train["stages"],
                      "train_peak_memory_MiB": train["peak_mb"],
                      "loss_peak_memory_MiB": train["loss_peak_mb"],
                      "train_losses": train["losses"],
                      **{f"train_{k}": v
                         for k, v in profiled_train.items()}}))
    print(json.dumps({"loop_step_median_ms": loop["step_median_ms"],
                      "refine_ms": loop["refine_ms"],
                      "refine_step_ms": loop["refine_step_ms"],
                      "loop_peak_memory_MiB": loop["peak_mb"],
                      "loop_peak_held_for_kernels_MiB": loop["held_mb"],
                      "profiled_refine": loop["profiled_refine"],
                      "loop_losses": loop["losses"],
                      "refines": loop["refines"],
                      "overflows": loop["overflows"],
                      "eval_psnr_before": loop["psnr"]["before"],
                      "eval_psnr_after": loop["psnr"]["after"],
                      "eval_ssim_before": loop["ssim"]["before"],
                      "eval_ssim_after": loop["ssim"]["after"],
                      "pup_scores_seconds": init_lod["pup_seconds"],
                      "pup_peak_memory_MiB": init_lod["pup_peak_mb"],
                      **{f"loop_{k}": v for k, v in profiled_loop.items()},
                      **{f"refine_{k}": v
                         for k, v in profiled_refine.items()}}))
    print(json.dumps({"kernels": kernel_line}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
