#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`brush_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: 1M splats at 1920x1080

Phases, each of which must pass (any failure exits non-zero):

1. build   — compiles the CUDA kernels of brush_tpu_torch/csrc with nvcc
             (one process per source, all at once) and loads them; logs
             each kernel's register use.
2. serve   — the port's serving path through its user entry points:
             `bench_splats` -> `fold_min_scale` -> `plan_caps` ->
             `render(RenderConfig(use_pallas=True, forward_only=True))`
             over 3 views, then 12 frames more; asserts no capacity
             overflow and a finite, non-empty image. The launch counters
             are zeroed just before this phase and read just after it:
             every kernel of the path must have launched.
3. golden  — renders the gsplat golden fixture tests/data/basic_case
             through the same CUDA path and holds it to the fixture image.
4. train   — the training path: `init_train_state` on the same 1M scene,
             a ground truth rendered from a second scene, and
             `train_step(state, batch, TrainConfig(), RenderConfig(
             use_pallas=True))`: 1 + 5 steps with no synchronize inside;
             asserts no overflow, finite loss, parameters and moments, the
             step count, refine statistics and that every parameter array
             moved; logs the eager per-stage split of two traced steps.
             Counters zeroed before, read after: every kernel of the
             training path must have launched.
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
8. grow    — overflow growth on the card: the served scene in a splat
             capacity of 2^20 (95 % full), `isect_cap` a quarter of what
             the served frame of view 0 needed, refine every 3 steps, 6
             turns of `process.loop_step`: the first two steps overflow and
             leave the means unchanged, the host reports the overflow one
             step late with `isect_cap = _next_pow2(needed * 1.3)`, the
             first refine doubles the capacity to 2^21 (`_grow_state`),
             and the state is finite afterwards. The launches of step 1
             (overflowing) and of step 4 (the first at the grown
             capacities) are kept for the kernel phase.
9. loop    — the training loop at full width: the 1M scene in a capacity of
             2^21, three views with rendered ground truth,
             `TrainConfig(refine_every=8)`, 24 turns of `process.loop_step`
             (a `train_step`, the one-step-behind overflow check, capacity
             growth, `refine_step` at steps 8, 16 and 24). Asserts each
             refine's bookkeeping, an inert dead tail, a zero refine record
             after a refine, finite parameters, moments and losses,
             `step == 24`, and that no step overflowed once the host had
             grown the capacities. The launches of step 1 and of step 9
             (the first after a refine) are kept for the kernel phase.
10. eval   — `eval_views` over the three views before and after the loop,
             and of the ground truth's own scene (PSNR above 60 dB, SSIM
             within 1e-3 of 1); each evaluation renders through a
             RenderGraph it captures at its first view.
11. init-lod — `create_random_splats(10_000)` and `to_init_splats` of
             100,000 random points, each rendered once; the PUP scoring of
             the trained scene over 2 views x 2 probes, its views on a CUDA
             graph (captured at the first, replayed for the second) and
             eagerly from the same seed, the sums within 2 * BWD_RTOL of
             the largest; `decimate_to_count` to half: finite scores, the
             live count halved, the kept set the top-scoring set; a scoring
             view's replay launching every training kernel. One eager
             scoring view's launches and the graph's capture are kept for
             the kernel phase, as are those of one view of the evaluation
             after the loop.
12. process — `train_process` as a user runs it: a COLMAP binary scene
             the phase writes to a temporary directory (8 PINHOLE views of
             1920x1080 about the serve camera, the port's own 8-bit renders
             of a second 1M scene as PNG ground truth, the 1M scene as
             init.ply, so the capacity is 2^21), 24 steps, refine every 8,
             eval every 12 on the 2 held-out views, a checkpoint at 24, the
             final export and one LOD level. Counters zeroed before, read
             after: every training kernel and the diet forward must have
             launched. Asserts the pinned ground-truth upload equal to the
             pageable one, the message kinds, finite losses, no overflow
             after the host grew the capacities, the final PLY equal bit
             for bit to the checkpoint's folded live rows, the checkpoint
             restoring the step-24 state and generator bit for bit, the LOD
             level at half the splats, a compressed export a third of the
             size or less, the eval PSNR not falling by more than 0.5 dB;
             then resumes to step 26 and runs the CLI for 2 steps at 960
             px. Every turn must run on `StepGraphs` and every refine on
             `RefineGraphs`; the launches of the first capture after the
             first refine are kept for the kernel phase. The LOD bake again
             from its input, one loader thread: on graphs (its captures
             kept) and eagerly with the graphed run's scores, the baked
             states held by `hold_steps`, the scoring sums within
             2 * BWD_RTOL; the LOD step graph's replay launching every
             training kernel.
13. live   — on the process phase's dataset, `train_process(slot=...,
             on_message=...)` for 6 steps while `serve(slot=..., bus=...)`
             runs: /render fetched from another thread while training
             runs, a `step` message read from /events, /views listing the
             8 views, /gt?view=0 decoding. Counters zeroed before, read
             after: the training kernels and the diet forward launched.
14. ffi    — libbrush_tpu_torch_ffi.so built with g++ (Python.h must be
             where sysconfig says), loaded with ctypes; `brush_train_and_save`
             with {"device": "cuda"} for 2 steps of the process dataset at
             960 px: `step` and `export` messages and the export written;
             a second call cancelled from its first callback returns after
             one message.
15. viewer — the served scene written to a PLY and `serve(path)` on the
             card: /info, then /render at 1920x1080 for the orbit pose, a
             pose from q= and fovy=, and one with scale= and bg=: each JPEG
             1920x1080, each `render_pose` frame equal bit for bit to a
             direct `render` with the viewer's RenderConfig and its JPEG the
             /render answer; /splats of 16 + 59 x 4 x 10^6 bytes; /brush.js.
             Logs each pose's `num_isects` against the viewer's fixed
             `isect_cap` of 2^20 (slots past it are dropped, as in the JAX
             viewer). The frames are replays of the RenderGraph the first
             /render captures; that capture's launches are kept for the
             kernel phase.
16. lpips  — `random_lpips(0)` of two 256x256 images on the card within
             `LPIPS_RTOL` of the CPU, where TF32 convolutions must miss that
             bar; the weights written to an .npz and read with
             `load_lpips(ProcessConfig.lpips_weights)`; 1 + 3 `train_step`s
             of the train cell with `lpips_loss_weight=0.5`: finite losses
             and parameters, step 1's loss above the train phase's (same
             state, view and generator). The first step's launches are
             kept.
17. space  — the strip-sharded render at the serve cell: view 0 in
             `SPACE_STRIPS` strips from `strip_camera_inputs`, each with its
             own `plan_caps`, assembled and held to the full frame (coverage
             within `TIE_ALPHA_TOL`, the colour mean within
             `TIE_RGB_MEAN_TOL`: tied depth keys may blend in another order
             in a strip); each strip's `num_isects` against its cap; strip
             1's launches kept. Each strip again on a RenderGraph: equal to
             its eager render bit for bit, a replay under sync debug mode,
             a replay launching every serving kernel; strip 1's capture
             kept.
18. dp     — view-sharded training at the train cell (B = 2 views):
             (a) over a one-process NCCL group: the eager DP step
             (`train_step_impl` with the group's share), 3 steps held to
             `train_step_impl(batched=True)` from the same state (every
             state tensor within rtol 1e-5, atol 1e-6; step 2's launches
             kept); `make_dp_train_step`, which runs on a StepGraph over
             NCCL (the all_reduces captured; its capture kept): 3 steps
             held to the batched step by the same rule and to the eager DP
             step by `hold_steps` (bit for bit reported), a replay under
             sync debug mode, a replay launching every training kernel;
             the graphed batched step, 3 steps, against it; the strips'
             `run` over the group (one strip, the frame's all_reduce
             captured) equal to the eager `run` bit for bit; (b) 2 child
             processes of this script on the card over gloo (`--child
             ranks`): bit-identical replicas after every step, each held to
             (a)'s reference, a refine and one more step, the steps eager
             (gloo cannot be captured, and each says so), then the strips'
             `run` of the space phase's strips on a graph (the render
             captured, the gloo all_reduce eager), equal to the strips
             rendered here bit for bit; (c) a 2-process
             `torch.distributed.run` launch of `cli.main` on the process
             phase's dataset (`--child cli`, 6 steps, refine at 3): one
             export, finite losses, no overflow after growth, equal final
             states, the steps eager (gloo). With more than one card the
             multi-card case runs after it (below); with one, a line says
             it did not.
19. graph  — the JAX package's compiled, donated programs as CUDA graphs
             (brush_tpu_torch/graphs.py). An eager serve frame, training
             step and first loop turn under sync debug mode "error" (no
             copy from the host, no read back); the serve cell's frame as
             a RenderGraph, equal bit for bit to the eager frame for each
             view, and a profiled replay (each kernel's launches by device
             name); the train cell's 1 + 5 steps on StepGraphs against
             1 + 5 eager steps from the same state (losses and every state
             tensor within the backward's BWD_RTOL rule, the generator
             equal), and a profiled replay; the loop cell (24 `loop_step`
             turns on StepGraphs in a capacity of 2^21, refines at 8, 16,
             24: finite after each, no overflow after growth, eval PSNR
             within 0.05 dB of the eager loop's); the process phase's
             turns on StepGraphs; the loop cell's refine (the state one
             step before its last refine) on a RefineGraph, each replay
             equal to eager `refine_step` bit for bit (statistics and
             generator too), one under sync debug mode. Replays under sync
             debug mode too. The frame's and the step's capture launches
             are kept for the kernel phase.
20. project — the projection's two kernels at the benchmark cells' shapes:
             a training render's rows (1M live in a capacity of 2^21) with
             its backward, the 1M and the 2M (3200x1800) frames.
21. kernels — each kernel against its plain PyTorch version, on the card,
             on the inputs the projection phase, the serving frame, the
             training step, the direct calls, the stress run, two growth
             steps, two loop steps, an evaluation view, a LOD scoring view,
             a process step, a viewer frame, an LPIPS step, a DP step, a
             strip, and the graphs' captures (frame, step, the DP step over
             NCCL, a scoring view, the LOD bake, a strip) gave it (scan,
             stack, emit, expand, fill and the projection's forward
             bit-exact; the forward rasterizers within a few ulps; the
             backwards within 1e-5 of each gradient row's largest entry;
             the f32 scan within 1e-6 of the running sum of |x|); per path,
             its time (CUDA events over back-to-back calls, `ms`, which a
             small kernel's host call rate can set), its device time (the
             device ops of the same calls under torch.profiler,
             `device_ms`: a call must run its own kernels and at most its
             memsets, `kernels.KERNELS`; a trace that dropped them is taken
             again, and a reading of zero fails the phase), a library
             call's times where one computes the same function, and its
             bound on the card (`bound_ms`, `bound_by`).

The last lines are the JSON of what each phase's checks decided on, the
`kernels` JSON, the card's name and power limit from nvidia-smi, and the
result JSON. No GPU, or no brush_tpu_torch next to this script: exit 2 with
no result. `--child ranks|cli|cli-eager ...` runs one of the script's own
child processes.

    python3 chip_smoke.py --multi-card   # on a machine of 2 or more cards

runs the multi-card case alone: the process cell's dataset, then the CLI
under `torchrun --nproc-per-node N` (one card a process, NCCL, N views a
step) on graphs and eagerly, 12 steps, refine every 3, one loader thread:
each run's replicas equal, the graphed losses within 1e-3 of the eager
ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
FRAMES = 12          # frames after the warm-up
TRAIN_STEPS = 5      # training steps after the first
ITERS = 20           # launches per kernel timing
STRESS_SLOTS = 30_000_000   # slots of the stress run (over N_SPLATS owners)
LOOP_CAPACITY = 1 << 21     # splat capacity of the loop phase
LOOP_STEPS = 24
REFINE_EVERY = 8
INIT_RANDOM = 10_000        # the default init_count of a training run
INIT_POINTS = 100_000       # point-cloud init (the KD-tree path)
LOD_VIEWS, LOD_PROBES = 2, 2
# The overflow-growth run: the served scene in a capacity of 2^20 (95 %
# full), a tile-sort capacity a quarter of what a step needs.
GROW_CAPACITY = 1 << 20
GROW_STEPS = 6
GROW_REFINE_EVERY = 3
# The kernel phase replays the launches of the first step (it overflows:
# the emission's remainder is a quarter of what it needs) and of the first
# step at the grown capacities (2^21 splats, the grown tile-sort capacity).
GROW_CAPTURED_STEPS = (1, GROW_REFINE_EVERY + 1)
# The process phase: `train_process` over a COLMAP dataset of 8 views it
# writes (2 held out for eval), 24 steps on StepGraphs; the kernel phase
# replays the launches of the first capture after the first refine.
PROCESS_VIEWS = 8
PROCESS_STEPS = 24
# The live view: `train_process` steps over the process dataset while the
# viewer serves; the C ABI's run; the LPIPS term's steps after its
# captured first.
LIVE_STEPS = 6
FFI_STEPS = 2
LPIPS_STEPS = 3
# The dp phase: B views a step, steps compared, the step whose launches
# are kept, the processes of (b) and (c), and the CLI run's length.
DP_VIEWS = 2
DP_STEPS = 3
DP_CAPTURED_STEP = 2
MULTI_STEPS = 12    # steps of the multi-card CLI run (more than one card)
DP_RANKS = 2
DP_CLI_STEPS = 6
DP_CLI_REFINE_EVERY = 3
SPACE_STRIPS = 2
# The strips against the full frame: tied depth keys may blend in another
# order (phase_space), which moves coverage only through the T < 1e-4 stop
# (7.1e-4 at most where every depth ties, tests/test_torch_parallel.py)
# and colours at a few pixels.
TIE_ALPHA_TOL = 1e-3
TIE_RGB_MEAN_TOL = 1e-3
GROUP_TIMEOUT_S = 120       # a collective that waits longer fails
CHILD_TIMEOUT_S = 300       # a launch of child processes, start to exit
# LPIPS of two 256x256 images on the card against the CPU: the value,
# relative (about 9 float32 ulps of it), and each of the five VGG taps, max
# |d| over the tap's largest entry (the JAX package computes them at
# Precision.HIGHEST). On an H100 (80GB HBM3, 700 W) the float32 value read
# 0 and the taps up to 4.7e-6 from the CPU's; with TF32 the value 4.7e-6 and
# the taps up to 1.3e-3, so TF32 misses both bars.
LPIPS_RTOL = 1e-6
LPIPS_TAP_RTOL = 1e-4

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

class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events, after one warm-up call)."""
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


def device_time(torch, fn, iters: int, traces: int = 3, own: int = 1) -> dict:
    """Device time of one call of `fn`: every device op (kernels, memsets,
    copies) that `iters` back-to-back calls launched, under torch.profiler,
    summed and divided by `iters` (after one warm-up call); and the ops a
    call launched, by kind. Unlike `time_ms` it leaves out the time the
    card waits for the host between launches. A trace on the H100 now and
    then drops ops or reads short durations, so each op's mean time counts
    the nearest whole number of times a call (every call launches the same
    ops), at least once; a trace that saw fewer than `own` kernels a call
    (it dropped the kernel's own launches) is taken again, up to four
    times; and of `traces` traces the median one is kept. `ops_by_trace`
    lists every kept trace's (kernels, memsets, copies) a call, `retraced`
    the traces taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()

    def trace():
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
        return reading

    readings, retraced = [], 0
    for _ in range(traces):
        reading = trace()
        for _ in range(4):
            if reading["kernels"] >= own:
                break
            retraced += 1
            reading = trace()
        readings.append(reading)
    median = dict(sorted(readings, key=lambda r: r["ms"])[len(readings) // 2])
    median["ops_by_trace"] = [(r["kernels"], r["memsets"], r["copies"])
                              for r in readings]
    median["retraced"] = retraced
    return median


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
    build.library()
    log(f"[build] kernels ready; sources {build.CSRC}")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build]   {line.strip()}")


def phase_serve(torch):
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    from brush_tpu_torch.utils.synthetic import bench_splats

    img = IMG_SIZE
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
    log(f"[serve] scene {N_SPLATS} splats sh{SH_DEGREE} at "
        f"{img[0]}x{img[1]}")

    kernels.reset_launches()
    captured = None
    n_frames = 0
    isects = []
    # One frame per view (the first also records every kernel's inputs for
    # the kernel phase), then FRAMES more.
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
        isects.append(num_isects)
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
    for f in range(FRAMES):
        _, ci, cfg = plans[f % len(plans)]
        out, _ = render(*params, ci, bg, cfg)
    torch.cuda.synchronize()
    n_frames += FRAMES
    check(bool(torch.isfinite(out).all()), "non-finite pixels (later frame)")
    launches = dict(kernels.LAUNCHES)
    log(f"[serve] launches over {n_frames} frames: {json.dumps(launches)}")
    for name in kernels.SERVE_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(launches=launches, frames=n_frames, captured=captured,
                splats=splats, plans=plans, isects=isects)


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
    del gt_rgb

    tcfg = TrainConfig()
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                        isect_cap=serve_cfg.isect_cap,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    state0 = init_train_state(serve["splats"], SEED)
    log(f"[train] scene {N_SPLATS} splats sh{SH_DEGREE} at {img[0]}x{img[1]}"
        f", expand_k0={rcfg.expand_k0} isect_cap={rcfg.isect_cap}, ground "
        f"truth from seed {SEED + 1}, ssim(gt, gt)={self_ssim:.7f}, "
        f"median_scale={float(state0.median_scale):.4f}")

    kernels.reset_launches()
    with kernels.capture() as cap_list:
        state, stats, aux = train_step(state0, batch, tcfg, rcfg)
    captured = list(cap_list)
    all_stats = [stats]
    for _ in range(TRAIN_STEPS):
        state, stats, aux = train_step(state, batch, tcfg, rcfg)
        all_stats.append(stats)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_steps = 1 + TRAIN_STEPS

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
    log(f"[train] losses {[round(x, 6) for x in losses]} visible="
        f"{int(aux.num_visible)} remainder={int(aux.num_isects)}/"
        f"{rcfg.isect_cap} num_chunks={int(aux.num_chunks)} "
        f"splats_blended_in_some_step="
        f"{int((state.refine.visible_count > 0).sum())} entries moved "
        + json.dumps(moved))
    log(f"[train] launches over {n_steps} steps: {json.dumps(launches)}")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")

    # The eager per-stage split (CUDA events a stage) of two traced steps.
    traced = 2
    with record_stages() as recs:
        for _ in range(traced):
            train_step(state, batch, tcfg, rcfg)
        torch.cuda.synchronize()
        stages = {k: v / traced for k, v in stage_ms(recs).items()}
    log(f"[train] per-stage ms/step over {traced} traced steps (CUDA events; "
        f"`backward` contains `rasterize_bwd` and `reduce`): "
        + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    return dict(stages=stages, launches=launches, steps=n_steps,
                captured=captured, losses=losses, batch=batch)


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


def phase_grow(torch, serve, train):
    """Overflow growth and `_grow_state` on the card: the served scene in a
    capacity of 2^20 (95 % full) and a tile-sort capacity of a quarter of
    what the served frame of view 0 needed, against the training phase's
    ground truth. The first step overflows and is a no-op on the device;
    the host reads it one step late (the second step, already enqueued, is
    lost too) and grows `isect_cap`; the first refine doubles the splat
    buffer before it refines. (The refine comes every 3 steps, not every 2:
    a refine on step 2 would run in the turn that reports the second lost
    step and compact the rows before they can be checked.)"""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.process import LoopState, _next_pow2, loop_step
    from brush_tpu_torch.render import RenderConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import init_train_state
    from brush_tpu_torch.utils.synthetic import bench_splats

    img = IMG_SIZE
    serve_cfg = serve["plans"][0][2]
    cam = views(N_VIEWS, YAW)[0][1]
    splats = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED,
                          capacity=GROW_CAPACITY)
    cap0 = serve["isects"][0] // 4
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE, isect_cap=cap0,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    tcfg = TrainConfig(refine_every=GROW_REFINE_EVERY)
    centers = torch.tensor(cam.position[None], dtype=torch.float32,
                           device="cuda")
    focals = torch.tensor([cam.focal(img)[0]], dtype=torch.float32,
                          device="cuda")
    loop = LoopState(state=init_train_state(splats, SEED), rcfg=rcfg)
    start = loop.state.splats.means.clone()
    log(f"[grow] scene {N_SPLATS} splats in a capacity of {GROW_CAPACITY} "
        f"({N_SPLATS / GROW_CAPACITY:.3f} full), isect_cap={cap0} (a quarter "
        f"of the served frame's {serve['isects'][0]}), refine every "
        f"{GROW_REFINE_EVERY}")

    kernels.reset_launches()
    stats_all, kinds, messages = [], [], []
    means, capacity = [], []     # each step's means and splat capacity
    captured = []
    for i in range(GROW_STEPS):
        with (kernels.capture() if i + 1 in GROW_CAPTURED_STEPS
              else contextlib.nullcontext([])) as cap_list:
            loop, stats, msgs = loop_step(loop, train["batch"], tcfg,
                                          centers, focals)
        captured += cap_list
        stats_all.append(stats)
        kinds.append([m.kind for m in msgs])
        messages += msgs
        means.append(loop.state.splats.means)
        capacity.append(loop.state.splats.capacity)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    flags = [bool(st.overflowed) for st in stats_all]
    losses = [float(st.loss) for st in stats_all]
    overflow = next((m for m in messages if m.kind == "overflow"), None)
    refines = [m for m in messages if m.kind == "refine"]
    log(f"[grow] steps={GROW_STEPS} "
        f"overflowed={flags} messages={kinds} capacity={capacity} "
        f"losses={[round(x, 6) for x in losses]}")
    check(overflow is not None, "no overflow message")
    log(f"[grow] overflow seen after step {overflow.iter}: "
        + json.dumps(overflow.data))
    for m in refines:
        log(f"[grow] refine at step {m.iter}: " + json.dumps(m.data))
    log(f"[grow] launches over {GROW_STEPS} steps: {json.dumps(launches)}; "
        f"{len(captured)} launches of steps {list(GROW_CAPTURED_STEPS)} kept "
        f"for the kernel phase")

    state = loop.state
    check(flags == [True, True] + [False] * (GROW_STEPS - 2),
          f"overflowed steps {flags}: the first two steps must be lost")
    check(kinds == [[], ["overflow"], ["refine"], [], [], ["refine"]],
          f"messages by step {kinds}")
    check(overflow.iter == 1 and overflow.data["isects"] > cap0
          and overflow.data["isect_cap"] == _next_pow2(
              int(overflow.data["isects"] * 1.3))
          and loop.rcfg.isect_cap == overflow.data["isect_cap"],
          f"overflow {overflow.data}, isect_cap {loop.rcfg.isect_cap}")
    for i in (0, 1):
        check(bool(torch.equal(means[i], start)),
              f"lost step {i + 1} moved the means")
    check(capacity == [GROW_CAPACITY] * 2 + [2 * GROW_CAPACITY] * 4,
          f"capacity by step {capacity}")
    n_alive = int(state.splats.n_alive)
    check(n_alive == refines[-1].data["total"], "live count moved")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    for name, new in state.splats.params().items():
        check(new.shape[0] == 2 * GROW_CAPACITY, f"{name} not grown")
        check(bool(torch.isfinite(new[:n_alive]).all()),
              f"{name} not finite")
        for which in ("moment1", "moment2"):
            mom = getattr(state.opt[name], which)
            check(mom.shape[0] == 2 * GROW_CAPACITY
                  and bool(torch.isfinite(mom).all()),
                  f"{name}.{which} not grown or not finite")
    for f in dataclasses.fields(state.refine):
        check(getattr(state.refine, f.name).shape[0] == 2 * GROW_CAPACITY,
              f"refine record {f.name} not grown")
    check(int(state.step) == GROW_STEPS, f"step {int(state.step)}")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    log(f"[grow] the lost steps left the means unchanged; isect_cap "
        f"{cap0} -> {loop.rcfg.isect_cap}, capacity {GROW_CAPACITY} -> "
        f"{state.splats.capacity} at the first refine, {n_alive} live, "
        f"state finite")
    return dict(launches=launches, captured=captured, steps=GROW_STEPS,
                overflow=overflow.data,
                isect_cap=loop.rcfg.isect_cap,
                capacity=state.splats.capacity)


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
    (min PSNR dB, max |1 - SSIM|) the scene is held to it. The views render
    through a RenderGraph, captured at the first view (the cache is emptied
    first, so the counters count this evaluation's capture); with `keep`
    the capture's launches are returned for the kernel phase."""
    from brush_tpu_torch import graphs, kernels
    from brush_tpu_torch.train.eval import eval_views
    graphs.RENDER_GRAPHS.clear()
    kernels.reset_launches()
    with kernels.capture() as cap_list:
        stats = eval_views(splats, [(cam, gt) for cam, _, gt in truths], rcfg)
    launches = dict(kernels.LAUNCHES)
    captured = list(cap_list) if keep else []
    del cap_list
    check(not keep or captured, "the evaluation's capture recorded nothing")
    log(f"[eval] {what}: psnr={stats.psnr:.4f} dB ssim={stats.ssim:.6f} "
        f"per view psnr {[round(x, 4) for x in stats.per_view_psnr]} ssim "
        f"{[round(x, 6) for x in stats.per_view_ssim]}")
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

    img = IMG_SIZE
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
    log(f"[loop] scene {N_SPLATS} splats in a capacity of {LOOP_CAPACITY}, "
        f"sh{SH_DEGREE}, {img[0]}x{img[1]}, {N_VIEWS} views, refine every "
        f"{REFINE_EVERY}, expand_k0={rcfg.expand_k0} isect_cap="
        f"{rcfg.isect_cap}")

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
    all_stats, messages, alive_before = [], [], {}
    # The kernel phase replays the launches of the first step (a capacity
    # whose second half is dead) and of the first step after a refine (a
    # scene the refine has permuted and grown).
    captured_steps = (1, REFINE_EVERY + 1)
    captured = []
    for i in range(LOOP_STEPS):
        if (i + 1) % REFINE_EVERY == 0:
            alive_before[i + 1] = loop.state.splats.n_alive
        if i + 1 == LOOP_STEPS:
            # One train_step short of the state the last refine sees: its
            # record holds the steps since the refine before.
            before_last_refine = loop.state
        with (kernels.capture() if i + 1 in captured_steps
              else contextlib.nullcontext([])) as cap_list:
            loop, stats, msgs = loop_step(loop, batches[i % N_VIEWS], tcfg,
                                          centers, focals)
        captured += cap_list
        all_stats.append(stats)
        messages += msgs
        if any(m.kind == "refine" for m in msgs):
            rec = loop.state.refine
            check(not bool(rec.refine_weight.any() | rec.visible_count.any()
                           | rec.max_radius.any()),
                  "refine record not zero after a refine")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
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
    log(f"[loop] steps={LOOP_STEPS} capacity={cap} live={n_alive} "
        f"overflowed_steps="
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
    # The refine the graph phase holds to eager: it must select something.
    _, rstats = refine_step(before_last_refine, tcfg, centers, focals)
    graph_refine = dict(
        live=int(before_last_refine.splats.n_alive),
        added=int(rstats.num_added), pruned=int(rstats.num_pruned),
        grad_grown=int(rstats.num_grad_grown), total=int(rstats.total_splats))
    check(graph_refine["added"] > 0, "the graphed refine selects nothing")
    log(f"[loop] the refine the graph phase holds to eager (the state one "
        f"step before the last refine, its record of steps "
        f"{LOOP_STEPS - REFINE_EVERY + 1}-{LOOP_STEPS - 1}): "
        + json.dumps(graph_refine))
    return dict(launches=launches, captured=captured,
                eval_launches=ev_after["launches"],
                eval_captured=ev_after["captured"],
                graph_refine=graph_refine,
                steps=LOOP_STEPS, losses=losses,
                refines=[m.data for m in refines],
                overflows=[m.data for m in overflows],
                psnr=dict(teacher=ev_teacher["psnr"],
                          before=ev_before["psnr"], after=ev_after["psnr"]),
                ssim=dict(teacher=ev_teacher["ssim"],
                          before=ev_before["ssim"], after=ev_after["ssim"]),
                state=state, rcfg=loop.rcfg, truths=truths,
                before_last_refine=before_last_refine, tcfg=tcfg,
                centers=centers, focals=focals)


def phase_init_lod(torch, loop):
    """Both splat initialisations rendered once; PUP scores of the trained
    scene and its decimation to half."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.render import RenderConfig, render
    from brush_tpu_torch.train.lod import decimate_to_count
    from brush_tpu_torch.train.splat_init import (
        create_random_splats, to_init_splats)

    truths = loop["truths"]
    cams = [cam for cam, _, _ in truths]
    _, ci, _ = truths[0]
    kernels.reset_launches()
    rng = np.random.default_rng(SEED)
    random_init = create_random_splats(INIT_RANDOM, cams, rng,
                                       sh_degree=SH_DEGREE)
    points = rng.normal(0.0, [3.0, 2.0, 5.0], (INIT_POINTS, 3)).astype(
        np.float32)
    cloud_init = to_init_splats(points).with_sh_degree(SH_DEGREE)
    for what, s in (("create_random_splats", random_init),
                    ("to_init_splats", cloud_init)):
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
        log(f"[init-lod] {what}: {int(s.n_alive)} splats, visible={visible} "
            f"coverage="
            f"{float((img[..., 3] > 1.0 / 255.0).float().mean()):.4f}")

    # LOD scoring of the trained scene, as the process bakes a level: the
    # views on a graph (captured at the first, replayed for the second),
    # then the same views eagerly, from the same seed.
    from brush_tpu_torch import graphs
    from brush_tpu_torch.ops.rasterize_cuda import BWD_ATOL, BWD_RTOL
    from brush_tpu_torch.train.lod import (
        _graphed_views, pup_hessians, scores_from_hessians)
    splats = loop["state"].splats
    n_alive = int(splats.n_alive)
    score_cams = [ci for _, ci, _ in truths[:LOD_VIEWS]]
    for how in ("graph", "eager"):
        with contextlib.ExitStack() as stack:
            if how == "eager":
                stack.enter_context(wrapped(graphs, "capturable",
                                            lambda real: lambda *a: False))
            cap_list = stack.enter_context(kernels.capture())
            h = pup_hessians(splats, score_cams, loop["rcfg"], SEED,
                             n_probes=LOD_PROBES)
        if how == "graph":
            h_graph, graph_captured = h, list(cap_list)
        else:
            h_eager = h
            # The first eager view's launches (a render and one backward a
            # probe) go to the kernel phase, as do the graph's capture's.
            captured = first_run(cap_list, LOD_VIEWS)
        del cap_list
    h_top = float(h_eager.abs().max())
    h_diff = float((h_graph - h_eager).abs().max())
    check(h_diff <= 2.0 * BWD_RTOL * h_top + BWD_ATOL,
          f"the graphed scoring views' sums differ from eager's by "
          f"{h_diff:.3g} (largest entry {h_top:.3g})")
    scores = scores_from_hessians(h_graph)
    del h_eager
    # One scoring view's graph alone: its replay's kernels.
    folded = splats.fold_min_scale()
    rng = torch.Generator(device="cuda")
    rng.manual_seed(SEED)
    view = _graphed_views(folded, loop["rcfg"], rng, LOD_PROBES, False)
    view(0, score_cams[0])
    score_replay = replay_profile(torch, "PUP scoring view",
                                  lambda: view(1, score_cams[1]))
    for name in kernels.TRAIN_PATH:
        check(score_replay["kernels"].get(name, 0) > 0,
              f"the replayed scoring view launched no {name}")
    del view, folded
    graphs.free_pools()
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
    log(f"[init-lod] scoring views on a graph against eager: sums within "
        f"{h_diff:.3g} (largest entry {h_top:.3g})")
    log(f"[init-lod] pup_scores over {LOD_VIEWS} views x {LOD_PROBES} "
        f"probes on {n_alive} live splats: {int(seen.sum())} splats score "
        f"above the floor, min "
        f"{float(live[seen].min()):.3f} max "
        f"{float(live.max()):.3f}; kept {keep} "
        f"(lowest kept score {float(top[-1]):.3f}); launches "
        f"{json.dumps(launches)}")
    for name in kernels.TRAIN_PATH + ("rasterize_fwd",):
        check(launches[name] > 0, f"kernel {name} was not launched")
    return dict(launches=launches, captured=captured,
                pup_sums_max_abs_diff=h_diff, pup_sums_largest=h_top,
                graph_captured=graph_captured,
                graph_counts=counted(graph_captured))


def write_colmap_scene(root: str, cams, focal: float, pngs) -> None:
    """A COLMAP binary scene: one PINHOLE camera of focal `focal` and the
    size of the images, a view a (Camera, [H, W, 3] uint8) in `cams` /
    `pngs` as sparse/0/{cameras,images,points3D}.bin and
    images/view_XX.png (no 3D points: an init.ply beside them seeds the
    splats)."""
    import struct

    from PIL import Image
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    h, w = pngs[0].shape[:2]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))            # PINHOLE
        f.write(struct.pack("<4d", focal, focal, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            q = cam.rotation / np.linalg.norm(cam.rotation)
            # World-to-camera pose: the inverse rotation and -R^T t.
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", q[0], -q[1], -q[2], -q[3]))
            f.write(struct.pack("<3d", *cam.world_to_local()[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(f"view_{i:02d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))
    for i, rgb in enumerate(pngs):
        Image.fromarray(rgb).save(
            os.path.join(root, "images", f"view_{i:02d}.png"),
            compress_level=1)


@contextlib.contextmanager
def wrapped(module, name: str, wrap):
    """`module.name` replaced by `wrap(original)` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_process(torch, loop, work: str):
    """`train_process` from a COLMAP dataset the phase writes to
    work/scene, at full width: eval, checkpoint, export, the LOD bake,
    resume and the CLI; then on the same dataset the live view and the C
    ABI. Returns the three phases' results (the dp phase trains on the
    dataset too)."""
    proc = _process_run(torch, loop, work)
    data = os.path.join(work, "scene")
    return proc, _live_view_run(torch, data, work), _ffi_run(
        torch, data, work)


def write_process_dataset(torch, work: str):
    """The process cell's dataset in work/scene: 8 PINHOLE views of
    1920x1080 about the serve camera, PNG ground truth the port's 8-bit
    renders of the seed-43 scene, the seed-42 scene as init.ply. Returns
    (its path, the PNGs' pixels)."""
    from brush_tpu_torch.camera import Camera, Pinhole, focal_to_fov
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.utils.synthetic import bench_splats

    w, h = IMG_SIZE
    focal = (w / 2.0) / np.tan(0.5)          # the serve camera's fov_x, 1.0
    cams = [(a, Camera(position=c.position, rotation=c.rotation,
                       fov_x=focal_to_fov(focal, w, Pinhole()),
                       fov_y=focal_to_fov(focal, h, Pinhole())))
            for a, c in views(PROCESS_VIEWS, YAW)]
    teacher = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED + 1)
    pngs = [np.ascontiguousarray(
        gt.cpu().numpy().view(np.uint8).reshape(h, w, 4)[..., :3])
        for _, _, gt in _ground_truths(torch, teacher, cams)]
    del teacher
    data = os.path.join(work, "scene")
    write_colmap_scene(data, [c for _, c in cams], focal, pngs)
    init = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED)
    with open(os.path.join(data, "init.ply"), "wb") as f:
        f.write(ply.splats_to_ply_bytes(init))
    del init
    log(f"[process] dataset: {PROCESS_VIEWS} views {w}x{h} PINHOLE f="
        f"{focal:.4f}, init.ply of {N_SPLATS} splats "
        f"({os.path.getsize(os.path.join(data, 'init.ply')) / 2**20:.1f} "
        f"MiB)")
    return data, pngs


def phase_multicard(torch, work: str, data: str) -> dict:
    """The CLI under `torchrun --nproc-per-node N`, one card a process
    (NCCL), on the process cell's dataset: B = N views a step, one each,
    `MULTI_STEPS` steps, refine every `DP_CLI_REFINE_EVERY`, one loader
    thread; on graphs, then with every program eager. Each run's replicas
    equal; the graphed run's losses within 1e-3 of the eager run's."""
    n = torch.cuda.device_count()
    res = {}
    for mode in ("cli", "cli-eager"):
        out = os.path.join(work, f"multi_{mode}")
        os.makedirs(out)
        export = os.path.join(out, "multi_{iter}.ply")
        run_children(torch, mode, [
            out, data, "--views-per-batch", str(n), "--total-train-iters",
            str(MULTI_STEPS), "--refine-every", str(DP_CLI_REFINE_EVERY),
            "--eval-every", "0", "--log-every", "1", "--export-path",
            export], n, work, torchrun=True)
        ranks = []
        for r in range(n):
            with open(os.path.join(out, f"cli{r}.json")) as f:
                ranks.append(json.load(f))
        for r, c in enumerate(ranks):
            check(c["rc"] == 0 and c["backend"] == "nccl"
                  and c["digest"] == ranks[0]["digest"],
                  f"{mode} rank {r}: rc {c['rc']} backend {c['backend']}, "
                  f"final state equal to rank 0's: "
                  f"{c['digest'] == ranks[0]['digest']}")
        res[mode] = dict(losses=ranks[0]["losses"],
                         step_kind=ranks[0]["step_kind"],
                         digest=ranks[0]["digest"])
        log(f"[multicard] {mode}: torchrun --nproc-per-node {n}, NCCL, "
            f"{n} views a step ({ranks[0]['step_kind']}): losses "
            f"{ranks[0]['losses']}; replicas equal")
    g, e = res["cli"], res["cli-eager"]
    check(g["step_kind"] == "graphs" and e["step_kind"] == "eager",
          f"step kinds {g['step_kind']}, {e['step_kind']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"])]
    check(len(rel) == MULTI_STEPS and max(rel) <= 1e-3,
          f"graphed losses {g['losses']} against eager {e['losses']}")
    res["bit_identical"] = g["digest"] == e["digest"]
    log(f"[multicard] graphed against eager: losses within "
        f"{max(rel):.3g} relative, final states bit for bit "
        f"{res['bit_identical']}")
    return res


def _process_run(torch, loop, work):
    from brush_tpu_torch import cli, graphs, kernels, process
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.ops.loss import gt_tensor
    from brush_tpu_torch.process import ProcessConfig, train_process
    from brush_tpu_torch.train import checkpoint
    from brush_tpu_torch.train.config import TrainConfig

    data, pngs = write_process_dataset(torch, work)
    w, h = IMG_SIZE
    out = os.path.join(work, "out")

    rgb = pngs[0].astype(np.uint32)
    packed = rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (
        np.uint32(255) << 24)
    # A ground-truth upload through the pinned staging buffers of
    # `PinnedUpload` equals the copy from pageable memory.
    upload = process.PinnedUpload("cuda")
    check(torch.equal(upload(packed.view(np.int32)),
                      gt_tensor(packed, device="cuda")),
          "the pinned upload differs")

    # --- the run ---
    tcfg = TrainConfig(total_train_iters=PROCESS_STEPS,
                       refine_every=REFINE_EVERY, lod_levels=1,
                       lod_refine_steps=2, lod_decimation_keep=50,
                       lod_image_scale=50)
    lcfg = LoadConfig(max_resolution=w, eval_split_every=4)
    ckpt_dir = os.path.join(work, "ckpt")
    pcfg = ProcessConfig(eval_every=12, export_every=0, log_every=6,
                         ckpt_every=PROCESS_STEPS, ckpt_dir=ckpt_dir,
                         export_path=os.path.join(out, "out_{iter}.ply"),
                         use_pallas=True, sh_degree=SH_DEGREE, seed=SEED)
    flags, captured, final = [], [], {}
    graphed = []      # (the turn ran on StepGraphs, its captures so far)
    refined = []      # each refine turn ran on RefineGraphs
    baked = []        # the LOD bake's arguments, its state a copy

    def step_turn(real):
        def run(loop_state, *a, **k):
            it = loop_state.it + 1
            # The launches of the first capture after the first refine
            # (the layout its 3D filter floor makes is a new key).
            with (kernels.capture() if it > REFINE_EVERY and not captured
                  else contextlib.nullcontext([])) as cap_list:
                res = real(loop_state, *a, **k)
            captured.extend(cap_list)
            steps = res[0].graphs
            graphed.append((steps is not None,
                            steps.captures if steps is not None else 0))
            flags.append(res[1].overflowed)
            if it == PROCESS_STEPS:
                final.update(state=res[0].state,
                             rng=res[0].state.rng.get_state())
            return res
        return run

    def refine_turn(real):
        def run(loop_state, *a, **k):
            res = real(loop_state, *a, **k)
            if res[1]:
                refined.append(res[0].refines is not None)
            return res
        return run

    def bake(real):
        def run(state, *a, **k):
            baked.append((fresh_copy(torch, state), a, k))
            return real(state, *a, **k)
        return run

    # No render graph carries over from an earlier phase: this run's
    # frames capture their own, so the counters count them.
    graphs.RENDER_GRAPHS.clear()
    kernels.reset_launches()
    with contextlib.ExitStack() as stack:
        for name, wrap in (("_step_turn", step_turn),
                           ("_refine_turn", refine_turn),
                           ("_bake_lod_level", bake)):
            stack.enter_context(wrapped(process, name, wrap))
        msgs = list(train_process(data, tcfg, lcfg, pcfg,
                                  telemetry_dir=os.path.join(work, "telem")))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    kinds = [m.kind for m in msgs]
    steps = [m for m in msgs if m.kind == "step"]
    evals = [m for m in msgs if m.kind == "eval"]
    refines = [m for m in msgs if m.kind == "refine"]
    overflows = [m for m in msgs if m.kind == "overflow"]
    exports = [m for m in msgs if m.kind == "export"]
    final_export = [m for m in exports if m.data.get("final")]
    lod_export = [m for m in exports if m.data.get("lod_level") == 1]
    check([m.iter for m in steps] == [6, 12, 18, 24], f"steps {kinds}")
    check([m.iter for m in refines] == [8, 16], f"refines {kinds}")
    check([m.iter for m in evals] == [12, 24], f"evals {kinds}")
    check([m.iter for m in msgs if m.kind == "checkpoint"] == [24],
          f"checkpoints {kinds}")
    check(len(final_export) == 1 and len(lod_export) == 1,
          f"exports {[m.data for m in exports]}")
    losses = [m.data["loss"] for m in steps]
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    flags = [bool(f) for f in flags]
    settled = max([m.iter + 1 for m in overflows], default=0)
    check(len(flags) == PROCESS_STEPS and not any(flags[settled:]),
          f"a step overflowed after the capacities were grown: steps "
          f"{[i + 1 for i, f in enumerate(flags) if f]}, grown after "
          f"{[m.iter for m in overflows]}")
    psnr = [m.data["psnr"] for m in evals]
    ssim = [m.data["ssim"] for m in evals]
    check(all(np.isfinite(psnr + ssim)), f"eval psnr {psnr} ssim {ssim}")
    check(psnr[1] >= psnr[0] - 0.5, f"eval psnr fell: {psnr}")
    for name in kernels.TRAIN_PATH + ("rasterize_fwd",):
        check(launches[name] > 0, f"kernel {name} was not launched")
    check(captured, "no capture after the first refine recorded launches")
    check(refined == [True] * len(refines),
          f"refine turns on RefineGraphs: {refined}")

    # The checkpoint restores the state of step 24 bit for bit, generator
    # included, and the final export is its folded live rows.
    saved = final["state"]
    restored = checkpoint.load_checkpoint(ckpt_dir, saved)
    check(checkpoint.checkpoint_meta(ckpt_dir) == dict(
        iteration=PROCESS_STEPS, capacity=saved.splats.capacity,
        sh_degree=SH_DEGREE), "checkpoint meta")
    check(torch.equal(restored.rng.get_state(), final["rng"]),
          "the restored generator differs")
    for path, a, b in _state_pairs(torch, saved, restored):
        check(b is not None and a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b),
              f"checkpoint {path} differs")
    n = int(restored.splats.n_alive)
    folded = restored.splats.fold_min_scale()
    raw_path = final_export[0].data["path"]
    got = ply.load_splat_ply(raw_path)
    check(got.num_splats == n, f"export holds {got.num_splats} of {n}")
    for name, field in (("means", "means"), ("log_scales", "log_scales"),
                        ("rotations", "quats"), ("sh_coeffs", "sh_coeffs"),
                        ("raw_opacities", "raw_opacities")):
        want = getattr(folded, field)[:n].cpu().numpy()
        check(np.array_equal(getattr(got, name).view(np.int32),
                             want.view(np.int32)),
              f"export {name} differs from the checkpoint's")
    lod = ply.load_splat_ply(lod_export[0].data["path"])
    check(lod.num_splats == int(n * 0.5) and np.isfinite(lod.means).all(),
          f"LOD holds {lod.num_splats} of {n}")
    comp_path = os.path.join(out, "state.compressed.ply")
    process._export_splats(comp_path, restored.splats)
    comp = ply.load_splat_ply(comp_path)
    raw_bytes, comp_bytes = (os.path.getsize(raw_path),
                             os.path.getsize(comp_path))
    check(comp.num_splats == -(-n // 256) * 256
          and np.isfinite(comp.means).all(),
          f"compressed export holds {comp.num_splats} rows for {n}")
    check(comp_bytes * 3 < raw_bytes,
          f"compressed {comp_bytes} bytes against {raw_bytes}")
    del saved, restored, folded, final

    bake_res = _bake_graph_against_eager(torch, baked[0])
    del baked

    # --- resume from the checkpoint to step 26 ---
    resumed = list(train_process(
        data, dataclasses.replace(tcfg, lod_levels=0), lcfg,
        dataclasses.replace(pcfg, total_iters=PROCESS_STEPS + 2,
                            resume_from=ckpt_dir, ckpt_every=0, eval_every=0,
                            log_every=1, export_path=os.path.join(
                                out, "resumed_{iter}.ply"))))
    r_steps = [m for m in resumed if m.kind == "step"]
    check([m.iter for m in r_steps] == [PROCESS_STEPS + 1, PROCESS_STEPS + 2]
          and all(np.isfinite(m.data["loss"]) for m in r_steps),
          f"resumed steps {[(m.iter, m.data.get('loss')) for m in r_steps]}")

    # --- the CLI, in-process ---
    cli_export = os.path.join(out, "cli_{iter}.ply")
    rc = cli.main([data, "--total-train-iters", "2", "--max-resolution",
                   "960", "--eval-every", "0", "--export-path", cli_export])
    check(rc == 0 and os.path.exists(cli_export.format(iter=2)),
          f"cli returned {rc}")

    res = dict(
        losses=losses, resumed_losses=[m.data["loss"] for m in r_steps],
        psnr=psnr, ssim=ssim, refines=[m.data for m in refines],
        overflows=[m.data for m in overflows], live=n,
        lod_live=lod.num_splats,
        graphed_turns=sum(g for g, _ in graphed),
        graph_captures=graphed[-1][1], graphed_refines=sum(refined),
        **bake_res)
    log(f"[process] train_process {PROCESS_STEPS} steps: "
        f"{res['graphed_turns']} turns on StepGraphs, "
        f"{res['graph_captures']} captures, {res['graphed_refines']} refines "
        f"on RefineGraphs; export {raw_bytes} bytes, compressed "
        f"{comp_bytes}")
    log(f"[process] losses {[round(x, 6) for x in losses]} resumed "
        f"{[round(x, 6) for x in res['resumed_losses']]} psnr {psnr} ssim "
        f"{ssim}; live {n}, LOD {lod.num_splats}; refines "
        f"{json.dumps(res['refines'])}; overflows "
        f"{json.dumps(res['overflows'])}; launches {json.dumps(launches)}")
    res.update(launches=launches, captured=captured)
    return res


def _bake_graph_against_eager(torch, baked) -> dict:
    """The process phase's LOD bake again from its input state, one loader
    thread (two make the view order a race): on graphs (the scoring views
    and the LOD steps; their captures' launches kept), then eagerly with
    the graphed run's scores (so both decimate alike), the baked states
    held by `hold_steps`; the scoring views' sums of that input graphed
    against eager; a replay of the LOD step graph launching every training
    kernel."""
    import functools

    from brush_tpu_torch import graphs, kernels, process
    from brush_tpu_torch.ops.rasterize_cuda import BWD_ATOL, BWD_RTOL
    from brush_tpu_torch.train import lod

    state, args, kw = baked
    scored, kept = {}, []

    def one_thread():
        return wrapped(process, "SceneLoader",
                       lambda real: functools.partial(real, n_threads=1))

    def record(real):
        def run(splats, cams, rcfg, rng, **k):
            scored["args"] = (splats, cams, rcfg, rng, k)
            scored["scores"] = real(splats, cams, rcfg, rng, **k)
            return scored["scores"]
        return run

    class KeptStepGraphs(process.StepGraphs):
        def clear(self):
            if self.graph is not None:
                kept.append(self.graph)  # kept for its profiled replay
            super().clear()

    with one_thread(), wrapped(lod, "pup_scores", record), wrapped(
            process, "StepGraphs", lambda real: KeptStepGraphs):
        with kernels.capture() as cap_list:
            on_graphs = process._bake_lod_level(fresh_copy(torch, state),
                                                *args, **kw)
    with one_thread(), wrapped(graphs, "capturable",
                               lambda real: lambda *a: False), wrapped(
            lod, "pup_scores", lambda real: lambda *a, **k: scored["scores"]):
        eager = process._bake_lod_level(fresh_copy(torch, state), *args, **kw)
    check(int(on_graphs.splats.n_alive) == int(eager.splats.n_alive),
          "the graphed bake kept another count")
    tcfg = args[3]
    lrs = dict(means=tcfg.lr_mean * float(eager.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    diffs = hold_steps(torch, on_graphs, eager, lrs, tcfg.lod_refine_steps)
    bit_identical = not diff_bits(torch, on_graphs, eager)
    # The scoring views' sums of the bake's input, graphed against eager.
    splats, cams, rcfg, rng, k = scored["args"]
    h_graph = lod.pup_hessians(splats, cams, rcfg, rng, **k)
    with wrapped(graphs, "capturable", lambda real: lambda *a: False):
        h_eager = lod.pup_hessians(splats, cams, rcfg, rng, **k)
    top = float(h_eager.abs().max())
    h_diff = float((h_graph - h_eager).abs().max())
    check(h_diff <= 2.0 * BWD_RTOL * top + BWD_ATOL,
          f"the bake's scoring sums graphed against eager: {h_diff:.3g} "
          f"(largest entry {top:.3g})")
    del h_graph, h_eager, on_graphs, eager
    step = kept[0]
    lod_replay = replay_profile(torch, "LOD step",
                                lambda: step(step.state, step._batch))
    for name in kernels.TRAIN_PATH:
        check(lod_replay["kernels"].get(name, 0) > 0,
              f"the replayed LOD step launched no {name}")
    del kept, step
    graphs.free_pools()
    log(f"[process] LOD bake from the run's state, one loader thread, on "
        f"graphs against eager: the baked states within the rule "
        f"(bit for bit: {bit_identical}; largest |d| by path "
        + json.dumps({p: float(f"{v:.3g}") for p, v in diffs.items() if v})
        + f"); the scoring sums within {h_diff:.3g} of eager's (largest "
        f"entry {top:.3g})")
    return dict(bake_bit_identical=bit_identical,
                bake_max_abs_diff={p: v for p, v in diffs.items() if v},
                bake_sums_max_abs_diff=h_diff,
                bake_captured=list(cap_list),
                bake_counts=counted(cap_list))


def _http(port: int, path: str, timeout: float = 600) -> bytes:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read()


def _jpeg(data: bytes) -> np.ndarray:
    """A JPEG's pixels, [H, W, 3] uint8."""
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _jpeg_bytes(frame: np.ndarray) -> bytes:
    """`frame` encoded as the viewer encodes a /render answer."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=88)
    return buf.getvalue()


def phase_viewer(torch):
    """The web viewer as a user starts it: the served scene written to a
    PLY and `serve(path)` on the card, then HTTP requests."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="brush_viewer_")
    try:
        return _viewer_run(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _viewer_run(torch, work):
    from brush_tpu_torch import graphs, kernels
    from brush_tpu_torch.io import ply
    from brush_tpu_torch.render import camera_inputs, render
    from brush_tpu_torch.utils.synthetic import bench_splats
    from brush_tpu_torch.viewer.service import Slot, frame_u8, serve

    path = os.path.join(work, "scene.ply")
    with open(path, "wb") as f:
        f.write(ply.splats_to_ply_bytes(
            bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED)))
    w, h = IMG_SIZE
    slot = Slot()
    server = serve(path, slot=slot, host="127.0.0.1", port=0,
                   sh_degree=SH_DEGREE, blocking=False, device="cuda")
    state = server.viewer_state
    try:
        port = server.server_address[1]
        info = json.loads(_http(port, "/info"))
        check(info["n_splats"] == N_SPLATS and info["n_frames"] == 1,
              f"/info {info}")
        # The orbit pose from the bench camera's place; the second served
        # view (yaw 0.3) as a quaternion with its fovy; a splat scale and a
        # background from above the scene.
        a = YAW / 2
        poses = {
            "orbit": ([0.0, 0.0, -18.0], {}),
            "quat": ([-18.0 * np.sin(YAW), 0.0, -18.0 * np.cos(YAW)],
                     dict(quat=(np.cos(a), 0.0, np.sin(a), 0.0),
                          fov_y=0.62)),
            "scale_bg": ([3.0, 4.0, -17.0],
                         dict(splat_scale=0.5, bg=(0.2, 0.3, 0.4))),
        }

        def query(pos, kw):
            q = f"px={pos[0]}&py={pos[1]}&pz={pos[2]}&w={w}&h={h}"
            if "quat" in kw:
                q += "&q=" + ",".join(str(x) for x in kw["quat"])
            if "fov_y" in kw:
                q += f"&fovy={kw['fov_y']}"
            if "splat_scale" in kw:
                q += f"&scale={kw['splat_scale']}"
            if "bg" in kw:
                q += "&bg=" + ",".join(str(x) for x in kw["bg"])
            return "/render?" + q

        splats = slot.get(0)
        graphs.RENDER_GRAPHS.clear()
        kernels.reset_launches()
        n_frames = 0
        isects = {}
        captured = []
        for name, (pos, kw) in poses.items():
            # The first /render captures the viewer's RenderGraph (the
            # server's thread launches it; nothing else runs meanwhile):
            # its launches are kept for the kernel phase.
            with (kernels.capture() if not captured
                  else contextlib.nullcontext([])) as cap_list:
                body = _http(port, query(pos, kw))
            captured += cap_list
            n_frames += 1
            got = _jpeg(body)
            check(got.shape == (h, w, 3), f"{name}: JPEG {got.shape}")
            frame = state.render_pose(pos, 0.0, 0.0, w, h, 0, **kw)
            n_frames += 1
            # The same pose rendered directly with the viewer's config.
            cam = state.pose_camera(pos, w, h, quat=kw.get("quat"),
                                    fov_y=kw.get("fov_y"))
            with torch.no_grad():
                folded = splats.fold_min_scale()
                log_scales = folded.log_scales
                if "splat_scale" in kw:
                    log_scales = log_scales + float(np.log(kw["splat_scale"]))
                img, aux = render(
                    folded.means, log_scales, folded.quats, folded.sh_coeffs,
                    folded.raw_opacities, camera_inputs(cam, (w, h)),
                    torch.tensor(kw.get("bg", (0.0, 0.0, 0.0)),
                                 dtype=torch.float32, device="cuda"),
                    state.render_config(w, h))
                direct = frame_u8(img).cpu().numpy()
            n_frames += 1
            isects[name] = int(aux.num_isects)
            check(np.array_equal(frame, direct),
                  f"{name}: render_pose differs from the direct render at "
                  f"{int((frame != direct).any(-1).sum())} pixels")
            check(body == _jpeg_bytes(frame),
                  f"{name}: /render's JPEG is not render_pose's frame")
            check(frame.std() > 1.0, f"{name}: the frame is flat")
        launches = dict(kernels.LAUNCHES)
        for name in kernels.SERVE_PATH:
            check(launches[name] > 0, f"kernel {name} was not launched")
        check(sorted({c.name for c in captured}) == sorted(kernels.SERVE_PATH),
              f"captured {[c.name for c in captured]}")
        raw = _http(port, "/splats")
        check(len(raw) == 16 + 59 * 4 * N_SPLATS,
              f"/splats has {len(raw)} bytes")
        check(b"class BrushClient" in _http(port, "/brush.js"), "/brush.js")
        del raw
    finally:
        server.shutdown()
        server.server_close()
    res = dict(num_isects=isects, isect_cap=state.isect_cap, frames=n_frames,
               launches=launches, captured=captured)
    log(f"[viewer] {N_SPLATS} splats sh{SH_DEGREE} from a PLY at {w}x{h}; "
        f"/splats {16 + 59 * 4 * N_SPLATS} bytes")
    log(f"[viewer] num_isects by pose against the fixed isect_cap "
        f"{state.isect_cap}: {json.dumps(isects)} (slots past the cap are "
        f"dropped, as in the JAX viewer); every pose's frame equals a "
        f"direct render bit for bit and its /render JPEG; launches over "
        f"{n_frames} frames {json.dumps(launches)}")
    return res


def _live_view_run(torch, data: str, work: str):
    """`train_process` with a live viewer, as `cli --view` runs it: a
    few steps over the process phase's dataset while `serve(slot=...,
    bus=...)` answers /render from another thread and streams /events."""
    import threading

    from brush_tpu_torch import graphs, kernels
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.process import ProcessConfig, train_process
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.viewer.service import serve
    from brush_tpu_torch.viewer.slot import MessageBus, Slot

    w, h = IMG_SIZE
    slot, bus = Slot(), MessageBus()
    server = serve(slot=slot, bus=bus, host="127.0.0.1", port=0,
                   sh_degree=SH_DEGREE, blocking=False, device="cuda")
    port = server.server_address[1]
    training = threading.Event()
    done = threading.Event()
    heard, frames, errors = [], [], []

    def events():
        import urllib.request
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/events",
                                        timeout=600) as r:
                while not (heard and heard[-1]["kind"] == "step"):
                    line = r.readline()
                    if not line:
                        break
                    if line.startswith(b"data:"):
                        heard.append(json.loads(line[5:]))
        except Exception as e:     # reported by the gate below
            errors.append(f"/events: {e!r}")

    def fetch():
        try:
            while not done.is_set():
                if slot.get(0) is None:
                    time.sleep(0.005)
                    continue
                t = time.perf_counter()
                body = _http(port, f"/render?px=0&py=0&pz=-18&w={w}&h={h}")
                frames.append((t, _jpeg(body).shape))
        except Exception as e:
            errors.append(f"/render: {e!r}")

    listener = threading.Thread(target=events, daemon=True)
    listener.start()
    # Until the stream is subscribed, a published message reaches no one.
    while not heard and listener.is_alive():
        bus.publish({"kind": "hello", "iter": 0})
        time.sleep(0.01)
    fetcher = threading.Thread(target=fetch, daemon=True)
    fetcher.start()
    # No render graph carries over from an earlier phase: this run's
    # frames capture their own, so the counters count them.
    graphs.RENDER_GRAPHS.clear()
    kernels.reset_launches()
    try:
        msgs = list(train_process(
            data, TrainConfig(total_train_iters=LIVE_STEPS, lod_levels=0),
            LoadConfig(max_resolution=w, eval_split_every=4),
            ProcessConfig(eval_every=0, export_every=0, log_every=1,
                          sh_degree=SH_DEGREE, seed=SEED,
                          export_path=os.path.join(work, "live",
                                                   "live_{iter}.ply")),
            slot=slot, device="cuda",
            on_message=lambda m: bus.publish(
                {"kind": m.kind, "iter": m.iter, **m.data})))
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        done.set()
        fetcher.join(timeout=600)
        listener.join(timeout=60)
        launches = dict(kernels.LAUNCHES)
        views = json.loads(_http(port, "/views"))
        gt = _jpeg(_http(port, "/gt?view=0"))
    finally:
        done.set()
        server.shutdown()
        server.server_close()
    check(not errors, f"live view: {errors}")
    steps = [m for m in msgs if m.kind == "step"]
    check([m.iter for m in steps] == list(range(1, LIVE_STEPS + 1))
          and all(np.isfinite(m.data["loss"]) for m in steps),
          f"live steps {[(m.iter, m.data.get('loss')) for m in steps]}")
    check(slot.version == LIVE_STEPS, f"{slot.version} snapshots")
    check(any(m["kind"] == "step" for m in heard),
          f"no step message on /events: {heard}")
    during = [f for f in frames if f[0] < t_end]
    check(during and all(f[1] == (h, w, 3) for f in frames),
          f"/render during training: {len(during)} of {len(frames)} "
          f"frames, shapes {sorted({f[1] for f in frames})}")
    check(len(views) == PROCESS_VIEWS
          and {v["split"] for v in views} == {"train", "eval"},
          f"/views lists {[(v['name'], v['split']) for v in views]}")
    check(gt.shape == (360, 640, 3), f"/gt?view=0 decodes to {gt.shape}")
    for name in kernels.TRAIN_PATH + ("rasterize_fwd",):
        check(launches[name] > 0, f"kernel {name} was not launched")
    res = dict(steps=LIVE_STEPS, frames=len(frames),
               frames_during_training=len(during),
               losses=[m.data["loss"] for m in steps],
               events=[m["kind"] for m in heard], launches=launches)
    log(f"[live] train_process {LIVE_STEPS} steps with serve(slot, bus) "
        f"running: {len(frames)} /render frames of {w}x{h} fetched "
        f"({len(during)} while training); /events gave "
        f"{res['events']}; /views {len(views)} views; /gt?view=0 "
        f"{gt.shape}; launches {json.dumps(launches)}")
    return res


def _ffi_run(torch, data: str, work: str):
    """The C ABI: build libbrush_tpu_torch_ffi.so with g++, load it with
    ctypes and train through `brush_train_and_save` on the card."""
    import ctypes
    import sysconfig

    from brush_tpu_torch import kernels
    from brush_tpu_torch.native import build as native

    include = sysconfig.get_paths()["include"]
    check(os.path.isfile(os.path.join(include, "Python.h")),
          f"Python.h is not in {include}, where sysconfig says")
    path = native.build_ffi(verbose=False)
    lib = ctypes.CDLL(str(path))
    cb_type = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p,
                               ctypes.c_void_p)
    lib.brush_train_and_save.restype = ctypes.c_int32
    lib.brush_train_and_save.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         cb_type, ctypes.c_void_p]
    lib.brush_last_error.restype = ctypes.c_char_p
    lib.brush_abi_version.restype = ctypes.c_int32
    check(lib.brush_abi_version() == 1, "ABI version")

    def run(iters: int, cancel: bool):
        msgs = []

        @cb_type
        def cb(payload, user_data):
            msgs.append(json.loads(payload.decode()))
            return 1 if cancel else 0

        export = os.path.join(work, "ffi", f"{iters}_{{iter}}.ply")
        opts = dict(device="cuda", total_train_iters=iters,
                    max_resolution=960, eval_every=0, export_every=0,
                    log_every=1, lod_levels=0, export_path=export)
        rc = lib.brush_train_and_save(data.encode(),
                                      json.dumps(opts).encode(), cb, None)
        check(rc == 0, f"brush_train_and_save returned {rc}: "
              f"{lib.brush_last_error().decode()}")
        return msgs, export.format(iter=iters)

    kernels.reset_launches()
    msgs, export = run(FFI_STEPS, cancel=False)
    launches = dict(kernels.LAUNCHES)
    kinds = [m["kind"] for m in msgs]
    check("step" in kinds and "export" in kinds and os.path.exists(export),
          f"C ABI run: messages {kinds}, export {os.path.exists(export)}")
    check(all(np.isfinite(m["loss"]) for m in msgs if m["kind"] == "step"),
          "C ABI run: loss not finite")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    cancelled, c_export = run(50, cancel=True)
    check(len(cancelled) == 1 and cancelled[0]["iter"] == 1
          and not os.path.exists(c_export),
          f"the cancelled call went on: {[m['kind'] for m in cancelled]}")
    res = dict(kinds=kinds, launches=launches,
               losses=[m["loss"] for m in msgs if m["kind"] == "step"])
    log(f"[ffi] libbrush_tpu_torch_ffi.so built; brush_train_and_save "
        f"{FFI_STEPS} steps at 960 px on cuda (messages {kinds}); a call "
        f"cancelled from its first callback returned with 1 message; "
        f"launches {json.dumps(launches)}")
    return res


def phase_lpips(torch, serve, train):
    """The LPIPS term: its value on the card against the CPU (and what
    TF32 would make of it), then training steps of the train cell's scene
    with `lpips_loss_weight=0.5`, the weights read from an .npz by the
    loader `train_process` uses."""
    import shutil
    import tempfile

    from brush_tpu_torch import kernels
    from brush_tpu_torch.models.lpips import (
        load_lpips, random_lpips, random_lpips_arrays, save_lpips_npz)
    from brush_tpu_torch.process import ProcessConfig
    from brush_tpu_torch.render import RenderConfig
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import init_train_state, train_step

    # --- the value at 256x256: card against CPU, and under TF32 ---
    rng = np.random.default_rng(SEED)
    a, b = (rng.uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
            for _ in range(2))
    readings = {}
    with torch.no_grad():
        cpu = random_lpips(0, device="cpu")
        want = float(cpu(torch.from_numpy(a), torch.from_numpy(b)))
        want_taps = cpu.features(torch.from_numpy(a))
        model = random_lpips(0, device="cuda")
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        for tf32 in (False, True):
            model.allow_tf32 = tf32
            value = float(model(ta, tb))
            taps = [float((x.cpu() - y).abs().max() / y.abs().max())
                    for x, y in zip(model.features(ta), want_taps)]
            readings[tf32] = (value, abs(value - want) / want, max(taps))
        model.allow_tf32 = False
    (got, err, tap_err), (tf32, tf32_err, tf32_tap_err) = (readings[False],
                                                           readings[True])
    log(f"[lpips] 256x256 random_lpips(0): cpu {want:.9g} cuda {got:.9g} "
        f"(rel {err:.3g}, bar {LPIPS_RTOL}; taps {tap_err:.3g}, bar "
        f"{LPIPS_TAP_RTOL}); with TF32 allowed {tf32:.9g} (rel "
        f"{tf32_err:.3g}; taps {tf32_tap_err:.3g})")
    check(err <= LPIPS_RTOL and tap_err <= LPIPS_TAP_RTOL,
          f"LPIPS on the card {got} against the CPU's {want}: rel "
          f"{err:.3g}, taps {tap_err:.3g}")
    check(tf32_err > LPIPS_RTOL and tf32_tap_err > LPIPS_TAP_RTOL,
          f"TF32 reads within a bar (value {tf32_err:.3g}, taps "
          f"{tf32_tap_err:.3g}): it cannot tell float32 from TF32")
    del model, cpu, ta, tb, want_taps

    # --- the weights through the loader, as train_process reads them ---
    work = tempfile.mkdtemp(prefix="brush_lpips_")
    try:
        path = os.path.join(work, "lpips.npz")
        save_lpips_npz(random_lpips_arrays(0), path)
        pcfg = ProcessConfig(lpips_weights=path)
        model = load_lpips(pcfg.lpips_weights, device="cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    _, _, serve_cfg = serve["plans"][0]
    rcfg = RenderConfig(img_size=IMG_SIZE, sh_degree=SH_DEGREE,
                        isect_cap=serve_cfg.isect_cap,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    tcfg = TrainConfig(lpips_loss_weight=0.5)
    batch = train["batch"]
    # The train phase's first step took the same state, batch, config and
    # generator seed without the term.
    state0 = init_train_state(serve["splats"], SEED)
    kernels.reset_launches()
    with kernels.capture() as cap_list:
        state, stats, aux = train_step(state0, batch, tcfg, rcfg,
                                       lpips_model=model)
    captured = list(cap_list)
    all_stats = [stats]
    for _ in range(LPIPS_STEPS):
        state, stats, aux = train_step(state, batch, tcfg, rcfg,
                                       lpips_model=model)
        all_stats.append(stats)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    losses = [float(st.loss) for st in all_stats]
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(not any(bool(st.overflowed) for st in all_stats), "overflow")
    term = losses[0] - train["losses"][0]
    check(term > 0.0, f"the LPIPS term moved the first step's loss by "
          f"{term} ({losses[0]} against {train['losses'][0]})")
    for name, new in state.splats.params().items():
        check(bool(torch.isfinite(new).all()), f"{name} not finite")
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    res = dict(losses=losses, term_step1=term, value_cpu=want,
               value_cuda=got, value_tf32=tf32, rel_err=err,
               tf32_rel_err=tf32_err, tap_err=tap_err,
               tf32_tap_err=tf32_tap_err, steps=1 + LPIPS_STEPS,
               launches=launches, captured=captured)
    log(f"[lpips] train_step with lpips_loss_weight=0.5 at {IMG_SIZE[0]}x"
        f"{IMG_SIZE[1]}, {N_SPLATS} splats: losses "
        f"{[round(x, 6) for x in losses]}, the term added {term:.6f} to "
        f"step 1's")
    return res


def plain_counted(launch, plain):
    """The plain version's result on a launch's inputs, from one run, with
    what `kernel_work` counts from that run: for the rasterizers the
    (pixel, slot) pairs. (result, pairs or None)."""
    from brush_tpu_torch.ops import rasterize_cuda as rc
    name, inputs = launch.name, launch.inputs
    if name == "rasterize_fwd":
        tiles, pairs = rc.rasterize_forward_plain(*inputs, count_pairs=True)
        return tiles, (pairs,)
    if name == "rasterize_fwd_train":
        tiles, schedule, pairs = rc.rasterize_forward_train_plain(
            *inputs, count_pairs=True)
        return (tiles, schedule), (pairs,)
    if name == "rasterize_bwd":
        slot_grads, replayed, blended = rc.rasterize_backward_plain(
            *inputs[:6], count_pairs=True)
        return (rc.reduce_slot_grads(slot_grads, inputs[6], inputs[7]),
                (replayed, blended))
    return plain(), None


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
    if name == "tile_counts":
        # A splat whose bbox holds a tile reads its mean, conic, threshold,
        # tile_min, tile_max's x and count (40 bytes); another its count.
        # Every splat writes its mask (int64) and count.
        bbox = inputs[5]
        n, live = bbox.numel(), int((bbox > 0).sum())
        return live * 40 + (n - live) * 4 + n * 12, 0, [n, live]
    if name == "project_fwd":
        # Every row: its means, the SH floats its degree uses and its
        # opacity (the colour channels' finiteness is an output even of a
        # culled row), and the 70 bytes it writes; a row that passes the
        # opacity gate also reads its log-scales and quaternion.
        means, _, _, sh, raw, _, _, degree, _, _ = inputs
        n = raw.numel()
        sig = torch.sigmoid(raw)
        opaque = int((sig >= 1.0 / 255.0).sum())
        sh_bytes = 12 * (degree + 1) ** 2
        return (n * (12 + sh_bytes + 4 + 70) + opaque * 28, 0,
                [n, opaque, int(got[0].visible.sum())])
    if name == "project_bwd":
        # A visible row reads its row (means, log-scales, quaternion, the
        # degree's SH, opacity) and the 36 bytes of cotangents; every row
        # reads its flags and writes its gradients (the SH's whole K).
        rows, flags, degree = inputs[:5], inputs[7], inputs[12]
        n = flags.numel()
        live = int((flags & 1).sum())
        k = rows[3].shape[1]
        return (live * (48 + 12 * (degree + 1) ** 2 + 36)
                + n * (1 + 44 + 12 * k), 0, [n, live])
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
    # ids, the saved and cotangent tiles and the schedule (the part
    # lengths); writes the [11, n] per-splat sums.
    replayed, blended = pairs
    useful = inputs[2][:, 5, 0].to(torch.int64)
    return (int(useful.sum()) * (rasterize_cuda.TRAIN_ROWS + 1) * 4
            + n_tiles * (8 + (rasterize_cuda.TRAIN_OUT_ROWS
                              + rasterize_cuda.V_ROWS) * tile_bytes) + 12
            + n_tiles * rasterize_cuda.TILE_PARTS * 4
            + got.numel() * 4,
            int(replayed) * BWD_REPLAY_OPS_PER_PAIR
            + int(blended) * BWD_BLEND_OPS_PER_PAIR,
            [n_tiles, int(useful.sum()), int(useful.max()), int(replayed),
             int(blended)])


def _state_pairs(torch, a, b, path="state"):
    """(path, tensor of a, tensor or None of b) for every tensor of a
    TrainState `a`, by the same path in `b`."""
    if torch.is_tensor(a):
        yield path, a, b if torch.is_tensor(b) else None
        return
    if isinstance(a, dict):
        items = a.items()
        get = b.get
    elif dataclasses.is_dataclass(a):
        items = ((f.name, getattr(a, f.name)) for f in dataclasses.fields(a))
        get = lambda k: getattr(b, k, None)        # noqa: E731
    else:
        return
    for k, v in items:
        yield from _state_pairs(torch, v, get(k), f"{path}.{k}")


def state_digest(torch, state) -> dict:
    """sha256 of every tensor of a TrainState (the generator's state too),
    by path: equal digests are bit-identical replicas."""
    import hashlib

    def sha(t):
        return hashlib.sha256(t.detach().contiguous().reshape(-1).cpu().view(
            torch.uint8).numpy()).hexdigest()

    out = {path: sha(t) for path, t, _ in _state_pairs(torch, state, state)}
    out["state.rng"] = sha(state.rng.get_state())
    return out


def hold_state(torch, got, want, lrs: dict) -> dict:
    """`got` against `want` (TrainStates) under the rule of the CPU tests
    (tests/test_torch_parallel.py): every tensor within rtol 1e-5, atol
    1e-6. Returns per tensor path the entries outside it, the largest
    difference, and for a parameter array the largest difference in
    learning rates and the largest reference first moment among the
    entries outside, against the array's largest."""
    out = {}
    for path, w, g in _state_pairs(torch, want, got):
        check(g is not None and g.shape == w.shape and g.dtype == w.dtype,
              f"{path}: {None if g is None else tuple(g.shape)} against "
              f"{tuple(w.shape)}")
        if not w.is_floating_point():
            out[path] = dict(bad=int((g != w).sum()), max_abs=0.0)
            continue
        d = (g - w).abs()
        bad = d > 1e-6 + 1e-5 * w.abs()
        r = dict(bad=int(bad.sum()), max_abs=float(d.max()) if d.numel()
                 else 0.0)
        name = path.split(".")[-1]
        if path.startswith("state.splats.") and name in lrs:
            r["max_lrs"] = r["max_abs"] / lrs[name]
            m1 = want.opt[name].moment1
            if r["bad"]:
                r["bad_m1_rel"] = float(m1[bad].abs().max()
                                        / m1.abs().max())
        out[path] = r
    return out


def _twin(torch, state):
    """`state` with a generator of its own in the same state."""
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    return dataclasses.replace(state, rng=rng)


def counted(captured) -> dict:
    """Launches of each kernel among `captured` (a graph's capture: its
    replays run no wrapper and move no counter)."""
    from brush_tpu_torch import kernels
    return {name: sum(1 for c in captured if c.name == name)
            for name in kernels.KERNEL_NAMES}


def fresh_copy(torch, state):
    """A copy of `state` with tensors and a generator of its own: what a
    graph that takes its state by donation is given here."""
    from brush_tpu_torch import graphs
    return dataclasses.replace(
        graphs.copy_out(dataclasses.replace(state, rng=None)),
        rng=_twin(torch, state).rng)


def diff_bits(torch, got, want) -> list:
    """The paths of the TrainState `want` (its generator's state too) that
    `got` does not hold bit for bit."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    bad = [p for p, w, g in _state_pairs(torch, want, got)
           if g is None or g.dtype != w.dtype or g.shape != w.shape
           or not torch.equal(bits(g), bits(w))]
    if not torch.equal(got.rng.get_state(), want.rng.get_state()):
        bad.append("state.rng")
    return bad


def run_children(torch, mode: str, args: list, world: int, work: str,
                 timeout: float = CHILD_TIMEOUT_S, torchrun: bool = False):
    """`world` processes of this script in `--child mode`, started at once
    (under torchrun when asked); each writes its log to work/rank<r>.log.
    Fails the phase if one exits non-zero or outlives `timeout` (then
    every one is killed)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if torchrun:
        cmds = [[sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(world),
                 os.path.abspath(__file__), "--child", mode] + args]
    else:
        cmds = [[sys.executable, os.path.abspath(__file__), "--child", mode,
                 str(r), str(world)] + args for r in range(world)]
    logs = [open(os.path.join(work, f"{mode}{i}.log"), "w")
            for i in range(len(cmds))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT, env=env,
                              cwd=REPO) for c, f in zip(cmds, logs)]
    try:
        for p in procs:
            p.wait(timeout=max(t0 + timeout - time.perf_counter(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    for i in range(len(cmds)):
        with open(os.path.join(work, f"{mode}{i}.log")) as f:
            text = f.read()
        for line in text.splitlines()[-40 if codes != [0] * len(cmds)
                                      else -12:]:
            log(f"[{mode} {i}] {line}")
    check(codes == [0] * len(cmds), f"{mode} processes exited {codes} "
          f"after {secs:.1f} s (a negative code is a kill, at the "
          f"{timeout} s limit)")


def phase_space(torch, serve):
    """The strip-sharded render at the serve cell: view 0 of the served
    scene in `SPACE_STRIPS` strips, each rendered here from
    `strip_camera_inputs` with its own planned capacity (strip 1's launches
    kept), assembled and held to the full render; the child processes of
    the dp phase render the same strips over gloo."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch.ops.projection import CameraInputs
    from brush_tpu_torch.parallel.tile_parallel import strip_camera_inputs
    from brush_tpu_torch.render import RenderConfig, render

    w, h = IMG_SIZE
    s = serve["splats"].fold_min_scale()
    params = (s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities)
    angle, ci, cfg = serve["plans"][0]
    cam = views(N_VIEWS, YAW)[0][1]
    bg = torch.zeros(3, dtype=torch.float32, device="cuda")
    stack, h_strip = strip_camera_inputs(cam, IMG_SIZE, SPACE_STRIPS)
    strips = [CameraInputs(*(x[i] for x in stack))
              for i in range(SPACE_STRIPS)]
    plans = [plan_caps(s.means, s.log_scales, s.quats, s.raw_opacities,
                       c, (w, h_strip)) for c in strips]
    # One RenderConfig for every strip (a strip process takes the one it
    # is given): the widest dense expansion and the largest capacity.
    rcfg = RenderConfig(img_size=IMG_SIZE, sh_degree=SH_DEGREE,
                        isect_cap=max(c for _, c in plans),
                        expand_k0=max(k for k, _ in plans), use_pallas=True,
                        forward_only=True)
    scfg = dataclasses.replace(rcfg, img_size=(w, h_strip))
    kernels.reset_launches()
    imgs, isects, captured = [], [], []
    for i, c in enumerate(strips):
        with (kernels.capture() if i == 1
              else contextlib.nullcontext([])) as cap_list:
            img, aux = render(*params, c, bg, scfg)
        captured.extend(cap_list)
        imgs.append(img)
        isects.append(int(aux.num_isects))
        check(isects[-1] <= scfg.isect_cap, f"strip {i} overflowed: "
              f"{isects[-1]} > {scfg.isect_cap}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in kernels.SERVE_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    frame = torch.cat(imgs)[:h]
    full, _ = render(*params, ci, bg, cfg)
    # A strip equals the full frame up to the blend order of slots whose
    # depth keys tie: the key keeps 32 - bit_length(num_tiles) depth bits
    # (a strip of half the tiles one more) and tied slots keep their
    # emission order, which a strip's clipped bounding boxes change
    # (tests/test_torch_parallel.py shows it in both packages). The order
    # moves colours, and coverage only through the T < 1e-4 stop.
    d_alpha = float((frame[..., 3] - full[..., 3]).abs().max())
    mean_rgb = float((frame[..., :3] - full[..., :3]).abs().mean())
    check(d_alpha <= TIE_ALPHA_TOL and mean_rgb <= TIE_RGB_MEAN_TOL,
          f"strips against the full render: alpha max {d_alpha} (bar "
          f"{TIE_ALPHA_TOL}), rgb mean {mean_rgb} (bar {TIE_RGB_MEAN_TOL})")

    # Each strip's render on a graph of its own (a process renders one):
    # bit for bit the eager strip; strip 1's capture kept.
    from brush_tpu_torch import graphs
    strip_graphs, graph_captured = [], []
    for i, c in enumerate(strips):
        g = graphs.RenderGraph(scfg, s.means.shape[0])
        with (kernels.capture() if i == 1
              else contextlib.nullcontext([])) as cap_list:
            g(*params, c, bg)
        graph_captured.extend(cap_list)
        for _ in range(2):
            got, _ = g(*params, c, bg)
            check(torch.equal(got.view(torch.int32), imgs[i].view(
                torch.int32)), f"strip {i} on a graph differs from eager")
        strip_graphs.append(g)
    sync_free(torch, "strip graph replay",
              lambda: strip_graphs[0](*params, strips[0], bg))
    strip_replay = replay_profile(
        torch, "strip", lambda: strip_graphs[1](*params, strips[1], bg))
    for name in kernels.SERVE_PATH:
        check(strip_replay["kernels"].get(name, 0) > 0,
              f"the replayed strip launched no {name}")
    del strip_graphs, g, got
    graphs.free_pools()
    res = dict(h_strip=h_strip, isect_cap=scfg.isect_cap,
               expand_k0=scfg.expand_k0, strip_isects=isects,
               strip_planned_caps=[c for _, c in plans], rgb_mean=mean_rgb,
               alpha_max=d_alpha, graph_captured=graph_captured,
               graph_counts=counted(graph_captured),
               launches=launches, captured=captured, strips=SPACE_STRIPS,
               # + 0.0: the all_reduce's sum with zeros turns -0 into +0
               frame=(frame + 0.0).cpu(),
               job=dict(splats=s, cam=cam, bg=bg.cpu(), rcfg=rcfg))
    log(f"[space] view yaw={angle:+.2f} in {SPACE_STRIPS} strips of "
        f"{w}x{h_strip}: num_isects {isects} against the cap "
        f"{scfg.isect_cap} (planned a strip {res['strip_planned_caps']}, "
        f"expand_k0 {scfg.expand_k0}), on graphs each equal to the eager "
        f"strip bit for bit; assembled against the full render: alpha max "
        f"{d_alpha:.3g}, rgb mean {mean_rgb:.3g}; launches "
        f"{json.dumps(launches)}")
    return res


def phase_dp(torch, serve, train, space, data: str, work: str):
    """View-sharded training at the train cell: (a) `make_dp_train_step`
    over a one-process NCCL group against the one-device batched step;
    (b) two gloo processes sharing the card, which also render the space
    phase's strips; (c) a 2-process torchrun launch of the CLI on the
    process phase's dataset."""
    import datetime

    import torch.distributed as dist

    from brush_tpu_torch import kernels
    from brush_tpu_torch.camera import fov_to_focal
    from brush_tpu_torch.ops import loss as loss_mod
    from brush_tpu_torch.ops.capacity import plan_caps
    from brush_tpu_torch import graphs
    from brush_tpu_torch.parallel.data_parallel import (
        make_dp_train_step, view_share)
    from brush_tpu_torch.parallel.tile_parallel import (
        make_space_parallel_render, strip_camera_inputs)
    from brush_tpu_torch.render import RenderConfig, render
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import (
        SceneBatch, init_train_state, stack_batches, train_step_impl)
    from brush_tpu_torch.utils.synthetic import bench_splats

    img = IMG_SIZE
    plans = serve["plans"][:DP_VIEWS]
    # Ground truth of every view: the train phase's for view 0, the second
    # scene rendered for the others.
    other = bench_splats(N_SPLATS, sh_degree=SH_DEGREE,
                         seed=SEED + 1).fold_min_scale()
    views_ = [train["batch"]]
    for _, ci, _ in plans[1:]:
        k0, cap = plan_caps(other.means, other.log_scales, other.quats,
                            other.raw_opacities, ci, img)
        gt, _ = render(other.means, other.log_scales, other.quats,
                       other.sh_coeffs, other.raw_opacities, ci,
                       torch.zeros(3, device="cuda"),
                       RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                                    isect_cap=cap, expand_k0=k0,
                                    use_pallas=True, forward_only=True))
        views_.append(SceneBatch(gt_packed=loss_mod.pack_gt(gt[..., :3]),
                                 cam=ci))
    del other
    batch = stack_batches(views_)
    tcfg = TrainConfig()
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                        isect_cap=max(c.isect_cap for _, _, c in plans),
                        expand_k0=max(c.expand_k0 for _, _, c in plans),
                        use_pallas=True)
    state0 = init_train_state(serve["splats"], SEED)

    # --- (a): the reference, then a one-process NCCL group ---
    ref, ref_losses = _twin(torch, state0), []
    for _ in range(DP_STEPS):
        ref, stats, aux = train_step_impl(ref, batch, tcfg, rcfg,
                                          batched=True)
        check(not bool(stats.overflowed), "the batched step overflowed")
        ref_losses.append(float(stats.loss))
    lrs = dict(means=float(stats.lr_mean), log_scales=tcfg.lr_scale,
               quats=tcfg.lr_rotation, sh_coeffs=tcfg.lr_coeffs_dc,
               raw_opacities=tcfg.lr_opac)
    repeat = _twin(torch, state0)
    for _ in range(DP_STEPS):
        repeat, _, _ = train_step_impl(repeat, batch, tcfg, rcfg,
                                       batched=True)
    torch.cuda.synchronize()
    self_report = hold_state(torch, repeat, ref, lrs)
    del repeat
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(work, "nccl_store"),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    group = dist.group.WORLD
    try:
        # The eager DP step: the body the graph captures, the share's
        # all_reduces over NCCL (its first step sets NCCL up).
        share = view_share(group, DP_VIEWS)
        state, losses, captured = _twin(torch, state0), [], []
        kernels.reset_launches()
        for i in range(1, DP_STEPS + 1):
            with (kernels.capture() if i == DP_CAPTURED_STEP
                  else contextlib.nullcontext([])) as cap_list:
                state, stats, _ = train_step_impl(
                    state, batch, tcfg, rcfg, batched=True, share=share)
            captured.extend(cap_list)
            losses.append(float(stats.loss))
            check(not bool(stats.overflowed), f"dp step {i} overflowed")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        # The DP step as a user makes it: on a StepGraph over NCCL, the
        # all_reduces in the graph. Its first step captures.
        step = make_dp_train_step(group, tcfg, rcfg)
        check(step.graphs is not None, "the NCCL DP step is not graphed")
        graphed, g_losses = fresh_copy(torch, state0), []
        with kernels.capture() as dp_graph_captured:
            graphed, stats, _ = step(graphed, batch)
        g_losses.append(float(stats.loss))
        for _ in range(DP_STEPS - 1):
            graphed, stats, _ = step(graphed, batch)
            g_losses.append(float(stats.loss))
        torch.cuda.synchronize()
        g_report = hold_state(torch, graphed, ref, lrs)
        g_diffs = hold_steps(torch, graphed, state, lrs, DP_STEPS)
        g_bits = diff_bits(torch, graphed, state)
        g_state = fresh_copy(torch, graphed)
        sync_free(torch, "graph DP step replay (NCCL)",
                  lambda: step(graphed, batch))
        own = step.graphs.graph
        dp_replay = replay_profile(torch, "DP step (NCCL)",
                                   lambda: step(own.state, batch))
        for name in kernels.TRAIN_PATH:
            check(dp_replay["kernels"].get(name, 0) > 0,
                  f"the replayed DP step launched no {name}")
        del own
        step.graphs.clear()
        # The strips' run over the NCCL group (one process: one strip, the
        # whole frame), the frame's all_reduce in its graph, against eager.
        frame_cfg = serve["plans"][0][2]
        cam = views(N_VIEWS, YAW)[0][1]
        stack, _ = strip_camera_inputs(cam, img, 1)
        sp = serve["splats"].fold_min_scale()
        sp_args = (sp.means, sp.log_scales, sp.quats, sp.sh_coeffs,
                   sp.raw_opacities, stack, torch.zeros(3, device="cuda"))
        with wrapped(graphs, "capturable", lambda real: lambda *a: False):
            eager_run = make_space_parallel_render(group, frame_cfg)
            strip_want = eager_run(*sp_args) + 0.0
        run = make_space_parallel_render(group, frame_cfg)
        with kernels.capture() as run_captured:
            run(*sp_args)
        for _ in range(2):
            check(torch.equal((run(*sp_args) + 0.0).view(torch.int32),
                              strip_want.view(torch.int32)),
                  "the strips' run on a graph over NCCL differs from eager")
        check(run.graph.captured and run_captured,
              "the strips' run over NCCL was not captured")
        del run, eager_run, strip_want, sp, sp_args
        graphs.free_pools()
    finally:
        dist.destroy_process_group()
    for name in kernels.TRAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched")
    report = hold_state(torch, state, ref, lrs)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    bad = {p: r for p, r in report.items() if r["bad"]}
    g_bad = {p: r for p, r in g_report.items() if r["bad"]}
    log(f"[dp] (a) one-process NCCL group, B={DP_VIEWS} views at {img[0]}x"
        f"{img[1]}, {N_SPLATS} splats sh{SH_DEGREE}: eager DP step losses "
        f"{losses} against the batched step's {ref_losses} (rel {loss_rel}); "
        f"tensors "
        f"outside rtol 1e-5 atol 1e-6: {json.dumps(bad)}; the batched step "
        f"against its own repeat: "
        f"{json.dumps({p: r for p, r in self_report.items() if r['bad']})}")
    log(f"[dp] (a) the DP step on a graph over NCCL (make_dp_train_step, "
        f"its all_reduces captured): losses "
        f"{g_losses}; against the eager DP step bit for bit: {not g_bits} "
        f"(differing {g_bits}; largest |d| by path "
        + json.dumps({p: float(f"{v:.3g}") for p, v in g_diffs.items() if v})
        + f"); tensors outside rtol 1e-5 atol 1e-6 of the batched step: "
        f"{json.dumps(g_bad)}")
    log("[space] the strips' run over the one-process NCCL group (one "
        "strip, the frame's all_reduce in the graph): equal to eager bit "
        "for bit")
    check(max(loss_rel) <= 1e-5, f"dp losses {losses} against {ref_losses}")
    check(not bad, "the dp step differs from the batched step")
    check(not g_bad, "the graphed dp step differs from the batched step")
    # The graphed batched step (one process, no share) from the same state.
    steps = graphs.StepGraphs(tcfg, batched=True)
    batched = fresh_copy(torch, state0)
    for _ in range(DP_STEPS):
        batched, _, _ = steps(batched, batch, rcfg)
    steps.clear()
    b_diffs = hold_steps(torch, g_state, batched, lrs, DP_STEPS)
    b_bits = diff_bits(torch, g_state, batched)
    log(f"[dp] (a) the graphed DP step against the graphed batched step: "
        f"bit for bit {not b_bits} (differing {b_bits}; largest |d| "
        + json.dumps({p: float(f"{v:.3g}") for p, v in b_diffs.items() if v})
        + ")")
    del state, graphed, g_state, batched

    # --- (b): two gloo processes on the card, and the space strips ---
    cams = [cam for _, cam in views(N_VIEWS, YAW)][:DP_VIEWS]
    centers = torch.tensor(np.stack([c.position for c in cams]),
                           dtype=torch.float32, device="cuda")
    focals = torch.tensor([fov_to_focal(c.fov_x, img[0], c.model)
                           for c in cams], dtype=torch.float32,
                          device="cuda")
    job = dict(
        state=dataclasses.replace(state0, rng=None),
        rng=state0.rng.get_state(), batch=batch, tcfg=tcfg, rcfg=rcfg,
        ref=dataclasses.replace(ref, rng=None), ref_losses=ref_losses,
        lrs=lrs, refine=(centers, focals), space=space["job"])
    job_path = os.path.join(work, "dp_job.pt")
    torch.save(job, job_path)
    del job, ref
    torch.cuda.empty_cache()
    run_children(torch, "ranks", [
        job_path, "file://" + os.path.join(work, "gloo_store"), work],
        DP_RANKS, work)
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        check(res["digests"] == ranks[0]["digests"],
              f"rank {r}'s state differs from rank 0's after a step")
        check(res["refined_digest"] == ranks[0]["refined_digest"]
              and res["after"] == ranks[0]["after"],
              f"rank {r} differs from rank 0 after the refine")
        rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   ref_losses)]
        bad = {p: v for p, v in res["report"].items() if v["bad"]}
        after = {k: v for k, v in res["after"].items() if k != "digest"}
        log(f"[dp] (b) rank {r} of {DP_RANKS} (gloo, one card; the step "
            f"{res['step_kind']}, the strips' render on a graph and their "
            f"all_reduce eager): losses {res['losses']} (rel "
            f"{rel}); tensors outside rtol 1e-5 atol 1e-6 against (a)'s "
            f"reference: {json.dumps(bad)}; after a refine and a step "
            f"{json.dumps(after)}")
        check(max(rel) <= 1e-5, f"rank {r} losses {res['losses']}")
        check(not bad, f"rank {r} differs from the batched step")
        check(res["after"]["finite"] and res["after"]["n_alive"] > 0
              and np.isfinite(res["after"]["loss"]),
              f"rank {r} after the refine: {res['after']}")
        check(res["step_kind"] == "eager (gloo)" and res["strip_graphed"],
              f"rank {r}: step {res['step_kind']}, strips on a graph "
              f"{res['strip_graphed']}")
        frame = torch.load(os.path.join(work, f"frame{r}.pt"))
        check(torch.equal(frame.view(torch.int32),
                          space["frame"].view(torch.int32)),
              f"rank {r}'s assembled strips differ from the strips "
              f"rendered here")
    log(f"[space] render_space_parallel over {DP_RANKS} gloo processes on "
        f"one card: every process's frame equals the strips rendered here "
        f"bit for bit")

    # --- (c): the CLI under torchrun ---
    out = os.path.join(work, "dp_cli")
    os.makedirs(out)
    export = os.path.join(out, "dp_{iter}.ply")
    run_children(torch, "cli", [out, data, "--views-per-batch",
                                           str(DP_VIEWS),
                                           "--total-train-iters",
                                           str(DP_CLI_STEPS),
                                           "--refine-every",
                                           str(DP_CLI_REFINE_EVERY),
                                           "--eval-every", "0",
                                           "--log-every", "1",
                                           "--export-path", export],
                            DP_RANKS, work, torchrun=True)
    cli = []
    for r in range(DP_RANKS):
        with open(os.path.join(out, f"cli{r}.json")) as f:
            cli.append(json.load(f))
    check(cli[0]["exports"] == [export.format(iter=DP_CLI_STEPS)]
          and all(c["exports"] == [] for c in cli[1:])
          and os.path.isfile(export.format(iter=DP_CLI_STEPS)),
          f"exports by rank {[c['exports'] for c in cli]}")
    for r, c in enumerate(cli):
        check(c["rc"] == 0 and len(c["losses"]) == DP_CLI_STEPS
              and all(np.isfinite(c["losses"])),
              f"rank {r}: rc {c['rc']} losses {c['losses']}")
        settled = max([i + 1 for i in c["overflow_iters"]], default=0)
        check(not any(c["overflowed"][settled:]),
              f"rank {r}: a step overflowed after the capacities grew: "
              f"{c['overflowed']}, grown after {c['overflow_iters']}")
        check(c["digest"] == cli[0]["digest"],
              f"rank {r}'s final state differs from rank 0's")
        check(c["refines"] == cli[0]["refines"] and len(c["refines"]) == 1,
              f"refines {c['refines']}")
        check(c["step_kind"] == "eager" and c["backend"] == "gloo",
              f"rank {r}: the CLI's step {c['step_kind']} over "
              f"{c['backend']}")
    log(f"[dp] (c) torchrun --nproc-per-node {DP_RANKS} of the CLI "
        f"({cli[0]['backend']}, {DP_CLI_STEPS} steps of {DP_VIEWS} views at "
        f"{img[0]}x{img[1]}, refine every {DP_CLI_REFINE_EVERY}): "
        f"steps {cli[0]['step_kind']}; losses {cli[0]['losses']}; refine "
        f"{cli[0]['refines']}; overflowed {cli[0]['overflowed']}; one "
        f"export, final states equal")
    return dict(losses=losses, ref_losses=ref_losses, graph_losses=g_losses,
                graph_bit_identical_to_eager=not g_bits,
                graph_bit_identical_to_graphed_batched=not b_bits,
                graph_max_abs_diff={p: v for p, v in g_diffs.items() if v},
                graph_captured=list(dp_graph_captured),
                graph_counts=counted(dp_graph_captured),
                ranks_step_kind=[x["step_kind"] for x in ranks],
                cli_step_kind=cli[0]["step_kind"],
                steps=DP_STEPS, launches=launches, captured=captured,
                cli_losses=cli[0]["losses"], cli_backend=cli[0]["backend"])


def child_ranks(torch, rank: int, world: int, job_path: str, store: str,
                work: str) -> int:
    """A process of the dp phase's (b): joins the gloo group, runs the DP
    steps from the job's state, a refine and one more step, and the space
    phase's strips; writes work/rank<r>.json and frame<r>.pt."""
    import datetime

    import torch.distributed as dist

    from brush_tpu_torch.parallel.data_parallel import make_dp_train_step
    from brush_tpu_torch.parallel.tile_parallel import (
        make_space_parallel_render, strip_camera_inputs)
    from brush_tpu_torch.train.refine import refine_step

    job = torch.load(job_path, map_location="cuda", weights_only=False)
    rng = torch.Generator(device="cuda")
    rng.set_state(job["rng"].cpu())   # map_location moved it to the card
    state = dataclasses.replace(job["state"], rng=rng)
    dist.init_process_group(
        "gloo", init_method=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        group = dist.group.WORLD
        step = make_dp_train_step(group, job["tcfg"], job["rcfg"])
        out = dict(losses=[], digests=[], step_kind=(
            "eager (gloo)" if step.graphs is None else "graphs"))
        for _ in range(DP_STEPS):
            state, stats, _ = step(state, job["batch"])
            out["losses"].append(float(stats.loss))
            out["digests"].append(state_digest(torch, state))
        out["report"] = hold_state(torch, state, job["ref"], job["lrs"])
        del job["ref"]
        state, _ = refine_step(state, job["tcfg"], *job["refine"])
        out["refined_digest"] = state_digest(torch, state)
        state, stats, _ = step(state, job["batch"])
        out["after"] = dict(
            loss=float(stats.loss), n_alive=int(state.splats.n_alive),
            finite=all(bool(torch.isfinite(v).all())
                       for v in state.splats.params().values()),
            digest=state_digest(torch, state))
        del state
        sp = job["space"]
        s = sp["splats"]
        stack, _ = strip_camera_inputs(sp["cam"], sp["rcfg"].img_size,
                                       world)
        run = make_space_parallel_render(group, sp["rcfg"])
        args = (s.means, s.log_scales, s.quats, s.sh_coeffs,
                s.raw_opacities, stack, sp["bg"].to("cuda"))
        frame = run(*args).clone()     # the capture's eager warm-up
        for _ in range(3):
            if not torch.equal(run(*args).view(torch.int32),
                               frame.view(torch.int32)):
                raise RuntimeError("a replay of the strips differs")
        out["strip_graphed"] = run.graph.captured
        del run
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(frame.cpu(), os.path.join(work, f"frame{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"rank {rank}: losses {out['losses']}", flush=True)
    return 0


def child_cli(torch, out: str, argv: list, eager: bool = False) -> int:
    """A process of the dp phase's (c) or of the multi-card case, started
    by torchrun: `cli.main` with the process functions wrapped to record
    what each process exported, each step's overflow flag and loss, the
    refines and the final state's digest, one loader thread, every
    program eager when asked; writes out/cli<rank>.json."""
    import functools

    import torch.distributed as dist

    from brush_tpu_torch import cli, process

    from brush_tpu_torch import graphs

    rank = int(os.environ["RANK"])
    rec = dict(exports=[], overflowed=[], overflow_iters=[], refines=[],
               losses=[])
    last = {}

    def step_turn(real):
        def run(loop, *a, **k):
            rec["step_kind"] = ("graphs" if loop.graphs is not None
                                else "eager")
            res = real(loop, *a, **k)
            rec["overflowed"].append(bool(res[1].overflowed))
            rec["losses"].append(float(res[1].loss))
            rec["overflow_iters"] += [m.iter for m in res[2]]
            return res
        return run

    def refine_turn(real):
        def run(loop, *a, **k):
            loop, msgs = real(loop, *a, **k)
            rec["refines"] += [m.iter for m in msgs]
            last["state"] = loop.state
            if dist.is_initialized():
                rec["backend"] = dist.get_backend()
            return loop, msgs
        return run

    def export(real):
        def run(path, splats):
            rec["exports"].append(path)
            return real(path, splats)
        return run

    with contextlib.ExitStack() as stack:
        for name, wrap in (("_step_turn", step_turn),
                           ("_refine_turn", refine_turn),
                           ("_export_splats", export),
                           # One loader thread: with two the view order is
                           # a race, and two runs are compared.
                           ("SceneLoader", lambda real: functools.partial(
                               real, n_threads=1))):
            stack.enter_context(wrapped(process, name, wrap))
        if eager:
            stack.enter_context(wrapped(graphs, "capturable",
                                        lambda real: lambda *a: False))
        rec["rc"] = cli.main(argv)
    rec["digest"] = state_digest(torch, last["state"])
    with open(os.path.join(out, f"cli{rank}.json"), "w") as f:
        json.dump(rec, f)
    return rec["rc"]


def sync_free(torch, what: str, fn):
    """`fn()` under `torch.cuda.set_sync_debug_mode("error")`: a copy from
    pageable memory or a read back to the host inside it fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise PhaseError(f"{what} synchronised the stream: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[graph] {what}: no synchronisation (sync debug mode 'error')")


def replay_profile(torch, what: str, fn, runs: int = 1) -> dict:
    """Device ops and the launches of each kernel of csrc/ (by its device
    name, `kernels.KERNELS`) a run of `fn` (a graph's replay: launched as
    one graph, so the wrappers' counters do not see them), from a
    torch.profiler trace of `runs` runs."""
    from torch.profiler import ProfilerActivity, profile

    from brush_tpu_torch import kernels
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    host = {e.name for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA}
    n_ops = 0
    seen = dict.fromkeys(kernels.KERNELS, 0)
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name in host):
            continue
        n_ops += 1
        for name, row in kernels.KERNELS.items():
            symbol, variant = row.symbol
            if symbol in e.name and variant in e.name:
                seen[name] += 1
    res = dict(device_ops=n_ops / runs,
               kernels={k: v / runs for k, v in seen.items() if v})
    log(f"[graph] {what}, profiled replay: {res['device_ops']:.1f} device "
        f"ops; kernels of csrc/ by device name " + json.dumps(res["kernels"]))
    return res


def hold_steps(torch, got, want, lrs: dict, steps: int,
               rtol: float | None = None) -> dict:
    """A TrainState `got` from `steps` graphed steps against `want` from
    the same steps run eagerly on the card, under the rule of the
    backward's non-repeatable f64 atomics (`rtol`, by default `BWD_RTOL`:
    per-splat gradients within 1e-5 of each row's largest, the sums' last
    rounding in atomic order): integer tensors equal; every float tensor
    within rtol of its array's largest entry (+ BWD_ATOL), the Adam second
    moments (square in the gradient) within twice that; a parameter array
    also within 2 * lr * steps, Adam's step for an entry whose gradient is
    rounding noise being lr * sign(noise). Returns the largest difference
    by path; raises PhaseError outside the rule."""
    from brush_tpu_torch.ops.rasterize_cuda import BWD_ATOL, BWD_RTOL
    rtol = BWD_RTOL if rtol is None else rtol
    out = {}
    for path, w, g in _state_pairs(torch, want, got):
        check(g is not None and g.shape == w.shape and g.dtype == w.dtype,
              f"{path}: {None if g is None else tuple(g.shape)} against "
              f"{tuple(w.shape)}")
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{path}: {int((g != w).sum())} "
                  f"entries differ")
            out[path] = 0.0
            continue
        d = float((g - w).abs().max()) if w.numel() else 0.0
        top = float(w.abs().max()) if w.numel() else 0.0
        limit = (2.0 if path.endswith("moment2") else 1.0) * (
            rtol * top + BWD_ATOL)
        name = path.split(".")[-1]
        if path.startswith("state.splats.") and name in lrs:
            limit = max(limit, 2.0 * lrs[name] * steps)
        check(d <= limit and np.isfinite(d),
              f"{path}: graphed against eager max |d| {d:.3g} past "
              f"{limit:.3g} (largest entry {top:.3g})")
        out[path] = d
    return out


def phase_graph(torch, serve, train, loop, proc):
    """The JAX package's compiled, donated programs on the card: the eager
    frame, step and loop turn run under sync debug mode, then the graphed
    serve, train and loop cells held to the eager ones, the frame and the
    step with one profiled replay each; `train_process` (the process phase)
    ran through `StepGraphs`. The launches of the frame's and the step's
    captures are kept for the kernel phase."""
    from brush_tpu_torch import graphs, kernels
    from brush_tpu_torch.ops.rasterize_cuda import BWD_RTOL
    from brush_tpu_torch.process import LoopState, loop_step
    from brush_tpu_torch.render import RenderConfig, render
    from brush_tpu_torch.train.config import TrainConfig
    from brush_tpu_torch.train.trainer import SceneBatch, init_train_state
    from brush_tpu_torch.train.trainer import train_step_impl
    from brush_tpu_torch.utils.synthetic import bench_splats

    img = IMG_SIZE
    plans = serve["plans"]
    serve_cfg = plans[0][2]
    s = serve["splats"].fold_min_scale()
    params = (s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities)
    bg = torch.zeros(3, dtype=torch.float32, device="cuda")
    cams = [ci for _, ci, _ in plans]
    # One graph a RenderConfig: the three views share the largest expansion
    # width and remainder capacity they planned.
    cfg = dataclasses.replace(
        serve_cfg, expand_k0=max(p[2].expand_k0 for p in plans),
        isect_cap=max(p[2].isect_cap for p in plans))
    tcfg = TrainConfig()
    rcfg = RenderConfig(img_size=img, sh_degree=SH_DEGREE,
                        isect_cap=serve_cfg.isect_cap,
                        expand_k0=serve_cfg.expand_k0, use_pallas=True)
    batch = train["batch"]
    state0 = init_train_state(serve["splats"], SEED)
    truths = loop["truths"]
    centers = torch.tensor(np.stack([cam.position for cam, _, _ in truths]),
                           dtype=torch.float32, device="cuda")
    focals = torch.tensor([cam.focal(img)[0] for cam, _, _ in truths],
                          dtype=torch.float32, device="cuda")
    wants = [render(*params, ci, bg, cfg) for ci in cams]
    torch.cuda.synchronize()

    # --- the eager path holds no synchronisation ---
    sync_free(torch, "eager serve frame",
              lambda: render(*params, cams[0], bg, cfg))
    sync_free(torch, "eager training step", lambda: train_step_impl(
        _twin(torch, state0), batch, tcfg, rcfg))
    floored = dataclasses.replace(state0, splats=dataclasses.replace(
        state0.splats, min_scale=torch.full((N_SPLATS,), 0.01,
                                            device="cuda")))
    sync_free(torch, "eager training step with a 3D filter floor",
              lambda: train_step_impl(_twin(torch, floored), batch, tcfg,
                                      rcfg))
    del floored
    sync_free(torch, "eager loop turn (its first: the one-step-behind "
              "overflow read comes a turn later)", lambda: loop_step(
                  LoopState(state=_twin(torch, state0), rcfg=rcfg), batch,
                  tcfg, centers, focals))

    # --- serve cell: the frame as a RenderGraph ---
    graphs.RENDER_GRAPHS.clear()
    kernels.reset_launches()
    with kernels.capture() as cap_frame:
        graphs.RENDER_GRAPHS.get(render, cfg, N_SPLATS)(*params, cams[0], bg)
    frame_launches = dict(kernels.LAUNCHES)
    frame = graphs.RENDER_GRAPHS.get(render, cfg, N_SPLATS)
    for v, (ci, (want, w_aux)) in enumerate(zip(cams, wants)):
        out, aux = frame(*params, ci, bg)
        check(torch.equal(out.view(torch.int32), want.view(torch.int32)),
              f"graph frame of view {v} differs from the eager frame at "
              f"{int((out != want).any(-1).sum())} pixels")
        check(int(aux.num_isects) == int(w_aux.num_isects),
              f"view {v}: num_isects {int(aux.num_isects)} against "
              f"{int(w_aux.num_isects)}")
    sync_free(torch, "graph frame replay", lambda: frame(*params, cams[1],
                                                         bg))
    # Three replays: a trace now and then drops an op.
    frame_prof = replay_profile(torch, "serve frame",
                                lambda: frame(*params, cams[0], bg), runs=3)
    for name in kernels.SERVE_PATH:
        check(frame_prof["kernels"].get(name, 0) > 0,
              f"the replayed frame launched no {name}")
        check(any(c.name == name for c in cap_frame),
              f"the frame's capture recorded no {name}")
    res = dict(frame_replay=frame_prof, frame_launches=frame_launches,
               frame_config=dict(expand_k0=cfg.expand_k0,
                                 isect_cap=cfg.isect_cap))
    log(f"[graph] serve cell: {len(cams)} views, each graph frame equal to "
        f"the eager frame bit for bit (expand_k0={cfg.expand_k0} isect_cap="
        f"{cfg.isect_cap})")
    del wants, frame
    graphs.RENDER_GRAPHS.clear()

    # --- train cell: 1 + TRAIN_STEPS steps, graphed against eager ---
    eager, graphed = _twin(torch, state0), _twin(torch, state0)
    steps = graphs.StepGraphs(tcfg)
    kernels.reset_launches()
    with kernels.capture() as cap_step:
        graphed, g_stats, _ = steps(graphed, batch, rcfg)
    step_launches = dict(kernels.LAUNCHES)
    eager, e_stats, _ = train_step_impl(eager, batch, tcfg, rcfg)
    stats_by = {"graph": [g_stats], "eager": [e_stats]}
    # The eager steps, then the replays, each run back to back as a
    # training loop runs them.
    for how in ("eager", "graph"):
        for _ in range(TRAIN_STEPS):
            if how == "graph":
                graphed, st, _ = steps(graphed, batch, rcfg)
            else:
                eager, st, _ = train_step_impl(eager, batch, tcfg, rcfg)
            stats_by[how].append(st)
    torch.cuda.synchronize()
    pairs = list(zip(stats_by["graph"], stats_by["eager"]))
    losses = [(float(g.loss), float(e.loss)) for g, e in pairs]
    for k, (g, e) in enumerate(losses, start=1):
        check(np.isfinite(g) and abs(g - e) <= BWD_RTOL * abs(e),
              f"step {k}: graphed loss {g} against eager {e}")
    check(not any(bool(g.overflowed) for g, _ in pairs), "a step overflowed")
    lrs = dict(means=tcfg.lr_mean * float(state0.median_scale),
               log_scales=tcfg.lr_scale, quats=tcfg.lr_rotation,
               sh_coeffs=tcfg.lr_coeffs_dc, raw_opacities=tcfg.lr_opac)
    diffs = hold_steps(torch, graphed, eager, lrs, 1 + TRAIN_STEPS)
    check(torch.equal(graphed.rng.get_state(), eager.rng.get_state()),
          "the generator after the graphed steps differs from eager's")
    check(steps.captures == 1, f"{steps.captures} captures for one key")
    sync_free(torch, "graph step replay",
              lambda: steps(graphed, batch, rcfg))
    step_prof = replay_profile(torch, "training step",
                               lambda: steps(graphed, batch, rcfg))
    for name in kernels.TRAIN_PATH:
        check(step_prof["kernels"].get(name, 0) > 0,
              f"the replayed step launched no {name}")
        check(any(c.name == name for c in cap_step),
              f"the step's capture recorded no {name}")
    res.update(
        step_losses=losses,
        step_max_abs_diff={k: v for k, v in diffs.items() if v},
        step_replay=step_prof, step_launches=step_launches)
    log(f"[graph] train cell: {1 + TRAIN_STEPS} steps graphed and eager "
        f"from one state, losses {[(round(g, 7), round(e, 7)) for g, e in losses]}"
        f", every state tensor within the rule (largest |d| by path "
        + json.dumps({k: float(f"{v:.3g}") for k, v in diffs.items() if v})
        + "), the generator equal")
    steps.clear()
    del eager, graphed, pairs

    # --- loop cell: LOOP_STEPS turns of loop_step on the graph ---
    tcfg_loop = TrainConfig(refine_every=REFINE_EVERY)
    student = bench_splats(N_SPLATS, sh_degree=SH_DEGREE, seed=SEED,
                           capacity=LOOP_CAPACITY)
    batches = [SceneBatch(gt_packed=gt, cam=ci) for _, ci, gt in truths]
    gl = LoopState(state=init_train_state(student, SEED), rcfg=rcfg,
                   graphs=graphs.StepGraphs(tcfg_loop))
    del student
    flags, messages = [], []
    for i in range(LOOP_STEPS):
        gl, stats, msgs = loop_step(gl, batches[i % N_VIEWS], tcfg_loop,
                                    centers, focals)
        flags.append(stats.overflowed)
        messages += msgs
        if any(m.kind == "refine" for m in msgs):
            n_alive = int(gl.state.splats.n_alive)
            for name, x in gl.state.splats.params().items():
                check(bool(torch.isfinite(x[:n_alive]).all()),
                      f"{name} not finite after the refine at {i + 1}")
    refines = [m.iter for m in messages if m.kind == "refine"]
    overflows = [m for m in messages if m.kind == "overflow"]
    check(refines == list(range(REFINE_EVERY, LOOP_STEPS + 1, REFINE_EVERY)),
          f"refines at {refines}")
    flags = [bool(f) for f in flags]
    settled = max([m.iter + 1 for m in overflows], default=0)
    check(not any(flags[settled:]), f"a step overflowed after growth: "
          f"{[i + 1 for i, f in enumerate(flags) if f]}")
    captures = gl.graphs.captures
    eval_cfg = dataclasses.replace(rcfg, isect_cap=gl.rcfg.isect_cap,
                                   forward_only=True)
    ev = phase_eval(torch, "student after the graphed loop", gl.state.splats,
                    truths, eval_cfg)
    gap = ev["psnr"] - loop["psnr"]["after"]
    check(abs(gap) <= 0.05, f"eval psnr {ev['psnr']} after the graphed loop "
          f"against {loop['psnr']['after']} after the eager loop")
    res.update(loop_captures=captures, loop_psnr=ev["psnr"],
               eager_loop_psnr=loop["psnr"]["after"],
               loop_overflows=[m.data for m in overflows])
    log(f"[graph] loop cell: {LOOP_STEPS} turns of loop_step on StepGraphs "
        f"({captures} captures: the first step, the layout the first refine "
        f"makes, and each capacity or isect_cap growth), refines at "
        f"{refines}, state finite after each, no overflow after growth; eval "
        f"psnr {ev['psnr']:.4f} dB against the eager loop's "
        f"{loop['psnr']['after']:.4f} (gap {gap:+.4f})")
    gl.graphs.clear()
    del gl
    graphs.RENDER_GRAPHS.clear()

    # --- loop cell: the refine on a RefineGraph ---
    res.update(_refine_cell(torch, loop))

    # --- train_process: the process phase's turns ran on StepGraphs ---
    check(proc["graphed_turns"] == PROCESS_STEPS,
          f"{proc['graphed_turns']} of {PROCESS_STEPS} train_process turns "
          f"ran on StepGraphs")
    res.update(process_captures=proc["graph_captures"])
    log(f"[graph] train_process: every turn on StepGraphs "
        f"({proc['graph_captures']} captures)")

    res.update(frame_captured=list(cap_frame), step_captured=list(cap_step),
               frame_counts=counted(cap_frame), step_counts=counted(cap_step))
    return res


def _refine_cell(torch, loop) -> dict:
    """The loop cell's refine (of the state one step before its last
    refine, so it selects and splits) on a RefineGraph: the first call
    captures, then 3 replays from copies of the same state, each equal bit
    for bit to the eager `refine_step` (statistics and generator too); a
    replay under sync debug mode."""
    from brush_tpu_torch import graphs
    from brush_tpu_torch.train.refine import refine_step

    state, tcfg = loop["before_last_refine"], loop["tcfg"]
    views = (loop["centers"], loop["focals"])
    want, w_stats = refine_step(fresh_copy(torch, state), tcfg, *views)
    refines = graphs.RefineGraphs(tcfg)

    def held(got, g_stats, what):
        bad = diff_bits(torch, got, want)
        check(not bad, f"{what}: the graphed refine differs from eager at "
              f"{bad}")
        for name in w_stats._fields:
            check(int(getattr(g_stats, name)) == int(getattr(w_stats, name)),
                  f"{what}: {name} {int(getattr(g_stats, name))} against "
                  f"{int(getattr(w_stats, name))}")
    held(*refines(fresh_copy(torch, state), *views), "the capture's call")
    for k in range(3):
        held(*refines(fresh_copy(torch, state), *views), f"replay {k + 1}")
    s = fresh_copy(torch, state)
    sync_free(torch, "graph refine replay", lambda: refines(s, *views))
    check(refines.captures == 1, f"{refines.captures} refine captures")
    refines.clear()
    del want, s
    log(f"[graph] loop cell's refine on a RefineGraph: 3 replays from "
        f"copies of the state one step before the last refine, each equal "
        f"to eager bit for bit (added {int(w_stats.num_added)}, pruned "
        f"{int(w_stats.num_pruned)}, resampled {int(w_stats.num_resampled)})")
    return dict(refine_stats={k: int(getattr(w_stats, k))
                              for k in w_stats._fields})


def fisheye_camera():
    """The fisheye cell's view: the KB4 lens of its configuration's
    `camera` (portbench/configs/scannetpp-fisheye-1m-sh3.json), 8 units
    from the scene's centre as the cell's views stand. Returns (Camera,
    img_size)."""
    from brush_tpu_torch.camera import Camera, KannalaBrandt4, focal_to_fov
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "portbench", "configs",
                           "scannetpp-fisheye-1m-sh3.json")) as f:
        lens = json.load(f)["camera"]
    model = KannalaBrandt4(*lens["k"])
    img = (lens["width"], lens["height"])
    return Camera(position=np.array([0.0, 0.0, -8.0]),
                  rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                  fov_x=focal_to_fov(lens["fx"], img[0], model),
                  fov_y=focal_to_fov(lens["fy"], img[1], model),
                  model=model), img


def phase_project(torch) -> dict:
    """The projection's kernels at the shapes of the benchmark's cells, for
    the kernel phase: a training render's projection and backward over the
    train cells' rows (1M live splats of the bench scene in a capacity of
    2^21, SH degree 3, 1920x1080, random cotangents), the same through the
    fisheye cell's KB4 view at 1752x1168, and the viewer's forward at 1M
    splats (1920x1080) and at 2M (3200x1800). Returns, by path, the launch
    counters and the captured launches."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops.project_cuda import project
    from brush_tpu_torch.render import camera_inputs
    from brush_tpu_torch.utils.synthetic import bench_splats

    _, bench = next(iter(views(1, YAW)))
    fisheye, fisheye_img = fisheye_camera()
    out = {}
    for path, count, capacity, cam, img, train in (
            ("project_train", N_SPLATS, 1 << 21, bench, IMG_SIZE, True),
            ("project_train_kb4", N_SPLATS, 1 << 21, fisheye, fisheye_img,
             True),
            ("project_view_1m", N_SPLATS, None, bench, IMG_SIZE, False),
            ("project_view_2m", 2 * N_SPLATS, None, bench, (3200, 1800),
             False)):
        s = bench_splats(count, sh_degree=SH_DEGREE, seed=SEED,
                         capacity=capacity)
        rows = [t.detach().requires_grad_(train) for t in (
            s.means, s.log_scales, s.quats, s.sh_coeffs, s.raw_opacities)]
        ci = camera_inputs(cam, img)
        n = rows[0].shape[0]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        cots = [torch.randn((n,) + shape, generator=gen, device="cuda")
                for shape in ((2,), (3,), (3,), ())]
        kernels.reset_launches()
        with torch.set_grad_enabled(train), kernels.capture() as caps:
            proj = project(*rows, ci, img, sh_degree=SH_DEGREE,
                           model=cam.model)
            if train:
                total = sum((getattr(proj, o) * c).sum() for o, c in zip(
                    ("mean2d", "conic", "color", "opac"), cots))
                torch.autograd.grad(total, rows)
        torch.cuda.synchronize()
        want = ("project_fwd", "project_bwd") if train else ("project_fwd",)
        check(sorted(c.name for c in caps) == sorted(want),
              f"{path}: launched {[c.name for c in caps]}")
        out[path] = dict(launches=dict(kernels.LAUNCHES), captured=list(caps))
        log(f"[project] {path}: {n} rows, {int(proj.visible.sum())} visible "
            f"at {img[0]}x{img[1]}, launches {want}")
        del proj, rows, s
    return out


def phase_kernels(torch, serve, train, direct, stress, grow, loop,
                  init_lod, proc, viewer, lpips, dp, space, graph, project):
    """Replay every launch captured by the projection phase, of the first
    served frame, of the first training step, of the direct calls, of the
    stress run, of two growth steps (the overflowing first, and the first
    at the grown capacities), of two loop steps (the first, and the first
    after a refine), of one view of the evaluation after the loop, of one
    view of the LOD scoring, of one step of `train_process` (the first
    capture after its first refine), of one /render of the web viewer, of
    the first training step with the LPIPS term, of the second step of the
    dp phase's one-process group, of the second strip of the space phase
    and of the graphs' captures: kernel against plain version on the same
    inputs (each kernel module's own `compare` holds them; the plain version
    runs once a launch), then the kernel's and the library call's times and
    the kernel's bound. A kernel is listed under the first of those paths
    that launched it; where a later one did too it is held and timed at
    those shapes as well, as `<path>_ms`, the sum over that path's replayed
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

    def measure(name, launches):
        row = kernels.KERNELS[name]
        r = dict(ms=0.0, device_ms=0.0,
                 library_ms=0.0 if name in library else None,
                 library_device_ms=0.0 if name in library else None,
                 err=0.0, bytes=0, ops=0, shape=[], parts=[])
        for launch in launches:
            kernel, plain = launch.replay(launch.inputs)
            got = kernel()
            want, pairs = plain_counted(launch, plain)
            torch.cuda.synchronize()
            err = launch.compare(got, want)
            del want
            nbytes, ops, shape = kernel_work(launch, got, pairs)
            del got
            dev = device_time(torch, kernel, ITERS, own=row.launches)
            # No reading of zero: a call runs at least its own kernels and
            # takes device time (a trace that dropped them was retaken).
            check(dev["ms"] > 0.0 and dev["kernels"] >= row.launches,
                  f"{name} {shape}: device_ms {dev['ms']} with (kernels, "
                  f"memsets, copies) a call by trace {dev['ops_by_trace']}")
            # The kernel's own launches a call and at most its memsets,
            # nothing else, in some trace (a trace may drop ops, never add).
            check(any(k == row.launches and m <= row.memsets and c == 0
                      for k, m, c in dev["ops_by_trace"]),
                  f"{name} {shape}: (kernels, memsets, copies) a call by "
                  f"trace {dev['ops_by_trace']}, expected {row.launches} "
                  f"kernels, at most {row.memsets} memsets, no copies")
            lib = (library[name](launch.inputs) if name in library
                   else None)
            part = dict(
                shape=shape, ms=time_ms(torch, kernel, ITERS),
                device_ms=dev["ms"],
                device_ops={k: dev[k] for k in ("kernels", "memsets",
                                                "copies", "retraced")},
                library_ms=(time_ms(torch, lib, ITERS) if lib else None),
                library_device_ms=(device_time(torch, lib, ITERS)["ms"]
                                   if lib else None),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3)
            r["err"] = max(r["err"], err)
            r["bytes"] += nbytes
            r["ops"] += ops
            r["shape"].append(shape)
            r["parts"].append(part)
            for key in ("ms", "device_ms", "library_ms", "library_device_ms"):
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
        # The projection's kernels at the benchmark cells' shapes first.
        **{p: (r["launches"], by_name(r["captured"]), 1)
           for p, r in project.items()},
        "serve": (serve["launches"], by_name(serve["captured"]),
                  serve["frames"]),
        "train": (train["launches"], by_name(train["captured"]),
                  train["steps"]),
        "direct": (direct["launches"], by_name(direct["captured"]), 1),
        "stress": (stress["launches"], by_name(stress["captured"]), 1),
        "grow": (grow["launches"], by_name(grow["captured"]), grow["steps"]),
        "loop": (loop["launches"], by_name(loop["captured"]), loop["steps"]),
        "eval": (loop["eval_launches"], by_name(loop["eval_captured"]),
                 N_VIEWS),
        "init-lod": (init_lod["launches"], by_name(init_lod["captured"]), 1),
        "process": (proc["launches"], by_name(proc["captured"]),
                    PROCESS_STEPS),
        "viewer": (viewer["launches"], by_name(viewer["captured"]),
                   viewer["frames"]),
        "lpips": (lpips["launches"], by_name(lpips["captured"]),
                  lpips["steps"]),
        "dp_step": (dp["launches"], by_name(dp["captured"]), dp["steps"]),
        "space_strip": (space["launches"], by_name(space["captured"]),
                        space["strips"]),
        # The graphs' captures: a replay runs no wrapper, so these count
        # the launches the capture recorded (the profiled replay's device
        # kernels are in the graph phase's line).
        "graph_frame": (graph["frame_counts"],
                        by_name(graph["frame_captured"]), 1),
        "graph_step": (graph["step_counts"], by_name(graph["step_captured"]),
                       1),
        # This slice's graphs: the DP step over NCCL, a PUP scoring view,
        # the process's LOD bake (its scoring view and LOD step) and a strip.
        "graph_dp_step": (dp["graph_counts"], by_name(dp["graph_captured"]),
                          1),
        "graph_score": (init_lod["graph_counts"],
                        by_name(init_lod["graph_captured"]), 1),
        "graph_lod_bake": (proc["bake_counts"],
                           by_name(proc["bake_captured"]), 1),
        "graph_strip": (space["graph_counts"],
                        by_name(space["graph_captured"]), 1)}
    counters = {p: c for p, (c, _, _) in paths.items()}
    line = []
    for name, row in kernels.KERNELS.items():
        path = next(p for p, (_, caps, _) in paths.items() if name in caps)
        counts, caps, n_runs = paths[path]
        r = measure(name, caps[name])
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / F32_OPS_PER_S * 1e3
        entry = dict(
            name=name, source=f"brush_tpu_torch/csrc/{row.source}",
            path=path, launches=counts[name],
            launches_per_run=counts[name] / n_runs,
            launches_by_path={p: c[name] for p, c in counters.items()},
            max_abs_err=r["err"], ms=r["ms"], device_ms=r["device_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"], shape=r["shape"],
            device_ops=[part["device_ops"] for part in r["parts"]])
        if len(r["parts"]) > 1:
            entry["per_launch"] = r["parts"]
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
                f"{other}_library_ms": ro["library_ms"],
                f"{other}_library_device_ms": ro["library_device_ms"],
                f"{other}_bound_ms": max(ro["bytes"] / HBM_BYTES_PER_S,
                                         ro["ops"] / F32_OPS_PER_S) * 1e3,
                f"{other}_shape": ro["shape"]})
            also += (f"; on the {other} path: ms={ro['ms']:.5f} device_ms="
                     f"{ro['device_ms']:.5f} library_ms={ro['library_ms']} "
                     f"library_device_ms={ro['library_device_ms']} "
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
            f"{json.dumps(entry['device_ops'][0])}) library_ms="
            f"{r['library_ms']} library_device_ms={r['library_device_ms']} "
            f"bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}) "
            f"launches={entry['launches']} by path "
            f"{json.dumps(entry['launches_by_path'])} shape={r['shape']}"
            + also)
        for part in r["parts"] if len(r["parts"]) > 1 else []:
            log(f"[kernels]   {name} {part['shape']}: ms={part['ms']:.5f} "
                f"device_ms={part['device_ms']:.5f} library_ms="
                f"{part['library_ms']} library_device_ms="
                f"{part['library_device_ms']} bound_ms="
                f"{part['bound_ms']:.5f}")
    return line


def gpu_line(every_card: bool = False) -> str:
    """The card's name and power limit as nvidia-smi gives them (every
    card's, one a line, when asked)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        lines = out.stdout.strip().splitlines()
        return "\n".join(lines) if every_card else lines[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def _multicard_only(torch) -> int:
    """`--multi-card`: the process cell's dataset and the multi-card phase
    alone, on a machine of several cards."""
    import shutil
    import tempfile
    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --multi-card: {n} card; the multi-card case "
              f"needs two or more", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="brush_multicard_")
    try:
        phase_build()
        data, _ = write_process_dataset(torch, work)
        res = phase_multicard(torch, work, data)
        print(json.dumps({f"multicard_{k}": v for k, v in res.items()}))
        print(gpu_line(every_card=True))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n}}))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    if argv[:2] == ["--child", "ranks"]:
        rank, world, job, store, work = argv[2:]
        return child_ranks(torch, int(rank), int(world), job, store, work)
    if argv[:2] in (["--child", "cli"], ["--child", "cli-eager"]):
        return child_cli(torch, argv[2], argv[3:],
                         eager=argv[1] == "cli-eager")
    if argv[:1] == ["--multi-card"]:
        return _multicard_only(torch)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 off")

    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="brush_smoke_")
    try:
        return _run_phases(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_phases(torch, work: str) -> int:
    t_all = time.perf_counter()
    phase_build()
    serve = phase_serve(torch)
    phase_golden(torch)
    train = phase_train(torch, serve)
    phase_golden_train(torch)
    direct = phase_direct(torch, train)
    stress = phase_stress(torch, serve)
    grow = phase_grow(torch, serve, train)
    loop = phase_loop(torch, serve)
    init_lod = phase_init_lod(torch, loop)
    proc, live, ffi = phase_process(torch, loop, work)
    viewer = phase_viewer(torch)
    lpips = phase_lpips(torch, serve, train)
    space = phase_space(torch, serve)
    dp = phase_dp(torch, serve, train, space, os.path.join(work, "scene"),
                  work)
    if torch.cuda.device_count() > 1:
        multicard = phase_multicard(torch, work, os.path.join(work, "scene"))
    else:
        multicard = {}
        log("[multicard] one card: the multi-card case (torchrun of the CLI "
            "over NCCL, a card a process; `python3 chip_smoke.py "
            "--multi-card` on a machine of several) was not run")
    graph = phase_graph(torch, serve, train, loop, proc)
    project = phase_project(torch)
    kernel_line = phase_kernels(torch, serve, train, direct, stress, grow,
                                loop, init_lod, proc, viewer, lpips, dp,
                                space, graph, project)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"serve_isects": serve["isects"],
                      "train_losses": train["losses"],
                      "train_stages_ms": train["stages"]}))
    print(json.dumps({"loop_losses": loop["losses"],
                      "refines": loop["refines"],
                      "overflows": loop["overflows"],
                      "graph_refine": loop["graph_refine"],
                      "grow_overflow": grow["overflow"],
                      "grow_isect_cap": grow["isect_cap"],
                      "grow_capacity": grow["capacity"],
                      "eval_psnr_before": loop["psnr"]["before"],
                      "eval_psnr_after": loop["psnr"]["after"],
                      "eval_ssim_before": loop["ssim"]["before"],
                      "eval_ssim_after": loop["ssim"]["after"],
                      "pup_sums_max_abs_diff": init_lod[
                          "pup_sums_max_abs_diff"]}))
    print(json.dumps({"process_" + k: v for k, v in proc.items()
                      if k not in ("launches", "captured", "bake_captured")}))
    for name, res in (("viewer", viewer), ("live", live), ("ffi", ffi),
                      ("lpips", lpips), ("dp", dp), ("space", space),
                      ("graph", graph), ("multicard", multicard)):
        if res:
            print(json.dumps({f"{name}_{k}": v for k, v in res.items()
                              if k not in ("captured", "frame", "job",
                                           "frame_captured", "step_captured",
                                           "graph_captured")}))
    print(json.dumps({"kernels": kernel_line}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
