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
6. direct  — the scan kernel's f32-sum and int32-max variants, which no
             render or training path calls yet, driven once at the width
             of the training scene's slot space.
7. kernels — each kernel against its plain PyTorch version, on the card,
             on the inputs the serving frame, the training step and the
             direct calls gave it (scan, stack and emit bit-exact; the
             forward rasterizers within a few ulps; the backward within
             1e-5 of each gradient row's largest entry; the f32 scan within
             1e-6 of the running sum of |x|), with its time, the plain
             version's, a library call's where one computes the same
             function, and its bound on the card.
8. profile — frames and training steps under torch.profiler: the device's
             busy time, its idle share and the top device ops.

The last lines are the `kernels` JSON, the card's name and power limit
from nvidia-smi, and the result JSON. No GPU, or no brush_tpu_torch next to
this script: exit 2 with no result.
"""

from __future__ import annotations

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
                      "ops/rasterize_pallas.py:_bwd_kernel"),
    "scan_f32": ("brush_tpu_torch/csrc/scan.cu",
                 "brush_tpu/ops/scan_pallas.py:43",
                 "ops/scan_pallas.py:_scan_kernel (f32 sum)"),
    "scan_max": ("brush_tpu_torch/csrc/scan.cu",
                 "brush_tpu/ops/scan_pallas.py:43",
                 "ops/scan_pallas.py:_scan_kernel (int32 max)"),
}


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
    scene's slot space: an [11, S] f32 sum (the shape of a per-slot
    gradient matrix) and a [S] int32 running max."""
    from brush_tpu_torch import kernels
    from brush_tpu_torch.ops import scan_cuda
    slot_grads = next(launch for launch in train["captured"]
                      if launch.name == "rasterize_bwd")
    width = slot_grads.inputs[0].shape[1]
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


def kernel_work(launch, got):
    """(bytes the function must move, f32 operations it must do, shape) for
    one launch on these inputs: each input read once, each output written
    once; the rasterizers' operations count the (pixel, slot) pairs this
    run's data needs (forward: before each pixel is done; backward: pairs
    replayed and pairs blended over the tiles' useful ranges)."""
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
        _, pairs = rasterize_cuda.rasterize_forward_plain(*inputs,
                                                          count_pairs=True)
        return (int(spans.sum()) * rasterize_cuda.DIET_WORDS * 4
                + n_tiles * (8 + rasterize_cuda.OUT_ROWS * tile_bytes) + 12,
                int(pairs) * RASTER_OPS_PER_PAIR,
                [n_tiles, int(spans.sum()), int(spans.max())])
    if name == "rasterize_fwd_train":
        _, pairs = rasterize_cuda.rasterize_forward_train_plain(
            *inputs, count_pairs=True)
        return (int(spans.sum()) * rasterize_cuda.TRAIN_ROWS * 4
                + n_tiles * (8 + rasterize_cuda.TRAIN_OUT_ROWS * tile_bytes)
                + 12,
                int(pairs) * RASTER_OPS_PER_PAIR,
                [n_tiles, int(spans.sum()), int(spans.max())])
    # rasterize_bwd: reads the replayed slots, the saved and cotangent
    # tiles; writes the whole [11, L] gradient matrix.
    _, replayed, blended = rasterize_cuda.rasterize_backward_plain(
        *inputs, count_pairs=True)
    useful = inputs[2][:, 5, 0].to(torch.int64)
    return (int(useful.sum()) * rasterize_cuda.TRAIN_ROWS * 4
            + n_tiles * (8 + (rasterize_cuda.TRAIN_OUT_ROWS
                              + rasterize_cuda.V_ROWS) * tile_bytes) + 12
            + got.numel() * 4,
            int(replayed) * BWD_REPLAY_OPS_PER_PAIR
            + int(blended) * BWD_BLEND_OPS_PER_PAIR,
            [n_tiles, int(useful.sum()), int(useful.max()), int(replayed),
             int(blended)])


def phase_kernels(torch, serve, train, direct):
    """Replay every launch of the first served frame, of the first training
    step and of the direct calls: kernel against plain version on the same
    inputs (each kernel module's own `compare` holds them), then the
    kernel's, the plain version's and the library call's times. A kernel
    on both paths (scan, stack, emit) is timed at the serving frame's
    shapes and, as `train_ms`, at the training step's."""
    from brush_tpu_torch import kernels

    library = {"scan": lambda x: torch.cumsum(x, dim=1),
               "scan_f32": lambda x: torch.cumsum(x, dim=1),
               "scan_max": lambda x: torch.cummax(x, dim=0),
               "stack": lambda rows, *_: torch.stack(rows)}
    # The plain rasterizers and emission are slow at full width: time them
    # over fewer calls.
    plain_iters = {"emit": 2, "rasterize_fwd": 1, "rasterize_fwd_train": 1,
                   "rasterize_bwd": 1}

    def measure(name, launches):
        r = dict(ms=0.0, plain_ms=0.0, library_ms=0.0 if name in library
                 else None, err=0.0, bytes=0, ops=0, shape=[])
        for launch in launches:
            kernel, plain = launch.replay(launch.inputs)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            r["err"] = max(r["err"], launch.compare(got, want))
            del want
            nbytes, ops, shape = kernel_work(launch, got)
            del got
            r["bytes"] += nbytes
            r["ops"] += ops
            r["shape"].append(shape)
            r["ms"] += time_ms(torch, kernel, ITERS)
            r["plain_ms"] += time_ms(torch, plain,
                                     plain_iters.get(name, ITERS))
            if name in library:
                r["library_ms"] += time_ms(
                    torch, lambda: library[name](*launch.inputs), ITERS)
        return r

    def by_name(captured):
        out: dict = {}
        for launch in captured:
            out.setdefault(launch.name, []).append(launch)
        return out

    paths = {"serve": (serve, by_name(serve["captured"]), serve["frames"]),
             "train": (train, by_name(train["captured"]), train["steps"]),
             "direct": (direct, by_name(direct["captured"]), 1)}
    line = []
    for name in kernels.KERNEL_NAMES:
        path = next(p for p, (_, caps, _) in paths.items() if name in caps)
        run, caps, n_runs = paths[path]
        r = measure(name, caps[name])
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / F32_OPS_PER_S * 1e3
        src, replaces, tpu = KERNEL_META[name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces, tpu=tpu,
            path=path, launches=run["launches"][name],
            launches_per_run=run["launches"][name] / n_runs,
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"], shape=r["shape"])
        if path == "serve" and name in kernels.TRAIN_PATH:
            # Also on the training path: hold those launches to their plain
            # versions too, and time them at their shapes.
            rt = measure(name, paths["train"][1][name])
            entry.update(
                max_abs_err=max(r["err"], rt["err"]),
                train_launches=train["launches"][name],
                train_launches_per_run=train["launches"][name]
                / train["steps"],
                train_ms=rt["ms"], train_plain_ms=rt["plain_ms"],
                train_bound_ms=max(rt["bytes"] / HBM_BYTES_PER_S,
                                   rt["ops"] / F32_OPS_PER_S) * 1e3,
                train_shape=rt["shape"])
        line.append(entry)
        log(f"[kernels] {name} ({path}): agrees with plain (max_abs="
            f"{entry['max_abs_err']:.6g}); ms={r['ms']:.5f} plain_ms="
            f"{r['plain_ms']:.5f} library_ms={r['library_ms']} bound_ms="
            f"{entry['bound_ms']:.5f} ({entry['bound_by']}) launches="
            f"{entry['launches']} shape={r['shape']}"
            + (f"; on the training path: ms={entry['train_ms']:.5f} "
               f"launches={entry['train_launches']} shape="
               f"{entry['train_shape']}" if "train_ms" in entry else ""))
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
    kernel_line = phase_kernels(torch, serve, train, direct)
    profiled = phase_profile(torch, "serving frame", serve["frame"],
                             serve["stages"], N_VIEWS)
    profiled_train = phase_profile(torch, "training step", train["step"],
                                   train["stages"], 2)
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
    print(json.dumps({"kernels": kernel_line}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
