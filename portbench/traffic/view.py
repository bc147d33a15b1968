"""One viewer user orbiting a scene: a closed loop of
`ViewerState.render_pose` calls, each waiting for its frame (a host uint8
array) before the next is asked for.

Set-up: the configuration's scene made on the card from the seed and put
into a `Slot`; the orbit's poses (one set at a radius: yaw evenly over the
full circle, elevation spread over a band), in an order drawn from the
seed; the
viewer's remainder capacity set to what the worst pose needs at its
expand_k0, counted by the reference and rounded up to the {2^k, 1.5 2^k}
grid; two frames to capture the viewer's render graph and replay it.
Window: the poses in turn until `seconds` have passed. After it: the
frames of a sample of poses drawn from the seed, the worst pose among
them, against the reference's frames of the same poses. A traced run
profiles `trace_frames` frames inside the window; the other frames are
its untraced part, whose host time a frame and graph replays' host time
the per-layer readers take.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench import common
from portbench.reference import camera as C
from portbench.reference import render as R


def round_cap(n: int, minimum: int = 1 << 13) -> int:
    """Round up to the {2^k, 1.5 * 2^k} grid."""
    n = max(int(n), minimum)
    p = 1 << max(int(math.ceil(math.log2(n))) - 1, 0)
    for cap in (p, p + p // 2, 2 * p, 3 * p):
        if cap >= n:
            return cap
    return 4 * p


def orbit_poses(traffic: dict, seed: int) -> list[np.ndarray]:
    """The orbit's camera positions: the same set for every seed (yaw
    evenly over the full circle, elevation spread over the band by the
    golden ratio's low-discrepancy sequence), in an order drawn from the
    seed."""
    n = traffic["poses"]
    i = np.arange(n)
    yaw = 2.0 * math.pi * i / n
    el = traffic["elevation"] * (2.0 * ((i * 0.6180339887498949) % 1.0)
                                 - 1.0)
    order = np.random.default_rng(common.seed_stream(seed, 1)).permutation(n)
    r = traffic["radius"]
    return [np.array([r * math.cos(e) * math.sin(y), r * math.sin(e),
                      -r * math.cos(e) * math.cos(y)])
            for y, e in zip(yaw[order], el[order])]


def remainder_needed(torch, scene: dict, view, k0: int) -> int:
    """Slots past each splat's first k0 that `view` needs."""
    with torch.no_grad():
        p = R.project(scene["means"], scene["log_scales"], scene["quats"],
                      scene["sh_coeffs"], scene["raw_opacities"], view)
        counts = R.slot_counts(p, view.width, view.height)
        return int(torch.clamp_min(counts - k0, 0).sum())


def check_sample(needs: list[int], traffic: dict, seed: int) -> list[int]:
    """The poses whose frames are checked: the one that needs the most
    slots and others drawn from the seed, `check_poses` in all."""
    rng = np.random.default_rng(common.seed_stream(seed, 2))
    worst = int(np.argmax(needs))
    others = [i for i in rng.permutation(len(needs)).tolist() if i != worst]
    return sorted([worst] + others[:traffic["check_poses"] - 1])


def compare_frames(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """Mean |difference| in 8-bit levels over the frame, and over the
    worst 32x32 tile."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).astype(
        np.float64)
    h, w, _ = d.shape
    th, tw = -(-h // R.TILE), -(-w // R.TILE)
    pad = np.zeros((th * R.TILE, tw * R.TILE, 3))
    cnt = np.zeros((th * R.TILE, tw * R.TILE, 1))
    pad[:h, :w] = d
    cnt[:h, :w] = 1
    tiles = pad.reshape(th, R.TILE, tw, R.TILE, 3).sum(axis=(1, 3, 4))
    n = cnt.reshape(th, R.TILE, tw, R.TILE, 1).sum(axis=(1, 3, 4)) * 3
    return float(d.mean()), float((tiles / n).max())


def compared(lim: dict, mean_abs: float, tile_abs: float,
             checked: int) -> list:
    """The numbers of a view cell's comparison beside its limits."""
    return [["frame_mean_abs", mean_abs, lim["frame_mean_abs"]],
            ["tile_mean_abs_max", tile_abs, lim["tile_mean_abs_max"]],
            ["poses_checked", float(checked), lim["poses_checked_min"],
             "min"]]


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    import torch

    from brush_tpu_torch.graphs import RENDER_GRAPHS
    from brush_tpu_torch.models.splats import Splats
    from brush_tpu_torch.viewer.service import ViewerState
    from brush_tpu_torch.viewer.slot import Slot

    from portbench.trace import GraphClock, Tracer

    tr = cell["traffic_params"]
    w, h = tr["width"], tr["height"]
    dev = torch.device(device)
    marks = {"imported": common.process_age_s()}
    scene = common_scene(torch, config, seed, dev)
    host = {k: v.cpu() for k, v in scene.items()}
    poses = orbit_poses(tr, seed)
    views = [C.orbit_view(p, tr["fov"], w, h) for p in poses]
    needs = [remainder_needed(torch, scene, v, tr["expand_k0"])
             for v in views]
    cap = round_cap(max(needs) * tr["cap_margin"])
    marks["cap_counted"] = common.process_age_s()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    n = config["num_splats"]
    slot = Slot()
    slot.set(0, Splats(means=scene["means"], log_scales=scene["log_scales"],
                       quats=scene["quats"], sh_coeffs=scene["sh_coeffs"],
                       raw_opacities=scene["raw_opacities"],
                       n_alive=torch.tensor(n, dtype=torch.int32,
                                            device=dev)))
    del scene
    state = ViewerState(slot, sh_degree=config["sh_degree"], isect_cap=cap,
                        device=dev)

    def frame(i):
        return state.render_pose(poses[i % len(poses)], 0.0, 0.0, w, h, 0,
                                 fov=tr["fov"])

    for i in range(tr["warmup_frames"]):
        frame(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    sample = check_sample(needs, tr, seed)
    kept: dict[int, np.ndarray] = {}
    tracer = Tracer(torch) if trace else None
    clock = GraphClock(torch, trace)
    lo = tr["trace_after_frames"] if trace else -1
    hi = lo + tr["trace_frames"] if trace else -1
    traced, untraced = [], []
    times = []
    setup_s = common.process_age_s()
    clock.window = clock.timing = True
    t0 = time.perf_counter()
    i = 0
    try:
        while True:
            if i == lo:
                clock.timing = False
                tracer.begin()
            ts = time.perf_counter()
            out = frame(i)
            te = time.perf_counter()
            times.append(te - ts)
            k = i % len(poses)
            if lo <= i < hi:
                traced.append(k)
                if i == hi - 1:
                    tracer.end()
                    clock.timing = True
            else:
                untraced.append(te - ts)
            if k in sample:
                kept[k] = out
            i += 1
            if te - t0 >= seconds:
                break
        window = te - t0
        if tracer is not None and tracer.prof is not None:
            tracer.end()
    finally:
        clock.restore()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, slot, out
    RENDER_GRAPHS.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = {k: v.to(dev) for k, v in host.items()}
    mean_abs, tile_abs = 0.0, 0.0
    checked = []
    for k in sorted(kept):
        img, _ = R.render(ref, views[k], (0.0, 0.0, 0.0))
        want = R.frame_u8(img).cpu().numpy()
        m, t = compare_frames(kept[k], want)
        mean_abs, tile_abs = max(mean_abs, m), max(tile_abs, t)
        checked.append(k)
    work = None
    if tracer is not None and tracer.summary() is not None:
        from portbench.work import frame_work
        works = []
        for k in traced:
            counts = R.BlendCounts(n, dev)
            _, bins = R.render(ref, views[k], (0.0, 0.0, 0.0),
                               counts=counts)
            works.append(frame_work(dict(
                n_live=n, n_visible=int((bins.counts > 0).sum()),
                pixels=w * h, tiles=bins.start.numel(),
                slots=bins.num_slots, evaluated=counts.evaluated,
                blended=counts.blended)))
        work = dict(flops=sum(x["flops"] for x in works),
                    kernel_least_s={
                        kk: sum(x["kernel_least_s"][kk] for x in works)
                        for kk in works[0]["kernel_least_s"]},
                    units=len(works))
    lim = cell["limits"]
    return dict(
        e2e=dict(frame_ms=1e3 * window / len(times),
                 frame_p95_ms=1e3 * float(np.percentile(times, 95.0)),
                 peak_mem_mib=peak / 2 ** 20, setup_s=setup_s),
        attempted=len(times), failed=0, peak_bytes=peak,
        window_s=window, units_name="frames",
        trace=tracer.summary() if tracer is not None else None,
        trace_units=len(traced), work=work,
        untraced=dict(s=float(sum(untraced)), units=len(untraced)),
        replays=clock.replays_line() if trace else None,
        compared=compared(lim, mean_abs, tile_abs, len(checked)),
        notes=dict(isect_cap=cap, worst_pose_slots=max(needs),
                   captures_in_window=clock.captures,
                   poses_checked=checked, setup_marks_s=marks))


def common_scene(torch, config: dict, seed: int, dev):
    from portbench.scene import bench_scene
    return bench_scene(config["num_splats"], common.seed_stream(seed, 0),
                       config["sh_degree"], dev)
