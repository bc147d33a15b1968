"""The control of a cell's comparison: the reference put in the program's
place and computed in bfloat16, the precision below the configurations'
float32, judged by the cell's own numbers and the harness's own verdict
(`run.verdict`) against the float32 reference; and the faults a cell can
have, planted in the float32 reference put in the program's place. Each
has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--variants bf16 half altered]

prints a JSON line a seed and variant with `correct` and each number
beside its limit, and last, for each variant, whether every seed came out
not correct and the least reading of each number over the seeds (the
upper reading a limit is set below). It runs at the cell's own sizes, on
the card; the benchmark's own runs never run it. It exits 1 if a variant
came out correct on any seed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from portbench import common  # noqa: E402
from portbench.reference import camera as C  # noqa: E402
from portbench.reference import render as R  # noqa: E402
from portbench.reference import train as RT  # noqa: E402
from portbench.run import compared_line, verdict  # noqa: E402

VARIANTS = ("bf16", "half", "altered")


def _invert_block(frame):
    """A frame with one 32x32 block of its values inverted (at (64, 64),
    or as near as the frame allows)."""
    out = frame.clone()
    y = max(min(64, out.shape[0] - 32), 0)
    x = max(min(64, out.shape[1] - 32), 0)
    out[y:y + 32, x:x + 32] = 255 - out[y:y + 32, x:x + 32]
    return out


def _half_frame(frame):
    """A frame whose lower half was left out (black)."""
    out = frame.clone()
    out[out.shape[0] // 2:] = 0
    return out


# What takes the program's place: the reference in bfloat16 (the
# control), or the float32 reference with one fault planted.
VIEW_FAULTS = {"bf16": None, "altered": _invert_block, "half": _half_frame}


def view_control(torch, cell, config, seed, device, variants) -> dict:
    """{variant: compared list} of the view cell's numbers for each
    variant in the program's place."""
    from portbench.traffic import view as V
    tr = cell["traffic_params"]
    w, h = tr["width"], tr["height"]
    scene = V.common_scene(torch, config, seed, torch.device(device))
    poses = V.orbit_poses(tr, seed)
    views = [C.orbit_view(p, tr["fov"], w, h) for p in poses]
    needs = [V.remainder_needed(torch, scene, v, tr["expand_k0"])
             for v in views]
    sample = V.check_sample(needs, tr, seed)
    want = {k: R.frame_u8(R.render(scene, views[k], (0.0,) * 3)[0])
            for k in sample}
    out = {}
    for variant in variants:
        mean_abs = tile_abs = 0.0
        for k in sample:
            if variant == "bf16":
                got = R.frame_u8(R.render(scene, views[k], (0.0,) * 3,
                                          dtype=torch.bfloat16)[0])
            else:
                got = VIEW_FAULTS[variant](want[k])
            m, t = V.compare_frames(got.cpu().numpy(), want[k].cpu().numpy())
            mean_abs, tile_abs = max(mean_abs, m), max(tile_abs, t)
        out[variant] = V.compared(cell["limits"], mean_abs, tile_abs,
                                  len(sample))
    return out


def _planted(variant: str):
    """Patch the reference for one fault; returns the undo."""
    if variant == "half":
        real = RT.image_loss

        def half(pred, gt):
            h = pred.shape[0] // 2
            return real(pred[:h], gt[:h])
        RT.image_loss = half
        return lambda: setattr(RT, "image_loss", real)
    if variant == "altered":
        real = RT._adam

        def altered(param, grad, *a, **k):
            grad = grad.clone()
            grad[:grad.shape[0] // 8] = 0.0
            return real(param, grad, *a, **k)
        RT._adam = altered
        return lambda: setattr(RT, "_adam", real)
    return lambda: None


def _follow(torch, arrays, views, gts, order, seed, tr, hp, cap, dev,
            variant):
    """The reference's followed turns with `variant` in the program's
    place (None: the float32 reference itself): (results, each array's
    change, the first real step's gradient as Adam got it)."""
    dt = torch.bfloat16 if variant == "bf16" else torch.float32
    undo = _planted(variant)
    try:
        state = RT.init_state(arrays, cap, dev)
        p0 = {k: v.clone() for k, v in state.params.items()}
        res, n_real, grads = [], 0, None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        caps = dict(isect=hp.init_isect_cap, chunk=hp.init_chunk_cap)
        for i in order:
            r = RT.step(state, views[i], gts[i], gen, caps, hp, dt)
            if res:
                RT.grow_caps(caps, res[-1])
            res.append(r)
            n_real += not r.overflowed
            if n_real == 1 and grads is None:
                # The gradient as the optimizer got it, read from its
                # state after the first step, as a run reads the program's.
                grads = {k: state.m1[k] / (1.0 - RT.BETA1)
                         for k in RT.NAMES}
            if n_real >= tr["follow_real_turns"]:
                break
    finally:
        undo()
    return res, {k: state.params[k] - p0[k] for k in RT.NAMES}, grads


def train_control(torch, cell, config, seed, device, variants) -> dict:
    """{variant: compared list} of the train cell's numbers for each
    variant in the program's place."""
    import numpy as np

    from portbench.traffic import train as T
    tr = cell["traffic_params"]
    dev = torch.device(device)
    views, pngs, init = T.make_inputs(torch, tr, config, seed, dev)
    gts = [torch.from_numpy(p).to(dev).float() / 255.0 for p in pngs]
    order = np.random.default_rng(seed).permutation(len(views))
    order = [int(i) for i in order[:tr["follow_max_turns"]]]
    cap = 1 << max(10, math.ceil(math.log2(2 * config["num_splats"])))
    hp = RT.Hyper(**tr.get("reference", {}))
    arrays = {k: v.numpy() for k, v in init.items()}
    args = (torch, arrays, views, gts, order, seed, tr, hp, cap, dev)
    ref, ref_change, _ = _follow(*args, None)
    first_r = next(r for r in ref if not r.overflowed)
    leaves = T.counted_leaves(first_r.grads)
    out = {}
    for variant in variants:
        ctl, ctl_change, ctl_g = _follow(*args, variant)
        flags = sum(int(a.overflowed != b.overflowed)
                    for a, b in zip(ref, ctl))
        loss_gap = max([T.gap(c.loss, r.loss, RT.SSIM_WEIGHT)
                        for r, c in zip(ref, ctl) if not r.overflowed
                        and not c.overflowed] or [math.inf])
        grad_gap = (math.inf if ctl_g is None else
                    T.leaf_gaps(ctl_g, first_r.grads, leaves)[0])
        change_gap = T.leaf_gaps(ctl_change, ref_change, leaves)[0]
        out[variant] = T.compared(cell["limits"], flags, loss_gap, grad_gap,
                                  change_gap)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["bf16"],
                    choices=VARIANTS,
                    help="bf16: the control; half: half the image left out "
                    "(of the loss, or of the frame); altered: an answer "
                    "altered where it is made (the gradient of the first "
                    "eighth of the rows zeroed, or a block of the frame "
                    "inverted)")
    args = ap.parse_args(argv)
    common.cache_env()
    cell, config = common.load_cell(args.workload)
    import torch
    common.require_cards(torch, cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = {"view": view_control, "train": train_control}[cell["traffic_kind"]]
    summary = {v: dict(all_not_correct=True, least={})
               for v in args.variants}
    for seed in args.seeds:
        got = fn(torch, cell, config, seed, "cuda", args.variants)
        for variant, cmp in got.items():
            correct = verdict(cmp)
            print(json.dumps(dict(seed=seed, variant=variant,
                                  correct=correct,
                                  compared=compared_line(cmp))), flush=True)
            s = summary[variant]
            s["all_not_correct"] = s["all_not_correct"] and not correct
            for name, value, *_ in cmp:
                s["least"][name] = min(s["least"].get(name, math.inf),
                                       value)
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds,
                          variants=summary)))
    return 0 if all(s["all_not_correct"] for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
