"""Command-line interface (port of `brush_tpu/cli.py`).

    python -m brush_tpu_torch.cli <dataset> [flags]      # trains on the card
    python -m brush_tpu_torch.cli <dataset> --device cpu # plain versions

Counterpart of apps/brush-cli: headless training (or ply inspection) with
the same flag surface as the reference's clap config groups
(SURVEY.md §5.6), plus an `args.txt` merge layer: a file named args.txt in
the dataset directory is parsed as CLI args and merged *under* real CLI
flags (brush-process/src/args_file.rs:14-49,114-138). The flags are the JAX
package's, plus `--device`.

    python -m brush_tpu_torch.cli scene.ply --view   # serve a ply (or a zip
                                                     # of plys) on :8080
    python -m brush_tpu_torch.cli <dataset> --view   # train, viewed live

Multi-device training: one process a device under torchrun, B views a
step shared among gcd(B, W) of the W processes (the JAX package's device
count; the others add zeros):

    torchrun --nproc-per-node N -m brush_tpu_torch.cli <dataset> \
        --views-per-batch B

Process r trains on cuda:LOCAL_RANK (or the CPU with `--device cpu`) over
NCCL when each process has a card of its own, gloo on the CPU or when
processes share a card (parallel/data_parallel.py). Only the first process
prints and writes."""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
from pathlib import Path

import torch.distributed as dist

from brush_tpu_torch.data.formats import LoadConfig
from brush_tpu_torch.data.scene import AlphaMode
from brush_tpu_torch.parallel.data_parallel import view_group
from brush_tpu_torch.process import ProcessConfig, train_process
from brush_tpu_torch.train.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="brush_tpu_torch",
        description="3D Gaussian Splatting on an NVIDIA GPU: train, or "
                    "inspect a ply.")
    p.add_argument("source", help="dataset dir/zip, or .ply to inspect")

    t = p.add_argument_group("Training options")
    t.add_argument("--total-train-iters", type=int, default=30000)
    t.add_argument("--lr-mean", type=float, default=2e-5)
    t.add_argument("--lr-mean-end", type=float, default=2e-7)
    t.add_argument("--mean-noise-weight", type=float, default=50.0)
    t.add_argument("--lr-coeffs-dc", type=float, default=2e-3)
    t.add_argument("--lr-coeffs-sh-scale", type=float, default=10.0)
    t.add_argument("--lr-opac", type=float, default=0.012)
    t.add_argument("--lr-scale", type=float, default=5e-3)
    t.add_argument("--lr-rotation", type=float, default=2e-3)
    t.add_argument("--ssim-weight", type=float, default=0.2)
    t.add_argument("--opac-decay", type=float, default=0.004)
    t.add_argument("--match-alpha-weight", type=float, default=0.1)
    t.add_argument("--lpips-loss-weight", type=float, default=0.0)
    t.add_argument("--background-color", type=str, default="0,0,0")
    t.add_argument("--background-noise-strength", type=float, default=0.1)
    t.add_argument("--random-init-scene-scale", type=float, default=None)

    r = p.add_argument_group("Refine options")
    r.add_argument("--max-splats", type=int, default=10_000_000)
    r.add_argument("--refine-every", type=int, default=200)
    r.add_argument("--growth-grad-threshold", type=float, default=0.0025)
    r.add_argument("--growth-select-fraction", type=float, default=0.25)
    r.add_argument("--growth-stop-iter", type=int, default=15000)
    r.add_argument("--split-at-screen-size", type=float, default=0.5)

    d = p.add_argument_group("Dataset options")
    d.add_argument("--max-resolution", type=int, default=1920)
    d.add_argument("--max-frames", type=int, default=None)
    d.add_argument("--eval-split-every", type=int, default=None)
    d.add_argument("--subsample-frames", type=int, default=None)
    d.add_argument("--subsample-points", type=int, default=None)
    d.add_argument("--alpha-mode", choices=["none", "transparent", "masked"],
                   default="transparent")

    pr = p.add_argument_group("Process options")
    pr.add_argument("--eval-every", type=int, default=1000)
    pr.add_argument("--export-every", type=int, default=5000)
    pr.add_argument("--export-path", type=str, default="./export_{iter}.ply")
    pr.add_argument("--start-iter", type=int, default=0)
    pr.add_argument("--seed", type=int, default=42)
    pr.add_argument("--init-count", type=int, default=10000)
    pr.add_argument("--sh-degree", type=int, default=3)
    pr.add_argument("--no-pallas", action="store_true",
                    help="use the plain PyTorch rasterizer (debug)")
    pr.add_argument("--log-every", type=int, default=50)
    pr.add_argument("--ckpt-every", type=int, default=0,
                    help="full-state checkpoint cadence (0 = off)")
    pr.add_argument("--ckpt-dir", type=str, default="./ckpt")
    pr.add_argument("--resume-from", type=str, default=None,
                    help="resume training from a checkpoint dir")
    pr.add_argument("--views-per-batch", type=int, default=1,
                    help="train on B views per step (loss = mean over "
                         "views); shared among the processes of a "
                         "torchrun launch")
    pr.add_argument("--eval-save-to-disk", type=str, default=None,
                    metavar="DIR", help="save per-view eval renders as PNGs")
    pr.add_argument("--lpips-weights", type=str, default=None,
                    help="VGG-LPIPS weights (.npz/.safetensors) enabling "
                         "the perceptual loss term")
    pr.add_argument("--device", type=str, default="cuda",
                    help="torch device to train on: cuda (the kernels) or "
                         "cpu (their plain versions)")

    v = p.add_argument_group("Viewer options")
    v.add_argument("--view", action="store_true",
                   help="serve the web viewer: of a ply / zip of plys, or "
                        "live while training on a dataset")
    v.add_argument("--port", type=int, default=8080)
    return p


def args_from_configs(tcfg: TrainConfig, lcfg: LoadConfig,
                      pcfg: ProcessConfig) -> list[str]:
    """Serialize configs back to CLI args, diffed against defaults
    (args_file.rs:53's config->args round-trip; lets callers persist
    settings as an args.txt)."""
    defaults = build_parser().parse_args(["_"])
    dt, dl, dp = configs_from_args(defaults)
    out: list[str] = []
    for cfg, dflt in ((tcfg, dt), (lcfg, dl), (pcfg, dp)):
        for f in dataclasses.fields(cfg):
            val, dval = getattr(cfg, f.name), getattr(dflt, f.name)
            if val == dval or val is None:
                continue
            flag = "--" + f.name.replace("_", "-")
            if isinstance(val, bool):
                # Only use_pallas has an inverted store_true flag.
                if f.name == "use_pallas" and not val:
                    out.append("--no-pallas")
                continue
            if isinstance(val, AlphaMode):
                val = val.value
            elif isinstance(val, tuple):
                val = ",".join(str(x) for x in val)
            out += [flag, str(val)]
    return out


def merge_args_file(argv: list[str]) -> list[str]:
    """defaults < args.txt < CLI flags (args_file.rs layered resolution)."""
    if not argv or argv[0].startswith("-"):
        return argv
    src = Path(argv[0])
    base = src if src.is_dir() else src.parent
    args_txt = base / "args.txt"
    if args_txt.is_file():
        file_args = args_txt.read_text().split()
        return [argv[0]] + file_args + argv[1:]
    return argv


def configs_from_args(a) -> tuple[TrainConfig, LoadConfig, ProcessConfig]:
    bg = tuple(float(x) for x in a.background_color.split(","))
    tcfg = TrainConfig(
        total_train_iters=a.total_train_iters, lr_mean=a.lr_mean,
        lr_mean_end=a.lr_mean_end, mean_noise_weight=a.mean_noise_weight,
        lr_coeffs_dc=a.lr_coeffs_dc, lr_coeffs_sh_scale=a.lr_coeffs_sh_scale,
        lr_opac=a.lr_opac, lr_scale=a.lr_scale, lr_rotation=a.lr_rotation,
        max_splats=a.max_splats, refine_every=a.refine_every,
        growth_grad_threshold=a.growth_grad_threshold,
        growth_select_fraction=a.growth_select_fraction,
        growth_stop_iter=a.growth_stop_iter,
        split_at_screen_size=a.split_at_screen_size,
        ssim_weight=a.ssim_weight, opac_decay=a.opac_decay,
        match_alpha_weight=a.match_alpha_weight,
        lpips_loss_weight=a.lpips_loss_weight,
        background_color=bg,
        background_noise_strength=a.background_noise_strength,
        random_init_scene_scale=a.random_init_scene_scale,
    )
    lcfg = LoadConfig(
        max_resolution=a.max_resolution, max_frames=a.max_frames,
        eval_split_every=a.eval_split_every,
        subsample_frames=a.subsample_frames,
        subsample_points=a.subsample_points,
        alpha_mode=AlphaMode(a.alpha_mode),
    )
    pcfg = ProcessConfig(
        eval_every=a.eval_every, export_every=a.export_every,
        export_path=a.export_path, start_iter=a.start_iter, seed=a.seed,
        init_count=a.init_count, sh_degree=a.sh_degree,
        use_pallas=not a.no_pallas, log_every=a.log_every,
        ckpt_every=a.ckpt_every, ckpt_dir=a.ckpt_dir,
        resume_from=a.resume_from, eval_save_to_disk=a.eval_save_to_disk,
        lpips_weights=a.lpips_weights, views_per_batch=a.views_per_batch,
    )
    return tcfg, lcfg, pcfg


def _is_view_only_source(source: str) -> bool:
    """Ply / zip-or-dir of plys with no dataset views = view, not train
    (brush-process/src/lib.rs:144 detects this the same way)."""
    if source.lower().endswith(".ply"):
        return True
    try:
        from brush_tpu_torch.data.vfs import Vfs
        vfs = Vfs(source)
        names = vfs.names()
        return (any(n.lower().endswith(".ply") for n in names)
                and not any(
                    n.lower().endswith((".json", ".bin", ".txt", ".csv"))
                    for n in names))
    except Exception:
        return False


def main(argv=None):
    argv = merge_args_file(argv if argv is not None else sys.argv[1:])
    a = build_parser().parse_args(argv)

    if a.view:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            build_parser().error("--view runs in one process, not under a "
                                 "multi-process launch")
        from brush_tpu_torch.viewer.service import serve
        if _is_view_only_source(a.source):
            serve(a.source, port=a.port, sh_degree=a.sh_degree,
                  use_pallas=not a.no_pallas, device=a.device)
            return 0
        # Train with a live viewer: snapshots + /events stream while the
        # training loop runs in this thread (the reference's GUI mode).
        from brush_tpu_torch.viewer.slot import MessageBus, Slot
        slot, bus = Slot(), MessageBus()
        serve(slot=slot, port=a.port, sh_degree=a.sh_degree,
              use_pallas=not a.no_pallas, blocking=False, bus=bus,
              device=a.device)
        print(f"viewer on http://0.0.0.0:{a.port} (training live)")
        tcfg, lcfg, pcfg = configs_from_args(a)
        for msg in train_process(
                a.source, tcfg, lcfg, pcfg, slot=slot,
                on_message=lambda m: bus.publish(
                    {"kind": m.kind, "iter": m.iter, **m.data}),
                device=a.device):
            pass
        return 0

    if a.source.lower().endswith(".ply"):
        from brush_tpu_torch.io.ply import load_splat_ply
        data = load_splat_ply(a.source)
        print(f"{a.source}: {data.num_splats} splats, "
              f"sh_coeffs={None if data.sh_coeffs is None else data.sh_coeffs.shape}, "
              f"up_axis={data.up_axis}, mode={data.render_mode}")
        return 0

    tcfg, lcfg, pcfg = configs_from_args(a)
    group, world, device = view_group(a.device)
    try:
        lead = group is None or dist.get_rank(group) == 0
        if group is not None and lead:
            sharing = math.gcd(pcfg.views_per_batch, world)
            on = "" if sharing == world else f" on {sharing} of them"
            print(f"{world} processes over {dist.get_backend(group)}, "
                  f"{pcfg.views_per_batch // sharing} views each{on} a step",
                  flush=True)
        for msg in train_process(a.source, tcfg, lcfg, pcfg, device=device,
                                 group=group):
            if lead:
                _print_message(msg)
    finally:
        if group is not None:
            dist.destroy_process_group()
    return 0


def _print_message(msg) -> None:
    """One message of the run as the CLI prints it."""
    if msg.kind == "step":
        d = msg.data
        print(f"[{msg.iter:>6}] loss={d['loss']:.4f} "
              f"splats={d['splats']} vis={d['num_visible']} "
              f"{d['sps']:.2f} it/s", flush=True)
    elif msg.kind == "refine":
        d = msg.data
        print(f"[{msg.iter:>6}] refine: +{d['added']} -{d['pruned']} "
              f"total={d['total']}", flush=True)
    elif msg.kind == "eval":
        print(f"[{msg.iter:>6}] eval: PSNR={msg.data['psnr']:.2f} "
              f"SSIM={msg.data['ssim']:.4f}", flush=True)
    elif msg.kind == "export":
        print(f"[{msg.iter:>6}] exported {msg.data['path']}", flush=True)
    elif msg.kind == "checkpoint":
        print(f"[{msg.iter:>6}] checkpoint -> {msg.data['path']}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
