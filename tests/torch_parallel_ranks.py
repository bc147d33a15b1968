"""Processes of a `torch.distributed` group for the multi-device tests of
`brush_tpu_torch` (tests/test_torch_parallel.py on the CPU over gloo,
tests/test_torch_cuda.py on the card).

    python tests/torch_parallel_ranks.py JOB RANK WORLD STORE OUT

JOB is a list of tasks written with `torch.save` by `run_ranks`; each
process joins the group through the file store STORE (gloo, 60 s
timeout), runs the tasks in order and writes its results to
OUT/rank<RANK>.pt. This module imports torch and brush_tpu_torch only: the
CPU test module imports JAX, which the ranks must not load.
"""

from __future__ import annotations

import datetime
import functools
import hashlib
import os
import pathlib
import subprocess
import sys
import time

import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 60     # a collective that waits longer fails the rank
JOIN_TIMEOUT_S = 180     # the whole group, from start to exit


def run_ranks(tmp: pathlib.Path, world: int, tasks: list,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run `tasks` in `world` processes of one gloo group; returns each
    rank's results. A rank that fails or outlives `timeout` fails the
    call, after every rank was killed."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(tasks, tmp / "job.pt")
    store = tmp / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)).rstrip(os.pathsep))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp / "job.pt"), str(r), str(world),
         str(store), str(tmp)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=REPO) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(
            f"--- rank {r} (exit {c}):\n"
            + (tmp / f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f"ranks exited {codes} (a negative code is a "
                             f"kill, at the {timeout} s limit)\n{tails}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by name, the generator's state too."""
    out = {"step": state.step, "median_scale": state.median_scale,
           "rng": state.rng.get_state()}
    for name, value in state.splats.params().items():
        out[f"splats.{name}"] = value
    out["splats.n_alive"] = state.splats.n_alive
    if state.splats.min_scale is not None:
        out["splats.min_scale"] = state.splats.min_scale
    for name, st in state.opt.items():
        out[f"opt.{name}.moment1"] = st.moment1
        out[f"opt.{name}.moment2"] = st.moment2
    for name in ("refine_weight", "visible_count", "max_radius"):
        out[f"refine.{name}"] = getattr(state.refine, name)
    for name in ("bounds_center", "bounds_extent"):
        if getattr(state, name) is not None:
            out[name] = getattr(state, name)
    return out


def state_digest(state) -> dict:
    """sha256 of every tensor of a TrainState, by name: equal digests are
    bit-identical replicas."""
    return {k: hashlib.sha256(
        v.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        if v.dim() else v.detach().cpu().reshape(1).view(torch.uint8)
        .numpy().tobytes()).hexdigest()
        for k, v in state_tensors(state).items()}


def _to(x, dev):
    """Tensors of a task moved to the rank's device (the generator too)."""
    import dataclasses
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=dev)
        g.set_state(x.get_state())
        return g
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))
            or isinstance(getattr(x, f.name), (dict, torch.Generator))
            or dataclasses.is_dataclass(getattr(x, f.name))})
    return x


def task_strip(group, dev, t):
    """`render_space_parallel` of one scene."""
    from brush_tpu_torch.parallel.tile_parallel import render_space_parallel
    with torch.no_grad():
        img = render_space_parallel(_to(t["splats"], dev), t["cam"],
                                    t["bg"], t["rcfg"], group)
    return img.cpu()


def task_dp(group, dev, t):
    """`steps` DP steps from one state (with the test's noise samples when
    it gives them), each step's loss and state digest; then, when asked, a
    refine and one more step."""
    from brush_tpu_torch.parallel.data_parallel import make_dp_train_step
    from brush_tpu_torch.train import trainer
    from brush_tpu_torch.train.refine import refine_step
    if t.get("noise") is not None:
        bg, mean = t["noise"]
        trainer.sample_background_noise = (
            lambda rng, n, s, d: bg.clone().to(d))
        trainer.sample_mean_noise = lambda rng, shape, d: mean.clone().to(d)
    state, batch = _to(t["state"], dev), _to(t["batch"], dev)
    step = make_dp_train_step(group, t["tcfg"], t["rcfg"])
    out = {"losses": [], "digests": []}
    try:
        for _ in range(t["steps"]):
            state, stats, _ = step(state, batch)
            out["losses"].append(float(stats.loss))
            out["digests"].append(state_digest(state))
    except ValueError as e:
        return {"error": str(e)}
    out["state"] = {k: v.cpu() for k, v in state_tensors(state).items()}
    if t.get("refine") is not None:
        centers, focals = _to(t["refine"], dev)
        state, _ = refine_step(state, t["tcfg"], centers, focals)
        out["refined_digest"] = state_digest(state)
        state, stats, _ = step(state, batch)
        out["after_refine"] = dict(
            loss=float(stats.loss), n_alive=int(state.splats.n_alive),
            finite=all(bool(torch.isfinite(v).all())
                       for v in state.splats.params().values()),
            digest=state_digest(state))
    return out


def task_process(group, dev, t):
    """`train_process` of a dataset with one loader thread: the messages,
    the paths each process exported to and the final state's digest."""
    from brush_tpu_torch import process
    from brush_tpu_torch.data.dataloader import SceneLoader
    process.SceneLoader = functools.partial(SceneLoader, n_threads=1)
    last, exports = {}, []
    real_refine, real_export = process._refine_turn, process._export_splats

    def refine_turn(loop, *a, **k):
        loop, msgs = real_refine(loop, *a, **k)
        last["loop"] = loop
        return loop, msgs

    def export(path, splats):
        exports.append(path)
        return real_export(path, splats)

    process._refine_turn, process._export_splats = refine_turn, export
    try:
        msgs = list(process.train_process(
            t["source"], t["tcfg"], t["lcfg"], t["pcfg"], device=dev,
            group=group))
    except ValueError as e:
        return {"error": str(e)}
    finally:
        process._refine_turn, process._export_splats = (real_refine,
                                                        real_export)
    return {"messages": [(m.kind, m.iter, m.data) for m in msgs],
            "exports": exports,
            "digest": state_digest(last["loop"].state)}


TASKS = {"strip": task_strip, "dp": task_dp, "process": task_process}


def main(argv) -> int:
    job, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tasks = torch.load(job, weights_only=False)
    dev = torch.device(tasks[0].get("device", "cpu")) if tasks else "cpu"
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = [TASKS[t["kind"]](dist.group.WORLD, dev, t)
                   for t in tasks]
        # Every rank finished every task before any writes its results.
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, pathlib.Path(out) / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
