"""The dataset-to-PLY run of `brush_tpu_torch` (process.py, cli.py,
train/checkpoint.py, utils/{telemetry,report}.py) on the CPU, through the
plain versions of every kernel.

  * Mirrors of tests/test_process_e2e.py, tests/test_checkpoint.py,
    tests/test_cli_config.py and tests/test_report.py on the port alone:
    the message stream with refine, eval, LOD, telemetry and the report;
    the compressed export; overflow seen at a non-log step, on the plain
    rasterizer and on the kernel path (whose chunk leg must grow); batched
    views; the eval cache decoding once; the exact checkpoint round trip,
    the generator included; resume; args.txt layering and the config/args
    round trip; the HTML report.
  * Two parity runs against the JAX package's `train_process` on the same
    32x32 COLMAP scene with an init.ply, background and mean noise off,
    refine off, 6 steps, one loader thread in both packages (so both see
    the same views in the same order): the port with `use_pallas=False`,
    and with `use_pallas=True` (the kernels' plain versions), each against
    JAX with `use_pallas=False` (the gradient oracle). Per-step losses
    within 1e-3 relative; every exported parameter within
    2 * lr * steps + 1e-5 of JAX's (an Adam step moves a parameter by about
    lr at most); eval PSNR within 0.05 dB.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch import cli as tcli
from brush_tpu_torch import process as tprocess
from brush_tpu_torch.data import dataloader as tloader
from brush_tpu_torch.data.formats import LoadConfig
from brush_tpu_torch.io import ply as tply
from brush_tpu_torch.models import splats as tsplats
from brush_tpu_torch.process import ProcessConfig, train_process
from brush_tpu_torch.train.config import TrainConfig

CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs several workers on the
    machine's cores at once, and these tests' results do not depend on the
    thread count (the other files' tests run with their own setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(scene, tcfg, lcfg, pcfg, **kw):
    return list(train_process(str(scene), tcfg, lcfg, pcfg, device=CPU, **kw))


def _big_splats_ply(scene):
    """Three big splats at z=8 in front of the synthetic COLMAP cameras
    (at z=+4 looking +z): every view hits every tile (the init of
    tests/test_process_e2e.py's overflow tests)."""
    big = tsplats.from_raw(
        means=np.array([[0, 0, 8], [0.2, 0.1, 8], [-0.2, -0.1, 8]],
                       np.float32),
        log_scales=np.full((3, 3), np.log(4.0), np.float32),
        quats=np.tile(np.array([1, 0, 0, 0], np.float32), (3, 1)),
        sh_coeffs=np.full((3, 1, 3), 0.5, np.float32),
        raw_opacities=np.full((3,), 2.0, np.float32), device=CPU)
    (scene / "init.ply").write_bytes(tply.splats_to_ply_bytes(big))


# --------------------------------------------------------------------------
# mirrors of tests/test_process_e2e.py
# --------------------------------------------------------------------------


def test_train_process_stream(tmp_path):
    write_colmap_bin(tmp_path / "scene", n_views=3, w=32, h=32)
    out = tmp_path / "out_{iter}.ply"
    tcfg = TrainConfig(total_train_iters=12, refine_every=6,
                       growth_grad_threshold=1e-6, lod_levels=1,
                       lod_refine_steps=2, lod_decimation_keep=50,
                       lod_image_scale=50)
    lcfg = LoadConfig(max_resolution=32, eval_split_every=3)
    pcfg = ProcessConfig(eval_every=12, export_every=0, log_every=6,
                         export_path=str(out), init_count=0, sh_degree=1,
                         use_pallas=False)
    seen = []
    msgs = _run(tmp_path / "scene", tcfg, lcfg, pcfg, on_message=seen.append,
                telemetry_dir=str(tmp_path / "telemetry"))
    kinds = [m.kind for m in msgs]
    assert {"step", "refine", "eval", "report"} <= set(kinds)
    # The JAX package's order within an iteration.
    at12 = [m.kind for m in msgs if m.iter == 12 and "lod_level"
            not in m.data]
    assert at12 == ["step", "eval", "export", "report"]
    assert [m.kind for m in seen] == ["step", "refine", "step", "eval"]
    exports = [m for m in msgs if m.kind == "export"]
    assert any(m.data.get("final") for m in exports)
    assert any(m.data.get("lod_level") == 1 for m in exports)
    final = tply.load_splat_ply(str(tmp_path / "out_12.ply"))
    lod1 = tply.load_splat_ply(str(tmp_path / "out_12_lod1.ply"))
    assert final.num_splats > 0
    assert 0 < lod1.num_splats <= int(final.num_splats * 0.75)
    assert np.isfinite(lod1.means).all()
    stats = (tmp_path / "telemetry" / "stats.jsonl").read_text().splitlines()
    assert len(stats) >= 2
    scene = json.loads((tmp_path / "telemetry" / "scene.json").read_text())
    assert len(scene["cameras"]) == scene["n_train"] > 0
    assert list((tmp_path / "telemetry").glob("splat_dist_*.npz"))
    assert (tmp_path / "telemetry" / "report.html").exists()
    assert all(np.isfinite(m.data["loss"]) for m in msgs if m.kind == "step")


def test_compressed_export_path(tmp_path):
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    out = tmp_path / "o_{iter}.compressed.ply"
    tcfg = TrainConfig(total_train_iters=2, refine_every=1000)
    pcfg = ProcessConfig(eval_every=0, export_every=0, log_every=1,
                         export_path=str(out), init_count=0, sh_degree=1,
                         use_pallas=False)
    _run(tmp_path / "scene", tcfg, LoadConfig(max_resolution=32), pcfg)
    d = tply.load_splat_ply(str(tmp_path / "o_2.compressed.ply"))
    assert d.num_splats > 0 and np.isfinite(d.means).all()
    raw = (tmp_path / "o_2.compressed.ply").stat().st_size
    assert raw < d.num_splats * 4 * 17


@pytest.mark.parametrize("use_pallas", [False, True])
def test_overflow_detected_at_non_log_step(tmp_path, use_pallas):
    """Start with 1-slot intersection and chunk capacities: an overflow is
    reported at a step that is not a log step, training goes on with grown
    caps, and on the kernel path (the plain versions here) the chunk leg
    grows too."""
    from brush_tpu_torch.constants import TILE_WIDTH
    dim = 3 * TILE_WIDTH
    write_colmap_bin(tmp_path / "scene", n_views=2, w=dim, h=dim)
    _big_splats_ply(tmp_path / "scene")
    tcfg = TrainConfig(total_train_iters=6 if not use_pallas else 5,
                       refine_every=1000)
    pcfg = ProcessConfig(eval_every=0, export_every=0, log_every=5,
                         export_path=str(tmp_path / "o_{iter}.ply"),
                         init_count=0, sh_degree=1, use_pallas=use_pallas,
                         init_isect_cap=1, init_chunk_cap=1)
    msgs = _run(tmp_path / "scene", tcfg, LoadConfig(max_resolution=dim),
                pcfg)
    overflows = [m for m in msgs if m.kind == "overflow"]
    assert overflows, "tiny caps did not trigger an overflow message"
    assert any(m.iter % pcfg.log_every != 0 for m in overflows)
    assert all(m.data["chunk_cap"] > 1 or m.data["isect_cap"] > 1
               for m in overflows)
    if use_pallas:
        assert any(m.data["chunk_cap"] > 1 for m in overflows)
    steps = [m for m in msgs if m.kind == "step"]
    assert steps and all(np.isfinite(m.data["loss"]) for m in steps)
    # An overflow of step k comes before the step message of step k + 1.
    order = [(m.iter, m.kind) for m in msgs if m.kind in ("overflow",
                                                         "step")]
    assert order == sorted(order, key=lambda x: (x[0], x[1] == "step"))


def test_batched_views_process(tmp_path):
    write_colmap_bin(tmp_path / "scene", n_views=4, w=32, h=32)
    tcfg = TrainConfig(total_train_iters=4, refine_every=1000)
    pcfg = ProcessConfig(eval_every=0, export_every=0, log_every=2,
                         export_path=str(tmp_path / "b_{iter}.ply"),
                         init_count=0, sh_degree=1, use_pallas=False,
                         views_per_batch=2)
    msgs = _run(tmp_path / "scene", tcfg, LoadConfig(max_resolution=32),
                pcfg)
    steps = [m for m in msgs if m.kind == "step"]
    assert [m.iter for m in steps] == [2, 4]
    assert all(np.isfinite(m.data["loss"]) for m in steps)
    assert not [m for m in msgs if m.kind == "warning"]


def test_eval_cache_decodes_once(tmp_path, monkeypatch):
    write_colmap_bin(tmp_path / "scene", n_views=4, w=32, h=32)
    tcfg = TrainConfig(total_train_iters=8, refine_every=100)
    lcfg = LoadConfig(max_resolution=32, eval_split_every=2)
    pcfg = ProcessConfig(eval_every=4, export_every=0, log_every=4,
                         export_path=str(tmp_path / "o_{iter}.ply"),
                         init_count=16, sh_degree=0, use_pallas=False)
    import brush_tpu_torch.data.scene as scene_mod
    calls = {"eval": 0, "train": 0}
    real_load = scene_mod.load_image

    def eval_counting_load(*a, **k):
        calls["eval"] += 1
        return real_load(*a, **k)

    def train_counting_load(*a, **k):
        calls["train"] += 1
        return real_load(*a, **k)

    monkeypatch.setattr(scene_mod, "load_image", eval_counting_load)
    monkeypatch.setattr(tloader, "load_image", train_counting_load)
    counts_at_eval = []
    for msg in train_process(str(tmp_path / "scene"), tcfg, lcfg, pcfg,
                             device=CPU):
        if msg.kind == "eval":
            counts_at_eval.append(calls["eval"])
    assert len(counts_at_eval) >= 2
    assert counts_at_eval[0] == 2        # 4 views, every 2nd held out
    assert counts_at_eval[-1] == counts_at_eval[0]
    assert calls["train"] >= 2


def test_train_process_refuses_what_is_not_ported(tmp_path):
    """A live viewer's slot and the LPIPS term were refused; both are
    ported (tests/test_torch_viewer.py, tests/test_torch_lpips.py) and run
    here together. What is refused now is an LPIPS weights file that is
    not there, before the first step."""
    from brush_tpu_torch.models.lpips import (
        random_lpips_arrays,
        save_lpips_npz,
    )
    from brush_tpu_torch.viewer.slot import Slot
    write_colmap_bin(tmp_path / "scene", n_views=2, w=64, h=64)
    with pytest.raises(FileNotFoundError):
        next(train_process(str(tmp_path / "scene"),
                           TrainConfig(lpips_loss_weight=0.1),
                           pcfg=ProcessConfig(lpips_weights=str(
                               tmp_path / "missing.npz")),
                           device=CPU))
    save_lpips_npz(random_lpips_arrays(0), tmp_path / "w.npz")
    slot = Slot()
    msgs = _run(tmp_path / "scene", TrainConfig(total_train_iters=2,
                                                lpips_loss_weight=0.1),
                LoadConfig(),
                ProcessConfig(lpips_weights=str(tmp_path / "w.npz"),
                              log_every=1, eval_every=0, export_every=0,
                              init_count=0, sh_degree=0,
                              export_path=str(tmp_path / "o_{iter}.ply")),
                slot=slot)
    assert [m.iter for m in msgs if m.kind == "step"] == [1, 2]
    assert slot.version == 2 and len(slot.scene_views) == 2


# --------------------------------------------------------------------------
# mirrors of tests/test_checkpoint.py
# --------------------------------------------------------------------------


def _tensors(obj, prefix=""):
    """Every tensor of a TrainState by path (None fields included)."""
    if torch.is_tensor(obj) or obj is None:
        return {prefix: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_tensors(v, f"{prefix}.{k}"))
    return out


def test_save_load_roundtrip_exact(tmp_path):
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.train import checkpoint as ck
    from brush_tpu_torch.train.splat_init import create_random_splats
    from brush_tpu_torch.train.trainer import init_train_state

    rng = np.random.default_rng(0)
    cam = Camera(position=np.array([0.0, 0.0, -4.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]),
                 fov_x=0.9, fov_y=0.9)
    splats = create_random_splats(32, [cam], rng, scene_scale_override=6.0,
                                  sh_degree=1, capacity=48, device=CPU)
    state = init_train_state(splats, 3, 2.0)
    state.opt["means"].moment1.normal_(generator=state.rng)
    state.refine.max_radius.uniform_(generator=state.rng)
    state = dataclasses.replace(state, step=state.step + 17)
    ck.save_checkpoint(tmp_path / "ck", state, iteration=17)

    meta = ck.checkpoint_meta(tmp_path / "ck")
    assert meta == dict(iteration=17, capacity=48, sh_degree=1)
    template = init_train_state(splats, 0, 2.0)
    restored = ck.load_checkpoint(tmp_path / "ck", template)
    want, got = _tensors(state), _tensors(restored)
    assert sorted(want) == sorted(got) and len(want) > 15
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == w.dtype, k
            assert torch.equal(got[k], w), k
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert torch.equal(torch.rand(5, generator=restored.rng),
                       torch.rand(5, generator=state.rng))
    # A template of another capacity is refused.
    small = init_train_state(tsplats.grow_capacity(splats, 64), 0, 2.0)
    with pytest.raises(ValueError, match="template"):
        ck.load_checkpoint(tmp_path / "ck", small)


def test_resume_through_process(tmp_path):
    from brush_tpu_torch.train.checkpoint import checkpoint_meta
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    tcfg = TrainConfig(total_train_iters=6, refine_every=1000)
    lcfg = LoadConfig(max_resolution=32)
    base = ProcessConfig(eval_every=0, export_every=0, log_every=2,
                         export_path=str(tmp_path / "o_{iter}.ply"),
                         init_count=0, sh_degree=1, use_pallas=False,
                         ckpt_every=4, ckpt_dir=str(tmp_path / "ck"))
    kinds = [m.kind for m in _run(tmp_path / "scene", tcfg, lcfg, base)]
    assert "checkpoint" in kinds
    assert checkpoint_meta(tmp_path / "ck")["iteration"] == 4
    pcfg2 = dataclasses.replace(base, ckpt_every=0,
                                resume_from=str(tmp_path / "ck"))
    steps = [m for m in _run(tmp_path / "scene", tcfg, lcfg, pcfg2)
             if m.kind == "step"]
    assert [m.iter for m in steps] == [6]
    assert all(np.isfinite(m.data["loss"]) for m in steps)
    with pytest.raises(ValueError, match="sh_degree"):
        _run(tmp_path / "scene", tcfg, lcfg,
             dataclasses.replace(pcfg2, sh_degree=2))


# --------------------------------------------------------------------------
# mirrors of tests/test_cli_config.py and tests/test_report.py
# --------------------------------------------------------------------------


def test_args_txt_merges_under_cli(tmp_path):
    (tmp_path / "args.txt").write_text(
        "--total-train-iters 123 --sh-degree 1\n")
    argv = tcli.merge_args_file([str(tmp_path), "--sh-degree", "2"])
    a = tcli.build_parser().parse_args(argv)
    assert a.total_train_iters == 123
    assert a.sh_degree == 2
    assert a.device == "cuda"


def test_config_args_roundtrip():
    a = tcli.build_parser().parse_args(
        ["scene", "--total-train-iters", "777", "--ssim-weight", "0.35",
         "--alpha-mode", "masked", "--max-resolution", "640",
         "--export-path", "x_{iter}.ply", "--no-pallas",
         "--background-color", "0.1,0.2,0.3", "--device", "cpu"])
    tcfg, lcfg, pcfg = tcli.configs_from_args(a)
    assert pcfg.use_pallas is False
    argv = ["scene"] + tcli.args_from_configs(tcfg, lcfg, pcfg)
    t2, l2, p2 = tcli.configs_from_args(tcli.build_parser().parse_args(argv))
    assert (t2, l2, p2) == (tcfg, lcfg, pcfg)


def test_defaults_serialize_empty():
    a = tcli.build_parser().parse_args(["scene"])
    assert tcli.args_from_configs(*tcli.configs_from_args(a)) == []


def test_cli_main_trains_and_inspects(tmp_path, capsys, monkeypatch):
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    export = tmp_path / "cli_{iter}.ply"
    rc = tcli.main([str(tmp_path / "scene"), "--device", "cpu",
                    "--total-train-iters", "2", "--log-every", "1",
                    "--eval-every", "0", "--sh-degree", "0",
                    "--export-path", str(export)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[     1] loss=" in out and "exported" in out
    assert tcli.main([str(tmp_path / "cli_2.ply")]) == 0
    # The COLMAP scene's 10 points seed the splats.
    assert "10 splats" in capsys.readouterr().out
    # `--view` was refused; it now serves the ply (tests/test_torch_viewer.py
    # runs the server).
    from brush_tpu_torch.viewer import service as tservice
    served = []
    monkeypatch.setattr(tservice, "serve",
                        lambda *a, **k: served.append((a, k)))
    assert tcli.main([str(tmp_path / "cli_2.ply"), "--view", "--device",
                      "cpu"]) == 0
    assert served == [((str(tmp_path / "cli_2.ply"),), dict(
        port=8080, sh_degree=3, use_pallas=True, device="cpu"))]


def test_report_from_telemetry_run(tmp_path, rng):
    from brush_tpu_torch.utils.report import write_report
    from brush_tpu_torch.utils.telemetry import TelemetryLogger
    telem = TelemetryLogger(tmp_path)
    for it in range(0, 200, 10):
        telem.log_scalars(it, loss=1.0 / (it + 1), psnr=20 + it * 0.05,
                          num_splats=1000 + it * 5)
    splats = tsplats.from_raw(
        rng.standard_normal((50, 3)).astype(np.float32),
        rng.standard_normal((50, 3)).astype(np.float32),
        rng.standard_normal((50, 4)).astype(np.float32),
        rng.standard_normal((50, 1, 3)).astype(np.float32),
        rng.standard_normal(50).astype(np.float32), capacity=64, device=CPU)
    telem.log_splat_distribution(190, splats)
    telem.log_image(190, "eval_v0", torch.rand(24, 32, 3))
    telem.log_memory(190)                # nothing on the CPU
    telem.close()
    with np.load(tmp_path / "splat_dist_000190.npz") as f:
        assert f["means"].shape == (50, 3)
    html = write_report(tmp_path).read_text()
    for frag in ("loss", "psnr", "num_splats", "data:image/png;base64",
                 "log_scales", "svg", "data-pts", "mousemove"):
        assert frag in html, frag
    assert "mem0" not in (tmp_path / "stats.jsonl").read_text()


def test_tracing_helpers(tmp_path):
    """A stage is a profiler range, named in a Chrome trace; `stages_off`
    keeps stages out of a `record_stages` block; the recorder sums each
    stage's host time, and `stage_ms` its device time (none on the CPU);
    `memory_stats` is empty without a card."""
    from torch.profiler import ProfilerActivity, profile

    from brush_tpu_torch.utils import tracing
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.stage("project"):
            torch.ones(64).cumsum(0)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "project" for e in trace["traceEvents"])
    with tracing.record_stages() as recs, tracing.stages_off():
        with tracing.stage("off"):
            pass
    assert recs.snapshot()["stages"] == {}
    with tracing.record_stages() as recs:
        for _ in range(2):
            with tracing.stage("project", device=True):
                torch.ones(64).cumsum(0)
    project = recs.snapshot()["stages"]["project"]
    assert project["count"] == 2 and project["host_ms"] > 0.0
    assert project["device_count"] == 0 and tracing.stage_ms(recs) == {}
    assert tracing.memory_stats() == {}


def test_log_memory_writes_memory_stats_under_the_jax_keys(tmp_path,
                                                           monkeypatch):
    from brush_tpu_torch.utils import tracing
    from brush_tpu_torch.utils.telemetry import TelemetryLogger
    monkeypatch.setattr(tracing, "memory_stats", lambda: {
        "cuda:1": dict(bytes_in_use=2, peak_bytes_in_use=3, bytes_limit=4),
        "cuda:0": dict(bytes_in_use=5, peak_bytes_in_use=7,
                       bytes_limit=11)})
    telem = TelemetryLogger(tmp_path)
    telem.log_memory(3)
    telem.close()
    rec = json.loads((tmp_path / "stats.jsonl").read_text())
    assert rec["step"] == 3
    assert {k: v for k, v in rec.items() if k.startswith("mem")} == dict(
        mem0_bytes_in_use=5.0, mem0_peak_bytes_in_use=7.0,
        mem0_bytes_limit=11.0, mem1_bytes_in_use=2.0,
        mem1_peak_bytes_in_use=3.0, mem1_bytes_limit=4.0)


def test_report_empty_dir_and_corrupt_lines(tmp_path):
    from brush_tpu_torch.utils.report import write_report
    assert "brush_tpu" in write_report(tmp_path).read_text()
    (tmp_path / "stats.jsonl").write_text(
        json.dumps({"step": 0, "loss": 1.0}) + "\nnot json\n"
        + json.dumps({"step": 1, "loss": 0.5}) + "\n")
    assert write_report(tmp_path).exists()


# --------------------------------------------------------------------------
# parity with the JAX package's train_process
# --------------------------------------------------------------------------

PARITY_STEPS = 6


def _parity_scene(root):
    """4 views of 32x32 (one held out for eval) and an init.ply of 160
    splats in front of the cameras."""
    write_colmap_bin(root, n_views=4, w=32, h=32)
    rng = np.random.default_rng(12)
    n = 160
    means = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            rng.uniform(7.0, 10.0, (n, 1))], 1)
    splats = tsplats.from_raw(
        means.astype(np.float32),
        np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
        rng.normal(0, 1, (n, 4)).astype(np.float32),
        rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        rng.normal(0.5, 1.0, n).astype(np.float32), device=CPU)
    (root / "init.ply").write_bytes(tply.splats_to_ply_bytes(splats))


def _parity_configs(tmp, tag, use_pallas):
    tcfg = dict(total_train_iters=PARITY_STEPS, refine_every=1000,
                background_noise_strength=0.0, mean_noise_weight=0.0)
    lcfg = dict(max_resolution=32, eval_split_every=4)
    pcfg = dict(eval_every=PARITY_STEPS, export_every=0, log_every=1,
                export_path=str(tmp / f"{tag}_{{iter}}.ply"), init_count=0,
                sh_degree=1, use_pallas=use_pallas)
    return tcfg, lcfg, pcfg


def _messages(msgs):
    losses = [m.data["loss"] for m in msgs if m.kind == "step"]
    (psnr,) = [m.data["psnr"] for m in msgs if m.kind == "eval"]
    return losses, psnr


@pytest.fixture(scope="module")
def jax_parity_run(tmp_path_factory):
    """The JAX package's run: (scene dir, per-step losses, eval PSNR,
    exported ply)."""
    from brush_tpu import process as jprocess
    from brush_tpu.data import dataloader as jloader
    from brush_tpu.data.formats import LoadConfig as JLoadConfig
    from brush_tpu.train.config import TrainConfig as JTrainConfig
    tmp = tmp_path_factory.mktemp("parity")
    _parity_scene(tmp / "scene")
    tcfg, lcfg, pcfg = _parity_configs(tmp, "jax", False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprocess, "SceneLoader",
                   functools.partial(jloader.SceneLoader, n_threads=1))
        msgs = list(jprocess.train_process(
            str(tmp / "scene"), JTrainConfig(**tcfg), JLoadConfig(**lcfg),
            jprocess.ProcessConfig(**pcfg)))
    losses, psnr = _messages(msgs)
    return tmp, losses, psnr, tply.load_splat_ply(
        str(tmp / f"jax_{PARITY_STEPS}.ply"))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_process_matches_jax(jax_parity_run, monkeypatch, use_pallas):
    tmp, want_losses, want_psnr, want = jax_parity_run
    tag = f"port{int(use_pallas)}"
    tcfg, lcfg, pcfg = _parity_configs(tmp, tag, use_pallas)
    monkeypatch.setattr(tprocess, "SceneLoader",
                        functools.partial(tloader.SceneLoader, n_threads=1))
    msgs = _run(tmp / "scene", TrainConfig(**tcfg), LoadConfig(**lcfg),
                ProcessConfig(**pcfg))
    losses, psnr = _messages(msgs)
    assert len(losses) == len(want_losses) == PARITY_STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert abs(psnr - want_psnr) <= 0.05, (psnr, want_psnr)
    got = tply.load_splat_ply(str(tmp / f"{tag}_{PARITY_STEPS}.ply"))
    assert got.num_splats == want.num_splats == 160
    t = TrainConfig()
    # The means' rate is lr_mean times the median scale (at most the
    # scene's extent here, 3) and decays from there.
    lrs = dict(means=t.lr_mean * 3.0, log_scales=t.lr_scale,
               rotations=t.lr_rotation, sh_coeffs=t.lr_coeffs_dc,
               raw_opacities=t.lr_opac)
    init = tply.load_splat_ply(str(tmp / "scene" / "init.ply"))
    for name, lr in lrs.items():
        g, w, w0 = (getattr(d, name) for d in (got, want, init))
        assert g.shape == w.shape, name
        dc = (slice(None), slice(0, 1)) if w.ndim == 3 else ...
        assert np.abs(w[dc] - w0[dc]).max() > 0, name       # trained
        assert np.abs(g - w).max() <= 2 * lr * PARITY_STEPS + 1e-5, (
            name, float(np.abs(g - w).max()))
