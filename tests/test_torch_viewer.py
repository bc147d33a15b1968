"""The web viewer of `brush_tpu_torch` (viewer/{slot,service}.py, the live
view of process.py, `cli --view`) on the CPU, through the plain versions
of the kernels.

  * Mirrors of tests/test_viewer.py on the port: animation zips, the HTTP
    render endpoint, the JS API (brush.js, the splat buffer, the /events
    stream), the render knobs, URL sources.
  * Parity with the JAX package's viewer on the same PLY: `render_pose`
    uint8 frames for the orbit pose, a pose from a quaternion and fovy, a
    splat scale and a background, with `use_pallas=True` (the kernels'
    plain versions) and `use_pallas=False`, held to
    tests/test_torch_render.py's rule converted to levels (that rule is
    p99.9 of |d| <= 1e-4 and max <= 2/255 on [0, 1] floats; truncation to
    a level turns a difference under 1/255 into at most one level):
    p99.9 of the level difference <= 1 and its max <= 2. The splat buffer
    bytes, /info and /views JSON equal; the progressive load's last frame
    equal to the JAX package's and to a one-shot load.
  * A `train_process(slot=...)` run: the snapshot published at one log
    step is unchanged after later steps and a refine.
  * `cli.main([<ply>, "--view"])` and `cli.main([<dataset>, "--view"])`
    with `serve` patched so it does not block.
"""

import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch import cli as tcli
from brush_tpu_torch.io.ply import save_splat_ply
from brush_tpu_torch.viewer import service as tservice
from brush_tpu_torch.viewer.service import Slot, load_source_into_slot, serve
from brush_tpu_torch.viewer.slot import MessageBus

CPU = "cpu"


def write_ply(path, n=32, seed=0, shift=0.0, sh_coeffs=1):
    rng = np.random.default_rng(seed)
    save_splat_ply(
        str(path),
        means=rng.normal(shift, 0.5, (n, 3)),
        log_scales=np.full((n, 3), np.log(0.1)),
        quats=np.tile([1, 0, 0, 0], (n, 1)).astype(np.float32),
        sh_coeffs=rng.normal(0, 0.3, (n, sh_coeffs, 3)),
        raw_opacities=np.full(n, 1.0),
    )


def _get(port, path, timeout=300):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout).read()


# --------------------------------------------------------------------------
# mirrors of tests/test_viewer.py
# --------------------------------------------------------------------------


def test_animation_zip_frames(tmp_path):
    for i in range(3):
        write_ply(tmp_path / f"frame_{i}.ply", seed=i, shift=0.2 * i)
    zp = tmp_path / "anim.zip"
    with zipfile.ZipFile(zp, "w") as z:
        for i in range(3):
            z.write(tmp_path / f"frame_{i}.ply", f"frame_{i}.ply")
    slot = Slot()
    load_source_into_slot(str(zp), slot, sh_degree=0, device=CPU)
    assert slot.n_frames == 3
    s0, s2 = slot.get(0), slot.get(2)
    assert int(s0.n_alive) == 32
    assert s0.means.device.type == CPU
    assert not np.allclose(s0.means[:32].numpy(), s2.means[:32].numpy())


def test_http_render_endpoint(tmp_path):
    write_ply(tmp_path / "scene.ply")
    server = serve(str(tmp_path / "scene.ply"), port=0, sh_degree=0,
                   use_pallas=False, blocking=False, device=CPU)
    try:
        port = server.server_address[1]
        info = json.loads(_get(port, "/info", 60))
        assert info["n_splats"] == 32
        assert info["n_frames"] == 1

        img_bytes = _get(port, "/render?px=0&py=0&pz=-4&w=64&h=48")
        from PIL import Image
        img = Image.open(io.BytesIO(img_bytes))
        assert img.size == (64, 48)

        html = _get(port, "/", 60)
        assert b"brush_tpu" in html

        # Unknown path -> 404.
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope", 60)
    finally:
        server.shutdown()
        server.server_close()


def test_js_api_endpoints(tmp_path):
    """brush.js client library + binary splat buffer + SSE message stream
    (counterpart of the reference's JS API, apps/brush-js/src/lib.rs)."""
    write_ply(tmp_path / "scene.ply", n=16)
    bus = MessageBus()
    server = serve(str(tmp_path / "scene.ply"), port=0, sh_degree=0,
                   use_pallas=False, blocking=False, bus=bus, device=CPU)
    try:
        port = server.server_address[1]
        js = _get(port, "/brush.js", 60)
        assert b"class BrushClient" in js

        raw = _get(port, "/splats?frame=0", 60)
        magic, version, count, sh_coeffs = struct.unpack_from("<4sIII", raw)
        assert magic == b"BSPL" and version == 1
        assert count == 16 and sh_coeffs == 1
        body = np.frombuffer(raw, np.float32, offset=16)
        # means(3) + log_scales(3) + quats(4) + sh(C*3) + opacity(1)
        assert body.size == count * (3 + 3 + 4 + sh_coeffs * 3 + 1)
        means = body[:count * 3].reshape(count, 3)
        assert np.isfinite(means).all()

        # SSE stream delivers published training messages. Publish from a
        # background thread until received: the subscription only exists
        # once the /events handler runs, so a single publish could race it.
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/events", timeout=60)
        got = threading.Event()

        def pump():
            while not got.is_set():
                bus.publish({"kind": "step", "iter": 7, "loss": 0.5})
                time.sleep(0.1)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            line = resp.readline()
            while not line.startswith(b"data:"):
                line = resp.readline()
        finally:
            got.set()
        msg = json.loads(line[5:].strip())
        assert msg["iter"] == 7 and msg["kind"] == "step"
        resp.close()
    finally:
        server.shutdown()
        server.server_close()


def test_render_params_scale_fov_bg(tmp_path):
    """Viewer render knobs: splat-scale slider, fov, background color
    (reference viewer Appendix F capabilities)."""
    write_ply(tmp_path / "scene.ply", n=8)
    server = serve(str(tmp_path / "scene.ply"), port=0, sh_degree=0,
                   use_pallas=False, blocking=False, device=CPU)
    try:
        port = server.server_address[1]

        def grab(qs):
            from PIL import Image
            data = _get(port, f"/render?px=0&py=0&pz=-30&w=32&h=32&{qs}")
            return np.asarray(Image.open(io.BytesIO(data)), np.float32)

        base = grab("")
        big = grab("scale=3.0")
        red_bg = grab("bg=1,0,0")
        wide = grab("fov=2.2")
        assert np.abs(big - base).max() > 3      # bigger splats
        assert red_bg[..., 0].mean() > base[..., 0].mean() + 10
        assert np.abs(wide - base).max() > 3     # zoomed out
    finally:
        server.shutdown()
        server.server_close()


def test_url_source_zip(tmp_path):
    """URL data sources: a zip served over HTTP loads like a local zip
    (brush-vfs data_source.rs Url arm)."""
    import functools
    import http.server

    for i in range(2):
        write_ply(tmp_path / f"f_{i}.ply", seed=i)
    zp = tmp_path / "anim.zip"
    with zipfile.ZipFile(zp, "w") as z:
        for i in range(2):
            z.write(tmp_path / f"f_{i}.ply", f"f_{i}.ply")

    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=str(tmp_path))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/anim.zip"
        slot = Slot()
        load_source_into_slot(url, slot, sh_degree=0, device=CPU)
        assert slot.n_frames == 2
        assert int(slot.get(1).n_alive) == 32
    finally:
        httpd.shutdown()
        httpd.server_close()


# --------------------------------------------------------------------------
# parity with the JAX package's viewer
# --------------------------------------------------------------------------

# (pos, render_pose keywords): the orbit pose, a pose from a quaternion and
# fovy (10 degrees about y, looking at the scene), a splat scale, a
# background colour.
POSES = {
    "orbit": ([0.6, 0.4, -4.0], {}),
    "quat": ([0.3, -0.2, -4.0], dict(quat=(0.9961947, 0.0, -0.0871557, 0.0),
                                     fov=1.1, fov_y=0.8)),
    "scale": ([0.0, 0.5, -4.5], dict(splat_scale=2.5)),
    "bg": ([-0.5, 0.2, -4.0], dict(bg=(0.2, 0.5, 0.9))),
}


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    path = tmp_path_factory.mktemp("viewer") / "scene.ply"
    write_ply(path, n=96, seed=5, sh_coeffs=4)
    return path


def _jax_state(path, use_pallas):
    from brush_tpu.viewer import service as jservice
    slot = jservice.Slot()
    mode = jservice.load_source_into_slot(str(path), slot, sh_degree=1)
    return jservice.ViewerState(slot, 1, use_pallas=use_pallas,
                                mip_splatting=mode == "mip")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_render_pose_matches_jax(scene_ply, use_pallas):
    jstate = _jax_state(scene_ply, use_pallas)
    slot = Slot()
    load_source_into_slot(str(scene_ply), slot, sh_degree=1, device=CPU)
    tstate = tservice.ViewerState(slot, 1, use_pallas=use_pallas, device=CPU)
    for name, (pos, kw) in POSES.items():
        want = jstate.render_pose(pos, 0.0, 0.0, 64, 48, 0, **kw)
        got = tstate.render_pose(pos, 0.0, 0.0, 64, 48, 0, **kw)
        assert got.dtype == want.dtype == np.uint8, name
        assert got.shape == want.shape == (48, 64, 3), name
        assert want.max() > 20, f"{name}: the pose sees nothing"
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert np.quantile(d, 0.999) <= 1 and d.max() <= 2, (
            name, np.quantile(d, 0.999), d.max())


def test_buffers_and_json_match_jax(tmp_path, scene_ply):
    """`splat_buffer` bytes, /info and /views of the two packages' servers:
    a PLY, and a live slot with a dataset attached."""
    from brush_tpu import process as jprocess
    from brush_tpu.data.formats import LoadConfig as JLoadConfig
    from brush_tpu.data.formats import load_dataset as jload_dataset
    from brush_tpu.viewer import service as jservice

    from brush_tpu_torch import process as tprocess
    from brush_tpu_torch.data.formats import LoadConfig, load_dataset

    jstate = _jax_state(scene_ply, True)
    slot = Slot()
    load_source_into_slot(str(scene_ply), slot, sh_degree=1, device=CPU)
    tstate = tservice.ViewerState(slot, 1, device=CPU)
    raw = tstate.splat_buffer(0)
    assert raw == jstate.splat_buffer(0)
    assert len(raw) == 16 + 96 * (3 + 3 + 4 + 4 * 3 + 1) * 4
    assert tstate.splat_buffer(3) == raw          # latest frame
    assert Slot().get(0) is None
    assert (tservice.ViewerState(Slot(), 1, device=CPU).splat_buffer(0)
            == jservice.ViewerState(jservice.Slot(), 1).splat_buffer(0))

    write_colmap_bin(tmp_path / "scene", n_views=4, w=32, h=32)
    jslot, tslot = jservice.Slot(), Slot()
    jprocess._attach_scene_to_slot(
        jslot, jload_dataset(str(tmp_path / "scene"),
                             JLoadConfig(eval_split_every=2)), None)
    tprocess._attach_scene_to_slot(
        tslot, load_dataset(str(tmp_path / "scene"),
                            LoadConfig(eval_split_every=2)))
    jslot.set(0, jstate.slot.get(0))
    tslot.set(0, slot.get(0))
    servers = [jservice.serve(slot=jslot, port=0, host="127.0.0.1",
                              sh_degree=1, blocking=False),
               serve(slot=tslot, port=0, host="127.0.0.1", sh_degree=1,
                     blocking=False, device=CPU)]
    try:
        jport, tport = (s.server_address[1] for s in servers)
        for path in ("/info", "/views"):
            want = json.loads(_get(jport, path, 60))
            assert json.loads(_get(tport, path, 60)) == want, path
        assert len(want) == 4 and {v["split"] for v in want} == {"train",
                                                                "eval"}
        assert _get(tport, "/gt?view=1&maxdim=32", 60) == _get(
            jport, "/gt?view=1&maxdim=32", 60)
        with pytest.raises(urllib.error.HTTPError):
            _get(tport, "/gt?view=9", 60)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_progressive_load_matches_jax(tmp_path):
    """A PLY longer than one streamed chunk (65,536 rows): the slot gets a
    growing prefix per chunk, and the last frame equals the JAX package's
    and a one-shot load, bit for bit."""
    from brush_tpu.viewer import service as jservice
    n = 70_000
    write_ply(tmp_path / "big.ply", n=n, seed=3, sh_coeffs=4)
    jslot, tslot, once = jservice.Slot(), Slot(), Slot()
    jservice.load_source_into_slot(str(tmp_path / "big.ply"), jslot,
                                   sh_degree=1)
    load_source_into_slot(str(tmp_path / "big.ply"), tslot, sh_degree=1,
                          device=CPU)
    load_source_into_slot(str(tmp_path / "big.ply"), once, sh_degree=1,
                          progressive=False, device=CPU)
    assert tslot.version == jslot.version == 2 and once.version == 1
    got, want, one = tslot.get(0), jslot.get(0), once.get(0)
    assert int(got.n_alive) == int(want.n_alive) == n
    for name in ("means", "log_scales", "quats", "sh_coeffs",
                 "raw_opacities"):
        a = getattr(got, name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(a, getattr(one, name).numpy(),
                                      err_msg=name)


# --------------------------------------------------------------------------
# the live view and the CLI
# --------------------------------------------------------------------------


def test_live_snapshot_survives_later_steps_and_refine(tmp_path):
    """Snapshots are the trainer's own tensors: the one published at step 2
    must not change through step 3's refine and steps 3-6."""
    from brush_tpu_torch.process import ProcessConfig, train_process
    from brush_tpu_torch.train.config import TrainConfig
    write_colmap_bin(tmp_path / "scene", n_views=3, w=32, h=32)
    slot, kept = Slot(), {}

    def on_message(msg):
        if msg.kind == "step" and msg.iter == 2:
            s = slot.get(0)
            kept.update(snap=s, copy={k: v.clone()
                                      for k, v in s.params().items()})

    msgs = list(train_process(
        str(tmp_path / "scene"),
        TrainConfig(total_train_iters=6, refine_every=3),
        pcfg=ProcessConfig(log_every=2, eval_every=0, export_every=0,
                           init_count=0, sh_degree=0, use_pallas=True,
                           export_path=str(tmp_path / "o_{iter}.ply")),
        on_message=on_message, slot=slot, device=CPU))
    assert [m.iter for m in msgs if m.kind == "refine"] == [3]
    assert slot.version == 3                     # steps 2, 4, 6
    assert len(slot.scene_views) == 3 and slot.gt_fn(0).dtype == np.uint8
    final = slot.get(0)
    assert final is not kept["snap"]
    moved = False
    for name, before in kept["copy"].items():
        assert torch.equal(getattr(kept["snap"], name), before), name
        moved |= not torch.equal(getattr(final, name)[:before.shape[0]],
                                 before)
    assert moved


@pytest.fixture
def nonblocking_serve(monkeypatch):
    """`serve` in a daemon thread on a free port; the servers it started."""
    started, real = [], tservice.serve

    def serve_in_background(*a, **k):
        k.update(blocking=False, port=0, host="127.0.0.1")
        started.append(real(*a, **k))
        return started[-1]

    monkeypatch.setattr(tservice, "serve", serve_in_background)
    yield started
    for s in started:
        s.shutdown()
        s.server_close()


def test_cli_view(tmp_path, nonblocking_serve):
    write_ply(tmp_path / "scene.ply", n=16)
    assert tcli._is_view_only_source(str(tmp_path / "scene.ply"))
    assert tcli.main([str(tmp_path / "scene.ply"), "--view", "--sh-degree",
                      "0", "--device", "cpu"]) == 0
    (server,) = nonblocking_serve
    port = server.server_address[1]
    assert json.loads(_get(port, "/info", 60))["n_splats"] == 16
    assert server.viewer_state.device.type == CPU

    # A dataset trains with the viewer live.
    write_colmap_bin(tmp_path / "data", n_views=2, w=32, h=32)
    assert not tcli._is_view_only_source(str(tmp_path / "data"))
    assert tcli.main([str(tmp_path / "data"), "--view", "--device", "cpu",
                      "--total-train-iters", "2", "--log-every", "1",
                      "--eval-every", "0", "--sh-degree", "0",
                      "--export-path", str(tmp_path / "v_{iter}.ply")]) == 0
    live = nonblocking_serve[1]
    info = json.loads(_get(live.server_address[1], "/info", 60))
    assert info["n_splats"] == 10 and info["version"] == 2
    assert len(json.loads(_get(live.server_address[1], "/views", 60))) == 2


def test_renders_on_several_threads_at_once():
    """The viewer renders on its server's threads while training projects
    on another: the projection's `jacfwd` must not run in two threads at
    once (PyTorch keeps forward-mode AD levels process-wide), so three
    threads rendering together each get the one-thread frame."""
    from brush_tpu_torch.camera import Camera
    from brush_tpu_torch.render import RenderConfig, camera_inputs, render
    from brush_tpu_torch.utils.synthetic import bench_splats
    s = bench_splats(200, sh_degree=1, seed=3, device=CPU)
    cam = Camera(position=np.array([0.0, 0.0, -18.0]),
                 rotation=np.array([1.0, 0.0, 0.0, 0.0]), fov_x=1.0,
                 fov_y=0.7)
    ci = camera_inputs(cam, (32, 32), device=CPU)
    cfg = RenderConfig(img_size=(32, 32), sh_degree=1, isect_cap=1 << 12,
                       use_pallas=True, forward_only=True)

    def frame():
        with torch.no_grad():
            return render(*s.params().values(), ci, torch.zeros(3), cfg)[0]

    want, errors = frame(), []

    def work():
        try:
            for _ in range(4):
                assert torch.equal(frame(), want)
        except Exception as e:         # reported below
            errors.append(repr(e))

    # One intra-op thread: three Python threads each driving all the cores
    # take ten times as long.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        torch.set_num_threads(n)
    assert errors == []
