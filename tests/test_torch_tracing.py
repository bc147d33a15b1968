"""The stage recorder of `brush_tpu_torch` (utils/tracing.py) on the CPU:
nesting, parents and units across threads, counters, nothing recorded
with the recorder closed, the timeline's cap, the host clock's order and
self times; and the stages a three-step `train_process` and the viewer's
`render_pose` record. On the CPU every device field is None; the card's
marks are tested in tests/test_torch_cuda.py."""

import threading
import time

import numpy as np
import pytest

from tests.test_dataset_formats import write_colmap_bin

from brush_tpu_torch.utils import tracing


def _by_name(snap, name):
    return [e for e in snap["timeline"] if e["name"] == name]


def test_stages_nest_with_parents_and_units_on_each_thread():
    """Each thread keeps its own stack: a stage's parent is the innermost
    stage open on its own thread, and its unit the outer stage's."""
    barrier = threading.Barrier(2, timeout=30)

    def work(unit):
        with tracing.stage("outer", unit=unit):
            barrier.wait()          # both outers open at once
            with tracing.stage("inner"):
                with tracing.stage("leaf", unit=unit + 100):
                    pass
            barrier.wait()

    with tracing.record_stages() as rec:
        threads = [threading.Thread(target=work, args=(u,)) for u in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        with tracing.stage("main"):
            pass
        snap = rec.snapshot()
    outers = _by_name(snap, "outer")
    assert sorted(e["unit"] for e in outers) == [1, 2]
    assert len({e["thread"] for e in outers}) == 2
    for e in _by_name(snap, "inner"):
        assert e["parent"] == "outer"
        outer = next(o for o in outers if o["thread"] == e["thread"])
        assert e["unit"] == outer["unit"]
        assert outer["host"][0] <= e["host"][0] <= e["host"][1] \
            <= outer["host"][1]
    assert sorted(e["unit"] for e in _by_name(snap, "leaf")) == [101, 102]
    assert all(e["parent"] == "inner" for e in _by_name(snap, "leaf"))
    main, = _by_name(snap, "main")
    assert main["parent"] is None and main["unit"] is None
    assert all(e["device"] is None for e in snap["timeline"])
    assert snap["stages"]["outer"]["count"] == 2
    assert snap["stages"]["outer"]["device_count"] == 0


def test_many_threads_lose_no_stage_or_count():
    """Threads past the core count, switching as often as the interpreter
    allows: every stage and count lands in the aggregates."""
    import os
    import sys
    n, each = 2 * (os.cpu_count() or 4) + 2, 100

    def work():
        for i in range(each):
            with tracing.stage("outer", unit=i), tracing.stage("inner"):
                tracing.count("c")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.record_stages() as rec:
            threads = [threading.Thread(target=work) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            snap = rec.snapshot()
    finally:
        sys.setswitchinterval(interval)
    assert snap["counters"] == {"c": n * each}
    assert snap["stages"]["outer"]["count"] == n * each
    assert snap["stages"]["inner"]["count"] == n * each
    inner = _by_name(snap, "inner")
    assert all(e["parent"] == "outer" for e in inner)
    assert len(inner) == n * each and snap["dropped"] == 0


def test_counters_add_only_with_the_recorder_open():
    tracing.count("c", 5)                  # closed: nothing, no error
    with tracing.record_stages() as rec:
        tracing.count("c")
        tracing.count("c", 2)
        tracing.count("d")
    assert rec.snapshot()["counters"] == {"c": 3, "d": 1}


def test_a_closed_recorder_records_nothing():
    """Without a recorder a stage records nothing and yields a stand-in;
    `stages_off` keeps a thread's stages out of an open recorder."""
    assert tracing.snapshot() is None
    with tracing.stage("closed", device=True) as span:
        span.mark_device_start()
    with tracing.record_stages() as rec:
        with tracing.stages_off(), tracing.stage("off", device=True):
            tracing.count("x")              # counters are not stages
        snap = tracing.snapshot()
    assert snap["stages"] == {} and snap["timeline"] == []
    assert snap["counters"] == {"x": 1} and tracing.stage_ms(rec) == {}
    assert tracing.snapshot() is None


def test_timeline_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "TIMELINE_CAP", 4)
    with tracing.record_stages() as rec:
        for i in range(10):
            with tracing.stage("s", unit=i):
                pass
        snap = rec.snapshot()
    assert [e["unit"] for e in snap["timeline"]] == [6, 7, 8, 9]
    assert snap["dropped"] == 6
    assert snap["stages"]["s"]["count"] == 10


def test_host_clock_order_and_self_time():
    """Stages in turn start in turn on the host clock; a parent's self
    time is its span less its children's."""
    with tracing.record_stages() as rec:
        with tracing.stage("parent"):
            time.sleep(0.002)
            for _ in range(2):
                with tracing.stage("child"):
                    time.sleep(0.003)
        snap = rec.snapshot()
    starts = [e["host"][0] for e in snap["timeline"]]
    assert starts == sorted(starts)
    c1, c2 = _by_name(snap, "child")
    assert c1["host"][1] <= c2["host"][0]
    parent = snap["stages"]["parent"]
    child = snap["stages"]["child"]
    assert child["count"] == 2 and child["self_ms"] == child["host_ms"]
    assert parent["self_ms"] == pytest.approx(
        parent["host_ms"] - child["host_ms"], abs=1e-6)
    assert parent["self_ms"] >= 2.0 and child["host_ms"] >= 6.0
    assert parent["host_max_ms"] == parent["host_ms"]


def test_train_process_records_its_turns(tmp_path):
    """Three steps of `train_process`: a `run.turn` a step (unit = the
    step), each holding one `run.load` and one `run.upload`, and from the
    second turn on (the first has no step before it to read) one
    `run.readback`; a log step's `run.message` sits in its turn."""
    from brush_tpu_torch.data.formats import LoadConfig
    from brush_tpu_torch.process import ProcessConfig, train_process
    from brush_tpu_torch.train.config import TrainConfig
    write_colmap_bin(tmp_path / "scene", n_views=2, w=32, h=32)
    tcfg = TrainConfig(total_train_iters=3, refine_every=1000)
    pcfg = ProcessConfig(eval_every=0, export_every=0, log_every=3,
                         init_count=50, sh_degree=0, use_pallas=False,
                         export_path=str(tmp_path / "out_{iter}.ply"))
    with tracing.record_stages() as rec:
        list(train_process(str(tmp_path / "scene"), tcfg,
                           LoadConfig(max_resolution=32), pcfg,
                           device="cpu"))
        snap = rec.snapshot()
    turns = _by_name(snap, "run.turn")
    assert [e["unit"] for e in turns] == [1, 2, 3]
    assert all(e["device"] is None for e in snap["timeline"])
    for name, units in (("run.load", [1, 2, 3]), ("run.upload", [1, 2, 3]),
                        ("run.readback", [2, 3]), ("run.message", [3])):
        got = _by_name(snap, name)
        assert [e["unit"] for e in got] == units, name
        for e in got:
            turn = turns[e["unit"] - 1]
            assert e["parent"] == "run.turn"
            assert turn["host"][0] <= e["host"][0] <= e["host"][1] \
                <= turn["host"][1]


def test_render_pose_records_the_frame_stages():
    """Two frames: a `viewer.frame` each (unit = the frame's number)
    holding `viewer.lock`, `viewer.fold`, `viewer.camera` and
    `viewer.copy`; a frame that waited for another render's lock counts
    `viewer.lock_contended`, and each frame's projection (eager on the
    CPU) counts the viewer's pinhole lens."""
    from brush_tpu_torch.utils.synthetic import bench_splats
    from brush_tpu_torch.viewer.service import Slot, ViewerState
    slot = Slot()
    slot.set(0, bench_splats(64, sh_degree=0, seed=1, device="cpu"))
    state = ViewerState(slot, 0, device="cpu")

    def frame():
        return state.render_pose(np.array([0.0, 0.0, -18.0]), 0.0, 0.0,
                                 32, 24, 0)

    with tracing.record_stages() as rec:
        assert frame().shape == (24, 32, 3)
        state.lock.acquire()
        t = threading.Thread(target=frame)
        t.start()
        deadline = time.monotonic() + 30
        while ("viewer.lock_contended" not in rec.snapshot()["counters"]
               and time.monotonic() < deadline):
            time.sleep(0.001)
        state.lock.release()
        t.join(timeout=60)
        assert not t.is_alive()
        snap = rec.snapshot()
    frames = _by_name(snap, "viewer.frame")
    assert [e["unit"] for e in frames] == [0, 1]
    assert snap["counters"] == {"viewer.lock_contended": 1,
                                "project.lens.pinhole": 2,
                                "project.route.torch": 2}
    for name in ("viewer.lock", "viewer.fold", "viewer.camera",
                 "viewer.copy"):
        got = _by_name(snap, name)
        assert [e["unit"] for e in got] == [0, 1], name
        assert all(e["parent"] == "viewer.frame" for e in got)
    assert all(e["device"] is None for e in snap["timeline"])
    lock = snap["stages"]["viewer.lock"]
    assert lock["host_max_ms"] > lock["host_ms"] / 2   # the wait
