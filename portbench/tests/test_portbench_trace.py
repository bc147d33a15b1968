"""The trace reader on small Chrome traces: a hand-written one whose
numbers are counted by hand, and one recorded on an H100 (a profiled
viewer frame of a small scene) for the names real traces carry; the
readers' arithmetic; and the clock of graph replays and captures."""

from pathlib import Path

import pytest

from portbench import trace

DATA = Path(__file__).resolve().parent / "data"


def test_hand_trace():
    s = trace.summarize(str(DATA / "stretch_trace.json"),
                        trace.kernel_names())
    assert s["window_s"] == pytest.approx(10000e-6)
    # Inside [1000, 11000]: the scan clipped to [1000, 1200] (200), the
    # forward 500, [3000, 4200] of the two overlapping (1200), the copy 100.
    assert s["busy_s"] == pytest.approx(2000e-6)
    assert s["own_kernel_s"] == pytest.approx(700e-6)
    assert s["own_by_kernel_s"] == pytest.approx(
        {"rasterize_fwd": 500e-6, "scan": 200e-6})
    assert s["other_device_s"] == pytest.approx(1800e-6)
    assert s["device_ops"] == 5
    gap, secs = s["idle_gaps"][0]
    assert secs == pytest.approx(6400e-6) and gap == "aten::copy_"
    assert s["top_ops"][0][0].startswith("ampere_sgemm")


def test_kernel_names_split_variants():
    ks = trace.kernel_names()
    assert trace.match_kernel("void rasterize_fwd_kernel<true>(x)", ks) == \
        "rasterize_fwd_train"
    assert trace.match_kernel("void rasterize_fwd_kernel<false>(x)", ks) == \
        "rasterize_fwd"
    assert trace.match_kernel("round_sums_kernel(double2 const*)", ks) == \
        "rasterize_bwd_round"
    assert trace.match_kernel("void at::native::vectorized_elementwise", ks
                              ) is None


def test_recorded_trace():
    path = DATA / "recorded_view_trace.json"
    if not path.exists():
        pytest.skip("no recorded trace in tests/data")
    s = trace.summarize(str(path), trace.kernel_names())
    assert 0 < s["busy_s"] <= s["window_s"]
    assert {"rasterize_fwd", "emit", "scan"} <= set(s["own_by_kernel_s"])
    assert s["other_device_s"] > 0


def test_readers_take_unit_times_from_the_untraced_part():
    """Idle and mfu divide device time by the untraced part's wall time a
    unit, not by the traced stretch's; the launch is the replays' own."""
    from portbench import readers
    from portbench.work import PEAK_FLOPS
    out = dict(trace=dict(busy_s=0.36, window_s=0.5, own_kernel_s=0.02,
                          other_device_s=0.34),
               trace_units=20, untraced=dict(s=8.0, units=400),
               work=dict(flops=20 * 0.02 * PEAK_FLOPS * 0.01,
                         kernel_least_s={"scan": 0.01}),
               replays=dict(count=400, s=0.2))
    # 18 ms busy a unit against 20 ms a unit untraced.
    assert readers.device_idle_pct(out) == pytest.approx(10.0)
    assert readers.mfu(out) == pytest.approx(1.0)
    assert readers.graph_launch_us(out) == pytest.approx(500.0)
    assert readers.csrc_roofline_pct(out) == pytest.approx(50.0)
    assert readers.torch_ops_ms(out) == pytest.approx(17.0)
    for key in ("untraced", "replays"):
        bare = dict(out, **{key: None})
        assert (readers.graph_launch_us(bare) is None) == (key == "replays")
        assert (readers.device_idle_pct(bare) is None) == (key == "untraced")


def test_graph_clock_times_replays_and_counts_captures(monkeypatch):
    import torch
    cls = torch.cuda.CUDAGraph
    calls = []
    monkeypatch.setattr(cls, "replay", lambda g: calls.append("replay"))
    monkeypatch.setattr(cls, "capture_begin",
                        lambda g, *a, **k: calls.append("capture"))
    stub_replay, stub_begin = cls.replay, cls.capture_begin
    clock = trace.GraphClock(torch, True)
    cls.replay(None)
    cls.capture_begin(None)
    clock.window = clock.timing = True
    cls.replay(None)
    cls.replay(None)
    cls.capture_begin(None, pool=None)
    clock.restore()
    cls.replay(None)
    assert calls == ["replay", "capture", "replay", "replay", "capture",
                     "replay"]
    assert clock.replays == 2 and clock.replay_s >= 0
    assert clock.captures == 1
    assert cls.replay is stub_replay and cls.capture_begin is stub_begin
    untimed = trace.GraphClock(torch, False)
    assert cls.replay is stub_replay
    untimed.restore()
