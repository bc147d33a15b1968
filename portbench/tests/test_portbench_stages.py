"""The stage readers (portbench/stages.py) on canned snapshots of the
program's recorder, counted by hand: host and device ms a unit, the gaps
between units' device spans (spans that overlap or come out of order
leave none), `idle_by_stage`, the notes; and the innermost stage of a
Chrome trace's annotations at an idle gap of tests/data's stretch."""

import json
from pathlib import Path

import pytest

from portbench import stages

DATA = Path(__file__).resolve().parent / "data"
MS = 1_000_000      # ns


def _entry(name, host, device=None, parent=None, unit=None):
    return dict(name=name, parent=parent, unit=unit, thread=1,
                host=[int(host[0] * MS), int(host[1] * MS)],
                device=None if device is None
                else [int(device[0] * MS), int(device[1] * MS)])


def _agg(host_ms, self_ms=None, device_ms=0.0, device_count=0, count=1):
    return dict(count=count, host_ms=host_ms, self_ms=self_ms or host_ms,
                host_max_ms=host_ms, device_count=device_count,
                device_ms=device_ms, device_max_ms=device_ms)


def train_snapshot():
    """Four turns. Device spans [0, 70], [75, 145], [140, 210] (starts
    before the second ended) and [150, 160] (inside the third): one gap,
    70 to 75 ms, while the host was in the second turn's `run.load`."""
    tl = [
        _entry("run.turn", (-2, 71), (0, 70), unit=1),
        _entry("run.turn", (71, 141), (75, 145), unit=2),
        _entry("run.load", (71, 74.5), parent="run.turn", unit=2),
        _entry("run.upload", (74.5, 75), parent="run.turn", unit=2),
        _entry("graphs.replay", (75, 76), (75.5, 140), parent="run.turn",
               unit=2),
        _entry("graphs.replay", (200, 201), (300, 310), parent="refine",
               unit=2),
        _entry("run.turn", (141, 150), (140, 210), unit=3),
        _entry("run.turn", (150, 151), (150, 160), unit=4),
    ]
    return dict(
        stages={"run.turn": _agg(300.0, self_ms=200.0, device_ms=290.0,
                                 device_count=4, count=4),
                "run.load": _agg(8.0, count=4),
                "run.upload": _agg(2.0, count=4),
                "graphs.replay": _agg(4.0, device_ms=74.5, device_count=2)},
        counters={"graphs.replay.step": 4}, dropped=0, timeline=tl)


def test_host_and_device_ms_a_unit():
    out = dict(stages=dict(snapshot=train_snapshot(), units=4))
    assert stages.loader_wait_ms(out) == pytest.approx(2.0)
    assert stages.upload_ms(out) == pytest.approx(0.5)
    # The step graph's replay alone (the refine's has another parent).
    assert stages.step_graph_device_ms(out) == pytest.approx(64.5 / 4)
    assert stages.camera_ms(out) is None
    assert stages.frame_graph_device_ms(out) is None
    for bare in ({}, dict(stages=None),
                 dict(stages=dict(snapshot=train_snapshot(), units=0))):
        assert stages.loader_wait_ms(bare) is None
        assert stages.turn_gap_pct(bare) is None


def test_gaps_between_units_count_overlap_and_disorder_as_zero():
    snap = train_snapshot()
    gaps, extent = stages.unit_gaps(snap, "run.turn")
    assert gaps == [(70 * MS, 75 * MS)] and extent == 210 * MS
    out = dict(stages=dict(snapshot=snap, units=4))
    assert stages.turn_gap_pct(out) == pytest.approx(100.0 * 5 / 210)
    snap["timeline"].reverse()                  # order does not matter
    assert stages.turn_gap_pct(out) == pytest.approx(100.0 * 5 / 210)
    assert stages.frame_gap_pct(out) is None


def test_idle_by_stage_takes_the_innermost_stage_at_the_midpoint():
    snap = train_snapshot()
    assert stages.idle_by_stage(snap, "run.turn") == pytest.approx(
        {"run.load": 0.005})
    # Without the load stage the gap falls to its turn; with no stage
    # open at all, outside any.
    snap["timeline"] = [e for e in snap["timeline"]
                        if e["name"] != "run.load"]
    assert stages.idle_by_stage(snap, "run.turn") == pytest.approx(
        {"run.turn": 0.005})
    for e in snap["timeline"]:
        e["host"] = [e["host"][0] + 1000 * MS, e["host"][1] + 1000 * MS]
    assert stages.idle_by_stage(snap, "run.turn") == pytest.approx(
        {stages.OUTSIDE: 0.005})


def test_view_readers_and_notes():
    """Two frames of 20 ms with a 2 ms gap during the second's lock wait;
    the copy 3 ms and the replay 12 ms a frame."""
    tl = []
    for k, t0 in enumerate((0.0, 22.0)):
        tl += [
            _entry("viewer.frame", (t0 - 3, t0 + 20), (t0, t0 + 20),
                   unit=k),
            _entry("viewer.lock", (t0 - 2.5, t0), parent="viewer.frame",
                   unit=k),
            _entry("viewer.camera", (t0 + 1, t0 + 1.5),
                   parent="viewer.frame", unit=k),
            _entry("graphs.replay", (t0 + 2, t0 + 2.5), (t0 + 3, t0 + 15),
                   parent="viewer.frame", unit=k),
            _entry("viewer.copy", (t0 + 15, t0 + 20), (t0 + 17, t0 + 20),
                   parent="viewer.frame", unit=k),
        ]
    snap = dict(stages={"viewer.frame": _agg(46.0, self_ms=30.0, count=2),
                        "viewer.camera": _agg(1.0, count=2)},
                counters={"graphs.replay.render": 2,
                          "viewer.lock_contended": 0},
                dropped=3, timeline=tl)
    out = dict(stages=dict(snapshot=snap, units=2))
    assert stages.camera_ms(out) == pytest.approx(0.5)
    assert stages.frame_copy_device_ms(out) == pytest.approx(3.0)
    assert stages.frame_graph_device_ms(out) == pytest.approx(12.0)
    assert stages.frame_gap_pct(out) == pytest.approx(100.0 * 2 / 42)
    n = stages.notes(out, "viewer.frame")
    assert n["idle_by_stage"] == pytest.approx({"viewer.lock": 0.002})
    assert n["self_ms"] == pytest.approx({"viewer.frame": 15.0,
                                          "viewer.camera": 0.5})
    assert n["counters"]["graphs.replay.render"] == 2
    assert n["dropped"] == 3 and n["units"] == 2
    assert json.loads(json.dumps(n)) == n


def test_innermost_annotation_at_a_trace_gap():
    """The stretch trace's gap from 2500 to 3000 us has no host op over
    its midpoint; a program stage annotated over it names it, and the
    innermost of nested annotations wins."""
    with open(DATA / "stretch_trace.json") as f:
        events = json.load(f)["traceEvents"]
    events += [dict(ph="X", name="run.turn", cat="user_annotation",
                    ts=1400, dur=5000, pid=0, tid=0),
               dict(ph="X", name="run.upload", cat="user_annotation",
                    ts=2600, dur=300, pid=0, tid=0)]
    where = stages.Innermost(
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
        if e["cat"] == "user_annotation" and e["name"] != "portbench.stretch")
    assert where.at(2750) == "run.upload"
    assert where.at(2000) == "run.turn"
    assert where.at(12000) is None
