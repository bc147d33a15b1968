"""The arithmetic of the program's own stages, over a snapshot of its
recorder (`brush_tpu_torch.utils.tracing.snapshot()`: per-name aggregates
of host and device times, counters, `dropped`, and a timeline of stages
with host [start, end] ns and device [start, end] ns on the host clock).

A traced run that opens the recorder for the window's untraced part hands
`out["stages"] = dict(snapshot=..., units=n)`, n the steps or frames of
that part; each reader below takes it and returns None where it finds
nothing to read. The unit stage is `run.turn` (a training step) or
`viewer.frame` (a viewer frame): its device span runs from its first
enqueue to its last, so the gaps between consecutive units' spans are
time the card had nothing of the program queued, seen without a profiler.
"""

from __future__ import annotations

import bisect

TRAIN_UNIT = "run.turn"
VIEW_UNIT = "viewer.frame"
OUTSIDE = "outside any stage"


def _part(out):
    s = out.get("stages")
    if not s or not s.get("snapshot") or s.get("units", 0) <= 0:
        return None
    return s["snapshot"], s["units"]


def host_ms(out, name: str):
    """Host ms a unit in stage `name`."""
    p = _part(out)
    if p is None or name not in p[0]["stages"]:
        return None
    return p[0]["stages"][name]["host_ms"] / p[1]


def device_ms(out, name: str, parent: str | None = None):
    """Device ms a unit between the marks of stage `name` (those whose
    parent is `parent`, where given), from the timeline."""
    p = _part(out)
    if p is None:
        return None
    spans = [e["device"] for e in p[0]["timeline"] if e["name"] == name
             and e["device"] is not None
             and (parent is None or e["parent"] == parent)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / p[1]


def unit_gaps(snap: dict, unit: str) -> tuple[list, float]:
    """The gaps between consecutive device spans of the unit stage, as
    (start, end) ns, and the ns from the first span's start to the last
    end. Spans are taken in order of their device start; a span that
    starts before an earlier one ended (overlapping, or out of order)
    leaves no gap."""
    spans = sorted(e["device"] for e in snap["timeline"]
                   if e["name"] == unit and e["device"] is not None)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    extent = end - spans[0][0] if spans else 0
    return gaps, extent


def gap_pct(out, unit: str):
    """The card's idle between units: the sum of `unit_gaps` over the
    units' extent, %. Idle inside a unit is not in it: a lower bound on
    the card's idle share."""
    p = _part(out)
    if p is None:
        return None
    gaps, extent = unit_gaps(p[0], unit)
    if extent <= 0:
        return None
    return 100.0 * sum(e - s for s, e in gaps) / extent


class Innermost:
    """The innermost of a set of host intervals containing a time: of
    those that contain it, the one that started last (stages on a thread
    nest, so it is the deepest)."""

    def __init__(self, intervals):
        """`intervals`: (start, end, name) in any order; of two that start
        together the shorter is the inner."""
        self.items = sorted(intervals, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.items]

    def at(self, t):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s, e, name = self.items[i]
            if e >= t:
                return name
        return None


def idle_by_stage(snap: dict, unit: str) -> dict[str, float]:
    """Each gap between the unit's device spans, in seconds, summed by
    the innermost stage open on the host at the gap's midpoint (`OUTSIDE`
    where none was)."""
    gaps, _ = unit_gaps(snap, unit)
    where = Innermost((e["host"][0], e["host"][1], e["name"])
                      for e in snap["timeline"])
    out: dict[str, float] = {}
    for s, e in gaps:
        name = where.at(0.5 * (s + e)) or OUTSIDE
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out


def notes(out, unit: str) -> dict | None:
    """What a cell's notes carry of the stages: `idle_by_stage`, each
    stage's self ms a unit (its span less its children's), the program's
    counters and `dropped`."""
    p = _part(out)
    if p is None:
        return None
    snap, units = p
    return dict(
        idle_by_stage=idle_by_stage(snap, unit),
        self_ms={k: v["self_ms"] / units for k, v in snap["stages"].items()},
        counters=snap["counters"], dropped=snap["dropped"], units=units)


# The readers of the per-layer metrics, one a metric.


def loader_wait_ms(out):
    """Host ms a step in `run.load` (the loader and the batch's views)."""
    return host_ms(out, "run.load")


def upload_ms(out):
    """Host ms a step in `run.upload` (the pinned uploads)."""
    return host_ms(out, "run.upload")


def step_graph_device_ms(out):
    """Device ms a step between the marks around the step graph's
    replay."""
    return device_ms(out, "graphs.replay", parent=TRAIN_UNIT)


def turn_gap_pct(out):
    return gap_pct(out, TRAIN_UNIT)


def camera_ms(out):
    """Host ms a frame in `viewer.camera` (the pose and its upload)."""
    return host_ms(out, "viewer.camera")


def frame_copy_device_ms(out):
    """Device ms a frame of `viewer.copy` (the uint8 frame to the host)."""
    return device_ms(out, "viewer.copy")


def frame_graph_device_ms(out):
    """Device ms a frame between the marks around the render graph's
    replay."""
    return device_ms(out, "graphs.replay", parent=VIEW_UNIT)


def frame_gap_pct(out):
    return gap_pct(out, VIEW_UNIT)
