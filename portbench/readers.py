"""The arithmetic of the per-layer metrics, over what a traced run hands
them: `out["trace"]` (trace.summarize's dict of the traced stretch),
`out["trace_units"]` (the steps or frames the stretch covered),
`out["work"]` (work.py's FLOPs and least kernel seconds of those units,
from the reference's counts), `out["untraced"]` (the wall seconds and
units of the window's untraced part) and `out["replays"]` (the count and
host seconds of the graph replays in that part). The profiler slows the
host and its graph launches, so a time a unit and a launch's host time
are taken from the untraced part, and only device times from the trace.
A reader with nothing to read returns None.
"""

from __future__ import annotations

from portbench.work import PEAK_FLOPS


def _trace(out):
    t = out.get("trace")
    return t if t and out.get("trace_units") else None


def _unit_s(out):
    """Wall seconds a unit of the window's untraced part."""
    u = out.get("untraced")
    if not u or u["units"] <= 0 or u["s"] <= 0:
        return None
    return u["s"] / u["units"]


def graph_launch_us(out):
    """Mean host microseconds of a CUDA graph's `replay()` (its launch)
    in the window's untraced part."""
    r = out.get("replays")
    if not r or not r["count"]:
        return None
    return 1e6 * r["s"] / r["count"]


def torch_ops_ms(out):
    """Device ms a unit of every operation that is not one of the
    program's own kernels (memcpys and memsets included)."""
    t = _trace(out)
    return None if t is None else 1e3 * t["other_device_s"] / out[
        "trace_units"]


def csrc_ms(out):
    """Device ms a unit of the program's own kernels."""
    t = _trace(out)
    if t is None or t["own_kernel_s"] <= 0:
        return None
    return 1e3 * t["own_kernel_s"] / out["trace_units"]


def csrc_roofline_pct(out):
    """The program's kernels' least time over their device time, %."""
    t, w = _trace(out), out.get("work")
    if t is None or not w or t["own_kernel_s"] <= 0:
        return None
    return 100.0 * sum(w["kernel_least_s"].values()) / t["own_kernel_s"]


def device_idle_pct(out):
    """The share of a unit's wall time with no device operation, %: one
    less the traced stretch's device busy time a unit over the untraced
    part's wall time a unit. The profiler lengthens device operations, so
    this is a lower bound; the stretch's own idle share is an upper one."""
    t, unit = _trace(out), _unit_s(out)
    if t is None or unit is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / out["trace_units"] / unit)


def mfu(out):
    """The FLOPs a unit needs over the untraced part's wall time a unit
    at the float32 peak, %."""
    t, w, unit = _trace(out), out.get("work"), _unit_s(out)
    if t is None or not w or unit is None:
        return None
    return 100.0 * w["flops"] / out["trace_units"] / (unit * PEAK_FLOPS)
