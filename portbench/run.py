"""Run one cell of the benchmark of brush_tpu_torch and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name: the cell in workloads/<cell>.json, its
configuration in configs/<config>.json, its traffic kind's runner in
traffic/<kind>.py, each per-layer metric's reader in metrics/<name>.py,
and which metrics a cell reports in BENCHMARK.json at the checkout's root.

The traffic runner makes the inputs from the seed, warms up, measures a
window of `--seconds`, then judges what the program produced against the
plain reference (portbench/reference). With `--trace 1` the window also
holds a device trace of a stretch, and the result carries the per-layer
metrics instead of the end-to-end ones.

The last lines on standard error, and the key `compared` that comes last
in the result, give each number compared beside its limit. Exit codes: 0
a result was printed; 2 the cards the cell needs are missing; 3 JAX or the
JAX package was loaded; 1 anything else.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import traceback
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from portbench import common  # noqa: E402


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def per_layer(bench: dict, cell: str, out: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    metrics = {}
    for m in bench["per_layer"]:
        if not applies(m, cell):
            continue
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(out)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def end_to_end(bench: dict, cell: str, out: dict) -> dict:
    return {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if applies(m, cell)}


def verdict(compared: list) -> bool:
    ok = True
    for entry in compared:
        name, value, limit = entry[:3]
        lower_bound = len(entry) > 3 and entry[3] == "min"
        good = value >= limit if lower_bound else value <= limit
        ok = ok and math.isfinite(value) and good
    return ok


def compared_line(compared: list) -> dict:
    return {e[0]: {"value": e[1], "limit": e[2],
                   "rule": ">=" if len(e) > 3 and e[3] == "min" else "<="}
            for e in compared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.cache_env()
    cell, config = common.load_cell(args.workload)
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    import torch
    try:
        common.require_cards(torch, cell["chips"])
    except common.NoDevice as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = load_module(BENCH / "traffic" / f"{cell['traffic_kind']}.py",
                       "portbench_traffic_" + cell["traffic_kind"])
    out = kind.run(cell, config, args.seed, args.seconds, bool(args.trace),
                   device="cuda")
    loaded = common.forbidden_loaded()
    if loaded:
        print("portbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(loaded) + "; no result", file=sys.stderr)
        return 3

    correct = verdict(out["compared"])
    metrics = (per_layer(bench, args.workload, out) if args.trace
               else end_to_end(bench, args.workload, out))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if args.trace and out["trace"] is not None:
        t = out["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["top_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["notes"] = out.get("notes", {})
    result["power_limit"] = power_limit()
    result["compared"] = compared_line(out["compared"])
    for e in out["compared"]:
        rule = ">=" if len(e) > 3 and e[3] == "min" else "<="
        print(f"compared {e[0]} {e[1]!r} {rule} {e[2]!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # the run's last words go to stderr, no result
        traceback.print_exc()
        sys.exit(1)
