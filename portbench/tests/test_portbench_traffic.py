"""Each traffic kind runs a tiny cell through the port on the CPU, and
its run judges the port correct; after a tiny run no module of JAX or of
the JAX package is loaded."""

import json
import math
import subprocess
import sys

import pytest

from portbench import common
from portbench.run import verdict
from portbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name,metrics", [
    ("view-1m-1080p", ("frame_ms", "frame_p95_ms", "peak_mem_mib",
                       "setup_s")),
    ("train-1m-1080p", ("step_ms", "peak_mem_mib", "setup_s")),
])
def test_kind_runs_tiny(name, metrics):
    cell, config = tiny_cell(name)
    kind = __import__(f"portbench.traffic.{cell['traffic_kind']}",
                      fromlist=["run"])
    out = kind.run(cell, config, 2 ** 33 + 17, 3.0, False, device="cpu")
    assert verdict(out["compared"]), out["compared"]
    for m in metrics:
        assert math.isfinite(out["e2e"][m])
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_no_jax_after_a_run():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import common\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "from portbench.traffic import view\n"
        "cell, config = tiny_cell('view-1m-1080p')\n"
        "view.run(cell, config, 3, 0.2, False, device='cpu')\n"
        "print(json.dumps(common.forbidden_loaded()))\n" % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole():
    sys.modules.setdefault("brush_tpu_torch_lookalike", sys)
    assert "brush_tpu_torch_lookalike" not in common.forbidden_loaded()


def test_no_card_no_result(tmp_path):
    """Without a card the command exits 2 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "view-1m-1080p",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(common.ROOT))
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["view-1m-1080p", "train-1m-1080p"])
def test_kind_runs_tiny_on_the_card(cuda, name):
    """The same tiny cells through the port's kernels and graphs, and a
    traced stretch reduced to every per-layer metric the cell declares."""
    from portbench.run import per_layer
    cell, config = tiny_cell(name)
    if cell["traffic_kind"] == "view":
        cell["traffic_params"].update(trace_after_frames=2, trace_frames=3)
    kind = __import__(f"portbench.traffic.{cell['traffic_kind']}",
                      fromlist=["run"])
    out = kind.run(cell, config, 2 ** 33 + 21, 3.0, True, device="cuda")
    assert verdict(out["compared"]), out["compared"]
    assert out["trace"]["busy_s"] > 0
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    got = per_layer(bench, name, out)
    assert got and all(math.isfinite(m["value"]) for m in got.values())
