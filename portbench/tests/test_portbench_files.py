"""Every configuration and cell file parses, BENCHMARK.json keeps to its
contract's shape, and each cell names only what BENCHMARK.json declares
and what the harness can find by name."""

import json
import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.load_json(common.ROOT / "BENCHMARK.json")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"step_ms", "frame_ms", "frame_p95_ms",
                        "peak_mem_mib", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell, config = common.load_cell(w["name"])
    assert cell["name"] == w["name"] and cell["config"] == w["config"]
    assert cell["chips"] == w["chips"] == 1
    assert len(w["why"]) <= 200
    assert (common.BENCH / "traffic" / f"{cell['traffic_kind']}.py").exists()
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (common.ROOT / cfg["file"]).exists()
    assert config["name"] == cfg["name"]
    assert sorted(config["reduced"]) == sorted(cfg["reduced"])
    reported = [m for m in BENCH["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    layers = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
    assert layers
    for m in layers:
        assert m["moves"] in names
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
    for entry in cell["limits"].values():
        assert isinstance(entry, (int, float))


def test_every_config_is_used_and_every_metric_file_declared():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    declared = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (common.BENCH / "metrics").glob("*.py")}
    assert files == declared
    cells = {p.stem for p in (common.BENCH / "workloads").glob("*.json")}
    assert cells == {w["name"] for w in BENCH["workloads"]}
