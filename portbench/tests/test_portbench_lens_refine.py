"""The fisheye and refine kinds (traffic/train_lens.py,
traffic/train_refine.py) run tiny cells through the port on the CPU and
judge it correct; their controls' planted faults read not correct; a
program that trains the fisheye views through a pinhole stops the fisheye
cell after its warm-up."""

import dataclasses
import math

import pytest
import torch

from portbench.run import verdict
from portbench.tests.tiny import tiny_cell
from portbench.traffic import train_lens, train_refine


def tiny_fisheye():
    cell, config = tiny_cell("train-1m-1752-fisheye")
    config["views"] = 4
    config["camera"] = dict(config["camera"], width=176, height=120,
                            fx=79.0, fy=79.0, cx=88.0, cy=60.0)
    return cell, config


def tiny_refine():
    cell, config = tiny_cell("train-1m-1080p-refine")
    cell["traffic_params"].update(warmup_iters=9,
                                  train=dict(refine_every=4))
    return cell, config


def test_fisheye_kind_runs_tiny():
    cell, config = tiny_fisheye()
    out = train_lens.run(cell, config, 2 ** 33 + 17, 2.0, False,
                         device="cpu")
    assert verdict(out["compared"]), out["compared"]
    share = [c for c in out["compared"] if c[0] == "kb4_turn_share"]
    assert share == [["kb4_turn_share", 1.0, 1.0, "min"]]
    assert math.isfinite(out["e2e"]["step_ms"])


def test_fisheye_kind_stops_a_program_that_drops_the_lens(monkeypatch):
    """A program that trains every view as a pinhole and counts no lens
    (as the port did before it carried lenses)."""
    from brush_tpu_torch import process
    from brush_tpu_torch.camera import Pinhole
    real = process._step_turn

    def as_pinhole(loop, *args, **kwargs):
        loop = dataclasses.replace(loop, rcfg=dataclasses.replace(
            loop.rcfg, model=Pinhole()))
        return real(loop, *args, **kwargs)
    monkeypatch.setattr(process, "count", lambda name, n=1: None)
    monkeypatch.setattr(process, "_step_turn", as_pinhole)
    cell, config = tiny_fisheye()
    with pytest.raises(RuntimeError, match="no KB4 turn"):
        train_lens.run(cell, config, 5, 2.0, False, device="cpu")


def test_fisheye_control_faults_read_not_correct():
    cell, config = tiny_fisheye()
    got = train_lens.control(torch, cell, config, 7, "cpu",
                             train_lens.VARIANTS)
    assert set(got) == set(train_lens.VARIANTS)
    for variant, cmp in got.items():
        assert not verdict(cmp), (variant, cmp)


def test_refine_kind_runs_tiny_and_its_faults_read_not_correct():
    cell, config = tiny_refine()
    out = train_refine.run(cell, config, 2 ** 33 + 17, 15.0, False,
                           device="cpu")
    assert verdict(out["compared"]), out["compared"]
    assert out["notes"]["refine_iter"] > cell["traffic_params"][
        "warmup_iters"]
    got = train_refine.control(torch, cell, config, 2 ** 33 + 17, "cpu",
                               train_refine.VARIANTS)
    for variant, cmp in got.items():
        assert not verdict(cmp), (variant, cmp)
