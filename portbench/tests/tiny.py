"""Tiny versions of the benchmark's cells for CPU tests: the cells' own
files with sizes cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import copy

from portbench import common

TINY_CONFIG = dict(num_splats=1500, sh_degree=3, dtype="float32")


def tiny_cell(name: str) -> tuple[dict, dict]:
    cell, config = common.load_cell(name)
    cell = copy.deepcopy(cell)
    tr = cell["traffic_params"]
    if cell["traffic_kind"] == "view":
        tr.update(width=80, height=48, poses=3, warmup_frames=1,
                  check_poses=3)
        cell["limits"]["poses_checked_min"] = 3
    else:
        tr.update(width=64, height=48, views=4, warmup_iters=2,
                  follow_real_turns=2, follow_max_turns=4,
                  process=dict(log_every=1, init_isect_cap=1 << 12,
                               init_chunk_cap=1 << 10),
                  train=dict(refine_every=1000),
                  reference=dict(init_isect_cap=1 << 12,
                                 init_chunk_cap=1 << 10))
    return cell, dict(config, **TINY_CONFIG)
