"""Projected rows that pick the edges of the exact tile counts, shared by
tests/test_torch_render.py (the plain version against the JAX package on
the CPU) and tests/test_torch_cuda.py (the kernel against the plain
version on the card). numpy only: the card's machine has no JAX.

Every case has `N_ROWS` rows, not a multiple of the kernel's 256-thread
block, on a 1920x1080 grid of 32-pixel tiles. The rows start as splats of
1-90 px radius, 3 % culled (bbox count 0 over a non-empty bbox, as the
projection's gates leave them), and each case adds its edge:

  * random:            the rows as they are;
  * bbox_counts:       bbox counts of 0, 1, 31, 32, 33, 120 and 150;
  * bbox_widths:       bboxes 1 tile wide (1-40 high) and 40-60 wide;
  * means_on_edges:    means exactly on tile edges and corners;
  * zero_den:          c00 or c11 (or both) zero, so the edge projections
                       divide by 1 in place of tx_den or ty_den;
  * nonfinite_culled:  NaN and infinite conics on rows whose bbox count is 0;
  * all_dead:          every bbox count 0, the other words garbage.
"""

import numpy as np

N_ROWS = 1001
IMG = (1920, 1080)
TILE = 32

CASES = ("random", "bbox_counts", "bbox_widths", "means_on_edges",
         "zero_den", "nonfinite_culled", "all_dead")


def _splats(rng, n):
    """Means, conics and opacities of splats of 1-90 px radius."""
    w, h = IMG
    mean = np.stack([rng.uniform(-40, w + 40, n),
                     rng.uniform(-40, h + 40, n)], axis=1)
    r1, r2 = rng.uniform(1.0, 90.0, (2, n))
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    a = r1 ** 2 * c ** 2 + r2 ** 2 * s ** 2
    b = (r1 ** 2 - r2 ** 2) * c * s
    d = r1 ** 2 * s ** 2 + r2 ** 2 * c ** 2
    det = a * d - b * b
    conic = np.stack([d / det, -b / det, a / det], axis=1)
    opac = rng.uniform(1.0 / 255.0, 1.0, n)
    return mean, conic, opac, (a, d)


def _bbox(mean, cov_diag, opac):
    """Tile bbox as the projection forms it: (tile_min, tile_max, count)."""
    tbw, tbh = -(-IMG[0] // TILE), -(-IMG[1] // TILE)
    thr = np.log(np.maximum(opac, 1e-30) * 255.0)
    ex = np.sqrt(np.maximum(2.0 * thr * cov_diag[0], 0.0))
    ey = np.sqrt(np.maximum(2.0 * thr * cov_diag[1], 0.0))
    lo = np.stack([np.clip((mean[:, 0] - ex) / TILE, 0, tbw),
                   np.clip((mean[:, 1] - ey) / TILE, 0, tbh)], 1)
    hi = np.stack([np.clip((mean[:, 0] + ex) / TILE + 1, 0, tbw),
                   np.clip((mean[:, 1] + ey) / TILE + 1, 0, tbh)], 1)
    tmin, tmax = lo.astype(np.int32), hi.astype(np.int32)
    count = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
    return tmin, tmax, count.astype(np.int32)


def _place(rng, rows, idx, wide, high, count=None):
    """Give rows `idx` a bbox `wide` x `high` tiles (count wide * high
    unless given), with the splat's mean and size inside it."""
    tmin = np.stack([rng.integers(0, np.maximum(IMG[0] // TILE - wide, 1)),
                     rng.integers(0, np.maximum(IMG[1] // TILE - high, 1))],
                    1).astype(np.int32)
    rows["tile_min"][idx] = tmin
    rows["tile_max"][idx] = tmin + np.stack([wide, high], 1)
    rows["num_tiles_bbox"][idx] = wide * high if count is None else count
    size = TILE * np.stack([wide, high], 1)
    rows["mean2d"][idx] = tmin * TILE + size * rng.uniform(0.2, 0.8,
                                                           (len(idx), 2))
    rad = np.maximum(0.3 * size.min(axis=1), 2.0)
    rows["conic"][idx] = np.stack([1 / rad ** 2, np.zeros(len(idx)),
                                   1 / rad ** 2], 1)


def tile_count_rows(case: str, seed: int = 0) -> dict:
    """The case's rows: mean2d [N, 2], conic [N, 3], opac [N] float32,
    tile_min, tile_max [N, 2] and num_tiles_bbox [N] int32."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}")
    rng = np.random.default_rng([seed, CASES.index(case)])
    n = N_ROWS
    mean, conic, opac, cov_diag = _splats(rng, n)
    tmin, tmax, count = _bbox(mean, cov_diag, opac)
    count[rng.random(n) < 0.03] = 0
    rows = dict(mean2d=mean, conic=conic, opac=opac, tile_min=tmin,
                tile_max=tmax, num_tiles_bbox=count)
    if case == "bbox_counts":
        shapes = [(1, 1, 0), (1, 1, 1), (31, 1, 31), (1, 31, 31), (8, 4, 32),
                  (4, 8, 32), (11, 3, 33), (3, 11, 33), (12, 10, 120),
                  (50, 3, 150)]
        for k, (wide, high, cnt) in enumerate(shapes):
            idx = np.arange(k, n, len(shapes))
            _place(rng, rows, idx, np.full(len(idx), wide),
                   np.full(len(idx), high), np.full(len(idx), cnt))
    elif case == "bbox_widths":
        idx = np.arange(0, n, 2)
        _place(rng, rows, idx, np.ones(len(idx), np.int64),
               rng.integers(1, 41, len(idx)))
        idx = np.arange(1, n, 2)
        _place(rng, rows, idx, rng.integers(40, 61, len(idx)),
               rng.integers(1, 4, len(idx)))
    elif case == "means_on_edges":
        edge = rng.integers(0, 34, (n, 2)) * TILE
        pick = rng.integers(0, 3, n)
        rows["mean2d"] = np.where(pick[:, None] == 0, edge,
                                  np.where(pick[:, None] == 1,
                                           np.stack([edge[:, 0],
                                                     mean[:, 1]], 1),
                                           np.stack([mean[:, 0],
                                                     edge[:, 1]], 1)))
        rad = rng.uniform(1.0, 40.0, n)
        rows["conic"] = np.stack([1 / rad ** 2, np.zeros(n), 1 / rad ** 2],
                                 1)
        rows["conic"][::4, 1] = 0.3 / rad[::4] ** 2
        lo = np.clip(rows["mean2d"] // TILE - 1, 0, None).astype(np.int32)
        wide = rng.integers(1, 6, (n, 2))
        rows["tile_min"], rows["tile_max"] = lo, (lo + wide).astype(np.int32)
        rows["num_tiles_bbox"] = (wide[:, 0] * wide[:, 1]).astype(np.int32)
    elif case == "zero_den":
        which = np.arange(n) % 3
        rows["conic"][which == 0, 0] = 0.0
        rows["conic"][which == 1, 2] = 0.0
        rows["conic"][which == 2, 0] = 0.0
        rows["conic"][which == 2, 2] = 0.0
    elif case == "nonfinite_culled":
        bad = np.arange(0, n, 3)
        vals = np.array([np.nan, np.inf, -np.inf])
        rows["conic"][bad] = vals[rng.integers(0, 3, (len(bad), 3))]
        rows["num_tiles_bbox"][bad] = 0
    elif case == "all_dead":
        rows["num_tiles_bbox"][:] = 0
        rows["mean2d"][::5] = np.nan
        rows["conic"][1::5] = np.inf
        rows["opac"][2::5] = 0.0
    return dict(mean2d=rows["mean2d"].astype(np.float32),
                conic=rows["conic"].astype(np.float32),
                opac=rows["opac"].astype(np.float32),
                tile_min=rows["tile_min"].astype(np.int32),
                tile_max=rows["tile_max"].astype(np.int32),
                num_tiles_bbox=rows["num_tiles_bbox"].astype(np.int32))


def projected_fields(rows: dict, n_sh: int = 3) -> dict:
    """Every field of a ProjectedSplats (numpy, either package's field
    names): the case's rows, the rest zeros."""
    n = rows["mean2d"].shape[0]
    out = dict(visible=rows["num_tiles_bbox"] > 0,
               depth=np.ones(n, np.float32),
               color=np.zeros((n, n_sh), np.float32),
               power_threshold=np.log(np.maximum(rows["opac"], 1e-30)
                                      * np.float32(255.0)).astype(np.float32),
               max_radius=np.zeros(n, np.float32))
    out.update(rows)
    return out
