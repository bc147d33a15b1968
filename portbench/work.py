"""The work a frame or a training step needs, from counts the benchmark's
reference takes on the same inputs, and the card's peaks.

Peaks: NVIDIA H100 SXM5 data sheet, dense rates, at its full 700 W power
limit: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. A
card set below 700 W runs slower under load; runs print the card's
`power.limit` beside these.

Operation counts are per element of the algorithm, counted from the
formulas of portbench/reference (an exp, a log, a sqrt or a division
counts as one): what the method needs, whatever implements it. Counts of
the blend are by (pixel, slot) pair: `evaluated` is every pair a pixel
looks at up to the slot that stops it, `blended` those that add to it.

Bytes of a kernel are its inputs read once and its outputs written once,
at the least the algorithm needs: the slots that exist (not the padded
slot space), the live splats (not the dead rows of a capacity).
"""

from __future__ import annotations

PEAK_FLOPS = 67e12          # float32, non-tensor-core, H100 SXM5 at 700 W
PEAK_BYTES = 3.35e12        # HBM3 bytes/s, H100 SXM5
PEAK_POWER_W = 700.0        # the power limit the data sheet assumes

# Projection of one splat (reference/render.py `project`): camera
# transform 15, scale exp 3, quaternion normalise 12, rotation matrix 30,
# R_cam R_q 45, times S 9, Jacobian 10, J M 30, V V^T 15, blur and conic
# 12, pixel mean 6, sigmoid 3, view direction 11, SH basis to degree 3 30,
# SH sum 96, offset and clamp 9.
PROJECT_OPS = 15 + 3 + 12 + 30 + 45 + 9 + 10 + 30 + 15 + 12 + 6 + 3 + 11 \
    + 30 + 96 + 9
# The blend of a (pixel, slot) pair forward: offsets 2, quadratic form 9,
# exp 1, opacity and cap 2, cutoff tests 2, transmittance 2, weight 1,
# colour accumulate 6, stop test 2 (27, as Brush's rasterize.rs).
BLEND_OPS = 27
# Its backward: the forward's arithmetic replayed (21 of the 27) on every
# evaluated pair, and 54 more on each blended pair (the colour, opacity,
# conic and position gradients with their accumulations).
BLEND_BWD_REPLAY_OPS = 21
BLEND_BWD_OPS = 54
# L1 + SSIM of one pixel (reference/loss.py): 15 moment maps blurred on
# two axes with 11 taps (660), the maps' products 9, SSIM per channel 20
# (60), L1 per channel 3 (9), weighting 6.
LOSS_OPS = 660 + 9 + 60 + 9 + 6
# Reverse-mode derivatives cost about twice their forward.
BACKWARD_FACTOR = 2
# AdamScaled on one element: square, two moments (3 each), two bias
# corrections, sqrt, eps, divide, learning rate, update.
ADAM_OPS = 13
# Floats a splat carries at SH degree 3: means 3, quats 4, log-scales 3,
# SH 48, opacity 1.
PARAMS_PER_SPLAT = 59

# Bytes a slot carries through the binning kernels: the diet's 6 words
# (packed position, conic, colour and opacity) for a frame; the training
# layout's 10 (9 payload words and the splat id).
DIET_SLOT_BYTES = 24
TRAIN_SLOT_BYTES = 40
KEY_BYTES = 8               # a slot's sort key
TABLE_BYTES = 68            # a splat's 17 emission-table words
PIXEL_OUT_BYTES = 16        # a float32 RGBA pixel
RANGE_BYTES = 8             # a tile's slot range
GRAD_OUT_BYTES = 44         # a splat's 11 gradient words


def _least(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def frame_work(c: dict) -> dict:
    """A served frame: `c` holds n_live, n_visible, pixels, tiles, slots,
    evaluated, blended. Returns the frame's FLOPs and, per kernel of the
    program, its least seconds."""
    flops = c["n_live"] * PROJECT_OPS + c["evaluated"] * BLEND_OPS
    kernels = {
        "rasterize_fwd": _least(
            c["evaluated"] * BLEND_OPS,
            c["slots"] * DIET_SLOT_BYTES + c["tiles"] * RANGE_BYTES
            + c["pixels"] * PIXEL_OUT_BYTES),
        "emit": _least(0, c["n_visible"] * TABLE_BYTES
                       + c["slots"] * (KEY_BYTES + DIET_SLOT_BYTES)),
        "scan": _least(0, 8 * c["n_live"]),
        "stack": _least(0, 2 * c["slots"] * DIET_SLOT_BYTES),
    }
    return dict(flops=flops, kernel_least_s=kernels)


def step_work(c: dict) -> dict:
    """A training step of one view; `c` as `frame_work`'s."""
    fwd = (c["n_live"] * PROJECT_OPS + c["pixels"] * LOSS_OPS)
    flops = (fwd * (1 + BACKWARD_FACTOR)
             + c["evaluated"] * (BLEND_OPS + BLEND_BWD_REPLAY_OPS)
             + c["blended"] * BLEND_BWD_OPS
             + c["n_live"] * PARAMS_PER_SPLAT * ADAM_OPS)
    slot_in = c["slots"] * TRAIN_SLOT_BYTES
    kernels = {
        "rasterize_fwd_train": _least(
            c["evaluated"] * BLEND_OPS,
            slot_in + c["tiles"] * RANGE_BYTES
            + c["pixels"] * PIXEL_OUT_BYTES),
        "rasterize_bwd": _least(
            c["evaluated"] * BLEND_BWD_REPLAY_OPS
            + c["blended"] * BLEND_BWD_OPS,
            slot_in + c["tiles"] * RANGE_BYTES
            + c["pixels"] * PIXEL_OUT_BYTES
            + c["n_visible"] * GRAD_OUT_BYTES),
        "emit": _least(0, c["n_visible"] * TABLE_BYTES
                       + c["slots"] * (KEY_BYTES + TRAIN_SLOT_BYTES)),
        "scan": _least(0, 2 * 8 * c["n_live"]),
        "stack": _least(0, 2 * slot_in),
    }
    return dict(flops=flops, kernel_least_s=kernels)
