"""work.py against a count by hand at a tiny size."""

import pytest

from portbench import work


def test_peaks_are_the_data_sheet_at_700_w():
    assert work.PEAK_FLOPS == 67e12
    assert work.PEAK_BYTES == 3.35e12
    assert work.PEAK_POWER_W == 700.0


C = dict(n_live=10, n_visible=8, pixels=64, tiles=2, slots=20,
         evaluated=300, blended=100)


def test_frame_work_by_hand():
    w = work.frame_work(C)
    assert work.PROJECT_OPS == 336
    assert w["flops"] == 10 * 336 + 300 * 27
    k = w["kernel_least_s"]
    # 8100 ops against 20*24 + 2*8 + 64*16 = 1520 bytes.
    assert k["rasterize_fwd"] == pytest.approx(
        max(300 * 27 / 67e12, 1520 / 3.35e12))
    assert k["emit"] == pytest.approx((8 * 68 + 20 * 32) / 3.35e12)
    assert k["scan"] == pytest.approx(80 / 3.35e12)
    assert k["stack"] == pytest.approx(960 / 3.35e12)


def test_step_work_by_hand():
    w = work.step_work(C)
    fwd = 10 * 336 + 64 * 744
    assert work.LOSS_OPS == 744
    assert w["flops"] == (3 * fwd + 300 * 48 + 100 * 54 + 10 * 59 * 13)
    k = w["kernel_least_s"]
    assert k["rasterize_bwd"] == pytest.approx(max(
        (300 * 21 + 100 * 54) / 67e12,
        (20 * 40 + 2 * 8 + 64 * 16 + 8 * 44) / 3.35e12))
    assert k["scan"] == pytest.approx(160 / 3.35e12)
    assert k["stack"] == pytest.approx(1600 / 3.35e12)
