"""The comparison fails a run whose timed path is broken underneath: each
fault the cells can have, planted in the port, with the look for a card
skipped (tiny cells on the CPU)."""

import pytest

from portbench.run import verdict
from portbench.tests.tiny import tiny_cell


def run_tiny(name):
    cell, config = tiny_cell(name)
    kind = __import__(f"portbench.traffic.{cell['traffic_kind']}",
                      fromlist=["run"])
    return kind.run(cell, config, 2 ** 32 + 99, 3.0, False, device="cpu")


def altered_tile(real):
    def fn(img):
        out = real(img).clone()
        out[8:24, 16:32] = 255 - out[8:24, 16:32]
        return out
    return fn


def half_frame(real):
    def fn(img):
        out = real(img).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return fn


@pytest.mark.parametrize("fault", [altered_tile, half_frame])
def test_view_faults(monkeypatch, fault):
    from brush_tpu_torch.viewer import service
    monkeypatch.setattr(service, "frame_u8", fault(service.frame_u8))
    assert not verdict(run_tiny("view-1m-1080p")["compared"])


def test_train_state_unchanged(monkeypatch):
    import dataclasses

    from brush_tpu_torch import process
    real = process.train_step_impl

    def unchanged(state, *a, **k):
        _, stats, aux = real(state, *a, **k)
        return dataclasses.replace(state, step=state.step + 1), stats, aux
    monkeypatch.setattr(process, "train_step_impl", unchanged)
    assert not verdict(run_tiny("train-1m-1080p")["compared"])


def test_train_half_the_pixels_in_the_mean(monkeypatch):
    from brush_tpu_torch.train import trainer
    real = trainer.image_loss

    def half(pred, gt, cfg, *a, **k):
        h = pred.shape[0] // 2
        return real(pred[:h], gt[:h], cfg, *a, **k)
    monkeypatch.setattr(trainer, "image_loss", half)
    assert not verdict(run_tiny("train-1m-1080p")["compared"])


def test_train_answer_altered(monkeypatch):
    """Gradients altered where the backward hands them on: those of the
    first eighth of the rows zeroed."""
    from brush_tpu_torch.train import trainer
    real = trainer.adam_step

    def altered(param, grad, *a, **k):
        grad = grad.clone()
        grad[:grad.shape[0] // 8] = 0.0
        return real(param, grad, *a, **k)
    monkeypatch.setattr(trainer, "adam_step", altered)
    assert not verdict(run_tiny("train-1m-1080p")["compared"])
