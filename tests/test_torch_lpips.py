"""LPIPS of `brush_tpu_torch` (models/lpips.py) and its term in the
training step, on the CPU, against the JAX package.

  * Mirrors of tests/test_lpips.py: identity, symmetry and positivity, the
    tap shapes, the independent float64 numpy forward of that file on the
    same deterministic weights (within 1e-5 relative), and the term
    changing the loss of a training step.
  * `random_lpips(0)` of both packages holds the same weights and gives the
    same value at 64x64 within 1e-5 relative, and the gradient w.r.t. the
    prediction within 1e-4 of its largest entry (the two compute the
    convolutions in float32 in different orders: measured 0 and 1.1e-5).
  * An `.npz` written in the JAX package's layout (HWIO) loads into the
    port (OIHW), and the JAX package loads the same file.
  * One `train_step` with `lpips_loss_weight=0.5`, noise off, against the
    JAX step under tests/test_torch_loss.py's rules (loss within
    LOSS_RTOL, moments, parameters and refine record by
    `_assert_step_matches`) at the rtol `STEP_RTOL` explains; and `train_process` reads `ProcessConfig.lpips_weights`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brush_tpu.models import lpips as jlpips
from brush_tpu.train.config import TrainConfig as JTrainConfig
from tests.test_lpips import _np_lpips
from tests.test_torch_loss import (
    JRCFG,
    LOSS_RTOL,
    _assert_step_matches,
    _both_states,
    _setup,
)

from brush_tpu_torch import convert
from brush_tpu_torch.models import lpips as tlpips
from brush_tpu_torch.train import trainer as ttrainer

CPU = "cpu"

# The LPIPS gradient w.r.t. the image passes back through 2x2 max pools, and
# where a window's largest values are equal up to rounding, float32 rounding
# decides which pixel takes the gradient (on a linear ramp two of 65,536
# first-block windows pick another pixel in float32 than in float64, and
# the image gradient moves by 4.9 % of its largest entry). On the render of
# tests/test_torch_loss.py's scene the two packages' LPIPS image gradients
# differ by 22 % of their largest entry, each 25-28 % from a float64
# evaluation. Summed back to the splats this moved the means' first moment
# by 5.1e-5 of its largest entry and the refine weight, a sum of per-pixel
# gradient norms that nothing cancels, by 4.8e-4 of its largest (the rule
# gives it 2 * rtol). So this step gets rtol 2.5e-4 where the step without
# the term gets 5e-5.
STEP_RTOL = 2.5e-4


def imgs(size=64):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    return a, b


def _t(x):
    return torch.from_numpy(x)


# --------------------------------------------------------------------------
# mirrors of tests/test_lpips.py
# --------------------------------------------------------------------------


def test_identity_is_zero():
    m = tlpips.random_lpips(device=CPU)
    a, _ = imgs()
    assert abs(float(m(_t(a), _t(a)))) < 1e-6


def test_symmetry_and_positive():
    m = tlpips.random_lpips(device=CPU)
    a, b = imgs()
    d_ab = float(m(_t(a), _t(b)))
    d_ba = float(m(_t(b), _t(a)))
    assert d_ab > 0
    assert abs(d_ab - d_ba) < 1e-6


def test_numeric_parity_vs_numpy_oracle():
    """The port against the independent float64 numpy forward of
    tests/test_lpips.py, on the deterministic weights of seed 7."""
    params = tlpips.random_lpips_arrays(7)
    m = tlpips.lpips_from_numpy(params, device=CPU)
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    want = _np_lpips(params, a, b)
    got = float(m(_t(a)[None], _t(b)[None]))
    assert want > 0.01  # non-degenerate fixture
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_feature_tap_shapes():
    m = tlpips.random_lpips(device=CPU)
    a, _ = imgs()
    taps = m.features(_t(a))
    assert [t.shape[1] for t in taps] == [64, 128, 256, 512, 512]
    assert [t.shape[-1] for t in taps] == [64, 32, 16, 8, 4]


def test_lpips_term_in_train_step():
    """The term changes the step's loss (train.rs:246-253; weight 0 by
    default) and leaves it finite."""
    splats, _, tbatch = _setup()
    m = tlpips.random_lpips(device=CPU)
    losses = {}
    for w, model in [(0.0, None), (0.5, m)]:
        tcfg = convert.train_config_from(
            JTrainConfig(total_train_iters=10, lpips_loss_weight=w))
        state = ttrainer.init_train_state(
            convert.splats_from_arrays(splats, device=CPU), 0, 3.0)
        rcfg = convert.render_config_from(JRCFG, use_pallas=True)
        _, stats, _ = ttrainer.train_step(state, tbatch, tcfg, rcfg,
                                          lpips_model=model)
        losses[w] = float(stats.loss)
    assert np.isfinite(losses[0.5])
    assert losses[0.5] != losses[0.0]


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------


def test_random_lpips_matches_jax():
    jm = jlpips.random_lpips(0)
    tm = tlpips.random_lpips(0, device=CPU)
    for group, leaves in jm.params.items():
        for leaf, w in leaves.items():
            w = np.asarray(w)
            if leaf == "w":
                w = w.transpose(3, 2, 0, 1)
            got = tm._p(f"{group}/{leaf}").numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, w, err_msg=f"{group}/{leaf}")
    a, b = imgs()
    want = float(jm(jnp.asarray(a), jnp.asarray(b)))
    x = _t(a).requires_grad_(True)
    value = tm(x, _t(b))
    (grad,) = torch.autograd.grad(value, x)
    assert abs(float(value.detach()) - want) <= 1e-5 * abs(want)
    jgrad = np.asarray(jax.grad(lambda p: jm(p, jnp.asarray(b)))(
        jnp.asarray(a)))
    assert np.abs(grad.numpy() - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


def test_npz_in_the_jax_layout_loads(tmp_path):
    params = tlpips.random_lpips_arrays(4)
    path = tmp_path / "lpips.npz"
    tlpips.save_lpips_npz(params, path)
    with np.load(path) as f:                      # the JAX package's keys
        assert sorted(f.files) == sorted(tlpips._param_names())
    got = tlpips.load_lpips(path, device=CPU)
    want = tlpips.lpips_from_numpy(params, device=CPU)
    jm = jlpips.load_lpips(path)
    assert set(jm.params) == {name.split("/")[0]
                              for name in tlpips._param_names()}
    assert jm.params["conv_0_0"]["w"].shape == (3, 3, 3, 64)
    assert got._p("conv_0_0/w").shape == (64, 3, 3, 3)
    assert got._p("lin_4/w").shape == (1, 512, 1, 1)
    for name in tlpips._param_names():
        assert torch.equal(got._p(name), want._p(name)), name
    a, b = imgs()
    v = float(got(_t(a), _t(b)))
    assert v == float(want(_t(a), _t(b)))
    assert abs(v - float(jm(jnp.asarray(a), jnp.asarray(b)))) <= 1e-5 * v


def test_train_step_with_lpips_matches_jax():
    """One step with the LPIPS term at weight 0.5 (noise off) against the
    JAX step with the same random weights."""
    from brush_tpu.train import trainer as jtrainer
    splats, jbatch, tbatch = _setup()
    jtcfg = JTrainConfig(total_train_iters=100, background_noise_strength=0.0,
                         mean_noise_weight=0.0, lpips_loss_weight=0.5,
                         background_color=(0.1, 0.2, 0.3))
    jm = jlpips.random_lpips(0)
    tm = tlpips.random_lpips(0, device=CPU)
    jstate, tstate = _both_states(splats, 0)
    js2, jstats, _ = jax.jit(lambda s, b: jtrainer.train_step(
        s, b, jtcfg, JRCFG, lpips_model=jm))(jstate, jbatch)
    ts2, tstats, _ = ttrainer.train_step(
        tstate, tbatch, convert.train_config_from(jtcfg),
        convert.render_config_from(JRCFG, use_pallas=True), lpips_model=tm)
    want_no_term = float(jax.jit(lambda s, b: jtrainer.train_step(
        s, b, jtcfg, JRCFG))(jstate, jbatch)[1].loss)
    # The term is a visible share of the loss, so the check has teeth.
    assert float(jstats.loss) > want_no_term * 1.05
    assert abs(float(tstats.loss) - float(jstats.loss)) <= LOSS_RTOL * abs(
        float(jstats.loss))
    lrs = dict(means=float(jstats.lr_mean), quats=jtcfg.lr_rotation,
               log_scales=jtcfg.lr_scale, sh_coeffs=jtcfg.lr_coeffs_dc,
               raw_opacities=jtcfg.lr_opac)
    _assert_step_matches(js2, ts2, jstate, lrs, rtol=STEP_RTOL)


def test_train_process_reads_lpips_weights(tmp_path, monkeypatch):
    """`ProcessConfig.lpips_weights` goes through `load_lpips` onto the run's
    device, and every step gets the model."""
    from tests.test_dataset_formats import write_colmap_bin

    from brush_tpu_torch import process as tprocess
    from brush_tpu_torch.process import ProcessConfig, train_process
    from brush_tpu_torch.train.config import TrainConfig
    write_colmap_bin(tmp_path / "scene", n_views=2, w=64, h=64)
    tlpips.save_lpips_npz(tlpips.random_lpips_arrays(0), tmp_path / "w.npz")
    seen = []
    real = tprocess.train_step_impl

    def step(*a, **k):
        seen.append(k["lpips_model"])
        return real(*a, **k)

    monkeypatch.setattr(tprocess, "train_step_impl", step)
    msgs = list(train_process(
        str(tmp_path / "scene"),
        TrainConfig(total_train_iters=2, lpips_loss_weight=0.5),
        pcfg=ProcessConfig(lpips_weights=str(tmp_path / "w.npz"),
                           log_every=1, eval_every=0, export_every=0,
                           sh_degree=0, init_count=0,
                           export_path=str(tmp_path / "o_{iter}.ply")),
        device=CPU))
    assert len(seen) == 2 and all(isinstance(m, tlpips.LpipsModel)
                                  for m in seen)
    assert seen[0]._p("conv_0_0/w").device.type == CPU
    losses = [m.data["loss"] for m in msgs if m.kind == "step"]
    assert len(losses) == 2 and np.isfinite(losses).all()
