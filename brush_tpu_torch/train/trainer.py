"""Training step: render -> fused loss -> backward -> AdamScaled -> noise
(port of `brush_tpu/train/trainer.py`; the reference is
SplatTrainer::step, brush-train/src/train.rs:157-412).

One step is a plain function over an explicit `TrainState` of tensors:

* five `adam_step` calls (means, quats, log_scales, SH with DC/rest LR
  scaling and a reduced second moment, opacity);
* the refine-weight gradient, the visibility mask and the max-radius
  statistics accumulate into `RefineRecord` (brush-train/src/stats.rs:7-63);
* the opacity-gated mean noise (train.rs:367-399) and the background noise
  draw from the state's `torch.Generator`, which replaces the JAX PRNG
  key: the two give different numbers from the same seed, so the two
  samplings sit in two small functions (`sample_background_noise`,
  `sample_mean_noise`) that a test can replace with the other package's
  samples.

Nothing in a step reads a value back to the host: the capacity-overflow
gate is a `torch.where` over the new and the old state, and the step
counter is a tensor. The step is functional (new tensors out, the old state
untouched), as in the JAX package.

`batched=True` takes views with a leading axis (`stack_batches`): the loss
is the mean over the views, rendered one after another on one device, and
the refine statistics are those of one view a step (the holder gradients
times B, the render statistics max-combined). With an `lpips_model`
(models/lpips.py) and `tcfg.lpips_loss_weight > 0`, each view's loss gains
`lpips_loss_weight * LPIPS(render, ground truth)` (train.rs:246-253).

Several processes share one batched step through a `ViewShare`: each
renders its own rows of the step's views (a process may render none),
and the share's `reduce` sums the gradients and the loss and max-combines
the render statistics across the processes before the optimizer
(parallel/data_parallel.py). On one device the share covers every view
and reduces nothing, so the one-device and the multi-device step are this
one function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from brush_tpu_torch.models.splats import Splats
from brush_tpu_torch.ops.loss import (
    ImageLossConfig,
    image_loss,
    unpack_gt_rgb,
)
from brush_tpu_torch.ops.projection import CameraInputs
from brush_tpu_torch.ops.sh import num_sh_coeffs
from brush_tpu_torch.render import RenderAux, RenderConfig, render_with_refine
from brush_tpu_torch.train import refine as refine_mod
from brush_tpu_torch.train.adam_scaled import (
    AdamParamState,
    adam_step,
    init_state,
)
from brush_tpu_torch.train.config import TrainConfig
from brush_tpu_torch.utils.device import device_constant
from brush_tpu_torch.utils.tracing import stage


@dataclasses.dataclass
class RefineRecord:
    """Per-splat accumulators between refines (stats.rs:7-63)."""

    refine_weight: torch.Tensor  # [cap] max of per-step refine weights
    visible_count: torch.Tensor  # [cap] sum of visibility
    max_radius: torch.Tensor     # [cap] max screen-fraction radius

    @classmethod
    def zeros(cls, cap: int, device="cuda") -> "RefineRecord":
        def z():
            return torch.zeros((cap,), dtype=torch.float32, device=device)
        return cls(refine_weight=z(), visible_count=z(), max_radius=z())

    def gather_stats(self, refine_weight, visible,
                     max_radius) -> "RefineRecord":
        return RefineRecord(
            refine_weight=torch.maximum(self.refine_weight, refine_weight),
            visible_count=self.visible_count + visible,
            max_radius=torch.maximum(self.max_radius, max_radius),
        )


@dataclasses.dataclass
class TrainState:
    splats: Splats
    opt: dict[str, AdamParamState]
    refine: RefineRecord
    step: torch.Tensor           # [] int32
    rng: torch.Generator         # on the splats' device
    median_scale: torch.Tensor   # [] f32, bounds.median_size() (train.rs:185)
    bounds_center: torch.Tensor | None = None   # [3] percentile-0.8 bounds
    bounds_extent: torch.Tensor | None = None   # [3]


class SceneBatch(NamedTuple):
    """One training view (brush-dataset/src/scene.rs SceneBatch). The
    alpha-mode flags are passed to train_step directly."""

    gt_packed: torch.Tensor      # [H, W] packed RGBA words (ops/loss.py)
    cam: CameraInputs


def stack_batches(batches: list[SceneBatch]) -> SceneBatch:
    """Per-view batches -> one batch with a leading [B] axis on every
    field (the fisheye bound becomes a [B] tensor)."""
    cams = [b.cam for b in batches]
    dev = batches[0].gt_packed.device
    return SceneBatch(
        gt_packed=torch.stack([b.gt_packed for b in batches]),
        cam=CameraInputs(
            *(torch.stack([getattr(c, f) for c in cams])
              for f in ("viewmat", "pinhole", "clamp_limits", "cam_pos")),
            half_max_render_fov=device_constant(
                [float(c.half_max_render_fov) for c in cams], dev)))


def _view_of(batch: SceneBatch, v: int) -> SceneBatch:
    """View `v` of a stacked batch."""
    c = batch.cam
    return SceneBatch(gt_packed=batch.gt_packed[v], cam=CameraInputs(
        c.viewmat[v], c.pinhole[v], c.clamp_limits[v], c.cam_pos[v],
        c.half_max_render_fov[v]))


def _local(grads, loss, aux):
    """The reduction of a step that one process takes alone: none."""
    return grads, loss, aux


class ViewShare(NamedTuple):
    """The views of one step that this process renders: rows [first,
    first + count) of the step's `total` views (count None: the batch's
    leading size; 0: none, the process adds zeros). `reduce(grads, loss,
    aux) -> (grads, loss, aux)` sums the processes' gradients (a list of
    tensors) and loss and max-combines their render statistics; every
    process gets the same result. `group` is the process group that
    reduces (None: this process alone)."""

    first: int
    total: int
    reduce: Callable = _local
    count: int | None = None
    group: object = None


def _zero_aux(n: int, device) -> RenderAux:
    """The render statistics of no view: zeros, which leave every sum and
    maximum of the statistics (all >= 0) as they are."""
    def z():
        return torch.zeros((), dtype=torch.int32, device=device)
    return RenderAux(
        num_visible=z(), num_isects=z(), num_bbox_tail=z(),
        max_isects_per_tile=z(),
        visible=torch.zeros((n,), dtype=torch.float32, device=device),
        max_radius=torch.zeros((n,), dtype=torch.float32, device=device),
        num_chunks=z())


def _max_aux(auxs: list[RenderAux]) -> RenderAux:
    """Render statistics of B views, max-combined (the JAX package's
    batched aux)."""
    def mx(name):
        return torch.stack([getattr(a, name) for a in auxs]).amax(dim=0)
    return RenderAux(
        num_visible=mx("num_visible"), num_isects=mx("num_isects"),
        num_bbox_tail=mx("num_bbox_tail"),
        max_isects_per_tile=mx("max_isects_per_tile"),
        visible=mx("visible"), max_radius=mx("max_radius"),
        num_chunks=(mx("num_chunks") if auxs[0].num_chunks is not None
                    else None))


class TrainStepStats(NamedTuple):
    loss: torch.Tensor
    num_visible: torch.Tensor
    lr_mean: torch.Tensor
    # [] bool: intersection/chunk capacity overflowed this step. The step is
    # then a device-side NO-OP (params/moments/refine kept) so a truncated
    # gradient can never be applied; the host grows the capacities.
    overflowed: torch.Tensor | None = None


def init_train_state(splats: Splats, rng: int | torch.Generator,
                     median_scale: float | torch.Tensor | None = None,
                     ) -> TrainState:
    """Build a fresh train state on the splats' device. `rng` is a seed or
    a generator on that device. Bounds (and hence the median scale that
    multiplies the mean LR, train.rs:185) come from the live splat means at
    percentile 0.8 unless `median_scale` overrides them."""
    dev = splats.means.device
    if not isinstance(rng, torch.Generator):
        seed = int(rng)
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
    opt = {
        "means": init_state(splats.means),
        "quats": init_state(splats.quats),
        "log_scales": init_state(splats.log_scales),
        "sh_coeffs": init_state(splats.sh_coeffs, reduce_moment_2=True),
        "raw_opacities": init_state(splats.raw_opacities),
    }
    center, extent = refine_mod._percentile_bounds(
        splats.means, splats.alive_mask(), 0.8)
    med = (torch.as_tensor(median_scale, dtype=torch.float32, device=dev)
           if median_scale is not None else refine_mod.median_size(extent))
    return TrainState(
        splats=splats,
        opt=opt,
        refine=RefineRecord.zeros(splats.capacity, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        rng=rng,
        median_scale=med,
        bounds_center=center,
        bounds_extent=extent,
    )


def _sh_lr_scaling(n_coeffs: int, rest_scale: float, device) -> torch.Tensor:
    """DC full LR; higher bands lr/rest_scale (train.rs:380-391)."""
    s = torch.full((1, n_coeffs, 1), 1.0 / rest_scale, dtype=torch.float32,
                   device=device)
    s[:, 0] = 1.0
    return s


def sample_background_noise(rng: torch.Generator, n_views: int,
                            strength: float, device) -> torch.Tensor:
    """[n_views, 3] uniform in [-strength, strength)."""
    u = torch.rand((n_views, 3), generator=rng, dtype=torch.float32,
                   device=device)
    return (2.0 * u - 1.0) * strength


def sample_mean_noise(rng: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal samples for the mean noise injection."""
    return torch.randn(tuple(shape), generator=rng, dtype=torch.float32,
                       device=device)


def train_step(
    state: TrainState,
    batch: SceneBatch,
    tcfg: TrainConfig,
    rcfg: RenderConfig,
    has_alpha: bool = False,
    alpha_is_mask: bool = False,
    lpips_model=None,
) -> tuple[TrainState, TrainStepStats, RenderAux]:
    """One single-view training step (reference semantics)."""
    return train_step_impl(state, batch, tcfg, rcfg,
                           has_alpha=has_alpha, alpha_is_mask=alpha_is_mask,
                           batched=False, lpips_model=lpips_model)


def _gate(overflowed, new, old):
    """`old` where the step overflowed, else `new`, over dataclasses and
    dicts of tensors (None and non-tensor fields pass through)."""
    if torch.is_tensor(new):
        return torch.where(overflowed, old, new)
    if isinstance(new, dict):
        return {k: _gate(overflowed, new[k], old[k]) for k in new}
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: _gate(overflowed, getattr(new, f.name),
                          getattr(old, f.name))
            for f in dataclasses.fields(new)})
    return new


def train_step_impl(
    state: TrainState,
    batch: SceneBatch,
    tcfg: TrainConfig,
    rcfg: RenderConfig,
    has_alpha: bool = False,
    alpha_is_mask: bool = False,
    batched: bool = False,
    lpips_model=None,
    share: ViewShare | None = None,
) -> tuple[TrainState, TrainStepStats, RenderAux]:
    """One training step. With `batched=True` the batch carries a leading
    view axis [B] (`stack_batches`) and the loss is the mean over views.
    With a `share` (batched only), the batch holds this process's rows of
    the step's `share.total` views and `share.reduce` combines the
    processes' gradients, loss and statistics."""
    if rcfg.forward_only:
        raise ValueError("train_step needs a differentiable render: "
                         "RenderConfig(forward_only=False)")
    splats = state.splats
    dev = splats.means.device
    n_local = batch.gt_packed.shape[0] if batched else 1
    share = share or ViewShare(first=0, total=n_local)

    # Background: base + uniform noise, clamped (config background_noise).
    # Every process draws the rows of all the step's views from its copy
    # of the generator and keeps its own, so the replicas stay equal.
    base_bg = device_constant(tcfg.background_color, dev)
    bgs = torch.clamp(
        base_bg + sample_background_noise(
            state.rng, share.total, tcfg.background_noise_strength, dev),
        0.0, 1.0)[share.first:share.first + n_local]

    params = {k: v.detach().requires_grad_(True)
              for k, v in splats.params().items()}
    refine_holder = torch.zeros((splats.capacity,), dtype=torch.float32,
                                device=dev, requires_grad=True)
    visible_holder = torch.zeros((splats.capacity,), dtype=torch.float32,
                                 device=dev, requires_grad=True)

    ssim_enabled = tcfg.ssim_weight > 0.0
    l1_w, ssim_w = ((1.0 - tcfg.ssim_weight, -tcfg.ssim_weight)
                    if ssim_enabled else (1.0, 0.0))
    do_alpha_match = (has_alpha and not alpha_is_mask
                      and tcfg.match_alpha_weight > 0.0)
    composite = has_alpha  # bg noise makes bg != 0 almost surely

    def view_loss(view: SceneBatch, bg):
        rendered = splats.with_params(params).fold_min_scale()
        img, aux = render_with_refine(
            rendered.means, rendered.log_scales, rendered.quats,
            rendered.sh_coeffs, rendered.raw_opacities,
            view.cam, bg, rcfg, refine_holder, visible_holder)
        with stage("loss", device=True):
            pred = img if do_alpha_match else img[..., :3]
            # Compositing folds gt + (1-a)*bg inside the loss
            # (train.rs:215-218).
            lcfg = ImageLossConfig(
                l1_weight=l1_w, ssim_weight=ssim_w, composite_bg=None,
                mask=alpha_is_mask, alpha_match=do_alpha_match)
            loss = image_loss(pred, view.gt_packed, lcfg,
                              tcfg.match_alpha_weight,
                              bg_dyn=bg if composite else None)
        if lpips_model is not None and tcfg.lpips_loss_weight > 0.0:
            # Optional perceptual term (train.rs:246-253; weight 0 default).
            with stage("lpips", device=True):
                gt_rgb = unpack_gt_rgb(view.gt_packed,
                                       bg if composite else None)
                loss = loss + tcfg.lpips_loss_weight * lpips_model(
                    img[None, ..., :3], gt_rgb[None])
        return loss, aux

    names = list(params)
    wrt = [params[k] for k in names] + [refine_holder, visible_holder]
    if batched and n_local == 0:
        # A process with none of the step's views (the step's views are
        # shared by gcd(B, W) processes): zeros for the sums and maxima.
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        aux = _zero_aux(splats.capacity, dev)
        grads = [torch.zeros_like(x) for x in wrt]
    else:
        if batched:
            # This process's part of the mean over all the step's views:
            # the parts' sum is the mean, so their gradients sum to its
            # gradient.
            losses, auxs = zip(*(view_loss(_view_of(batch, v), bgs[v])
                                 for v in range(n_local)))
            loss = torch.stack(losses).sum() / float(share.total)
            aux = _max_aux(list(auxs))
        else:
            loss, aux = view_loss(batch, bgs[0])
        with stage("backward", device=True):
            grads = torch.autograd.grad(loss, wrt)
    # Sum the gradients and the loss, max the statistics, across the
    # processes of the step, before anything reads them (the overflow
    # gate included, so every process takes the same branch).
    grads, loss, aux = share.reduce(list(grads), loss.detach(), aux)
    param_grads = dict(zip(names, grads[:len(names)]))
    refine_weight, visible_grad = grads[len(names):]

    with stage("adam", device=True), torch.no_grad():
        # The batched loss is a mean over views: undo the 1/B factor so the
        # refine statistics accumulate as one view a step does.
        if share.total > 1:
            refine_weight = refine_weight * float(share.total)
            visible_grad = visible_grad * float(share.total)
        visible = torch.clamp(visible_grad, 0.0, 1.0)

        # --- Learning rates (train.rs:311-364) ---
        decay = tcfg.mean_lr_decay()
        lr_mean = (tcfg.lr_mean * decay ** state.step.to(torch.float32)
                   ) * state.median_scale
        lrs = {
            "means": lr_mean,
            "quats": tcfg.lr_rotation,
            "log_scales": tcfg.lr_scale,
            "raw_opacities": tcfg.lr_opac,
            "sh_coeffs": tcfg.lr_coeffs_dc,
        }
        sh_scaling = _sh_lr_scaling(num_sh_coeffs(splats.sh_degree),
                                    tcfg.lr_coeffs_sh_scale, dev)
        opt = dict(state.opt)
        new_params = {}
        for name in names:
            scaling = sh_scaling if name == "sh_coeffs" else None
            new_params[name], opt[name] = adam_step(
                params[name].detach(), param_grads[name], opt[name],
                lrs[name], scaling)
        new_splats = splats.with_params(new_params)

        # --- Opacity-gated mean noise injection (train.rs:367-399) ---
        folded = new_splats.fold_min_scale()
        inv_opac = 1.0 - torch.sigmoid(folded.raw_opacities)
        noise_weight = torch.clamp(inv_opac ** 150.0, 0.0, 1.0) * visible
        samples = sample_mean_noise(state.rng, new_splats.means.shape, dev)
        noise = samples * (noise_weight * lr_mean
                           * tcfg.mean_noise_weight)[:, None]
        noise = torch.maximum(torch.minimum(noise, state.median_scale),
                              -state.median_scale)
        new_splats = dataclasses.replace(new_splats,
                                         means=new_splats.means + noise)

        refine = state.refine.gather_stats(refine_weight, visible,
                                           aux.max_radius)

        # Capacity-overflow no-op gate: an overflowing step truncates slots
        # (the binning masks them to the sentinel), losing their gradients;
        # such an update is never applied. step and rng still advance so the
        # run keeps moving while the host grows capacities. The port's
        # backward has no chunk buffer, but the chunk comparison stays, so
        # both packages skip the same steps for the same config.
        overflowed = aux.num_isects > rcfg.isect_cap
        if aux.num_chunks is not None:
            overflowed = overflowed | (
                aux.num_chunks > rcfg.resolved_chunk_cap(splats.capacity))

        new_state = dataclasses.replace(
            state,
            splats=_gate(overflowed, new_splats, state.splats),
            opt=_gate(overflowed, opt, state.opt),
            refine=_gate(overflowed, refine, state.refine),
            step=state.step + 1)
    stats = TrainStepStats(loss=loss, num_visible=aux.num_visible,
                           lr_mean=lr_mean, overflowed=overflowed)
    return new_state, stats, aux
