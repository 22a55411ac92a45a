"""Training step: sample rays -> render -> loss -> Adam update.

Counterpart of ``dexnerf_tpu/train/step.py`` (the single-device resident-
store step). The loss is the plain, autograd-differentiable render
(``render_rays`` + :func:`nerf_loss`, the counterpart of the XLA path),
the same render through fused fields (``ops.fused_mlp_train``, kernels 2
and 3 on a card) or a fused loss
(``ops.fused_train_loss.make_fused_train_loss``, kernel 4 on a card).
The optimizer is one of JAX's five (:data:`OPTIMIZER_REGISTRY`), each
with optax's update at optax's defaults, its learning rate set before
every update to ``optax.exponential_decay`` evaluated at the number of
updates taken so far, as optax evaluates it (step 0 uses ``lr``).
``steps_per_call`` updates run as a Python loop with no host sync. With
pose refinement (``train/pose_opt.py``) the rays come from a
``ray_source`` and the twists of ``TrainState.pose`` take their own update.
:func:`make_batch_train_step` runs the same update on a batch gathered on
the host (the host-streamed store, ``data/host_store.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.data.pipeline import (
    RayStore,
    per_image_ray_indices,
    take_depth,
    take_ray_batch,
    uniform_ray_indices,
)
from dexnerf_tpu_torch.render.renderer import (
    RenderDraws,
    RenderSettings,
    draw_render_noise,
    render_rays,
)


def exponential_decay_schedule(
    init_lr: float, lr_decay: float, lr_decay_factor: float
) -> Callable[[int], float]:
    """``lr * factor ** (step / (lr_decay * 1000))`` (the reference's
    schedule, ``train_nerf_rgb.py:281-286``), computed in float32 as
    ``optax.exponential_decay(..., staircase=False)`` computes it."""
    transition_steps = int(lr_decay * 1000)
    lr = torch.tensor(init_lr, dtype=torch.float32)
    rate = torch.tensor(lr_decay_factor, dtype=torch.float32)

    def schedule(step: int) -> float:
        p = torch.tensor(step, dtype=torch.float32) / transition_steps
        return float(lr * rate**p)

    return schedule


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` at its defaults, which ``torch.optim.RMSprop``
    does not match (α 0.99, eps outside the root): ``nu = (1 - decay) g² +
    decay nu`` from ``initial_scale`` 0, then ``p += -lr * rsqrt(nu + eps)
    g`` with decay 0.9 and eps 1e-8 inside the root
    (``optax.scale_by_rms``, ``scale_by_learning_rate``). State: ``nu``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                g = p.grad
                nu = (1 - decay) * g ** 2 + decay * st["nu"]
                st["nu"] = nu
                p.add_(-group["lr"] * (torch.rsqrt(nu + eps) * g))


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad`` at its defaults, which ``torch.optim.Adagrad`` does
    not match (accumulator 0, eps 1e-10 outside the root): ``sum = g² +
    sum`` from ``initial_accumulator_value`` 0.1, then ``p += -lr *
    rsqrt(sum + eps) g`` (0 where ``sum`` is 0) with eps 1e-7 inside the
    root (``optax.scale_by_rss``, ``scale_by_learning_rate``). State:
    ``sum``."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "sum" not in st:
                    st["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad
                total = g ** 2 + st["sum"]
                st["sum"] = total
                scale = torch.where(total > 0, torch.rsqrt(total + group["eps"]),
                                    torch.zeros_like(total))
                p.add_(-group["lr"] * (scale * g))


# JAX's five optimizers (dexnerf_tpu/train/step.py:45-51), each at optax's
# defaults, which JAX's make_optimizer keeps (it passes the schedule alone);
# the reference picks one by name, train_nerf_rgb.py:146. torch's Adam and
# SGD (no momentum) are optax's updates; AdamW is too with optax's weight
# decay 1e-4 (both decay by lr * wd * p); RMSprop and Adagrad are not.
OPTIMIZER_REGISTRY: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "Adam": torch.optim.Adam,
    "AdamW": functools.partial(torch.optim.AdamW, weight_decay=1e-4, eps=1e-8),
    "SGD": torch.optim.SGD,
    "RMSprop": OptaxRMSprop,
    "Adagrad": OptaxAdagrad,
}


# the name of the optimizer's parameter group of the SG shading leaves
SG_GROUP = "sg"


@dataclasses.dataclass
class TrainState:
    """The models, their optimizer (of registry name ``opt_type``), its
    learning-rate schedule and the number of updates taken; ``pose``, a
    ``train.pose_opt.PoseState``, when the camera poses are refined; ``sg``,
    the SG shading leaves of ``--sg-ir`` (``render.sg_ir``), a parameter
    group of the same optimizer named :data:`SG_GROUP`."""

    coarse: nn.Module
    fine: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    opt_type: str = "Adam"
    pose: Optional[Any] = None
    sg: Optional[Dict[str, torch.Tensor]] = None

    def models(self) -> List[nn.Module]:
        return [m for m in (self.coarse, self.fine) if m is not None]


def make_optimizer(
    params, lr: float, opt_type: str = "Adam"
) -> torch.optim.Optimizer:
    """The registry's optimizer over ``params`` (tensors, or parameter
    groups) at optax's defaults (Adam's betas/eps 0.9/0.999/1e-8, as
    torch's)."""
    try:
        ctor = OPTIMIZER_REGISTRY[opt_type]
    except KeyError:
        raise KeyError(
            f"unknown optimizer type {opt_type!r}; registered: {sorted(OPTIMIZER_REGISTRY)}"
        ) from None
    return ctor(list(params), lr=lr)


def init_train_state(
    coarse: nn.Module,
    fine: Optional[nn.Module],
    lr: float,
    lr_decay: float = 250.0,
    lr_decay_factor: float = 0.1,
    opt_type: str = "Adam",
    sg: Optional[Dict[str, torch.Tensor]] = None,
) -> TrainState:
    """One optimizer over ``coarse`` then ``fine`` parameters (the
    reference's order, which its ``.ckpt`` Adam state indexes) and, with
    ``sg`` (the SG shading leaves, made to require grad), a second
    parameter group :data:`SG_GROUP` of those leaves under the same
    schedule, as JAX's one optimizer covers ``params["sg"]``."""
    params = list(coarse.parameters()) + (list(fine.parameters()) if fine is not None else [])
    groups = [{"params": params}]
    if sg is not None:
        for leaf in sg.values():
            leaf.requires_grad_(True)
        groups.append({"params": list(sg.values()), "name": SG_GROUP})
    return TrainState(
        coarse=coarse,
        fine=fine,
        optimizer=make_optimizer(groups, lr, opt_type),
        schedule=exponential_decay_schedule(lr, lr_decay, lr_decay_factor),
        opt_type=opt_type,
        sg=sg,
    )


def nerf_loss(result, target_rgb: torch.Tensor, *, supervision: str = "rgb"):
    """Coarse + fine photometric MSE (``train_nerf_rgb.py:262-278``; the
    luminance variant ``train_nerf_ir.py:260-263``)."""
    if supervision == "rgb":
        def mse(rgb):
            return torch.mean((rgb - target_rgb) ** 2)
    elif supervision == "luminance":
        target_y = luminance(target_rgb)

        def mse(rgb):
            return torch.mean((luminance(rgb) - target_y) ** 2)
    else:
        raise ValueError(f"unknown supervision mode: {supervision}")
    coarse_loss = mse(result.coarse.rgb)
    fine_loss = (
        mse(result.fine.rgb) if result.fine is not None
        else torch.zeros((), dtype=coarse_loss.dtype, device=coarse_loss.device)
    )
    loss = coarse_loss + fine_loss
    return loss, {"loss": loss, "coarse_loss": coarse_loss, "fine_loss": fine_loss}


def masked_depth_mse(
    depth_pred: torch.Tensor, depth_gt: torch.Tensor, valid_max: Optional[float] = None
) -> torch.Tensor:
    """Mean squared depth error over ``gt > 0`` (and ``gt < valid_max``)."""
    mask = depth_gt > 0.0
    if valid_max is not None:
        mask = mask & (depth_gt < valid_max)
    mask = mask.to(depth_pred.dtype)
    return torch.sum(mask * (depth_pred - depth_gt) ** 2) / torch.clamp(torch.sum(mask), min=1.0)


# ``sampling`` -> the draw of a batch's store rows
SAMPLERS = {"uniform": uniform_ray_indices, "per_image": per_image_ray_indices}


class StepDraws(NamedTuple):
    """The random inputs of one update: the ray indices and the render
    draws (the JAX step's ``k_sample`` and ``k_render`` halves)."""

    idx: torch.Tensor  # [batch] int64 rows of the store
    render: RenderDraws


def _make_update(settings: RenderSettings, *, supervision: str, coarse_field, fine_field,
                 fused_loss, depth_loss_weight: float, depth_valid_max: Optional[float],
                 sync: Optional[Callable] = None):
    """``update(state, rays, target, render_draws, depth_gt) -> metrics``:
    one update of the resident and the batch steps on a gathered batch (the
    loss, its backward, ``sync``, the scheduled optimizer step, the PSNR,
    the pose update)."""
    use_depth = depth_loss_weight > 0.0
    if use_depth and fused_loss is not None and not getattr(fused_loss, "supports_depth", False):
        raise ValueError(
            "depth supervision with a fused loss needs one built with depth_loss_weight > 0"
        )

    def loss_fn(state: TrainState, rays, target, render: RenderDraws, depth_gt):
        if fused_loss is not None:
            if use_depth:
                return fused_loss(rays, target, render, depth_gt)
            return fused_loss(rays, target, render)
        result = render_rays(state.coarse, state.fine, rays, settings, render,
                             coarse_field=coarse_field, fine_field=fine_field)
        loss, metrics = nerf_loss(result, target, supervision=supervision)
        if use_depth:
            pred = result.fine.depth if result.fine is not None else result.coarse.depth
            d_loss = masked_depth_mse(pred, depth_gt, depth_valid_max)
            loss = loss + depth_loss_weight * d_loss
            metrics["depth_loss"] = d_loss
            metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    def update(state: TrainState, rays, target, render: RenderDraws,
               depth_gt=None) -> Dict[str, torch.Tensor]:
        loss, metrics = loss_fn(state, rays, target, render, depth_gt)
        state.optimizer.zero_grad(set_to_none=True)
        if state.pose is not None:
            state.pose.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if sync is not None:
            metrics = sync(state, metrics)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        photometric = metrics["coarse_loss"] + metrics["fine_loss"]
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp(photometric, min=1e-10))
        if state.pose is not None:
            state.pose.update()
            twists = state.pose.twists.detach()
            metrics["pose_twist_norm"] = torch.mean(torch.linalg.norm(twists, dim=-1))
        return metrics

    return update


def make_train_step(
    settings: RenderSettings,
    batch_size: int,
    *,
    supervision: str = "rgb",
    coarse_field=None,
    fine_field=None,
    fused_loss=None,
    sampling: str = "uniform",
    steps_per_call: int = 1,
    depth_loss_weight: float = 0.0,
    depth_valid_max: Optional[float] = None,
    ray_source: Optional[Callable] = None,
    sync: Optional[Callable] = None,
):
    """Build ``train_step(state, store, generator, draws=None) -> metrics``.

    Each call takes ``steps_per_call`` updates; the returned metrics (0-d
    tensors, not synchronized) are the last update's. The random inputs
    come from ``generator`` (on the store's device) in the order indices,
    then render draws, unless ``draws`` gives a :class:`StepDraws` per
    update. ``coarse_field``/``fine_field`` replace the encode + model call
    of their pass in the plain render (the fused fields of
    ``ops.fused_mlp_train``, kernels 2 and 3 on a card);
    ``fused_loss`` replaces the whole render + loss body and supersedes them;
    ``sampling`` is "uniform" over all rays or "per_image" (one image per
    update, ``train_nerf_rgb.py:222-241``). ``depth_loss_weight`` > 0 adds
    ``weight * masked_depth_mse`` of the fine (or coarse-only) expected
    depth against the store's GT depth over ``0 < gt [< depth_valid_max]``;
    a fused loss must then have been built with the same term
    (``supports_depth``) and the same ``depth_valid_max``.
    ``ray_source(state, store, idx) -> (rays, target)`` replaces the store
    gather: pose refinement rotates the camera-frame directions by the
    refined poses this way (``train.pose_opt.pose_ray_source``); then each
    update also steps ``state.pose`` and the metrics gain
    ``pose_twist_norm``, the mean norm of the updated twists.
    ``sync(state, metrics) -> metrics``, called between the backward and
    the update, may replace the gradients and the metrics (the data-
    parallel step's mean over ranks, ``parallel.sharding``)."""
    indices = SAMPLERS[sampling]
    if depth_loss_weight > 0.0 and ray_source is not None:
        raise ValueError(
            "depth supervision and a custom ray_source (pose refinement) are mutually exclusive"
        )
    update = _make_update(settings, supervision=supervision, coarse_field=coarse_field,
                          fine_field=fine_field, fused_loss=fused_loss,
                          depth_loss_weight=depth_loss_weight, depth_valid_max=depth_valid_max,
                          sync=sync)

    def one_step(state: TrainState, store: RayStore, d: StepDraws) -> Dict[str, torch.Tensor]:
        if ray_source is not None:
            rays, target = ray_source(state, store, d.idx)
        else:
            rays, target = take_ray_batch(store, d.idx)
        depth_gt = take_depth(store, d.idx) if depth_loss_weight > 0.0 else None
        return update(state, rays, target, d.render, depth_gt)

    def train_step(
        state: TrainState,
        store: RayStore,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[StepDraws]] = None,
    ) -> Dict[str, torch.Tensor]:
        if draws is not None and len(draws) != steps_per_call:
            raise ValueError(f"need {steps_per_call} StepDraws, got {len(draws)}")
        metrics = {}
        for j in range(steps_per_call):
            if draws is not None:
                d = draws[j]
            else:
                idx = indices(store, batch_size, generator)
                d = StepDraws(
                    idx, draw_render_noise(batch_size, settings, generator, store.data.device)
                )
            metrics = one_step(state, store, d)
        return metrics

    return train_step


def make_batch_train_step(
    settings: RenderSettings,
    *,
    supervision: str = "rgb",
    coarse_field=None,
    fine_field=None,
    fused_loss=None,
    depth_loss_weight: float = 0.0,
    depth_valid_max: Optional[float] = None,
    unpack: Optional[Callable] = None,
):
    """The step over a batch gathered on the host (the host-streamed store,
    ``data/host_store.py``): :func:`make_train_step`'s update on ``(rays,
    target[, depth_gt])`` given by the caller, in place of the store
    gather. Returns ``step(state, rays, target, generator=None, draws=None,
    depth_gt=None) -> metrics`` (``depth_gt`` needed iff
    ``depth_loss_weight`` > 0), one update a call. The render draws are
    ``draws`` (a :class:`RenderDraws`) when given, else drawn from
    ``generator`` as the resident step draws them after its indices.

    ``unpack`` (``data/host_store.py::make_ray_unpack``) takes the packed
    wire: the step is then ``step(state, packed, generator=None,
    draws=None)`` and rebuilds ``(rays, target[, depth_gt])`` from the
    packed dict's indices, u8 rgb and depth on the device first."""
    use_depth = depth_loss_weight > 0.0
    update = _make_update(settings, supervision=supervision, coarse_field=coarse_field,
                          fine_field=fine_field, fused_loss=fused_loss,
                          depth_loss_weight=depth_loss_weight, depth_valid_max=depth_valid_max)

    def batch_step(state: TrainState, rays, target, generator: Optional[torch.Generator] = None,
                   draws: Optional[RenderDraws] = None, depth_gt=None) -> Dict[str, torch.Tensor]:
        if use_depth and depth_gt is None:
            raise ValueError("depth supervision needs the batch's GT depth (depth_gt)")
        if draws is None:
            draws = draw_render_noise(target.shape[0], settings, generator, target.device)
        return update(state, rays, target, draws, depth_gt if use_depth else None)

    if unpack is None:
        return batch_step

    def packed_step(state: TrainState, packed: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[RenderDraws] = None) -> Dict[str, torch.Tensor]:
        parts = unpack(packed)
        return batch_step(state, parts[0], parts[1], generator, draws,
                          parts[2] if use_depth else None)

    return packed_step
