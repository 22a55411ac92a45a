"""Data-parallel training and tiled frames over a process group.

Counterpart of ``dexnerf_tpu/parallel/sharding.py``, one process a device
(``parallel.mesh``) where JAX ``shard_map``s one program over a mesh:

* **Training**: every rank holds the whole ray store and the same
  parameters. Each renders its own share of the global batch through the
  single-device step's body (``train.step.make_train_step``, with the same
  fused loss, fused fields or depth term, so kernel 4, or kernels 2 and 3,
  run on every rank), then the gradients and the metrics are averaged over
  the ranks by one ``all_reduce`` of one flat buffer (JAX's ``pmean``), and
  every rank takes the same update: the parameters stay replicated, bit
  for bit.
* **Rendering**: a frame's rays are padded as JAX pads them and split
  evenly over the ranks; each rank renders its share through the plain
  ``render_image`` (as JAX's tiled frame does), and one ``all_gather`` of
  the shares (through the host on gloo) gives every rank the whole frame.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from dexnerf_tpu_torch.core.volrend import VolumeRenderOutputs
from dexnerf_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum
from dexnerf_tpu_torch.render.renderer import (
    RenderDraws,
    RenderResult,
    RenderSettings,
    draw_render_noise,
    render_image,
)
from dexnerf_tpu_torch.train.step import SAMPLERS, StepDraws, TrainState, make_train_step


def _trainable(state) -> List[torch.Tensor]:
    """Every tensor the step updates: the optimizer's groups (models, SG
    leaves, or a multi-scene state's stacked leaves), then the pose
    twists."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    pose = getattr(state, "pose", None)
    return params + ([pose.twists] if pose is not None else [])


def make_grad_mean(mesh: Mesh) -> Callable:
    """``sync(state, metrics) -> metrics`` for ``make_train_step`` (or the
    multi-scene step, whose metrics are per scene): the mean over the ranks
    of every gradient (a missing one counts as zeros) and every metric, by
    one ``all_reduce`` of one flat buffer."""

    def sync(state, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        params = _trainable(state)
        keys = sorted(metrics)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([t.reshape(-1) for t in grads + [metrics[k] for k in keys]])
        all_reduce_sum(mesh, flat)
        flat = flat / mesh.world_size
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n
        out = {}
        for k in keys:
            n = metrics[k].numel()
            out[k] = flat[offset:offset + n].view_as(metrics[k])
            offset += n
        return out

    return sync


def local_draws(mesh: Mesh, store, global_batch_size: int, settings: RenderSettings,
                generator: torch.Generator, sampling: str = "uniform") -> StepDraws:
    """This rank's share of one update's draws: the global batch's rows and
    render draws, drawn from ``generator`` as the single-device step draws
    them (every rank's generator in the same state), then this rank's
    contiguous slice. So the ranks' rows are their own, with
    ``sampling="per_image"`` from the same image, and the ranks together
    take the single-device step's batch."""
    local = global_batch_size // mesh.world_size
    idx = SAMPLERS[sampling](store, global_batch_size, generator)
    render = draw_render_noise(global_batch_size, settings, generator, store.data.device)
    sl = slice(mesh.rank * local, (mesh.rank + 1) * local)
    return StepDraws(idx[sl], RenderDraws(*[None if t is None else t[sl] for t in render]))


def make_parallel_train_step(
    mesh: Mesh,
    settings: RenderSettings,
    global_batch_size: int,
    *,
    supervision: str = "rgb",
    sampling: str = "uniform",
    steps_per_call: int = 1,
    coarse_field=None,
    fine_field=None,
    fused_loss=None,
    depth_loss_weight: float = 0.0,
    depth_valid_max: Optional[float] = None,
    ray_source: Optional[Callable] = None,
):
    """Data-parallel ``train_step(state, store, generator=None, draws=None)
    -> metrics``: ``global_batch_size`` rays a step, split evenly over the
    ranks (an uneven split raises JAX's words). Each rank renders
    ``global / world_size`` rays by ``make_train_step``'s body with these
    options, its rows and render draws from :func:`local_draws`, or from
    ``draws`` (this rank's ``StepDraws``, one an update, e.g. JAX's, which
    fold the rank into the key); then :func:`make_grad_mean` and the same
    update on every rank. The metrics are the ranks' means."""
    n_dev = mesh.world_size
    if global_batch_size % n_dev:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n_dev} devices")
    inner = make_train_step(
        settings, global_batch_size // n_dev, supervision=supervision, coarse_field=coarse_field,
        fine_field=fine_field, fused_loss=fused_loss, sampling=sampling,
        steps_per_call=steps_per_call, depth_loss_weight=depth_loss_weight,
        depth_valid_max=depth_valid_max, ray_source=ray_source, sync=make_grad_mean(mesh))

    def train_step(state: TrainState, store, generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[StepDraws]] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = [local_draws(mesh, store, global_batch_size, settings, generator, sampling)
                     for _ in range(steps_per_call)]
        return inner(state, store, draws=draws)

    return train_step


def make_parallel_pose_train_step(mesh: Mesh, settings: RenderSettings, global_batch_size: int,
                                  **kwargs):
    """The data-parallel SE(3) pose-refinement step: :func:`make_parallel_
    train_step` (the same keywords but ``ray_source``) with the rays made
    from the refined poses (``train.pose_opt.pose_ray_source``); the
    twists' gradients join the mean and every rank takes the same twist
    update. Always the plain render (the kernels give no ray gradients)."""
    from dexnerf_tpu_torch.train.pose_opt import pose_ray_source

    return make_parallel_train_step(mesh, settings, global_batch_size,
                                    ray_source=pose_ray_source, **kwargs)


def render_image_parallel(
    mesh: Mesh,
    coarse_model,
    fine_model,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: float,
    far: float,
    settings: RenderSettings,
    *,
    chunk: Optional[int] = None,
    use_ndc: bool = False,
    height: Optional[int] = None,
    width: Optional[int] = None,
    focal_length: Optional[float] = None,
) -> RenderResult:
    """A full [H, W] frame tiled over the ranks, the drop-in for
    ``render_image`` (deterministic settings) that JAX's
    ``render_image_parallel`` is: the rays padded to a multiple of the
    ranks (zero origins, unit-z directions), each rank's contiguous share
    rendered by the plain ``render_image`` (``chunk`` rays at a time), and
    the whole frame returned on every rank, reshaped as ``render_image``
    reshapes it."""
    img_shape = ray_directions.shape[:-1]
    ro = ray_origins.reshape(-1, 3)
    rd = ray_directions.reshape(-1, 3)
    n = ro.shape[0]
    pad = (-n) % mesh.world_size
    if pad:
        ro = torch.cat([ro, ro.new_zeros((pad, 3))])
        # unit-z directions keep the padded rays' norms finite
        rd = torch.cat([rd, rd.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
    shard = (n + pad) // mesh.world_size
    lo = mesh.rank * shard
    with torch.no_grad():
        out = render_image(coarse_model, fine_model, ro[lo:lo + shard], rd[lo:lo + shard], near,
                           far, settings.eval_variant(), chunk=chunk, use_ndc=use_ndc,
                           height=height, width=width, focal_length=focal_length)
    passes = [out.coarse] + ([out.fine] if out.fine is not None else [])
    fields = [(i, f) for i, o in enumerate(passes) for f in VolumeRenderOutputs._fields
              if getattr(o, f) is not None]
    # every map's share in one flat buffer, gathered by rank; a rank's rays
    # follow the previous rank's along each map's ray axis
    parts = [getattr(passes[i], f) for i, f in fields]
    gathered = all_gather(mesh, torch.cat([x.reshape(-1) for x in parts]))
    maps: List[Dict[str, torch.Tensor]] = [{} for _ in passes]
    offset = 0
    for (i, f), x in zip(fields, parts):
        g = gathered[:, offset:offset + x.numel()].reshape(mesh.world_size, *x.shape)
        offset += x.numel()
        if f == "depth_dex":  # [k, rays]
            maps[i][f] = g.transpose(0, 1).reshape(x.shape[0], -1)[:, :n].reshape(
                x.shape[0], *img_shape)
        else:
            maps[i][f] = g.reshape(-1, *x.shape[1:])[:n].reshape(*img_shape, *x.shape[1:])
    outs = [VolumeRenderOutputs(**{f: m.get(f) for f in VolumeRenderOutputs._fields})
            for m in maps]
    return RenderResult(coarse=outs[0], fine=outs[1] if len(outs) > 1 else None)
