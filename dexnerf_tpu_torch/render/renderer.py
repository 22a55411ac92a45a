"""Hierarchical (coarse->fine) NeRF renderer.

Counterpart of ``dexnerf_tpu/render/renderer.py``: stratified depths
(jittered when training), coarse field + compositing, inverse-CDF
resampling, fine field + compositing with the Dex-NeRF σ-threshold depths
on the fine pass only. The training path's random numbers come in as a
:class:`RenderDraws` (see :func:`draw_render_noise`), so a test can hand
both packages the same draws; :func:`render_rays` is plain autograd-
differentiable PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.rays import ndc_rays
from dexnerf_tpu_torch.core.sampling import (
    hierarchical_z_vals,
    perturb_z_vals,
    stratified_z_vals,
)
from dexnerf_tpu_torch.core.volrend import (
    VolumeRenderOutputs,
    concat_outputs,
    volume_render_radiance_field,
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static rendering configuration for one mode (train/val)."""

    num_coarse: int = 64
    num_fine: int = 64
    perturb: bool = True
    lindisp: bool = False
    radiance_field_noise_std: float = 0.0
    white_background: bool = False
    m_thres_cand: Tuple[float, ...] = ()
    # encoder settings
    use_viewdirs: bool = True
    num_encoding_fn_xyz: int = 6
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    log_sampling_xyz: bool = True
    log_sampling_dir: bool = True

    def eval_variant(self) -> "RenderSettings":
        """Deterministic variant for validation/rendering."""
        return dataclasses.replace(self, perturb=False, radiance_field_noise_std=0.0)


class RayBatch(NamedTuple):
    """A flat batch of rays; ``viewdirs`` are the normalized directions."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3]
    viewdirs: torch.Tensor  # [N, 3]
    near: torch.Tensor  # [N]
    far: torch.Tensor  # [N]


class RenderDraws(NamedTuple):
    """The four random inputs of one training render, in the JAX key-split
    order (``render_rays``: k_strat, k_noise_c, k_fine, k_noise_f). A field
    is None where the settings draw nothing (no perturbation, σ-noise std
    0)."""

    t_strat: Optional[torch.Tensor]  # [N, num_coarse] uniforms
    noise_coarse: Optional[torch.Tensor]  # [N, num_coarse], std * normal
    u_fine: Optional[torch.Tensor]  # [N, num_fine] uniforms
    noise_fine: Optional[torch.Tensor]  # [N, num_coarse + num_fine], std * normal


NO_DRAWS = RenderDraws(None, None, None, None)


def draw_render_noise(
    n: int, s: "RenderSettings", generator: torch.Generator, device
) -> RenderDraws:
    """Draw a RenderDraws for ``n`` rays from ``generator`` (on
    ``device``)."""
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    std = float(s.radiance_field_noise_std)
    has_fine = s.num_fine > 0
    return RenderDraws(
        t_strat=torch.rand((n, s.num_coarse), **kw) if s.perturb else None,
        noise_coarse=std * torch.randn((n, s.num_coarse), **kw) if std > 0 else None,
        u_fine=torch.rand((n, s.num_fine), **kw) if s.perturb and has_fine else None,
        noise_fine=(
            std * torch.randn((n, s.num_coarse + s.num_fine), **kw)
            if std > 0 and has_fine
            else None
        ),
    )


def _check_draws(s: "RenderSettings", draws: RenderDraws) -> None:
    if s.perturb and draws.t_strat is None:
        raise ValueError("perturbed sampling needs the draws (t_strat, u_fine)")
    if s.radiance_field_noise_std > 0 and draws.noise_coarse is None:
        raise ValueError("σ-noise std > 0 needs the drawn noise")


def jittered_z_vals(rays: "RayBatch", s: "RenderSettings", draws: RenderDraws):
    """Coarse depths: stratified, then jittered by ``draws.t_strat`` when
    the settings perturb."""
    z_vals = stratified_z_vals(rays.near, rays.far, s.num_coarse, lindisp=s.lindisp)
    if s.perturb:
        z_vals = perturb_z_vals(z_vals, draws.t_strat)
    return z_vals


# rays a block of the plain renderer's frames (JAX's render_image maps
# blocks of 4096): the activations of a whole 400x400 frame at once would
# not fit the card for the 8x256 PaperNeRF
PLAIN_RENDER_CHUNK = 16384


class RenderResult(NamedTuple):
    coarse: VolumeRenderOutputs
    fine: Optional[VolumeRenderOutputs]


# A rays_impl renders one RayBatch through both passes.
RaysImpl = Callable[[RayBatch], RenderResult]


def make_ray_batch(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: float,
    far: float,
    *,
    use_ndc: bool = False,
    height: Optional[int] = None,
    width: Optional[int] = None,
    focal_length: Optional[float] = None,
) -> RayBatch:
    """Flatten world-space [..., 3] ray bundles into a RayBatch with
    constant near/far. The viewdirs are the normalized world directions;
    with ``use_ndc`` the origins and directions are then projected into
    NDC with the projection's near plane at 1.0 (``near``/``far`` stay the
    sampling interval, 0 and 1 for LLFF), as in the reference's
    ``run_one_iter_of_nerf``."""
    viewdirs = ray_directions / torch.linalg.norm(
        ray_directions, dim=-1, keepdim=True
    )
    if use_ndc:
        ray_origins, ray_directions = ndc_rays(
            height, width, focal_length, 1.0, ray_origins, ray_directions
        )
    ro = ray_origins.reshape(-1, 3)
    rd = ray_directions.reshape(-1, 3)
    n = ro.shape[0]
    return RayBatch(
        origins=ro,
        directions=rd,
        viewdirs=viewdirs.reshape(-1, 3),
        near=torch.full((n,), near, dtype=ro.dtype, device=ro.device),
        far=torch.full((n,), far, dtype=ro.dtype, device=ro.device),
    )


def encode_points(pts: torch.Tensor, viewdirs: Optional[torch.Tensor], s: RenderSettings):
    """(xyz_enc [N, S, Dx], dir_enc [N, Dd]) for sample points [N, S, 3]
    and per-ray viewdirs [N, 3]; dir_enc is None without viewdirs
    (``settings.use_viewdirs`` false or ``viewdirs`` None), and the model
    then sees the xyz encoding alone, as in JAX's ``make_mlp_field``."""
    enc = positional_encoding(
        pts, s.num_encoding_fn_xyz, s.include_input_xyz, s.log_sampling_xyz
    )
    if viewdirs is None or not s.use_viewdirs:
        return enc, None
    dir_enc = positional_encoding(
        viewdirs, s.num_encoding_fn_dir, s.include_input_dir, s.log_sampling_dir
    )
    return enc, dir_enc


# A field maps sample points [N, S, 3] and per-ray viewdirs [N, 3] to raw
# [N, S, 4], its model's weights bound in (ops.fused_mlp, ops.fused_mlp_train).
FieldFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_mlp_field(model: nn.Module, settings: RenderSettings) -> FieldFn:
    """The plain field of ``model``: encode the points (and the viewdirs,
    when ``settings.use_viewdirs``) per ``settings``, then call the model
    (the occupancy bake's σ and the mesh's, as JAX's ``make_mlp_field``)."""

    def field(pts, viewdirs):
        return model(*encode_points(pts, viewdirs, settings))

    return field


def render_rays(
    coarse_model: nn.Module,
    fine_model: Optional[nn.Module],
    rays: RayBatch,
    settings: RenderSettings,
    draws: RenderDraws = NO_DRAWS,
    *,
    coarse_field: Optional[FieldFn] = None,
    fine_field: Optional[FieldFn] = None,
) -> RenderResult:
    """Render one ray batch through the coarse->fine hierarchy (plain
    PyTorch, differentiable with respect to the models' parameters). With
    ``settings.perturb`` or σ-noise, ``draws`` carries the random numbers;
    the fine depths are detached, as in the reference. ``coarse_field`` /
    ``fine_field`` replace the encode + model call of their pass (e.g. the
    fused fields of ``ops.fused_mlp_train``)."""
    s = settings
    _check_draws(s, draws)
    z_vals = jittered_z_vals(rays, s, draws)
    viewdirs = rays.viewdirs if s.use_viewdirs else None

    def pass_(model, field, z, thresholds, noise):
        pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z[..., :, None]
        if field is not None:
            raw = field(pts, viewdirs)
        else:
            raw = model(*encode_points(pts, viewdirs, s))
        return volume_render_radiance_field(
            raw, z, rays.directions,
            white_background=s.white_background, m_thres_cand=thresholds,
            sigma_noise=noise,
        )

    coarse = pass_(coarse_model, coarse_field, z_vals, None, draws.noise_coarse)
    fine = None
    if (fine_model is not None or fine_field is not None) and s.num_fine > 0:
        z_merged, _ = hierarchical_z_vals(
            z_vals, coarse.weights.detach(), s.num_fine, det=not s.perturb,
            u=draws.u_fine,
        )
        fine = pass_(fine_model, fine_field, z_merged, s.m_thres_cand or None,
                     draws.noise_fine)
    return RenderResult(coarse=coarse, fine=fine)


def _reshape_outputs(o: VolumeRenderOutputs, img_shape) -> VolumeRenderOutputs:
    return VolumeRenderOutputs(
        rgb=o.rgb.reshape(*img_shape, 3),
        disparity=o.disparity.reshape(img_shape),
        accumulation=o.accumulation.reshape(img_shape),
        weights=o.weights.reshape(*img_shape, -1),
        depth=o.depth.reshape(img_shape),
        depth_dex=(
            None
            if o.depth_dex is None
            else o.depth_dex.reshape(o.depth_dex.shape[0], *img_shape)
        ),
    )


def render_image(
    coarse_model: nn.Module,
    fine_model: Optional[nn.Module],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: float,
    far: float,
    settings: RenderSettings,
    *,
    chunk: Optional[int] = None,
    rays_impl: Optional[RaysImpl] = None,
    use_ndc: bool = False,
    height: Optional[int] = None,
    width: Optional[int] = None,
    focal_length: Optional[float] = None,
    occupancy=None,
    occupancy_probes: int = 128,
    occupancy_subsample: int = 2,
) -> RenderResult:
    """Render a full [H, W] ray bundle, ``chunk`` rays at a time (when None,
    the whole bundle at once through ``rays_impl``, :data:`PLAIN_RENDER_CHUNK`
    rays at a time through :func:`render_rays`). ``rays_impl`` replaces
    :func:`render_rays` per chunk, e.g. the fused renderer of
    ``dexnerf_tpu_torch.ops.fused_render.make_fused_render_rays``. With
    ``use_ndc`` the rays are projected into NDC (:func:`make_ray_batch`),
    and the depths are NDC ray parameters.
    ``occupancy`` (a ``render.occupancy.OccupancyGrid``) tightens each ray's
    ``[near, far]`` to its occupied span before sampling: a full [H, W]
    frame through ``tighten_image_intervals`` (every
    ``occupancy_subsample``-th pixel probed), any other bundle through
    ``tighten_ray_intervals``, ``occupancy_probes`` probes a ray. The grid
    is world-space, so it raises with ``use_ndc``.
    Outputs are reshaped to [H, W, ...]; ``depth_dex`` to [T, H, W]."""
    img_shape = ray_directions.shape[:-1]
    rays = make_ray_batch(
        ray_origins, ray_directions, near, far, use_ndc=use_ndc, height=height,
        width=width, focal_length=focal_length,
    )
    if occupancy is not None:
        if use_ndc:
            raise ValueError(
                "occupancy-guided sampling is world-space; NDC rays are "
                "reparameterized (nerf_helpers.py:172-199) — disable one"
            )
        from dexnerf_tpu_torch.render.occupancy import (
            tighten_image_intervals,
            tighten_ray_intervals,
        )

        if len(img_shape) == 2:
            t_near, t_far = tighten_image_intervals(
                occupancy, rays.origins, rays.directions, rays.near, rays.far, img_shape,
                num_probes=occupancy_probes, subsample=occupancy_subsample,
            )
        else:
            t_near, t_far = tighten_ray_intervals(
                occupancy, rays.origins, rays.directions, rays.near, rays.far,
                num_probes=occupancy_probes,
            )
        rays = rays._replace(near=t_near, far=t_far)
    n = rays.origins.shape[0]
    if chunk is not None:
        step = int(chunk)
    else:
        step = n if rays_impl is not None else PLAIN_RENDER_CHUNK
    results = []
    for i in range(0, n, step):
        block = RayBatch(*[x[i:i + step] for x in rays])
        if rays_impl is not None:
            results.append(rays_impl(block))
        else:
            results.append(render_rays(coarse_model, fine_model, block, settings))
    coarse = concat_outputs([r.coarse for r in results])
    fine = (
        None
        if results[0].fine is None
        else concat_outputs([r.fine for r in results])
    )
    return RenderResult(
        coarse=_reshape_outputs(coarse, img_shape),
        fine=None if fine is None else _reshape_outputs(fine, img_shape),
    )
