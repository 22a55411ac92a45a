"""Active-IR supervision through the live SG shader (``models/sg.py``).

Counterpart of ``dexnerf_tpu/render/sg_ir.py``. The reference carried
``SgRenderer`` as dead code "for the planned IR-active-light work"
(reference ``nerf/render.py:5-60``): supervise a NeRF on IR frames not as
raw luminance (``train_nerf_ir.py:260-263``) but as a *shaded* image, the
model of Dex-NeRF's sensor, whose IR camera sees its own co-located
projector reflected off the scene.

Per sample point along each ray:

* **basecolor**: the field's RGB head through its sigmoid, read as albedo;
* **normal**: the density-gradient normal ``n = -∇σ / |∇σ|`` (one extra
  backward pass through the field, taken from the same forward that gives
  the raw outputs);
* **metallic / roughness**: global learnable scalars (sigmoid-squashed);
* **illumination**: a learnable world-frame SG mixture (environment lobes)
  plus one *active* lobe riding each ray: its axis the surface→camera
  direction (projector and camera co-located), its amplitude a learnable
  colour with an optional inverse-square distance falloff, its sharpness a
  learnable beam width.

``sg_shade`` evaluates the Cook-Torrance BRDF against that mixture per
sample; the shaded radiance is composited with the emission-absorption
weights and its Rec.601 luminance matched to the IR target by MSE, through
``train.step.make_train_step(fused_loss=...)``. The shading parameters are
a dict of tensors (``TrainState.sg``) in the optimizer beside the fields.

No kernel gives gradients with respect to the sample points, so every pass
here is the plain field (``render.renderer.make_mlp_field``), as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
from dexnerf_tpu_torch.core.volrend import VolumeRenderOutputs, volume_render_radiance_field
from dexnerf_tpu_torch.models.sg import pack_sg, sg_shade
from dexnerf_tpu_torch.render.renderer import (
    FieldFn,
    RayBatch,
    RenderDraws,
    RenderSettings,
    jittered_z_vals,
    make_mlp_field,
    make_ray_batch,
)

_EPS = 1e-6

# the shading leaves, in JAX's order (init_sg_ir_params)
SG_LEAVES = ("illum_env", "active_log_amp", "active_log_sharpness", "metallic_logit",
             "roughness_logit")


def init_sg_ir_params(generator: torch.Generator, num_env_lobes: int = 2,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """The learnable shading parameters, JAX's five leaves with their shapes
    and init distributions: environment lobes dim and broad (stray IR) with
    random unit axes (``illum_env`` [L, 7]), the active lobe at unit
    amplitude (``active_log_amp`` [3] zeros) and a moderate beam
    (``active_log_sharpness`` log 8), ``metallic_logit`` -2 (sigmoid ~0.12)
    and ``roughness_logit`` 0 (0.5). Drawn on the CPU from ``generator``,
    then moved to ``device``."""
    axes = torch.randn((num_env_lobes, 3), generator=generator)
    axes = axes / torch.linalg.norm(axes, dim=-1, keepdim=True)
    amps = 0.05 * torch.abs(torch.randn((num_env_lobes, 3), generator=generator))
    sharp = torch.full((num_env_lobes, 1), 2.0)
    params = {
        "illum_env": pack_sg(amps, axes, sharp),
        "active_log_amp": torch.zeros((3,)),
        "active_log_sharpness": torch.tensor(math.log(8.0), dtype=torch.float32),
        "metallic_logit": torch.tensor(-2.0),
        "roughness_logit": torch.tensor(0.0),
    }
    return {k: params[k].to(device) for k in SG_LEAVES}


def _field_with_normals(field: FieldFn, pts: torch.Tensor, viewdirs: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shared forward: ``(raw [N, S, 4], normals [N, S, 3])``.

    σ at a point depends only on that point's coordinates, so pulling a
    σ-only cotangent back to the points gives each point's gradient (the
    Jacobian is block-diagonal), from the forward that gives ``raw`` (a
    second forward would make 3 field evaluations a pass instead of 2). The
    normals are detached (JAX's ``stop_gradient``): they guide shading; the
    density head trains through the compositing weights."""
    if not pts.requires_grad:
        pts.requires_grad_(True)
    raw = field(pts, viewdirs)
    sigma = raw[..., 3]
    (g,) = torch.autograd.grad(sigma, pts, torch.ones_like(sigma), retain_graph=True)
    g = g.detach()
    n = -g / torch.maximum(torch.linalg.norm(g, dim=-1, keepdim=True), g.new_tensor(_EPS))
    return raw, n


def _shade_samples(sg_params: Dict[str, torch.Tensor], raw: torch.Tensor, normals: torch.Tensor,
                   z_vals: torch.Tensor, viewdirs: torch.Tensor, *,
                   distance_falloff: bool) -> torch.Tensor:
    """Per-sample shaded radiance [N, S, 3] under the environment lobes and
    the active lobe."""
    n, s = z_vals.shape
    b = n * s
    basecolor = torch.sigmoid(raw[..., :3]).reshape(b, 3)
    normal = normals.reshape(b, 3)
    # surface -> camera; also the incident direction of the co-located
    # projector's light at the surface
    to_cam = (-viewdirs[:, None, :]).expand(n, s, 3).reshape(b, 3)
    env = sg_params["illum_env"][None].expand(b, *sg_params["illum_env"].shape)
    amp = torch.exp(sg_params["active_log_amp"])[None, :]
    if distance_falloff:
        # inverse-square falloff with distance along the ray (z is the
        # parametric depth; the |d| scale folds into the learned amplitude)
        r2 = torch.maximum(z_vals.reshape(b, 1) ** 2, z_vals.new_tensor(1e-2))
        amp = amp / r2
    else:
        amp = amp.expand(b, 3)
    sharp = torch.exp(sg_params["active_log_sharpness"]).expand(b, 1)
    active = pack_sg(amp, to_cam, sharp)[:, None, :]  # [B, 1, 7]
    illums = torch.cat([env, active], dim=1)
    metallic = torch.sigmoid(sg_params["metallic_logit"]).expand(b, 1)
    roughness = (0.04 + 0.96 * torch.sigmoid(sg_params["roughness_logit"])).expand(b, 1)
    shaded = sg_shade(illums, basecolor, metallic, roughness, normal, to_cam)
    return shaded.reshape(n, s, 3)


def render_sg_ir_rays(
    field: FieldFn,
    sg_params: Dict[str, torch.Tensor],
    rays: RayBatch,
    z_vals: torch.Tensor,
    sigma_noise: Optional[torch.Tensor],
    s: RenderSettings,
    *,
    distance_falloff: bool = True,
) -> Tuple[torch.Tensor, VolumeRenderOutputs]:
    """One pass: field → normals → shade → composite, with the drawn
    σ-noise [N, S] (or None). Returns ``(ir [N], outs)``, ``outs`` the
    volume-render outputs (their weights feed the hierarchical resample)."""
    viewdirs = rays.viewdirs if s.use_viewdirs else None
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., :, None]
    raw, normals = _field_with_normals(field, pts, viewdirs)
    outs = volume_render_radiance_field(raw, z_vals, rays.directions, white_background=False,
                                        m_thres_cand=None, sigma_noise=sigma_noise)
    shaded = _shade_samples(sg_params, raw, normals, z_vals, rays.viewdirs,
                            distance_falloff=distance_falloff)
    ir = torch.sum(outs.weights[..., None] * shaded, dim=-2)  # [N, 3]
    return luminance(ir), outs


def render_sg_ir_image(
    coarse_model,
    fine_model,
    sg_params: Dict[str, torch.Tensor],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near: float,
    far: float,
    settings: RenderSettings,
    *,
    distance_falloff: bool = True,
    block_size: int = 4096,
    use_ndc: bool = False,
    height: Optional[int] = None,
    width: Optional[int] = None,
    focal_length: Optional[float] = None,
) -> torch.Tensor:
    """Deterministic full-frame shaded-IR render [H, W] (luminance), the
    evaluation view of the :func:`make_sg_ir_loss` model, ``block_size``
    rays at a time (the last block short: JAX's zero padding changes no
    pixel). The normals need autograd, so it runs under
    ``torch.enable_grad()`` whatever the caller's mode; the ray bundles must
    not be inference tensors. Returns a detached tensor."""
    s = settings.eval_variant()
    coarse_field = make_mlp_field(coarse_model, s)
    fine_field = make_mlp_field(fine_model, s) if fine_model is not None else None
    img_shape = ray_directions.shape[:-1]
    rays = make_ray_batch(ray_origins, ray_directions, near, far, use_ndc=use_ndc,
                          height=height, width=width, focal_length=focal_length)
    n = rays.origins.shape[0]
    out = []
    with torch.enable_grad():
        for i in range(0, n, block_size):
            block = RayBatch(*[x[i:i + block_size] for x in rays])
            z_vals = stratified_z_vals(block.near, block.far, s.num_coarse, lindisp=s.lindisp)
            ir, outs_c = render_sg_ir_rays(coarse_field, sg_params, block, z_vals, None, s,
                                           distance_falloff=distance_falloff)
            if fine_field is not None and s.num_fine > 0:
                z_merged, _ = hierarchical_z_vals(z_vals, outs_c.weights.detach(), s.num_fine,
                                                  det=True)
                ir, _ = render_sg_ir_rays(fine_field, sg_params, block, z_merged, None, s,
                                          distance_falloff=distance_falloff)
            out.append(ir.detach())
    return torch.cat(out).reshape(img_shape)


def make_sg_ir_loss(
    coarse_model,
    fine_model,
    sg_params: Dict[str, torch.Tensor],
    settings: RenderSettings,
    *,
    distance_falloff: bool = True,
):
    """The loss for ``make_train_step(fused_loss=...)``: ``(rays, target
    [N, 3], draws) -> (loss, metrics)``, ``draws`` a ``RenderDraws`` (the
    perturbation uniforms, each pass's σ-noise, the resample's uniforms).
    The models and the shading leaves ``sg_params``
    (:func:`init_sg_ir_params`, requiring grad) are bound in. The
    target's Rec.601 luminance is the IR frame (the reference stores IR
    captures as grayscale RGB, ``train_nerf_ir.py:260-263``)."""
    s = settings
    coarse_field = make_mlp_field(coarse_model, s)
    fine_field = make_mlp_field(fine_model, s) if fine_model is not None else None

    def loss_fn(rays: RayBatch, target: torch.Tensor, draws: RenderDraws):
        target_y = luminance(target)
        z_vals = jittered_z_vals(rays, s, draws)
        ir_c, outs_c = render_sg_ir_rays(coarse_field, sg_params, rays, z_vals,
                                         draws.noise_coarse, s, distance_falloff=distance_falloff)
        coarse_loss = torch.mean((ir_c - target_y) ** 2)
        fine_loss = torch.zeros((), dtype=coarse_loss.dtype, device=coarse_loss.device)
        if fine_field is not None and s.num_fine > 0:
            z_merged, _ = hierarchical_z_vals(z_vals, outs_c.weights.detach(), s.num_fine,
                                              det=not s.perturb, u=draws.u_fine)
            ir_f, _ = render_sg_ir_rays(fine_field, sg_params, rays, z_merged, draws.noise_fine,
                                        s, distance_falloff=distance_falloff)
            fine_loss = torch.mean((ir_f - target_y) ** 2)
        loss = coarse_loss + fine_loss
        metrics = {"loss": loss, "coarse_loss": coarse_loss, "fine_loss": fine_loss}
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn
