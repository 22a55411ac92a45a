"""Volume rendering (emission-absorption compositing) + Dex-NeRF
σ-threshold depth.

Counterpart of ``dexnerf_tpu/core/volrend.py``. The σ-noise of training
is an argument (the drawn values, already scaled by the noise std), added
to the raw σ before the ReLU as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class VolumeRenderOutputs(NamedTuple):
    """Per-ray outputs of compositing a radiance field. ``depth_dex`` is
    ``None`` when no thresholds were requested, else ``[T, ...]``: the
    σ-threshold first-crossing depth per candidate threshold."""

    rgb: torch.Tensor  # [..., 3]
    disparity: torch.Tensor  # [...]
    accumulation: torch.Tensor  # [...]
    weights: torch.Tensor  # [..., S]
    depth: torch.Tensor  # [...]
    depth_dex: Optional[torch.Tensor]  # [T, ...] or None


def concat_outputs(parts: Sequence[VolumeRenderOutputs]) -> VolumeRenderOutputs:
    """Join per-chunk outputs along the ray axis (``depth_dex`` [T, N]
    along its last)."""
    return VolumeRenderOutputs(
        *[
            None if f[0] is None else torch.cat(f, dim=-1 if i == 5 else 0)
            for i, f in enumerate(zip(*parts))
        ]
    )


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis."""
    ones = torch.ones_like(x[..., :1])
    return torch.cat([ones, torch.cumprod(x, dim=-1)[..., :-1]], dim=-1)


def sigma_to_weights(sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """``alpha = 1 - exp(-sigma * dist)``;
    ``w_i = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10)``."""
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha * cumprod_exclusive(1.0 - alpha + 1e-10)


def ray_dists(depth_values: torch.Tensor, ray_directions: torch.Tensor) -> torch.Tensor:
    """Distances between consecutive samples in world units; the last
    interval is 1e10."""
    last = torch.full_like(depth_values[..., :1], 1e10)
    dists = torch.cat([depth_values[..., 1:] - depth_values[..., :-1], last], dim=-1)
    return dists * torch.linalg.norm(ray_directions, dim=-1, keepdim=True)


def sigma_threshold_depth(
    sigma: torch.Tensor,
    depth_values: torch.Tensor,
    thresholds: Sequence[float],
) -> torch.Tensor:
    """Dex-NeRF metric depth: per ray, the depth of the FIRST sample with
    σ > m, or sample 0 when no sample crosses (the reference's argmax of an
    all-zero mask). sigma, depth_values: [..., S]; returns [T, ...]."""
    m = torch.as_tensor(thresholds, dtype=sigma.dtype, device=sigma.device)
    hit = sigma[None] > m.reshape(-1, *([1] * sigma.ndim))  # [T, ..., S]
    first = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
    z = depth_values[None].expand(hit.shape)
    return torch.gather(z, -1, first)[..., 0]


def composite(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    dists: torch.Tensor,
    *,
    white_background: bool = False,
    m_thres_cand: Optional[Sequence[float]] = None,
    sigma_noise: Optional[torch.Tensor] = None,
) -> VolumeRenderOutputs:
    """Composite raw ``[..., S, 4]`` (rgb logits + σ logit) at sample
    depths ``[..., S]`` with inter-sample distances ``dists`` [..., S].
    ``sigma_noise`` [..., S], when given, is added to the σ logit before
    the ReLU."""
    rgb = torch.sigmoid(radiance_field[..., :3])
    sigma_raw = radiance_field[..., 3]
    if sigma_noise is not None:
        sigma_raw = sigma_raw + sigma_noise
    sigma = torch.relu(sigma_raw)
    weights = sigma_to_weights(sigma, dists)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    depth_dex = None
    if m_thres_cand is not None and len(tuple(m_thres_cand)) > 0:
        depth_dex = sigma_threshold_depth(sigma, depth_values, m_thres_cand)
    # 1 / max(1e-10, depth / max(acc, 1e-37)): the fused kernel's form,
    # finite where acc == 0 (the bare depth / acc is NaN there)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-37), min=1e-10)
    return VolumeRenderOutputs(
        rgb=rgb_map,
        disparity=disp_map,
        accumulation=acc_map,
        weights=weights,
        depth=depth_map,
        depth_dex=depth_dex,
    )


def volume_render_radiance_field(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    white_background: bool = False,
    m_thres_cand: Optional[Sequence[float]] = None,
    sigma_noise: Optional[torch.Tensor] = None,
) -> VolumeRenderOutputs:
    """Composite a sampled radiance field into per-ray maps.

    ``radiance_field``: [..., S, 4] raw output (rgb logits + σ logit);
    ``depth_values``: [..., S]; ``ray_directions``: [..., 3];
    ``sigma_noise``: the drawn σ-noise [..., S] or None.
    """
    return composite(
        radiance_field,
        depth_values,
        ray_dists(depth_values, ray_directions),
        white_background=white_background,
        m_thres_cand=m_thres_cand,
        sigma_noise=sigma_noise,
    )


def depth_confidence(
    weights: torch.Tensor, z_vals: torch.Tensor, depth: torch.Tensor, delta: float
) -> torch.Tensor:
    """Per-ray weight mass within ``±delta`` of ``depth`` along the ray
    (unnormalized: it compounds coverage with concentration)."""
    near = torch.abs(z_vals - depth[..., None]) <= delta
    return torch.sum(weights * near.to(weights.dtype), dim=-1)
