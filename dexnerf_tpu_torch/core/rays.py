"""Ray generation from a camera-to-world pose (blender/llff convention) or
a world-to-camera pose and intrinsics (messytable convention), and the
LLFF normalized-device-coordinate (NDC) projection.

Counterpart of ``dexnerf_tpu/core/rays.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None):
    """(ii, jj) pixel coordinate grids of shape [H, W]: ``ii`` varies along
    the width (column), ``jj`` along the height (row)."""
    jj, ii = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return ii, jj


def _rotate(directions: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``out[..., r] = sum_c directions[..., c] * rot[r, c]`` (R @ d), as a
    sum of products rather than a matmul, so it stays in full float32."""
    return torch.sum(directions[..., None, :] * rot, dim=-1)


def get_ray_bundle_c2w(
    height: int, width: int, focal_length: float, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays from a camera-to-world pose + focal length: directions
    ``((i - W/2)/f, -(j - H/2)/f, -1)`` rotated into the world frame.

    Returns (ray_origins[H, W, 3], ray_directions[H, W, 3]).
    """
    ii, jj = pixel_grid(height, width, c2w.dtype, c2w.device)
    directions = torch.stack(
        [
            (ii - width * 0.5) / focal_length,
            -(jj - height * 0.5) / focal_length,
            -torch.ones_like(ii),
        ],
        dim=-1,
    )
    rays_d = _rotate(directions, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_ray_bundle_w2c(
    height: int,
    width: int,
    w2c: torch.Tensor,
    intrinsic: torch.Tensor,
    fx_for_both_axes: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays from a world-to-camera pose + full 3x3 intrinsics (reference
    ``nerf_helpers.py:89-112``): pixel directions ``((i - cx)/fx,
    (j - cy)/fy, 1)`` with ``fy = fx`` when ``fx_for_both_axes`` (the
    reference uses ``intrinsic[0, 0]`` for both axes), rotated by
    ``inv(w2c[:3, :3])``; the origin is ``inv(w2c)[:3, 3]``. Both inverses
    are taken in float64 and cast to the pose's dtype, so the rays do not
    depend on the rounding of an f32 inverse.

    Returns (ray_origins[H, W, 3], ray_directions[H, W, 3]).
    """
    dtype = w2c.dtype
    ii, jj = pixel_grid(height, width, dtype, w2c.device)
    fx = intrinsic[0, 0]
    fy = intrinsic[0, 0] if fx_for_both_axes else intrinsic[1, 1]
    directions = torch.stack(
        [(ii - intrinsic[0, 2]) / fx, (jj - intrinsic[1, 2]) / fy, torch.ones_like(ii)],
        dim=-1,
    )
    w2c64 = w2c.to(torch.float64)
    inv_rot = torch.linalg.inv(w2c64[:3, :3]).to(dtype)
    rays_d = _rotate(directions, inv_rot)
    rays_o = torch.linalg.inv(w2c64)[:3, 3].to(dtype).expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(
    height: int,
    width: int,
    focal_length: float,
    near: float,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift the rays to the plane z = -near and project them into NDC
    space (the original NeRF's LLFF math, reference
    ``nerf_helpers.py:172-199``). Returns (origins, directions), [..., 3]
    each, in the rays' dtype."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    sx = -1.0 / (width / (2.0 * focal_length))
    sy = -1.0 / (height / (2.0 * focal_length))
    o = torch.stack([sx * ox / oz, sy * oy / oz, 1.0 + 2.0 * near / oz], dim=-1)
    d = torch.stack(
        [sx * (dx / dz - ox / oz), sy * (dy / dz - oy / oz), -2.0 * near / oz], dim=-1
    )
    return o, d


def ndc_t_to_world_depth(
    t: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    height: int,
    width: int,
    focal_length: float,
    near: float = 1.0,
) -> torch.Tensor:
    """Metric ray distance (scene units) of NDC ray parameters ``t``.

    An NDC render samples ``t`` in [0, 1] along the projected ray, so its
    expected and σ-threshold depths are NDC parameters. This inverts the
    projection: the NDC point ``o' + t d'`` has world z ``2 near / (p_z -
    1)`` (clamped at -1e-6 below 0 in the denominator, so t = 1, the far
    plane at infinity, stays finite), x and y follow from the perspective
    divide, and the result is the distance from the world ray origin
    ``rays_o`` to that point. Exact for sample-valued ``t``; for the
    expected depth it converts the expectation's location. ``t`` broadcasts
    against the rays: [H, W] rays take [H, W] or [T, H, W] parameters."""
    o_ndc, d_ndc = ndc_rays(height, width, focal_length, near, rays_o, rays_d)
    p = o_ndc + t[..., None] * d_ndc
    sx = -1.0 / (width / (2.0 * focal_length))
    sy = -1.0 / (height / (2.0 * focal_length))
    z = 2.0 * near / torch.clamp(p[..., 2] - 1.0, max=-1e-6)
    pw = torch.stack([p[..., 0] * z / sx, p[..., 1] * z / sy, z], dim=-1)
    return torch.linalg.norm(pw - rays_o, dim=-1)
