"""Ray generation from a camera-to-world pose (blender/llff convention) or
a world-to-camera pose and intrinsics (messytable convention).

Counterpart of the c2w and w2c + K parts of ``dexnerf_tpu/core/rays.py``;
NDC is not ported yet.
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
