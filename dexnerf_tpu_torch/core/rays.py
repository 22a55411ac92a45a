"""Ray generation from a camera-to-world pose (blender/llff convention).

Counterpart of the c2w half of ``dexnerf_tpu/core/rays.py``; the w2c+K
(messytable) convention and NDC are not ported yet.
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
