"""Hierarchical coarse-to-fine renderer."""

from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderResult,
    RenderSettings,
    encode_points,
    make_mlp_field,
    make_ray_batch,
    render_image,
    render_rays,
)

__all__ = [
    "RayBatch",
    "RenderResult",
    "RenderSettings",
    "encode_points",
    "make_mlp_field",
    "make_ray_batch",
    "render_image",
    "render_rays",
]
