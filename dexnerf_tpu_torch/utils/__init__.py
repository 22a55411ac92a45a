"""Image casts and colormaps, the point-cloud export and the σ-isosurface mesh
(numpy + PIL)."""

from dexnerf_tpu_torch.utils.images import (
    apply_jet_colormap,
    cast_to_disparity_image,
    cast_to_gray_image,
    cast_to_image,
    write_gif,
    write_png,
)
from dexnerf_tpu_torch.utils.mesh import marching_tetrahedra, write_ply_mesh
from dexnerf_tpu_torch.utils.pointcloud import depth_to_points, read_ply, write_ply

__all__ = [
    "apply_jet_colormap",
    "cast_to_disparity_image",
    "cast_to_gray_image",
    "cast_to_image",
    "depth_to_points",
    "marching_tetrahedra",
    "read_ply",
    "write_gif",
    "write_ply",
    "write_ply_mesh",
    "write_png",
]
