"""Datasets: the blender, messytable and LLFF loaders, synthetic scenes,
the device ray store, the host-streamed store."""

from dexnerf_tpu_torch.data.blender import (
    load_blender_data,
    load_blender_depths,
    pose_spherical,
    rotate_phi_x,
    rotate_theta_y,
    translate_z,
)
from dexnerf_tpu_torch.data.host_store import (
    HostPixelLoader,
    HostRayLoader,
    build_host_ray_rows,
    build_pose_tables,
    images_to_u8,
    make_ray_unpack,
)
from dexnerf_tpu_torch.data.llff import load_llff_data, load_llff_depths
from dexnerf_tpu_torch.data.messytable import load_messytable_data
from dexnerf_tpu_torch.data.pipeline import (
    RayStore,
    build_ray_store,
    build_ray_store_from_cache,
    sample_ray_batch,
    sample_ray_batch_per_image,
    take_ray_batch,
    with_full_intervals,
)
from dexnerf_tpu_torch.data.synthetic import (
    analytic_field,
    make_synthetic_scene,
    render_analytic_image,
    write_blender_dataset,
    write_llff_dataset,
    write_messytable_dataset,
)

__all__ = [
    "HostPixelLoader",
    "HostRayLoader",
    "RayStore",
    "analytic_field",
    "build_host_ray_rows",
    "build_pose_tables",
    "build_ray_store",
    "build_ray_store_from_cache",
    "images_to_u8",
    "load_blender_data",
    "load_blender_depths",
    "load_llff_data",
    "load_llff_depths",
    "load_messytable_data",
    "make_ray_unpack",
    "make_synthetic_scene",
    "pose_spherical",
    "render_analytic_image",
    "rotate_phi_x",
    "rotate_theta_y",
    "sample_ray_batch",
    "sample_ray_batch_per_image",
    "take_ray_batch",
    "with_full_intervals",
    "translate_z",
    "write_blender_dataset",
    "write_llff_dataset",
    "write_messytable_dataset",
]
