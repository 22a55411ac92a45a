"""Data-parallel training and tiled frames over ``torch.distributed``."""

from dexnerf_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn_ranks
from dexnerf_tpu_torch.parallel.sharding import (
    make_parallel_pose_train_step,
    make_parallel_train_step,
    render_image_parallel,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_parallel_pose_train_step",
    "make_parallel_train_step",
    "render_image_parallel",
    "spawn_ranks",
]
