"""Data-parallel training and tiled frames over ``torch.distributed``,
multi-scene training and the multi-host entry."""

from dexnerf_tpu_torch.parallel import multihost
from dexnerf_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn_ranks
from dexnerf_tpu_torch.parallel.multiscene import (
    RAY_AXIS,
    SCENE_AXIS,
    MultiSceneState,
    MultiSceneStore,
    SceneMesh,
    init_multi_scene_state,
    make_multi_scene_parallel_train_step,
    make_multi_scene_train_step,
    make_scene_data_mesh,
    make_scene_mesh,
    scene_params,
    scene_store,
    scene_train_state,
    shard_multi_scene,
    stack_params,
    stack_ray_stores,
)
from dexnerf_tpu_torch.parallel.sharding import (
    make_parallel_pose_train_step,
    make_parallel_train_step,
    render_image_parallel,
)

__all__ = [
    "multihost",
    "Mesh",
    "MultiSceneState",
    "MultiSceneStore",
    "RAY_AXIS",
    "SCENE_AXIS",
    "SceneMesh",
    "init_multi_scene_state",
    "make_mesh",
    "make_multi_scene_parallel_train_step",
    "make_multi_scene_train_step",
    "make_parallel_pose_train_step",
    "make_parallel_train_step",
    "make_scene_data_mesh",
    "make_scene_mesh",
    "render_image_parallel",
    "scene_params",
    "scene_store",
    "scene_train_state",
    "shard_multi_scene",
    "spawn_ranks",
    "stack_params",
    "stack_ray_stores",
]
