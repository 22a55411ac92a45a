"""Camera pose refinement: an SE(3) correction per training image, trained
with the fields.

Counterpart of ``dexnerf_tpu/train/pose_opt.py``. The refined
camera-to-world transform of train image ``i`` is ``se3_exp(xi_i) @ T0_i``,
a left (world-frame) correction whose twist ``xi_i`` starts at exactly 0.
The store keeps each pixel's camera-frame direction; each step rotates the
batch's directions by the refined poses (:func:`pose_rays`), so the
photometric loss differentiates into the twists through ray generation
(and through the NDC projection, applied after it, on LLFF scenes). Both
camera conventions: c2w + focal, and w2c + K with the reference's
``K[0, 0]`` for both axes, whose base transform is ``inv(w2c)``.

The step needs gradients with respect to the rays, which the fused
kernels do not give (the JAX kernels declare zero cotangents for their ray
inputs), so pose steps run the plain render. The twists train under their
own Adam at ``optimizer.pose_lr`` and their own schedule and count
(:class:`PoseState`), as JAX's ``optax.multi_transform`` partition does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dexnerf_tpu_torch.core.lie import matmul3, se3_exp
from dexnerf_tpu_torch.core.rays import _rotate, ndc_rays, pixel_grid
from dexnerf_tpu_torch.render.renderer import RayBatch


@dataclasses.dataclass(frozen=True)
class PoseRayStore:
    """Per-pixel camera-frame directions and targets, plus the base poses.
    World rays are a function of the twists (:func:`pose_rays`)."""

    data: torch.Tensor  # [N, 6]: cam_dir(3) rgb(3); N = n_images * H * W
    base_c2w: torch.Tensor  # [n_images, 4, 4] camera-to-world
    near: float
    far: float
    rays_per_image: int
    use_ndc: bool = False
    height: int = 0
    width: int = 0
    focal: float = 0.0

    @property
    def num_rays(self) -> int:
        return self.data.shape[0]

    @property
    def num_images(self) -> int:
        return self.data.shape[0] // self.rays_per_image


def c2w_from_w2c(w2c: np.ndarray) -> np.ndarray:
    """``inv(w2c)`` [N, 4, 4] taken in float64, cast to float32 (as
    ``get_ray_bundle_w2c`` takes its inverses)."""
    return np.linalg.inv(np.asarray(w2c, np.float64)[:, :4, :4]).astype(np.float32)


def camera_dirs(height: int, width: int, K: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] camera-frame pixel directions of intrinsics ``K``,
    ``((i - cx) / fx, (j - cy) / fx, 1)`` (the reference's ``K[0, 0]`` for
    both axes)."""
    ii, jj = pixel_grid(height, width, K.dtype, K.device)
    return torch.stack([(ii - K[0, 2]) / K[0, 0], (jj - K[1, 2]) / K[0, 0],
                        torch.ones_like(ii)], dim=-1)


def init_pose_params(num_images: int, device="cpu") -> torch.Tensor:
    """Zero twists [n_images, 6]: training starts at the dataset poses."""
    return torch.zeros((num_images, 6), dtype=torch.float32, device=device)


def refined_c2w(base_c2w: torch.Tensor, twists: torch.Tensor) -> torch.Tensor:
    """``se3_exp(xi_i) @ T0_i`` for every image, [n_images, 4, 4], in full
    float32 (:func:`matmul3`)."""
    return matmul3(se3_exp(twists), base_c2w)


def build_pose_ray_store(
    images: np.ndarray,
    poses: np.ndarray,
    hwf,
    near: float,
    far: float,
    *,
    device,
    intrinsics: Optional[np.ndarray] = None,
    use_ndc: bool = False,
) -> PoseRayStore:
    """The camera-frame counterpart of ``build_ray_store``: ``poses`` are
    c2w unless ``intrinsics`` is given; then they are w2c and the base
    transforms are :func:`c2w_from_w2c`."""
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    n = len(images)
    if intrinsics is not None:
        Ks = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
        cam = torch.stack([camera_dirs(H, W, K) for K in Ks])
        base = c2w_from_w2c(poses)
    else:
        ii, jj = pixel_grid(H, W, torch.float32, device)
        d = torch.stack([(ii - W * 0.5) / focal, -(jj - H * 0.5) / focal,
                         -torch.ones_like(ii)], dim=-1)
        cam = d.expand(n, H, W, 3)
        base = np.asarray(poses, np.float32)[:, :4, :4]
    rgb = torch.as_tensor(np.asarray(images, np.float32)[..., :3], device=device)
    return PoseRayStore(
        data=torch.cat([cam.reshape(-1, 3), rgb.reshape(-1, 3)], dim=-1),
        base_c2w=torch.as_tensor(np.ascontiguousarray(base), device=device),
        near=float(near), far=float(far), rays_per_image=H * W, use_ndc=bool(use_ndc),
        height=H, width=W, focal=focal,
    )


def pose_rays(store: PoseRayStore, twists: torch.Tensor,
              idx: torch.Tensor) -> Tuple[RayBatch, torch.Tensor]:
    """World rays and target rgb [B, 3] of the flat ray indices ``idx``,
    differentiable with respect to ``twists``."""
    rows = store.data[idx]
    cam_dir, target = rows[:, 0:3], rows[:, 3:6]
    Ti = refined_c2w(store.base_c2w, twists)[idx // store.rays_per_image]
    rd = _rotate(cam_dir, Ti[:, :3, :3])
    ro = Ti[:, :3, 3]
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if store.use_ndc:
        ro, rd = ndc_rays(store.height, store.width, store.focal, 1.0, ro, rd)
    n = idx.shape[0]
    kw = dict(dtype=rd.dtype, device=rd.device)
    rays = RayBatch(origins=ro, directions=rd, viewdirs=viewdirs,
                    near=torch.full((n,), store.near, **kw),
                    far=torch.full((n,), store.far, **kw))
    return rays, target


@dataclasses.dataclass
class PoseState:
    """The twists [n_images, 6] (a leaf that the loss differentiates), their
    Adam, its learning-rate schedule and its own count of updates."""

    twists: torch.Tensor
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def update(self) -> None:
        """One Adam update of the twists at ``schedule(step)``."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def init_pose_state(num_images: int, pose_lr: float, lr_decay: float, lr_decay_factor: float,
                    device) -> PoseState:
    """Zero twists under ``optax.adam`` of the reference's exponential decay
    from ``pose_lr`` (JAX's pose partition)."""
    from dexnerf_tpu_torch.train.step import exponential_decay_schedule

    twists = init_pose_params(num_images, device).requires_grad_(True)
    return PoseState(twists=twists, optimizer=torch.optim.Adam([twists], lr=pose_lr),
                     schedule=exponential_decay_schedule(pose_lr, lr_decay, lr_decay_factor))


def pose_ray_source(state, store: PoseRayStore, idx: torch.Tensor):
    """``make_train_step``'s ``ray_source``: the batch's rays at the
    state's refined poses."""
    return pose_rays(store, state.pose.twists, idx)
