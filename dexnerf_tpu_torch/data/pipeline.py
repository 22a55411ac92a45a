"""Device-resident ray store and batch sampling.

Counterpart of ``dexnerf_tpu/data/pipeline.py`` (camera-to-world rays,
world-to-camera rays with intrinsics, LLFF rays in NDC, or the rays of an
offline cache written by ``apps/cache.py``): ray generation runs once over
all training images and the rays
live on the device as one [N_rays, 12] float32 tensor (origin 3,
direction 3, viewdir 3, rgb 3). Each step gathers a batch of rows by
index. Index draws come from a ``torch.Generator`` on the store's device,
or are given by the caller (:func:`take_ray_batch`), so a test can use the
JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Tuple

import numpy as np
import torch

from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c, ndc_rays
from dexnerf_tpu_torch.render.renderer import RayBatch


@dataclasses.dataclass(frozen=True)
class RayStore:
    """Packed rays on the device plus the scene's near/far.

    ``rays_per_image`` > 0 when the rows keep image structure (per-image
    sampling needs it); ``depth`` optionally holds per-ray ground-truth
    depth [N] (meters) for depth supervision; ``intervals`` optionally
    holds per-ray integration bounds [N, 2] (near, far) that replace the
    scene's scalars when a batch is gathered (occupancy-guided training
    re-tightens them from the field as it trains)."""

    data: torch.Tensor  # [N, 12]: ro(3) rd(3) viewdir(3) rgb(3)
    near: float
    far: float
    rays_per_image: int = 0
    depth: Optional[torch.Tensor] = None
    intervals: Optional[torch.Tensor] = None  # [N, 2] per-ray (near, far)

    @property
    def num_rays(self) -> int:
        return self.data.shape[0]

    @property
    def num_images(self) -> int:
        return self.data.shape[0] // self.rays_per_image if self.rays_per_image else 0


def image_ray_rows(img: np.ndarray, pose: np.ndarray, hwf, *, device,
                   intrinsic: Optional[np.ndarray] = None, use_ndc: bool = False) -> torch.Tensor:
    """One image's [H*W, 12] store rows on ``device`` (origin, direction,
    viewdir, rgb), as :func:`build_ray_store` packs each image: the rays of
    the c2w ``pose``, or of the w2c ``pose`` and its K ``intrinsic``, then
    NDC after the viewdirs with ``use_ndc``."""
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    pose = torch.as_tensor(np.asarray(pose, np.float32)[:4, :4], device=device)
    if intrinsic is not None:
        K = torch.as_tensor(np.asarray(intrinsic, np.float32), device=device)
        ro, rd = get_ray_bundle_w2c(H, W, pose, K)
    else:
        ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if use_ndc:
        ro, rd = ndc_rays(H, W, focal, 1.0, ro, rd)
    rgb = torch.as_tensor(np.asarray(img[..., :3], np.float32), device=device)
    return torch.cat([t.reshape(-1, 3) for t in (ro, rd, viewdirs, rgb)], dim=-1)


def build_ray_store(
    images: np.ndarray,
    poses: np.ndarray,
    hwf,
    near: float,
    far: float,
    *,
    device,
    intrinsics: Optional[np.ndarray] = None,
    use_ndc: bool = False,
    depths: Optional[np.ndarray] = None,
) -> RayStore:
    """Generate and pack the rays of every image on ``device``. ``poses``
    are c2w [N, 4, 4] unless ``intrinsics`` [N, 3, 3] is given; then they
    are w2c and each view's rays come from its full K (the messytable
    convention). ``use_ndc`` projects the rays into NDC (near plane 1.0)
    after the viewdirs are taken from the world directions (LLFF).
    ``depths`` [N, H, W] attaches ray-aligned GT depth."""
    H, W = int(hwf[0]), int(hwf[1])
    rows = [image_ray_rows(img, pose, hwf, device=device, use_ndc=use_ndc,
                           intrinsic=None if intrinsics is None else intrinsics[k])
            for k, (img, pose) in enumerate(zip(images, poses))]
    data = torch.cat(rows, dim=0)
    depth = None
    if depths is not None:
        depth = torch.as_tensor(np.asarray(depths, np.float32).reshape(-1), device=device)
        if depth.shape[0] != data.shape[0]:
            raise ValueError(f"depths cover {depth.shape[0]} rays, store has {data.shape[0]}")
    return RayStore(data=data, near=float(near), far=float(far), rays_per_image=H * W, depth=depth)


def unit_directions(rd: np.ndarray) -> np.ndarray:
    """``d * (1 / sqrt(dx*dx + dy*dy + dz*dz))`` in float32, as the JAX
    package's host packer computes its viewdirs. That packer is built with
    ``-march=native``, where the compiler contracts the sum into fused
    multiply-adds, ``fma(dz, dz, fma(dx, dx, dy * dy))``: each is taken
    here in float64 (the product exact) and rounded once to float32."""
    rd = np.asarray(rd, np.float32)
    dx, dy, dz = (rd[:, k].astype(np.float64) for k in range(3))
    s = (dx * dx + (dy * dy).astype(np.float32)).astype(np.float32)
    s = (dz * dz + s).astype(np.float32)
    inv = np.float32(1.0) / np.sqrt(s)
    return rd * inv[:, None]


def build_ray_store_from_cache(cachedir: str, near: float, far: float, *, device) -> RayStore:
    """The store of an offline ray cache (``apps/cache.py``; the
    reference's ``USE_CACHED_DATASET`` branch, ``train_nerf_rgb.py:186-220``):
    every train shard of ``cachedir/train`` in sorted order, ``.npz`` or the
    reference's ``torch.save`` ``.data`` (its ``ray_bundle`` and
    ``target[..., :3]``), concatenated once into rows on ``device``. The
    rows keep no image structure, so per-image sampling raises on it."""
    train = os.path.join(cachedir, "train")
    shards = sorted(glob.glob(os.path.join(train, "*.npz"))
                    + glob.glob(os.path.join(train, "*.data")))
    if not shards:
        raise FileNotFoundError(f"no train shards under {cachedir}/train")
    rows = []
    for path in shards:
        if path.endswith(".data"):
            d = torch.load(path, map_location="cpu", weights_only=False)
            bundle = np.asarray(d["ray_bundle"], dtype=np.float32)
            rgb = np.asarray(d["target"], dtype=np.float32)[..., :3]
        else:
            with np.load(path) as z:
                bundle, rgb = z["ray_bundle"], z["target"]
        ro = np.asarray(bundle[0], np.float32).reshape(-1, 3)
        rd = np.asarray(bundle[1], np.float32).reshape(-1, 3)
        rows.append(np.concatenate(
            [ro, rd, unit_directions(rd), np.asarray(rgb, np.float32).reshape(-1, 3)], axis=-1))
    data = torch.as_tensor(np.concatenate(rows, axis=0), device=device)
    return RayStore(data=data, near=float(near), far=float(far))


def take_ray_batch(store: RayStore, idx: torch.Tensor) -> Tuple[RayBatch, torch.Tensor]:
    """Gather rows ``idx`` into a RayBatch and the target rgb [B, 3]. Each
    ray's bounds come from ``store.intervals`` when present, else the
    scene's scalars."""
    rows = store.data[idx]
    n = rows.shape[0]
    kw = dict(dtype=rows.dtype, device=rows.device)
    if store.intervals is not None:
        iv = store.intervals[idx].to(rows.dtype)
        near, far = iv[:, 0], iv[:, 1]
    else:
        near = torch.full((n,), store.near, **kw)
        far = torch.full((n,), store.far, **kw)
    rays = RayBatch(
        origins=rows[:, 0:3],
        directions=rows[:, 3:6],
        viewdirs=rows[:, 6:9],
        near=near,
        far=far,
    )
    return rays, rows[:, 9:12]


def with_full_intervals(store: RayStore) -> RayStore:
    """``store`` with explicit per-ray ``intervals`` equal to the scene's
    scalars (unchanged when it has intervals already)."""
    if store.intervals is not None:
        return store
    full = torch.tensor([store.near, store.far], dtype=torch.float32, device=store.data.device)
    return dataclasses.replace(store, intervals=full.expand(store.num_rays, 2).contiguous())


def take_depth(store: RayStore, idx: torch.Tensor) -> torch.Tensor:
    if store.depth is None:
        raise ValueError("depth supervision needs a store built with GT depths")
    return store.depth[idx]


def uniform_ray_indices(store: RayStore, batch_size: int, generator: torch.Generator):
    """``batch_size`` indices uniform over all stored rays."""
    return torch.randint(
        0, store.num_rays, (batch_size,), generator=generator, device=store.data.device
    )


def per_image_ray_indices(store: RayStore, batch_size: int, generator: torch.Generator):
    """The reference's sampling: one random image, then ``batch_size``
    random pixels of it."""
    if not store.rays_per_image:
        raise ValueError("store has no image structure (cache-built?)")
    dev = store.data.device
    img = torch.randint(0, store.num_images, (1,), generator=generator, device=dev)
    pix = torch.randint(0, store.rays_per_image, (batch_size,), generator=generator, device=dev)
    return img * store.rays_per_image + pix


def sample_ray_batch(store: RayStore, batch_size: int, generator: torch.Generator):
    """A batch uniform over all training rays: (RayBatch, target rgb)."""
    return take_ray_batch(store, uniform_ray_indices(store, batch_size, generator))


def sample_ray_batch_per_image(store: RayStore, batch_size: int, generator: torch.Generator):
    """A batch from one random image: (RayBatch, target rgb)."""
    return take_ray_batch(store, per_image_ray_indices(store, batch_size, generator))
