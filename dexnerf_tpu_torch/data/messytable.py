"""MessyTable-format dataset loader (active-stereo IR / real RGB scenes;
numpy + PIL only).

Counterpart of ``dexnerf_tpu/data/messytable.py`` (the reference's
``load_messytable.py``): per-prefix scene directories under
``{basedir}/{train,val,test}/``, each holding a ``meta.pkl``
(``extrinsic_l``/``intrinsic_l`` for IR-left, ``extrinsic``/``intrinsic``
for real RGB), one image and a GT depth PNG in millimeters. Quirks kept: a
gray image is repeated to 3 channels; ``half_res`` divides the first two
rows of K by 4 and pins cx = 240, cy = 135; the output is always halved in
H and W with ``focal = K[0, 0] / 4``. Poses are **world-to-camera** (rays
from :func:`dexnerf_tpu_torch.core.rays.get_ray_bundle_w2c`).

The resizes are OpenCV's, written in numpy (``data/resize.py``):
``INTER_AREA`` for images, ``INTER_NEAREST`` for depths, at any size. With
``debug`` the images and depths are 25x25 while ``hwf`` is ``[H // 32,
W // 32, K[0, 0] / 32]`` of the stored frame, as the reference returns
them (the two disagree unless the frame is 800x800).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from dexnerf_tpu_torch.data.blender import spherical_render_poses
from dexnerf_tpu_torch.data.resize import area_resize, nearest_resize


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def load_messytable_data(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    debug: bool = False,
    imgname: str = "0128_irL_kuafu_half.png",
    is_real_rgb: bool = False,
) -> Tuple[
    np.ndarray, np.ndarray, np.ndarray, List, List[np.ndarray], np.ndarray, np.ndarray
]:
    """Returns ``(images, poses_w2c, render_poses, [H, W, focal], i_split,
    intrinsics, depths)``, depths in meters. ``testskip`` is accepted and
    unused, as in the reference."""
    if is_real_rgb:
        depth_n, extri_n, intri_n = "depth.png", "extrinsic", "intrinsic"
    else:
        depth_n, extri_n, intri_n = "depthL.png", "extrinsic_l", "intrinsic_l"

    all_imgs, all_poses, all_intrinsics, all_depths, counts = [], [], [], [], [0]
    meta = None
    for split in ("train", "val", "test"):
        path = os.path.join(basedir, split)
        imgs, poses, intrinsics, depths = [], [], [], []
        for prefix in sorted(os.listdir(path)):
            meta = _load_pickle(os.path.join(path, prefix, "meta.pkl"))
            img = _read_png(os.path.join(path, prefix, imgname))
            if img.ndim != 3:
                img = np.repeat(img[..., None], 3, axis=-1)
            imgs.append(img)
            depths.append(_read_png(os.path.join(path, prefix, depth_n)) / 1000.0)
            poses.append(np.array(meta[extri_n]))
            K = np.array(meta[intri_n], dtype=np.float64).copy()
            if half_res:
                K[:2, :] = K[:2, :] / 4
                K[0, 2] = 240.0
                K[1, 2] = 135.0
            intrinsics.append(K)
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))
        all_intrinsics.append(np.array(intrinsics).astype(np.float32))
        all_depths.append(np.array(depths).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    depths = np.concatenate(all_depths, 0)
    H, W = imgs[0].shape[:2]
    poses = np.concatenate(all_poses, 0)
    intrinsics = np.concatenate(all_intrinsics, 0)
    # the focal of the last scene read, unscaled by half_res, as in the reference
    focal = float(np.array(meta[intri_n])[0, 0])
    size, hwf = (H // 2, W // 2), [H // 2, W // 2, focal / 4.0]
    if debug:
        size, hwf = (25, 25), [H // 32, W // 32, focal / 32.0]
    imgs = np.stack([area_resize(im, size) for im in imgs], 0)
    depths = np.stack([nearest_resize(d, size) for d in depths], 0)
    return imgs, poses, spherical_render_poses(), hwf, i_split, intrinsics, depths
