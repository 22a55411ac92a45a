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

The halving is the 2x2 block mean for images (what OpenCV's
``INTER_AREA`` computes at a factor of 2) and the top-left sample of each
block for depths (``INTER_NEAREST``); other sizes, among them the
reference's 25x25 ``debug`` mode, are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from dexnerf_tpu_torch.data.blender import _area_downsample, spherical_render_poses

UNPORTED_RESIZE = "ROADMAP.md Queue 1 item 4c"


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
    if debug:
        raise NotImplementedError(
            f"dataset.debug: the 25x25 messytable resize is not ported yet ({UNPORTED_RESIZE})"
        )
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
    if H % 2 or W % 2:
        raise NotImplementedError(
            f"{H}x{W} messytable images: only an exact halving is ported ({UNPORTED_RESIZE})"
        )
    # the focal of the last scene read, unscaled by half_res, as in the reference
    focal = float(np.array(meta[intri_n])[0, 0]) / 4.0
    imgs = np.stack([_area_downsample(im, 2) for im in imgs], 0)
    depths = depths[:, ::2, ::2]
    return (
        imgs,
        np.concatenate(all_poses, 0),
        spherical_render_poses(),
        [H // 2, W // 2, focal],
        i_split,
        np.concatenate(all_intrinsics, 0),
        np.ascontiguousarray(depths),
    )
