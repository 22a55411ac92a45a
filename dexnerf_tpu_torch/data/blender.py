"""Blender-synthetic dataset loader (NeRF ``transforms_*.json`` format)
and spherical-orbit camera poses (numpy only).

Counterpart of ``dexnerf_tpu/data/blender.py``: three JSON splits, c2w
poses, focal from ``camera_angle_x``, ``half_res`` (÷4, as in the
reference despite the name), ``testskip`` on val/test and the 25x25
``debug`` mode. PNGs are read with PIL; the resizes are OpenCV's
``INTER_AREA`` (images) and ``INTER_NEAREST`` (depth sidecars), written in
numpy (``data/resize.py``), at any size.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from dexnerf_tpu_torch.data.resize import area_resize, nearest_resize


def translate_z(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rotate_phi_x(phi: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1] = m[2, 2] = c
    m[1, 2] = -s
    m[2, 1] = s
    return m


def rotate_theta_y(theta: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    m[0, 0] = m[2, 2] = c
    m[0, 2] = -s
    m[2, 0] = s
    return m


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """c2w pose on a sphere looking at the origin (reference
    ``load_blender.py:33-38``)."""
    c2w = translate_z(radius)
    c2w = rotate_phi_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rotate_theta_y(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ c2w


def spherical_render_poses(num: int = 40, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    angles = np.linspace(-180.0, 180.0, num + 1)[:-1]
    return np.stack([pose_spherical(a, phi, radius) for a in angles], 0)


def _frames(basedir: str, split: str, testskip: int):
    with open(os.path.join(basedir, f"transforms_{split}.json"), "r") as fp:
        meta = json.load(fp)
    skip = 1 if (split == "train" or testskip == 0) else testskip
    return meta, meta["frames"][::skip]


def load_blender_depths(
    basedir: str, testskip: int = 1, half_res: bool = False, debug: bool = False,
    prefix: str = "d_",
):
    """Optional per-view metric-depth sidecars (``split/d_k.npy`` beside
    ``split/r_k.png``) as [N, H, W] float32 in the loader's view order,
    zeros for views without one; None when the dataset has none. Resizes
    take the nearest sample (``INTER_NEAREST``): averaging metric depth
    across a resize invents depths no surface has."""
    per_view, found = [], False
    for split in ("train", "val", "test"):
        for frame in _frames(basedir, split, testskip)[1]:
            d, base = os.path.split(frame["file_path"])
            sidecar = None
            if base.startswith("r_"):
                cand = os.path.join(basedir, d, prefix + base[2:] + ".npy")
                if os.path.exists(cand):
                    sidecar = np.load(cand).astype(np.float32)
                    found = True
            per_view.append(sidecar)
    if not found:
        return None
    shape = next(d.shape for d in per_view if d is not None)
    depths = np.stack(
        [d if d is not None else np.zeros(shape, np.float32) for d in per_view], 0
    )
    if debug:
        size = (25, 25)
    elif half_res:
        size = (shape[0] // 4, shape[1] // 4)
    else:
        return depths
    return np.stack([nearest_resize(d, size) for d in depths], 0)


def load_blender_data(
    basedir: str, half_res: bool = False, testskip: int = 1, debug: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List, List[np.ndarray]]:
    """Load ``transforms_{train,val,test}.json`` + PNGs. Returns
    ``(images, poses, render_poses, [H, W, focal], i_split)`` with float32
    images in [0, 1] (RGBA where the PNGs have alpha)."""
    from PIL import Image

    all_imgs, all_poses, counts = [], [], [0]
    metas = {}
    for split in ("train", "val", "test"):
        metas[split], frames = _frames(basedir, split, testskip)
        imgs, poses = [], []
        for frame in frames:
            with Image.open(os.path.join(basedir, frame["file_path"] + ".png")) as im:
                imgs.append(np.asarray(im))
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses, dtype=np.float32))
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(metas["test"]["camera_angle_x"]))
    render_poses = spherical_render_poses()
    if debug:
        # 25x25 smoke-test images (the reference's //32 of 800x800)
        imgs = np.stack([area_resize(im, (25, 25)) for im in imgs], 0)
        return imgs, poses, render_poses, [H // 32, W // 32, focal / 32.0], i_split
    if half_res:
        H, W, focal = H // 4, W // 4, focal / 4.0
        imgs = np.stack([area_resize(im, (H, W)) for im in imgs], 0)
    return imgs, poses, render_poses, [H, W, focal], i_split
