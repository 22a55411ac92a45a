"""LLFF real forward-facing dataset loader (numpy + PIL only).

Counterpart of ``dexnerf_tpu/data/llff.py`` (the reference's
``load_llff.py``, the standard LLFF loading code): ``poses_bounds.npy``
gives [3, 5, N] poses and [2, N] bounds; images are read from
``images_{factor}/`` (made from ``images/`` on first use); the rotation
axes are reordered ([-y x z] -> [x y z]), the bounds rescaled, the poses
recentred on their average (or spherified), a spiral (or ring) render
path built, and the view nearest the average camera returned as
``i_test``.

``_minify`` shrinks each image to ``(H // factor, W // factor)`` with
OpenCV's ``INTER_AREA`` written in numpy (``data/resize.py``), so it
writes the PNGs that the JAX package's OpenCV minify writes, whether or
not the factor divides the size.

The pose math (``poses_avg``, ``recenter_poses``, ``spherify_poses``,
``render_path_spiral``) keeps the canonical LLFF constants: the
``[0.1, 0.2, 0.3]`` tie-break vector, 120 render poses, ``dt = 0.75`` and
90th-percentile radii.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dexnerf_tpu_torch.data.resize import area_resize

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _image_files(d: str):
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(_IMG_EXTS)]


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def _minify(basedir: str, factor: int) -> None:
    """Write ``images_{factor}/``, the PNGs of ``images/`` shrunk by
    ``factor``, unless it exists."""
    from PIL import Image

    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return
    files = _image_files(os.path.join(basedir, "images"))
    os.makedirs(imgdir)
    for f in files:
        img = _read_image(f)
        small = area_resize(img, (img.shape[0] // factor, img.shape[1] // factor))
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        Image.fromarray(small).save(os.path.join(imgdir, name))


def _load_data(basedir: str, factor: Optional[int] = None, load_imgs: bool = True):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None:
        sfx = f"_{factor}"
        _minify(basedir, int(factor))
    else:
        factor = 1
    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")
    imgfiles = _image_files(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    sh = _read_image(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    if not load_imgs:
        return poses, bds
    imgs = np.stack([_read_image(f)[..., :3] / 255.0 for f in imgfiles], -1)
    return poses, bds, imgs


def normalize(x: np.ndarray, axis: Optional[int] = None) -> np.ndarray:
    """Unit vector(s); ``axis`` for batched rows."""
    return x / np.linalg.norm(x, axis=axis, keepdims=axis is not None)


def _se3(p34: np.ndarray) -> np.ndarray:
    """[..., 3, 4] camera-to-world -> [..., 4, 4] homogeneous transform."""
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), p34.shape[:-2] + (1, 4))
    return np.concatenate([p34, bottom], axis=-2)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] camera frame at ``pos``: +z along ``z``, +x right-handed
    against the ``up`` hint, +y re-orthogonalized."""
    forward = normalize(z)
    right = normalize(np.cross(up, forward))
    true_up = normalize(np.cross(forward, right))
    return np.stack([right, true_up, forward, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """The average camera [3, 5]: centroid position, summed view directions
    and up hints, and the first pose's hwf column."""
    cam = viewmatrix(
        z=poses[:, :3, 2].sum(0), up=poses[:, :3, 1].sum(0), pos=poses[:, :3, 3].mean(0)
    )
    return np.concatenate([cam, poses[0, :3, -1:]], 1)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """``N`` poses on a spiral around the average camera ``c2w``, each
    looking at the point ``focal`` units in front of it. ``zdelta`` is
    unused (the reference's signature)."""
    thetas = np.linspace(0.0, 2.0 * np.pi * rots, int(N) + 1)[:-1]
    offsets = np.stack(
        [
            np.cos(thetas) * rads[0],
            -np.sin(thetas) * rads[1],
            -np.sin(thetas * zrate) * rads[2],
            np.ones_like(thetas),
        ],
        1,
    )
    centers = offsets @ c2w[:3, :4].T
    look_at = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    hwf = c2w[:, 4:5]
    return [np.concatenate([viewmatrix(c - look_at, up, c), hwf], 1) for c in centers]


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Every camera re-expressed in the average camera's frame."""
    world_from_avg = _se3(poses_avg(poses)[:3, :4])
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(world_from_avg) @ _se3(poses[:, :3, :4]))[:, :3, :4]
    return out


def _axes_focus_point(poses: np.ndarray) -> np.ndarray:
    """Least-squares point closest to every camera's optical axis."""
    fwd = poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    proj = np.eye(3) - fwd @ np.transpose(fwd, (0, 2, 1))
    lhs = (np.transpose(proj, (0, 2, 1)) @ proj).mean(0)
    rhs = (proj @ origins).mean(0)
    return np.squeeze(np.linalg.inv(lhs) @ rhs)


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recentre on the cameras' mutual focus point, scale to unit mean
    radius, and build a 120-pose ring at the cameras' mean height.
    Returns (poses, render_poses, bds)."""
    focus = _axes_focus_point(poses)
    z_axis = normalize((poses[:, :3, 3] - focus).mean(0))
    x_axis = normalize(np.cross([0.1, 0.2, 0.3], z_axis))
    y_axis = normalize(np.cross(z_axis, x_axis))
    world_from_new = np.stack([x_axis, y_axis, z_axis, focus], 1)

    recentred = np.linalg.inv(_se3(world_from_new[None])) @ _se3(poses[:, :3, :4])
    mean_radius = np.sqrt(np.mean(np.sum(recentred[:, :3, 3] ** 2, -1)))
    scale = 1.0 / mean_radius
    recentred[:, :3, 3] *= scale
    bds = bds * scale

    ring_h = np.mean(recentred[:, :3, 3], 0)[2]
    ring_r = np.sqrt(1.0 - ring_h**2)
    th = np.linspace(0.0, 2.0 * np.pi, 120)
    centers = np.stack([ring_r * np.cos(th), ring_r * np.sin(th), np.full_like(th, ring_h)], 1)
    fwd = normalize(centers, axis=1)
    right = normalize(np.cross(fwd, np.array([0.0, 0.0, -1.0])), axis=1)
    ring_up = normalize(np.cross(fwd, right), axis=1)
    ring = np.stack([right, ring_up, fwd, centers], -1)

    def with_hwf(p34):
        hwf = np.broadcast_to(poses[0, :3, -1:], p34.shape[:-1] + (1,))
        return np.concatenate([p34, hwf], -1)

    return with_hwf(recentred[:, :3, :4]), with_hwf(ring), bds


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
):
    """Returns ``(images [N, H, W, 3], poses [N, 3, 5], bds [N, 2],
    render_poses, i_test)``, the reference's contract
    (``load_llff.py:278-354``)."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots = 1
            n_views //= 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=n_rots, N=n_views
        )

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images.astype(np.float32), poses.astype(np.float32), bds, render_poses, i_test


def load_llff_depths(basedir: str, n: int, prefix: str = "d_") -> Optional[np.ndarray]:
    """Per-view depth sidecars ``{basedir}/depths/{prefix}{k}.npy`` (float32
    metric ray distance in scene units, 0 = no reading), indexed like the
    sorted images: ``d_`` the expected depth, ``d_dex_`` the σ-threshold
    surface. Returns [N, H, W] float32, or None unless all ``n`` exist."""
    d = os.path.join(basedir, "depths")
    paths = [os.path.join(d, f"{prefix}{k}.npy") for k in range(n)]
    if not all(os.path.exists(p) for p in paths):
        return None
    return np.stack([np.load(p).astype(np.float32) for p in paths], axis=0)
