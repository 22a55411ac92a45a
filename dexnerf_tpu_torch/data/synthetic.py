"""Procedural synthetic scenes: self-contained data for tests and smoke runs.

Counterpart of ``dexnerf_tpu/data/synthetic.py``: an analytic
emission-absorption field (soft spheres, optional shells and planes)
rendered with the port's own compositor gives ground-truth posed images,
and :func:`write_blender_dataset` / :func:`write_messytable_dataset` /
:func:`write_llff_dataset` lay them out on disk in the blender format
(transforms JSONs + PNGs), the messytable format (``meta.pkl`` + gray PNG
+ uint16 millimeter depth PNG) and the LLFF format (``poses_bounds.npy``
+ ``images/`` + ``depths/`` sidecars), written with PIL, for the loaders.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c
from dexnerf_tpu_torch.core.sampling import linspace
from dexnerf_tpu_torch.core.volrend import volume_render_radiance_field
from dexnerf_tpu_torch.data.blender import pose_spherical

# Soft-sphere scene constants: centers, radii, albedos, densities.
SPHERES = (
    ((0.0, 0.0, 0.0), 1.0, (0.9, 0.2, 0.2), 40.0),
    ((0.9, 0.9, 0.0), 0.5, (0.2, 0.4, 0.9), 60.0),
)


def analytic_field(
    pts: torch.Tensor, spheres=None, falloff: float = 8.0, shells=(), planes=()
) -> torch.Tensor:
    """Map points [..., 3] to raw radiance-field logits [..., 4].

    Each sphere adds density ``d * sigmoid(falloff * (r - |p - c|))``, each
    shell ``d * exp(-(|p - c| - R)^2 / 2t^2)``, each plane
    ``d * sigmoid(falloff * (offset - normal . p))``; the rgb is the
    occupancy-weighted albedo, returned as logits (pre-sigmoid rgb,
    pre-ReLU σ) for the compositor."""
    kw = dict(dtype=pts.dtype, device=pts.device)
    rgb_accum = torch.zeros((*pts.shape[:-1], 3), **kw)
    sigma = torch.zeros(pts.shape[:-1], **kw)
    total_w = torch.zeros(pts.shape[:-1], **kw)
    for center, radius, albedo, density in SPHERES if spheres is None else spheres:
        dist = torch.linalg.norm(pts - torch.tensor(center, **kw), dim=-1)
        inside = torch.sigmoid(float(falloff) * (radius - dist))
        sigma = sigma + density * inside
        rgb_accum = rgb_accum + inside[..., None] * torch.tensor(albedo, **kw)
        total_w = total_w + inside
    for center, radius, thickness, albedo, density in shells:
        dist = torch.linalg.norm(pts - torch.tensor(center, **kw), dim=-1)
        w = torch.exp(-((dist - radius) ** 2) / (2.0 * thickness**2))
        sigma = sigma + density * w
        rgb_accum = rgb_accum + w[..., None] * torch.tensor(albedo, **kw)
        total_w = total_w + w
    for normal, offset, albedo, density in planes:
        s = torch.sum(pts * torch.tensor(normal, **kw), dim=-1)
        inside = torch.sigmoid(float(falloff) * (offset - s))
        sigma = sigma + density * inside
        rgb_accum = rgb_accum + inside[..., None] * torch.tensor(albedo, **kw)
        total_w = total_w + inside
    rgb = torch.clamp(rgb_accum / torch.clamp(total_w, min=1e-6)[..., None], 1e-4, 1 - 1e-4)
    rgb_logit = torch.log(rgb) - torch.log1p(-rgb)
    return torch.cat([rgb_logit, sigma[..., None]], dim=-1)


def render_analytic_rays(
    ro: torch.Tensor,
    rd: torch.Tensor,
    near: float = 2.0,
    far: float = 6.0,
    num_samples: int = 128,
    spheres=None,
    falloff: float = 8.0,
    shells=(),
    planes=(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth (rgb, depth) of the analytic scene along given rays,
    composited on a white background."""
    t = linspace(near, far, num_samples, rd.dtype, rd.device)
    pts = ro[..., None, :] + rd[..., None, :] * t[..., :, None]
    raw = analytic_field(pts, spheres=spheres, falloff=falloff, shells=shells, planes=planes)
    z = t.expand(*rd.shape[:-1], num_samples)
    out = volume_render_radiance_field(raw, z, rd, white_background=True)
    return out.rgb.cpu().numpy(), out.depth.cpu().numpy()


def render_analytic_image(
    c2w: np.ndarray,
    height: int,
    width: int,
    focal: float,
    near: float = 2.0,
    far: float = 6.0,
    num_samples: int = 128,
    spheres=None,
    falloff: float = 8.0,
    shells=(),
    planes=(),
    device="cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth (rgb [H, W, 3], depth [H, W]) of the analytic scene
    from one camera-to-world pose, rendered on ``device``."""
    pose = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    ro, rd = get_ray_bundle_c2w(height, width, focal, pose)
    return render_analytic_rays(
        ro, rd, near, far, num_samples, spheres=spheres, falloff=falloff,
        shells=shells, planes=planes,
    )


def make_synthetic_scene(
    num_views: int = 8,
    height: int = 32,
    width: int = 32,
    focal: Optional[float] = None,
    near: float = 2.0,
    far: float = 6.0,
    seed: int = 0,
    cam_radius: float = 4.0,
    spheres=None,
    falloff: float = 8.0,
    num_gt_samples: int = 128,
    shells=(),
    planes=(),
    device="cpu",
):
    """Posed ground-truth views of the analytic scene: (images [N, H, W, 3],
    depths [N, H, W], poses_c2w [N, 4, 4], [H, W, focal]). The elevations
    come from ``np.random.RandomState(seed)``, as in the JAX package."""
    if focal is None:
        focal = 1.2 * width
    rng = np.random.RandomState(seed)
    thetas = np.linspace(-180, 180, num_views, endpoint=False)
    phis = -30.0 + rng.uniform(-10, 10, size=num_views)
    poses = np.stack([pose_spherical(t, p, float(cam_radius)) for t, p in zip(thetas, phis)], 0)
    images, depths = [], []
    for c2w in poses:
        rgb, depth = render_analytic_image(
            c2w, height, width, focal, near, far, num_samples=num_gt_samples,
            spheres=spheres, falloff=falloff, shells=shells, planes=planes, device=device,
        )
        images.append(rgb)
        depths.append(depth)
    return (
        np.stack(images, 0).astype(np.float32),
        np.stack(depths, 0).astype(np.float32),
        poses.astype(np.float32),
        [height, width, float(focal)],
    )


def write_blender_dataset(
    basedir: str, height: int = 25, width: int = 25, views_per_split=(4, 2, 2), device="cpu"
) -> None:
    """Write a blender-format dataset of the analytic scene (transforms
    JSONs + 8-bit RGB PNGs), views evenly spaced in azimuth at elevation
    -30 and radius 4, rendered on ``device``."""
    from PIL import Image

    focal = 1.2 * width
    camera_angle_x = 2.0 * np.arctan(0.5 * width / focal)
    idx = 0
    for split, n in zip(["train", "val", "test"], views_per_split):
        frames = []
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        for k in range(n):
            theta = -180 + 360.0 * (idx / float(sum(views_per_split)))
            c2w = pose_spherical(theta, -30.0, 4.0)
            rgb, _ = render_analytic_image(c2w, height, width, focal, device=device)
            rel = f"./{split}/r_{k}"
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(basedir, f"{rel}.png")
            )
            frames.append({"file_path": rel, "transform_matrix": c2w.tolist()})
            idx += 1
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)


def write_messytable_dataset(
    basedir: str,
    height: int = 32,
    width: int = 32,
    views_per_split=(2, 1, 1),
    imgname: str = "0128_irL_kuafu_half.png",
    device="cpu",
) -> None:
    """Write a messytable-format dataset of the analytic scene, whose
    geometry holds end to end with the loader and the trainer: the loader
    halves the stored resolution and keeps the meta intrinsics, and the
    trainer unprojects with ``get_ray_bundle_w2c`` through them. So the
    ground truth is rendered on ``device`` along exactly those rays at the
    loader's output size (``height // 2`` x ``width // 2``) and stored at 2x
    by a nearest upsample, and ``meta.pkl`` holds the w2c and the K at
    output resolution. Poses are the w2c of an OpenCV-convention camera
    (the blender orbit's c2w with its y and z axes flipped, so +z looks at
    the scene), views evenly spaced in azimuth at elevation -30 and radius
    4; the image is the 8-bit gray mean of the rgb, the depth a uint16
    millimeter PNG, as in the real format."""
    from PIL import Image

    h_out, w_out = height // 2, width // 2
    focal = 1.2 * w_out
    K = np.array([[focal, 0, w_out / 2.0], [0, focal, h_out / 2.0], [0, 0, 1]], dtype=np.float64)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    total = sum(views_per_split)
    idx = 0
    for split, n in zip(["train", "val", "test"], views_per_split):
        for k in range(n):
            d = os.path.join(basedir, split, f"scene-{k}")
            os.makedirs(d, exist_ok=True)
            theta = -180 + 360.0 * (idx / float(total))
            c2w = pose_spherical(theta, -30.0, 4.0).astype(np.float64) @ flip
            w2c = np.linalg.inv(c2w)
            ro, rd = get_ray_bundle_w2c(
                h_out, w_out, torch.as_tensor(w2c, dtype=torch.float32, device=device),
                torch.as_tensor(K, dtype=torch.float32, device=device),
            )
            rgb, depth = render_analytic_rays(ro, rd)
            gray = (np.clip(rgb.mean(-1), 0, 1) * 255).astype(np.uint8)
            depth_mm = (depth * 1000).astype(np.uint16)
            for img, name in ((gray, imgname), (depth_mm, "depthL.png")):
                Image.fromarray(np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)).save(
                    os.path.join(d, name))
            with open(os.path.join(d, "meta.pkl"), "wb") as f:
                pickle.dump({"extrinsic_l": w2c, "intrinsic_l": K}, f)
            idx += 1


# The forward-facing scene of write_llff_dataset, in the frame the LLFF
# loader puts the cameras in (the average camera at the origin looking
# down -z): three spheres between z = -2.3 and -4.5, and an opaque wall
# behind z = -6 so that every ray hits something.
LLFF_SPHERES = (
    ((0.0, 0.0, -3.0), 0.6, (0.9, 0.2, 0.2), 40.0),
    ((0.7, 0.4, -4.0), 0.5, (0.2, 0.4, 0.9), 60.0),
    ((-0.8, -0.3, -2.6), 0.35, (0.2, 0.8, 0.3), 60.0),
)
LLFF_PLANES = (((0.0, 0.0, 1.0), -6.0, (0.7, 0.7, 0.6), 60.0),)
# fern's focal length, 410 px at 504 px wide, scaled to the written width
LLFF_FOCAL_PER_WIDTH = 410.0 / 504.0
# the σ threshold of the d_dex_ sidecars
LLFF_DEX_THRESHOLD = 25.0
# the seed of the camera positions
LLFF_SEED = 0


def _lookat_c2w(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """NeRF-convention c2w [3, 4]: columns right, up, back, position."""
    back = pos - target
    back = back / np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right = right / np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, pos], axis=1)


def write_llff_dataset(
    basedir: str,
    height: int = 32,
    width: int = 48,
    views: int = 10,
    device="cpu",
) -> None:
    """Write an LLFF-format forward-facing dataset of the analytic scene
    (``LLFF_SPHERES``, ``LLFF_PLANES``), in the layout of
    ``tools/make_llff_dataset_from_ckpt.py``: ``poses_bounds.npy``,
    ``images/r_<k>.png`` (``height`` x ``width``, 8-bit RGB) and the depth
    sidecars ``depths/d_<k>.npy`` (expected depth) and ``d_dex_<k>.npy``
    (the first sample with σ > ``LLFF_DEX_THRESHOLD``), float32 ray distances
    from the camera in scene units, 0 where the view's accumulation is at
    most 0.5.

    Cameras: ``views`` look-at poses at positions uniform in ±(0.25, 0.18,
    0.08) (``np.random.default_rng(LLFF_SEED)``) aimed at (0, 0, -2);
    bounds (4/3, 8), so the loader's rescale is exactly 1; focal length
    fern's 410 px at 504 px wide, scaled to ``width``. As in the tool, the
    poses are written first with placeholder images, read back through
    :func:`~dexnerf_tpu_torch.data.llff.load_llff_data` (factor 1, no
    spherify), and the views rendered on ``device`` at the poses the loader
    gives, so images and loaded poses agree."""
    from PIL import Image

    from dexnerf_tpu_torch.data.llff import load_llff_data

    focal = LLFF_FOCAL_PER_WIDTH * width
    rng = np.random.default_rng(LLFF_SEED)
    rows = []
    for _ in range(int(views)):
        pos = rng.uniform(-1.0, 1.0, 3) * np.array([0.25, 0.18, 0.08])
        loaded = np.concatenate(
            [_lookat_c2w(pos, np.array([0.0, 0.0, -2.0])), [[height], [width], [focal]]], 1)
        # storage column order [-y, x, z]: the loader turns it back into [x, y, z]
        storage = np.concatenate([-loaded[:, 1:2], loaded[:, 0:1], loaded[:, 2:]], 1)
        rows.append(np.concatenate([storage.reshape(-1), [4.0 / 3.0, 8.0]]))
    imgdir = os.path.join(basedir, "images")
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(os.path.join(basedir, "depths"), exist_ok=True)
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.stack(rows, 0))
    names = [os.path.join(imgdir, f"r_{k:03d}.png") for k in range(int(views))]
    for name in names:
        Image.fromarray(np.zeros((height, width, 3), np.uint8)).save(name)
    _, poses, _, _, _ = load_llff_data(basedir, factor=None)
    near, far, n_samples = 1.0, 8.0, 128
    t = linspace(near, far, n_samples, torch.float32, device)
    for k, name in enumerate(names):
        pose = torch.as_tensor(poses[k, :3, :4], device=device)
        ro, rd = get_ray_bundle_c2w(height, width, float(poses[k, 2, 4]), pose)
        pts = ro[..., None, :] + rd[..., None, :] * t[:, None]
        raw = analytic_field(pts, spheres=LLFF_SPHERES, planes=LLFF_PLANES)
        z = t.expand(*rd.shape[:-1], n_samples)
        out = volume_render_radiance_field(raw, z, rd, white_background=True,
                                           m_thres_cand=(LLFF_DEX_THRESHOLD,))
        norm = torch.linalg.norm(rd, dim=-1)
        hit = out.accumulation > 0.5
        zero = torch.zeros_like(norm)
        d_exp = torch.where(hit, out.depth * norm, zero)
        d_dex = torch.where(hit, out.depth_dex[0] * norm, zero)
        rgb = (torch.clamp(out.rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(rgb).save(name)
        np.save(os.path.join(basedir, "depths", f"d_{k}.npy"), d_exp.cpu().numpy())
        np.save(os.path.join(basedir, "depths", f"d_dex_{k}.npy"), d_dex.cpu().numpy())
