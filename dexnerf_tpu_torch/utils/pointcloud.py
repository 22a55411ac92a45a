"""Depth map -> colored point cloud, written as ASCII PLY.

Counterpart of ``dexnerf_tpu/utils/pointcloud.py``, the geometry a grasp
planner takes. Depths are ray parameters ``t`` along the (unnormalized)
ray directions, the convention of both the expected depth and the
σ-threshold depth, so a pixel's point is ``origin + t * direction``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_to_points(
    ray_origins: np.ndarray,
    ray_directions: np.ndarray,
    depth: np.ndarray,
    *,
    rgb: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    return_keep: bool = False,
):
    """Back-project a depth map: ``point = o + t * d`` per pixel whose
    ``t`` is finite and positive and, when given, inside ``mask``.

    Returns ``(points [M, 3], colors [M, 3] in [0, 1] or None)``, and the
    flat keep mask with ``return_keep``."""
    ro = np.asarray(ray_origins, np.float32).reshape(-1, 3)
    rd = np.asarray(ray_directions, np.float32).reshape(-1, 3)
    t = np.asarray(depth, np.float32).reshape(-1)
    keep = np.isfinite(t) & (t > 0)
    if mask is not None:
        keep &= np.asarray(mask, bool).reshape(-1)
    pts = ro[keep] + t[keep, None] * rd[keep]
    colors = None
    if rgb is not None:
        colors = np.clip(np.asarray(rgb, np.float32).reshape(-1, 3)[keep], 0.0, 1.0)
    if return_keep:
        return pts, colors, keep
    return pts, colors


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    confidence: Optional[np.ndarray] = None,
) -> None:
    """ASCII PLY: a header, then one vertex per line (``%.6f`` x y z,
    uint8 colors rounded from [0, 1], and a ``%.4f`` per-vertex
    ``confidence`` when given)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    lines = ["ply", "format ascii 1.0", f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    conf = None
    if confidence is not None:
        lines.append("property float confidence")
        conf = np.asarray(confidence, np.float32).reshape(-1)
        if conf.shape[0] != n:
            raise ValueError(f"confidence has {conf.shape[0]} values for {n} points")
    lines.append("end_header")
    c8 = None
    if colors is not None:
        c8 = np.clip(np.asarray(colors) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(points):
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if c8 is not None:
                row += f" {c8[i][0]} {c8[i][1]} {c8[i][2]}"
            if conf is not None:
                row += f" {conf[i]:.4f}"
            f.write(row + "\n")


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(points [M, 3], colors [M, 3] in [0, 1] or None) of an ASCII PLY
    written by :func:`write_ply`."""
    with open(path) as f:
        header = []
        for line in f:
            header.append(line.strip())
            if line.strip() == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
        has_color = any("uchar red" in h for h in header)
        rows = [f.readline().split() for _ in range(n)]
    arr = np.asarray(rows, np.float64).reshape(n, -1)
    pts = arr[:, :3].astype(np.float32)
    colors = arr[:, 3:6].astype(np.float32) / 255.0 if has_color else None
    return pts, colors
