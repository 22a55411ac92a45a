"""Spherical-orbit camera poses (numpy only).

Counterpart of the pose helpers of ``dexnerf_tpu/data/blender.py``; the
blender loader itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
