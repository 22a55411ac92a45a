"""SO(3)/SE(3) Lie-group operations, for camera pose refinement.

Counterpart of ``dexnerf_tpu/core/lie.py`` (the reference's
``lieutils.py``): ``hat``/``vee`` of both groups, ``so3_exp``/``so3_log``,
``se3_exp``/``se3_log``, ``so3_inverse``/``se3_inverse`` and
``se3_transform``, batched over leading axes and differentiable by
autograd. Near the identity the exp coefficients come from their Taylor
series through the "double where": ``sqrt`` only ever sees a θ² bounded
away from 0, so the gradient at the zero twist every pose run starts from
is finite.

The 3x3 and 4x4 products are sums of elementwise products
(:func:`matmul3`), never ``torch.matmul``: on a card an f32 matmul follows
a global TF32 setting, which would put ~1e-2 of error on a camera 4 m from
the origin, the size of the corrections being learned. The JAX package
computes them at ``Precision.HIGHEST`` for the same reason.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small [..., n, k] x [..., k, m] factors, as a sum of
    elementwise products in full float32 whatever the TF32 settings."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _exp_coeffs(theta2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t²) from t², value and gradient finite at
    t = 0 (the Taylor branch carries both below 1e-8)."""
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
    return a, b


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    W = so3_hat(w)
    a, b = _exp_coeffs(theta2)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * matmul3(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (|w| in [0, π])."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + _EPS, 1.0 - _EPS)
    theta = torch.arccos(cos_theta)
    w = so3_vee((R - R.transpose(-1, -2)) / 2.0)
    scale = theta / torch.clamp(torch.sin(theta), min=_EPS)
    return torch.where(theta[..., None] < 1e-4, w, scale[..., None] * w)


def so3_inverse(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def se3_hat(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (w, v) -> [..., 4, 4]."""
    top = torch.cat([so3_hat(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    bottom = torch.zeros((*xi.shape[:-1], 1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def se3_vee(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_vee(X[..., :3, :3]), X[..., :3, 3]], dim=-1)


def _so3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V, with V v the translation of the twist's exp."""
    theta2 = torch.sum(w * w, dim=-1)
    W = so3_hat(w)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(safe_t2)
    _, b = _exp_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (safe_t2 * t))
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * matmul3(W, W)


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from a rotation [..., 3, 3] and a translation [..., 3]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros((*R.shape[:-2], 1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (w, v) -> rigid transform [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    return _rigid(so3_exp(w), matmul3(_so3_V(w), v[..., :, None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Rigid transform [..., 4, 4] -> twist [..., 6]."""
    w = so3_log(T[..., :3, :3])
    v = torch.linalg.solve(_so3_V(w), T[..., :3, 3][..., :, None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R_T = T[..., :3, :3].transpose(-1, -2)
    t_inv = -matmul3(R_T, T[..., :3, 3][..., :, None])[..., 0]
    return torch.cat([torch.cat([R_T, t_inv[..., :, None]], dim=-1), T[..., 3:, :]], dim=-2)


def se3_transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3]."""
    return matmul3(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]
