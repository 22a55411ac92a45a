"""Spherical-Gaussian PBR shading (active-IR illumination rendering).

Counterpart of ``dexnerf_tpu/models/sg.py`` (the reference's dead
``SgRenderer``, ``nerf-pytorch/nerf/render.py`` + ``nerf/math_utils.py``,
implemented live). A scene's incident illumination is a mixture of
spherical Gaussians ``G(v) = a * exp(s * (v . axis - 1))``; shading
evaluates a Cook-Torrance style BRDF against that mixture in closed form
(the Neural-PIL / PhySG formulation): Lambert diffuse by a hemisphere-cosine
SG fit, GGX specular by an SG warp of the NDF, Schlick Fresnel.

Plain functions on ``[..., L, 7]`` SG tensors (amplitude 3, axis 3,
sharpness 1). Every clip and max/min is ``torch.maximum``/``torch.minimum``
against a tensor bound, never ``torch.clamp``: at a tie (x equal to the
bound) they split the gradient in halves, as ``jnp.clip``/``jnp.maximum``
do, where ``clamp`` passes it whole. Ties occur: a zero density gradient
(every ReLU of the σ path dead) gives a zero normal, which ``sg_shade``
replaces by the view direction, whose dots then saturate at exactly 0 or 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-7


def _max(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(bound))


def _min(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(bound))


# -- numeric helpers (reference nerf/math_utils.py surface) ------------------

def saturate(x: torch.Tensor, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """``jnp.clip(x, low, high)``: ``minimum(maximum(x, low), high)``."""
    return _min(_max(x, low), high)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = saturate(x)
    return torch.where(x >= 0.04045, ((_max(x, 0.04045) + 0.055) / 1.055) ** 2.4, x / 12.92)


def mix(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = saturate(a)
    return x * (1 - a) + y * a


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_max(x, _EPS))


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(_min(x, 87.5))


def safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(_min(x, 33e37))


def magnitude(x: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(dot(x, x))


def normalize(x: torch.Tensor) -> torch.Tensor:
    m = magnitude(x)
    # the bound in the tensor's dtype, as jnp.sqrt(_EPS) is: magnitude's
    # floor, sqrt(_EPS), must compare equal to it
    return torch.where(m <= torch.sqrt(m.new_tensor(_EPS)), torch.zeros_like(x), x / m)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * dot(d, n) * n


# -- spherical gaussians -----------------------------------------------------

class SG(NamedTuple):
    """A spherical-Gaussian mixture, unpacked."""

    amplitude: torch.Tensor  # [..., 3] (>= 0)
    axis: torch.Tensor  # [..., 3] (unit)
    sharpness: torch.Tensor  # [..., 1] in [0.5, 30]


def unpack_sg(sg: torch.Tensor, compress_amplitude: bool = False,
              compress_sharpness: bool = False) -> SG:
    """[..., 7] packed -> SG (abs/normalize/saturate, optional log-space)."""
    amp = safe_exp(sg[..., 0:3]) if compress_amplitude else sg[..., 0:3]
    sharp = safe_exp(sg[..., 6:7]) if compress_sharpness else sg[..., 6:7]
    return SG(amplitude=torch.abs(amp), axis=normalize(sg[..., 3:6]),
              sharpness=saturate(sharp, 0.5, 30.0))


def pack_sg(amplitude: torch.Tensor, axis: torch.Tensor, sharpness: torch.Tensor) -> torch.Tensor:
    return torch.cat([amplitude, axis, sharpness.expand(*axis.shape[:-1], 1)], dim=-1)


def sg_evaluate(sg: SG, d: torch.Tensor) -> torch.Tensor:
    """Evaluate the mixture lobes along direction d."""
    return sg.amplitude * safe_exp(sg.sharpness * (dot(d, sg.axis) - 1.0))


def sg_integral(sg: SG) -> torch.Tensor:
    """Closed-form integral of an SG over the sphere."""
    exp_term = 1.0 - safe_exp(-2.0 * sg.sharpness)
    return 2.0 * np.pi * (sg.amplitude / sg.sharpness) * exp_term


def sg_inner_product(a: SG, b: SG) -> torch.Tensor:
    """Closed-form integral of the product of two SGs over the sphere."""
    um_len = magnitude(a.sharpness * a.axis + b.sharpness * b.axis)
    expo = safe_exp(um_len - a.sharpness - b.sharpness) * a.amplitude * b.amplitude
    other = 1.0 - safe_exp(-2.0 * um_len)
    return (2.0 * np.pi * expo * other) / um_len


# -- BRDF terms --------------------------------------------------------------

def ggx_ndf_sg(normal: torch.Tensor, roughness: torch.Tensor) -> SG:
    """GGX normal-distribution function approximated as an SG about n."""
    a2 = saturate(roughness * roughness, 1e-3)
    amp = (1.0 / (np.pi * a2)).expand(*normal.shape[:-1], 3)
    return SG(amplitude=amp, axis=normal, sharpness=2.0 / _max(a2, 1e-6))


def sg_warp_distribution(ndf: SG, view_dir: torch.Tensor) -> SG:
    """Warp the NDF SG from half-vector space into reflection space."""
    return SG(
        amplitude=ndf.amplitude,
        axis=reflect(-view_dir, ndf.axis),
        sharpness=ndf.sharpness / (4.0 * saturate(dot(ndf.axis, view_dir), 1e-4)),
    )


def _ggx_smith(a2: torch.Tensor, ndx: torch.Tensor) -> torch.Tensor:
    return 1.0 / (ndx + safe_sqrt(a2 + (1 - a2) * ndx * ndx))


def evaluate_diffuse(illum: SG, diffuse_albedo: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Lambert diffuse under the SG mixture (hemisphere-cosine fit)."""
    diff = diffuse_albedo / np.pi
    mudn = saturate(dot(illum.axis, normal))

    c0 = 0.36
    c1 = 1.0 / (4.0 * c0)
    eml = safe_exp(-illum.sharpness)
    em2l = eml * eml
    rl = 1.0 / illum.sharpness
    scale = 1.0 + 2.0 * em2l - rl
    bias = (eml - em2l) * rl - em2l

    x = safe_sqrt(1.0 - scale)
    x0 = c0 * mudn
    x1 = c1 * x
    n = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, n * (n / _max(x, 1e-6)), mudn)
    return (scale * y + bias) * sg_integral(illum) * diff


def evaluate_specular(illum: SG, specular_f0: torch.Tensor, roughness: torch.Tensor,
                      warped_ndf: SG, ndl: torch.Tensor, ndv: torch.Tensor,
                      ldh: torch.Tensor) -> torch.Tensor:
    a2 = saturate(roughness * roughness, 1e-3)
    D = sg_inner_product(warped_ndf, illum)
    G = _ggx_smith(a2, ndl) * _ggx_smith(a2, ndv)
    F = specular_f0 + (1.0 - specular_f0) * (1.0 - ldh) ** 5
    return _max(D * G * F * ndl, 0.0)


def sg_shade(
    sg_illuminations: torch.Tensor,
    basecolor: torch.Tensor,
    metallic: torch.Tensor,
    roughness: torch.Tensor,
    normal: torch.Tensor,
    view_dir: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    *,
    eval_background: bool = False,
    compress_amplitude: bool = False,
    compress_sharpness: bool = False,
) -> torch.Tensor:
    """Shade surface points under an SG illumination mixture.

    ``sg_illuminations``: [B, L, 7]; ``basecolor``: [B, 3] (sRGB);
    ``metallic``/``roughness``: [B, 1]; ``normal``/``view_dir``: [B, 3];
    ``alpha``: [B] or [B, 1] (only with ``eval_background``). Returns [B, 3]
    linear radiance (relu-clamped), the reference ``SgRenderer``'s forward
    contract (``render.py:19-60``).
    """
    lin_base = srgb_to_linear(basecolor)
    diffuse = lin_base * (1 - metallic)
    specular = mix(torch.ones_like(lin_base) * 0.04, lin_base, metallic)
    normal = torch.where(normal == 0.0, view_dir, normal)

    # lift to [B, 1, ...] so the SG lobe axis L broadcasts
    diffuse = diffuse[:, None, :]
    specular = specular[:, None, :]
    roughness = roughness[:, None, :]
    normal = normalize(normal)[:, None, :]
    view_dir = normalize(view_dir)[:, None, :]

    illum = unpack_sg(sg_illuminations, compress_amplitude, compress_sharpness)

    ndf = ggx_ndf_sg(normal, roughness)
    warped = sg_warp_distribution(ndf, view_dir)
    ndl = saturate(dot(normal, warped.axis))
    ndv = saturate(dot(normal, view_dir))
    h = normalize(warped.axis + view_dir)
    ldh = saturate(dot(warped.axis, h))

    brdf = evaluate_diffuse(illum, diffuse, normal) + evaluate_specular(
        illum, specular, roughness, warped, ndl, ndv, ldh)
    brdf = torch.sum(brdf, dim=1)

    if eval_background:
        if alpha is None:
            raise ValueError("eval_background requires alpha")
        env = torch.sum(sg_evaluate(illum, view_dir), dim=1)
        if alpha.ndim == 1:
            alpha = alpha[:, None]
        alpha = saturate(alpha)
        return _max(brdf * alpha + env * (1 - alpha), 0.0)
    return _max(brdf, 0.0)
