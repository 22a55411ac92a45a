"""Depth sampling along rays: stratified coarse samples + inverse-CDF fine
samples.

Counterpart of ``dexnerf_tpu/core/sampling.py``. The inverse-CDF rank is
``torch.searchsorted(..., right=True)``, i.e. ``count(cdf <= u)``,
followed by gathers. Functions that jitter take their uniform draws as an
argument, so a test can hand both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def linspace(start: float, stop: float, num: int, dtype=torch.float32, device=None):
    """``jnp.linspace`` as XLA computes it: ``start*(1-t) + stop*t`` with
    ``t = iota * (1/(num-1))`` and the last entry set to ``stop``.
    ``torch.linspace`` rounds some entries one ulp apart from it."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    recip = torch.ones((), dtype=dtype, device=device) / div
    t = torch.arange(div, dtype=dtype, device=device) * recip
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def stratified_z_vals(
    near: torch.Tensor, far: torch.Tensor, num_samples: int, *, lindisp: bool = False
) -> torch.Tensor:
    """Deterministic bin centers: linspace in depth (or in disparity).
    ``near``/``far`` are [...] per-ray scalars; returns [..., num_samples]."""
    t = linspace(0.0, 1.0, num_samples, near.dtype, near.device)
    near = near[..., None]
    far = far[..., None]
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def perturb_z_vals(z_vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified jitter: the sample moves to ``lower + (upper - lower) * u``
    within its bin, where the bins are cut at the midpoints. ``u`` holds
    the uniform draws, shaped like ``z_vals``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def weights_to_cdf(weights: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize weights[..., M] to a CDF [..., M+1] with a leading zero
    (with the reference's +1e-5 guard)."""
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    *,
    det: bool = True,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Importance-sample ``num_samples`` depths from a per-ray piecewise PDF.

    ``bins``: [..., M+1] sorted edges; ``weights``: [..., M]. ``det=True``
    uses an even grid in [0, 1]; otherwise the caller supplies the uniform
    draws ``u`` [..., num_samples].
    """
    cdf = weights_to_cdf(weights)  # [..., M+1]
    if u is None:
        if not det:
            raise ValueError("sample_pdf with det=False needs the draws u")
        u = linspace(0.0, 1.0, num_samples, weights.dtype, weights.device)
        u = u.expand(*cdf.shape[:-1], num_samples)
    u = u.contiguous()
    last = cdf.shape[-1] - 1
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    # u >= cdf[-1]: the reference clamps "above" to the last index, which
    # makes below == above there
    above = torch.clamp(inds, max=last)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_z_vals(
    z_vals_coarse: torch.Tensor,
    weights_coarse: torch.Tensor,
    num_fine: int,
    *,
    det: bool = True,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine-pass depths: sample_pdf over the coarse midpoints (dropping the
    first and last coarse weight), merged with the coarse depths and
    sorted. Returns (z_vals_merged [..., C+F], z_samples [..., F])."""
    z_mid = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    z_samples = sample_pdf(
        z_mid, weights_coarse[..., 1:-1], num_fine, det=det, u=u
    ).detach()
    z_merged, _ = torch.sort(torch.cat([z_vals_coarse, z_samples], dim=-1), dim=-1)
    return z_merged, z_samples
