"""Frequency (Fourier-feature) positional encoding.

Counterpart of ``dexnerf_tpu/core/encoding.py``, with the reference
layout ``[x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]``:
frequency-major, the raw input first when ``include_input``.
"""

from __future__ import annotations

import torch


def encoding_dim(
    input_dim: int, num_frequencies: int, include_input: bool = True
) -> int:
    """Output feature size of :func:`positional_encoding`."""
    return input_dim * (2 * num_frequencies + (1 if include_input else 0))


def frequency_bands(
    num_frequencies: int,
    log_sampling: bool = True,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """The ``num_frequencies`` scales applied to the input:
    ``2**linspace(0, F-1, F)`` when ``log_sampling``, else
    ``linspace(1, 2**(F-1), F)``."""
    from dexnerf_tpu_torch.core.sampling import linspace

    if num_frequencies <= 0:
        return torch.zeros((0,), dtype=dtype, device=device)
    if log_sampling:
        exps = linspace(0.0, num_frequencies - 1, num_frequencies, dtype, device)
        return torch.pow(2.0, exps)
    return linspace(
        1.0, 2.0 ** (num_frequencies - 1), num_frequencies, dtype, device
    )


def positional_encoding(
    x: torch.Tensor,
    num_frequencies: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x[..., D]`` into ``[..., D * (2F + include_input)]``."""
    if num_frequencies <= 0:
        return x
    bands = frequency_bands(num_frequencies, log_sampling, x.dtype, x.device)
    scaled = x[..., None, :] * bands[:, None]  # [..., F, D]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], num_frequencies * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
