"""Fused inverse-CDF sampling: weights -> PDF -> CDF -> rank -> lerp in
one launch.

Counterpart of ``dexnerf_tpu/ops/sample_pdf_pallas.py``, whose Pallas kernel
(``_sample_pdf_kernel``) this module's CUDA kernel (``sample_pdf_kernel`` in
``ops/csrc/resample.cu``, the inverse-CDF half of the resample kernel as
its own launch) replaces. The public names are the JAX package's:
:func:`sample_pdf_pallas` and the drop-in :func:`sample_pdf_branchless`.
On a CUDA tensor they launch the kernel; on a CPU tensor they run
:func:`sample_pdf_reference`, the gather-free formula of the JAX
package's ``_sample_pdf_branchless_xla``. As in the JAX package, no product
path calls this op: the renderer resamples through
``core.sampling.sample_pdf``.

The kernel is bound by bytes (~8.3 MB for 8192 rays of 63 bins and 64
draws, a 2.5 us bound at 3.35 TB/s); one warp per ray scans the CDF and
ranks each draw by a binary search of it in shared memory. ``launches``
counts kernel launches (+1 per launch, nowhere else).
"""

from __future__ import annotations

from typing import Optional

import torch

from dexnerf_tpu_torch.core.sampling import linspace

launches = 0

MAX_BINS = 512  # bins (M + 1) per ray: a lane of ops/csrc/resample.cu holds up to 16 weights
_BIG = 1e30


def sample_pdf_reference(
    bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: weights + 1e-5 -> PDF -> CDF with a leading
    zero; the entries <= u bracket it from below (masked maxima) and the
    rest from above (masked minima); u at or past cdf[-1] stays on the last
    bin; denominators below 1e-5 are taken as 1."""
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    le = cdf[..., None, :] <= u[..., :, None]  # [..., N, M+1]
    cdf_b, bins_b = cdf[..., None, :], bins[..., None, :]
    cdf_below = torch.where(le, cdf_b, -_BIG).amax(dim=-1)
    bins_below = torch.where(le, bins_b, -_BIG).amax(dim=-1)
    cdf_above = torch.where(le, _BIG, cdf_b).amin(dim=-1)
    bins_above = torch.where(le, _BIG, bins_b).amin(dim=-1)
    none_above = le.all(dim=-1)
    cdf_above = torch.where(none_above, cdf_below, cdf_above)
    bins_above = torch.where(none_above, bins_below, bins_above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def _launch(bins, weights, u):
    global launches
    from dexnerf_tpu_torch.ops._build import check, load_library

    B, M = weights.shape
    N = u.shape[-1]
    dev = weights.device
    for name, t, shape in (("bins", bins, (B, M + 1)), ("weights", weights, (B, M)),
                           ("u", u, (B, N))):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not 2 <= M + 1 <= MAX_BINS or N < 1:
        raise ValueError(f"{M + 1} bins, {N} draws: the kernel takes 2..{MAX_BINS} bins")
    lib = load_library()
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(
        lib,
        lib.dexnerf_sample_pdf(bins.data_ptr(), weights.data_ptr(), u.data_ptr(),
                               out.data_ptr(), B, M, N, stream),
        "sample_pdf kernel launch",
    )
    launches += 1
    return out


@torch.no_grad()
def sample_pdf_pallas(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Importance-sample depths: ``bins`` [B, M+1] ascending, ``weights``
    [B, M], ``u`` [B, N] draws (``linspace(0, 1, N)`` rows for the
    deterministic path) -> [B, N]. CUDA tensors go through the kernel, CPU
    tensors through :func:`sample_pdf_reference`. The name is the JAX op's;
    there is no Pallas here."""
    if weights.device.type == "cuda":
        return _launch(bins, weights, u)
    if weights.device.type == "cpu":
        return sample_pdf_reference(bins, weights, u)
    raise ValueError(f"no sample_pdf kernel for device {weights.device}")


def sample_pdf_branchless(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    *,
    det: bool,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in for ``core.sampling.sample_pdf`` through
    :func:`sample_pdf_pallas`: ``det=True`` draws the even grid in [0, 1];
    otherwise ``u`` [B, num_samples] carries the uniform draws."""
    if det:
        u = linspace(0.0, 1.0, num_samples, weights.dtype, weights.device)
        u = u.expand(*weights.shape[:-1], num_samples).contiguous()
    elif u is None:
        raise ValueError("det=False needs the draws u")
    return sample_pdf_pallas(bins, weights, u)
