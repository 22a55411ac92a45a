"""Image quality metrics: MSE, PSNR, SSIM and the Rec.601 luminance of
IR supervision.

Counterpart of the image half of ``dexnerf_tpu/core/metrics.py`` (the
depth-error metrics and colormaps come with ``apps/eval.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Rec.601 luma weights (reference train_nerf_ir.py:260-263).
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luminance of ``rgb`` [..., 3] -> [...]."""
    w = torch.tensor(LUMA_WEIGHTS, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def img2mse(img_src: torch.Tensor, img_tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean((img_src - img_tgt) ** 2)


def mse2psnr(mse: float) -> float:
    """PSNR from MSE, with the reference's guard for MSE 0."""
    mse = float(mse)
    if mse == 0:
        mse = 1e-5
    return -10.0 * math.log10(mse)


def ssim(
    img_a: torch.Tensor,
    img_b: torch.Tensor,
    *,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) between two [H, W, C] (or
    [H, W]) images: Gaussian-windowed statistics by separable depthwise
    VALID convolutions, mean over window positions and channels.

    The convolutions run in full float32: cuDNN's TF32 default rounds the
    operands to 10 mantissa bits, which breaks the ``E[x^2] - mu^2``
    cancellation (``c2`` is only 9e-4) and can push SSIM past 1."""
    a = img_a.to(torch.float32)
    b = img_b.to(torch.float32)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c = a.shape[-1]
    window_size = min(window_size, a.shape[0], a.shape[1])
    half = window_size // 2
    x = torch.arange(window_size, dtype=torch.float32, device=a.device) - half
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    w = w / torch.sum(w)
    kh = w.reshape(1, 1, window_size, 1).repeat(c, 1, 1, 1)
    kv = w.reshape(1, 1, 1, window_size).repeat(c, 1, 1, 1)

    def blur(img):  # [H, W, C] -> [C, H', W']
        t = img.permute(2, 0, 1)[None]
        t = F.conv2d(t, kh, groups=c)
        t = F.conv2d(t, kv, groups=c)
        return t[0]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu_a = blur(a)
        mu_b = blur(b)
        var_a = blur(a * a) - mu_a * mu_a
        var_b = blur(b * b) - mu_b * mu_b
        cov = blur(a * b) - mu_a * mu_b
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
