"""Image and depth quality metrics: MSE, PSNR, SSIM, the Rec.601
luminance of IR supervision, the depth errors in millimeters and their
colormapped image.

Counterpart of ``dexnerf_tpu/core/metrics.py``: the depth metrics are the
reference's ``train_utils.py:9-70`` (torch on the metric side, numpy for
the error image).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
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


def compute_err_metric(depth_gt, depth_pred, mask) -> Dict[str, float]:
    """Depth metrics over the pixels of ``mask`` (reference
    ``train_utils.py:9-30``), in float32: ``depth_abs_err`` and
    ``depth_rmse`` in millimeters, and ``depth_err{2,4,8}``, the fraction
    of masked pixels whose |error| exceeds 2/4/8 mm (the denominator is the
    number of masked pixels, at least 1). An empty mask gives NaN errors
    and fractions 0.0, as the JAX package's unguarded mean does."""
    gt = torch.as_tensor(depth_gt).to(torch.float32)
    pred = torch.as_tensor(depth_pred, device=gt.device).to(torch.float32)
    mask = torch.as_tensor(mask, device=gt.device).to(torch.bool)
    gt, pred = gt[mask], pred[mask]
    diff = torch.abs(gt - pred)
    n = max(int(diff.numel()), 1)
    return {
        "depth_abs_err": float(torch.mean(torch.abs(pred - gt)) * 1000.0),
        "depth_rmse": float(torch.sqrt(torch.mean((pred - gt) ** 2)) * 1000.0),
        "depth_err2": float(torch.sum(diff > 2e-3)) / n,
        "depth_err4": float(torch.sum(diff > 4e-3)) / n,
        "depth_err8": float(torch.sum(diff > 8e-3)) / n,
    }


def gen_error_colormap_depth() -> np.ndarray:
    """11-band [lo, hi, r, g, b] colormap table (reference
    ``train_utils.py:31-45``), bands in millimeters."""
    bands = [0.0, 0.00001] + [2000.0 / 2**k for k in range(10, 1, -1)] + [np.inf]
    colors = [
        (0, 0, 0), (49, 54, 149), (69, 117, 180), (116, 173, 209), (171, 217, 233),
        (224, 243, 248), (254, 224, 144), (253, 174, 97), (244, 109, 67), (215, 48, 39),
        (165, 0, 38),
    ]
    cols = np.array([[bands[i], bands[i + 1], *c] for i, c in enumerate(colors)],
                    dtype=np.float32)
    cols[:, 2:5] /= 255.0
    return cols


def depth_error_img(
    depth_est: np.ndarray, depth_gt: np.ndarray, mask: np.ndarray, abs_thres: float = 1.0
) -> np.ndarray:
    """Colormapped |error| image [H, W, 3] (reference
    ``train_utils.py:46-70``). Inputs are batched [B, H, W]; the first
    element is returned, with the legend (one 20-pixel swatch per band)
    stamped into its top 10 rows."""
    depth_gt = np.asarray(depth_gt)
    depth_est = np.asarray(depth_est)
    mask = np.asarray(mask)
    B, H, W = depth_gt.shape
    error = np.abs(depth_gt - depth_est)
    error[np.logical_not(mask)] = 0
    error[mask] = error[mask] / abs_thres
    cols = gen_error_colormap_depth()
    error_image = np.zeros([B, H, W, 3], dtype=np.float32)
    for i in range(cols.shape[0]):
        error_image[np.logical_and(error >= cols[i][0], error < cols[i][1])] = cols[i, 2:]
    error_image[np.logical_not(mask)] = 0.0
    for i in range(cols.shape[0]):
        error_image[:, :10, i * 20:(i + 1) * 20, :] = cols[i, 2:]
    return error_image[0]
