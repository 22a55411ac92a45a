"""Image resizes in numpy, written to give OpenCV's bytes.

The JAX package resizes with OpenCV (``cv2.resize``), which the card's
machine lacks. :func:`area_resize` computes what ``cv2.INTER_AREA``
computes for any downscale, for float32 and uint8 images of 1-4
channels, in OpenCV's own order of operations: at an integer factor the
mean of each block (a float32 sum in OpenCV's order times ``1 / area``;
uint8 sums rounded half up at a factor of 2 and half to even otherwise),
at any other scale the fractional-coverage weights of each destination
pixel (``computeResizeAreaTab``), applied per source row along x and then
along y in float32, uint8 rounded half to even. :func:`nearest_resize`
computes ``cv2.INTER_NEAREST``: the source index ``floor(i * src / dst)``
(not ``INTER_NEAREST_EXACT``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _scale(src: int, dst: int) -> float:
    """OpenCV's ``1. / (dst / src)``."""
    return 1.0 / (dst / src)


def _area_table(ssize: int, dsize: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """The source indices and float32 weights [dsize, n] of each
    destination pixel along one axis, in OpenCV's order (a weight of 0
    pads a shorter row)."""
    rows = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(int(np.floor(f2)), ssize - 1)
        s1 = min(int(np.ceil(f1)), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(f2 - s2, 1.0, cell) / cell))
        rows.append(row)
    n = max(len(r) for r in rows)
    idx = np.zeros((dsize, n), np.int64)
    weight = np.zeros((dsize, n), np.float32)
    for d, row in enumerate(rows):
        for j, (s, a) in enumerate(row):
            idx[d, j], weight[d, j] = s, a
    return idx, weight


def _area_fractional(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """OpenCV's ``resizeArea``: each source row weighted along x, then the
    rows weighted along y, accumulated in float32 in the tables' order."""
    sh, sw = img.shape[:2]
    xi, xw = _area_table(sw, w, _scale(sw, w))
    yi, yw = _area_table(sh, h, _scale(sh, h))
    src = img.astype(np.float32)
    tail = (None,) * (img.ndim - 2)
    along_x = (None, slice(None)) + tail
    along_y = (slice(None), None) + tail
    buf = src[:, xi[:, 0]] * xw[:, 0][along_x]
    for j in range(1, xi.shape[1]):
        buf = buf + src[:, xi[:, j]] * xw[:, j][along_x]
    out = yw[:, 0][along_y] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j][along_y] * buf[yi[:, j]]
    return out


def _area_blocks(img: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """OpenCV's ``resizeAreaFast`` at the integer factors ``fy`` x ``fx``."""
    h, w = img.shape[0] // fy, img.shape[1] // fx
    blocks = img[: h * fy, : w * fx].reshape(h, fy, w, fx, *img.shape[2:])
    if img.dtype == np.uint8:
        total = blocks.astype(np.int64).sum(axis=(1, 3))
        if fy == fx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        scaled = total.astype(np.float32) * np.float32(1.0 / (fx * fy))
        return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
    vals = [blocks[:, i, :, j] for i in range(fy) for j in range(fx)]
    # the scalar loop: four values a step, (((a + b) + c) + d), then the rest
    acc = np.zeros_like(vals[0])
    k = 0
    while k + 4 <= len(vals):
        acc = acc + (((vals[k] + vals[k + 1]) + vals[k + 2]) + vals[k + 3])
        k += 4
    for v in vals[k:]:
        acc = acc + v
    if fy == fx == 2 and (img.ndim == 2 or img.shape[2] in (1, 4)):
        # the vector loop at 2x2, (a + b) + (c + d): every pixel of 4
        # channels, the first multiple of 4 pixels of 1 channel
        a, b, c, d = vals
        n = w if img.ndim == 3 and img.shape[2] == 4 else (w // 4) * 4
        acc[:, :n] = ((a + b) + (c + d))[:, :n]
    return acc * np.float32(1.0 / (fx * fy))


def area_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` for a
    float32 or uint8 [H, W(, C)] image and ``size = (h, w)`` no larger
    than the image along either axis."""
    h, w = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"area_resize takes uint8 or float32 images, not {img.dtype}")
    if not (0 < h <= sh and 0 < w <= sw):
        raise ValueError(f"area_resize downscales: {sh}x{sw} -> {h}x{w}")
    sx, sy = _scale(sw, w), _scale(sh, h)
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    if abs(sx - ix) < _DBL_EPSILON and abs(sy - iy) < _DBL_EPSILON:
        return _area_blocks(img, iy, ix)
    out = _area_fractional(img, h, w)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def nearest_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` for
    ``size = (h, w)``: source row ``floor(i * H / h)``, column ``floor(j *
    W / w)``, each clamped to the image."""
    h, w = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * _scale(sh, h)).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * _scale(sw, w)).astype(np.int64), sw - 1)
    return np.ascontiguousarray(img[ys][:, xs])
