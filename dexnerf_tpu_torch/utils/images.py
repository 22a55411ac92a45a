"""Image conversion helpers of the CLI apps, and their PNG and GIF writers.

Counterpart of ``dexnerf_tpu/utils/images.py``. The jet colormap is
matplotlib's ``cm.jet`` (its 256-entry lookup table, built from the same
segment data the same way), so that the port needs no matplotlib and
gives the same bytes. PNGs and GIFs are written with PIL.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

# matplotlib's jet: per channel, (x, y_left, y_right) breakpoints
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_JET_N = 256


def cast_to_image(rgb: np.ndarray) -> np.ndarray:
    """Float [0, 1] HWC -> uint8 (reference ``train_nerf_rgb.py:447-455``)."""
    return (np.clip(np.asarray(rgb), 0.0, 1.0) * 255).astype(np.uint8)


def cast_to_gray_image(img: np.ndarray) -> np.ndarray:
    """Grayscale-aware cast (reference ``train_nerf_ir.py:449-459``): an
    [H, W, 3] image becomes its Rec.601 luma."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr @ np.array([0.299, 0.587, 0.114], dtype=arr.dtype)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def cast_to_disparity_image(disp: np.ndarray, max_disp: float = 2.0) -> np.ndarray:
    """Disparity clamped to [0, max_disp], scaled to uint8 (reference
    ``eval_nerf.py:34-45``)."""
    img = np.clip(np.asarray(disp), 0.0, max_disp) / max_disp
    return (img * 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _jet_lut() -> np.ndarray:
    """[256 + 1, 3] float64: jet's lookup table, then the color of NaN
    (0). Each channel is the piecewise-linear map of its breakpoints
    sampled at 256 evenly spaced points, as matplotlib's
    ``_create_lookup_table`` samples it."""
    n = _JET_N
    cols = []
    for ch in ("red", "green", "blue"):
        a = np.array(_JET_DATA[ch], dtype=float)
        x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.concatenate([np.stack(cols, -1), np.zeros((1, 3))], 0)


def apply_jet_colormap(gray01: np.ndarray) -> np.ndarray:
    """Jet colormap on a [0, 1] image -> uint8 RGB, as ``(cm.jet(x)[...,
    :3] * 255).astype(uint8)`` (reference ``eval_nerf.py:196-205``): the
    index is ``int(x * 256)`` in the input's dtype (256 -> 255), NaN black."""
    xa = np.array(np.clip(np.asarray(gray01), 0, 1), copy=True)
    if xa.dtype.kind != "f":
        raise TypeError("apply_jet_colormap takes a float image in [0, 1]")
    bad = np.isnan(xa)
    xa *= _JET_N
    xa[xa == _JET_N] = _JET_N - 1
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[bad] = _JET_N
    return (_jet_lut()[idx] * 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit gray [H, W] or RGB [H, W, 3] image as a PNG."""
    from PIL import Image

    Image.fromarray(np.asarray(img)).save(path, format="PNG")


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float) -> None:
    """uint8 RGB frames as a looping GIF shown at ``fps`` (each frame
    ``1000 / fps`` ms, ``fps`` at least 0.1, as the JAX package's
    ``imageio.mimwrite(duration=1000 / fps, loop=0)``)."""
    from PIL import Image

    ims = [Image.fromarray(np.asarray(f)) for f in frames]
    ims[0].save(
        path, format="GIF", save_all=True, append_images=ims[1:],
        duration=1000.0 / max(float(fps), 0.1), loop=0,
    )
