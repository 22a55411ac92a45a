"""Occupancy-grid-guided ray-interval tightening (empty-space skipping).

Counterpart of ``dexnerf_tpu/render/occupancy.py``: a binary σ-occupancy
grid is baked from a trained density field, and each ray's ``[near, far]``
is then tightened to the span that meets occupied space, so the renderer's
fixed sample budget lands where matter is. The tightened intervals ride
the per-ray ``RayBatch.near/far``: the render and train-loss kernels sample
``stratified_z_vals(rays.near, rays.far)`` already, so no kernel changes.

* The bake evaluates relu(σ) of the plain model on a dense lattice in
  blocks of points (the σ evaluation ``apps.mesh`` uses too), then dilates
  the thresholded grid by 3³ max-pools so that thin structures survive.
* Tightening probes K midpoints along each ray, looks each up in the grid
  with one flat gather, and brackets the occupied probes with one probe
  step of margin; rays that hit nothing keep their interval, so the field
  composites to background there exactly as before.

NDC rays are refused by the callers: occupancy lives in world space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# a field maps points [N, S, 3] and viewdirs [N, 3] to raw [N, S, 4]
FieldFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Axis-aligned binary occupancy over ``[center - radius, center + radius]³``.

    ``occ``: [R, R, R] bool; cell (i, j, k) covers the half-open box whose
    min corner is ``center - radius + (i, j, k) * spacing`` with
    ``spacing = 2 * radius / R``. ``center`` [3] and ``radius`` [] are
    float32 tensors on the grid's device."""

    occ: torch.Tensor
    center: torch.Tensor
    radius: torch.Tensor

    @property
    def resolution(self) -> int:
        return int(self.occ.shape[0])

    def occupancy_fraction(self) -> float:
        return float(self.occ.float().mean())


def lattice_axis(resolution: int, radius: float, style: str = "centers") -> np.ndarray:
    """The lattice's coordinates along one axis, relative to the center:
    cell centers (``"centers"``, the grid as a volume classifier) or the
    inclusive corner nodes (``"corners"``, isosurface extraction)."""
    n = int(resolution)
    if style == "corners":
        return np.linspace(-float(radius), float(radius), n, dtype=np.float32)
    if style == "centers":
        spacing = 2.0 * float(radius) / n
        return (np.arange(n, dtype=np.float32) + 0.5) * spacing - float(radius)
    raise ValueError(f"unknown lattice style {style!r}")


def eval_sigma_grid(
    field: FieldFn,
    *,
    device,
    center=(0.0, 0.0, 0.0),
    radius: float = 1.5,
    resolution: int = 128,
    batch: int = 65536,
    style: str = "centers",
) -> torch.Tensor:
    """relu(σ) of ``field`` on a dense ``resolution³`` lattice on ``device``,
    ``batch`` points at a time. σ is view-independent, so every point takes
    the fixed +z view direction. Returns [R, R, R] float32, ordered ``ij``
    (x-major)."""
    n = int(resolution)
    device = torch.device(device)
    lin = torch.as_tensor(lattice_axis(n, radius, style), device=device)
    c = torch.as_tensor(np.asarray(center, np.float32), device=device)
    total = n ** 3
    sigma = torch.empty(total, dtype=torch.float32, device=device)
    with torch.inference_mode():
        for i in range(0, total, int(batch)):
            idx = torch.arange(i, min(i + int(batch), total), device=device)
            pts = torch.stack([lin[idx // (n * n)], lin[(idx // n) % n], lin[idx % n]], -1) + c
            vd = pts.new_tensor([0.0, 0.0, 1.0]).expand(pts.shape[0], 3)
            sigma[i:i + pts.shape[0]] = field(pts[:, None, :], vd)[:, 0, 3].clamp_min(0.0)
    return sigma.reshape(n, n, n)


def dilate_occupancy(occ: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """Binary dilation by ``rounds`` cells (one 3³ max-pool a round, the
    outside padded with -inf)."""
    x = occ.float()[None, None]
    for _ in range(int(rounds)):
        x = F.max_pool3d(x, kernel_size=3, stride=1, padding=1)
    return x[0, 0] > 0.5


def build_occupancy_grid(
    field: FieldFn,
    *,
    device,
    sigma_threshold: float,
    center=(0.0, 0.0, 0.0),
    radius: float = 1.5,
    resolution: int = 128,
    dilate: int = 1,
    batch: int = 65536,
) -> OccupancyGrid:
    """Bake the σ > ``sigma_threshold`` grid of ``field`` on ``device``,
    dilated ``dilate`` rounds. A threshold far below the scene's surface
    threshold keeps semi-transparent fringes inside the interval."""
    sigma = eval_sigma_grid(field, device=device, center=center, radius=radius,
                            resolution=resolution, batch=batch)
    occ = sigma > float(sigma_threshold)
    if dilate:
        occ = dilate_occupancy(occ, dilate)
    device = torch.device(device)
    return OccupancyGrid(
        occ=occ,
        center=torch.as_tensor(np.asarray(center, np.float32), device=device),
        radius=torch.tensor(float(radius), dtype=torch.float32, device=device),
    )


def probe_depths(near: torch.Tensor, far: torch.Tensor, num_probes: int) -> torch.Tensor:
    """The ``num_probes`` midpoints of each ``[near, far]``: [N, K]."""
    k = int(num_probes)
    frac = (torch.arange(k, dtype=torch.float32, device=near.device) + 0.5) / k
    return near[..., None] + (far - near)[..., None] * frac


def probe_coords(grid: OccupancyGrid, origins, directions, t) -> List[torch.Tensor]:
    """Per axis, the probes' grid coordinates in cells [N, K], before the
    floor that picks their cell."""
    lo = grid.center - grid.radius
    inv_spacing = grid.resolution / (2.0 * grid.radius)
    return [(origins[..., a:a + 1] + directions[..., a:a + 1] * t - lo[a]) * inv_spacing
            for a in range(3)]


def tighten_ray_intervals(
    grid: OccupancyGrid,
    origins: torch.Tensor,
    directions: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    *,
    num_probes: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray tightened ``(near, far)`` from ``num_probes`` midpoint probes
    of ``[near, far]``: the occupied span with one probe step of margin on
    each side, clipped to the interval; rays with no occupied probe keep
    their interval. With ``dilate=1`` occupied blobs are at least 3 cells
    wide, so ``num_probes >= (far - near) / (3 * spacing)`` cannot step
    over one."""
    k = int(num_probes)
    res = grid.resolution
    near = near.float()
    far = far.float()
    t = probe_depths(near, far, k)
    flat = inb = None
    for u in probe_coords(grid, origins, directions, t):
        ia = torch.floor(u)
        inb_a = (ia >= 0) & (ia < res)
        inb = inb_a if inb is None else inb & inb_a
        ia = ia.long().clamp_(0, res - 1)
        flat = ia if flat is None else flat * res + ia
    hit = grid.occ.reshape(-1)[flat] & inb  # [N, K]
    big = torch.finfo(torch.float32).max
    t0 = torch.where(hit, t, big).amin(-1)
    t1 = torch.where(hit, t, -big).amax(-1)
    step = (far - near) / k
    any_hit = hit.any(-1)
    new_near = torch.where(any_hit, torch.maximum(near, t0 - step), near)
    new_far = torch.where(any_hit, torch.minimum(far, t1 + step), far)
    return new_near, new_far


def tighten_store_intervals(
    grid: OccupancyGrid,
    data: torch.Tensor,
    near: float,
    far: float,
    *,
    num_probes: int = 64,
    block: int = 65536,
) -> torch.Tensor:
    """Tightened per-ray ``[N, 2]`` intervals of a whole packed ray store
    (``RayStore.data``: origins in columns 0:3, directions 3:6), ``block``
    rays at a time. Each call starts from the scene's scalar ``near`` /
    ``far``, never from an earlier tightening, so re-bakes cannot compound
    clipping."""
    n = int(data.shape[0])
    out = torch.empty((n, 2), dtype=torch.float32, device=data.device)
    with torch.no_grad():
        for i in range(0, n, int(block)):
            rows = data[i:i + int(block)]
            full = torch.full((rows.shape[0],), float(near), dtype=torch.float32,
                              device=data.device)
            tn, tf = tighten_ray_intervals(
                grid, rows[:, 0:3], rows[:, 3:6], full, torch.full_like(full, float(far)),
                num_probes=num_probes)
            out[i:i + rows.shape[0], 0] = tn
            out[i:i + rows.shape[0], 1] = tf
    return out


def tighten_image_intervals(
    grid: OccupancyGrid,
    origins: torch.Tensor,
    directions: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    img_shape: Tuple[int, int],
    *,
    num_probes: int = 128,
    subsample: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-frame tightening over pixel coherence: probe every
    ``subsample``-th pixel in each axis, spread each probed interval to its
    neighbours with a 3x3 min window on near and max window on far, upsample
    by nearest neighbour and clamp to the full interval. A probed miss keeps
    the full interval, so the windows spread full intervals, never clipped
    ones, into uncertain regions. When ``subsample`` <= 1 or does not divide
    H and W, every ray is probed (:func:`tighten_ray_intervals`)."""
    s = int(subsample)
    h, w = int(img_shape[0]), int(img_shape[1])
    if s <= 1 or (h % s) or (w % s):
        return tighten_ray_intervals(grid, origins, directions, near, far, num_probes=num_probes)
    ro = origins.reshape(h, w, 3)[::s, ::s]
    rd = directions.reshape(h, w, 3)[::s, ::s]
    nr = near.reshape(h, w)[::s, ::s]
    fr = far.reshape(h, w)[::s, ::s]
    t_near, t_far = tighten_ray_intervals(
        grid, ro.reshape(-1, 3), rd.reshape(-1, 3), nr.reshape(-1), fr.reshape(-1),
        num_probes=num_probes)
    hs, ws = h // s, w // s
    t_near = -F.max_pool2d(-t_near.reshape(1, 1, hs, ws), 3, stride=1, padding=1)[0, 0]
    t_far = F.max_pool2d(t_far.reshape(1, 1, hs, ws), 3, stride=1, padding=1)[0, 0]
    up_near = t_near.repeat_interleave(s, 0).repeat_interleave(s, 1)
    up_far = t_far.repeat_interleave(s, 0).repeat_interleave(s, 1)
    near2 = torch.maximum(near.float().reshape(h, w), up_near)
    far2 = torch.minimum(far.float().reshape(h, w), up_far)
    near2 = torch.minimum(near2, far2)
    return near2.reshape(-1), far2.reshape(-1)
