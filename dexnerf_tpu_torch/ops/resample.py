"""Fused hierarchical resampling: the inverse-CDF fine depths, the merge
with the coarse depths and the fine pass's ray intervals, in one launch.

Counterpart of ``dexnerf_tpu/ops/resample_pallas.py`` (``make_fused_resample``),
whose Pallas kernel (``_make_resample_kernel``) this module's CUDA kernel
(``resample_kernel`` in ``ops/csrc/resample.cu``, built by ``ops/_build.py``)
replaces. On a CUDA tensor :func:`fused_resample` launches the kernel; on a
CPU tensor it runs :func:`fused_resample_reference`, the plain PyTorch
version (``hierarchical_z_vals`` on the given draws, then the
``ray_dists`` formula on the given direction norms). There is no fallback
between the two: a CUDA call that cannot launch raises.

The kernel is bound by bytes (~14.7 MB at 8192 rays x (64 + 64) samples, a
4.4 us bound at 3.35 TB/s); one warp per ray ranks each draw by a binary
search of the CDF in shared memory, sorts the fine depths in registers
(a warp bitonic sort) and places every depth in the merged row by a binary
search of the other list (see the source's note). ``launches`` counts
kernel launches (+1 per launch, nowhere else).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals

launches = 0

# limits of ops/csrc/resample.cu: a lane holds up to 8 coarse and 8 fine
# depths of its warp's ray (its kernels are instantiated for 1, 2, 4, 8)
MAX_COARSE = 256
MAX_FINE = 256


def fused_resample_reference(
    z_coarse: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, dir_norms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's contract: ``(z_merged [N, S],
    dists [N, S])`` with ``S = Sc + Sf``: the sorted concatenation of the
    coarse depths and the inverse-CDF samples of the draws ``u`` over the
    coarse midpoints (weights[1:-1]), and ``diff(z_merged) * |d|`` with a
    last interval of ``1e10 * |d|``."""
    z_merged, _ = hierarchical_z_vals(z_coarse, weights, u.shape[-1], det=False, u=u)
    last = torch.full_like(z_merged[..., :1], 1e10)
    dists = torch.cat([z_merged[..., 1:] - z_merged[..., :-1], last], dim=-1) * dir_norms
    return z_merged, dists


def _launch(z_coarse, weights, u, dir_norms):
    global launches
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, Sc = z_coarse.shape
    Sf = u.shape[-1]
    dev = z_coarse.device
    for name, t, shape in (
        ("z_coarse", z_coarse, (N, Sc)),
        ("weights", weights, (N, Sc)),
        ("u", u, (N, Sf)),
        ("dir_norms", dir_norms, (N, 1)),
    ):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not 3 <= Sc <= MAX_COARSE or not 1 <= Sf <= MAX_FINE:
        raise ValueError(
            f"{Sc} coarse and {Sf} fine samples: the kernel takes 3..{MAX_COARSE} "
            f"and 1..{MAX_FINE}"
        )
    lib = load_library()
    z_out = torch.empty((N, Sc + Sf), dtype=torch.float32, device=dev)
    d_out = torch.empty_like(z_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(
        lib,
        lib.dexnerf_resample(
            z_coarse.data_ptr(), weights.data_ptr(), u.data_ptr(), dir_norms.data_ptr(),
            z_out.data_ptr(), d_out.data_ptr(), N, Sc, Sf, stream,
        ),
        "resample kernel launch",
    )
    launches += 1
    return z_out, d_out


@torch.no_grad()
def fused_resample(
    z_coarse: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, dir_norms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hierarchical_z_vals`` with the draws ``u`` [N, Sf], then the fine
    intervals, for coarse depths ``z_coarse`` [N, Sc] (ascending per ray),
    their compositing ``weights`` [N, Sc] and the ray direction norms
    ``dir_norms`` [N, 1]. Nothing carries a gradient, as in the JAX path
    (its inputs and outputs are stop-gradient there). CUDA tensors go
    through the kernel, CPU tensors through
    :func:`fused_resample_reference`."""
    if z_coarse.device.type == "cuda":
        return _launch(z_coarse, weights, u, dir_norms)
    if z_coarse.device.type == "cpu":
        return fused_resample_reference(z_coarse, weights, u, dir_norms)
    raise ValueError(f"no fused resample for device {z_coarse.device}")


def make_fused_resample(num_coarse: int, num_fine: int):
    """``resample(z_coarse [N, Sc], weights [N, Sc], u [N, Sf], dir_norms
    [N, 1]) -> (z_merged [N, Sc + Sf], dists [N, Sc + Sf])`` for the
    counts of one configuration (the counterpart of ``make_fused_resample``;
    ``u`` is the draws the plain path would use: the uniforms of perturbed
    training or the ``linspace(0, 1, Sf)`` grid)."""
    Sc, Sf = int(num_coarse), int(num_fine)

    def resample(z_coarse, weights, u, dir_norms):
        if z_coarse.shape[-1] != Sc or u.shape[-1] != Sf:
            raise ValueError(
                f"built for {Sc} coarse and {Sf} fine samples, got "
                f"{z_coarse.shape[-1]} and {u.shape[-1]}"
            )
        return fused_resample(z_coarse, weights, u, dir_norms)

    return resample
