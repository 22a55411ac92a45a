"""Fused field evaluation: positional encoding -> FlexibleNeRF MLP -> raw
[N, S, 4], with the encodings and activations kept on chip.

Counterpart of ``dexnerf_tpu/ops/fused_mlp.py`` (``make_fused_flexible_field``),
whose Pallas kernel (``_make_fwd_kernel``) this module's CUDA kernels
(built by ``ops/_build.py``) replace, with its ``compute_dtype`` (float32
by default, as in JAX; training resolves it from
``nerf.pallas_compute_dtype``, bf16 by default). On a CUDA tensor
:func:`fused_field` launches kernel 4's prep and forward kernels of the
dtype with the launcher tag 2, reading the points from ``pts``, writing raw
straight to the output and saving nothing: at float32 those of
``ops/csrc/fused_train_loss.cu`` (split TF32 on ``wgmma``, layer1 a
sequential f32 FMA chain; ~156k multiply-adds per sample of the 8x128
model; ``fused_train_loss.Tf32Pass``), at bfloat16 those of
``ops/csrc/fused_train_loss_bf16.cu`` (kernel 1's bf16 tile on ``wgmma``).
On a CPU tensor it runs
:func:`fused_field_reference`, the plain PyTorch version at that dtype
(``model`` on the encodings, or ``flex_forward_bf16``). There is no
fallback between them: a CUDA call that cannot launch raises. The port's
weights live in the model, so a field function is bound to its model when
it is built: ``field(pts, viewdirs) -> raw``. It is also the forward of
the training field (``ops/fused_mlp_train.py``); times are in ``PERF.md``.

``launches`` counts kernel-2 launches of either dtype, ``launches_bf16``
those of the bf16 route, ``launches_wide`` those of its wide route and
``launches_wide_f32`` those of the f32 route's (a model wider than 128:
kernel 4's wide forward of the dtype) (+1 per launch, nowhere else).
Widths: as ``ops/fused_render.py::check_width``.
"""

from __future__ import annotations

import ctypes

import torch

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.ops.fused_render import (
    _check_compute_dtype,
    check_fusable,
    check_width,
    flex_forward_bf16,
    is_wide,
)

launches = 0  # kernel-2 launches of either dtype
launches_bf16 = 0  # of which the bf16 route's (narrow or wide)
launches_wide = 0  # of which the wide bf16 kernels'
launches_wide_f32 = 0  # of which the wide f32 kernels'

# limits of the kernels (ops/csrc/fused_train_loss*.cu); any number of samples
MAX_LAYERS = ftl.MAX_LAYERS
MAX_FREQ = ftl.MAX_FREQ


def fused_field_reference(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels' contract: ``model`` on the
    encodings of ``pts`` [N, S, 3] and of the per-ray ``viewdirs`` [N, 3]
    -> raw [N, S, 4] (rgb logits, σ logit); at bfloat16 the model's forward
    under the JAX package's bf16 contract (``flex_forward_bf16``).
    Differentiable (at float32)."""
    _check_compute_dtype(compute_dtype)
    xyz = positional_encoding(
        pts, model.num_encoding_fn_xyz, model.include_input_xyz, log_sampling_xyz
    )
    view = positional_encoding(
        viewdirs, model.num_encoding_fn_dir, model.include_input_dir, log_sampling_dir
    )
    if compute_dtype == torch.bfloat16:
        return flex_forward_bf16(model, xyz, view)
    return model(xyz, view, dtype=torch.float32)  # not the model's own plain-path dtype


def check_field_inputs(model, tensors, compute_dtype) -> None:
    """Device, dtype, contiguity and shape of ``tensors`` ((name, tensor,
    shape), ...) and the model's fit to the limits of the kernels at
    ``compute_dtype``."""
    check_fusable(model, "the field kernels")
    dev = tensors[0][1].device
    for name, t, shape in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    for p in model.parameters():
        if p.device != dev or p.dtype != torch.float32:
            raise ValueError(f"model parameters must be float32 on {dev}")
    check_width(model.hidden_size, compute_dtype, "the field kernels")
    nt = model.num_layers - 1
    if nt + 5 > MAX_LAYERS or nt > 31:
        raise ValueError(f"{model.num_layers} layers: too deep for the kernels")
    if max(model.num_encoding_fn_xyz, model.num_encoding_fn_dir) > MAX_FREQ:
        raise ValueError(f"the kernels take at most {MAX_FREQ} PE frequencies")


def _launch(model, pts, viewdirs, *, log_sampling_xyz, log_sampling_dir,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Kernel 2 at ``compute_dtype`` on CUDA tensors."""
    global launches, launches_bf16, launches_wide, launches_wide_f32
    from dexnerf_tpu_torch.ops._build import check, load_library

    _check_compute_dtype(compute_dtype)
    N, S = pts.shape[:2]
    check_field_inputs(model, [("pts", pts, (N, S, 3)), ("viewdirs", viewdirs, (N, 3))],
                       compute_dtype)
    lib = load_library()
    raw = torch.empty((N, S, 4), dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    if compute_dtype == torch.bfloat16:
        args, keep = ftl.bf16_args(lib, model, N, S, log_sampling_xyz=log_sampling_xyz,
                                   log_sampling_dir=log_sampling_dir)
        args.pts, args.viewdirs, args.raw = pts.data_ptr(), viewdirs.data_ptr(), raw.data_ptr()
        args.ray0, args.n_rays = 0, N
        check(lib, lib.dexnerf_field_bf16_pass(ctypes.addressof(args), None, N * S,
                                               -(-N * S // 128), 0, stream),
              "fused field bf16 forward launch")
        launches_bf16 += 1
        launches_wide += int(is_wide(model))
    else:  # every ray in one launch pair: no scratch to cap
        ftl.Tf32Pass(lib, model, dict(pts=pts, viewdirs=viewdirs, raw=raw), N, S, ftl.s_pad_of(S),
                     max(1, N), None, owner=ftl.FIELD_FWD, log_sampling_xyz=log_sampling_xyz,
                     log_sampling_dir=log_sampling_dir).run(0, stream)
        launches_wide_f32 += int(is_wide(model))
    launches += 1
    return raw


@torch.no_grad()
def fused_field(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """raw [N, S, 4] of ``model`` at ``pts`` [N, S, 3] seen along the
    per-ray ``viewdirs`` [N, 3] at ``compute_dtype`` (float32 or
    bfloat16); forward only (the training field is ``ops.fused_mlp_train``).
    CUDA tensors go through the kernel of the dtype, CPU tensors through
    :func:`fused_field_reference`."""
    kw = dict(log_sampling_xyz=log_sampling_xyz, log_sampling_dir=log_sampling_dir,
              compute_dtype=compute_dtype)
    if pts.device.type == "cuda":
        return _launch(model, pts, viewdirs, **kw)
    if pts.device.type == "cpu":
        return fused_field_reference(model, pts, viewdirs, **kw)
    raise ValueError(f"no fused field for device {pts.device}")


def make_fused_flexible_field(
    model: FlexibleNeRFModel, *, log_sampling_xyz: bool = True, log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
):
    """``field(pts [N, S, 3], viewdirs [N, 3]) -> raw [N, S, 4]`` through
    :func:`fused_field` on ``model`` at ``compute_dtype`` (the counterpart
    of ``make_fused_flexible_field``, whose weights are an argument
    instead; float32 by default, as there)."""
    _check_compute_dtype(compute_dtype)
    check_fusable(model, "the field kernels")

    def field(pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        return fused_field(
            model, pts.contiguous(), viewdirs.contiguous(),
            log_sampling_xyz=log_sampling_xyz, log_sampling_dir=log_sampling_dir,
            compute_dtype=compute_dtype,
        )

    field.compute_dtype = compute_dtype
    return field
