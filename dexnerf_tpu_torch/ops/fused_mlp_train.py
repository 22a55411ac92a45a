"""Fused field with a hand-written backward: the training field of the
``nerf.pallas_fused_loss: false`` path.

Counterpart of ``dexnerf_tpu/ops/fused_mlp_train.py``
(``make_fused_flexible_field_train``), whose backward Pallas kernel
(``_make_bwd_kernel``) this module's CUDA kernels replace, with its
``compute_dtype`` / ``dw_dtype`` (float32 by default, as in JAX; training
resolves both from ``nerf.pallas_compute_dtype``, bf16 by default). The
field is a ``torch.autograd.Function``: its forward is the field kernel of
``ops/fused_mlp.py`` (kernel 2) at ``compute_dtype``; its backward takes
the cotangent ``g`` of raw [N, S, 4], recomputes the forward, runs the
cotangent chain and sums the weight gradients over every sample (kernel
3): kernel 4's prep, forward and chain kernels of the dtype with the
launcher tag 3, on the caller's ``g`` (no compositing), chunk by chunk of
the scratch, then kernel 4's weight gradients and fixed-order reduction,
so two runs are bitwise equal. At float32/float32 those of
``ops/csrc/fused_train_loss.cu`` (split TF32 on ``wgmma``, layer1 a
sequential f32 FMA chain: ``fused_train_loss.Tf32Pass``) with the f32
scratch and the split-TF32 dW of ``ops/_weight_grads.py``; at
bfloat16/bfloat16 those of ``ops/csrc/fused_train_loss_bf16.cu`` with its
bf16 scratch, dW and reduction (``fused_train_loss.Bf16Gradients``): bf16
operands, activations and dW operands, f32 heads, bias sums and chain. A
mixed pair raises on the card. On CPU
tensors both halves are the plain version at any pair: the forward is
``fused_field_reference`` and the backward autograd through the model, or
through ``flex_forward_train`` (the contract's three roundings) when a
dtype is bfloat16.

CONTRACT (the JAX module's): the backward returns gradients for the model's
parameters only and **no cotangent for the sample points or the view
directions**. In the NeRF training graph that is exact: the coarse depths
come from the parameter-free stratified sampler and the fine depths are
detached, so no gradient flows into the field's inputs. Do not use this
field where ``pts`` depends on trained values (pose refinement).

``launches`` counts kernel-3 backwards of either dtype, ``launches_bf16``
those of the bf16 route, ``launches_wide`` those of its wide route and
``launches_wide_f32`` those of the f32 route's (a model wider than 128:
kernel 4's wide forward and chain of the dtype) (+1 per backward,
where it launches its group of ``__global__`` kernels; nowhere else); the
forward's are ``ops.fused_mlp``'s.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.ops._weight_grads import WeightGradients
from dexnerf_tpu_torch.ops.fused_mlp import check_field_inputs, check_fusable, fused_field_reference
from dexnerf_tpu_torch.ops.fused_train_loss import (
    Bf16Gradients,
    _check_dtypes,
    bf16_args,
    check_kernel_pair,
    flex_forward_train,
)

launches = 0  # kernel-3 backwards of either dtype
launches_bf16 = 0  # of which the bf16 route's (narrow or wide)
launches_wide = 0  # of which the wide bf16 kernels'
launches_wide_f32 = 0  # of which the wide f32 kernels'

# samples of activation/cotangent scratch per chunk of rays
SCRATCH_SAMPLES = 1 << 18


def _launch_backward(model, pts, viewdirs, g, *, log_sampling_xyz, log_sampling_dir,
                     compute_dtype=torch.float32, dw_dtype=None) -> tuple:
    """The gradient of ``sum(g * raw)`` with respect to every parameter of
    ``model``, in ``model.parameters()`` order, by kernel 3 at
    ``compute_dtype`` / ``dw_dtype`` (None: float32): float32/float32 or
    bfloat16/bfloat16."""
    global launches, launches_bf16, launches_wide, launches_wide_f32
    from dexnerf_tpu_torch.ops._build import check, load_library

    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    check_kernel_pair(compute_dtype, dw_dtype)
    N, S = pts.shape[:2]
    dev = pts.device
    check_field_inputs(model, [("pts", pts, (N, S, 3)), ("viewdirs", viewdirs, (N, 3)),
                               ("g", g, (N, S, 4))], compute_dtype)
    lib = load_library()
    if compute_dtype == torch.bfloat16:
        chunk = max(1, min(N, SCRATCH_SAMPLES // S))
        args, keep = bf16_args(lib, model, chunk, S, log_sampling_xyz=log_sampling_xyz,
                               log_sampling_dir=log_sampling_dir)
        wg = Bf16Gradients(lib, model, N, S, chunk, args)
        args.pts, args.viewdirs = pts.data_ptr(), viewdirs.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in range(wg.n_chunks):
            ray0, n_rows, tiles = wg.chunk_args(args, c)
            args.graw = g.data_ptr() + 16 * ray0 * S  # the chunk's [rows][4] cotangents
            check(lib, lib.dexnerf_field_bf16_pass(ctypes.addressof(args),
                                                   ctypes.addressof(wg.chain_maps), n_rows,
                                                   tiles, 1, stream),
                  "fused field bf16 backward launch")
            wg.dw(c, tiles, stream)
        grads = wg.reduce(stream)
        launches += 1
        launches_bf16 += 1
        launches_wide += int(fused_mlp.is_wide(model))
        return grads
    wg, ps = tf32_backward_pass(lib, model, pts, viewdirs, g, log_sampling_xyz=log_sampling_xyz,
                                log_sampling_dir=log_sampling_dir)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(wg.n_chunks):
        wg.chunk(c, ps.run(c, stream), stream)
    grads = wg.reduce(stream)
    launches += 1
    launches_wide_f32 += int(fused_mlp.is_wide(model))
    return grads


def tf32_backward_pass(lib, model, pts, viewdirs, g, *, log_sampling_xyz, log_sampling_dir):
    """Kernel 3's f32 route over ``pts`` [N, S, 3]: the scratch
    (:class:`WeightGradients`) of chunks of ``SCRATCH_SAMPLES`` padded
    samples and the :class:`~dexnerf_tpu_torch.ops.fused_train_loss.Tf32Pass`
    that fills it chunk by chunk from the cotangent ``g`` [N, S, 4]."""
    N, S = pts.shape[:2]
    s_pad = ftl.s_pad_of(S)
    chunk = max(1, min(N, SCRATCH_SAMPLES // s_pad))
    wg = WeightGradients(lib, model, N, chunk, s_pad, pts.device)
    ps = ftl.Tf32Pass(lib, model, dict(pts=pts, viewdirs=viewdirs, graw=g), N, S, s_pad, chunk,
                      wg, owner=ftl.FIELD_BWD, log_sampling_xyz=log_sampling_xyz,
                      log_sampling_dir=log_sampling_dir)
    return wg, ps


def cotangent_columns(g: torch.Tensor, ray0: int, n_rays: int, s_pad: int) -> torch.Tensor:
    """The raw cotangents that kernel 3's f32 chain takes for the chunk of
    rays [ray0, ray0 + n_rays) of ``g`` [N, S, 4], as it writes them to the
    scratch's rgb and sigma cotangent rows: [n_rays s_pad, 4], column r
    s_pad + s holding g[ray0 + r, s] for s < S and 0 on the padding
    columns."""
    out = g.new_zeros((n_rays, s_pad, 4))
    out[:, :g.shape[1]] = g[ray0:ray0 + n_rays]
    return out.reshape(-1, 4)


def field_grads_reference(model, pts, viewdirs, g, *, log_sampling_xyz=True,
                          log_sampling_dir=True, compute_dtype=torch.float32,
                          dw_dtype=None) -> tuple:
    """Plain version of the backward at any pair of dtypes (``dw_dtype``
    None: float32): the gradient of ``sum(g * raw)`` with respect to every
    parameter, by autograd through ``fused_field_reference`` at
    float32/float32, else through ``flex_forward_train`` on the
    encodings."""
    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    params = list(model.parameters())
    with torch.enable_grad():
        if compute_dtype == dw_dtype == torch.float32:
            raw = fused_field_reference(model, pts, viewdirs, log_sampling_xyz=log_sampling_xyz,
                                        log_sampling_dir=log_sampling_dir)
        else:
            xyz = positional_encoding(pts, model.num_encoding_fn_xyz, model.include_input_xyz,
                                      log_sampling_xyz)
            view = positional_encoding(viewdirs, model.num_encoding_fn_dir,
                                       model.include_input_dir, log_sampling_dir)
            raw = flex_forward_train(model, xyz, view, compute_dtype, dw_dtype)
        return torch.autograd.grad(raw, params, g)


class _FieldTrain(torch.autograd.Function):
    """raw of ``fwd(pts, viewdirs)``, differentiable with respect to the
    model parameters only; the backward gets their gradients from
    ``bwd(pts, viewdirs, g)`` and gives ``pts``/``viewdirs`` none."""

    @staticmethod
    def forward(ctx, fwd, bwd, n_params, *args):
        pts, viewdirs = args[n_params:]
        ctx.bwd = bwd
        ctx.save_for_backward(pts, viewdirs)
        return fwd(pts, viewdirs)

    @staticmethod
    def backward(ctx, g):
        pts, viewdirs = ctx.saved_tensors
        grads = ctx.bwd(pts, viewdirs, g.contiguous())
        return (None, None, None, *grads, None, None)


def fused_field_train(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    dw_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """raw [N, S, 4] of ``model`` at ``pts`` [N, S, 3] along ``viewdirs``
    [N, 3] at ``compute_dtype``, differentiable with respect to the model's
    parameters with the gradients of the ``compute_dtype`` / ``dw_dtype``
    contract (None: float32; the inputs are detached: see the module's
    contract). CUDA tensors launch kernel 2 forward and kernel 3 backward
    of the dtypes (float32/float32 or bfloat16/bfloat16; a mixed pair
    raises); CPU tensors run the plain versions at any pair."""
    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    kw = dict(log_sampling_xyz=log_sampling_xyz, log_sampling_dir=log_sampling_dir)
    fkw = dict(kw, compute_dtype=compute_dtype)
    bkw = dict(fkw, dw_dtype=dw_dtype)
    if pts.device.type == "cuda":
        check_kernel_pair(compute_dtype, dw_dtype)

        def fwd(p, v):
            return fused_mlp._launch(model, p, v, **fkw)

        def bwd(p, v, g):
            return _launch_backward(model, p, v, g, **bkw)
    elif pts.device.type == "cpu":
        def fwd(p, v):
            return fused_field_reference(model, p, v, **fkw)

        def bwd(p, v, g):
            return field_grads_reference(model, p, v, g, **bkw)
    else:
        raise ValueError(f"no fused field for device {pts.device}")
    params = tuple(model.parameters())
    return _FieldTrain.apply(fwd, bwd, len(params), *params, pts.detach().contiguous(),
                             viewdirs.detach().contiguous())


def make_fused_flexible_field_train(
    model: FlexibleNeRFModel, *, log_sampling_xyz: bool = True, log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32, dw_dtype: Optional[torch.dtype] = None,
):
    """``field(pts [N, S, 3], viewdirs [N, 3]) -> raw [N, S, 4]`` through
    :func:`fused_field_train` on ``model`` at ``compute_dtype`` /
    ``dw_dtype`` (the counterpart of ``make_fused_flexible_field_train``,
    whose defaults, f32, these are too; ``dw_dtype`` None is float32)."""
    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    check_fusable(model, "the field kernels")

    def field(pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        return fused_field_train(model, pts, viewdirs, log_sampling_xyz=log_sampling_xyz,
                                 log_sampling_dir=log_sampling_dir,
                                 compute_dtype=compute_dtype, dw_dtype=dw_dtype)

    field.compute_dtype, field.dw_dtype = compute_dtype, dw_dtype
    return field
