"""Fused field with a hand-written backward: the training field of the
``nerf.pallas_fused_loss: false`` path.

Counterpart of ``dexnerf_tpu/ops/fused_mlp_train.py``
(``make_fused_flexible_field_train``), whose backward Pallas kernel
(``_make_bwd_kernel``) this module's CUDA kernel
(``ops/csrc/fused_mlp_train.cu``) replaces. The field is a
``torch.autograd.Function``: its forward is the field kernel of
``ops/fused_mlp.py`` (kernel 2); its backward takes the cotangent ``g`` of
raw [N, S, 4], recomputes the forward, runs the cotangent chain and sums
the weight gradients over every sample (kernel 3, with the scratch and the
weight-gradient launches of ``ops/_weight_grads.py``, shared with the fused
train loss). On CPU tensors both halves are the plain version: the forward
is ``fused_field_reference`` and the backward autograd through it.

CONTRACT (the JAX module's): the backward returns gradients for the model's
parameters only and **no cotangent for the sample points or the view
directions**. In the NeRF training graph that is exact: the coarse depths
come from the parameter-free stratified sampler and the fine depths are
detached, so no gradient flows into the field's inputs. Do not use this
field where ``pts`` depends on trained values (pose refinement).

``launches`` counts launches of the backward kernel (+1 per backward, where
it launches its group of ``__global__`` kernels; nowhere else); the
forward's are ``ops.fused_mlp.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp
from dexnerf_tpu_torch.ops._weight_grads import (
    WeightGradients,
    check_gemm_args_size,
    pack_backward_weights,
)
from dexnerf_tpu_torch.ops.fused_mlp import check_field_inputs, field_args, fused_field_reference

launches = 0

# samples of activation/cotangent scratch per chunk of rays
SCRATCH_SAMPLES = 1 << 18


def _launch_backward(model, pts, viewdirs, g, *, log_sampling_xyz, log_sampling_dir) -> tuple:
    """The gradient of ``sum(g * raw)`` with respect to every parameter of
    ``model``, in ``model.parameters()`` order."""
    global launches
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, S = pts.shape[:2]
    dev = pts.device
    check_field_inputs(model, [("pts", pts, (N, S, 3)), ("viewdirs", viewdirs, (N, 3)),
                               ("g", g, (N, S, 4))])
    lib = load_library()
    check_gemm_args_size(lib)
    s_pad = -(-S // fused_mlp.SLOTS) * fused_mlp.SLOTS
    chunk = max(1, min(N, SCRATCH_SAMPLES // s_pad))
    n_chunks = -(-N // chunk)
    wg = WeightGradients(lib, model, N, chunk, s_pad, dev)
    args, wf = field_args(lib, model, pts, viewdirs, log_sampling_xyz=log_sampling_xyz,
                          log_sampling_dir=log_sampling_dir)
    wb, b_off = pack_backward_weights(model, dev)
    args.g, args.wb = g.data_ptr(), wb.data_ptr()
    args.act, args.dlt = wg.act.data_ptr(), wg.dlt.data_ptr()
    args.dir_enc, args.dy_sum = wg.dir_enc.data_ptr(), wg.dy_sum.data_ptr()
    args.s_pad = s_pad
    args.wb_off[:len(b_off)] = b_off
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(n_chunks):
        ray0 = c * chunk
        rays = min(chunk, N - ray0)
        args.ray0, args.n_rays, args.k = ray0, rays, rays * s_pad
        check(lib, lib.dexnerf_field_backward(ctypes.addressof(args), stream),
              "fused field backward launch")
        wg.chunk(c, rays, stream)
    grads = wg.reduce(stream)
    launches += 1
    return grads


def field_grads_reference(model, pts, viewdirs, g, **kw) -> tuple:
    """Plain version of the backward: autograd through
    ``fused_field_reference``, the gradient of ``sum(g * raw)`` with
    respect to every parameter."""
    with torch.enable_grad():
        raw = fused_field_reference(model, pts, viewdirs, **kw)
        return torch.autograd.grad(raw, list(model.parameters()), g)


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
) -> torch.Tensor:
    """raw [N, S, 4] of ``model`` at ``pts`` [N, S, 3] along ``viewdirs``
    [N, 3], differentiable with respect to the model's parameters (the
    inputs are detached: see the module's contract). CUDA tensors launch
    kernel 2 forward and kernel 3 backward; CPU tensors run the plain
    versions."""
    kw = dict(log_sampling_xyz=log_sampling_xyz, log_sampling_dir=log_sampling_dir)
    if pts.device.type == "cuda":
        def fwd(p, v):
            return fused_mlp._launch(model, p, v, **kw)

        def bwd(p, v, g):
            return _launch_backward(model, p, v, g, **kw)
    elif pts.device.type == "cpu":
        def fwd(p, v):
            return fused_field_reference(model, p, v, **kw)

        def bwd(p, v, g):
            return field_grads_reference(model, p, v, g, **kw)
    else:
        raise ValueError(f"no fused field for device {pts.device}")
    params = tuple(model.parameters())
    return _FieldTrain.apply(fwd, bwd, len(params), *params, pts.detach().contiguous(),
                             viewdirs.detach().contiguous())


def make_fused_flexible_field_train(
    model: FlexibleNeRFModel, *, log_sampling_xyz: bool = True, log_sampling_dir: bool = True
):
    """``field(pts [N, S, 3], viewdirs [N, 3]) -> raw [N, S, 4]`` through
    :func:`fused_field_train` on ``model`` (the counterpart of
    ``make_fused_flexible_field_train``; the f32 form of its contract)."""

    def field(pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        return fused_field_train(model, pts, viewdirs, log_sampling_xyz=log_sampling_xyz,
                                 log_sampling_dir=log_sampling_dir)

    return field
