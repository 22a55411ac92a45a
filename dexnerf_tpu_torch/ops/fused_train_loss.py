"""Fused training loss of one render pass: PE -> MLP -> σ-noise ->
compositing -> squared error, with the gradient of the loss sum with
respect to every model parameter.

Counterpart of ``dexnerf_tpu/ops/fused_train_loss.py``, whose Pallas
kernel (``_make_loss_kernel``, ``dexnerf_tpu/ops/fused_train_loss.py:99``)
this module's CUDA kernels (built by ``ops/_build.py``) replace, with its
``compute_dtype`` / ``dw_dtype`` (float32 by default, as in JAX; training
resolves both from ``nerf.pallas_compute_dtype``, bf16 by default). On a
CUDA tensor :func:`fused_pass_loss` launches the kernel of the dtypes:
``ops/csrc/fused_train_loss.cu`` at float32, ``fused_train_loss_bf16.cu``
at bfloat16 (a mixed pair raises). On a CPU tensor it runs
:func:`fused_pass_loss_reference`, the plain PyTorch version of the same
contract at any pair (pts, PE, the model forward, or at bf16
:func:`flex_forward_train`, noise, ``composite``, loss sum, then
``torch.autograd.grad``). There is no fallback between them: a CUDA call
that cannot launch raises.

The f32 route: f32 FMA work, ~0.9 MFLOP per sample of the 8x128 model
(forward, cotangent chain and weight gradients), 1.42 TFLOP per train step
at batch 8192 with 64 + 128 samples per ray, 21.2 ms at the 67 TFLOP/s f32
peak of an H100 SXM (700 W). A fine ray's activations (~650 KB) do not fit
in a CTA's 227 KB of shared memory, so the kernel saves every layer's
activations and cotangents to a device scratch (~10 KB per sample, written
and read back once: ~31 GB of traffic a step, written with streaming
stores so that it does not evict the weights from L2), capped by running
the batch in chunks of ``SCRATCH_SAMPLES`` samples (~2.6 GB for 8x128,
whatever the batch). The weight gradients, products over every sample of
the batch, are summed by CTAs that each own a 128 x 128 tile and a
K-range, into separate slots, and the slots are reduced in a fixed order:
no atomics, bitwise-repeatable runs. The scratch and those launches are
``ops/_weight_grads.py``'s, shared with the field backward (kernel 3).

The bf16 route: the same 1.42 TFLOP on the bf16 tensor cores (1.435 ms at
the 989 TFLOP/s dense bf16 peak), so its scratch traffic bounds it first:
activations and cotangents saved in bf16, sample-major, ~5 KB per sample
(~1.3 GB a chunk for 8x128), written once and read back by the chain's
ReLU masks and the weight gradients (~20 GB a step, ~6 ms at 3.35 TB/s).
Its design, per chunk: a per-ray prep (viewdir encoding and bias), the
forward of each 128-sample tile on ``mma.sync`` (kernel 1's bf16 tile:
weights streamed as [N, 32] K-chunks through a 4-stage ``cp.async`` ring,
f32 heads from the accumulators), f32 compositing and its backward one
warp per ray, the cotangent chain on ``mma.sync`` against
:func:`pack_backward_weights_bf16` with the bias sums and the viewdir
rows' dW accumulated per CTA in a fixed order, and the weight gradients as
64 x 64 ``mma.sync`` tiles per K-range slot; one fixed-order reduction:
bitwise-repeatable runs. Widths that are not a multiple of 32 run
zero-padded to one. The same kernels, with :func:`bf16_args` and
:class:`Bf16Gradients`, are the bf16 routes of the field kernels (kernel 2
forward, kernel 3 backward: ``ops/fused_mlp.py``, ``ops/fused_mlp_train.py``).
Measured times: ``PERF.md``.

``launches`` counts kernel-4 passes of either route and ``launches_bf16``
those of the bf16 route (+1 per pass, where the pass launches its group of
``__global__`` kernels; nowhere else), so a run can show which kernel its
path went through.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, linspace
from dexnerf_tpu_torch.core.volrend import composite, ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops._weight_grads import (
    MAX_ITEMS,
    WeightGradients,
    _param_offsets,
    check_gemm_args_size,
    pack_backward_weights,
)
from dexnerf_tpu_torch.ops.fused_render import (
    BF16_KCHUNK,
    _cached_bf16_weights,
    _k_chunks,
    _round_up,
    bf16_hidden,
    gather_params,
    gather_plan,
    pack_flex_weights,
)
from dexnerf_tpu_torch.ops.resample import make_fused_resample
from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderDraws,
    RenderSettings,
    jittered_z_vals,
)

launches = 0  # kernel-4 passes of either route
launches_bf16 = 0  # of which the bf16 route's

# samples of activation/cotangent scratch per chunk of rays
SCRATCH_SAMPLES = 1 << 18
# limits of ops/csrc/fused_train_loss.cu
SLOTS = 64
MAX_LAYERS = 40
MAX_FREQ = 16
MAX_SAMPLES = 256
MAX_HIDDEN = 128
# of ops/csrc/fused_train_loss_bf16.cu (kMaxBlocks, kGT)
MAX_BLOCKS = MAX_LAYERS + 8
BF16_DW_TILE = 64
SUPERVISION = ("rgb", "luminance")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class _TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in ops/csrc/fused_train_loss.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "origins", "dirs", "viewdirs", "z", "dists", "noise", "target",
            "depth_gt", "depth_coef", "wf", "wb", "weights_out", "rgb_out",
            "loss_ray", "act", "dlt", "dir_enc", "dy_sum",
        )
    ] + [("k", ctypes.c_int64)] + [
        (name, ctypes.c_int32)
        for name in (
            "ray0", "n_rays", "n_samples", "s_pad", "hidden", "num_trunk",
            "skip_mask", "fx", "fd", "inc_x", "inc_d", "white_bg", "luma",
            "has_noise", "has_depth",
        )
    ] + [
        ("w_off", ctypes.c_int32 * MAX_LAYERS),
        ("b_off", ctypes.c_int32 * MAX_LAYERS),
        ("wb_off", ctypes.c_int32 * MAX_LAYERS),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


def pass_loss_sum(rgb: torch.Tensor, target: torch.Tensor, supervision: str) -> torch.Tensor:
    """Unnormalized squared error over the batch: per channel (``rgb``) or
    of the Rec.601 luminance (``luminance``)."""
    if supervision == "rgb":
        return torch.sum((rgb - target) ** 2)
    if supervision == "luminance":
        return torch.sum((luminance(rgb) - luminance(target)) ** 2)
    raise ValueError(f"unknown supervision mode: {supervision}")


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32 (a no-op at float32)."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


class _RoundedLinear(torch.autograd.Function):
    """``x W^T`` under the JAX package's rounding contract
    (``_forward_block_parts`` / ``_backward_chain_parts``): the forward
    multiplies ``x`` rounded to ``x_dtype`` by ``W`` rounded to
    ``w_dtype`` in f32; the input cotangent is the output cotangent rounded
    to the weight's dtype times the rounded weight (``matWT``); the weight
    gradient multiplies the output cotangent and the saved input (``x``
    rounded to ``save_dtype``), both rounded to ``dw_dtype`` (``matT``).
    Autograd through ``.to(bf16)`` would round the products and the
    weight gradient instead."""

    @staticmethod
    def forward(ctx, x, w, x_dtype, w_dtype, save_dtype, dw_dtype):
        wr = _round(w, w_dtype)
        ctx.save_for_backward(_round(x, save_dtype), wr)
        ctx.dtypes = (w_dtype, dw_dtype)
        return F.linear(_round(x, x_dtype), wr)

    @staticmethod
    def backward(ctx, g):
        saved, wr = ctx.saved_tensors
        w_dtype, dw_dtype = ctx.dtypes
        gx = _round(g, w_dtype) @ wr if ctx.needs_input_grad[0] else None
        g2 = _round(g, dw_dtype).reshape(-1, g.shape[-1])
        gw = g2.t() @ _round(saved, dw_dtype).reshape(-1, saved.shape[-1])
        return gx, gw, None, None, None, None


def flex_forward_train(
    model: FlexibleNeRFModel,
    xyz: torch.Tensor,
    view: torch.Tensor,
    compute_dtype: torch.dtype,
    dw_dtype: torch.dtype,
) -> torch.Tensor:
    """The model's forward [..., S, 4] for training under the JAX
    package's ``compute_dtype`` / ``dw_dtype`` contract, differentiable by
    autograd with that contract's gradients. Matmul operands of layer1,
    the trunk (h, and the xyz encoding on a skip layer), fc_feat and
    layers_dir.0 are rounded to ``compute_dtype``; bias, ReLU and the chain
    stay f32; the σ head reads the unrounded trunk output and the rgb head
    the unrounded viewdir-layer output, with f32 weights. Activations are
    saved in ``compute_dtype`` (the encodings in f32), and every weight
    gradient multiplies operands rounded to ``dw_dtype``; bias gradients
    sum the f32 cotangents. ``view`` is the per-ray [..., dim_dir]
    encoding; it is expanded to the samples, as JAX contracts it per
    sample."""
    cd, dw, f32 = compute_dtype, dw_dtype, torch.float32
    H = model.hidden_size
    lin = _RoundedLinear.apply
    h = lin(xyz, model.layer1.weight, cd, cd, f32, dw) + model.layer1.bias
    for i, layer in enumerate(model.layers_xyz):
        y = lin(h, layer.weight[:, :H], cd, cd, cd, dw)
        if i in model.skips:
            y = y + lin(xyz, layer.weight[:, H:], cd, cd, f32, dw)
        h = torch.relu(y + layer.bias)
    feat = torch.relu(lin(h, model.fc_feat.weight, cd, cd, cd, dw) + model.fc_feat.bias)
    alpha = lin(h, model.fc_alpha.weight, f32, f32, cd, dw) + model.fc_alpha.bias
    ld = model.layers_dir[0]
    view_s = view[..., None, :].expand(*feat.shape[:-1], view.shape[-1])
    y = torch.relu(
        lin(feat, ld.weight[:, :H], cd, cd, cd, dw)
        + lin(view_s, ld.weight[:, H:], cd, cd, f32, dw) + ld.bias
    )
    rgb = lin(y, model.fc_rgb.weight, f32, f32, cd, dw) + model.fc_rgb.bias
    return torch.cat([rgb, alpha], dim=-1)


def _check_dtypes(compute_dtype, dw_dtype) -> torch.dtype:
    """``dw_dtype`` resolved (None means float32, as in JAX)."""
    dw_dtype = torch.float32 if dw_dtype is None else dw_dtype
    for name, dt in (("compute_dtype", compute_dtype), ("dw_dtype", dw_dtype)):
        if dt not in COMPUTE_DTYPES:
            raise ValueError(f"{name} {dt}: the fused kernels take torch.float32 or "
                             "torch.bfloat16")
    return dw_dtype


def check_kernel_pair(compute_dtype, dw_dtype) -> None:
    """The pairs the training kernels (kernels 3 and 4) take on the card."""
    if compute_dtype != dw_dtype:
        raise ValueError(
            f"compute_dtype {compute_dtype} with dw_dtype {dw_dtype}: the kernels take "
            "float32/float32 and bfloat16/bfloat16 (the plain version takes every pair)"
        )


def fused_pass_loss_reference(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    z_vals: torch.Tensor,
    viewdirs: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    depth_gt: Optional[torch.Tensor] = None,
    depth_coef: Optional[torch.Tensor] = None,
    *,
    white_background: bool = False,
    supervision: str = "rgb",
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    dw_dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of the kernels' contract. Returns ``(loss_sum,
    weights [N, S], rgb [N, 3], grads)``, ``grads`` in
    ``model.parameters()`` order; ``loss_sum`` adds ``sum(depth_coef *
    (sum_s w z - depth_gt)^2)`` when ``depth_gt`` is given. At
    ``compute_dtype`` / ``dw_dtype`` (None: float32) other than float32 the
    model runs :func:`flex_forward_train`; every pair of the two dtypes is
    taken."""
    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    if compute_dtype == dw_dtype == torch.float32:
        forward = model
    else:
        def forward(xyz, view):
            return flex_forward_train(model, xyz, view, compute_dtype, dw_dtype)
    params = list(model.parameters())
    with torch.enable_grad():
        pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
        xyz = positional_encoding(
            pts, model.num_encoding_fn_xyz, model.include_input_xyz, log_sampling_xyz
        )
        view = positional_encoding(
            viewdirs, model.num_encoding_fn_dir, model.include_input_dir, log_sampling_dir
        )
        out = composite(
            forward(xyz, view), z_vals, dists,
            white_background=white_background, sigma_noise=noise,
        )
        loss = pass_loss_sum(out.rgb, target, supervision)
        if depth_gt is not None:
            loss = loss + torch.sum(depth_coef * (out.depth - depth_gt) ** 2)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), out.weights.detach(), out.rgb.detach(), grads


def _check_inputs(model, dev, tensors, S: int) -> None:
    if not isinstance(model, FlexibleNeRFModel):
        raise TypeError(f"the fused loss kernel takes FlexibleNeRFModel, not {type(model)}")
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
    H = model.hidden_size
    if H > MAX_HIDDEN or H % 8 or H < 8:
        raise ValueError(f"hidden_size {H}: the kernel takes multiples of 8 up to {MAX_HIDDEN}")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray: the kernel takes 1..{MAX_SAMPLES}")
    nt = model.num_layers - 1
    if nt + 5 > MAX_LAYERS or nt > 31 or nt + len(model.skips) + 6 > MAX_ITEMS:
        raise ValueError(f"{model.num_layers} layers: too deep for the kernel")
    if max(model.num_encoding_fn_xyz, model.num_encoding_fn_dir) > MAX_FREQ:
        raise ValueError(f"the kernel takes at most {MAX_FREQ} PE frequencies")


def _check_struct_sizes(lib) -> None:
    if lib.dexnerf_train_args_size(0) != ctypes.sizeof(_TrainArgs):
        raise RuntimeError(
            f"_TrainArgs is {ctypes.sizeof(_TrainArgs)} bytes here but "
            f"{lib.dexnerf_train_args_size(0)} in the kernel library"
        )
    check_gemm_args_size(lib)


def _launch(
    model, origins, directions, z_vals, viewdirs, dists, noise, target,
    depth_gt, depth_coef, *, white_background, supervision, log_sampling_xyz,
    log_sampling_dir,
):
    global launches
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, S = z_vals.shape
    dev = z_vals.device
    tensors = [
        ("origins", origins, (N, 3)),
        ("directions", directions, (N, 3)),
        ("z_vals", z_vals, (N, S)),
        ("viewdirs", viewdirs, (N, 3)),
        ("dists", dists, (N, S)),
        ("target", target, (N, 3)),
    ]
    if noise is not None:
        tensors.append(("noise", noise, (N, S)))
    if depth_gt is not None:
        tensors += [("depth_gt", depth_gt, (N,)), ("depth_coef", depth_coef, (N,))]
    _check_inputs(model, dev, tensors, S)
    lib = load_library()
    _check_struct_sizes(lib)

    s_pad = -(-S // SLOTS) * SLOTS
    chunk = max(1, min(N, SCRATCH_SAMPLES // s_pad))
    n_chunks = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    wg = WeightGradients(lib, model, N, chunk, s_pad, dev)
    weights = torch.empty((N, S), **f32)
    rgb = torch.empty((N, 3), **f32)
    loss_ray = torch.empty((N,), **f32)
    loss = torch.empty((), **f32)
    wf, f_off = pack_flex_weights(model, dev)
    wb, b_off = pack_backward_weights(model, dev)

    args = _TrainArgs()
    for name, t in (
        ("origins", origins), ("dirs", directions), ("viewdirs", viewdirs),
        ("z", z_vals), ("dists", dists), ("noise", noise), ("target", target),
        ("depth_gt", depth_gt), ("depth_coef", depth_coef), ("wf", wf), ("wb", wb),
        ("weights_out", weights), ("rgb_out", rgb), ("loss_ray", loss_ray),
        ("act", wg.act), ("dlt", wg.dlt), ("dir_enc", wg.dir_enc), ("dy_sum", wg.dy_sum),
    ):
        setattr(args, name, None if t is None else t.data_ptr())
    args.n_samples, args.s_pad = S, s_pad
    args.hidden, args.num_trunk = model.hidden_size, model.num_layers - 1
    args.skip_mask = sum(1 << i for i in model.skips)
    args.fx, args.fd = model.num_encoding_fn_xyz, model.num_encoding_fn_dir
    args.inc_x, args.inc_d = int(model.include_input_xyz), int(model.include_input_dir)
    args.white_bg = int(bool(white_background))
    args.luma = int(supervision == "luminance")
    args.has_noise, args.has_depth = int(noise is not None), int(depth_gt is not None)
    args.w_off[:len(f_off) // 2] = f_off[0::2]
    args.b_off[:len(f_off) // 2] = f_off[1::2]
    args.wb_off[:len(b_off)] = b_off
    bx = frequency_bands(model.num_encoding_fn_xyz, log_sampling_xyz).tolist()
    bd = frequency_bands(model.num_encoding_fn_dir, log_sampling_dir).tolist()
    args.bands_x[:len(bx)] = bx
    args.bands_d[:len(bd)] = bd

    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(n_chunks):
        ray0 = c * chunk
        rays = min(chunk, N - ray0)
        args.ray0, args.n_rays, args.k = ray0, rays, rays * s_pad
        check(lib, lib.dexnerf_train_pass(ctypes.addressof(args), stream),
              "fused_train_loss pass launch")
        wg.chunk(c, rays, stream)
    grads = wg.reduce(stream, loss_ray, loss)
    launches += 1
    return loss, weights, rgb, grads


class _Bf16TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in ops/csrc/fused_train_loss_bf16.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "origins", "dirs", "viewdirs", "pts", "z", "dists", "noise", "target",
            "depth_gt", "depth_coef", "wq", "aux", "wbq", "weights_out", "rgb_out",
            "loss_ray", "scratch", "raw", "graw", "dir_enc", "dirb", "aux_part",
        )
    ] + [
        ("act_off", ctypes.c_int64 * MAX_BLOCKS),
        ("dlt_off", ctypes.c_int64 * MAX_BLOCKS),
    ] + [
        (name, ctypes.c_int32)
        for name in (
            "ray0", "n_rays", "n_samples", "hidden", "num_trunk", "skip_mask",
            "fx", "fd", "inc_x", "inc_d", "dx", "dxp", "dd",
            "white_bg", "luma", "has_noise", "has_depth", "chain_ctas",
        )
    ] + [
        ("aux_off", ctypes.c_int32 * (MAX_LAYERS + 8)),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


class _Bf16GemmItem(ctypes.Structure):
    """Mirror of ``GemmItem`` in ops/csrc/fused_train_loss_bf16.cu: one
    weight-gradient product over sample-major bf16 operands."""

    _fields_ = [("d", ctypes.c_void_p), ("a", ctypes.c_void_p)] + [
        (name, ctypes.c_int32)
        for name in ("ldd", "lda", "n", "m", "m_tiles", "tile0", "w_off", "ldw", "col_off",
                     "pad")
    ]


class _Bf16GemmArgs(ctypes.Structure):
    _fields_ = [
        ("items", _Bf16GemmItem * MAX_ITEMS),
        ("partial", ctypes.c_void_p),
        ("n_params", ctypes.c_int64),
        ("k", ctypes.c_int64),
        ("n_items", ctypes.c_int32),
        ("n_splits", ctypes.c_int32),
        ("part0", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


def _backward_layout(model: FlexibleNeRFModel, w: dict) -> Tuple[torch.Tensor]:
    """:func:`pack_backward_weights_bf16`'s layout of the parameters ``w``
    (name -> tensor), before rounding."""
    H = model.hidden_size
    Hp = bf16_hidden(H)
    kp2 = _round_up(Hp // 2, BF16_KCHUNK)
    nt = model.num_layers - 1
    parts = [_k_chunks(w["layers_dir.0.weight"][:, :H].t(), kp2, Hp),
             _k_chunks(w["fc_feat.weight"].t(), Hp, Hp)]
    parts += [_k_chunks(w[f"layers_xyz.{i}.weight"][:, :H].t(), Hp, Hp)
              for i in reversed(range(nt))]
    return (torch.cat(parts),)


def pack_backward_weights_bf16(model: FlexibleNeRFModel, device=None) -> torch.Tensor:
    """The bf16 chain's weights (``pack_backward_weights`` at bfloat16):
    each product's matrix [in, out] (the transpose of ``nn.Linear.weight``,
    rounded to bf16, zero-padded to Hp = ``bf16_hidden`` rows and to K a
    multiple of 32) as [Hp, 32] K-chunks in the chain's order:
    ``layers_dir.0`` (feat rows), ``fc_feat``, then ``layers_xyz`` from the
    last to the first (h rows). The heads stay f32 (the forward pack's
    aux). One gather of the parameters (``gather_plan``)."""
    (idx,) = gather_plan(_backward_layout, model, next(model.parameters()).device)
    with torch.no_grad():
        return gather_params(model, idx)[0].to(torch.bfloat16).to(device)


def _scratch_layout(model: FlexibleNeRFModel):
    """(Hp, dxp, widths of the activation blocks, of the cotangent blocks)
    of the bf16 scratch: e, a_0..a_nt, feat, y; d_0..d_nt, feat, y, rgb,
    sigma (the last two 8 wide)."""
    Hp = bf16_hidden(model.hidden_size)
    nt = model.num_layers - 1
    dxp = _round_up(model.dim_xyz, BF16_KCHUNK)
    act = [dxp] + [Hp] * (nt + 1) + [Hp, Hp // 2]
    dlt = [Hp] * (nt + 1) + [Hp, Hp // 2, 8, 8]
    return Hp, dxp, act, dlt


# (widths, depth, skips, encodings, device) -> _aux_map's result: built and
# copied to the card once per shape (a copy per pass stalls the host on the
# card's queue)
_aux_maps = {}


def _cached_aux_map(model: FlexibleNeRFModel, device) -> Tuple[torch.Tensor, int]:
    key = (model.hidden_size, model.num_layers, tuple(model.skips), model.dim_xyz,
           model.dim_dir, str(device))
    if key not in _aux_maps:
        _aux_maps[key] = _aux_map(model, device)
    return _aux_maps[key]


def _aux_map(model: FlexibleNeRFModel, device) -> Tuple[torch.Tensor, int]:
    """For each entry of the flat gradient: -1 where the dW slots hold it,
    else its index in a chain CTA's slot (``aux_*`` in
    ops/csrc/fused_train_loss_bf16.cu: the bias sums, then the viewdir rows
    of ``layers_dir.0`` as [dd, Hp/2]). Returns the map and the slot
    length."""
    H, nt, dd = model.hidden_size, model.num_layers - 1, model.dim_dir
    Hp = bf16_hidden(H)
    Hp2, H2 = Hp // 2, H // 2
    offs, n = _param_offsets(model)
    m = torch.full((n,), -1, dtype=torch.int32)

    def put(name, start, count):
        m[offs[name]:offs[name] + count] = torch.arange(start, start + count, dtype=torch.int32)

    put("layer1.bias", 0, H)
    for i in range(nt):
        put(f"layers_xyz.{i}.bias", (i + 1) * Hp, H)
    put("fc_feat.bias", (nt + 1) * Hp, H)
    dir0 = (nt + 2) * Hp
    put("layers_dir.0.bias", dir0, H2)
    put("fc_alpha.bias", dir0 + Hp2, 1)
    put("fc_rgb.bias", dir0 + Hp2 + 1, 3)
    vd = dir0 + Hp2 + 4
    c, k = torch.meshgrid(torch.arange(H2), torch.arange(dd), indexing="ij")
    w0 = offs["layers_dir.0.weight"]
    m[w0 + c * (H + dd) + H + k] = (vd + k * Hp2 + c).to(torch.int32)
    return m.to(device), vd + dd * Hp2


def _dw_items(model, scratch, act_off, dlt_off, offs):
    """The bf16 weight-gradient products over one chunk's scratch, as
    (d, ldd, a, lda, N, M, w_off, ldw, col_off)."""
    H, nt, dx, dd = model.hidden_size, model.num_layers - 1, model.dim_xyz, model.dim_dir
    Hp, dxp, _, _ = _scratch_layout(model)
    H2, Hp2 = H // 2, Hp // 2

    def blk(off):
        return scratch.data_ptr() + 2 * off

    e, feat, y = blk(act_off[0]), blk(act_off[nt + 2]), blk(act_off[nt + 3])
    items = [(blk(dlt_off[0]), Hp, e, dxp, H, dx, offs["layer1.weight"], dx, 0)]
    for i, lin in enumerate(model.layers_xyz):
        w, n_in = offs[f"layers_xyz.{i}.weight"], lin.in_features
        items.append((blk(dlt_off[i + 1]), Hp, blk(act_off[1 + i]), Hp, H, H, w, n_in, 0))
        if i in model.skips:
            items.append((blk(dlt_off[i + 1]), Hp, e, dxp, H, dx, w, n_in, H))
    a_last = blk(act_off[nt + 1])
    items += [
        (blk(dlt_off[nt + 1]), Hp, a_last, Hp, H, H, offs["fc_feat.weight"], H, 0),
        (blk(dlt_off[nt + 4]), 8, a_last, Hp, 1, H, offs["fc_alpha.weight"], H, 0),
        (blk(dlt_off[nt + 2]), Hp2, feat, Hp, H2, H, offs["layers_dir.0.weight"], H + dd, 0),
        (blk(dlt_off[nt + 3]), 8, y, Hp2, 3, H2, offs["fc_rgb.weight"], H2, 0),
    ]
    return items


def _bf16_gemm_args(items, partial, n_params: int, k: int, n_splits: int, part0: int):
    args = _Bf16GemmArgs()
    tile0 = 0
    for slot, (d, ldd, a, lda, n, m, w_off, ldw, col_off) in zip(args.items, items):
        m_tiles, n_tiles = -(-m // BF16_DW_TILE), -(-n // BF16_DW_TILE)
        slot.d, slot.a, slot.ldd, slot.lda = d, a, ldd, lda
        slot.n, slot.m, slot.m_tiles, slot.tile0 = n, m, m_tiles, tile0
        slot.w_off, slot.ldw, slot.col_off = w_off, ldw, col_off
        tile0 += m_tiles * n_tiles
    args.partial = partial.data_ptr()
    args.n_params, args.k = n_params, k
    args.n_items, args.n_splits, args.part0 = len(items), n_splits, part0
    return args, tile0


def bf16_occupancy(model: FlexibleNeRFModel) -> dict:
    """CTAs per SM and shared-memory bytes per CTA of the bf16 forward and
    chain kernels for ``model``, as the CUDA runtime reports them (needs
    the card)."""
    from dexnerf_tpu_torch.ops._build import check, load_library

    lib = load_library()
    v = [ctypes.c_int(0) for _ in range(4)]
    Hp, dxp, _, _ = _scratch_layout(model)
    check(lib, lib.dexnerf_train_bf16_occupancy(Hp, dxp, *(ctypes.byref(x) for x in v)),
          "fused_train_loss bf16 occupancy query")
    return {"forward": (v[0].value, v[2].value), "chain": (v[1].value, v[3].value)}


def bf16_args(lib, model: FlexibleNeRFModel, n_rays: int, n_samples: int, *,
              log_sampling_xyz: bool, log_sampling_dir: bool):
    """A ``_Bf16TrainArgs`` with the model's layout (zero-padded to
    ``bf16_hidden``), its bf16 forward pack and f32 heads, and the per-ray
    prep buffers of ``n_rays`` rays (``dir_enc``, ``dirb``) filled in, for
    the bf16 kernels of the fused train loss (kernel 4) and of the fields
    (kernels 2 and 3); and the tensors it points to (keep them until the
    launches are done)."""
    for which, struct in ((0, _Bf16TrainArgs), (1, _Bf16GemmArgs)):
        if lib.dexnerf_train_bf16_size(which, 0, 0, 0) != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)} bytes here but "
                               f"{lib.dexnerf_train_bf16_size(which, 0, 0, 0)} in the library")
    dev = next(model.parameters()).device
    nt, dd = model.num_layers - 1, model.dim_dir
    Hp, dxp, _, _ = _scratch_layout(model)
    wq, aux, aux_off = _cached_bf16_weights(model, dev)
    dir_enc = torch.empty(n_rays * dd, dtype=torch.float32, device=dev)
    dirb = torch.empty(n_rays * Hp // 2, dtype=torch.float32, device=dev)
    args = _Bf16TrainArgs()
    args.wq, args.aux = wq.data_ptr(), aux.data_ptr()
    args.dir_enc, args.dirb = dir_enc.data_ptr(), dirb.data_ptr()
    args.n_samples, args.hidden, args.num_trunk = n_samples, Hp, nt
    args.skip_mask = sum(1 << i for i in model.skips)
    args.fx, args.fd = model.num_encoding_fn_xyz, model.num_encoding_fn_dir
    args.inc_x, args.inc_d = int(model.include_input_xyz), int(model.include_input_dir)
    args.dx, args.dxp, args.dd = model.dim_xyz, dxp, dd
    args.aux_off[:len(aux_off)] = aux_off
    bx = frequency_bands(model.num_encoding_fn_xyz, log_sampling_xyz).tolist()
    bd = frequency_bands(model.num_encoding_fn_dir, log_sampling_dir).tolist()
    args.bands_x[:len(bx)] = bx
    args.bands_d[:len(bd)] = bd
    return args, (wq, aux, dir_enc, dirb)


class Bf16Gradients:
    """The weight-gradient half of the bf16 training kernels, shared by the
    fused train loss (kernel 4) and the field backward (kernel 3): the bf16
    scratch of one pass over ``n_rays`` rays of ``n_samples`` samples, run
    in chunks of ``chunk`` rays (rows ray-major, padded to whole 128-sample
    tiles), the chain CTAs' slots, the dW slots and the launches that sum
    them. The constructor points ``args`` (from :func:`bf16_args`) at the
    scratch and the backward pack; per chunk ``c``, :meth:`chunk_args`
    points it at the chunk, the caller launches its pass kernels, then
    :meth:`dw` the chunk's weight-gradient products; :meth:`reduce` sums
    every slot in a fixed order."""

    def __init__(self, lib, model: FlexibleNeRFModel, n_rays: int, n_samples: int, chunk: int,
                 args):
        dev = next(model.parameters()).device
        nt, dd = model.num_layers - 1, model.dim_dir
        Hp, _, act_w, dlt_w = _scratch_layout(model)
        self.lib, self.model, self.n_rays, self.S, self.chunk = lib, model, n_rays, n_samples, chunk
        self.n_aux = lib.dexnerf_train_bf16_size(2, Hp, nt, dd)
        self.bmap, n_aux_py = _cached_aux_map(model, dev)
        if self.n_aux != n_aux_py:
            raise RuntimeError(f"chain slot of {n_aux_py} floats here but {self.n_aux} in the "
                               "library")
        self.n_chunks = -(-n_rays // chunk)
        self.rows = rows = -(-chunk * n_samples // 128) * 128
        f32 = dict(dtype=torch.float32, device=dev)
        act_off = [rows * w for w in itertools.accumulate([0] + act_w[:-1])]
        dlt0 = rows * sum(act_w)
        dlt_off = [dlt0 + rows * w for w in itertools.accumulate([0] + dlt_w[:-1])]
        self.scratch = torch.empty(rows * (sum(act_w) + sum(dlt_w)), dtype=torch.bfloat16,
                                   device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.chain_ctas = max(1, min(rows // 128, 2 * sms))
        self.aux_part = torch.empty(self.n_chunks * self.chain_ctas * self.n_aux, **f32)
        self.offs, self.n_params = _param_offsets(model)
        self.items = _dw_items(model, self.scratch, act_off, dlt_off, self.offs)
        self.n_tiles = _bf16_gemm_args(self.items, self.aux_part, self.n_params, 0, 1, 0)[1]
        self.n_splits = max(1, min(256, 8 * sms // self.n_tiles))
        self.partial = torch.empty(self.n_chunks * self.n_splits * self.n_params, **f32)
        self.grad = torch.empty(self.n_params, **f32)
        self.wbq = pack_backward_weights_bf16(model, dev)
        args.scratch, args.wbq = self.scratch.data_ptr(), self.wbq.data_ptr()
        args.act_off[:len(act_off)] = act_off
        args.dlt_off[:len(dlt_off)] = dlt_off
        args.chain_ctas = self.chain_ctas

    def chunk_args(self, args, c: int) -> Tuple[int, int, int]:
        """Point ``args`` at chunk ``c``; its (first ray, scratch rows,
        tiles)."""
        ray0 = c * self.chunk
        n = min(self.chunk, self.n_rays - ray0)
        args.ray0, args.n_rays = ray0, n
        args.aux_part = self.aux_part.data_ptr() + 4 * c * self.chain_ctas * self.n_aux
        return ray0, n * self.S, -(-n * self.S // 128)

    def dw(self, c: int, tiles: int, stream: int) -> None:
        """Launch the weight-gradient products of chunk ``c`` (``tiles``
        tiles of scratch rows)."""
        from dexnerf_tpu_torch.ops._build import check

        gargs = _bf16_gemm_args(self.items, self.partial, self.n_params, tiles * 128,
                                self.n_splits, c * self.n_splits)[0]
        check(self.lib, self.lib.dexnerf_train_bf16_dw(ctypes.addressof(gargs), self.n_tiles,
                                                       stream),
              "bf16 weight-gradient launch")

    def reduce(self, stream: int, loss_ray=None, loss=None) -> tuple:
        """Sum the slots (and ``loss_ray`` [N] into ``loss`` [] when given);
        the gradients in ``model.parameters()`` order, views of one flat
        buffer."""
        from dexnerf_tpu_torch.ops._build import check

        check(self.lib, self.lib.dexnerf_train_bf16_reduce(
            self.partial.data_ptr(), self.n_chunks * self.n_splits, self.n_params,
            self.aux_part.data_ptr(), self.n_chunks * self.chain_ctas, self.n_aux,
            self.bmap.data_ptr(), self.grad.data_ptr(),
            None if loss_ray is None else loss_ray.data_ptr(), self.n_rays,
            None if loss is None else loss.data_ptr(), stream), "bf16 reduce launch")
        return tuple(self.grad[self.offs[name]:self.offs[name] + p.numel()].view_as(p)
                     for name, p in self.model.named_parameters())


def _launch_bf16(
    model, origins, directions, z_vals, viewdirs, dists, noise, target,
    depth_gt, depth_coef, *, white_background, supervision, log_sampling_xyz,
    log_sampling_dir,
):
    global launches, launches_bf16
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, S = z_vals.shape
    dev = z_vals.device
    tensors = [
        ("origins", origins, (N, 3)),
        ("directions", directions, (N, 3)),
        ("z_vals", z_vals, (N, S)),
        ("viewdirs", viewdirs, (N, 3)),
        ("dists", dists, (N, S)),
        ("target", target, (N, 3)),
    ]
    if noise is not None:
        tensors.append(("noise", noise, (N, S)))
    if depth_gt is not None:
        tensors += [("depth_gt", depth_gt, (N,)), ("depth_coef", depth_coef, (N,))]
    _check_inputs(model, dev, tensors, S)
    lib = load_library()
    chunk = max(1, min(N, SCRATCH_SAMPLES // S))
    args, keep = bf16_args(lib, model, chunk, S, log_sampling_xyz=log_sampling_xyz,
                           log_sampling_dir=log_sampling_dir)
    wg = Bf16Gradients(lib, model, N, S, chunk, args)
    f32 = dict(dtype=torch.float32, device=dev)
    raw = torch.empty(wg.rows * 4, **f32)
    graw = torch.empty(wg.rows * 4, **f32)
    weights = torch.empty((N, S), **f32)
    rgb = torch.empty((N, 3), **f32)
    loss_ray = torch.empty((N,), **f32)
    loss = torch.empty((), **f32)
    for name, t in (
        ("origins", origins), ("dirs", directions), ("viewdirs", viewdirs),
        ("z", z_vals), ("dists", dists), ("noise", noise), ("target", target),
        ("depth_gt", depth_gt), ("depth_coef", depth_coef), ("weights_out", weights),
        ("rgb_out", rgb), ("loss_ray", loss_ray), ("raw", raw), ("graw", graw),
    ):
        setattr(args, name, None if t is None else t.data_ptr())
    args.white_bg = int(bool(white_background))
    args.luma = int(supervision == "luminance")
    args.has_noise, args.has_depth = int(noise is not None), int(depth_gt is not None)

    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(wg.n_chunks):
        _, n_rows, tiles = wg.chunk_args(args, c)
        check(lib, lib.dexnerf_train_bf16_pass(ctypes.addressof(args), n_rows, tiles, stream),
              "fused_train_loss bf16 pass launch")
        wg.dw(c, tiles, stream)
    grads = wg.reduce(stream, loss_ray, loss)
    launches += 1
    launches_bf16 += 1
    return loss, weights, rgb, grads


class _PassLoss(torch.autograd.Function):
    """``(loss_sum, weights, rgb)`` of one pass, differentiable with respect
    to the model parameters only: the gradients come from the forward (the
    kernel's, or the plain version's), and the backward scales them by the
    loss cotangent (the counterpart of the JAX ``custom_vjp``). The
    cotangents of ``weights``/``rgb`` and of every array input are zero by
    contract: in the NeRF training graph, no gradient flows through the
    sample depths, the draws or the targets."""

    @staticmethod
    def forward(ctx, run, n_params, *args):
        loss, weights, rgb, grads = run(*args[n_params:])
        ctx.save_for_backward(*grads)
        ctx.n_inputs = len(args) - n_params
        ctx.mark_non_differentiable(weights, rgb)
        return loss, weights, rgb

    @staticmethod
    def backward(ctx, g_loss, _g_weights, _g_rgb):
        grads = [g_loss * g for g in ctx.saved_tensors]
        return (None, None, *grads, *([None] * ctx.n_inputs))


def fused_pass_loss(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    z_vals: torch.Tensor,
    viewdirs: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    depth_gt: Optional[torch.Tensor] = None,
    depth_coef: Optional[torch.Tensor] = None,
    *,
    white_background: bool = False,
    supervision: str = "rgb",
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    dw_dtype: Optional[torch.dtype] = None,
):
    """One render pass as a fused loss op (the counterpart of
    ``make_fused_pass_loss``'s ``pass_loss``): ``(loss_sum, weights [N, S],
    rgb [N, 3])`` for rays ``origins/directions/viewdirs`` [N, 3] at depths
    ``z_vals`` [N, S] with intervals ``dists`` [N, S], σ-noise ``noise``
    [N, S] (or None) and targets [N, 3]; ``loss_sum`` is the UNNORMALIZED
    squared error (plus ``sum(depth_coef * (depth - depth_gt)^2)`` when
    ``depth_gt`` [N] is given). Only ``loss_sum`` carries a gradient, to
    the model parameters. CUDA tensors go through the kernel of the dtypes
    (``fused_train_loss.cu`` at float32/float32, ``fused_train_loss_bf16.cu``
    at bfloat16/bfloat16; a mixed pair raises), CPU tensors through
    :func:`fused_pass_loss_reference` at any pair. ``dw_dtype`` None means
    float32, as in JAX."""
    dw_dtype = _check_dtypes(compute_dtype, dw_dtype)
    if supervision not in SUPERVISION:
        raise ValueError(f"unknown supervision mode: {supervision}")
    if (depth_gt is None) != (depth_coef is None):
        raise ValueError("depth_gt and depth_coef come together")
    kw = dict(
        white_background=bool(white_background),
        supervision=supervision,
        log_sampling_xyz=log_sampling_xyz,
        log_sampling_dir=log_sampling_dir,
    )
    if z_vals.device.type == "cuda":
        check_kernel_pair(compute_dtype, dw_dtype)
        launch = _launch_bf16 if compute_dtype == torch.bfloat16 else _launch

        def run(*a):
            return launch(model, *a, **kw)
    elif z_vals.device.type == "cpu":
        def run(*a):
            return fused_pass_loss_reference(
                model, *a, **kw, compute_dtype=compute_dtype, dw_dtype=dw_dtype)
    else:
        raise ValueError(f"no fused train loss for device {z_vals.device}")
    params = tuple(model.parameters())
    return _PassLoss.apply(
        run, len(params), *params, origins, directions, z_vals, viewdirs, dists,
        noise, target, depth_gt, depth_coef,
    )


def make_fused_train_loss(
    coarse_model: FlexibleNeRFModel,
    fine_model: Optional[FlexibleNeRFModel],
    settings: RenderSettings,
    *,
    supervision: str = "rgb",
    depth_loss_weight: float = 0.0,
    resample: str = "auto",
    compute_dtype: torch.dtype = torch.float32,
    dw_dtype: Optional[torch.dtype] = None,
):
    """The full hierarchical training loss through :func:`fused_pass_loss`
    at ``compute_dtype`` / ``dw_dtype`` (None: float32), the counterpart of
    ``make_fused_train_loss`` (whose defaults, f32, these are too).

    Returns ``loss_fn(rays, target [N, 3], draws, depth_gt=None) -> (loss,
    metrics)``, a drop-in for the ``render_rays`` + ``nerf_loss`` body of
    ``train.step.make_train_step``. ``draws`` is the
    :class:`~dexnerf_tpu_torch.render.renderer.RenderDraws` of the JAX
    key-split order; the stratified depths stay plain PyTorch ([N, S]-sized).
    ``resample`` names the step between the passes with the JAX package's
    values (the configs are shared): "pallas" runs the inverse-CDF
    resampling, the merge and the fine intervals in one kernel
    (:mod:`~dexnerf_tpu_torch.ops.resample`, kernel 5, on the same draws);
    "xla" and "auto" keep them plain PyTorch (``hierarchical_z_vals`` +
    ``ray_dists``), as "auto" resolves in JAX.
    Each pass's loss is normalized by N·3 (rgb) or N (luminance).
    ``depth_loss_weight`` > 0 adds ``weight * masked MSE`` of the expected
    depth against ``depth_gt`` inside the kernel (valid mask ``gt > 0``),
    on the fine pass (coarse when there is no
    fine model); ``loss_fn.supports_depth`` says whether it does."""
    s = settings
    if not s.use_viewdirs:
        raise NotImplementedError("the fused train loss requires use_viewdirs=True")
    if supervision not in SUPERVISION:
        raise ValueError(f"unknown supervision mode: {supervision}")
    kw = dict(
        white_background=s.white_background,
        supervision=supervision,
        log_sampling_xyz=s.log_sampling_xyz,
        log_sampling_dir=s.log_sampling_dir,
        compute_dtype=compute_dtype,
        dw_dtype=_check_dtypes(compute_dtype, dw_dtype),
    )
    has_fine = fine_model is not None and s.num_fine > 0
    use_depth = depth_loss_weight > 0.0
    if resample not in ("auto", "xla", "pallas"):
        raise ValueError(f"resample {resample!r}: one of 'auto', 'xla', 'pallas'")
    resample_fn = (
        make_fused_resample(s.num_coarse, s.num_fine)
        if resample == "pallas" and has_fine else None
    )

    def loss_fn(rays: RayBatch, target: torch.Tensor, draws: RenderDraws, depth_gt=None):
        if use_depth and depth_gt is None:
            raise ValueError(
                "a fused loss built with depth_loss_weight > 0 needs depth_gt"
            )
        o, d, v = (t.contiguous() for t in rays[:3])
        target = target.contiguous()
        z_vals = jittered_z_vals(rays, s, draws)
        n = target.shape[0]
        norm = float(n * 3 if supervision == "rgb" else n)
        dcoef = mask = n_valid = None
        if use_depth:
            depth_gt = depth_gt.reshape(n).to(torch.float32).contiguous()
            mask = (depth_gt > 0.0).to(torch.float32)
            n_valid = torch.clamp(torch.sum(mask), min=1.0)
            # premultiplied: the kernel's sum divided by norm is weight * masked MSE
            dcoef = (norm * depth_loss_weight / n_valid) * mask

        def depth_metric(w, z):
            return torch.sum(mask * (torch.sum(w * z, dim=-1) - depth_gt) ** 2) / n_valid

        depth_on_coarse = use_depth and not has_fine
        loss_c, w_c, _ = fused_pass_loss(
            coarse_model, o, d, z_vals, v, ray_dists(z_vals, d), draws.noise_coarse,
            target, *((depth_gt, dcoef) if depth_on_coarse else (None, None)), **kw,
        )
        coarse_loss = loss_c / norm
        fine_loss = torch.zeros((), dtype=torch.float32, device=z_vals.device)
        depth_loss = depth_metric(w_c, z_vals) if depth_on_coarse else None
        if has_fine:
            if resample_fn is not None:
                u = draws.u_fine if s.perturb else linspace(
                    0.0, 1.0, s.num_fine, device=z_vals.device).expand(n, s.num_fine)
                dn = torch.linalg.norm(d, dim=-1, keepdim=True)
                z_merged, dists_f = resample_fn(z_vals, w_c, u.contiguous(), dn)
            else:
                z_merged, _ = hierarchical_z_vals(
                    z_vals, w_c, s.num_fine, det=not s.perturb, u=draws.u_fine
                )
                dists_f = ray_dists(z_merged, d)
            depth_on_fine = use_depth and not depth_on_coarse
            loss_f, w_f, _ = fused_pass_loss(
                fine_model, o, d, z_merged, v, dists_f, draws.noise_fine,
                target, *((depth_gt, dcoef) if depth_on_fine else (None, None)), **kw,
            )
            fine_loss = loss_f / norm
            if depth_on_fine:
                depth_loss = depth_metric(w_f, z_merged)
        loss = coarse_loss + fine_loss
        metrics = {"loss": loss, "coarse_loss": coarse_loss, "fine_loss": fine_loss}
        if depth_loss is not None:
            # the photometric split, as the plain path reports it
            dl = depth_loss_weight * depth_loss
            key = "coarse_loss" if depth_on_coarse else "fine_loss"
            metrics[key] = metrics[key] - dl
            metrics["depth_loss"] = depth_loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    loss_fn.supports_depth = use_depth
    loss_fn.compute_dtype = compute_dtype
    return loss_fn
