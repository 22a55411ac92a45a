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

The f32 route: ~0.9 MFLOP per sample of the 8x128 model (forward,
cotangent chain and weight gradients), 1.42 TFLOP per train step at batch
8192 with 64 + 128 samples per ray; on the tensor cores in split TF32
(each f32 operand as two TF32 halves, three products, each K-chunk's
products added in f32), 8.6 ms at the 495 TFLOP/s dense TF32 peak of an
H100 SXM (700 W). A fine ray's activations (~650 KB) do not fit in a CTA's
shared memory, so the pass saves every layer's activations and cotangents
to a device scratch (~10 KB per sample, written and read back once: ~16 GB
a step; streaming stores, so that it does not evict the weights from L2),
capped by running the batch in chunks of ``SCRATCH_SAMPLES`` samples (~2.6
GB for 8x128, whatever the batch). Per chunk (:class:`Tf32Pass`): a per-ray
prep (viewdir encoding and bias), the forward on ``wgmma`` (kernel 1's f32
tile: persistent CTAs, a bulk-copy ring of the pre-split pack
:func:`~dexnerf_tpu_torch.ops.fused_render.pack_flex_weights_tf32`; layer1
alone as a sequential f32 FMA chain on the CUDA cores
(:func:`pack_layer1_f32`), whose rounding the lower trunk's gradients
follow most closely; the
activations stored from the accumulator registers, the ReLU masks as bits
in the accumulator's thread order: :func:`tf32_mask_words`), f32
compositing and its backward one warp per ray (shared with the bf16 route),
and the cotangent chain on ``wgmma`` against
:func:`pack_backward_weights_tf32`. The weight gradients, products over
every sample of the batch, run in split TF32 too (``ops/csrc/dw_tf32.cu``),
bound by the scratch's bytes; persistent CTAs sum equal shares of them into
separate slots, and the slots are reduced in a fixed order: no atomics,
bitwise-repeatable runs. The scratch and those launches are
``ops/_weight_grads.py``'s, shared with the field backward (kernel 3).

The bf16 route: the same 1.42 TFLOP on the bf16 tensor cores (1.435 ms at
the 989 TFLOP/s dense bf16 peak), so its scratch traffic bounds it first:
activations and cotangents saved in bf16, sample-major, ~5 KB per sample
(~1.3 GB a chunk for 8x128), written once and read back by the chain's
ReLU masks and the weight gradients (~20 GB a step, ~6 ms at 3.35 TB/s).
Its design, per chunk: a per-ray prep (viewdir encoding and bias), the
forward on ``wgmma`` (kernel 1's bf16 tile: persistent CTAs whose consumer
warpgroups each run 64-row tiles through the whole MLP, fed by a bulk-copy
ring of the pre-swizzled pack :func:`~dexnerf_tpu_torch.ops.fused_render.pack_flex_weights_bf16`,
f32 heads from the accumulators, every activation stored to the scratch by
TMA from a swizzled staging tile), f32 compositing and its backward one
warp per ray, the cotangent chain on ``wgmma`` against
:func:`pack_backward_weights_bf16`, its weights, masks and stores moved by
TMA, with the bias sums and the viewdir rows' dW accumulated per consumer
warpgroup in a fixed order, and the weight gradients on ``wgmma`` by the
plan of :func:`dw_plan` (each scratch block read once per unit, TMA boxes,
equal shares of the bytes per CTA, one slot per CTA and unit); one
fixed-order reduction: bitwise-repeatable runs. Widths that are not a multiple of 32 run
zero-padded to one. Padded widths above 128, up to
:data:`~dexnerf_tpu_torch.ops.fused_render.MAX_HIDDEN_BF16`, take the wide
route: the forward and the chain on ``ops/csrc/mlp_wide_bf16.cuh``'s tile
(the layers in shared memory, column blocks of 64, a fresh accumulator a
K-chunk; the chain's ReLU masks the mask words the forward writes,
:func:`wide_mask_words`), the
dW plan's units split to the kernel's limits (:func:`dw_split`) and
launched in parts (:func:`_cached_dw_parts`) with a fresh accumulator a
stage. The f32 route
takes padded widths above 128, up to
:data:`~dexnerf_tpu_torch.ops.fused_render.MAX_HIDDEN`, on its own wide
route: the forward and the chain on ``ops/csrc/mlp_wide_tf32.cuh``'s tile
(the layer's input as an f32 tile in shared memory, split into TF32 halves
on load, column blocks of at most 128, each layer's output stored to the
scratch and read back), the same prep, compositing, scratch and mask words,
and the split-TF32 dW plan split to its kernel's limits and launched in
parts (``ops/_weight_grads.py``). The same kernels, with :func:`bf16_args` and
:class:`Bf16Gradients`, are the bf16 routes of the field kernels (kernel 2
forward, kernel 3 backward: ``ops/fused_mlp.py``, ``ops/fused_mlp_train.py``).
Measured times: ``PERF.md``.

``launches`` counts kernel-4 passes of either route, ``launches_bf16``
those of the bf16 route, ``launches_wide`` those of its wide route and
``launches_wide_f32`` those of the f32 route's wide kernels (+1 per pass,
where the pass launches its group of ``__global__`` kernels; nowhere else),
so a run can show which kernel its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, linspace
from dexnerf_tpu_torch.core.volrend import composite, ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops._weight_grads import (
    WeightGradients,
    _param_offsets,
    check_dw_args_size,
)
from dexnerf_tpu_torch.ops.fused_render import (
    TF32_KCHUNK,
    _cached_bf16_weights,
    _cached_pack,
    _cached_tf32_weights,
    _round_up,
    _tf32_chunks,
    bf16_hidden,
    check_fusable,
    check_width,
    gather_params,
    gather_plan,
    is_wide,
    tf32_split,
)
from dexnerf_tpu_torch.ops.resample import make_fused_resample
from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderDraws,
    RenderSettings,
    jittered_z_vals,
)

launches = 0  # kernel-4 passes of either route
launches_bf16 = 0  # of which the bf16 route's (narrow or wide)
launches_wide = 0  # of which the wide bf16 kernels'
launches_wide_f32 = 0  # of which the wide f32 kernels'

# samples of activation/cotangent scratch per chunk of rays
SCRATCH_SAMPLES = 1 << 18
# limits of ops/csrc/fused_train_loss.cu
SLOTS = 64
MAX_LAYERS = 40
MAX_FREQ = 16
MAX_SAMPLES = 256
# of ops/csrc/fused_train_loss_bf16.cu (kMaxBlocks, kDw*)
MAX_BLOCKS = MAX_LAYERS + 8
DW_BOX = 64
DW_MAX_MAPS = 2 * MAX_LAYERS - 8
DW_MAX_UNITS = 36
DW_MAX_BOXES = 6
DW_MAX_BLOCKS = 8
DW_MAX_PARTS = 8  # launches of a plan in parts (kDwMaxParts)
DW_SMEM_MAX = 232448
WIDE_BOX_ROWS = 64  # rows of the wide chain's weight boxes (kWideBlock; the narrow's: Hp)
CHAIN_KCHUNK = 64  # K of a chain weight chunk (one [Hp][64] TMA box)
ENC_PAD = 32  # the scratch's encoding block: dim_xyz padded to a multiple (kEncPad)
# the f32 pass's kernels (``parts`` bits of ops/csrc/fused_train_loss.cu): prep,
# forward, compositing, chain
PASS_PARTS = 1 | 2 | 4 | 8
# who launches the f32 pass kernels (their kOwner tag there): the field forward
# (kernel 2), the field backward (kernel 3), the fused train loss (kernel 4)
FIELD_FWD, FIELD_BWD, LOSS = 2, 3, 4
SUPERVISION = ("rgb", "luminance")
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class _TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in ops/csrc/fused_train_loss.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "origins", "dirs", "viewdirs", "pts", "z", "dists", "noise", "target",
            "depth_gt", "depth_coef", "wq", "aux", "wbq", "w1", "weights_out", "rgb_out",
            "loss_ray", "act", "dlt", "dir_enc", "dy_sum", "dirb", "raw", "graw", "masks",
            "wbuf",
        )
    ] + [("k", ctypes.c_int64)] + [
        (name, ctypes.c_int32)
        for name in (
            "ray0", "n_rays", "n_samples", "s_pad", "hidden", "hp", "num_trunk",
            "skip_mask", "fx", "fd", "inc_x", "inc_d", "dx", "kx", "dd", "white_bg", "luma",
            "has_noise", "has_depth", "sms", "fwd_stages", "chain_stages", "parts",
        )
    ] + [
        ("aux_off", ctypes.c_int32 * (MAX_LAYERS + 8)),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


def s_pad_of(S: int) -> int:
    """The f32 pass kernels' samples a ray: S padded to whole 64-sample
    tiles (a tile lies in one ray)."""
    return -(-S // SLOTS) * SLOTS


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
        # the model's own compute dtype is its plain path's, not the kernel's
        forward = functools.partial(model, dtype=torch.float32)
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


def _check_inputs(model, dev, tensors, S: int, compute_dtype) -> None:
    check_fusable(model, "the fused loss kernel")
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
    check_width(model.hidden_size, compute_dtype, "the fused loss kernel")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray: the kernel takes 1..{MAX_SAMPLES}")
    nt = model.num_layers - 1
    if nt + 5 > MAX_LAYERS or nt > 31:
        raise ValueError(f"{model.num_layers} layers: too deep for the kernel")
    if max(model.num_encoding_fn_xyz, model.num_encoding_fn_dir) > MAX_FREQ:
        raise ValueError(f"the kernel takes at most {MAX_FREQ} PE frequencies")


def _check_struct_sizes(lib) -> None:
    if lib.dexnerf_train_args_size() != ctypes.sizeof(_TrainArgs):
        raise RuntimeError(
            f"_TrainArgs is {ctypes.sizeof(_TrainArgs)} bytes here but "
            f"{lib.dexnerf_train_args_size()} in the kernel library"
        )
    check_dw_args_size(lib)


def _tf32_backward_layout(model: FlexibleNeRFModel, w: dict) -> Tuple[torch.Tensor]:
    """:func:`pack_backward_weights_tf32`'s layout of the parameters ``w``
    (name -> tensor) before the split."""
    H = model.hidden_size
    Hp = bf16_hidden(H)
    kd, nt = _round_up(Hp // 2, TF32_KCHUNK), model.num_layers - 1
    parts = [_tf32_chunks(w["layers_dir.0.weight"][:, :H].t(), kd, Hp),
             _tf32_chunks(w["fc_feat.weight"].t(), Hp, Hp)]
    parts += [_tf32_chunks(w[f"layers_xyz.{i}.weight"][:, :H].t(), Hp, Hp)
              for i in reversed(range(nt))]
    return (torch.cat(parts),)


def pack_backward_weights_tf32(model: FlexibleNeRFModel, device=None) -> torch.Tensor:
    """The f32 chain's weights (``ops/csrc/fused_train_loss.cu``), the
    products that run on the tensor cores, in the chain's order:
    ``layers_dir.0``'s feat rows, ``fc_feat``, then ``layers_xyz.i`` [:, :H]
    from the last to the first (``fc_rgb`` and ``fc_alpha`` stay f32 on the
    CUDA cores, from the forward pack's aux). Each as the B operand [in, out] (the transpose
    of ``nn.Linear.weight``) zero-padded to Hp = ``bf16_hidden`` rows and K
    (out) to a multiple of 32, K in ``tf32_feature_order``, as [Hp, 32]
    K-chunks in wgmma's 128 B swizzle, each first as hi = tf32(w), then as
    lo = tf32(w - hi): one ring stage each, in consumption order. One gather
    of the parameters (``gather_plan``), then the split."""
    (idx,) = gather_plan(_tf32_backward_layout, model, next(model.parameters()).device)
    with torch.no_grad():
        hi, lo = tf32_split(gather_params(model, idx)[0])
        n = bf16_hidden(model.hidden_size) * TF32_KCHUNK
        wbq = torch.stack([hi.view(-1, n), lo.view(-1, n)], 1).reshape(-1)
    return wbq.to(device)


def _cached_tf32_backward(model: FlexibleNeRFModel, device):
    return _cached_pack(pack_backward_weights_tf32, model, device)


def pack_layer1_f32(model: FlexibleNeRFModel, device=None) -> torch.Tensor:
    """layer1's weights for the f32 forward's CUDA-core product: ``[in,
    out]`` (the transpose of ``nn.Linear.weight``), float32, the outputs
    zero-padded to Hp = ``bf16_hidden``."""
    with torch.no_grad():
        w = model.layer1.weight.detach().t().to(torch.float32)
        w = F.pad(w, (0, bf16_hidden(model.hidden_size) - w.shape[1])).contiguous()
    return w.to(device)


def tf32_mask_layout(hp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) [128, hp/2] of each bit of a thread's mask words for an
    [64, hp] activation tile: thread t (warp t // 32, lane l, g = l // 4, q
    = l % 4) holds, as wgmma's accumulator, entry 4 j + e at row 16 (t //
    32) + g + 8 (e // 2) and column 8 j + 2 q + e % 2; entry i is bit i % 32
    of word i // 32."""
    t = torch.arange(128)[:, None]
    i = torch.arange(hp // 2)[None, :]
    g, q, j, e = (t % 32) // 4, t % 4, i // 4, i % 4
    return 16 * (t // 32) + g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def tf32_mask_words(acts, hp: int) -> torch.Tensor:
    """The plain version of the f32 forward's ReLU mask words: ``acts`` the
    recorded activations a_1..a_nt, feat ([k, >= hp] each, k a multiple of
    64; columns past the model's width zero) and y ([k, >= hp/2]), as the
    kernel writes their bits (``> 0``) for each 64-column tile: int32
    [k / 64, (nt + 1) ceil(hp / 64) + ceil(hp / 128), 128], word w of layer
    l of a thread at [tile][l ceil(hp / 64) + w][thread] (y's words last);
    see :func:`tf32_mask_layout`."""
    mw = -(-hp // 64)
    k = acts[0].shape[0]
    out = torch.zeros((k // 64, (len(acts) - 1) * mw + -(-(hp // 2) // 64), 128),
                      dtype=torch.int64)
    for l, act in enumerate(acts):
        width = hp if l < len(acts) - 1 else hp // 2
        rows, cols = tf32_mask_layout(width)
        bits = (act[:, :width] > 0).reshape(k // 64, 64, width)[:, rows, cols].to(torch.int64)
        i = torch.arange(width // 2)
        first = l * mw
        for w in range(-(-(width // 2) // 32)):
            sel = i // 32 == w
            word = (bits[..., sel] << (i[sel] % 32)).sum(-1)  # distinct bits: sum = or
            out[:, first + w] = word
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


# (width, encoding chunks, depth, device) -> tf32_occupancy's result
_tf32_residency = {}


def tf32_occupancy(model: FlexibleNeRFModel) -> dict:
    """The residency of the f32 pass's forward and chain kernels for
    ``model`` (the wide route's above a padded width of 128), as the CUDA
    runtime and the launcher report them (needs the card; once per shape and
    device): each as (CTAs per SM, shared bytes per CTA, weight ring
    stages), and ``cons`` their consumer warpgroups a CTA."""
    from dexnerf_tpu_torch.ops._build import check, load_library

    dev = torch.cuda.current_device()
    kx = -(-model.dim_xyz // TF32_KCHUNK)
    key = (bf16_hidden(model.hidden_size), kx, model.num_layers, dev)
    if key not in _tf32_residency:
        lib = load_library()
        out = (ctypes.c_int * 8)()
        check(lib, lib.dexnerf_train_tf32_occupancy(key[0], model.num_layers - 1, kx,
                                                    ctypes.addressof(out)),
              "fused_train_loss f32 occupancy query")
        if min(out[0], out[3]) < 1:
            raise RuntimeError(f"the f32 pass kernels do not fit on an SM: {list(out)}")
        _tf32_residency[key] = {"forward": tuple(out[0:3]), "chain": tuple(out[3:6]),
                                "cons": tuple(out[6:8])}
    return _tf32_residency[key]


class Tf32Pass:
    """The f32 route's pass kernels (``ops/csrc/fused_train_loss.cu``) over
    ``N`` rays of ``S`` samples in chunks of ``chunk`` rays, as launcher
    ``owner`` runs them: kernel 4 (:data:`LOSS`: prep, forward, compositing
    and chain, ``args.parts`` of :data:`PASS_PARTS`), kernel 3, the field
    backward (:data:`FIELD_BWD`: prep, forward and chain on the caller's
    cotangent ``inputs["graw"]`` [N, S, 4]; the points from
    ``inputs["pts"]``), or kernel 2, the field forward (:data:`FIELD_FWD`:
    prep and forward into ``inputs["raw"]`` [N, S, 4]; no scratch, ``wg``
    None; on the wide route a buffer of layer outputs a worker). It holds
    the argument block (the forward and chain packs, cached per parameter
    state), the per-chunk buffers (the viewdir bias, raw [cols][4] and its
    cotangent, the mask words) and the scratch of ``wg``
    (:class:`WeightGradients`). :meth:`run` launches chunk ``c``'s kernels,
    which fill the scratch for ``wg.chunk``."""

    def __init__(self, lib, model, inputs: dict, N: int, S: int, s_pad: int, chunk: int, wg,
                 *, owner=LOSS, white_background=False, supervision="rgb",
                 log_sampling_xyz=True, log_sampling_dir=True):
        _check_struct_sizes(lib)
        dev = next(t for t in inputs.values() if t is not None).device
        H, nt = model.hidden_size, model.num_layers - 1
        Hp = bf16_hidden(H)
        kx = -(-model.dim_xyz // TF32_KCHUNK)
        occ = tf32_occupancy(model)
        wq, aux, aux_off = _cached_tf32_weights(model, dev)
        w1 = _cached_pack(pack_layer1_f32, model, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        cols = chunk * s_pad
        self.tile_words = lib.dexnerf_train_tile_words(Hp, nt)
        self.dirb = torch.empty(chunk * Hp // 2, **f32)
        bufs = {"wq": wq, "aux": aux, "w1": w1, "dirb": self.dirb}
        if owner != FIELD_FWD:  # the chain's pack, the scratch and the mask words
            self.raw = torch.empty(cols * 4, **f32)
            self.masks = torch.empty(cols // 64 * self.tile_words * 128, dtype=torch.int32,
                                     device=dev)
            bufs.update(wbq=_cached_tf32_backward(model, dev), act=wg.act, dlt=wg.dlt,
                        dir_enc=wg.dir_enc, dy_sum=wg.dy_sum, raw=self.raw, masks=self.masks)
        if owner == LOSS:
            self.graw = bufs["graw"] = torch.empty(cols * 4, **f32)
        if owner == FIELD_FWD and is_wide(model):  # [Hp][64] a worker of the forward
            workers = torch.cuda.get_device_properties(dev).multi_processor_count * occ["cons"][0]
            bufs["wbuf"] = torch.empty(workers * Hp * 64, **f32)
        self.keep = (bufs, inputs)  # the buffers args points to
        self.lib, self.chunk, self.N, self.s_pad, self.owner = lib, chunk, N, s_pad, owner
        a = self.args = _TrainArgs()
        for name, t in (*bufs.items(), *inputs.items()):
            setattr(a, name, None if t is None else t.data_ptr())
        a.n_samples, a.s_pad = S, s_pad
        a.hidden, a.hp, a.num_trunk = H, Hp, nt
        a.skip_mask = sum(1 << i for i in model.skips)
        a.fx, a.fd = model.num_encoding_fn_xyz, model.num_encoding_fn_dir
        a.inc_x, a.inc_d = int(model.include_input_xyz), int(model.include_input_dir)
        a.dx, a.kx, a.dd = model.dim_xyz, kx, model.dim_dir
        a.white_bg = int(bool(white_background))
        a.luma = int(supervision == "luminance")
        a.has_noise = int(inputs.get("noise") is not None)
        a.has_depth = int(inputs.get("depth_gt") is not None)
        a.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        a.fwd_stages, a.chain_stages = occ["forward"][2], occ["chain"][2]
        a.parts = PASS_PARTS
        a.aux_off[:len(aux_off)] = aux_off
        bx = frequency_bands(model.num_encoding_fn_xyz, log_sampling_xyz).tolist()
        bd = frequency_bands(model.num_encoding_fn_dir, log_sampling_dir).tolist()
        a.bands_x[:len(bx)] = bx
        a.bands_d[:len(bd)] = bd

    def run(self, c: int, stream: int) -> int:
        """Launch chunk ``c``'s pass kernels; returns its rays."""
        from dexnerf_tpu_torch.ops._build import check

        a = self.args
        a.ray0 = c * self.chunk
        a.n_rays = min(self.chunk, self.N - a.ray0)
        a.k = a.n_rays * self.s_pad
        if self.owner == LOSS:
            check(self.lib, self.lib.dexnerf_train_pass(ctypes.addressof(a), stream),
                  "fused_train_loss pass launch")
        else:
            bwd = self.owner == FIELD_BWD
            check(self.lib, self.lib.dexnerf_field_tf32_pass(ctypes.addressof(a), int(bwd), stream),
                  f"fused field f32 {'backward' if bwd else 'forward'} launch")
        return a.n_rays


def _launch(
    model, origins, directions, z_vals, viewdirs, dists, noise, target,
    depth_gt, depth_coef, *, white_background, supervision, log_sampling_xyz,
    log_sampling_dir,
):
    global launches, launches_wide_f32
    from dexnerf_tpu_torch.ops._build import load_library

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
    _check_inputs(model, dev, tensors, S, torch.float32)
    lib = load_library()

    s_pad = s_pad_of(S)
    chunk = max(1, min(N, SCRATCH_SAMPLES // s_pad))
    f32 = dict(dtype=torch.float32, device=dev)
    wg = WeightGradients(lib, model, N, chunk, s_pad, dev)
    weights = torch.empty((N, S), **f32)
    rgb = torch.empty((N, 3), **f32)
    loss_ray = torch.empty((N,), **f32)
    loss = torch.empty((), **f32)
    inputs = dict(origins=origins, dirs=directions, viewdirs=viewdirs, z=z_vals, dists=dists,
                  noise=noise, target=target, depth_gt=depth_gt, depth_coef=depth_coef,
                  weights_out=weights, rgb_out=rgb, loss_ray=loss_ray)
    ps = Tf32Pass(lib, model, inputs, N, S, s_pad, chunk, wg,
                  white_background=white_background, supervision=supervision,
                  log_sampling_xyz=log_sampling_xyz, log_sampling_dir=log_sampling_dir)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(wg.n_chunks):
        wg.chunk(c, ps.run(c, stream), stream)
    grads = wg.reduce(stream, loss_ray, loss)
    launches += 1
    launches_wide_f32 += int(is_wide(model))
    return loss, weights, rgb, grads


class _Bf16TrainArgs(ctypes.Structure):
    """Mirror of ``TrainArgs`` in ops/csrc/fused_train_loss_bf16.cu."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "origins", "dirs", "viewdirs", "pts", "z", "dists", "noise", "target",
            "depth_gt", "depth_coef", "wq", "aux", "wbq", "weights_out", "rgb_out",
            "loss_ray", "scratch", "raw", "graw", "dir_enc", "dirb", "aux_part", "masks",
        )
    ] + [
        ("act_off", ctypes.c_int64 * MAX_BLOCKS),
        ("dlt_off", ctypes.c_int64 * MAX_BLOCKS),
    ] + [
        (name, ctypes.c_int32)
        for name in (
            "ray0", "n_rays", "n_samples", "hidden", "num_trunk", "skip_mask",
            "fx", "fd", "inc_x", "inc_d", "dx", "dxp", "dd",
            "white_bg", "luma", "has_noise", "has_depth", "chain_ctas", "fwd_ctas",
        )
    ] + [
        ("aux_off", ctypes.c_int32 * (MAX_LAYERS + 8)),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


class _DwBlock(ctypes.Structure):
    """Mirror of ``DwBlock`` in ops/csrc/fused_train_loss_bf16.cu."""

    _fields_ = [(name, ctypes.c_int32)
                for name in ("a", "b", "small", "base", "ldw", "n_lim", "m_lim", "pad")]


class _DwUnit(ctypes.Structure):
    """Mirror of ``DwUnit``: one unit of :func:`dw_plan`."""

    _fields_ = [(name, ctypes.c_int32) for name in ("n_a", "n_b", "n_blocks", "cost", "tx")] + [
        ("pad", ctypes.c_int32 * 3),
        ("map", ctypes.c_int32 * DW_MAX_BOXES),
        ("col", ctypes.c_int32 * DW_MAX_BOXES),
        ("blk", _DwBlock * DW_MAX_BLOCKS),
    ]


class _DwArgs(ctypes.Structure):
    """Mirror of ``DwArgs``: the tensor maps of the scratch blocks (128
    bytes each, filled by the library), the plan's units and the slots."""

    _fields_ = [
        ("maps", ctypes.c_uint8 * (128 * DW_MAX_MAPS)),
        ("units", _DwUnit * DW_MAX_UNITS),
        ("partial", ctypes.c_void_p),
        ("n_params", ctypes.c_int64),
    ] + [(name, ctypes.c_int32) for name in (
        "n_units", "total_cost", "grid", "max_pieces", "n_stages", "stage_bytes", "fresh")] + [
        ("pad", ctypes.c_int32 * 5),
    ]


class _ChainMaps(ctypes.Structure):
    """Mirror of ``ChainMaps``: the tensor maps of the backward pack and of
    the scratch blocks (as ``_DwArgs.maps``)."""

    _fields_ = [("w", ctypes.c_uint8 * 128), ("blocks", ctypes.c_uint8 * (128 * DW_MAX_MAPS))]


class DwUnit(NamedTuple):
    """One unit of the bf16 weight-gradient plan: products read together,
    each operand once. ``a`` and ``b`` are the boxes of the cotangent and
    activation operands, (scratch block, first column): the block indexes
    :func:`_scratch_layout`'s activation blocks, then its cotangent blocks;
    a box is 64 samples x 64 columns, zero past the block's width, or 64 x
    8 for an 8-wide block (a head's cotangents; ``a_small``). ``blocks`` are
    the 64 x 64 output blocks, (A box, B box (both indices into ``a +
    b``), offset in the flat gradient, its row stride, rows, columns).
    ``cost`` is the bytes per sample the unit reads, over 16; ``tx`` the
    bytes of one stage of 64 samples."""

    a: Tuple[Tuple[int, int], ...]
    b: Tuple[Tuple[int, int], ...]
    blocks: Tuple[Tuple[int, int, int, int, int, int], ...]
    cost: int
    tx: int
    a_small: Tuple[bool, ...]


def dw_unit(widths, products) -> DwUnit:
    """The unit of ``products`` over scratch blocks of ``widths`` columns:
    each (cotangent block, activation block, offset of dW[0][0] in the flat
    gradient, its row stride, N, M). Every block's boxes are read once."""
    a_blk = list(dict.fromkeys(p[0] for p in products))
    b_blk = list(dict.fromkeys(p[1] for p in products))
    a = [(k, c) for k in a_blk for c in range(0, widths[k], DW_BOX)]
    b = [(k, c) for k in b_blk for c in range(0, widths[k], DW_BOX)]
    blocks = []
    for d, x, off, ldw, n, m in products:
        for ia, (k, n0) in enumerate(a):
            for ib, (kb, m0) in enumerate(b):
                if k == d and kb == x and n0 < n and m0 < m:
                    blocks.append((ia, len(a) + ib, off + n0 * ldw + m0, ldw,
                                   min(DW_BOX, n - n0), min(DW_BOX, m - m0)))
    return _dw_unit_of(widths, a, b, blocks)


def _dw_unit_of(widths, a, b, blocks) -> DwUnit:
    """The unit of boxes ``a`` (cotangent) and ``b`` (activation) with
    output ``blocks``: its cost and stage bytes."""
    cost = sum(min(DW_BOX, widths[k] - c) * 2 // 16 for k, c in (*a, *b))
    tx = sum(64 * 8 * 2 if widths[k] == 8 else DW_BOX * DW_BOX * 2 for k, _ in (*a, *b))
    return DwUnit(tuple(a), tuple(b), tuple(blocks), cost, tx,
                  tuple(widths[k] == 8 for k, _ in a))


def dw_split(widths, d, x, off, ldw, n, m) -> list:
    """The product dW[n][m] = d^T x (scratch blocks d and x) as units
    within the kernel's limits (at most DW_MAX_BOXES boxes, DW_MAX_BLOCKS
    output blocks): the boxes of d that hold rows below n in groups of ga,
    by those of x in groups of gb, ga and gb those that give the fewest
    units, then the fewest boxes read. For the wide route, whose products
    have up to 9 x 9 boxes."""
    na = -(-min(n, widths[d]) // DW_BOX)
    nb = -(-min(m, widths[x]) // DW_BOX)
    best = None
    for ga in range(1, DW_MAX_BOXES):
        for gb in range(1, DW_MAX_BOXES + 1 - ga):
            if ga * gb <= DW_MAX_BLOCKS:
                ua, ub = -(-na // ga), -(-nb // gb)
                key = (ua * ub, ub * na + ua * nb)
                if best is None or key < best[0]:
                    best = (key, ga, gb)
    _, ga, gb = best
    units = []
    for a0 in range(0, na, ga):
        for b0 in range(0, nb, gb):
            a = [(d, DW_BOX * i) for i in range(a0, min(na, a0 + ga))]
            b = [(x, DW_BOX * i) for i in range(b0, min(nb, b0 + gb))]
            blocks = [(ia, len(a) + ib, off + n0 * ldw + m0, ldw, min(DW_BOX, n - n0),
                       min(DW_BOX, m - m0))
                      for ia, (_, n0) in enumerate(a) for ib, (_, m0) in enumerate(b)]
            units.append(_dw_unit_of(widths, a, b, blocks))
    return units


def dw_plan(model: FlexibleNeRFModel) -> Tuple[DwUnit, ...]:
    """The units of the bf16 weight gradients dW[n][m] = sum_k d[k][n]
    a[k][m] (d a layer's output cotangent, a its input, both sample-major
    bf16 scratch blocks), each placed in the flat gradient
    (:func:`_param_offsets`). In order: layer1 (d_0 x e); each trunk layer
    i (d_{i+1} x a_i, and on a skip layer d_{i+1} x e, the cotangent read
    once: e is the narrower operand to read twice); fc_feat and fc_alpha
    (sharing a_last); layers_dir.0's feat rows (d_y x feat) with fc_rgb
    (d_rgb x y), a unit too small alone. A unit over the kernel's limits
    (the wide route's) becomes its products split by :func:`dw_split`. The
    viewdir rows of layers_dir.0 and the biases are the chain's
    (:func:`_aux_map`)."""
    H, nt, dx, dd = model.hidden_size, model.num_layers - 1, model.dim_xyz, model.dim_dir
    _, _, act_w, dlt_w = _scratch_layout(model)
    widths = act_w + dlt_w
    offs, _ = _param_offsets(model)
    dlt = len(act_w)  # the first cotangent block

    def unit(products):
        """products: (cotangent block, activation block, param, ldw, col_off, N, M)."""
        prods = [(d, x, offs[name] + col_off, ldw, n, m)
                 for d, x, name, ldw, col_off, n, m in products]
        u = dw_unit(widths, prods)
        if len(u.a) + len(u.b) <= DW_MAX_BOXES and len(u.blocks) <= DW_MAX_BLOCKS:
            return [u]
        return [v for p in prods for v in dw_split(widths, *p)]

    units = unit([(dlt, 0, "layer1.weight", dx, 0, H, dx)])
    for i, lin in enumerate(model.layers_xyz):
        name, ldw = f"layers_xyz.{i}.weight", lin.in_features
        products = [(dlt + i + 1, 1 + i, name, ldw, 0, H, H)]
        if i in model.skips:
            products.append((dlt + i + 1, 0, name, ldw, H, H, dx))
        units += unit(products)
    units += unit([(dlt + nt + 1, nt + 1, "fc_feat.weight", H, 0, H, H),
                   (dlt + nt + 4, nt + 1, "fc_alpha.weight", H, 0, 1, H)])
    units += unit([(dlt + nt + 2, nt + 2, "layers_dir.0.weight", H + dd, 0, H // 2, H),
                   (dlt + nt + 3, nt + 3, "fc_rgb.weight", H // 2, 0, 3, H // 2)])
    return tuple(units)


def dw_owner(p: int, total: int, grid: int) -> int:
    """The CTA whose share [b T / G, (b + 1) T / G) of the plan's work holds
    position ``p`` (``dw_owner`` in the kernel)."""
    return ((p + 1) * grid - 1) // total


def dw_spans(costs, n_st: int, grid: int):
    """The dW kernel's work split (``dw_span`` there): the units laid end
    to end, unit u over n_st ``costs[u]`` positions (its stages of 64
    samples), CTA b owning [b T / G, (b + 1) T / G) of the total T. For each
    CTA, its parts as (unit, slot, first stage, end stage): its slot is its
    rank among the CTAs with a part of the unit, and it writes the slot even
    when it has no stage of the unit."""
    T = n_st * sum(costs)
    spans = [[] for _ in range(grid)]
    pre = 0
    for u, c in enumerate(costs):
        S, E = n_st * pre, n_st * (pre + c)
        first = dw_owner(S, T, grid)
        for b in range(first, dw_owner(E - 1, T, grid) + 1):
            lo, hi = b * T // grid, (b + 1) * T // grid
            j0, j1 = (min(n_st, -(-(x - S) // c)) if x > S else 0 for x in (lo, hi))
            spans[b].append((u, b - first, j0, j1))
        pre += c
    return spans


def dw_max_pieces(costs, grid: int) -> int:
    """A bound on the slots one unit takes in any launch (the CTAs whose
    shares meet an interval of n_st cost positions of n_st sum(costs))."""
    return min(grid, max(-(-c * grid // sum(costs)) + 1 for c in costs))


# (widths, depth, skips, encodings, grid) -> the plan's parts, each (_DwArgs of
# its units without the tensor maps and slots, the kernel's shared-memory bytes)
_dw_templates = {}


def _cached_dw_parts(model: FlexibleNeRFModel, grid: int) -> list:
    """:func:`dw_plan` in parts of at most DW_MAX_UNITS units, each launched
    on its own (one part up to a padded width of 128), as
    :func:`dw_template`s; on the wide route each stage's products go into a
    fresh accumulator (``fresh``), added to the sum in f32."""
    key = (model.hidden_size, model.num_layers, tuple(model.skips), model.dim_xyz,
           model.dim_dir, grid)
    if key not in _dw_templates:
        units = dw_plan(model)
        parts = [dw_template(units[i:i + DW_MAX_UNITS], grid)
                 for i in range(0, len(units), DW_MAX_UNITS)]
        for args, _ in parts:  # the wide route's small units run long: fresh accumulators
            args.fresh = int(is_wide(model))
        if len(parts) > DW_MAX_PARTS:
            raise ValueError(f"{len(units)} weight-gradient units: the bf16 kernels take at "
                             f"most {DW_MAX_PARTS * DW_MAX_UNITS} (a shallower or narrower "
                             "model)")
        _dw_templates[key] = parts
    return _dw_templates[key]


def _cached_dw_template(model: FlexibleNeRFModel, grid: int):
    """The first part of :func:`_cached_dw_parts` (the whole plan up to a
    padded width of 128)."""
    return _cached_dw_parts(model, grid)[0]


def dw_template(units, grid: int):
    """(a ``_DwArgs`` of ``units`` on ``grid`` CTAs, without the tensor
    maps and the slots; the kernel's shared-memory bytes): the ring has as
    many stages as fit, each as large as the unit with the most boxes."""
    args = _DwArgs()
    for slot, u in zip(args.units, units):
        boxes = u.a + u.b
        slot.n_a, slot.n_b, slot.n_blocks = len(u.a), len(u.b), len(u.blocks)
        slot.cost, slot.tx = u.cost, u.tx
        slot.map[:len(boxes)] = [k for k, _ in boxes]
        slot.col[:len(boxes)] = [c for _, c in boxes]
        for blk, v in zip(slot.blk, u.blocks):
            blk.a, blk.b, blk.base, blk.ldw, blk.n_lim, blk.m_lim = v
            blk.small = int(u.a_small[v[0]])
    costs = [u.cost for u in units]
    args.n_units, args.total_cost, args.grid = len(units), sum(costs), grid
    args.max_pieces = dw_max_pieces(costs, grid)
    args.stage_bytes = max(len(u.a) + len(u.b) for u in units) * DW_BOX * DW_BOX * 2
    args.n_stages = min(8, (DW_SMEM_MAX - 1024) // (args.stage_bytes + 16))
    return args, 1024 + args.n_stages * (args.stage_bytes + 16)


def _k_chunks64(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``w`` [N, K] zero-padded to ``n`` rows and ``k`` (a multiple of 64)
    columns, as flat [k/64, n, 64]."""
    w = F.pad(w, (0, k - w.shape[1], 0, n - w.shape[0]))
    return w.reshape(n, k // CHAIN_KCHUNK, CHAIN_KCHUNK).transpose(0, 1).reshape(-1)


def _backward_layout(model: FlexibleNeRFModel, w: dict) -> Tuple[torch.Tensor]:
    """:func:`pack_backward_weights_bf16`'s layout of the parameters ``w``
    (name -> tensor), before rounding."""
    H = model.hidden_size
    Hp = bf16_hidden(H)
    k2, k = _round_up(Hp // 2, CHAIN_KCHUNK), _round_up(Hp, CHAIN_KCHUNK)
    nt = model.num_layers - 1
    parts = [_k_chunks64(w["layers_dir.0.weight"][:, :H].t(), k2, Hp),
             _k_chunks64(w["fc_feat.weight"].t(), k, Hp)]
    parts += [_k_chunks64(w[f"layers_xyz.{i}.weight"][:, :H].t(), k, Hp)
              for i in reversed(range(nt))]
    return (torch.cat(parts),)


def pack_backward_weights_bf16(model: FlexibleNeRFModel, device=None) -> torch.Tensor:
    """The bf16 chain's weights: each product's matrix [in, out] (the
    transpose of ``nn.Linear.weight``, rounded to bf16, zero-padded to Hp = ``bf16_hidden`` rows and to K a
    multiple of 64) as [Hp, 64] K-chunks (one 128 B-swizzled TMA box and
    wgmma B operand each) in the chain's order: ``layers_dir.0`` (feat
    rows), ``fc_feat``, then ``layers_xyz`` from the last to the first (h
    rows). The heads stay f32 (the forward pack's aux). One gather of the
    parameters (``gather_plan``)."""
    (idx,) = gather_plan(_backward_layout, model, next(model.parameters()).device)
    with torch.no_grad():
        return gather_params(model, idx)[0].to(torch.bfloat16).to(device)


def _scratch_layout(model: FlexibleNeRFModel):
    """(Hp, dxp, widths of the activation blocks, of the cotangent blocks)
    of the bf16 scratch: e, a_0..a_nt, feat, y; d_0..d_nt, feat, y, rgb,
    sigma (the last two 8 wide)."""
    Hp = bf16_hidden(model.hidden_size)
    nt = model.num_layers - 1
    dxp = _round_up(model.dim_xyz, ENC_PAD)
    act = [dxp] + [Hp] * (nt + 1) + [Hp, Hp // 2]
    dlt = [Hp] * (nt + 1) + [Hp, Hp // 2, 8, 8]
    return Hp, dxp, act, dlt


def wide_mask_words(hp: int, nt: int) -> int:
    """The bf16 wide route's ReLU mask words a thread of a 64-row tile
    (``wide_mask_words`` in ops/csrc/mlp_wide_bf16.cuh), which its forward
    writes and its chain reads: ceil(hp / 64) for each of a_1 .. a_nt and
    feat, then ceil(hp / 128) for y, each bit the saved bf16 activation's
    ``> 0`` (:func:`wide_mask_layout`)."""
    return (nt + 1) * -(-hp // 64) + -(-(hp // 2) // 64)


def wide_mask_layout(hp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) [128, 32 ceil(hp / 64)] of each bit of a thread's mask
    words for an [64, hp] activation tile on the bf16 wide route: thread t
    (warp t // 32, lane l, g = l // 4, q = l % 4) holds the entry of row 16
    (t // 32) + g + 8 h and column 64 w + 8 j + 2 q + e in bit (h ? 7 : 15)
    + 16 e - j of its word w (``wide_mask_bit`` there); entry i of the
    layout is bit i % 32 of word i // 32. Columns at or past hp are none."""
    t = torch.arange(128)[:, None]
    i = torch.arange(32 * -(-hp // 64))[None, :]
    b, e = i % 32, (i % 32) // 16
    h = ((b % 16) < 8).to(torch.int64)
    j = torch.where(h == 1, 7 - b % 16, 15 - b % 16)
    g, q = (t % 32) // 4, t % 4
    return 16 * (t // 32) + g + 8 * h, 64 * (i // 32) + 8 * j + 2 * q + e


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


def dw_unit_map(model: FlexibleNeRFModel) -> torch.Tensor:
    """For each entry of the flat gradient, how many of :func:`dw_plan`'s
    output blocks write it (0 or 1), and -1 - the unit of the last."""
    offs, n = _param_offsets(model)
    count = torch.zeros(n, dtype=torch.int32)
    unit = torch.zeros(n, dtype=torch.int32)
    for u, un in enumerate(dw_plan(model)):
        for _, _, base, ldw, n_lim, m_lim in un.blocks:
            idx = (base + torch.arange(n_lim)[:, None] * ldw + torch.arange(m_lim)).reshape(-1)
            count[idx] += 1
            unit[idx] = -1 - u
    return count, unit


def _aux_map(model: FlexibleNeRFModel, device) -> Tuple[torch.Tensor, int]:
    """For each entry of the flat gradient: -1 - its unit of
    :func:`dw_plan` where the dW slots hold it, else its index in a chain
    CTA's slot (``aux_*`` in ops/csrc/fused_train_loss_bf16.cu: the bias
    sums, then the viewdir rows of ``layers_dir.0`` as [dd, Hp/2]). Returns
    the map and the slot length."""
    H, nt, dd = model.hidden_size, model.num_layers - 1, model.dim_dir
    Hp = bf16_hidden(H)
    Hp2, H2 = Hp // 2, H // 2
    offs, n = _param_offsets(model)
    m = dw_unit_map(model)[1]

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


# (width, encodings, depth, skips, device) -> bf16_occupancy's result
_residency = {}


def bf16_occupancy(model: FlexibleNeRFModel) -> dict:
    """The residency of the bf16 kernels for ``model``, as the CUDA runtime
    and the launchers report them (needs the card; once per shape and
    device): ``forward`` (kernels 4 and 3, saving the activations) and
    ``field_forward`` (kernel 2) as (CTAs per SM, shared bytes per CTA,
    weight ring stages, staging tiles per consumer warpgroup); ``chain`` and
    ``dw`` as (CTAs per SM, shared bytes per CTA). On the wide route
    (:func:`~dexnerf_tpu_torch.ops.fused_render.is_wide`) ``forward``,
    ``field_forward`` and ``chain`` are (CTAs per SM, shared bytes per CTA,
    ring stages, consumer warpgroups)."""
    from dexnerf_tpu_torch.ops._build import check, load_library

    dev = torch.cuda.current_device()
    key = (bf16_hidden(model.hidden_size), model.dim_xyz, model.num_layers, tuple(model.skips),
           model.dim_dir, dev)
    if key not in _residency:
        lib = load_library()
        shape = (key[0], model.dim_xyz, model.num_layers - 1, model.dim_dir,
                 sum(1 << i for i in model.skips))
        if is_wide(model):  # each kernel's 4th entry: its consumer warpgroups
            out = (ctypes.c_int * 12)()
            check(lib, lib.dexnerf_train_bf16_wide_occupancy(*shape, ctypes.addressof(out)),
                  "fused_train_loss wide bf16 occupancy query")
            res = {"forward": tuple(out[0:4]), "field_forward": tuple(out[4:8]),
                   "chain": tuple(out[8:12])}
        else:
            out = (ctypes.c_int * 10)()
            check(lib, lib.dexnerf_train_bf16_occupancy(*shape, ctypes.addressof(out)),
                  "fused_train_loss bf16 occupancy query")
            res = {"forward": tuple(out[0:4]), "field_forward": tuple(out[4:8]),
                   "chain": tuple(out[8:10])}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        dw_smem = max(smem for _, smem in _cached_dw_parts(model, sms))
        dw = ctypes.c_int(0)
        check(lib, lib.dexnerf_train_bf16_dw_occupancy(dw_smem, ctypes.byref(dw)),
              "bf16 weight-gradient occupancy query")
        _residency[key] = {**res, "dw": (dw.value, dw_smem)}
    return _residency[key]


def fwd_ctas(model: FlexibleNeRFModel, device) -> int:
    """The bf16 training forward's persistent CTAs on ``device``: every SM,
    as many as fit on one (:func:`bf16_occupancy`)."""
    occ = bf16_occupancy(model)
    ctas = min(occ["forward"][0], occ["field_forward"][0])
    if ctas < 1:
        raise RuntimeError(f"the bf16 training forward does not fit on an SM: {occ}")
    return ctas * torch.cuda.get_device_properties(device).multi_processor_count


def bf16_args(lib, model: FlexibleNeRFModel, n_rays: int, n_samples: int, *,
              log_sampling_xyz: bool, log_sampling_dir: bool):
    """A ``_Bf16TrainArgs`` with the model's layout (zero-padded to
    ``bf16_hidden``), its bf16 forward pack (kernel 1's, packed once per
    parameter state for both) and f32 heads, the forward's persistent CTAs
    (:func:`fwd_ctas`) and the per-ray prep buffers of ``n_rays`` rays
    (``dir_enc``, ``dirb``) filled in, for
    the bf16 kernels of the fused train loss (kernel 4) and of the fields
    (kernels 2 and 3); and the tensors it points to (keep them until the
    launches are done)."""
    for which, struct in ((0, _Bf16TrainArgs), (1, _DwArgs), (2, _ChainMaps)):
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
    args.fwd_ctas = fwd_ctas(model, dev)
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
    tiles), the chain CTAs' slots, the dW plan (:func:`dw_plan`, with a TMA
    tensor map of each scratch block, built once here: chunks reuse the
    scratch), its slots and the launches that sum them. The constructor
    points ``args`` (from :func:`bf16_args`) at the scratch and the backward
    pack; per chunk ``c``, :meth:`chunk_args` points it at the chunk, the
    caller launches its pass kernels, then :meth:`dw` the chunk's
    weight-gradient products; :meth:`reduce` sums every slot in a fixed
    order."""

    def __init__(self, lib, model: FlexibleNeRFModel, n_rays: int, n_samples: int, chunk: int,
                 args):
        from dexnerf_tpu_torch.ops._build import check

        dev = next(model.parameters()).device
        nt, dd = model.num_layers - 1, model.dim_dir
        Hp, _, act_w, dlt_w = _scratch_layout(model)
        self.lib, self.model, self.n_rays, self.S, self.chunk = lib, model, n_rays, n_samples, chunk
        self.n_aux = lib.dexnerf_train_bf16_size(3, Hp, nt, dd)
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
        self.masks = None  # the wide route's mask words, written by its forward
        if is_wide(model):
            n_words = lib.dexnerf_train_bf16_size(4, Hp, nt, dd)
            if n_words != wide_mask_words(Hp, nt):
                raise RuntimeError(f"{wide_mask_words(Hp, nt)} mask words a thread here but "
                                   f"{n_words} in the library")
            self.masks = torch.empty(rows // 64 * n_words * 128, dtype=torch.int32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # the chain's slots: a slot per consumer warpgroup (two a CTA on the
        # narrow route), one CTA per SM
        cons = bf16_occupancy(model)["chain"][3] if is_wide(model) else 2
        self.chain_ctas = cons * max(1, min(rows // 128, sms))
        self.aux_part = torch.empty(self.n_chunks * self.chain_ctas * self.n_aux, **f32)
        self.offs, self.n_params = _param_offsets(model)
        # the dW plan's parts (one up to a padded width of 128), each launched
        # on its own slots, with the same tensor maps
        parts = _cached_dw_parts(model, sms)
        self.dw_parts = (_DwArgs * len(parts))(*(t for t, _ in parts))
        self.dw_args = self.dw_parts[0]
        for i, (off, w) in enumerate(zip(act_off + dlt_off, act_w + dlt_w)):
            check(lib, lib.dexnerf_train_bf16_tensor_map(
                ctypes.addressof(self.dw_args) + 128 * i, self.scratch.data_ptr() + 2 * off, w,
                rows, DW_BOX), "bf16 scratch tensor map")
        self.partials = []
        for a in self.dw_parts:
            ctypes.memmove(a.maps, self.dw_args.maps, ctypes.sizeof(a.maps))
            self.partials.append(torch.empty(self.n_chunks * a.max_pieces * self.n_params, **f32))
            a.partial, a.n_params = self.partials[-1].data_ptr(), self.n_params
        self.partial = self.partials[0]
        self.grad = torch.empty(self.n_params, **f32)
        self.wbq = pack_backward_weights_bf16(model, dev)
        self.chain_maps = _ChainMaps()
        ctypes.memmove(self.chain_maps.blocks, self.dw_args.maps, ctypes.sizeof(self.dw_args.maps))
        check(lib, lib.dexnerf_train_bf16_tensor_map(
            ctypes.addressof(self.chain_maps), self.wbq.data_ptr(), CHAIN_KCHUNK,
            self.wbq.numel() // CHAIN_KCHUNK, WIDE_BOX_ROWS if is_wide(model) else Hp),
            "bf16 backward-pack tensor map")
        args.scratch, args.wbq = self.scratch.data_ptr(), self.wbq.data_ptr()
        args.masks = None if self.masks is None else self.masks.data_ptr()
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
        tiles of scratch rows: 2 ``tiles`` stages of 64)."""
        from dexnerf_tpu_torch.ops._build import check

        for a in self.dw_parts:
            check(self.lib, self.lib.dexnerf_train_bf16_dw(ctypes.addressof(a), 2 * tiles, c,
                                                           stream),
                  "bf16 weight-gradient launch")

    def reduce(self, stream: int, loss_ray=None, loss=None) -> tuple:
        """Sum the slots (and ``loss_ray`` [N] into ``loss`` [] when given);
        the gradients in ``model.parameters()`` order, views of one flat
        buffer."""
        from dexnerf_tpu_torch.ops._build import check

        last = self.n_rays - (self.n_chunks - 1) * self.chunk
        check(self.lib, self.lib.dexnerf_train_bf16_reduce(
            ctypes.addressof(self.dw_parts), len(self.dw_parts), self.n_chunks, self.rows // 64,
            2 * -(-last * self.S // 128),
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
    global launches, launches_bf16, launches_wide
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
    _check_inputs(model, dev, tensors, S, torch.bfloat16)
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
        check(lib, lib.dexnerf_train_bf16_pass(ctypes.addressof(args),
                                               ctypes.addressof(wg.chain_maps), n_rows, tiles,
                                               stream),
              "fused_train_loss bf16 pass launch")
        wg.dw(c, tiles, stream)
    grads = wg.reduce(stream, loss_ray, loss)
    launches += 1
    launches_bf16 += 1
    launches_wide += int(is_wide(model))
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
    depth_valid_max: Optional[float] = None,
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
    depth against ``depth_gt`` inside the kernel (valid mask ``gt > 0``,
    and ``gt < depth_valid_max`` when that is given), on the fine pass (coarse when there is no
    fine model); ``loss_fn.supports_depth`` says whether it does."""
    s = settings
    if not s.use_viewdirs:
        raise NotImplementedError("the fused train loss requires use_viewdirs=True")
    for m in (coarse_model, fine_model):
        check_fusable(m, "the fused loss kernel")
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
            mask = depth_gt > 0.0
            if depth_valid_max is not None:
                mask = mask & (depth_gt < depth_valid_max)
            mask = mask.to(torch.float32)
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
