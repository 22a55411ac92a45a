"""Fused training loss of one render pass: PE -> MLP -> σ-noise ->
compositing -> squared error, with the gradient of the loss sum with
respect to every model parameter.

Counterpart of ``dexnerf_tpu/ops/fused_train_loss.py``, whose Pallas
kernel (``_make_loss_kernel``) this module's CUDA kernel
(``ops/csrc/fused_train_loss.cu``, built by ``ops/_build.py``) replaces.
On a CUDA tensor :func:`fused_pass_loss` launches the kernel; on a CPU
tensor it runs :func:`fused_pass_loss_reference`, the plain PyTorch
version of the same contract (pts, PE, model forward, noise,
``composite``, loss sum, then ``torch.autograd.grad``). There is no
fallback between the two: a CUDA call that cannot launch raises.

What bounds the kernel on the H100, and how it is built: f32 FMA work,
~0.9 MFLOP per sample of the 8x128 model (forward, cotangent chain and
weight gradients), 1.42 TFLOP per train step at batch 8192 with 64 + 128
samples per ray, 21.2 ms at the 67 TFLOP/s f32 peak of an H100 SXM
(700 W). A fine ray's activations (~650 KB) do not fit in a CTA's 227 KB
of shared memory, so the kernel saves every layer's activations and
cotangents to a device scratch (~10 KB per sample, written and read back
once: ~31 GB of traffic a step, written with streaming stores so that it
does not evict the weights from L2), capped by running the batch in
chunks of ``SCRATCH_SAMPLES`` samples (~2.6 GB for 8x128, whatever the
batch). The weight gradients, products over every sample of the batch,
are summed by CTAs that each own a 128 x 128 tile and a K-range, into
separate slots, and the slots are reduced in a fixed order: no atomics,
bitwise-repeatable runs. Measured times: ``PERF.md``.

``launches`` counts kernel calls (+1 per pass, where the pass launches its
group of ``__global__`` kernels; nowhere else), so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
from dexnerf_tpu_torch.core.volrend import composite, ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops.fused_render import pack_flex_weights
from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderDraws,
    RenderSettings,
    jittered_z_vals,
)

launches = 0

# samples of activation/cotangent scratch per chunk of rays
SCRATCH_SAMPLES = 1 << 18
# limits of ops/csrc/fused_train_loss.cu
SLOTS = 64
MAX_LAYERS = 40
MAX_FREQ = 16
MAX_SAMPLES = 256
MAX_HIDDEN = 128
MAX_ITEMS = 40
TILE = 128
SUPERVISION = ("rgb", "luminance")


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


class _GemmItem(ctypes.Structure):
    """Mirror of ``GemmItem``: one weight-gradient product."""

    _fields_ = [
        ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
        ("ld", ctypes.c_int64), ("k", ctypes.c_int64),
    ] + [
        (name, ctypes.c_int32)
        for name in ("m", "n", "m_tiles", "tile0", "w_off", "ldw", "col_off", "b_off")
    ]


class _GemmArgs(ctypes.Structure):
    _fields_ = [
        ("items", _GemmItem * MAX_ITEMS),
        ("partial", ctypes.c_void_p),
        ("n_params", ctypes.c_int64),
        ("n_items", ctypes.c_int32),
        ("n_splits", ctypes.c_int32),
        ("part0", ctypes.c_int32),
    ]


def pack_backward_weights(model: FlexibleNeRFModel, device=None) -> Tuple[torch.Tensor, list]:
    """The matrices the cotangent chain multiplies by, each ``[out, in]``
    row-major as ``nn.Linear.weight`` keeps it (the transpose of the
    forward pack), cut to the input columns that carry a gradient, each
    starting on a 16-byte boundary: ``fc_rgb`` [3, H/2], ``layers_dir.0``
    [H/2, :H], ``fc_feat`` with ``fc_alpha`` as one more row [H + 1, H],
    then ``layers_xyz.i`` [H, :H]. Returns the buffer and the offsets."""
    H = model.hidden_size
    mats = [
        model.fc_rgb.weight,
        model.layers_dir[0].weight[:, :H],
        torch.cat([model.fc_feat.weight, model.fc_alpha.weight], dim=0),
        *(lin.weight[:, :H] for lin in model.layers_xyz),
    ]
    chunks, offsets, pos = [], [], 0
    for m in mats:
        pad = -pos % 4
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.float32, device=m.device))
            pos += pad
        offsets.append(pos)
        flat = m.detach().reshape(-1).to(torch.float32)
        chunks.append(flat)
        pos += flat.numel()
    return torch.cat(chunks).to(device), offsets


def _param_offsets(model) -> Tuple[dict, int]:
    """Offset of every parameter in the flat gradient, in
    ``model.named_parameters()`` order, and the total count."""
    offs, pos = {}, 0
    for name, p in model.named_parameters():
        offs[name] = pos
        pos += p.numel()
    return offs, pos


def pass_loss_sum(rgb: torch.Tensor, target: torch.Tensor, supervision: str) -> torch.Tensor:
    """Unnormalized squared error over the batch: per channel (``rgb``) or
    of the Rec.601 luminance (``luminance``)."""
    if supervision == "rgb":
        return torch.sum((rgb - target) ** 2)
    if supervision == "luminance":
        return torch.sum((luminance(rgb) - luminance(target)) ** 2)
    raise ValueError(f"unknown supervision mode: {supervision}")


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
):
    """Plain PyTorch version of the kernel's contract. Returns ``(loss_sum,
    weights [N, S], rgb [N, 3], grads)``, ``grads`` in
    ``model.parameters()`` order; ``loss_sum`` adds ``sum(depth_coef *
    (sum_s w z - depth_gt)^2)`` when ``depth_gt`` is given."""
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
            model(xyz, view), z_vals, dists,
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
    for which, struct in ((0, _TrainArgs), (1, _GemmArgs)):
        if lib.dexnerf_train_args_size(which) != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__name__} is {ctypes.sizeof(struct)} bytes here but "
                f"{lib.dexnerf_train_args_size(which)} in the kernel library"
            )


def _scratch_rows(lib, model) -> dict:
    """The scratch layout as the kernel library defines it (``Rows`` in
    ops/csrc/fused_train_loss.cu), in rows of ``k`` floats: the row counts
    ``act_rows``/``dlt_rows``, the first row of each named block, and the
    lists ``a`` (layer1's output, then the trunk's) and ``d`` (their
    cotangents, then feat's)."""
    from dexnerf_tpu_torch.ops._build import check

    nt = model.num_layers - 1
    buf = (ctypes.c_int * (2 * nt + 11))()
    check(lib, lib.dexnerf_train_rows(model.dim_xyz, model.hidden_size, nt, buf, len(buf)),
          "fused_train_loss scratch layout")
    names = ("act_rows", "dlt_rows", "e", "feat", "y", "dsig", "dy", "drgb")
    rows = dict(zip(names, buf))
    rows["a"] = list(buf[len(names):len(names) + nt + 1])
    rows["d"] = list(buf[len(names) + nt + 1:])
    return rows


def _dw_items(model, rows, act, dlt, dir_enc, dy_sum, k: int, rays: int, offs: dict):
    """The weight-gradient products of one chunk (``k`` scratch columns,
    ``rays`` rays, scratch layout ``rows``) as (a, b, ld, K, M, N, w_off,
    ldw, col_off, b_off)."""
    H, H2, nt = model.hidden_size, model.hidden_size // 2, model.num_layers - 1
    dx, dd = model.dim_xyz, model.dim_dir
    a, d = rows["a"], rows["d"]

    def act_row(r):
        return act.data_ptr() + 4 * r * k

    def dlt_row(r):
        return dlt.data_ptr() + 4 * r * k

    e = act_row(rows["e"])
    items = [(e, dlt_row(d[0]), k, k, dx, H, offs["layer1.weight"], dx, 0,
              offs["layer1.bias"])]
    for i, lin in enumerate(model.layers_xyz):
        w, b = offs[f"layers_xyz.{i}.weight"], offs[f"layers_xyz.{i}.bias"]
        n_in = lin.in_features
        items.append((act_row(a[i]), dlt_row(d[i + 1]), k, k, H, H, w, n_in, 0, b))
        if i in model.skips:
            items.append((e, dlt_row(d[i + 1]), k, k, dx, H, w, n_in, H, -1))
    items += [
        (act_row(a[nt]), dlt_row(d[nt + 1]), k, k, H, H, offs["fc_feat.weight"], H, 0,
         offs["fc_feat.bias"]),
        (act_row(a[nt]), dlt_row(rows["dsig"]), k, k, H, 1, offs["fc_alpha.weight"], H, 0,
         offs["fc_alpha.bias"]),
        (act_row(rows["feat"]), dlt_row(rows["dy"]), k, k, H, H2,
         offs["layers_dir.0.weight"], H + dd, 0, offs["layers_dir.0.bias"]),
        (dir_enc.data_ptr(), dy_sum.data_ptr(), rays, rays, dd, H2,
         offs["layers_dir.0.weight"], H + dd, H, -1),
        (act_row(rows["y"]), dlt_row(rows["drgb"]), k, k, H2, 3, offs["fc_rgb.weight"], H2, 0,
         offs["fc_rgb.bias"]),
    ]
    return items


def _gemm_args(items, partial, n_params: int, n_splits: int, part0: int):
    args = _GemmArgs()
    tile0 = 0
    for slot, (a, b, ld, k, m, n, w_off, ldw, col_off, b_off) in zip(args.items, items):
        m_tiles, n_tiles = -(-m // TILE), -(-n // TILE)
        slot.a, slot.b, slot.ld, slot.k = a, b, ld, k
        slot.m, slot.n, slot.m_tiles, slot.tile0 = m, n, m_tiles, tile0
        slot.w_off, slot.ldw, slot.col_off, slot.b_off = w_off, ldw, col_off, b_off
        tile0 += m_tiles * n_tiles
    args.partial = partial.data_ptr()
    args.n_params = n_params
    args.n_items, args.n_splits, args.part0 = len(items), n_splits, part0
    return args, tile0


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

    H2, dd = model.hidden_size // 2, model.dim_dir
    rows = _scratch_rows(lib, model)
    s_pad = -(-S // SLOTS) * SLOTS
    chunk = max(1, min(N, SCRATCH_SAMPLES // s_pad))
    n_chunks = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch, reused by every chunk (all launches are on one stream)
    act = torch.empty(rows["act_rows"] * chunk * s_pad, **f32)
    dlt = torch.empty(rows["dlt_rows"] * chunk * s_pad, **f32)
    dir_enc = torch.empty(dd * chunk, **f32)
    dy_sum = torch.empty(H2 * chunk, **f32)
    weights = torch.empty((N, S), **f32)
    rgb = torch.empty((N, 3), **f32)
    loss_ray = torch.empty((N,), **f32)
    loss = torch.empty((), **f32)
    offs, n_params = _param_offsets(model)
    grad = torch.empty((n_params,), **f32)
    wf, f_off = pack_flex_weights(model, dev)
    wb, b_off = pack_backward_weights(model, dev)

    args = _TrainArgs()
    for name, t in (
        ("origins", origins), ("dirs", directions), ("viewdirs", viewdirs),
        ("z", z_vals), ("dists", dists), ("noise", noise), ("target", target),
        ("depth_gt", depth_gt), ("depth_coef", depth_coef), ("wf", wf), ("wb", wb),
        ("weights_out", weights), ("rgb_out", rgb), ("loss_ray", loss_ray),
        ("act", act), ("dlt", dlt), ("dir_enc", dir_enc), ("dy_sum", dy_sum),
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

    # K-splits of the dW products: about eight CTAs per SM in all (tiles
    # differ in cost; more, shorter CTAs even out the last wave)
    n_tiles = _gemm_args(
        _dw_items(model, rows, act, dlt, dir_enc, dy_sum, 1, 1, offs), grad, n_params, 1, 0
    )[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits = max(1, min(256, 8 * sms // n_tiles))
    partial = torch.empty((n_chunks * n_splits * n_params,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in range(n_chunks):
        ray0 = c * chunk
        rays = min(chunk, N - ray0)
        args.ray0, args.n_rays, args.k = ray0, rays, rays * s_pad
        check(lib, lib.dexnerf_train_pass(ctypes.addressof(args), stream),
              "fused_train_loss pass launch")
        items = _dw_items(model, rows, act, dlt, dir_enc, dy_sum, rays * s_pad, rays, offs)
        gargs, tiles = _gemm_args(items, partial, n_params, n_splits, c * n_splits)
        check(lib, lib.dexnerf_train_dw(ctypes.addressof(gargs), tiles, stream),
              "fused_train_loss dW launch")
    check(
        lib,
        lib.dexnerf_train_reduce(
            partial.data_ptr(), n_chunks * n_splits, n_params, grad.data_ptr(),
            loss_ray.data_ptr(), N, loss.data_ptr(), stream,
        ),
        "fused_train_loss reduce launch",
    )
    launches += 1
    grads = tuple(
        grad[offs[name]:offs[name] + p.numel()].view_as(p)
        for name, p in model.named_parameters()
    )
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
):
    """One render pass as a fused loss op (the counterpart of
    ``make_fused_pass_loss``'s ``pass_loss``): ``(loss_sum, weights [N, S],
    rgb [N, 3])`` for rays ``origins/directions/viewdirs`` [N, 3] at depths
    ``z_vals`` [N, S] with intervals ``dists`` [N, S], σ-noise ``noise``
    [N, S] (or None) and targets [N, 3]; ``loss_sum`` is the UNNORMALIZED
    squared error (plus ``sum(depth_coef * (depth - depth_gt)^2)`` when
    ``depth_gt`` [N] is given). Only ``loss_sum`` carries a gradient, to
    the model parameters. CUDA tensors go through the kernel, CPU tensors
    through :func:`fused_pass_loss_reference`."""
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
        def run(*a):
            return _launch(model, *a, **kw)
    elif z_vals.device.type == "cpu":
        def run(*a):
            return fused_pass_loss_reference(model, *a, **kw)
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
):
    """The full hierarchical training loss through :func:`fused_pass_loss`
    (the counterpart of ``make_fused_train_loss``).

    Returns ``loss_fn(rays, target [N, 3], draws, depth_gt=None) -> (loss,
    metrics)``, a drop-in for the ``render_rays`` + ``nerf_loss`` body of
    ``train.step.make_train_step``. ``draws`` is the
    :class:`~dexnerf_tpu_torch.render.renderer.RenderDraws` of the JAX
    key-split order; the stratified depths, the inverse-CDF resampling and
    the ray intervals between the passes stay plain PyTorch ([N, S]-sized).
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
    )
    has_fine = fine_model is not None and s.num_fine > 0
    use_depth = depth_loss_weight > 0.0

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
            z_merged, _ = hierarchical_z_vals(
                z_vals, w_c, s.num_fine, det=not s.perturb, u=draws.u_fine
            )
            depth_on_fine = use_depth and not depth_on_coarse
            loss_f, w_f, _ = fused_pass_loss(
                fine_model, o, d, z_merged, v, ray_dists(z_merged, d), draws.noise_fine,
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
    return loss_fn
