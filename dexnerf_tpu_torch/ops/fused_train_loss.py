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
bitwise-repeatable runs. The scratch and those launches are
``ops/_weight_grads.py``'s, shared with the field backward (kernel 3).
Measured times: ``PERF.md``.

``launches`` counts kernel calls (+1 per pass, where the pass launches its
group of ``__global__`` kernels; nowhere else), so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.metrics import luminance
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, linspace
from dexnerf_tpu_torch.core.volrend import composite, ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops._weight_grads import (
    MAX_ITEMS,
    WeightGradients,
    check_gemm_args_size,
    pack_backward_weights,
)
from dexnerf_tpu_torch.ops.fused_render import pack_flex_weights
from dexnerf_tpu_torch.ops.resample import make_fused_resample
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
    resample: str = "auto",
):
    """The full hierarchical training loss through :func:`fused_pass_loss`
    (the counterpart of ``make_fused_train_loss``).

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
    return loss_fn
