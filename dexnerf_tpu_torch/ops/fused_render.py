"""Fully fused render pass: PE -> MLP -> alpha compositing -> Dex depth.

Counterpart of ``dexnerf_tpu/ops/fused_render.py``. On a CUDA tensor,
:func:`fused_render` launches the hand-written kernel of
``ops/csrc/fused_render.cu`` (built by ``ops/_build.py``); on a CPU tensor
it runs :func:`fused_render_reference`, the plain PyTorch version of the
same contract. There is no fallback between the two: a CUDA call that
cannot launch raises.

``launches`` counts kernel launches (+1 per launch, nowhere else), so a
run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
from dexnerf_tpu_torch.core.volrend import (
    VolumeRenderOutputs,
    composite,
    concat_outputs,
    ray_dists,
)
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderResult, RenderSettings

launches = 0

# limits of ops/csrc/fused_render.cu (kMax*, kThreads)
MAX_LAYERS = 40
MAX_FREQ = 16
MAX_THRESHOLDS = 64
MAX_SAMPLES = 256
MAX_HIDDEN = 128
SHARED_BYTES_LIMIT = 232448  # per block on Hopper


def _layers(model: FlexibleNeRFModel):
    """The model's linear layers in the kernel's consumption order."""
    return [
        model.layer1,
        *model.layers_xyz,
        model.fc_feat,
        model.fc_alpha,
        model.layers_dir[0],
        model.fc_rgb,
    ]


def pack_flex_weights(
    model: FlexibleNeRFModel, device=None
) -> Tuple[torch.Tensor, List[int]]:
    """The kernel's weight layout (it replaces
    ``dexnerf_tpu/ops/fused_mlp.py::split_flex_params``): one flat float32
    buffer holding, per layer in :func:`_layers` order, the kernel
    ``[in, out]`` row-major (the transpose of ``nn.Linear.weight``) and then
    the bias, each starting on a 16-byte boundary. Returns the buffer and
    the offsets ``[w0, b0, w1, b1, ...]`` in floats."""
    chunks, offsets, pos = [], [], 0
    for lin in _layers(model):
        for t in (lin.weight.detach().t(), lin.bias.detach()):
            pad = -pos % 4
            if pad:
                chunks.append(torch.zeros(pad, dtype=torch.float32, device=t.device))
                pos += pad
            offsets.append(pos)
            flat = t.reshape(-1).to(torch.float32)
            chunks.append(flat)
            pos += flat.numel()
    return torch.cat(chunks).to(device), offsets


@torch.no_grad()
def fused_render_reference(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    *,
    thresholds: Sequence[float] = (),
    white_background: bool = False,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    chunk: int = 8192,
) -> VolumeRenderOutputs:
    """Plain PyTorch version of the kernel's contract, ``chunk`` rays at a
    time: pts = o + d*z, PE, the model forward, and compositing with the
    given ``dists`` (disparity in the kernel's finite form). No autograd,
    like the kernel."""
    parts = []
    for i in range(0, z_vals.shape[0], chunk):
        sl = slice(i, i + chunk)
        z = z_vals[sl]
        pts = origins[sl, None, :] + directions[sl, None, :] * z[..., None]
        xyz = positional_encoding(
            pts, model.num_encoding_fn_xyz, model.include_input_xyz, log_sampling_xyz
        )
        view = positional_encoding(
            viewdirs[sl], model.num_encoding_fn_dir, model.include_input_dir,
            log_sampling_dir,
        )
        parts.append(
            composite(
                model(xyz, view), z, dists[sl],
                white_background=white_background,
                m_thres_cand=tuple(thresholds) or None,
            )
        )
    return concat_outputs(parts)


def _check_inputs(model, dev, tensors, N: int, S: int, T: int) -> None:
    if not isinstance(model, FlexibleNeRFModel):
        raise TypeError(f"the fused render kernel takes FlexibleNeRFModel, not {type(model)}")
    for name, t, shape in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    H = model.hidden_size
    if H > MAX_HIDDEN or H % 8 or H < 8:
        raise ValueError(f"hidden_size {H}: the kernel takes multiples of 8 up to {MAX_HIDDEN}")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray: the kernel takes 1..{MAX_SAMPLES}")
    if T > MAX_THRESHOLDS:
        raise ValueError(f"{T} thresholds: the kernel takes at most {MAX_THRESHOLDS}")
    nt = model.num_layers - 1
    if nt + 5 > MAX_LAYERS or nt > 31:
        raise ValueError(f"{model.num_layers} layers: too deep for the kernel")
    if max(model.num_encoding_fn_xyz, model.num_encoding_fn_dir) > MAX_FREQ:
        raise ValueError(f"the kernel takes at most {MAX_FREQ} PE frequencies")
    shared = 4 * ((model.dim_xyz + 2 * H) * 64 + 7 * S + model.dim_dir + H // 2)
    if shared > SHARED_BYTES_LIMIT:
        raise ValueError(f"{shared} bytes of shared memory needed; the card has {SHARED_BYTES_LIMIT}")


def _host_array(ctype, values):
    arr = (ctype * max(1, len(values)))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _launch(
    model, origins, directions, viewdirs, z_vals, dists, *, thresholds,
    white_background, log_sampling_xyz, log_sampling_dir,
) -> VolumeRenderOutputs:
    global launches
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, S = z_vals.shape
    T = len(thresholds)
    dev = z_vals.device
    _check_inputs(
        model,
        dev,
        [
            ("origins", origins, (N, 3)),
            ("directions", directions, (N, 3)),
            ("viewdirs", viewdirs, (N, 3)),
            ("z_vals", z_vals, (N, S)),
            ("dists", dists, (N, S)),
        ],
        N, S, T,
    )
    lib = load_library()
    weights, offsets = pack_flex_weights(model, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    rgb = torch.empty((N, 3), **f32)
    disp = torch.empty((N,), **f32)
    acc = torch.empty((N,), **f32)
    depth = torch.empty((N,), **f32)
    w = torch.empty((N, S), **f32)
    dex = torch.empty((T, N), **f32) if T else None
    bx = frequency_bands(model.num_encoding_fn_xyz, log_sampling_xyz).tolist()
    bd = frequency_bands(model.num_encoding_fn_dir, log_sampling_dir).tolist()
    # host arrays, copied into the launch's parameter block by the call;
    # the *_arr names keep them alive until then
    bx_arr, bx_ptr = _host_array(ctypes.c_float, bx)
    bd_arr, bd_ptr = _host_array(ctypes.c_float, bd)
    th_arr, th_ptr = _host_array(ctypes.c_float, [float(m) for m in thresholds])
    off_arr, off_ptr = _host_array(ctypes.c_int, offsets)
    skip_mask = sum(1 << i for i in model.skips)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.dexnerf_fused_render(
        origins.data_ptr(), directions.data_ptr(), viewdirs.data_ptr(),
        z_vals.data_ptr(), dists.data_ptr(), weights.data_ptr(),
        rgb.data_ptr(), disp.data_ptr(), acc.data_ptr(), depth.data_ptr(),
        w.data_ptr(), dex.data_ptr() if dex is not None else None,
        N, S, model.hidden_size, model.num_layers - 1, skip_mask,
        model.num_encoding_fn_xyz, int(model.include_input_xyz), bx_ptr,
        model.num_encoding_fn_dir, int(model.include_input_dir), bd_ptr,
        T, th_ptr, off_ptr, int(bool(white_background)), stream,
    )
    check(lib, code, "fused_render kernel launch")
    launches += 1
    return VolumeRenderOutputs(
        rgb=rgb, disparity=disp, accumulation=acc, weights=w, depth=depth,
        depth_dex=dex,
    )


@torch.no_grad()
def fused_render(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    *,
    thresholds: Sequence[float] = (),
    white_background: bool = False,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
) -> VolumeRenderOutputs:
    """One deterministic render pass over rays ``origins/directions/
    viewdirs`` [N, 3] at depths ``z_vals`` [N, S] with intervals ``dists``
    [N, S] (the counterpart of ``make_fused_render``'s render). Returns
    [N]-shaped maps, weights [N, S] and ``depth_dex`` [T, N] (None when no
    thresholds). CUDA tensors go through the kernel, CPU tensors through
    :func:`fused_render_reference`."""
    kwargs = dict(
        thresholds=tuple(float(m) for m in thresholds),
        white_background=white_background,
        log_sampling_xyz=log_sampling_xyz,
        log_sampling_dir=log_sampling_dir,
    )
    if z_vals.device.type == "cuda":
        return _launch(model, origins, directions, viewdirs, z_vals, dists, **kwargs)
    if z_vals.device.type == "cpu":
        return fused_render_reference(
            model, origins, directions, viewdirs, z_vals, dists, **kwargs
        )
    raise ValueError(f"no fused render for device {z_vals.device}")


def make_fused_render_rays(
    coarse_model: FlexibleNeRFModel,
    fine_model: Optional[FlexibleNeRFModel],
    settings: RenderSettings,
):
    """Deterministic coarse->fine renderer over one ray batch with field
    evaluation and compositing in :func:`fused_render` (the counterpart of
    ``make_fused_render_rays``): a ``rays_impl`` for ``render_image``.
    Stratified depths, the inverse-CDF resampling and the ray intervals
    stay plain PyTorch ([N, S]-sized)."""
    s = settings.eval_variant()
    kw = dict(
        white_background=s.white_background,
        log_sampling_xyz=s.log_sampling_xyz,
        log_sampling_dir=s.log_sampling_dir,
    )

    def render(rays: RayBatch) -> RenderResult:
        o = rays.origins.contiguous()
        d = rays.directions.contiguous()
        v = rays.viewdirs.contiguous()
        z_vals = stratified_z_vals(rays.near, rays.far, s.num_coarse, lindisp=s.lindisp)
        coarse = fused_render(
            coarse_model, o, d, v, z_vals, ray_dists(z_vals, d), **kw
        )
        fine = None
        if fine_model is not None and s.num_fine > 0:
            z_merged, _ = hierarchical_z_vals(
                z_vals, coarse.weights, s.num_fine, det=True
            )
            fine = fused_render(
                fine_model, o, d, v, z_merged, ray_dists(z_merged, d),
                thresholds=s.m_thres_cand, **kw,
            )
        return RenderResult(coarse=coarse, fine=fine)

    return render
