"""Training loop, model set-up and checkpoint loading.

Counterpart of ``dexnerf_tpu/train/loop.py`` for training on a
device-resident ray store (the train views' rays, an offline cache's,
or the camera-frame rays of pose refinement), on one device or data-
parallel over several (``num_devices``, ``parallel/``): ``load_scene`` (blender,
messytable, LLFF with NDC rays),
``maybe_fused_loss`` (kernel 4 at ``train_compute_dtype``, with the depth
term when asked, and kernel 5 between its passes, when ``nerf.use_pallas``),
``maybe_fused_fields`` (kernels 2 and 3 at ``train_compute_dtype`` when
``nerf.pallas_fused_loss`` is false), ``validate`` (through the fused
render kernel; the expected-depth metrics against GT depth, and with
``dex`` the Dex-NeRF σ-threshold sweep), ``run_training`` (with depth
supervision and its warmup, pose refinement, or the active-IR SG shading
of ``render/sg_ir.py``), and what serving needs:
``align_cfg_models_to_checkpoint``, ``load_eval_params`` (reference
``.ckpt`` only), ``setup_models`` and ``fused_render_impl`` (the
counterpart of ``maybe_fused_render_impl``, at the compute dtype of
``render_compute_dtype``). Each of those three selects the kernels one
model at a time by JAX's rules, before any launch: a FlexibleNeRF with
viewdirs takes its kernel, every other model the plain path. Checkpoints
are reference ``.ckpt`` files with the optimizer's state (Adam's and
AdamW's in the layout the JAX package also resumes), the pose twists' and
the SG shading leaves'.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.config.schema import models_from_cfg, render_settings_from_cfg
from dexnerf_tpu_torch.core.metrics import (
    compute_err_metric,
    depth_error_img,
    luminance,
    mse2psnr,
    ssim,
)
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c
from dexnerf_tpu_torch.data.blender import load_blender_data, load_blender_depths
from dexnerf_tpu_torch.data.llff import load_llff_data, load_llff_depths
from dexnerf_tpu_torch.data.messytable import load_messytable_data
from dexnerf_tpu_torch.data.pipeline import (
    build_ray_store,
    build_ray_store_from_cache,
    with_full_intervals,
)
from dexnerf_tpu_torch.models.mlp import COMPUTE_DTYPES, skip_positions
from dexnerf_tpu_torch.ops.fused_mlp import make_fused_flexible_field
from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
from dexnerf_tpu_torch.ops.fused_render import fusable, fusable_pair, make_fused_render_rays
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.render.occupancy import build_occupancy_grid, tighten_store_intervals
from dexnerf_tpu_torch.render.renderer import RenderSettings, make_mlp_field, render_image
from dexnerf_tpu_torch.render.sg_ir import init_sg_ir_params, make_sg_ir_loss
from dexnerf_tpu_torch.train.checkpoints import (
    has_viewdir_head,
    infer_flexible_arch,
    load_optimizer_checkpoint,
    load_pose_checkpoint,
    load_sg_checkpoint,
    optimizer_checkpoint,
    parse_reference_checkpoint,
    pose_checkpoint,
    read_reference_checkpoint,
    reference_checkpoint,
    sg_checkpoint,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.logging import MetricsLogger, save_depth_png_mm
from dexnerf_tpu_torch.train.pose_opt import (
    build_pose_ray_store,
    init_pose_state,
    pose_ray_source,
    refined_c2w,
)
from dexnerf_tpu_torch.train.step import init_train_state, make_train_step


def _get(node, key, default):
    try:
        return node[key]
    except (KeyError, TypeError):
        return default


def align_cfg_models_to_checkpoint(cfg: CfgNode, imported: Dict) -> CfgNode:
    """Reconcile ``cfg.models.*`` with a checkpoint's actual FlexibleNeRF
    architecture (in place; returns ``cfg``), warning when it changes. A
    checkpoint whose heads disagree with ``nerf.use_viewdirs`` (``fc_out``
    without viewdirs) raises, as loading it in JAX does. Other families'
    blocks are taken as written."""
    was_frozen = cfg.is_frozen()
    changed = []
    use_vd = bool(_get(cfg.nerf, "use_viewdirs", True))
    for name in ("coarse", "fine"):
        sd = imported.get(name)
        blk = _get(cfg.models, name, None)
        if sd is None or blk is None:
            continue
        if str(_get(blk, "type", "FlexibleNeRFModel")) != "FlexibleNeRFModel":
            continue
        if has_viewdir_head(sd) != use_vd:
            raise ValueError(
                f"models.{name}: the checkpoint's FlexibleNeRF was trained "
                f"{'with' if has_viewdir_head(sd) else 'without'} viewdirs, the config has "
                f"nerf.use_viewdirs: {use_vd}"
            )
        arch = infer_flexible_arch(sd)
        cfg_layers = int(_get(blk, "num_layers", 4))
        cfg_hidden = int(_get(blk, "hidden_size", 128))
        cfg_skip = int(_get(blk, "skip_connect_every", 4))
        same = (
            cfg_layers == arch["num_layers"]
            and cfg_hidden == arch["hidden_size"]
            and skip_positions(cfg_layers - 1, cfg_skip)
            == skip_positions(arch["num_layers"] - 1, arch["skip_connect_every"])
        )
        if same:
            continue
        if cfg.is_frozen():
            cfg.defrost()
        for k, v in arch.items():
            setattr(blk, k, int(v))
        changed.append(
            f"models.{name}: {cfg_layers}x{cfg_hidden} (skip {cfg_skip}) "
            f"-> {arch['num_layers']}x{arch['hidden_size']} "
            f"(skip {arch['skip_connect_every']})"
        )
    if changed:
        warnings.warn(
            "checkpoint architecture overrides the config (the reference "
            "ignores these config knobs): " + "; ".join(changed),
            stacklevel=2,
        )
        if was_frozen:
            cfg.freeze()
    return cfg


def load_eval_params(cfg: CfgNode, checkpoint: str):
    """Load inference weights from a reference ``.ckpt``.

    Returns ``(cfg, state_dicts, hwf, imported)``: the config with its
    model blocks aligned to the weights, ``{"coarse": sd[, "fine": sd]}``,
    ``(H, W, focal)`` when the checkpoint carries frame geometry else
    None, and the raw import dict.
    """
    if not str(checkpoint).endswith(".ckpt"):
        raise ValueError(
            f"{checkpoint}: this package reads reference .ckpt files; turn "
            "an orbax checkpoint into one with `python -m dexnerf_tpu.apps.export`"
        )
    imported = read_reference_checkpoint(checkpoint)
    cfg = align_cfg_models_to_checkpoint(cfg, imported)
    sds = {"coarse": imported["coarse"]}
    if imported["fine"] is not None:
        sds["fine"] = imported["fine"]
    hwf = None
    if all(imported.get(k) is not None for k in ("height", "width", "focal_length")):
        hwf = (
            int(imported["height"]),
            int(imported["width"]),
            float(imported["focal_length"]),
        )
    return cfg, sds, hwf, imported


def setup_models(cfg: CfgNode, seed: int, device):
    """(coarse, fine_or_None) models from the config, initialized from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    coarse, fine = models_from_cfg(cfg)
    coarse = coarse.reset_parameters(gen).to(device).eval()
    if fine is not None:
        fine = fine.reset_parameters(gen).to(device).eval()
    return coarse, fine


def render_compute_dtype(cfg: CfgNode, device) -> torch.dtype:
    """The fused render's compute dtype on ``device``, resolved as the JAX
    package's ``maybe_fused_render_impl`` does. On a CUDA device (the
    TPU's side in JAX) it is ``nerf.pallas_compute_dtype``, default
    "bfloat16". On the CPU, where JAX renders through XLA in f32 unless
    ``nerf.use_fused_render`` is set, it is float32, or the key's dtype
    when ``nerf.use_fused_render: true`` (JAX's interpret-mode kernel). A
    value other than "bfloat16" or "float32" raises."""
    dtype = train_compute_dtype(cfg)
    device = torch.device(device)
    if device.type == "cpu" and not bool(_get(cfg.nerf, "use_fused_render", False)):
        return torch.float32
    return dtype


def train_compute_dtype(cfg: CfgNode) -> torch.dtype:
    """The ``compute_dtype`` and ``dw_dtype`` of the training kernels (the
    fused train loss, kernel 4; the fields, kernels 2 and 3), resolved as
    the JAX package's ``maybe_fused_loss`` and ``maybe_fused_fields`` do,
    on every device: ``nerf.pallas_compute_dtype``, default "bfloat16" (on
    the CPU JAX runs its kernels at that dtype in interpret mode; the port
    runs the plain versions at it). A value other than "bfloat16" or
    "float32" raises."""
    name = str(_get(cfg.nerf, "pallas_compute_dtype", "bfloat16"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(
            f"nerf.pallas_compute_dtype {name!r}: expected one of {sorted(COMPUTE_DTYPES)}"
        )
    return COMPUTE_DTYPES[name]


def fused_render_impl(
    cfg: CfgNode,
    settings: RenderSettings,
    device,
    coarse,
    fine=None,
):
    """The fused PE->MLP->compositing ``rays_impl`` for ``render_image``
    (the counterpart of ``maybe_fused_render_impl``; the models carry the
    weights here) at :func:`render_compute_dtype`. On a CUDA ``device``
    every pass launches the kernel of that dtype (bf16 tensor cores by
    default, f32 with ``nerf.pallas_compute_dtype: float32``); on the CPU
    it runs the kernels' plain PyTorch version. It returns None, and
    ``render_image`` then renders through the plain ``render_rays``, where
    JAX's ``maybe_fused_render_impl`` does: with ``nerf.use_fused_render:
    false``, when the coarse model is not a FlexibleNeRF with viewdirs, or
    the fine model not a FlexibleNeRF; and on the CPU, where JAX renders
    through XLA unless ``nerf.use_fused_render`` is set, when a model's own
    compute dtype is not f32."""
    flag = _get(cfg.nerf, "use_fused_render", None)
    if flag is not None and not bool(flag):
        return None
    if not fusable_pair(coarse, fine):
        return None
    device = torch.device(device)
    if device.type == "cpu" and flag is None and any(
            m.compute_dtype != torch.float32 for m in (coarse, fine) if m is not None):
        # JAX renders through XLA here, at the models' own compute dtype
        # (models.*.compute_dtype), which the f32 plain kernel is not
        return None
    compute_dtype = render_compute_dtype(cfg, device)
    # the kernel reads the weights where they live: keep them on the card
    for model in (coarse, fine):
        if model is not None and next(model.parameters()).device.type != device.type:
            raise ValueError(f"models must live on {device} to render there")
    return make_fused_render_rays(coarse, fine, settings, compute_dtype=compute_dtype)


@dataclass
class SceneData:
    """A loaded scene: images [N, H, W, 3], poses [N, 4, 4] (c2w, or w2c
    when ``intrinsics`` [N, 3, 3] is given: messytable), [H, W, focal] and
    the split indices; ``use_ndc`` renders its rays in NDC (LLFF)."""

    images: np.ndarray
    poses: np.ndarray
    hwf: list
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: Optional[np.ndarray] = None
    depths: Optional[np.ndarray] = None  # [N, H, W] GT depth (meters)
    render_poses: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None
    use_ndc: bool = False


def load_scene(cfg: CfgNode) -> SceneData:
    """Load the blender, messytable or LLFF dataset named by
    ``cfg.dataset``. An LLFF scene holds out every ``dataset.llffhold``-th
    view (default 8; 0 holds out the loader's ``i_test``) as both its
    validation and test split, carries the ``depths/d_<k>.npy`` sidecars
    when all are there, and uses NDC rays unless ``dataset.no_ndc`` (whose
    default is true, as in the JAX package)."""
    ds = cfg.dataset
    kind = str(ds.type).lower()
    kw = dict(
        half_res=bool(_get(ds, "half_res", False)),
        testskip=int(_get(ds, "testskip", 1)),
        debug=bool(_get(ds, "debug", False)),
    )
    if kind == "messytable":
        images, poses, render_poses, hwf, i_split, intrinsics, depths = load_messytable_data(
            ds.basedir, **kw,
            imgname=str(_get(ds, "imgname", "0128_irL_kuafu_half.png")),
            is_real_rgb=bool(_get(ds, "is_real_rgb", False)),
        )
        return SceneData(
            images=images, poses=poses, hwf=hwf, i_train=i_split[0], i_val=i_split[1],
            i_test=i_split[2], depths=depths, render_poses=render_poses,
            intrinsics=intrinsics,
        )
    if kind == "llff":
        images, poses, _, render_poses, i_test = load_llff_data(
            ds.basedir,
            factor=int(_get(ds, "downsample_factor", 8)),
            spherify=bool(_get(ds, "spherify", False)),
            path_zflat=bool(_get(ds, "path_zflat", False)),
        )
        hwf = poses[0, :3, -1]
        n = images.shape[0]
        poses44 = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        poses44[:, :3, :4] = poses[:, :3, :4]
        llffhold = int(_get(ds, "llffhold", 8))
        i_val = np.arange(n)[::llffhold] if llffhold > 0 else np.array([i_test])
        held = set(i_val.tolist())
        return SceneData(
            images=images, poses=poses44, hwf=[int(hwf[0]), int(hwf[1]), float(hwf[2])],
            i_train=np.array([i for i in range(n) if i not in held]), i_val=i_val,
            i_test=i_val, depths=load_llff_depths(ds.basedir, n), render_poses=render_poses,
            use_ndc=not bool(_get(ds, "no_ndc", True)),
        )
    if kind != "blender":
        raise ValueError(f"unknown dataset type: {ds.type}")
    images, poses, render_poses, hwf, i_split = load_blender_data(ds.basedir, **kw)
    return SceneData(
        images=images[..., :3],
        poses=poses,
        hwf=hwf,
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        depths=load_blender_depths(ds.basedir, **kw),
        render_poses=render_poses,
    )


def maybe_fused_fields(cfg: CfgNode, coarse, fine, *, train: bool = False):
    """(coarse_field, fine_field) over ``coarse``/``fine`` when
    ``cfg.nerf.use_pallas`` is set, else (None, None) (the plain encode +
    model call). As in JAX, each model gets a field only when it is a
    FlexibleNeRF with viewdirs (None, its pass plain, otherwise), and
    ``nerf.use_viewdirs: false`` warns and gives (None, None).
    ``train=True`` gives the autograd fields of
    ``ops.fused_mlp_train`` (kernel 2 forward, kernel 3 backward on a
    card), else the forward-only fields of ``ops.fused_mlp`` (kernel 2).
    Their ``compute_dtype`` (and kernel 3's ``dw_dtype``) is
    :func:`train_compute_dtype` on every device, as the JAX package's
    ``maybe_fused_fields`` resolves it: on a card the bf16 tensor-core
    kernels by default, the f32 ones with ``nerf.pallas_compute_dtype:
    float32``; on the CPU the plain versions at that dtype.
    The JAX package's block sizes are TPU knobs: the port's kernels pick
    their own blocks."""
    if not bool(_get(cfg.nerf, "use_pallas", False)):
        return None, None
    if not bool(_get(cfg.nerf, "use_viewdirs", True)):
        # JAX's words (dexnerf_tpu/train/loop.py:192-201)
        warnings.warn(
            "cfg.nerf.use_pallas is set but use_viewdirs is false; the "
            "fused Pallas kernels require viewdirs — using the XLA path",
            stacklevel=2,
        )
        return None, None
    dtype = train_compute_dtype(cfg)
    s = render_settings_from_cfg(cfg, "train")
    kw = dict(log_sampling_xyz=s.log_sampling_xyz, log_sampling_dir=s.log_sampling_dir,
              compute_dtype=dtype)
    if train:
        make, kw["dw_dtype"] = make_fused_flexible_field_train, dtype
    else:
        make = make_fused_flexible_field
    return tuple(make(m, **kw) if fusable(m) else None for m in (coarse, fine))


def maybe_fused_loss(
    cfg: CfgNode,
    settings: RenderSettings,
    supervision: str,
    coarse,
    fine,
    depth_loss_weight: float = 0.0,
    depth_valid_max: Optional[float] = None,
):
    """The fused train loss over ``coarse``/``fine`` (kernel 4 on a card)
    when ``cfg.nerf.use_pallas`` is set, ``nerf.pallas_fused_loss`` is not
    false, the coarse model is a FlexibleNeRF with viewdirs, the fine one
    (if any) a FlexibleNeRF and ``settings.use_viewdirs`` holds, else None
    (then the fused fields, or the plain autograd render, the counterpart
    of the JAX package's XLA path), as JAX's ``maybe_fused_loss``. With
    ``depth_loss_weight`` > 0 the kernel adds the depth term over
    ``0 < gt [< depth_valid_max]``.
    ``nerf.pallas_loss_resample`` ("auto" | "xla" | "pallas") selects the
    resample between the passes (kernel 5 for "pallas"). Both dtypes of
    kernel 4 are :func:`train_compute_dtype` (bf16 by default, as in JAX):
    on a card the bf16 tensor-core kernel, or the f32 one with
    ``nerf.pallas_compute_dtype: float32``; on the CPU the plain version
    at that dtype."""
    if not bool(_get(cfg.nerf, "use_pallas", False)):
        return None
    if not bool(_get(cfg.nerf, "pallas_fused_loss", True)):
        return None
    if not fusable_pair(coarse, fine):
        return None
    if not settings.use_viewdirs:
        return None
    dtype = train_compute_dtype(cfg)
    return make_fused_train_loss(
        coarse, fine, settings, supervision=supervision,
        resample=str(_get(cfg.nerf, "pallas_loss_resample", "auto")),
        compute_dtype=dtype, dw_dtype=dtype,
        depth_loss_weight=float(depth_loss_weight), depth_valid_max=depth_valid_max,
    )


def validate(
    coarse,
    fine,
    scene: SceneData,
    cfg: CfgNode,
    *,
    supervision: str,
    device,
    dex: bool = False,
    val_idx: Optional[int] = None,
    mesh=None,
) -> Dict[str, Any]:
    """Render one validation view through the fused render kernel (its
    plain version on the CPU) and score it: coarse/fine loss, PSNR of their
    sum and SSIM of the fine image (``train_nerf_rgb.py:304-425``); the
    loss is the luminance MSE for ``supervision`` "luminance" and "sg_ir"
    (whose shaded frame is an analysis view, not a validation metric, as
    in JAX). With ``mesh`` (``parallel.mesh.Mesh``) every rank renders its
    share of the frame through the plain render and gets the whole frame
    (``parallel.sharding.render_image_parallel``, JAX's tiled frame). The
    rays are w2c + K when the scene has intrinsics, and in NDC when it
    uses NDC; then its depths are NDC ray parameters and no depth metric is
    computed (``apps.eval --test-set`` scores them through
    ``ndc_t_to_world_depth``). On a view with GT depth
    the expected depth is scored over ``0 < gt < dataset.depth_valid_max``
    (default 1.25 m; ``compute_err_metric``); with ``dex`` the fine pass
    also gives the σ-threshold depths of the validation grid
    (``depth_dex`` [T, H, W]), each scored the same way, and the threshold
    of least abs error is kept (``train_dexnerf_rgb.py:363-428``)."""
    device = torch.device(device)
    s_val = render_settings_from_cfg(cfg, "validation", dex=dex).eval_variant()
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    idx = int(scene.i_val[0]) if val_idx is None else int(val_idx)
    pose = torch.as_tensor(np.asarray(scene.poses[idx], np.float32), device=device)
    if scene.intrinsics is not None:
        K = torch.as_tensor(np.asarray(scene.intrinsics[idx], np.float32), device=device)
        ro, rd = get_ray_bundle_w2c(H, W, pose, K)
    else:
        ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
    with torch.no_grad():
        if mesh is not None:
            from dexnerf_tpu_torch.parallel.sharding import render_image_parallel

            out = render_image_parallel(
                mesh, coarse, fine, ro, rd, float(cfg.dataset.near), float(cfg.dataset.far),
                s_val, use_ndc=scene.use_ndc, height=H, width=W, focal_length=focal,
            )
        else:
            out = render_image(
                coarse, fine, ro, rd, float(cfg.dataset.near), float(cfg.dataset.far), s_val,
                rays_impl=fused_render_impl(cfg, s_val, device, coarse, fine),
                use_ndc=scene.use_ndc, height=H, width=W, focal_length=focal,
            )
        target = torch.as_tensor(np.asarray(scene.images[idx][..., :3], np.float32), device=device)

        def mse(rgb):
            if supervision in ("luminance", "sg_ir"):
                return float(torch.mean((luminance(rgb) - luminance(target)) ** 2))
            return float(torch.mean((rgb - target) ** 2))

        r = out.fine if out.fine is not None else out.coarse
        coarse_mse = mse(out.coarse.rgb)
        fine_mse = mse(out.fine.rgb) if out.fine is not None else 0.0
        total = coarse_mse + fine_mse
        metrics: Dict[str, Any] = {
            "loss": total,
            "coarse_loss": coarse_mse,
            "fine_loss": fine_mse,
            "psnr": mse2psnr(total),
            "ssim": float(ssim(r.rgb, target)),
            "rgb": r.rgb.cpu().numpy(),
            "rgb_coarse": out.coarse.rgb.cpu().numpy(),
            "depth": r.depth.cpu().numpy(),
            "target": target.cpu().numpy(),
            "index": idx,
        }
    if dex and r.depth_dex is not None:
        metrics["depth_dex"] = r.depth_dex.cpu().numpy()  # [T, H, W]
        metrics["m_thres_cand"] = tuple(s_val.m_thres_cand)
    if scene.depths is None or scene.use_ndc:
        return metrics
    gt = np.asarray(scene.depths[idx])
    mask = (gt > 0) & (gt < float(_get(cfg.dataset, "depth_valid_max", 1.25)))
    metrics["depth_gt"], metrics["depth_mask"] = gt, mask
    if not np.any(gt > 0):
        # a view without GT depth (zero-filled): skipped, not scored as NaN
        return metrics
    metrics.update(compute_err_metric(gt, metrics["depth"], mask))
    if "depth_dex" in metrics:
        errs = [compute_err_metric(gt, d, mask) for d in metrics["depth_dex"]]
        abs_errs = [e["depth_abs_err"] for e in errs]
        best = int(np.argmin(abs_errs))
        metrics.update(
            dex_errors=errs,
            best_threshold_index=best,
            best_threshold=float(s_val.m_thres_cand[best]),
            min_abs_err=float(abs_errs[best]),
            best_depth=metrics["depth_dex"][best],
            err4=errs[best]["depth_err4"],
        )
    return metrics


def _normalize_img(x: np.ndarray) -> np.ndarray:
    """Min-max normalized to [0, 1], as the reference shows depth images
    (``vutils.make_grid(..., normalize=True, scale_each=True)``)."""
    x = np.asarray(x, np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / max(hi - lo, 1e-12)


def _log_validation(logger: MetricsLogger, val: Dict[str, Any], step: int, logdir: str) -> None:
    """The reference's validation artifacts (``train_dexnerf_rgb.py:375-428``):
    the scalars ``validation/{loss,coarse_loss,fine_loss,psnr,ssim}`` and,
    where computed, ``validation/{depth_abs_err,depth_err4,min_abs_err,err4}``;
    the images ``validation/{rgb_coarse,rgb_fine,img_target}``, with Dex
    ``validation/depth_pred_<m>`` per threshold, and with GT depth
    ``validation/depth_gt`` and ``validation/depth_pred_err``; with GT depth
    the best depth (the expected depth where no threshold was scored) as a
    millimeter PNG ``<logdir>/pred_depth/pred_depth_step_<step>.png``."""
    for k in ("loss", "coarse_loss", "fine_loss", "psnr", "ssim"):
        logger.scalar(f"validation/{k}", val[k], step)
    for k in ("depth_abs_err", "depth_err4", "min_abs_err", "err4"):
        if k in val:
            logger.scalar(f"validation/{k}", float(val[k]), step)
    logger.image("validation/rgb_coarse", np.clip(val["rgb_coarse"], 0, 1), step)
    logger.image("validation/rgb_fine", np.clip(val["rgb"], 0, 1), step)
    logger.image("validation/img_target", np.clip(val["target"], 0, 1), step)
    if "depth_gt" in val:
        logger.image("validation/depth_gt", _normalize_img(val["depth_gt"]), step)
    for t, m in enumerate(val.get("m_thres_cand", ()) if "depth_dex" in val else ()):
        logger.image(f"validation/depth_pred_{int(m)}", _normalize_img(val["depth_dex"][t]), step)
    if "depth_gt" not in val:
        return
    best_depth = val.get("best_depth", val["depth"])
    err_img = depth_error_img(
        np.asarray(best_depth)[None] * 1000.0,
        np.asarray(val["depth_gt"])[None] * 1000.0,
        np.asarray(val["depth_mask"])[None],
    )
    logger.image("validation/depth_pred_err", err_img, step)
    pred_dir = os.path.join(logdir, "pred_depth")
    os.makedirs(pred_dir, exist_ok=True)
    save_depth_png_mm(os.path.join(pred_dir, f"pred_depth_step_{step}.png"), best_depth)


_CKPT = re.compile(r"checkpoint_(\d+)\.ckpt$")


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``checkpoint_<iteration>.ckpt`` in ``directory`` with the highest
    iteration, or None."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(directory) if (m := _CKPT.search(f))]
    return os.path.join(directory, max(found)[1]) if found else None


def build_train_state(cfg: CfgNode, seed: int, device, *, imported: Optional[Dict] = None,
                      supervision: str = "rgb", pose_opt: bool = False, num_train: int = 0):
    """The seeded models, their optimizer and schedule (``cfg.optimizer``,
    ``cfg.scheduler``), with ``supervision="sg_ir"`` the SG shading leaves
    (``nerf.train.sg_env_lobes`` lobes, default 2, drawn from a generator
    seeded with ``seed + 7``, where JAX folds 7 into the seed's key) as a
    group of the same optimizer, with ``pose_opt`` the twists of
    ``num_train`` views under their own Adam; then a checkpoint's weights
    and states (``imported``, :func:`read_reference_checkpoint`'s) put in."""
    coarse, fine = setup_models(cfg, seed, device)
    sg = None
    if supervision == "sg_ir":
        sg = init_sg_ir_params(torch.Generator().manual_seed(int(seed) + 7),
                               int(_get(cfg.nerf.train, "sg_env_lobes", 2)), device)
    state = init_train_state(
        coarse, fine, float(cfg.optimizer.lr), float(cfg.scheduler.lr_decay),
        float(cfg.scheduler.lr_decay_factor), opt_type=str(_get(cfg.optimizer, "type", "Adam")),
        sg=sg,
    )
    if imported is not None:
        coarse.load_state_dict(imported["coarse"])
        if fine is not None and imported["fine"] is not None:
            fine.load_state_dict(imported["fine"])
        load_optimizer_checkpoint(state.opt_type, state.optimizer, imported)
        state.step = int(imported["step"])
        if sg is not None:
            # after the models' state: a reference .ckpt keeps the fresh leaves
            load_sg_checkpoint(sg, state.optimizer, state.opt_type, imported)
    if pose_opt:
        state.pose = init_pose_state(
            num_train, float(_get(cfg.optimizer, "pose_lr", 1e-3)),
            float(cfg.scheduler.lr_decay), float(cfg.scheduler.lr_decay_factor), device)
        if imported is not None:
            load_pose_checkpoint(state.pose, imported)
    return state


def _checkpoint_of(state, lr: float, metrics: Dict[str, Any]) -> Dict:
    """The :func:`reference_checkpoint` (or :func:`write_reference_checkpoint`)
    keywords of ``state`` after its last update."""
    return dict(
        coarse=state.coarse.state_dict(),
        fine=state.fine.state_dict() if state.fine is not None else None,
        step=state.step,
        **optimizer_checkpoint(state.opt_type, state.optimizer, state.step, lr),
        pose_state=pose_checkpoint(state.pose) if state.pose is not None else None,
        sg_state=sg_checkpoint(state.sg, state.optimizer) if state.sg is not None else None,
        loss=float(metrics["loss"]),
        psnr=float(metrics["psnr"]),
    )


def _train_rank(mesh, cfg_yaml: str, kwargs: Dict[str, Any]):
    """One rank of a data-parallel :func:`run_training` (run by
    ``parallel.mesh.spawn_ranks``): rank 0 returns its summary, with the
    last state as a ``.ckpt`` dict under ``"checkpoint"``; the others None."""
    import yaml

    out = run_training(CfgNode(yaml.safe_load(cfg_yaml)), mesh=mesh, device=mesh.device,
                       **kwargs)
    if not mesh.is_primary:
        return None
    state = out.pop("state")
    out.pop("scene")
    out["checkpoint"] = reference_checkpoint(**_checkpoint_of(
        state, float(state.schedule(0)), out["final_train_metrics"] or {"loss": 0.0, "psnr": 0.0}))
    return out


def _host_source(cfg, scene, train_views, intrinsics, depth_w: float, device) -> Dict[str, Any]:
    """The host-streamed store's host arrays (``data/host_store.py``):
    ``dataset.host_wire`` "packed" (the u8 rgb, the pose tables and the f32
    depth with a depth term) or "rows" (the store's f32 rows, built one
    image at a time on ``device``, and the depth)."""
    from dexnerf_tpu_torch.data import host_store as hs

    images, poses, hwf = train_views[:3]
    depths = scene.depths[scene.i_train] if depth_w > 0.0 else None
    wire = str(_get(cfg.dataset, "host_wire", "packed"))
    if wire == "packed":
        return {"wire": wire, "rgb": hs.images_to_u8(images),
                "tables": hs.build_pose_tables(poses, hwf, intrinsics=intrinsics,
                                               use_ndc=scene.use_ndc),
                "depth": None if depths is None else np.asarray(depths, np.float32).reshape(-1)}
    if wire == "rows":
        rows, depth = hs.build_host_ray_rows(images, poses, hwf, device=device,
                                             intrinsics=intrinsics, use_ndc=scene.use_ndc,
                                             depths=depths)
        return {"wire": wire, "rows": rows, "depth": depth}
    raise ValueError(f"dataset.host_wire must be 'packed' or 'rows', got {wire!r}")  # JAX's


def _host_train_step(host: Dict[str, Any], cfg, s_train: RenderSettings, batch_size: int,
                     seed: int, device, train_kw: Dict[str, Any]):
    """``(train_step(state, store, generator) -> metrics, loader)`` of the
    host-streamed store: each of the call's ``steps_per_call`` updates takes
    the loader's next batch (the indices of ``default_rng(seed)``, JAX's
    stream) through ``make_batch_train_step``, its render draws from
    ``generator``."""
    from dexnerf_tpu_torch.data import host_store as hs
    from dexnerf_tpu_torch.train.step import make_batch_train_step

    kw = {k: v for k, v in train_kw.items() if k not in ("sampling", "steps_per_call")}
    steps = int(train_kw["steps_per_call"])
    prefetch = int(_get(cfg.dataset, "host_prefetch", 2) or 2)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    if host["wire"] == "packed":
        loader = hs.HostPixelLoader(host["rgb"], batch_size, seed, depth=host["depth"],
                                    prefetch=prefetch, device=device)
        step = make_batch_train_step(s_train, unpack=hs.make_ray_unpack(host["tables"], near, far),
                                     **kw)

        def one(state, generator):
            return step(state, next(loader), generator)
    else:
        loader = hs.HostRayLoader(host["rows"], near, far, batch_size, seed,
                                  depth=host["depth"], prefetch=prefetch, device=device)
        step = make_batch_train_step(s_train, **kw)

        def one(state, generator):
            batch = next(loader)
            return step(state, batch[0], batch[1], generator, None, *batch[2:])

    def train_step(state, _store, generator):
        metrics = {}
        for _ in range(steps):
            metrics = one(state, generator)
        return metrics

    return train_step, loader


def run_training(
    cfg: CfgNode,
    *,
    dex: bool = False,
    supervision: str = "rgb",
    scene: Optional[SceneData] = None,
    load_ckpt: Optional[str] = None,
    auto_resume: bool = False,
    max_iters: Optional[int] = None,
    logdir: Optional[str] = None,
    sampling: Optional[str] = None,
    steps_per_call: Optional[int] = None,
    depth_loss_weight: Optional[float] = None,
    depth_warmup: Optional[int] = None,
    occupancy: Optional[float] = None,
    pose_opt: Optional[bool] = None,
    num_devices: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> Dict[str, Any]:
    """Train a NeRF per ``cfg``; returns a summary dict.

    ``device`` is the card unless the caller asks for the CPU. ``scene``
    may be injected, else it is loaded from ``cfg.dataset``.
    ``max_iters`` overrides ``cfg.experiment.train_iters``; ``sampling``
    ("uniform" | "per_image") and ``steps_per_call`` override
    ``cfg.nerf.train``. ``load_ckpt`` is a reference ``.ckpt`` (models,
    Adam moments, iteration) or a directory of ``checkpoint_<i>.ckpt``
    (the latest is taken); ``auto_resume`` resumes from
    ``<logdir>/checkpoints`` when it holds one. Metrics go to
    ``<logdir>/metrics.jsonl``; checkpoints to
    ``<logdir>/checkpoints/checkpoint_<iteration>.ckpt``, whose ``iter``
    is the number of updates taken (where a resume starts).

    ``supervision`` is "rgb", "luminance" (``--ir``) or "sg_ir": the
    active-IR SG shading of ``render/sg_ir.py``, whose shading leaves train
    in the fields' optimizer (``nerf.train.sg_env_lobes``, default 2;
    ``nerf.train.sg_distance_falloff``, default true), through the plain
    render (the kernels give no point gradients; validation still renders
    through kernel 1, scored by luminance); the ``.ckpt`` holds the leaves
    under ``checkpoints.SG_KEY``, and a reference ``.ckpt`` without them
    keeps the fresh leaves. Not with pose refinement nor a depth term.

    ``dex`` validates with the σ-threshold sweep (:func:`validate`).
    ``depth_loss_weight`` (else ``nerf.train.depth_loss_weight``) > 0 adds
    GT-depth supervision of the expected depth over ``0 < gt [<
    depth_valid_max]``, the limit from ``nerf.train.depth_valid_max``, else
    ``dataset.depth_valid_max``, else none. ``depth_warmup`` (else
    ``nerf.train.depth_warmup``) N > 0 runs the first N iterations without
    the depth term; -1 waits until the train PSNR at print cadence passes
    ``nerf.train.depth_warmup_psnr`` (default 14 dB), logs
    ``train/depth_on_step`` and returns ``depth_on_step``.

    ``occupancy`` (else ``nerf.train.occupancy``) > 0 trains occupancy-
    guided: a σ > threshold grid is baked from the in-progress field (the
    fine one when there is one) at ``nerf.train.occupancy_start_iter`` and
    every ``occupancy_rebake_every`` iterations after, and every stored
    ray's ``[near, far]`` is tightened to its occupied span (misses keep the
    full interval; ``render/occupancy.py``), logging ``train/occ_fraction``
    and ``train/occ_interval_shrink``. World-space scenes and the
    device-resident store only, and not with pose refinement.

    ``pose_opt`` (else ``nerf.train.pose_opt``) refines the train views'
    camera poses: a zero-initialized SE(3) twist per view trains with the
    fields under its own Adam at ``optimizer.pose_lr`` (default 1e-3) and
    the model's decay (``train/pose_opt.py``), through the plain render
    (the kernels give no ray gradients), logging ``train/pose_twist_norm``;
    the summary gains ``refined_poses`` [n_train, 4, 4] (c2w). Not with
    depth supervision, occupancy or a ray cache (ignored).

    ``num_devices`` N > 1 trains data-parallel: N ranks, one a device
    (``cuda:0``..``cuda:N-1`` over NCCL, or N CPU processes over gloo),
    spawned on a free 127.0.0.1 port (``parallel.mesh.spawn_ranks``), each
    running this function with its ``mesh``: the global batch
    ``nerf.train.num_random_rays`` split over the ranks, the gradients
    averaged (``parallel.sharding.make_parallel_train_step``, kernel 4 or
    kernels 2-3 on every rank as on one device; the pose step with
    ``pose_opt``), validation tiled over the ranks through the plain
    render; rank 0 alone logs and writes checkpoints. The returned state
    holds rank 0's last checkpoint, on the CPU. More ranks than devices, a
    depth warmup or the host store raise JAX's words.

    The store is, in JAX's order of precedence: the pose store; the
    host-streamed store (``dataset.host_store``, ``data/host_store.py``:
    the rays stay in host memory and a loader thread ships each step's
    batch, ``dataset.host_prefetch`` (default 2) batches ahead, on
    ``dataset.host_wire`` "packed" (default: int32 indices and u8 rgb, the
    rays rebuilt on the device from a pose table) or "rows" (the store's f32
    rows); uniform sampling only, no depth warmup; the render draws from the
    run's generator); the offline ray cache of ``apps/cache.py`` when
    ``dataset.cachedir/train`` exists and no depth term is asked for
    (``build_ray_store_from_cache``); else the resident store of the train
    views."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device cuda: no CUDA card is visible to PyTorch")
    parallel = mesh is not None or (num_devices is not None and num_devices > 1)
    primary = mesh is None or mesh.is_primary
    depth_w = float(
        depth_loss_weight if depth_loss_weight is not None
        else (_get(cfg.nerf.train, "depth_loss_weight", 0.0) or 0.0)
    )
    occ_sigma = float(
        occupancy if occupancy is not None
        else (_get(cfg.nerf.train, "occupancy", 0.0) or 0.0)
    )
    pose_opt = bool(_get(cfg.nerf.train, "pose_opt", False) if pose_opt is None else pose_opt)
    sg_ir = supervision == "sg_ir"
    if pose_opt and sg_ir:
        raise NotImplementedError("pose_opt + sg_ir is not supported")  # JAX's words
    if occ_sigma > 0.0:
        if pose_opt:
            raise ValueError(
                "occupancy-guided training and pose refinement are mutually exclusive (the "
                "pose store holds camera-frame rays whose world-space intervals move with "
                "the poses)"
            )
        if _get(cfg.dataset, "host_store", False):
            raise ValueError(
                "occupancy-guided training needs the device-resident ray store "
                "(dataset.host_store: false)"
            )
    seed = int(_get(cfg.experiment, "randomseed", 42))
    logdir = logdir or os.path.join(str(cfg.experiment.logdir), str(cfg.experiment.id))
    ckpt_dir = os.path.join(logdir, "checkpoints")
    if load_ckpt and os.path.isdir(load_ckpt):
        load_ckpt = latest_checkpoint(load_ckpt)
    elif not load_ckpt and auto_resume:
        load_ckpt = latest_checkpoint(ckpt_dir)
    imported = None
    if load_ckpt:
        if not str(load_ckpt).endswith(".ckpt"):
            raise ValueError(
                f"{load_ckpt}: this package resumes reference .ckpt files; turn an "
                "orbax checkpoint into one with `python -m dexnerf_tpu.apps.export`"
            )
        imported = read_reference_checkpoint(load_ckpt)
        cfg = align_cfg_models_to_checkpoint(cfg, imported)
    if scene is None:
        scene = load_scene(cfg)

    dvm = _get(cfg.nerf.train, "depth_valid_max", None)
    if dvm is None:
        dvm = _get(cfg.dataset, "depth_valid_max", None)
    depth_valid_max = float(dvm) if dvm is not None else None
    depth_warmup_iters = int(
        depth_warmup if depth_warmup is not None
        else (_get(cfg.nerf.train, "depth_warmup", 0) or 0)
    ) if depth_w > 0.0 else 0
    warmup_auto = depth_warmup_iters < 0
    warmup_psnr = float(_get(cfg.nerf.train, "depth_warmup_psnr", 14.0) or 14.0)
    if depth_w > 0.0 and pose_opt:
        raise ValueError("depth supervision and --pose-opt are mutually exclusive")
    if depth_w > 0.0 and sg_ir:
        raise ValueError("depth supervision and --sg-ir are mutually exclusive")  # JAX's words
    if depth_w > 0.0 and scene.depths is None:
        raise ValueError(
            "depth_loss_weight > 0 but the dataset has no GT depth maps (messytable "
            "carries depthL.png / depth.png)"
        )
    if depth_w > 0.0 and scene.use_ndc:
        raise ValueError(
            "depth supervision under NDC is unsupported: the render depth is an NDC ray "
            "parameter while depth sidecars are metric ray distance (see "
            "core.rays.ndc_t_to_world_depth)"
        )
    if occ_sigma > 0.0 and scene.use_ndc:
        raise ValueError(
            "occupancy-guided training is world-space; NDC (llff) scenes reparameterize "
            "the frustum — unsupported"
        )
    if parallel and _get(cfg.dataset, "host_store", False):
        # JAX's words (dexnerf_tpu/train/loop.py:1150-1155)
        raise ValueError(
            "dataset.host_store is a single-device data path (keep the store resident for "
            "data-parallel training, or scale scenes with apps.multiscene)"
        )
    if parallel and depth_warmup_iters != 0:
        # JAX's words (dexnerf_tpu/train/loop.py:1414-1425)
        raise ValueError(
            "depth_warmup supports the single-device resident-store path (the distillation "
            "protocol)"
        )
    if parallel and mesh is None:
        from dexnerf_tpu_torch.parallel.mesh import spawn_ranks

        kwargs = dict(dex=dex, supervision=supervision, scene=scene, load_ckpt=load_ckpt,
                      max_iters=max_iters, logdir=logdir, sampling=sampling,
                      steps_per_call=steps_per_call, depth_loss_weight=depth_w,
                      depth_warmup=depth_warmup_iters, occupancy=occ_sigma, pose_opt=pose_opt)
        out = spawn_ranks(_train_rank, int(num_devices), device.type, (cfg.dump(), kwargs))[0]
        checkpoint = parse_reference_checkpoint(out.pop("checkpoint"))
        out["state"] = build_train_state(cfg, seed, "cpu", imported=checkpoint,
                                         supervision=supervision, pose_opt=pose_opt,
                                         num_train=len(scene.i_train))
        out["scene"] = scene
        return out

    os.makedirs(logdir, exist_ok=True)
    if primary:
        with open(os.path.join(logdir, "config.yml"), "w") as f:
            f.write(cfg.dump())
    state = build_train_state(cfg, seed, device, imported=imported, supervision=supervision,
                              pose_opt=pose_opt, num_train=len(scene.i_train))
    coarse, fine = state.coarse, state.fine
    lr = float(cfg.optimizer.lr)
    start_iter = state.step

    s_train = render_settings_from_cfg(cfg, "train")
    batch_size = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    cachedir = str(_get(cfg.dataset, "cachedir", "") or "")
    train_views = (scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf, near, far)
    intrinsics = None if scene.intrinsics is None else scene.intrinsics[scene.i_train]
    host = None  # the host-streamed store's wire, host arrays and tables
    if pose_opt:
        # camera-frame rays, turned into world rays by the refined poses in
        # each step (a cache's world rays have no image to refine)
        store = build_pose_ray_store(*train_views, device=device, intrinsics=intrinsics,
                                     use_ndc=scene.use_ndc)
    elif _get(cfg.dataset, "host_store", False):
        # the rays stay in host memory (JAX's dexnerf_tpu/train/loop.py:1064-1117)
        host = _host_source(cfg, scene, train_views, intrinsics, depth_w, device)
        store = None
    elif cachedir and os.path.isdir(os.path.join(cachedir, "train")) and depth_w == 0.0:
        # the reference's USE_CACHED_DATASET preference (cache shards carry no depth)
        store = build_ray_store_from_cache(cachedir, near, far, device=device)
    else:
        store = build_ray_store(
            *train_views, device=device, intrinsics=intrinsics, use_ndc=scene.use_ndc,
            depths=scene.depths[scene.i_train] if depth_w > 0.0 else None,
        )
    occ_rebake = None
    occ_next = occ_every = 0
    last_occ: Dict[str, float] = {}  # the last bake's occ_fraction and occ_interval_shrink
    if occ_sigma > 0.0:
        t = cfg.nerf.train
        occ_next = int(_get(t, "occupancy_start_iter", 500))
        occ_every = int(_get(t, "occupancy_rebake_every", 1000))
        occ_kw = dict(
            sigma_threshold=occ_sigma,
            resolution=int(_get(t, "occupancy_resolution", 128)),
            radius=float(_get(t, "occupancy_radius", 1.5)),
            center=tuple(float(c) for c in _get(t, "occupancy_center", (0.0,) * 3)),
            dilate=int(_get(t, "occupancy_dilate", 1)),
        )
        occ_probes = int(_get(t, "occupancy_probes", 64))
        # explicit full intervals before the first step, replaced at each bake
        store = with_full_intervals(store)
        occ_field = make_mlp_field(fine if fine is not None else coarse, s_train)

        def occ_rebake():
            grid = build_occupancy_grid(occ_field, device=device, **occ_kw)
            iv = tighten_store_intervals(grid, store.data, store.near, store.far,
                                         num_probes=occ_probes)
            return grid.occupancy_fraction(), iv
    steps_per_call = int(
        steps_per_call if steps_per_call is not None
        else _get(cfg.nerf.train, "steps_per_call", 1)
    )
    if pose_opt:
        if bool(_get(cfg.nerf, "use_pallas", False)):
            # JAX's words (dexnerf_tpu/train/loop.py:1269-1278)
            warnings.warn(
                "pose_opt needs ray-input gradients; the fused Pallas train kernels are "
                "bypassed (XLA path)",
                stacklevel=2,
            )
        fused_loss = None
    elif sg_ir:
        # the shaded loss supersedes every kernel of the step (JAX's order)
        fused_loss = make_sg_ir_loss(
            coarse, fine, state.sg, s_train,
            distance_falloff=bool(_get(cfg.nerf.train, "sg_distance_falloff", True)),
        )
    else:
        fused_loss = maybe_fused_loss(cfg, s_train, supervision, coarse, fine,
                                      depth_loss_weight=depth_w, depth_valid_max=depth_valid_max)
    # the fused loss supersedes the separate field kernels
    coarse_field, fine_field = (
        (None, None) if fused_loss is not None or pose_opt
        else maybe_fused_fields(cfg, coarse, fine, train=True)
    )
    step_kw = dict(
        supervision=supervision,
        coarse_field=coarse_field,
        fine_field=fine_field,
        sampling=sampling or str(_get(cfg.nerf.train, "sampling", "uniform")),
        steps_per_call=steps_per_call,
    )
    train_kw = dict(fused_loss=fused_loss, depth_loss_weight=depth_w,
                    depth_valid_max=depth_valid_max, **step_kw)
    host_loader = None
    if host is not None:
        # sampling and the batch on the host, ahead of the device (JAX's
        # dexnerf_tpu/train/loop.py:1319-1404 and 1416-1424, its words)
        if step_kw["sampling"] != "uniform":
            raise ValueError(
                "dataset.host_store supports uniform sampling only (the loader draws "
                "uniform-over-all-rays batches)"
            )
        if depth_warmup_iters != 0:
            raise ValueError(
                "depth_warmup supports the single-device resident-store path (the "
                "distillation protocol)"
            )
        train_step, host_loader = _host_train_step(host, cfg, s_train, batch_size, seed, device,
                                                   train_kw)
    elif mesh is None:
        train_step = make_train_step(s_train, batch_size,
                                     ray_source=pose_ray_source if pose_opt else None, **train_kw)
    else:
        from dexnerf_tpu_torch.parallel import sharding

        make_step = (sharding.make_parallel_pose_train_step if pose_opt
                     else sharding.make_parallel_train_step)
        train_step = make_step(mesh, s_train, batch_size, **train_kw)
    # the depth-free step of the warmup, over its own depth-free fused loss
    warmup_step = None if depth_warmup_iters == 0 else make_train_step(
        s_train, batch_size,
        fused_loss=None if fused_loss is None
        else maybe_fused_loss(cfg, s_train, supervision, coarse, fine),
        **step_kw,
    )
    generator = torch.Generator(device=device).manual_seed(seed)
    train_iters = int(max_iters if max_iters is not None else cfg.experiment.train_iters)
    validate_every = int(_get(cfg.experiment, "validate_every", 0) or 0)
    save_every = int(_get(cfg.experiment, "save_every", 0) or 0)
    print_every = int(_get(cfg.experiment, "print_every", 100) or 100)

    def crosses(lo: int, hi: int, every: int) -> bool:
        """[lo, hi] holds a multiple of ``every`` (several iterations land
        per call when steps_per_call > 1)."""
        return every > 0 and (hi // every) > ((lo - 1) // every) if lo else True

    t0 = time.time()
    last_metrics: Dict[str, float] = {}
    last_val: Dict[str, Any] = {}
    i = start_iter
    depth_on_step: Optional[int] = None  # where the auto warmup switched the depth term on
    with MetricsLogger(logdir, enabled=primary) as logger, (
            host_loader or contextlib.nullcontext()):
        while i < train_iters:
            if warmup_step is None:
                step_fn = train_step
            elif warmup_auto:
                step_fn = train_step if depth_on_step is not None else warmup_step
            else:
                step_fn = warmup_step if i < depth_warmup_iters else train_step
            metrics = step_fn(state, store, generator)
            last = min(i + steps_per_call, train_iters) - 1
            final = last == train_iters - 1
            if occ_rebake is not None and last + 1 >= occ_next:
                frac, iv = occ_rebake()
                store = replace(store, intervals=iv)
                occ_next = last + 1 + occ_every
                last_occ = {"occ_fraction": frac, "occ_interval_shrink": 1.0 - float(
                    torch.mean(iv[:, 1] - iv[:, 0])) / (store.far - store.near)}
                logger.scalars({f"train/{k}": v for k, v in last_occ.items()}, last)
            if crosses(i, last, print_every) or final:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                if (warmup_auto and depth_on_step is None
                        and last_metrics.get("psnr", 0.0) > warmup_psnr):
                    depth_on_step = last + 1
                    logger.scalar("train/depth_on_step", depth_on_step, last)
                    print(f"[depth warmup] train PSNR {last_metrics['psnr']:.1f} > "
                          f"{warmup_psnr:g} dB at iter {last}: depth supervision ON", flush=True)
                logger.scalars({f"train/{k}": v for k, v in last_metrics.items()}, last)
                rays_per_sec = (last - start_iter + 1) * batch_size / max(time.time() - t0, 1e-9)
                logger.scalar("train/rays_per_sec", rays_per_sec, last)
            if validate_every and (crosses(i, last, validate_every) or final):
                val_idx = int(scene.i_val[(last // validate_every) % len(scene.i_val)])
                last_val = validate(
                    coarse, fine, scene, cfg, supervision=supervision, device=device,
                    dex=dex, val_idx=val_idx, mesh=mesh,
                )
                if primary:
                    _log_validation(logger, last_val, last, logdir)
            if primary and save_every and last > 0 and (crosses(i, last, save_every) or final):
                os.makedirs(ckpt_dir, exist_ok=True)
                write_reference_checkpoint(os.path.join(ckpt_dir, f"checkpoint_{last:07d}.ckpt"),
                                           **_checkpoint_of(state, lr, metrics))
            logger.flush()
            i = last + 1
    elapsed = time.time() - t0
    refined = {}
    if pose_opt:
        with torch.no_grad():
            refined["refined_poses"] = refined_c2w(store.base_c2w, state.pose.twists).cpu().numpy()
    return {
        **({"depth_on_step": depth_on_step} if warmup_auto else {}),
        **last_occ,
        **refined,
        "state": state,
        "final_train_metrics": last_metrics,
        "final_validation": last_val,
        "elapsed_sec": elapsed,
        "rays_per_sec": (train_iters - start_iter) * batch_size / max(elapsed, 1e-9),
        "logdir": logdir,
        "scene": scene,
    }
