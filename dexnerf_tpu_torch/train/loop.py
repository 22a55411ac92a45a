"""Training loop, model set-up and checkpoint loading.

Counterpart of ``dexnerf_tpu/train/loop.py`` for single-device training on
a device-resident ray store: ``load_scene`` (blender), ``maybe_fused_loss``
(kernel 4 at ``train_compute_dtype``, and kernel 5 between its passes,
when ``nerf.use_pallas``),
``maybe_fused_fields`` (kernels 2 and 3 at ``train_compute_dtype`` when
``nerf.pallas_fused_loss`` is false), ``validate`` (through the fused render kernel), ``run_training``,
and what serving needs:
``align_cfg_models_to_checkpoint``, ``load_eval_params`` (reference
``.ckpt`` only), ``setup_models`` and ``fused_render_impl`` (the
counterpart of ``maybe_fused_render_impl``, at the compute dtype of
``render_compute_dtype``). Checkpoints are reference
``.ckpt`` files with the Adam state, which the JAX package also resumes.
"""

from __future__ import annotations

import os
import re
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.config.schema import models_from_cfg, render_settings_from_cfg
from dexnerf_tpu_torch.core.metrics import luminance, mse2psnr, ssim
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
from dexnerf_tpu_torch.data.blender import load_blender_data, load_blender_depths
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel, skip_positions
from dexnerf_tpu_torch.ops.fused_mlp import make_fused_flexible_field
from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
from dexnerf_tpu_torch.ops.fused_render import make_fused_render_rays
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.render.renderer import RenderSettings, render_image
from dexnerf_tpu_torch.train.checkpoints import (
    adam_state_dict,
    infer_flexible_arch,
    load_adam_state,
    read_reference_checkpoint,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.logging import MetricsLogger
from dexnerf_tpu_torch.train.step import init_train_state, make_train_step


def _get(node, key, default):
    try:
        return node[key]
    except (KeyError, TypeError):
        return default


def align_cfg_models_to_checkpoint(cfg: CfgNode, imported: Dict) -> CfgNode:
    """Reconcile ``cfg.models.*`` with a checkpoint's actual FlexibleNeRF
    architecture (in place; returns ``cfg``), warning when it changes."""
    was_frozen = cfg.is_frozen()
    changed = []
    for name in ("coarse", "fine"):
        sd = imported.get(name)
        blk = _get(cfg.models, name, None)
        if sd is None or blk is None:
            continue
        if str(_get(blk, "type", "FlexibleNeRFModel")) != "FlexibleNeRFModel":
            continue
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


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"nerf.pallas_compute_dtype {name!r}: expected one of {sorted(_COMPUTE_DTYPES)}"
        )
    return _COMPUTE_DTYPES[name]


def fused_render_impl(
    cfg: CfgNode,
    settings: RenderSettings,
    device,
    coarse: FlexibleNeRFModel,
    fine=None,
):
    """The fused PE->MLP->compositing ``rays_impl`` for ``render_image``
    (the counterpart of ``maybe_fused_render_impl``; the models carry the
    weights here) at :func:`render_compute_dtype`. On a CUDA ``device``
    every pass launches the kernel of that dtype (bf16 tensor cores by
    default, f32 with ``nerf.pallas_compute_dtype: float32``); on the CPU
    it runs the kernels' plain PyTorch version. With
    ``nerf.use_fused_render: false`` it returns None on every device, as
    JAX's ``maybe_fused_render_impl`` does: ``render_image`` then renders
    through the plain ``render_rays``, because the config asks for it."""
    flag = _get(cfg.nerf, "use_fused_render", None)
    if flag is not None and not bool(flag):
        return None
    device = torch.device(device)
    compute_dtype = render_compute_dtype(cfg, device)
    for name in ("coarse", "fine"):
        blk = _get(cfg.models, name, None)
        if blk is not None and str(blk.type) != "FlexibleNeRFModel":
            raise NotImplementedError(
                f"models.{name}.type {blk.type}: the fused renderer takes "
                "FlexibleNeRFModel only"
            )
    # the kernel reads the weights where they live: keep them on the card
    for model in (coarse, fine):
        if model is not None and next(model.parameters()).device.type != device.type:
            raise ValueError(f"models must live on {device} to render there")
    return make_fused_render_rays(coarse, fine, settings, compute_dtype=compute_dtype)


@dataclass
class SceneData:
    """A loaded scene: images [N, H, W, 3], c2w poses [N, 4, 4], [H, W,
    focal] and the split indices."""

    images: np.ndarray
    poses: np.ndarray
    hwf: list
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: Optional[np.ndarray] = None
    depths: Optional[np.ndarray] = None  # [N, H, W] GT depth (meters)
    render_poses: Optional[np.ndarray] = None


def load_scene(cfg: CfgNode) -> SceneData:
    """Load the blender dataset named by ``cfg.dataset``."""
    ds = cfg.dataset
    if str(ds.type).lower() != "blender":
        raise NotImplementedError(
            f"dataset type {ds.type!r}: only blender is ported (ROADMAP.md Queue 1 item 4)"
        )
    kw = dict(
        half_res=bool(_get(ds, "half_res", False)),
        testskip=int(_get(ds, "testskip", 1)),
        debug=bool(_get(ds, "debug", False)),
    )
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
    model call). ``train=True`` gives the autograd fields of
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
    dtype = train_compute_dtype(cfg)
    s = render_settings_from_cfg(cfg, "train")
    kw = dict(log_sampling_xyz=s.log_sampling_xyz, log_sampling_dir=s.log_sampling_dir,
              compute_dtype=dtype)
    if train:
        make, kw["dw_dtype"] = make_fused_flexible_field_train, dtype
    else:
        make = make_fused_flexible_field
    return tuple(None if m is None else make(m, **kw) for m in (coarse, fine))


def maybe_fused_loss(cfg: CfgNode, settings: RenderSettings, supervision: str, coarse, fine):
    """The fused train loss over ``coarse``/``fine`` (kernel 4 on a card)
    when ``cfg.nerf.use_pallas`` is set and ``nerf.pallas_fused_loss`` is
    not false, else None (then the fused fields, or the plain autograd
    render, the counterpart of the JAX package's XLA path).
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
    dtype = train_compute_dtype(cfg)
    return make_fused_train_loss(
        coarse, fine, settings, supervision=supervision,
        resample=str(_get(cfg.nerf, "pallas_loss_resample", "auto")),
        compute_dtype=dtype, dw_dtype=dtype,
    )


def validate(
    coarse,
    fine,
    scene: SceneData,
    cfg: CfgNode,
    *,
    supervision: str,
    device,
    val_idx: Optional[int] = None,
) -> Dict[str, Any]:
    """Render one validation view through the fused render kernel (its
    plain version on the CPU) and score it: coarse/fine loss, PSNR of their
    sum and SSIM of the fine image (``train_nerf_rgb.py:304-425``)."""
    device = torch.device(device)
    s_val = render_settings_from_cfg(cfg, "validation").eval_variant()
    H, W, focal = scene.hwf
    idx = int(scene.i_val[0]) if val_idx is None else int(val_idx)
    c2w = torch.as_tensor(np.asarray(scene.poses[idx], np.float32), device=device)
    ro, rd = get_ray_bundle_c2w(int(H), int(W), float(focal), c2w)
    impl = fused_render_impl(cfg, s_val, device, coarse, fine)
    with torch.no_grad():
        out = render_image(
            coarse, fine, ro, rd, float(cfg.dataset.near), float(cfg.dataset.far), s_val,
            rays_impl=impl,
        )
        target = torch.as_tensor(np.asarray(scene.images[idx][..., :3], np.float32), device=device)

        def mse(rgb):
            if supervision == "luminance":
                return float(torch.mean((luminance(rgb) - luminance(target)) ** 2))
            return float(torch.mean((rgb - target) ** 2))

        r = out.fine if out.fine is not None else out.coarse
        coarse_mse = mse(out.coarse.rgb)
        fine_mse = mse(out.fine.rgb) if out.fine is not None else 0.0
        total = coarse_mse + fine_mse
        return {
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


def _log_validation(logger: MetricsLogger, val: Dict[str, Any], step: int) -> None:
    for k in ("loss", "coarse_loss", "fine_loss", "psnr", "ssim"):
        logger.scalar(f"validation/{k}", val[k], step)
    logger.image("validation/rgb_coarse", val["rgb_coarse"], step)
    logger.image("validation/rgb_fine", val["rgb"], step)
    logger.image("validation/img_target", val["target"], step)


_CKPT = re.compile(r"checkpoint_(\d+)\.ckpt$")


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``checkpoint_<iteration>.ckpt`` in ``directory`` with the highest
    iteration, or None."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(directory) if (m := _CKPT.search(f))]
    return os.path.join(directory, max(found)[1]) if found else None


def _reject_unported(cfg: CfgNode) -> None:
    """Config keys whose training modes are not ported raise instead of
    training something else."""
    t = cfg.nerf.train
    for key, item in (
        ("depth_loss_weight", "depth supervision (ROADMAP.md Queue 1 item 2)"),
        ("occupancy", "occupancy-guided training (ROADMAP.md Queue 1 item 8)"),
        ("pose_opt", "pose refinement (ROADMAP.md Queue 1 item 9)"),
    ):
        if _get(t, key, 0):
            raise NotImplementedError(f"nerf.train.{key}: {item} is not ported yet")
    if _get(cfg.dataset, "host_store", False):
        raise NotImplementedError(
            "dataset.host_store: the host-streamed store is not ported yet "
            "(ROADMAP.md Queue 1 item 7)"
        )
    cachedir = str(_get(cfg.dataset, "cachedir", "") or "")
    if cachedir and os.path.isdir(os.path.join(cachedir, "train")):
        raise NotImplementedError(
            f"dataset.cachedir {cachedir} holds a ray cache; training from it is not "
            "ported yet (ROADMAP.md Queue 1 item 4)"
        )


def run_training(
    cfg: CfgNode,
    *,
    supervision: str = "rgb",
    scene: Optional[SceneData] = None,
    load_ckpt: Optional[str] = None,
    auto_resume: bool = False,
    max_iters: Optional[int] = None,
    logdir: Optional[str] = None,
    sampling: Optional[str] = None,
    steps_per_call: Optional[int] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Train a NeRF per ``cfg`` on one device; returns a summary dict.

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
    is the number of updates taken (where a resume starts)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device cuda: no CUDA card is visible to PyTorch")
    _reject_unported(cfg)
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
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        f.write(cfg.dump())

    coarse, fine = setup_models(cfg, seed, device)
    lr = float(cfg.optimizer.lr)
    state = init_train_state(
        coarse, fine, lr, float(cfg.scheduler.lr_decay), float(cfg.scheduler.lr_decay_factor),
        opt_type=str(_get(cfg.optimizer, "type", "Adam")),
    )
    if imported is not None:
        coarse.load_state_dict(imported["coarse"])
        if fine is not None and imported["fine"] is not None:
            fine.load_state_dict(imported["fine"])
        if "optimizer_state_dict" in imported:
            load_adam_state(state.optimizer, imported["optimizer_state_dict"])
        state.step = int(imported["step"])
    start_iter = state.step

    s_train = render_settings_from_cfg(cfg, "train")
    batch_size = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    store = build_ray_store(
        scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf, near, far,
        device=device,
    )
    steps_per_call = int(
        steps_per_call if steps_per_call is not None
        else _get(cfg.nerf.train, "steps_per_call", 1)
    )
    fused_loss = maybe_fused_loss(cfg, s_train, supervision, coarse, fine)
    # the fused loss supersedes the separate field kernels
    coarse_field, fine_field = (
        (None, None) if fused_loss is not None
        else maybe_fused_fields(cfg, coarse, fine, train=True)
    )
    train_step = make_train_step(
        s_train, batch_size,
        supervision=supervision,
        coarse_field=coarse_field,
        fine_field=fine_field,
        fused_loss=fused_loss,
        sampling=sampling or str(_get(cfg.nerf.train, "sampling", "uniform")),
        steps_per_call=steps_per_call,
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
    with MetricsLogger(logdir) as logger:
        while i < train_iters:
            metrics = train_step(state, store, generator)
            last = min(i + steps_per_call, train_iters) - 1
            final = last == train_iters - 1
            if crosses(i, last, print_every) or final:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                logger.scalars({f"train/{k}": v for k, v in last_metrics.items()}, last)
                rays_per_sec = (last - start_iter + 1) * batch_size / max(time.time() - t0, 1e-9)
                logger.scalar("train/rays_per_sec", rays_per_sec, last)
            if validate_every and (crosses(i, last, validate_every) or final):
                val_idx = int(scene.i_val[(last // validate_every) % len(scene.i_val)])
                last_val = validate(
                    coarse, fine, scene, cfg, supervision=supervision, device=device,
                    val_idx=val_idx,
                )
                _log_validation(logger, last_val, last)
            if save_every and last > 0 and (crosses(i, last, save_every) or final):
                os.makedirs(ckpt_dir, exist_ok=True)
                write_reference_checkpoint(
                    os.path.join(ckpt_dir, f"checkpoint_{last:07d}.ckpt"),
                    coarse.state_dict(),
                    fine.state_dict() if fine is not None else None,
                    step=state.step,
                    optimizer_state=adam_state_dict(state.optimizer, state.step, lr),
                    loss=float(metrics["loss"]),
                    psnr=float(metrics["psnr"]),
                )
            logger.flush()
            i = last + 1
    elapsed = time.time() - t0
    return {
        "state": state,
        "final_train_metrics": last_metrics,
        "final_validation": last_val,
        "elapsed_sec": elapsed,
        "rays_per_sec": (train_iters - start_iter) * batch_size / max(elapsed, 1e-9),
        "logdir": logdir,
        "scene": scene,
    }
