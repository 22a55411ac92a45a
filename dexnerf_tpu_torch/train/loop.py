"""Model set-up and checkpoint loading for inference.

Counterpart of the parts of ``dexnerf_tpu/train/loop.py`` that serving
needs: ``align_cfg_models_to_checkpoint``, ``load_eval_params`` (reference
``.ckpt`` only), ``setup_models`` and ``fused_render_impl`` (the
counterpart of ``maybe_fused_render_impl``). The training loop is not
ported yet.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.config.schema import models_from_cfg
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel, skip_positions
from dexnerf_tpu_torch.ops.fused_render import make_fused_render_rays
from dexnerf_tpu_torch.render.renderer import RenderSettings
from dexnerf_tpu_torch.train.checkpoints import (
    infer_flexible_arch,
    read_reference_checkpoint,
)


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


def setup_models(cfg: CfgNode, seed: int, device="cpu"):
    """(coarse, fine_or_None) models from the config, initialized from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    coarse, fine = models_from_cfg(cfg)
    coarse = coarse.reset_parameters(gen).to(device).eval()
    if fine is not None:
        fine = fine.reset_parameters(gen).to(device).eval()
    return coarse, fine


def fused_render_impl(
    cfg: CfgNode,
    settings: RenderSettings,
    device,
    coarse: FlexibleNeRFModel,
    fine=None,
):
    """The fused PE->MLP->compositing ``rays_impl`` for ``render_image``
    (the counterpart of ``maybe_fused_render_impl``; the models carry the
    weights here). On a CUDA ``device`` every pass launches the kernel; on
    the CPU it runs the kernel's plain PyTorch version. There is no knob
    that routes CUDA work to the plain version."""
    device = torch.device(device)
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
    return make_fused_render_rays(coarse, fine, settings)
