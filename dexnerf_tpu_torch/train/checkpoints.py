"""Reference ``.ckpt`` interchange and weight conversion.

Counterpart of the reference-checkpoint half of
``dexnerf_tpu/train/checkpoints.py``. The reference schema (a torch pickle
with ``model_coarse_state_dict``, ``model_fine_state_dict`` and optional
``height``/``width``/``focal_length``) is the format both packages read
and write, so either can serve the other's weights. Orbax checkpoints need
JAX: ``python -m dexnerf_tpu.apps.export`` turns one into a ``.ckpt``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dexnerf_tpu_torch.models.mlp import skip_positions

# call-order tail of the flax FlexibleNeRFModel (use_viewdirs=True)
_HEADS = ["fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb"]


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``FlexibleNeRFModel`` state_dict from a JAX param tree
    given as numpy arrays (``{"params": {"Dense_i": {"kernel", "bias"}}}``).

    Call-order ``Dense_i`` map to ``layer1``, ``layers_xyz.{i}``,
    ``fc_feat``, ``fc_alpha``, ``layers_dir.0``, ``fc_rgb``; kernels are
    transposed from [in, out] to [out, in]."""
    p = tree["params"] if "params" in tree else tree
    names = sorted(p, key=lambda k: int(k.rsplit("_", 1)[1]))
    num_trunk = len(names) - 1 - len(_HEADS)
    if num_trunk < 0:
        raise ValueError(f"param tree has only {len(names)} Dense layers")
    prefixes = ["layer1"] + [f"layers_xyz.{i}" for i in range(num_trunk)] + _HEADS
    sd = {}
    for name, prefix in zip(names, prefixes):
        w = np.asarray(p[name]["kernel"], dtype=np.float32)
        b = np.asarray(p[name]["bias"], dtype=np.float32)
        sd[f"{prefix}.weight"] = torch.tensor(w.T)
        sd[f"{prefix}.bias"] = torch.tensor(b)
    return sd


def read_reference_checkpoint(path: str) -> Dict:
    """``{"coarse": state_dict, "fine": state_dict | None, "step": int}``
    plus ``height``/``width``/``focal_length`` when the file has them.
    Loads tensors and plain containers only (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {
        "step": int(ckpt.get("iter", 0)),
        "coarse": dict(ckpt["model_coarse_state_dict"]),
        "fine": (
            dict(ckpt["model_fine_state_dict"])
            if ckpt.get("model_fine_state_dict")
            else None
        ),
    }
    for k in ("height", "width", "focal_length"):
        if k in ckpt:
            out[k] = ckpt[k]
    return out


def write_reference_checkpoint(
    path: str,
    coarse: Mapping[str, torch.Tensor],
    fine: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    step: int = 0,
    hwf=None,
) -> None:
    """Write a reference-schema ``.ckpt`` from two state_dicts (no
    optimizer state)."""

    def cpu(sd):
        return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}

    ckpt = {
        "iter": int(step),
        "model_coarse_state_dict": cpu(coarse),
        "model_fine_state_dict": cpu(fine) if fine is not None else None,
        "loss": 0.0,
        "psnr": 0.0,
    }
    if hwf is not None:
        ckpt["height"], ckpt["width"], ckpt["focal_length"] = (
            int(hwf[0]), int(hwf[1]), float(hwf[2]),
        )
    torch.save(ckpt, path)


def infer_flexible_arch(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """``{num_layers, hidden_size, skip_connect_every}`` that reproduce a
    FlexibleNeRF state_dict's shapes (the reference's train scripts drop
    these knobs from the config, so a checkpoint's architecture may
    disagree with the config beside it; the weights are the truth)."""
    hidden = int(state_dict["layer1.weight"].shape[0])
    trunk = sorted(
        int(m.group(1))
        for k in state_dict
        if (m := re.match(r"layers_xyz\.(\d+)\.weight", k))
    )
    num_trunk = len(trunk)
    skips = {
        j
        for j in trunk
        if int(state_dict[f"layers_xyz.{j}.weight"].shape[1]) != hidden
    }
    num_layers = num_trunk + 1
    if not skips:
        # a period that never fires inside the trunk
        skip_every = num_layers + 1
    else:
        skip_every = min(skips)
        if skip_positions(num_trunk, skip_every) != skips:
            raise ValueError(
                f"skip layers at trunk positions {sorted(skips)} do not "
                "match any periodic skip_connect_every"
            )
    return {
        "num_layers": num_layers,
        "hidden_size": hidden,
        "skip_connect_every": skip_every,
    }
