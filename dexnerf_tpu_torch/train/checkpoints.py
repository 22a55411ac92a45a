"""Reference ``.ckpt`` interchange and weight conversion.

Counterpart of the reference-checkpoint half of
``dexnerf_tpu/train/checkpoints.py``. The reference schema (a torch pickle
with ``model_coarse_state_dict``, ``model_fine_state_dict``, ``iter``,
optional ``height``/``width``/``focal_length`` and an optional
``optimizer_state_dict``) is the format both packages read and write, so
either can serve or resume the other's weights. The Adam state is written
in the layout of the JAX package's ``export_torch_checkpoint``: moments
keyed by the position of the parameter in ``coarse.parameters()`` then
``fine.parameters()``, weights [out, in], an integer ``step``. Orbax
checkpoints need JAX: ``python -m dexnerf_tpu.apps.export`` turns one into
a ``.ckpt``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

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
    for k in ("height", "width", "focal_length", "optimizer_state_dict"):
        if ckpt.get(k) is not None:
            out[k] = ckpt[k]
    return out


def write_reference_checkpoint(
    path: str,
    coarse: Mapping[str, torch.Tensor],
    fine: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    step: int = 0,
    hwf=None,
    optimizer_state: Optional[Dict] = None,
    loss: float = 0.0,
    psnr: float = 0.0,
) -> None:
    """Write a reference-schema ``.ckpt`` from two state_dicts and,
    optionally, an Adam state in the reference layout
    (:func:`adam_state_dict`, :func:`adam_state_from_optax`)."""

    def cpu(sd):
        return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}

    ckpt = {
        "iter": int(step),
        "model_coarse_state_dict": cpu(coarse),
        "model_fine_state_dict": cpu(fine) if fine is not None else None,
        "loss": float(loss),
        "psnr": float(psnr),
    }
    if hwf is not None:
        ckpt["height"], ckpt["width"], ckpt["focal_length"] = (
            int(hwf[0]), int(hwf[1]), float(hwf[2]),
        )
    if optimizer_state is not None:
        ckpt["optimizer_state_dict"] = optimizer_state
    torch.save(ckpt, path)


def _adam_layout(moments: Sequence, step: int, lr: float) -> Dict:
    """The reference Adam state from ``(exp_avg, exp_avg_sq)`` per
    parameter, in optimizer order."""
    state = {
        i: {
            "step": int(step),
            "exp_avg": m.detach().to("cpu", torch.float32).contiguous(),
            "exp_avg_sq": v.detach().to("cpu", torch.float32).contiguous(),
        }
        for i, (m, v) in enumerate(moments)
    }
    return {
        "state": state,
        "param_groups": [{
            "lr": float(lr), "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
            "amsgrad": False, "params": list(range(len(state))),
        }],
    }


def _optimizer_params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def adam_state_dict(optimizer: torch.optim.Optimizer, step: int, lr: float) -> Dict:
    """A ``torch.optim.Adam``'s moments in the reference layout, after
    ``step`` updates (zero moments for a parameter not yet updated)."""
    moments = []
    for p in _optimizer_params(optimizer):
        st = optimizer.state.get(p, {})
        moments.append((
            st.get("exp_avg", torch.zeros_like(p)),
            st.get("exp_avg_sq", torch.zeros_like(p)),
        ))
    return _adam_layout(moments, step, lr)


def load_adam_state(optimizer: torch.optim.Optimizer, opt_state: Mapping) -> int:
    """Put a reference-layout Adam state into ``optimizer`` (its own
    hyper-parameters stay); returns the state's update count."""
    params = _optimizer_params(optimizer)
    state = opt_state["state"]
    order = list(opt_state["param_groups"][0]["params"])
    if len(order) != len(params):
        raise ValueError(
            f"the checkpoint's optimizer holds {len(order)} parameters, this one {len(params)}"
        )
    steps = set()
    new_state = {}
    for i, pid in enumerate(order):
        st = state[pid]
        if tuple(st["exp_avg"].shape) != tuple(params[i].shape):
            raise ValueError(
                f"optimizer parameter {i}: moments {tuple(st['exp_avg'].shape)} vs "
                f"parameter {tuple(params[i].shape)}"
            )
        step = int(st["step"])
        steps.add(step)
        new_state[i] = {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.as_tensor(st["exp_avg"]),
            "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]),
        }
    if len(steps) > 1:
        raise ValueError(f"the checkpoint's Adam moments have step counts {sorted(steps)}")
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": new_state, "param_groups": sd["param_groups"]})
    return steps.pop() if steps else 0


def adam_state_from_optax(mu: Mapping, nu: Mapping, count: int, models: Mapping, lr: float) -> Dict:
    """The reference Adam state from an optax ``ScaleByAdamState``'s moment
    trees given as numpy (``mu``/``nu``: ``{"coarse": flax tree, "fine":
    flax tree}``) and its ``count``, in the optimizer order of ``models``
    (``{"coarse": module, "fine": module or None}``)."""
    moments = []
    for name in ("coarse", "fine"):
        model = models.get(name)
        if model is None:
            continue
        m_sd, v_sd = state_dict_from_flax(mu[name]), state_dict_from_flax(nu[name])
        moments += [(m_sd[k], v_sd[k]) for k, _ in model.named_parameters()]
    return _adam_layout(moments, count, lr)


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
