"""Reference ``.ckpt`` interchange and weight conversion.

Counterpart of the reference-checkpoint half of
``dexnerf_tpu/train/checkpoints.py``. The reference schema (a torch pickle
with ``model_coarse_state_dict``, ``model_fine_state_dict``, ``iter``,
optional ``height``/``width``/``focal_length`` and an optional
``optimizer_state_dict``) is the format both packages read and write, so
either can serve or resume the other's weights. The Adam (and AdamW) state
is written in the layout of the JAX package's ``export_torch_checkpoint``:
moments keyed by the position of the parameter in ``coarse.parameters()``
then ``fine.parameters()``, weights [out, in], an integer ``step``. The
state of SGD, RMSprop and Adagrad, which JAX's export does not write, goes
under :data:`PORT_OPTIMIZER_KEY`, a key JAX's ``import_torch_checkpoint``
does not read, so the port resumes every optimizer. The twists of pose
refinement and their Adam's state go under :data:`POSE_KEY`, and the SG
shading leaves of ``--sg-ir`` and their optimizer state under
:data:`SG_KEY`; JAX's importer reads neither. Orbax checkpoints need JAX: ``python -m
dexnerf_tpu.apps.export`` turns one into a ``.ckpt``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dexnerf_tpu_torch.models.mlp import skip_positions
from dexnerf_tpu_torch.train.step import SG_GROUP

# call-order tails of the flax FlexibleNeRFModel, with and without viewdirs
_HEADS = ["fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb"]
_HEAD_NO_VIEWDIRS = ["fc_out"]
# where the state of an optimizer outside JAX's export (SGD, RMSprop, Adagrad) goes
PORT_OPTIMIZER_KEY = "dexnerf_torch_optimizer_state"
# where the pose twists [n_images, 6], their Adam state and its count go
POSE_KEY = "dexnerf_torch_pose_state"
# where the SG shading leaves of --sg-ir and their optimizer state go
SG_KEY = "dexnerf_torch_sg_state"
# the optimizers whose state the reference Adam layout carries (JAX exports AdamW's too)
ADAM_LAYOUT = ("Adam", "AdamW")


def state_dict_from_flax(tree: Mapping, model: Optional[nn.Module] = None
                         ) -> Dict[str, torch.Tensor]:
    """A port model's state_dict from a JAX param tree given as numpy
    arrays (``{"params": {"Dense_i": {"kernel", "bias"}}}``).

    Call-order ``Dense_i`` map by position to ``model.flax_order`` (any
    family); without ``model``, to a FlexibleNeRF's ``layer1``,
    ``layers_xyz.{i}`` and ``fc_feat``, ``fc_alpha``, ``layers_dir.0``,
    ``fc_rgb``, or ``fc_out`` when the last layer has 4 outputs (no
    viewdirs). Kernels are transposed from [in, out] to [out, in]."""
    p = tree["params"] if "params" in tree else tree
    names = sorted(p, key=lambda k: int(k.rsplit("_", 1)[1]))
    if model is not None:
        prefixes = list(model.flax_order)
        if len(prefixes) != len(names):
            raise ValueError(
                f"param tree has {len(names)} Dense layers, {type(model).__name__} {len(prefixes)}")
    else:
        heads = _HEAD_NO_VIEWDIRS if np.shape(p[names[-1]]["kernel"])[-1] == 4 else _HEADS
        num_trunk = len(names) - 1 - len(heads)
        if num_trunk < 0:
            raise ValueError(f"param tree has only {len(names)} Dense layers")
        prefixes = ["layer1"] + [f"layers_xyz.{i}" for i in range(num_trunk)] + heads
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
    return parse_reference_checkpoint(torch.load(path, map_location="cpu", weights_only=True))


def parse_reference_checkpoint(ckpt: Mapping) -> Dict:
    """:func:`read_reference_checkpoint` of a loaded ``.ckpt`` dict (as
    :func:`reference_checkpoint` builds it)."""
    out = {
        "step": int(ckpt.get("iter", 0)),
        "coarse": dict(ckpt["model_coarse_state_dict"]),
        "fine": (
            dict(ckpt["model_fine_state_dict"])
            if ckpt.get("model_fine_state_dict")
            else None
        ),
    }
    for k in ("height", "width", "focal_length", "optimizer_state_dict", PORT_OPTIMIZER_KEY,
              POSE_KEY, SG_KEY):
        if ckpt.get(k) is not None:
            out[k] = ckpt[k]
    return out


def write_reference_checkpoint(path: str, *args, **kwargs) -> None:
    """Write :func:`reference_checkpoint`'s dict of the same arguments to
    ``path``."""
    torch.save(reference_checkpoint(*args, **kwargs), path)


def reference_checkpoint(
    coarse: Mapping[str, torch.Tensor],
    fine: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    step: int = 0,
    hwf=None,
    optimizer_state: Optional[Dict] = None,
    loss: float = 0.0,
    psnr: float = 0.0,
    port_optimizer_state: Optional[Dict] = None,
    pose_state: Optional[Dict] = None,
    sg_state: Optional[Dict] = None,
) -> Dict:
    """A reference-schema ``.ckpt``'s dict from two state_dicts and,
    optionally, an Adam state in the reference layout
    (:func:`adam_state_dict`, :func:`adam_state_from_optax`) or another
    optimizer's state under :data:`PORT_OPTIMIZER_KEY`
    (:func:`optimizer_checkpoint`), the pose twists' under
    :data:`POSE_KEY` (:func:`pose_checkpoint`) and the SG shading leaves'
    under :data:`SG_KEY` (:func:`sg_checkpoint`)."""

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
    if port_optimizer_state is not None:
        ckpt[PORT_OPTIMIZER_KEY] = port_optimizer_state
    if pose_state is not None:
        ckpt[POSE_KEY] = pose_state
    if sg_state is not None:
        ckpt[SG_KEY] = sg_state
    return ckpt


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
    """The models' parameters of ``optimizer`` in order (the reference
    layout's), without the SG shading group."""
    return [p for group in optimizer.param_groups if group.get("name") != SG_GROUP
            for p in group["params"]]


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
        m_sd, v_sd = state_dict_from_flax(mu[name], model), state_dict_from_flax(nu[name], model)
        moments += [(m_sd[k], v_sd[k]) for k, _ in model.named_parameters()]
    return _adam_layout(moments, count, lr)


def stack_adam_states(states: Sequence[Mapping]) -> Dict:
    """M scenes' reference-layout Adam states (:func:`adam_state_dict`,
    :func:`adam_state_from_optax`) as one over their stacked parameters
    (``parallel.multiscene``): each moment stacked on a leading scene axis,
    for :func:`load_adam_state` into a multi-scene optimizer. The scenes
    advance in lockstep: their update counts must agree."""
    steps = {int(st["step"]) for s in states for st in s["state"].values()}
    if len(steps) > 1:
        raise ValueError(f"the scenes' Adam states have step counts {sorted(steps)}")
    order = list(states[0]["param_groups"][0]["params"])
    moments = [(torch.stack([torch.as_tensor(s["state"][i]["exp_avg"]) for s in states]),
                torch.stack([torch.as_tensor(s["state"][i]["exp_avg_sq"]) for s in states]))
               for i in order]
    return _adam_layout(moments, steps.pop() if steps else 0,
                        states[0]["param_groups"][0]["lr"])


def has_viewdir_head(state_dict: Mapping[str, torch.Tensor]) -> bool:
    """Whether a FlexibleNeRF state_dict has the viewdir heads (``fc_rgb``),
    not the single ``fc_out`` of a model without viewdirs."""
    return "fc_out.weight" not in state_dict


def infer_flexible_arch(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """``{num_layers, hidden_size, skip_connect_every}`` that reproduce a
    FlexibleNeRF state_dict's shapes, with or without viewdirs (``fc_out``;
    the reference's train scripts drop these knobs from the config, so a
    checkpoint's architecture may disagree with the config beside it; the
    weights are the truth)."""
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


def optimizer_checkpoint(opt_type: str, optimizer: torch.optim.Optimizer, step: int,
                         lr: float) -> Dict:
    """The :func:`write_reference_checkpoint` keywords that carry
    ``optimizer``'s state after ``step`` updates: Adam's and AdamW's moments
    as ``optimizer_state``, in the reference layout JAX's
    ``export_torch_checkpoint`` writes for both; SGD's, RMSprop's and
    Adagrad's (which JAX's export leaves out) as ``port_optimizer_state``,
    ``{"type", "step", "state": {parameter index: {name: tensor}}}``."""
    if opt_type in ADAM_LAYOUT:
        return {"optimizer_state": adam_state_dict(optimizer, step, lr)}
    params = _optimizer_params(optimizer)
    state = {
        i: {k: v.detach().to("cpu") for k, v in optimizer.state.get(p, {}).items()}
        for i, p in enumerate(params)
    }
    return {"port_optimizer_state": {"type": opt_type, "step": int(step), "state": state}}


def load_optimizer_checkpoint(opt_type: str, optimizer: torch.optim.Optimizer,
                              imported: Mapping) -> bool:
    """Put a checkpoint's optimizer state (:func:`read_reference_checkpoint`)
    into ``optimizer``, an ``opt_type``: the reference Adam layout for Adam
    and AdamW, the port's own entry for the others when it was written by
    the same type. A state of another optimizer is left out and the
    optimizer starts fresh, as JAX's ``build_opt_state_from_torch`` grafts
    Adam moments only. Returns whether a state was loaded."""
    if opt_type in ADAM_LAYOUT:
        if "optimizer_state_dict" not in imported:
            return False
        load_adam_state(optimizer, imported["optimizer_state_dict"])
        return True
    entry = imported.get(PORT_OPTIMIZER_KEY)
    if entry is None or entry.get("type") != opt_type:
        return False
    params = _optimizer_params(optimizer)
    if len(entry["state"]) != len(params):
        raise ValueError(
            f"the checkpoint's optimizer holds {len(entry['state'])} parameters, this one "
            f"{len(params)}"
        )
    state = {i: {k: torch.as_tensor(v) for k, v in entry["state"][i].items()}
             for i in range(len(params)) if entry["state"][i]}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    return True


def pose_checkpoint(pose) -> Dict:
    """A ``train.pose_opt.PoseState`` as the :data:`POSE_KEY` entry:
    ``{"twists", "step", "state"}``, the state its Adam's for the twists."""
    st = pose.optimizer.state.get(pose.twists, {})
    return {"twists": pose.twists.detach().to("cpu").clone(), "step": int(pose.step),
            "state": {k: v.detach().to("cpu") for k, v in st.items()}}


def load_pose_checkpoint(pose, imported: Mapping) -> bool:
    """Put a checkpoint's :data:`POSE_KEY` entry into ``pose`` (a
    ``train.pose_opt.PoseState``). A checkpoint without one (the
    reference's, or one JAX exported) leaves the twists at 0; as JAX grafts
    the checkpoint's Adam count onto every partition of its optimizer, the
    twists' Adam then resumes at the checkpoint's iteration with zero
    moments when the file carries ``optimizer_state_dict``, else fresh.
    Returns whether twists were loaded."""
    entry = imported.get(POSE_KEY)
    sd = pose.optimizer.state_dict()
    if entry is None:
        count = int(imported.get("step", 0)) if "optimizer_state_dict" in imported else 0
        pose.step = count
        if count:
            zeros = torch.zeros_like(pose.twists, device="cpu")
            pose.optimizer.load_state_dict({"state": {0: {
                "step": torch.tensor(float(count)), "exp_avg": zeros, "exp_avg_sq": zeros.clone(),
            }}, "param_groups": sd["param_groups"]})
        return False
    twists = torch.as_tensor(entry["twists"])
    if tuple(twists.shape) != tuple(pose.twists.shape):
        raise ValueError(
            f"the checkpoint holds twists of {tuple(twists.shape)}, this scene "
            f"{tuple(pose.twists.shape)} (one per train view)")
    with torch.no_grad():
        pose.twists.copy_(twists)
    pose.step = int(entry["step"])
    state = {k: torch.as_tensor(v).clone() for k, v in entry["state"].items()}
    pose.optimizer.load_state_dict({"state": {0: state} if state else {},
                                    "param_groups": sd["param_groups"]})
    return True


def sg_checkpoint(sg: Mapping[str, torch.Tensor], optimizer: torch.optim.Optimizer) -> Dict:
    """The SG shading leaves (``TrainState.sg``) and their state in
    ``optimizer`` as the :data:`SG_KEY` entry: ``{"params": {leaf: tensor},
    "state": {leaf: {name: tensor}}}``."""
    return {
        "params": {k: v.detach().to("cpu").clone() for k, v in sg.items()},
        "state": {k: {n: t.detach().to("cpu").clone() if torch.is_tensor(t) else t
                      for n, t in optimizer.state.get(v, {}).items()} for k, v in sg.items()},
    }


def load_sg_checkpoint(sg: Mapping[str, torch.Tensor], optimizer: torch.optim.Optimizer,
                       opt_type: str, imported: Mapping) -> bool:
    """Put a checkpoint's :data:`SG_KEY` entry into the leaves ``sg`` and
    their state in ``optimizer`` (after the models' state is loaded: it
    touches only the leaves' entries). A checkpoint without one (the
    reference's, or one JAX exported) keeps the fresh leaves; their state
    is then zero moments at the checkpoint's count for Adam and AdamW when
    the file carries ``optimizer_state_dict`` (JAX grafts the count onto
    every leaf, ``build_opt_state_from_torch``), else fresh. Returns whether
    leaves were loaded."""
    entry = imported.get(SG_KEY)
    if entry is None:
        if opt_type in ADAM_LAYOUT and "optimizer_state_dict" in imported:
            count = float(imported.get("step", 0))
            for v in sg.values():
                optimizer.state[v] = {"step": torch.tensor(count),
                                      "exp_avg": torch.zeros_like(v.detach()),
                                      "exp_avg_sq": torch.zeros_like(v.detach())}
        return False
    if set(entry["params"]) != set(sg):
        raise ValueError(
            f"the checkpoint's SG leaves {sorted(entry['params'])}, this model's {sorted(sg)}")
    with torch.no_grad():
        for k, v in sg.items():
            src = torch.as_tensor(entry["params"][k])
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(
                    f"SG leaf {k}: the checkpoint's {tuple(src.shape)}, this model's "
                    f"{tuple(v.shape)} (nerf.train.sg_env_lobes)")
            v.copy_(src)
    for k, v in sg.items():
        st = entry["state"].get(k, {})
        # step counts stay on the CPU, as torch's optimizers keep them
        optimizer.state[v] = {n: (t.clone() if n == "step" else t.to(v.device))
                              if torch.is_tensor(t) else t for n, t in st.items()}
    return True
