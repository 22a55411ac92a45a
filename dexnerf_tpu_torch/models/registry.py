"""Explicit model registry (counterpart of
``dexnerf_tpu/models/registry.py``).

Only ``FlexibleNeRFModel`` — the model of every shipped config — is
ported; the other four reference families are registered by name and
raise until they are.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

from torch import nn

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel


def _not_ported(name: str) -> Callable[..., nn.Module]:
    def build(**_kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1, models: the other "
            "model families)"
        )

    return build


MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "FlexibleNeRFModel": FlexibleNeRFModel,
    **{
        name: _not_ported(name)
        for name in (
            "VeryTinyNeRFModel",
            "MultiHeadNeRFModel",
            "ReplicateNeRFModel",
            "PaperNeRFModel",
        )
    },
}


def build_model(name: str, **kwargs) -> nn.Module:
    """Instantiate a registered model, dropping kwargs it does not take."""
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model type {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        ) from None
    params = inspect.signature(cls).parameters
    if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in params}
    return cls(**kwargs)
