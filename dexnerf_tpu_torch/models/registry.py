"""Explicit model registry (counterpart of
``dexnerf_tpu/models/registry.py``): the five families by name."""

from __future__ import annotations

import inspect
from typing import Callable, Dict

from torch import nn

from dexnerf_tpu_torch.models.mlp import (
    FlexibleNeRFModel,
    MultiHeadNeRFModel,
    PaperNeRFModel,
    ReplicateNeRFModel,
    VeryTinyNeRFModel,
)

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "VeryTinyNeRFModel": VeryTinyNeRFModel,
    "MultiHeadNeRFModel": MultiHeadNeRFModel,
    "ReplicateNeRFModel": ReplicateNeRFModel,
    "PaperNeRFModel": PaperNeRFModel,
    "FlexibleNeRFModel": FlexibleNeRFModel,
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
