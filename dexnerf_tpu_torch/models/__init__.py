"""NeRF model families (``nn.Module``) and the name registry."""

from dexnerf_tpu_torch.models.mlp import (
    FlexibleNeRFModel,
    MultiHeadNeRFModel,
    PaperNeRFModel,
    ReplicateNeRFModel,
    VeryTinyNeRFModel,
)
from dexnerf_tpu_torch.models.registry import MODEL_REGISTRY, build_model

__all__ = [
    "FlexibleNeRFModel",
    "MODEL_REGISTRY",
    "MultiHeadNeRFModel",
    "PaperNeRFModel",
    "ReplicateNeRFModel",
    "VeryTinyNeRFModel",
    "build_model",
]
