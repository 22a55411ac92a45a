"""Checkpoint interchange and the model set-up that serving needs."""

from dexnerf_tpu_torch.train.checkpoints import (
    infer_flexible_arch,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.loop import (
    align_cfg_models_to_checkpoint,
    fused_render_impl,
    load_eval_params,
    setup_models,
)

__all__ = [
    "align_cfg_models_to_checkpoint",
    "fused_render_impl",
    "infer_flexible_arch",
    "load_eval_params",
    "read_reference_checkpoint",
    "setup_models",
    "state_dict_from_flax",
    "write_reference_checkpoint",
]
