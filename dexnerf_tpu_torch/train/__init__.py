"""Training: the train step, checkpoint interchange, metrics logging and
the training loop (plus the model set-up that serving needs)."""

from dexnerf_tpu_torch.train.checkpoints import (
    adam_state_dict,
    adam_state_from_optax,
    infer_flexible_arch,
    load_adam_state,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.loop import (
    align_cfg_models_to_checkpoint,
    fused_render_impl,
    load_eval_params,
    load_scene,
    maybe_fused_loss,
    render_compute_dtype,
    run_training,
    setup_models,
    validate,
)
from dexnerf_tpu_torch.train.step import (
    TrainState,
    exponential_decay_schedule,
    init_train_state,
    make_optimizer,
    make_train_step,
    masked_depth_mse,
    nerf_loss,
)

__all__ = [
    "TrainState",
    "adam_state_dict",
    "adam_state_from_optax",
    "align_cfg_models_to_checkpoint",
    "exponential_decay_schedule",
    "fused_render_impl",
    "infer_flexible_arch",
    "init_train_state",
    "load_adam_state",
    "load_eval_params",
    "load_scene",
    "make_optimizer",
    "make_train_step",
    "masked_depth_mse",
    "maybe_fused_loss",
    "nerf_loss",
    "render_compute_dtype",
    "read_reference_checkpoint",
    "run_training",
    "setup_models",
    "state_dict_from_flax",
    "validate",
    "write_reference_checkpoint",
]
