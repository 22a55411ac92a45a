"""Config tree and typed views over it."""

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.config.schema import (
    load_config,
    m_thres_candidates,
    model_from_cfg,
    models_from_cfg,
    render_settings_from_cfg,
)

__all__ = [
    "CfgNode",
    "load_config",
    "m_thres_candidates",
    "model_from_cfg",
    "models_from_cfg",
    "render_settings_from_cfg",
]
