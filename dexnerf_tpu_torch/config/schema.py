"""Typed views over the experiment config tree.

Counterpart of ``dexnerf_tpu/config/schema.py``: maps a :class:`CfgNode`
onto :class:`~dexnerf_tpu_torch.render.RenderSettings` and the models of
the registry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.models.registry import build_model
from dexnerf_tpu_torch.render.renderer import RenderSettings


def _get(node, key, default):
    try:
        return node[key]
    except (KeyError, TypeError):
        return default


def load_config(path: str) -> CfgNode:
    with open(path, "r") as f:
        return CfgNode.load_cfg(f)


def m_thres_candidates(cfg: CfgNode, mode: str = "validation") -> Tuple[float, ...]:
    """Dex-NeRF threshold sweep grid: arange(5, m_thres+5, 5); () when the
    config has no ``m_thres``."""
    m_thres = _get(cfg.nerf[mode], "m_thres", None)
    if m_thres is None:
        return ()
    return tuple(float(m) for m in np.arange(5, m_thres + 5, 5))


def render_settings_from_cfg(
    cfg: CfgNode, mode: str = "train", *, dex: bool = False
) -> RenderSettings:
    """RenderSettings for ``mode`` in {"train", "validation"}; encoder
    settings come from ``models.coarse``."""
    mode_cfg = cfg.nerf[mode]
    mc = cfg.models.coarse
    return RenderSettings(
        num_coarse=int(mode_cfg.num_coarse),
        num_fine=int(_get(mode_cfg, "num_fine", 0)),
        perturb=bool(mode_cfg.perturb),
        lindisp=bool(_get(mode_cfg, "lindisp", False)),
        radiance_field_noise_std=float(
            _get(mode_cfg, "radiance_field_noise_std", 0.0)
        ),
        white_background=bool(_get(mode_cfg, "white_background", False)),
        m_thres_cand=m_thres_candidates(cfg, mode) if dex else (),
        use_viewdirs=bool(cfg.nerf.use_viewdirs),
        num_encoding_fn_xyz=int(_get(mc, "num_encoding_fn_xyz", 6)),
        num_encoding_fn_dir=int(_get(mc, "num_encoding_fn_dir", 4)),
        include_input_xyz=bool(_get(mc, "include_input_xyz", True)),
        include_input_dir=bool(_get(mc, "include_input_dir", True)),
        log_sampling_xyz=bool(_get(mc, "log_sampling_xyz", True)),
        log_sampling_dir=bool(_get(mc, "log_sampling_dir", True)),
    )


def model_from_cfg(model_cfg: CfgNode, use_viewdirs: Optional[bool] = None):
    """Instantiate a registry model from a ``models.{coarse,fine}`` block;
    every declared knob is honored, with the keys JAX's ``model_from_cfg``
    passes (``dexnerf_tpu/config/schema.py:83-100``): ``filter_size`` and
    ``num_encoding_functions`` for the small families, ``dtype`` from
    ``compute_dtype`` for FlexibleNeRF's plain path."""
    kwargs = dict(
        num_layers=int(_get(model_cfg, "num_layers", 4)),
        hidden_size=int(_get(model_cfg, "hidden_size", 128)),
        skip_connect_every=int(_get(model_cfg, "skip_connect_every", 4)),
        num_encoding_fn_xyz=int(_get(model_cfg, "num_encoding_fn_xyz", 6)),
        num_encoding_fn_dir=int(_get(model_cfg, "num_encoding_fn_dir", 4)),
        include_input_xyz=bool(_get(model_cfg, "include_input_xyz", True)),
        include_input_dir=bool(_get(model_cfg, "include_input_dir", True)),
        use_viewdirs=bool(
            _get(model_cfg, "use_viewdirs", True)
            if use_viewdirs is None
            else use_viewdirs
        ),
        filter_size=int(_get(model_cfg, "hidden_size", 128)),
        num_encoding_functions=int(_get(model_cfg, "num_encoding_fn_xyz", 6)),
        dtype=str(_get(model_cfg, "compute_dtype", "float32")),
    )
    return build_model(str(model_cfg.type), **kwargs)


def models_from_cfg(cfg: CfgNode):
    """(coarse, fine_or_None) modules from the config tree."""
    coarse = model_from_cfg(cfg.models.coarse, bool(cfg.nerf.use_viewdirs))
    fine = None
    if _get(cfg.models, "fine", None) is not None:
        fine = model_from_cfg(cfg.models.fine, bool(cfg.nerf.use_viewdirs))
    return coarse, fine
