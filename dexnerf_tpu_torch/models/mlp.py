"""FlexibleNeRF MLP as an ``nn.Module``.

Counterpart of ``dexnerf_tpu/models/mlp.py::FlexibleNeRFModel``, with the
reference's module names (``layer1``, ``layers_xyz.{i}``, ``fc_feat``,
``fc_alpha``, ``layers_dir.0``, ``fc_rgb``) registered in the reference's
order, so ``state_dict()`` reads and writes the reference ``.ckpt`` schema
as it is. Inputs are the already-encoded features: the xyz encoding per
sample and the viewdir encoding, per sample or per ray.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _dims(num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
          include_input_dir):
    dim_xyz = (3 if include_input_xyz else 0) + 2 * 3 * num_encoding_fn_xyz
    dim_dir = (3 if include_input_dir else 0) + 2 * 3 * num_encoding_fn_dir
    return dim_xyz, dim_dir


def skip_positions(num_trunk: int, skip_every: int):
    """Trunk indices whose input is ``cat(h, xyz)``."""
    return {
        i
        for i in range(num_trunk)
        if i % skip_every == 0 and i > 0 and i != num_trunk - 1
    }


class FlexibleNeRFModel(nn.Module):
    """Configurable-depth NeRF MLP (``use_viewdirs=True`` only): ``layer1``
    without activation, a ReLU trunk with skip concats, then ``fc_alpha``
    on the trunk output and ``fc_feat -> layers_dir.0 -> fc_rgb`` for rgb.
    Returns raw ``[..., 4]`` (rgb logits, σ logit)."""

    def __init__(
        self,
        num_layers: int = 4,
        hidden_size: int = 128,
        skip_connect_every: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        use_viewdirs: bool = True,
    ):
        super().__init__()
        if not use_viewdirs:
            raise NotImplementedError(
                "FlexibleNeRFModel without viewdirs is not ported yet "
                "(ROADMAP Queue 1, models)"
            )
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_connect_every = skip_connect_every
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.use_viewdirs = use_viewdirs
        self.dim_xyz, self.dim_dir = _dims(
            num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
            include_input_dir,
        )
        num_trunk = num_layers - 1
        self.skips = skip_positions(num_trunk, skip_connect_every)
        H = hidden_size
        # registration order = the reference's (nerf/models.py:207-228)
        self.layer1 = nn.Linear(self.dim_xyz, H)
        self.layers_xyz = nn.ModuleList(
            nn.Linear(H + self.dim_xyz if i in self.skips else H, H)
            for i in range(num_trunk)
        )
        self.layers_dir = nn.ModuleList([nn.Linear(H + self.dim_dir, H // 2)])
        self.fc_alpha = nn.Linear(H, 1)
        self.fc_rgb = nn.Linear(H // 2, 3)
        self.fc_feat = nn.Linear(H, H)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """``nn.Linear``-style init, kernel and bias both uniform in
        ±1/sqrt(fan_in), drawn from ``generator``."""
        with torch.no_grad():
            for lin in self.modules():
                if isinstance(lin, nn.Linear):
                    bound = 1.0 / lin.in_features ** 0.5
                    lin.weight.uniform_(-bound, bound, generator=generator)
                    lin.bias.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, xyz: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
        """``xyz``: [..., S, dim_xyz]; ``view``: [..., S, dim_dir] or the
        per-ray [..., dim_dir] (broadcast across samples)."""
        if view.ndim < xyz.ndim:
            view = view[..., None, :].expand(*xyz.shape[:-1], view.shape[-1])
        h = self.layer1(xyz)
        for i, layer in enumerate(self.layers_xyz):
            if i in self.skips:
                h = torch.relu(layer(torch.cat([h, xyz], dim=-1)))
            else:
                h = torch.relu(layer(h))
        feat = torch.relu(self.fc_feat(h))
        alpha = self.fc_alpha(h)
        y = torch.relu(self.layers_dir[0](torch.cat([feat, view], dim=-1)))
        rgb = self.fc_rgb(y)
        return torch.cat([rgb, alpha], dim=-1)
