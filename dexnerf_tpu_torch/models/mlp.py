"""The NeRF MLP families as ``nn.Module``s.

Counterparts of the five flax families of ``dexnerf_tpu/models/mlp.py``.
Each maps the already-encoded features, the xyz encoding per sample and,
with viewdirs, the viewdir encoding per sample or per ray, to raw
``[..., 4]`` (rgb logits, σ logit): ``forward(xyz, view=None)``.

Each module's ``nn.Linear`` layers carry the reference's names
(``nerf-pytorch/nerf/models.py``) and are registered in the reference's
order, so ``state_dict()`` is the reference ``.ckpt`` schema; each class's
``flax_order`` lists them in the order the flax module calls its
``Dense`` layers (``Dense_0``, ``Dense_1``, ...), which
``train/checkpoints.py::state_dict_from_flax`` maps by position.

Flax infers a ``Dense``'s fan-in from its input at init, ``nn.Linear``
needs it up front: every family takes the encoding widths the config
gives the renderer (``num_encoding_fn_xyz/dir``, ``include_input_xyz/dir``,
``use_viewdirs``) and sizes its layers to the renderer's inputs.

A layer whose input is a concatenation runs as JAX's ``Dense`` over a
tuple of blocks does (:func:`dense`): one kernel, sliced per block, a
product per block, summed; a per-ray block's product runs once per ray.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# the compute dtypes of the configs (models.*.compute_dtype, nerf.pallas_compute_dtype)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """A compute dtype from its config name ("float32", "bfloat16")."""
    try:
        return COMPUTE_DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"compute dtype {name!r}: expected one of {sorted(COMPUTE_DTYPES)}"
                         ) from None


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


def dense(lin: nn.Linear, parts: Sequence[torch.Tensor],
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``lin`` on the concatenation of ``parts`` as JAX's ``Dense`` computes
    it (``dexnerf_tpu/models/mlp.py:51-98``): the kernel sliced per part,
    each part's product in ``dtype`` (parameters stay f32 and are cast for
    it), the products summed in ``dtype`` and the bias added in ``dtype``;
    a part of lower rank (a per-ray viewdir encoding) broadcasts across the
    samples."""
    if dtype == torch.float32 and len(parts) == 1:
        return F.linear(parts[0], lin.weight, lin.bias)
    w = lin.weight.to(dtype)
    rank = max(p.ndim for p in parts)
    y, off = None, 0
    for p in parts:
        k = p.shape[-1]
        t = p.to(dtype) @ w[:, off:off + k].t()
        off += k
        while t.ndim < rank:
            t = t.unsqueeze(-2)
        y = t if y is None else y + t
    if off != lin.in_features:
        raise ValueError(f"inputs of width {off} for a layer of fan-in {lin.in_features}")
    return y + lin.bias.to(dtype)


def _packed(xyz: torch.Tensor, view: Optional[torch.Tensor]) -> torch.Tensor:
    """``cat(xyz, view)`` with a per-ray ``view`` broadcast across the
    samples (JAX's ``_as_packed``)."""
    if view is None:
        return xyz
    if view.ndim < xyz.ndim:
        view = view[..., None, :].expand(*xyz.shape[:-1], view.shape[-1])
    return torch.cat([xyz, view], dim=-1)


def _needs_viewdirs(name: str, use_viewdirs: bool) -> None:
    if not use_viewdirs:
        raise ValueError(
            f"{name} needs viewdirs (nerf.use_viewdirs: true): its rgb branch takes "
            "(feat, view), as in the JAX package, whose Dense fails without them"
        )


class _NeRFMLP(nn.Module):
    """What every family shares: ``reset_parameters`` and the encoding
    widths."""

    flax_order: tuple = ()

    def _set_encodings(self, num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
                       include_input_dir, use_viewdirs):
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.use_viewdirs = use_viewdirs
        self.dim_xyz, self.dim_dir = _dims(
            num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz, include_input_dir
        )

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


class VeryTinyNeRFModel(_NeRFMLP):
    """Three layers over ``cat(xyz, view)``: ``layer1``, ``layer2`` (ReLU
    each), ``layer3`` -> raw (``dexnerf_tpu/models/mlp.py:132-144``).
    ``num_encoding_fn_xyz``/``dir`` default to ``num_encoding_functions``
    (the tiny pipeline encodes both at 6 frequencies: fan-in 78)."""

    flax_order = ("layer1", "layer2", "layer3")

    def __init__(
        self,
        filter_size: int = 128,
        num_encoding_functions: int = 6,
        use_viewdirs: bool = True,
        num_encoding_fn_xyz: Optional[int] = None,
        num_encoding_fn_dir: Optional[int] = None,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
    ):
        super().__init__()
        fx = num_encoding_functions if num_encoding_fn_xyz is None else num_encoding_fn_xyz
        fd = num_encoding_functions if num_encoding_fn_dir is None else num_encoding_fn_dir
        self._set_encodings(fx, fd, include_input_xyz, include_input_dir, use_viewdirs)
        self.filter_size = filter_size
        fan_in = self.dim_xyz + (self.dim_dir if use_viewdirs else 0)
        self.layer1 = nn.Linear(fan_in, filter_size)
        self.layer2 = nn.Linear(filter_size, filter_size)
        self.layer3 = nn.Linear(filter_size, 4)

    def forward(self, xyz: torch.Tensor, view: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.relu(self.layer1(_packed(xyz, view)))
        x = torch.relu(self.layer2(x))
        return self.layer3(x)


class MultiHeadNeRFModel(_NeRFMLP):
    """Separate σ and rgb heads (``dexnerf_tpu/models/mlp.py:147-166``):
    ``layer1``, ``layer2`` on xyz (ReLU), σ from ``layer3_1``, a feature
    from ``layer3_2`` (ReLU), then ``layer4`` on ``(feat, view)``,
    ``layer5`` (ReLU each) and ``layer6`` -> rgb. Needs viewdirs."""

    flax_order = ("layer1", "layer2", "layer3_1", "layer3_2", "layer4", "layer5", "layer6")

    def __init__(
        self,
        hidden_size: int = 128,
        num_encoding_functions: int = 6,
        use_viewdirs: bool = True,
        num_encoding_fn_xyz: Optional[int] = None,
        num_encoding_fn_dir: Optional[int] = None,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
    ):
        super().__init__()
        _needs_viewdirs("MultiHeadNeRFModel", use_viewdirs)
        fx = num_encoding_functions if num_encoding_fn_xyz is None else num_encoding_fn_xyz
        fd = num_encoding_functions if num_encoding_fn_dir is None else num_encoding_fn_dir
        self._set_encodings(fx, fd, include_input_xyz, include_input_dir, use_viewdirs)
        H = self.hidden_size = hidden_size
        self.layer1 = nn.Linear(self.dim_xyz, H)
        self.layer2 = nn.Linear(H, H)
        self.layer3_1 = nn.Linear(H, 1)
        self.layer3_2 = nn.Linear(H, H)
        self.layer4 = nn.Linear(H + self.dim_dir, H)
        self.layer5 = nn.Linear(H, H)
        self.layer6 = nn.Linear(H, 3)

    def forward(self, xyz: torch.Tensor, view: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self.layer1(xyz))
        h = torch.relu(self.layer2(h))
        sigma = self.layer3_1(h)
        feat = torch.relu(self.layer3_2(h))
        h = torch.relu(dense(self.layer4, (feat, view)))
        h = torch.relu(self.layer5(h))
        return torch.cat([self.layer6(h), sigma], dim=-1)


class ReplicateNeRFModel(_NeRFMLP):
    """The small NeRF of the paper's supplement
    (``dexnerf_tpu/models/mlp.py:169-196``): ``layer1``, ``layer2`` (ReLU),
    a feature ``layer3`` and σ ``fc_alpha`` from the trunk, then ``layer4``
    on ``(feat, view)``, ``layer5`` (ReLU each) and ``fc_rgb``. Needs
    viewdirs; ``num_layers`` is accepted and unused, as in JAX."""

    flax_order = ("layer1", "layer2", "layer3", "fc_alpha", "layer4", "layer5", "fc_rgb")

    def __init__(
        self,
        hidden_size: int = 256,
        num_layers: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        use_viewdirs: bool = True,
    ):
        super().__init__()
        _needs_viewdirs("ReplicateNeRFModel", use_viewdirs)
        self._set_encodings(num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
                            include_input_dir, use_viewdirs)
        H = self.hidden_size = hidden_size
        self.layer1 = nn.Linear(self.dim_xyz, H)
        self.layer2 = nn.Linear(H, H)
        self.layer3 = nn.Linear(H, H)
        self.fc_alpha = nn.Linear(H, 1)
        self.layer4 = nn.Linear(H + self.dim_dir, H // 2)
        self.layer5 = nn.Linear(H // 2, H // 2)
        self.fc_rgb = nn.Linear(H // 2, 3)

    def forward(self, xyz: torch.Tensor, view: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self.layer1(xyz))
        h = torch.relu(self.layer2(h))
        feat = self.layer3(h)
        alpha = self.fc_alpha(h)
        y = torch.relu(dense(self.layer4, (feat, view)))
        y = torch.relu(self.layer5(y))
        return torch.cat([self.fc_rgb(y), alpha], dim=-1)


class PaperNeRFModel(_NeRFMLP):
    """The paper's 8x256 NeRF (``dexnerf_tpu/models/mlp.py:199-239``),
    hard-coded as in JAX (``num_layers``, ``hidden_size`` and
    ``skip_connect_every`` are accepted and unused): ``layers_xyz.0-7``
    (ReLU each; ``layers_xyz.4`` on ``(xyz, h)``), ``fc_feat``, σ
    ``fc_alpha`` from the feature, then ``layers_dir.0`` on
    ``(feat, view)`` (on ``feat`` alone without viewdirs), ``layers_dir.1``,
    ``layers_dir.2`` (ReLU each) and ``fc_rgb``. The reference's unused
    fourth ``layers_dir`` layer is not built, as in JAX."""

    flax_order = (
        *(f"layers_xyz.{i}" for i in range(8)), "fc_feat", "fc_alpha",
        *(f"layers_dir.{i}" for i in range(3)), "fc_rgb",
    )

    def __init__(
        self,
        num_layers: int = 8,
        hidden_size: int = 256,
        skip_connect_every: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        use_viewdirs: bool = True,
    ):
        super().__init__()
        self._set_encodings(num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
                            include_input_dir, use_viewdirs)
        self.num_layers, self.hidden_size = 8, 256
        self.layers_xyz = nn.ModuleList(
            nn.Linear(self.dim_xyz + 256 if i == 4 else (self.dim_xyz if i == 0 else 256), 256)
            for i in range(8)
        )
        self.fc_feat = nn.Linear(256, 256)
        self.fc_alpha = nn.Linear(256, 1)
        self.layers_dir = nn.ModuleList([
            nn.Linear(256 + (self.dim_dir if use_viewdirs else 0), 128),
            nn.Linear(128, 128),
            nn.Linear(128, 128),
        ])
        self.fc_rgb = nn.Linear(128, 3)

    def forward(self, xyz: torch.Tensor, view: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = xyz
        for i, layer in enumerate(self.layers_xyz):
            h = torch.relu(dense(layer, (xyz, h)) if i == 4 else layer(h))
        feat = self.fc_feat(h)
        alpha = self.fc_alpha(feat)
        parts = (feat, view) if self.use_viewdirs else (feat,)
        h = torch.relu(dense(self.layers_dir[0], parts))
        for layer in self.layers_dir[1:]:
            h = torch.relu(layer(h))
        return torch.cat([self.fc_rgb(h), alpha], dim=-1)


class FlexibleNeRFModel(_NeRFMLP):
    """Configurable-depth NeRF MLP (``dexnerf_tpu/models/mlp.py:242-303``):
    ``layer1`` without activation, a ReLU trunk ``layers_xyz.*`` with skip
    concats ``(h, xyz)``, then with viewdirs ``fc_alpha`` on the trunk
    output and ``fc_feat -> layers_dir.0 -> fc_rgb`` for rgb, without them
    one ``fc_out`` layer -> raw. Parameters are f32; ``dtype`` (the
    config's ``models.*.compute_dtype``) is the plain path's compute dtype,
    as JAX's ``Dense(dtype=)``: inputs, kernels and biases are cast to it
    for each layer and raw goes back to f32. The fused kernels ignore it
    (``nerf.pallas_compute_dtype`` sets theirs), as in JAX."""

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
        dtype="float32",
    ):
        super().__init__()
        self._set_encodings(num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz,
                            include_input_dir, use_viewdirs)
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_connect_every = skip_connect_every
        self.compute_dtype = compute_dtype_of(dtype)
        num_trunk = num_layers - 1
        self.skips = skip_positions(num_trunk, skip_connect_every)
        H = hidden_size
        # registration order = the reference's (nerf/models.py:207-228)
        self.layer1 = nn.Linear(self.dim_xyz, H)
        self.layers_xyz = nn.ModuleList(
            nn.Linear(H + self.dim_xyz if i in self.skips else H, H)
            for i in range(num_trunk)
        )
        trunk = ("layer1", *(f"layers_xyz.{i}" for i in range(num_trunk)))
        if use_viewdirs:
            self.layers_dir = nn.ModuleList([nn.Linear(H + self.dim_dir, H // 2)])
            self.fc_alpha = nn.Linear(H, 1)
            self.fc_rgb = nn.Linear(H // 2, 3)
            self.fc_feat = nn.Linear(H, H)
            self.flax_order = (*trunk, "fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb")
        else:
            self.fc_out = nn.Linear(H, 4)
            self.flax_order = (*trunk, "fc_out")

    def forward(self, xyz: torch.Tensor, view: Optional[torch.Tensor] = None, *,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``xyz``: [..., S, dim_xyz]; ``view`` (with viewdirs): [..., S,
        dim_dir] or the per-ray [..., dim_dir]. ``dtype`` overrides the
        model's compute dtype for this call (the kernels' plain versions
        run at their own)."""
        dtype = self.compute_dtype if dtype is None else dtype
        if dtype != torch.float32:
            return self._forward_cast(xyz, view, dtype)
        if self.use_viewdirs and view.ndim < xyz.ndim:
            view = view[..., None, :].expand(*xyz.shape[:-1], view.shape[-1])
        h = self.layer1(xyz)
        for i, layer in enumerate(self.layers_xyz):
            if i in self.skips:
                h = torch.relu(layer(torch.cat([h, xyz], dim=-1)))
            else:
                h = torch.relu(layer(h))
        if not self.use_viewdirs:
            return self.fc_out(h)
        feat = torch.relu(self.fc_feat(h))
        alpha = self.fc_alpha(h)
        y = torch.relu(self.layers_dir[0](torch.cat([feat, view], dim=-1)))
        rgb = self.fc_rgb(y)
        return torch.cat([rgb, alpha], dim=-1)

    def _forward_cast(self, xyz, view, dtype):
        """JAX's ``FlexibleNeRFModel.__call__`` at a compute dtype other
        than f32: every layer through :func:`dense` in ``dtype``."""
        xyz = xyz.to(dtype)
        h = dense(self.layer1, (xyz,), dtype)
        for i, layer in enumerate(self.layers_xyz):
            h = torch.relu(dense(layer, (h, xyz) if i in self.skips else (h,), dtype))
        if not self.use_viewdirs:
            return dense(self.fc_out, (h,), dtype).float()
        feat = torch.relu(dense(self.fc_feat, (h,), dtype))
        alpha = dense(self.fc_alpha, (h,), dtype)
        y = torch.relu(dense(self.layers_dir[0], (feat, view.to(dtype)), dtype))
        rgb = dense(self.fc_rgb, (y,), dtype)
        return torch.cat([rgb, alpha], dim=-1).float()
