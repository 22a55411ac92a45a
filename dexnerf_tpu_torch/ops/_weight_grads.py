"""The weight-gradient half of the f32 training kernels, shared by the
field backward (``ops/fused_mlp_train.py``, kernel 3) and the fused train
loss (``ops/fused_train_loss.py``, kernel 4); their bf16 routes share
``ops/fused_train_loss.py::Bf16Gradients``.

Both pass kernels fill one activation/cotangent scratch (``Rows`` in
``ops/csrc/mlp_chain.cuh``) chunk of rays by chunk; :class:`WeightGradients`
owns that scratch and turns it into the gradient of every parameter with
the K-split dW launch (``dexnerf_train_dw``, one 128 x 128 tile and one
K-range per CTA, each into its own slot of partial sums) and the
fixed-order reduction of the slots (``dexnerf_train_reduce``): no atomics,
so two runs are bitwise equal.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel

# limits of ops/csrc/fused_train_loss.cu
MAX_ITEMS = 40
TILE = 128


class _GemmItem(ctypes.Structure):
    """Mirror of ``GemmItem``: one weight-gradient product."""

    _fields_ = [
        ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
        ("ld", ctypes.c_int64), ("k", ctypes.c_int64),
    ] + [
        (name, ctypes.c_int32)
        for name in ("m", "n", "m_tiles", "tile0", "w_off", "ldw", "col_off", "b_off")
    ]


class _GemmArgs(ctypes.Structure):
    _fields_ = [
        ("items", _GemmItem * MAX_ITEMS),
        ("partial", ctypes.c_void_p),
        ("n_params", ctypes.c_int64),
        ("n_items", ctypes.c_int32),
        ("n_splits", ctypes.c_int32),
        ("part0", ctypes.c_int32),
    ]


def pack_backward_weights(model: FlexibleNeRFModel, device=None) -> Tuple[torch.Tensor, list]:
    """The matrices the cotangent chain multiplies by, each ``[out, in]``
    row-major as ``nn.Linear.weight`` keeps it (the transpose of the
    forward pack), cut to the input columns that carry a gradient, each
    starting on a 16-byte boundary: ``fc_rgb`` [3, H/2], ``layers_dir.0``
    [H/2, :H], ``fc_feat`` with ``fc_alpha`` as one more row [H + 1, H],
    then ``layers_xyz.i`` [H, :H]. Returns the buffer and the offsets."""
    H = model.hidden_size
    mats = [
        model.fc_rgb.weight,
        model.layers_dir[0].weight[:, :H],
        torch.cat([model.fc_feat.weight, model.fc_alpha.weight], dim=0),
        *(lin.weight[:, :H] for lin in model.layers_xyz),
    ]
    chunks, offsets, pos = [], [], 0
    for m in mats:
        pad = -pos % 4
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.float32, device=m.device))
            pos += pad
        offsets.append(pos)
        flat = m.detach().reshape(-1).to(torch.float32)
        chunks.append(flat)
        pos += flat.numel()
    return torch.cat(chunks).to(device), offsets


def check_gemm_args_size(lib) -> None:
    if lib.dexnerf_train_args_size(1) != ctypes.sizeof(_GemmArgs):
        raise RuntimeError(
            f"_GemmArgs is {ctypes.sizeof(_GemmArgs)} bytes here but "
            f"{lib.dexnerf_train_args_size(1)} in the kernel library"
        )


def _param_offsets(model) -> Tuple[dict, int]:
    """Offset of every parameter in the flat gradient, in
    ``model.named_parameters()`` order, and the total count."""
    offs, pos = {}, 0
    for name, p in model.named_parameters():
        offs[name] = pos
        pos += p.numel()
    return offs, pos


def _scratch_rows(lib, model) -> dict:
    """The scratch layout as the kernel library defines it (``Rows``), in
    rows of ``k`` floats: the row counts ``act_rows``/``dlt_rows``, the
    first row of each named block, and the lists ``a`` (layer1's output,
    then the trunk's) and ``d`` (their cotangents, then feat's)."""
    from dexnerf_tpu_torch.ops._build import check

    nt = model.num_layers - 1
    buf = (ctypes.c_int * (2 * nt + 11))()
    check(lib, lib.dexnerf_train_rows(model.dim_xyz, model.hidden_size, nt, buf, len(buf)),
          "training scratch layout")
    names = ("act_rows", "dlt_rows", "e", "feat", "y", "dsig", "dy", "drgb")
    rows = dict(zip(names, buf))
    rows["a"] = list(buf[len(names):len(names) + nt + 1])
    rows["d"] = list(buf[len(names) + nt + 1:])
    return rows


def _gemm_args(items, partial, n_params: int, n_splits: int, part0: int):
    args = _GemmArgs()
    tile0 = 0
    for slot, (a, b, ld, k, m, n, w_off, ldw, col_off, b_off) in zip(args.items, items):
        m_tiles, n_tiles = -(-m // TILE), -(-n // TILE)
        slot.a, slot.b, slot.ld, slot.k = a, b, ld, k
        slot.m, slot.n, slot.m_tiles, slot.tile0 = m, n, m_tiles, tile0
        slot.w_off, slot.ldw, slot.col_off, slot.b_off = w_off, ldw, col_off, b_off
        tile0 += m_tiles * n_tiles
    args.partial = partial.data_ptr()
    args.n_params = n_params
    args.n_items, args.n_splits, args.part0 = len(items), n_splits, part0
    return args, tile0


class WeightGradients:
    """The scratch of one pass over ``n_rays`` rays of ``s_pad`` samples
    (padded to the 64-sample tile), run in chunks of ``chunk`` rays, and
    the launches that sum it into the gradient of every parameter of
    ``model``: after the pass kernel of chunk ``c`` has filled the scratch
    (``act``, ``dlt``, ``dir_enc``, ``dy_sum``), :meth:`chunk` launches its
    weight-gradient products; :meth:`reduce` then sums the chunks."""

    def __init__(self, lib, model: FlexibleNeRFModel, n_rays: int, chunk: int, s_pad: int, dev):
        self.lib, self.model, self.s_pad = lib, model, s_pad
        self.rows = _scratch_rows(lib, model)
        f32 = dict(dtype=torch.float32, device=dev)
        # reused by every chunk (all launches are on one stream)
        self.act = torch.empty(self.rows["act_rows"] * chunk * s_pad, **f32)
        self.dlt = torch.empty(self.rows["dlt_rows"] * chunk * s_pad, **f32)
        self.dir_enc = torch.empty(model.dim_dir * chunk, **f32)
        self.dy_sum = torch.empty(model.hidden_size // 2 * chunk, **f32)
        self.offs, self.n_params = _param_offsets(model)
        self.grad = torch.empty((self.n_params,), **f32)
        # K-splits of the dW products: about eight CTAs per SM in all (tiles
        # differ in cost; more, shorter CTAs even out the last wave)
        n_tiles = _gemm_args(self._items(1, 1), self.grad, self.n_params, 1, 0)[1]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.n_splits = max(1, min(256, 8 * sms // n_tiles))
        self.n_chunks = -(-n_rays // chunk)
        self.partial = torch.empty((self.n_chunks * self.n_splits * self.n_params,), **f32)

    def _items(self, k: int, rays: int):
        """The weight-gradient products of one chunk (``k`` scratch columns,
        ``rays`` rays) as (a, b, ld, K, M, N, w_off, ldw, col_off, b_off)."""
        model, rows, offs = self.model, self.rows, self.offs
        H, H2, nt = model.hidden_size, model.hidden_size // 2, model.num_layers - 1
        dx, dd = model.dim_xyz, model.dim_dir
        a, d = rows["a"], rows["d"]

        def act_row(r):
            return self.act.data_ptr() + 4 * r * k

        def dlt_row(r):
            return self.dlt.data_ptr() + 4 * r * k

        e = act_row(rows["e"])
        items = [(e, dlt_row(d[0]), k, k, dx, H, offs["layer1.weight"], dx, 0,
                  offs["layer1.bias"])]
        for i, lin in enumerate(model.layers_xyz):
            w, b = offs[f"layers_xyz.{i}.weight"], offs[f"layers_xyz.{i}.bias"]
            n_in = lin.in_features
            items.append((act_row(a[i]), dlt_row(d[i + 1]), k, k, H, H, w, n_in, 0, b))
            if i in model.skips:
                items.append((e, dlt_row(d[i + 1]), k, k, dx, H, w, n_in, H, -1))
        items += [
            (act_row(a[nt]), dlt_row(d[nt + 1]), k, k, H, H, offs["fc_feat.weight"], H, 0,
             offs["fc_feat.bias"]),
            (act_row(a[nt]), dlt_row(rows["dsig"]), k, k, H, 1, offs["fc_alpha.weight"], H, 0,
             offs["fc_alpha.bias"]),
            (act_row(rows["feat"]), dlt_row(rows["dy"]), k, k, H, H2,
             offs["layers_dir.0.weight"], H + dd, 0, offs["layers_dir.0.bias"]),
            (self.dir_enc.data_ptr(), self.dy_sum.data_ptr(), rays, rays, dd, H2,
             offs["layers_dir.0.weight"], H + dd, H, -1),
            (act_row(rows["y"]), dlt_row(rows["drgb"]), k, k, H2, 3, offs["fc_rgb.weight"], H2,
             0, offs["fc_rgb.bias"]),
        ]
        return items

    def chunk(self, c: int, rays: int, stream: int) -> None:
        """Launch the weight-gradient products of chunk ``c`` (``rays`` rays)."""
        from dexnerf_tpu_torch.ops._build import check

        items = self._items(rays * self.s_pad, rays)
        gargs, tiles = _gemm_args(items, self.partial, self.n_params, self.n_splits,
                                  c * self.n_splits)
        check(self.lib, self.lib.dexnerf_train_dw(ctypes.addressof(gargs), tiles, stream),
              "weight-gradient launch")

    def reduce(self, stream: int, loss_ray=None, loss=None) -> tuple:
        """Sum the chunks' slots (and ``loss_ray`` [N] into ``loss`` [] when
        given); the gradients in ``model.parameters()`` order, views of one
        flat buffer."""
        from dexnerf_tpu_torch.ops._build import check

        check(
            self.lib,
            self.lib.dexnerf_train_reduce(
                self.partial.data_ptr(), self.n_chunks * self.n_splits, self.n_params,
                self.grad.data_ptr(),
                None if loss_ray is None else loss_ray.data_ptr(),
                0 if loss_ray is None else loss_ray.numel(),
                None if loss is None else loss.data_ptr(), stream,
            ),
            "gradient reduce launch",
        )
        return tuple(
            self.grad[self.offs[name]:self.offs[name] + p.numel()].view_as(p)
            for name, p in self.model.named_parameters()
        )
