"""Fully fused render pass: PE -> MLP -> alpha compositing -> Dex depth.

Counterpart of ``dexnerf_tpu/ops/fused_render.py``, with its
``compute_dtype`` (float32 or bfloat16, default float32 as in JAX). On a
CUDA tensor, :func:`fused_render` launches a hand-written kernel built by
``ops/_build.py``, both on the tensor cores with persistent CTAs walking the
work plan :func:`render_plan`: ``ops/csrc/fused_render.cu`` (split-TF32
``wgmma``: every f32 operand as hi + lo, three products each, f32
accumulators) at float32, ``ops/csrc/fused_render_bf16.cu`` (bf16
``wgmma``, f32 chain) at bfloat16. A model wider than 128 (:func:`is_wide`)
takes each source's wide route (the layers in shared memory:
``ops/csrc/mlp_wide_bf16.cuh``, ``ops/csrc/mlp_wide_tf32.cuh``). Widths:
any up to :data:`MAX_HIDDEN` at float32 and up to :data:`MAX_HIDDEN_BF16` at
bfloat16 (:func:`check_width`). On a CPU tensor it runs
:func:`fused_render_reference`, the plain PyTorch version of the same
contract. There is no fallback between
them: a CUDA call that cannot launch its dtype's kernel raises.

``launches`` counts kernel launches of either dtype, ``launches_bf16``
those of the bf16 kernel, ``launches_wide`` those of its wide route and
``launches_wide_f32`` those of the f32 kernel's wide route (+1 per launch,
nowhere else), so a run can show which kernel its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dexnerf_tpu_torch.core.encoding import frequency_bands, positional_encoding
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
from dexnerf_tpu_torch.core.volrend import (
    VolumeRenderOutputs,
    composite,
    concat_outputs,
    ray_dists,
)
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderResult, RenderSettings

launches = 0  # kernel-1 launches of either dtype
launches_bf16 = 0  # of which the bf16 route's (narrow or wide)
launches_wide = 0  # of which the wide bf16 kernel's
launches_wide_f32 = 0  # of which the wide f32 kernel's

# limits of both routes' kernels (kMax*)
MAX_LAYERS = 40
MAX_FREQ = 16
MAX_THRESHOLDS = 64
MAX_SAMPLES = 256
NARROW_HIDDEN = 128  # padded widths of the narrow tiles; wider ones take the wide routes
# the bf16 route's widths: the largest padded width whose wide plans fit
# (wide_fits at the kernels' largest encodings; kWideMaxHidden)
MAX_HIDDEN_BF16 = 576
# the float32 route's widths: the largest padded width whose wide plans fit
# (tf32_wide_fits at the kernels' largest encodings; kWtMaxHidden)
MAX_HIDDEN = 608
SHARED_BYTES_LIMIT = 232448  # per block on Hopper
# of ops/csrc/fused_render_bf16.cu (kTile, kKc, kMaxUnitRows, kMaxRpu, kCons)
BF16_TILE = 64
BF16_KCHUNK = 64
BF16_MAX_ROWS = 256
BF16_MAX_RPU = 16
BF16_WORKERS = 3
# of ops/csrc/fused_render.cu, the float32 route (kKc, kCons; its tile and
# unit limits are the bf16 route's)
TF32_KCHUNK = 32
TF32_WORKERS = 2
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _layers(model: FlexibleNeRFModel):
    """The model's linear layers in the kernel's consumption order."""
    return [
        model.layer1,
        *model.layers_xyz,
        model.fc_feat,
        model.fc_alpha,
        model.layers_dir[0],
        model.fc_rgb,
    ]


def _pack_f32(tensors) -> Tuple[torch.Tensor, List[int]]:
    """``tensors`` flattened into one float32 buffer, each starting on a
    16-byte boundary; returns the buffer and their offsets in floats."""
    chunks, offsets, pos = [], [], 0
    for t in tensors:
        pad = -pos % 4
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.float32, device=t.device))
            pos += pad
        offsets.append(pos)
        flat = t.reshape(-1).to(torch.float32)
        chunks.append(flat)
        pos += flat.numel()
    return torch.cat(chunks), offsets


def pack_flex_weights(
    model: FlexibleNeRFModel, device=None
) -> Tuple[torch.Tensor, List[int]]:
    """The f32 FMA kernels' weight layout (the f32 routes of kernels 2-4;
    it replaces ``dexnerf_tpu/ops/fused_mlp.py::split_flex_params``): one
    flat float32 buffer holding, per layer in :func:`_layers` order, the kernel
    ``[in, out]`` row-major (the transpose of ``nn.Linear.weight``) and then
    the bias, each starting on a 16-byte boundary. Returns the buffer and
    the offsets ``[w0, b0, w1, b1, ...]`` in floats."""
    flat, offsets = _pack_f32(
        t for lin in _layers(model) for t in (lin.weight.detach().t(), lin.bias.detach()))
    return flat.to(device), offsets


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _k_chunks(w: torch.Tensor, k: int, n: Optional[int] = None,
              kc: int = BF16_KCHUNK) -> torch.Tensor:
    """``w`` [N, K] zero-padded to ``n`` rows (default N) and ``k`` (a
    multiple of ``kc``) columns, as flat [k/kc, n, kc] K-chunks in wgmma's
    128 B-swizzled layout (a row of a chunk is 128 bytes: 64 bf16 or 32
    f32): in row r of a chunk, the 16-byte group j (columns j kc/8 ..
    (j + 1) kc/8 - 1) is stored at group j ^ (r % 8)."""
    n = w.shape[0] if n is None else n
    w = F.pad(w, (0, k - w.shape[1], 0, n - w.shape[0]))
    groups = w.reshape(n, k // kc, 8, kc // 8)
    swz = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)  # [n, 8]
    groups = groups[torch.arange(n)[:, None, None], torch.arange(k // kc)[None, :, None],
                    swz[:, None, :]]
    return groups.transpose(0, 1).reshape(-1)


def bf16_hidden(hidden: int) -> int:
    """The width the bf16 kernels compute at: ``hidden`` zero-padded to a
    multiple of 32 (the narrow tile's instances: 32, 64, 96 and 128, each a
    wgmma width with one for the viewdir layer's half; the wide route takes
    every multiple of 32 above, up to :data:`MAX_HIDDEN_BF16`). The padding
    is exact: a padded unit computes ReLU(0 + 0) = 0 and meets zero weight
    rows."""
    return _round_up(hidden, 32)


def is_wide(model: FlexibleNeRFModel) -> bool:
    """Whether the kernels of either dtype run ``model`` on their wide
    route (``ops/csrc/mlp_wide_bf16.cuh``, ``ops/csrc/mlp_wide_tf32.cuh``:
    padded widths above 128)."""
    return bf16_hidden(model.hidden_size) > NARROW_HIDDEN


def check_width(hidden: int, compute_dtype, what: str) -> None:
    """The widths the kernels take: any up to :data:`MAX_HIDDEN` at float32
    and up to :data:`MAX_HIDDEN_BF16` at bfloat16 (both computed at
    :func:`bf16_hidden`); wider ones, which JAX takes, are ROADMAP Queue 2
    item 6c."""
    if hidden < 1:
        raise ValueError(f"hidden_size {hidden}: {what} takes widths from 1")
    f32 = compute_dtype == torch.float32
    top, name = (MAX_HIDDEN, "float32") if f32 else (MAX_HIDDEN_BF16, "bfloat16")
    if bf16_hidden(hidden) > top:
        raise ValueError(
            f"hidden_size {hidden}: {what} takes widths up to {top} at {name} (the wide "
            "routes' shared-memory plans; wider is ROADMAP Queue 2 item 6c)")


# of ops/csrc/mlp_wide_bf16.cuh (kWide*)
WIDE_BLOCK = 64  # columns of a column block (kWideBlock)
WIDE_STAGE = WIDE_BLOCK * 128
WIDE_MAX_CONS = 2
WIDE_MAX_STAGES = 16
WIDE_MIN_STAGES = 4
WIDE_SPAN = 4  # k16 steps a fresh accumulator in wide_product (kWideSpan)


def wide_plan(cons_bytes: int) -> Optional[Tuple[int, int, int]]:
    """(consumers, ring stages, shared bytes) of a wide kernel whose
    consumers take ``cons_bytes`` each (``wide_plan`` there): the most
    consumers, then the most stages that fit; None if none fits."""
    for cons in range(WIDE_MAX_CONS, 0, -1):
        for ns in range(WIDE_MAX_STAGES, WIDE_MIN_STAGES - 1, -1):
            total = 1024 + ns * (WIDE_STAGE + 16) + cons * cons_bytes
            if total <= SHARED_BYTES_LIMIT:
                return cons, ns, total
    return None


def wide_cons_bytes(hp: int, kx: int, dd: int, n_samples: Optional[int] = None) -> dict:
    """Each wide kernel's bytes a consumer at padded width ``hp`` with ``kx``
    encoding K-chunks (``*_cons_bytes`` there): the training forward (with
    two layers' mask words), the chain (its tiles, column sums and two
    products' mask words) and, for ``n_samples``, the render kernel on its
    plan's unit."""
    act = 2 * -(-hp // BF16_KCHUNK) * BF16_TILE * 128

    def a1024(x):
        return _round_up(x, 1024)

    words = 2 * -(-hp // 64) * 512  # two layers' (or products') mask words
    out = {"forward": a1024(act + kx * BF16_TILE * 128 + BF16_TILE * 16 + words),
           "chain": a1024(act + 16 * hp + words)}
    if n_samples is not None:
        rp = render_plan(1, n_samples, 1)
        out["render"] = a1024(act + kx * BF16_TILE * 128 + rp.rows_per_unit * 24
                              + rp.rays_per_unit * (hp // 2 + dd) * 4)
    return out


def wide_fits(hp: int, kx: int, dd: int) -> bool:
    """Whether every wide kernel's plan fits at padded width ``hp`` for
    every number of samples the render kernel takes."""
    return all(wide_plan(b) is not None
               for S in range(1, MAX_SAMPLES + 1)
               for b in wide_cons_bytes(hp, kx, dd, S).values())


# of ops/csrc/mlp_wide_tf32.cuh (kWt*) and the f32 kernels (kMaxDx, kMaxRpu)
TF32_WIDE_MAX_CONS = 2
TF32_CHAIN_PIECE_ROWS = 64  # the wide chain's pieces (kChainPieceRows there)
TF32_WIDE_MAX_STAGES = 8
TF32_WIDE_MIN_STAGES = 2
TF32_MAX_KX = 4  # xyz encodings up to 128 wide: four 32-wide K-chunks


def tf32_wide_plan(cons_bytes: int, bmax_first: int = 128
                   ) -> Optional[Tuple[int, int, int, int]]:
    """(consumers, piece rows, ring stages, shared bytes) of a wide f32
    kernel whose consumers take ``cons_bytes`` each (``wt_plan`` there): the
    most consumers, then the largest pieces of at most ``bmax_first`` rows
    (128, else 64; the chain's 64, ``TF32_CHAIN_PIECE_ROWS``), then the most
    stages that fit (a stage: a piece's hi and lo halves); None if none
    fits."""
    for cons in range(TF32_WIDE_MAX_CONS, 0, -1):
        for bmax in range(bmax_first, 63, -64):
            for ns in range(TF32_WIDE_MAX_STAGES, TF32_WIDE_MIN_STAGES - 1, -1):
                total = 1024 + ns * (2 * bmax * 128 + 16) + cons * cons_bytes
                if total <= SHARED_BYTES_LIMIT:
                    return cons, bmax, ns, total
    return None


def tf32_wide_cons_bytes(hp: int, kx: int, n_samples: Optional[int] = None) -> dict:
    """Each wide f32 kernel's bytes a consumer at padded width ``hp`` with
    ``kx`` 32-wide encoding K-chunks (``*_cons_bytes`` there): the training
    forward (its input and encoding tiles, f32 [features][64], and the
    tile's logits), the chain (its input tile, the column sums and the
    ray's sums) and, for ``n_samples``, the render kernel on its plan's
    unit (the tiles and the unit's z, dists, sigma and rgb rows)."""
    def tile(n):
        return n * 64 * 4

    out = {"forward": _round_up(tile(hp) + tile(kx * TF32_KCHUNK) + 64 * 16, 16),
           "chain": _round_up(tile(hp) + 5 * (hp // 2) * 4, 16)}
    if n_samples is not None:
        rows = render_plan(1, n_samples, 1).rows_per_unit
        out["render"] = _round_up(tile(hp) + tile(kx * TF32_KCHUNK) + rows * 24, 16)
    return out


def tf32_wide_fits(hp: int, kx: int = TF32_MAX_KX) -> bool:
    """Whether every wide f32 kernel's plan fits at padded width ``hp`` for
    every number of samples the render kernel takes."""
    return all(tf32_wide_plan(b, TF32_CHAIN_PIECE_ROWS if name == "chain" else 128) is not None
               for S in range(1, MAX_SAMPLES + 1)
               for name, b in tf32_wide_cons_bytes(hp, kx, S).items())


def _pad_vec(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, n - t.shape[-1]))


def _operands(model: FlexibleNeRFModel, w: dict, chunks, kc: int) -> List[torch.Tensor]:
    """The matmul operands of the parameters ``w`` (name -> tensor, the
    model's shapes) in the kernels' consumption order, each as
    ``chunks(weight [N, K], K padded, N padded)``: layer1; per trunk layer
    its h rows, then on a skip layer its xyz rows; fc_feat; the feat rows of
    layers_dir.0. Padded to Hp = :func:`bf16_hidden` rows (Hp/2 for the
    viewdir layer); K to a multiple of ``kc``."""
    H = model.hidden_size
    Hp = bf16_hidden(H)
    dxp, kh = _round_up(model.dim_xyz, kc), _round_up(Hp, kc)
    parts = [chunks(w["layer1.weight"], dxp, Hp)]
    for i in range(model.num_layers - 1):
        wi = w[f"layers_xyz.{i}.weight"]
        parts.append(chunks(wi[:, :H], kh, Hp))
        if i in model.skips:
            parts.append(chunks(wi[:, H:], dxp, Hp))
    parts.append(chunks(w["fc_feat.weight"], kh, Hp))
    parts.append(chunks(w["layers_dir.0.weight"][:, :H], kh, Hp // 2))
    return parts


def _aux(model: FlexibleNeRFModel, w: dict) -> Tuple[torch.Tensor, List[int]]:
    """The aux buffer of both routes' packs at Hp = :func:`bf16_hidden` and
    its offsets: the biases of layer1, of each trunk layer, of fc_feat and
    of layers_dir.0, then w_alpha [Hp], b_alpha, w_rgb [Hp/2, 3], b_rgb and
    the viewdir rows of layers_dir.0 [dd, Hp/2]."""
    H = model.hidden_size
    Hp = bf16_hidden(H)
    Hp2 = Hp // 2
    d0 = "layers_dir.0"
    return _pack_f32([
        _pad_vec(w["layer1.bias"], Hp),
        *(_pad_vec(w[f"layers_xyz.{i}.bias"], Hp) for i in range(model.num_layers - 1)),
        _pad_vec(w["fc_feat.bias"], Hp), _pad_vec(w[f"{d0}.bias"], Hp2),
        _pad_vec(w["fc_alpha.weight"], Hp), w["fc_alpha.bias"],
        F.pad(w["fc_rgb.weight"].t(), (0, 0, 0, Hp2 - H // 2)), w["fc_rgb.bias"],
        _pad_vec(w[f"{d0}.weight"][:, H:].t(), Hp2),
    ])


def _bf16_layout(model: FlexibleNeRFModel, w: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """:func:`pack_flex_weights_bf16`'s layout of the parameters ``w``
    (name -> tensor, the model's shapes) at the padded width, before any
    rounding: the float32 matmul operands as :func:`_k_chunks` in
    consumption order, the aux buffer and its offsets."""
    aux, offsets = _aux(model, w)
    return torch.cat(_operands(model, w, _k_chunks, BF16_KCHUNK)), aux, offsets


def tf32_feature_order(k: int) -> torch.Tensor:
    """The feature at each of ``k`` K positions of the float32 route's
    products (``ops/csrc/mlp_tile_tf32.cuh``): within each block of 8,
    positions 0-3 hold features 0, 2, 4, 6 and positions 4-7 features 1, 3,
    5, 7, the order in which a thread's accumulator columns 2q, 2q + 1 sit
    in wgmma's tf32 A fragment (positions q, q + 4)."""
    p = torch.arange(k)
    return (p & ~7) + 2 * (p & 3) + ((p & 7) >> 2)


def _tf32_chunks(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``w`` [N, K] as the float32 route's B operand before the split:
    padded to ``n`` rows and ``k`` columns, K in :func:`tf32_feature_order`,
    as [n, 32] swizzled K-chunks (:func:`_k_chunks`)."""
    w = F.pad(w, (0, k - w.shape[1], 0, n - w.shape[0]))[:, tf32_feature_order(k)]
    return _k_chunks(w, k, n, TF32_KCHUNK)


def _tf32_layout(model: FlexibleNeRFModel, w: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """:func:`pack_flex_weights_tf32`'s layout of the parameters ``w``
    before the split: the operands as :func:`_tf32_chunks` in consumption
    order, the aux buffer and its offsets."""
    aux, offsets = _aux(model, w)
    return torch.cat(_operands(model, w, _tf32_chunks, TF32_KCHUNK)), aux, offsets


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), its 13 low mantissa bits zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` = (tf32(x), tf32(x - hi)): x - hi is exact in float32,
    and hi + lo holds x to ~2^-22 of its magnitude."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# (layout function, model shape, device) -> gather plan: every packed entry
# as 1 + its index in the flat parameter vector (0: a zero of the padding)
_plans = {}


def gather_plan(layout, model: FlexibleNeRFModel, device) -> tuple:
    """``layout(model, w)`` (a function of the parameters ``w`` that only
    moves entries and pads with zeros) turned into index tensors on
    ``device``, once per model shape, so that a pack is one gather of the
    flat parameters (:func:`gather_params`) instead of one small op per
    layer. Returns the index tensors and any further outputs of
    ``layout``."""
    key = (layout, tuple((n, tuple(p.shape)) for n, p in model.named_parameters()),
           tuple(model.skips), str(device))
    if key not in _plans:
        w, pos = {}, 1
        for name, p in model.named_parameters():
            w[name] = torch.arange(pos, pos + p.numel(), dtype=torch.float32).reshape(p.shape)
            pos += p.numel()
        if pos >= 1 << 24:  # float32 holds the indices exactly below 2^24
            raise ValueError(f"{pos} parameters: too many for a float32 gather plan")
        out = layout(model, w)
        idx = tuple(t.to(torch.int64).to(device) for t in out if isinstance(t, torch.Tensor))
        _plans[key] = (*idx, *(v for v in out if not isinstance(v, torch.Tensor)))
    return _plans[key]


def gather_params(model: FlexibleNeRFModel, *idx: torch.Tensor) -> List[torch.Tensor]:
    """The model's parameters, float32, at each of the plan index tensors
    ``idx`` (0: zero)."""
    p0 = next(model.parameters())
    flat = torch.cat([p0.new_zeros(1)] + [p.detach().reshape(-1) for p in model.parameters()])
    flat = flat.to(torch.float32)
    return [flat[i] for i in idx]


def pack_flex_weights_bf16(
    model: FlexibleNeRFModel, device=None
) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The bf16 render kernel's weight layout (``split_flex_params`` at
    bfloat16), at the padded width Hp = :func:`bf16_hidden` (every padded
    row, column and bias is zero):

    * ``wq``, bf16: the matmul operands as [N, 64] K-chunks (rows of
      ``nn.Linear.weight``, N zero-padded to Hp or Hp/2, K zero-padded to a
      multiple of 64), each in wgmma's 128 B-swizzled layout
      (:func:`_k_chunks`), in the kernel's consumption order: layer1; per
      trunk layer its h rows, then on a skip layer its xyz rows; fc_feat;
      the feat rows of layers_dir.0. The kernel copies each chunk to shared
      memory as it is;
    * ``aux``, float32, at the returned offsets: the biases of layer1, of
      each trunk layer, of fc_feat and of layers_dir.0, then w_alpha [Hp],
      b_alpha, w_rgb [Hp/2, 3], b_rgb and the viewdir rows of layers_dir.0
      [dd, Hp/2] rounded to bf16 (the kernel folds them into a per-ray bias).

    Kernel 1 and the training forward (kernels 2-4) take the same pack. One
    gather of the parameters (:func:`gather_plan`).
    """
    dev = next(model.parameters()).device
    idx_wq, idx_aux, offsets = gather_plan(_bf16_layout, model, dev)
    with torch.no_grad():
        wq, aux = gather_params(model, idx_wq, idx_aux)
        wq = wq.to(torch.bfloat16)
        vd = offsets[model.num_layers + 6]
        n_vd = model.dim_dir * bf16_hidden(model.hidden_size) // 2
        aux[vd:vd + n_vd] = _bf16(aux[vd:vd + n_vd])
    return wq.to(device), aux.to(device), offsets


def pack_flex_weights_tf32(
    model: FlexibleNeRFModel, device=None
) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The float32 render kernel's weight layout, at the padded width Hp =
    :func:`bf16_hidden` (every padded row, column and bias is zero):

    * ``wq``, float32: the matmul operands in the consumption order of
      :func:`pack_flex_weights_bf16`, K zero-padded to a multiple of 32 and
      in :func:`tf32_feature_order`, as [N, 32] K-chunks in wgmma's
      128 B-swizzled layout; each chunk first as hi = tf32(w), then as lo =
      tf32(w - hi) (:func:`tf32_split`), one ring stage each. The kernel
      copies each stage to shared memory as it is;
    * ``aux``, float32, at the returned offsets: as
      :func:`pack_flex_weights_bf16`'s, unrounded (the viewdir rows make a
      per-ray f32 bias).

    One gather of the parameters (:func:`gather_plan`), then the split.
    """
    dev = next(model.parameters()).device
    idx_wq, idx_aux, offsets = gather_plan(_tf32_layout, model, dev)
    with torch.no_grad():
        wq, aux = gather_params(model, idx_wq, idx_aux)
        hi, lo = tf32_split(wq)
        # each chunk's hi stage, then its lo stage; the chunks of the last
        # operand (layers_dir.0's feat rows) have Hp/2 rows, the others Hp
        Hp = bf16_hidden(model.hidden_size)
        cut = wq.numel() - Hp // 2 * Hp
        parts = []
        for part, rows in ((slice(0, cut), Hp), (slice(cut, None), Hp // 2)):
            n = rows * TF32_KCHUNK
            parts.append(torch.stack([hi[part].view(-1, n), lo[part].view(-1, n)], 1).reshape(-1))
        wq = torch.cat(parts)
    return wq.to(device), aux.to(device), offsets


# model -> {pack function: ((each parameter's (data_ptr, version), device),
# its pack)}: packed once per parameter state (kernel 1's bf16 pack also
# serves the training forward), rebuilt when a parameter is replaced or
# changed in place
_packed = weakref.WeakKeyDictionary()


def _cached_pack(pack, model: FlexibleNeRFModel, device):
    key = (tuple((p.data_ptr(), p._version) for p in model.parameters()), str(device))
    packs = _packed.setdefault(model, {})
    hit = packs.get(pack)
    if hit is None or hit[0] != key:
        hit = packs[pack] = (key, pack(model, device))
    return hit[1]


def _cached_bf16_weights(model: FlexibleNeRFModel, device):
    return _cached_pack(pack_flex_weights_bf16, model, device)


def _cached_tf32_weights(model: FlexibleNeRFModel, device):
    return _cached_pack(pack_flex_weights_tf32, model, device)


def flex_forward_bf16(
    model: FlexibleNeRFModel, xyz: torch.Tensor, view: torch.Tensor
) -> torch.Tensor:
    """The model's forward under the JAX package's bf16 contract
    (``_forward_block_parts`` at ``compute_dtype=bfloat16``): every matmul
    operand of layer1, the trunk (h, and the xyz encoding on a skip
    layer), fc_feat and layers_dir.0 (feat and the viewdir encoding) is
    rounded to bf16 and the product taken in f32; bias, ReLU and the chain
    stay f32; the σ head reads the unrounded trunk output and the rgb head
    the f32 viewdir-layer output, both with f32 weights. ``view`` is the
    per-ray [..., dim_dir] encoding (its product is taken per ray)."""
    H = model.hidden_size
    xq = _bf16(xyz)
    h = F.linear(xq, _bf16(model.layer1.weight)) + model.layer1.bias
    for i, layer in enumerate(model.layers_xyz):
        w = _bf16(layer.weight)
        y = F.linear(_bf16(h), w[:, :H])
        if i in model.skips:
            y = y + F.linear(xq, w[:, H:])
        h = torch.relu(y + layer.bias)
    feat = torch.relu(F.linear(_bf16(h), _bf16(model.fc_feat.weight)) + model.fc_feat.bias)
    alpha = F.linear(h, model.fc_alpha.weight) + model.fc_alpha.bias
    lin = model.layers_dir[0]
    wd = _bf16(lin.weight)
    y_dir = F.linear(_bf16(view), wd[:, H:])
    if y_dir.ndim < feat.ndim:
        y_dir = y_dir[..., None, :]
    y = torch.relu(F.linear(_bf16(feat), wd[:, :H]) + y_dir + lin.bias)
    rgb = F.linear(y, model.fc_rgb.weight) + model.fc_rgb.bias
    return torch.cat([rgb, alpha], dim=-1)


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype {compute_dtype}: the fused kernels take torch.float32 "
            "or torch.bfloat16"
        )


@torch.no_grad()
def fused_render_reference(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    *,
    thresholds: Sequence[float] = (),
    white_background: bool = False,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    chunk: int = 8192,
) -> VolumeRenderOutputs:
    """Plain PyTorch version of the kernels' contract, ``chunk`` rays at a
    time: pts = o + d*z, PE, the model forward (at bfloat16 the rounded
    forward :func:`flex_forward_bf16`), and compositing with the given
    ``dists`` (disparity in the kernel's finite form). No autograd, like
    the kernels."""
    _check_compute_dtype(compute_dtype)
    # the model's own compute dtype is its plain path's, not the kernels'
    forward = functools.partial(model, dtype=torch.float32) if compute_dtype == torch.float32 \
        else (lambda xyz, view: flex_forward_bf16(model, xyz, view))
    parts = []
    for i in range(0, z_vals.shape[0], chunk):
        sl = slice(i, i + chunk)
        z = z_vals[sl]
        pts = origins[sl, None, :] + directions[sl, None, :] * z[..., None]
        xyz = positional_encoding(
            pts, model.num_encoding_fn_xyz, model.include_input_xyz, log_sampling_xyz
        )
        view = positional_encoding(
            viewdirs[sl], model.num_encoding_fn_dir, model.include_input_dir,
            log_sampling_dir,
        )
        parts.append(
            composite(
                forward(xyz, view), z, dists[sl],
                white_background=white_background,
                m_thres_cand=tuple(thresholds) or None,
            )
        )
    return concat_outputs(parts)


class RenderPlan(NamedTuple):
    """A render kernel's work plan for one pass: the rays cut into
    ``units`` units of ``rays_per_unit`` whole rays (the last may hold
    fewer), each computed as ``rows_per_unit`` MLP rows (a multiple of 64,
    one 64-row tile at a time); ``rows`` = units x rows_per_unit of which
    ``padded_rows`` are padding; ``grid`` persistent CTAs, whose ``workers``
    consumer warpgroups each (worker k b + c of CTA b, k = workers) take
    units w, w + k grid, ...."""

    rays_per_unit: int
    rows_per_unit: int
    units: int
    rows: int
    padded_rows: int
    grid: int
    workers: int = BF16_WORKERS


def render_plan(n_rays: int, n_samples: int, ctas: int,
                workers: int = BF16_WORKERS) -> RenderPlan:
    """The work plan of a render kernel (ops/csrc/fused_render_bf16.cu, 3
    workers a CTA; ops/csrc/fused_render.cu, ``workers`` = TF32_WORKERS)
    for ``n_rays`` rays of ``n_samples`` on a card that holds ``ctas`` CTAs
    at once. The rays per unit (at most 16, at most 256 rows) are those with
    the fewest padded rows per ray; on a tie the largest unit of at most 128
    rows (fewer unit prologues and compositing rounds), else the smallest.
    S = 64 gives 2 rays in 128 rows, S = 128 one ray, S = 100 one ray in 128
    rows (28 padded), S = 8 16 rays. One CTA per ``workers`` units, at most
    ``ctas``, so that a small frame leaves no CTA idle."""
    if not 1 <= n_samples <= MAX_SAMPLES:
        raise ValueError(f"{n_samples} samples per ray: the kernel takes 1..{MAX_SAMPLES}")
    best = None
    for r in range(1, min(BF16_MAX_RPU, BF16_MAX_ROWS // n_samples) + 1):
        rows = _round_up(r * n_samples, BF16_TILE)
        small = rows <= 2 * BF16_TILE
        # padded rows per ray (compared as fractions), then the tie-break
        key = ((rows - r * n_samples) / r, 0 if small else 1, -r if small else r)
        if best is None or key < best[0]:
            best = (key, r, rows)
    _, rpu, rows_u = best
    units = -(-n_rays // rpu)
    grid = min(ctas, -(-units // workers))
    return RenderPlan(rpu, rows_u, units, units * rows_u, units * rows_u - n_rays * n_samples,
                      grid, workers)


def plan_workers(plan: RenderPlan) -> List[List[int]]:
    """The units of each worker (consumer warpgroup c of CTA b is worker
    k b + c, k = plan.workers), in the order the kernel computes them."""
    n = plan.workers * plan.grid
    return [list(range(w, plan.units, n)) for w in range(n)]


# (C entry, its shape arguments, device) -> (CTAs per SM, shared-memory bytes
# per CTA, weight ring stages[, consumer warpgroups])
_residency = {}


def _occupancy(entry: str, *args: int, n_out: int = 3) -> tuple:
    """The residency that the C query ``entry`` reports for a render kernel
    at the shape ``args``, once per shape and device."""
    from dexnerf_tpu_torch.ops._build import check, load_library

    key = (entry, *args, torch.cuda.current_device())
    if key not in _residency:
        lib = load_library()
        out = [ctypes.c_int(0) for _ in range(n_out)]
        check(lib, getattr(lib, entry)(*args, *map(ctypes.byref, out)), f"{entry} query")
        if out[0].value < 1:
            raise RuntimeError(f"{entry}: the render kernel does not fit on an SM "
                               f"({out[1].value} bytes of shared memory)")
        _residency[key] = tuple(o.value for o in out)
    return _residency[key]


def _kernel_shape(model: FlexibleNeRFModel, n_samples: int) -> tuple:
    rpu = render_plan(1, n_samples, 1).rays_per_unit
    return (bf16_hidden(model.hidden_size), model.dim_xyz, model.dim_dir, n_samples, rpu,
            model.num_layers - 1)


def bf16_occupancy(model: FlexibleNeRFModel, n_samples: int) -> Tuple[int, int, int]:
    """(CTAs per SM, shared-memory bytes per CTA, weight ring stages) of the
    bf16 kernel for ``model`` at ``n_samples`` per ray, as the CUDA runtime
    and the launcher report them (needs the card)."""
    return _occupancy("dexnerf_fused_render_bf16_occupancy", *_kernel_shape(model, n_samples),
                      sum(1 << i for i in model.skips))


def wide_occupancy(model: FlexibleNeRFModel, n_samples: int) -> Tuple[int, int, int, int]:
    """(CTAs per SM, shared-memory bytes per CTA, weight ring stages,
    consumer warpgroups) of the wide bf16 kernel (padded widths above 128)
    for ``model`` at ``n_samples`` per ray (needs the card); its consumers
    are the render plan's workers a CTA."""
    return _occupancy("dexnerf_fused_render_bf16_wide_occupancy",
                      *_kernel_shape(model, n_samples), n_out=4)


def tf32_occupancy(model: FlexibleNeRFModel, n_samples: int) -> Tuple[int, int, int]:
    """The same for the float32 route's kernel (ops/csrc/fused_render.cu)."""
    return _occupancy("dexnerf_fused_render_occupancy", *_kernel_shape(model, n_samples))


def tf32_wide_occupancy(model: FlexibleNeRFModel, n_samples: int) -> Tuple[int, int, int, int, int]:
    """(CTAs per SM, shared-memory bytes per CTA, weight ring stages,
    consumer warpgroups, floats of a worker's buffer) of the wide f32 kernel
    (padded widths above 128) for ``model`` at ``n_samples`` per ray (needs
    the card); its consumers are the render plan's workers a CTA."""
    return _occupancy("dexnerf_fused_render_wide_occupancy", *_kernel_shape(model, n_samples),
                      n_out=5)


def fusable(model) -> bool:
    """Whether the kernels take ``model``: a FlexibleNeRF with viewdirs
    (JAX's ``isinstance(m, FlexibleNeRFModel) and m.use_viewdirs``)."""
    return isinstance(model, FlexibleNeRFModel) and model.use_viewdirs


def fusable_pair(coarse, fine) -> bool:
    """JAX's rule for the kernels that take both passes (the fused render,
    the fused loss): the coarse model :func:`fusable`, the fine one (if
    any) a FlexibleNeRF."""
    return fusable(coarse) and (fine is None or isinstance(fine, FlexibleNeRFModel))


def check_fusable(model, what: str) -> None:
    """The kernels' guard for direct callers: they take a :func:`fusable`
    model (the loop's selection sends every other model to the plain path
    before any launch, as JAX's does)."""
    if model is None or fusable(model):
        return
    if not isinstance(model, FlexibleNeRFModel):
        raise TypeError(f"{what} takes FlexibleNeRFModel, not {type(model)}")
    if not model.use_viewdirs:
        raise ValueError(f"{what} takes a FlexibleNeRFModel with viewdirs")


def _check_inputs(model, dev, tensors, N: int, S: int, T: int, compute_dtype) -> None:
    check_fusable(model, "the fused render kernel")
    for name, t, shape in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 tensor on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    # every width up to the dtype's limit, computed at bf16_hidden(H); the
    # shared-memory requests are checked by the launch
    check_width(model.hidden_size, compute_dtype, "the fused render kernel")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"{S} samples per ray: the kernel takes 1..{MAX_SAMPLES}")
    if T > MAX_THRESHOLDS:
        raise ValueError(f"{T} thresholds: the kernel takes at most {MAX_THRESHOLDS}")
    nt = model.num_layers - 1
    if nt + 5 > MAX_LAYERS or nt > 31:
        raise ValueError(f"{model.num_layers} layers: too deep for the kernel")
    if max(model.num_encoding_fn_xyz, model.num_encoding_fn_dir) > MAX_FREQ:
        raise ValueError(f"the kernel takes at most {MAX_FREQ} PE frequencies")


def _host_array(ctype, values):
    arr = (ctype * max(1, len(values)))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _launch(
    model, origins, directions, viewdirs, z_vals, dists, *, thresholds,
    white_background, log_sampling_xyz, log_sampling_dir, compute_dtype,
) -> VolumeRenderOutputs:
    global launches, launches_bf16, launches_wide, launches_wide_f32
    from dexnerf_tpu_torch.ops._build import check, load_library

    N, S = z_vals.shape
    T = len(thresholds)
    dev = z_vals.device
    _check_inputs(
        model,
        dev,
        [
            ("origins", origins, (N, 3)),
            ("directions", directions, (N, 3)),
            ("viewdirs", viewdirs, (N, 3)),
            ("z_vals", z_vals, (N, S)),
            ("dists", dists, (N, S)),
        ],
        N, S, T, compute_dtype,
    )
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    rgb = torch.empty((N, 3), **f32)
    disp = torch.empty((N,), **f32)
    acc = torch.empty((N,), **f32)
    depth = torch.empty((N,), **f32)
    w = torch.empty((N, S), **f32)
    dex = torch.empty((T, N), **f32) if T else None
    bx = frequency_bands(model.num_encoding_fn_xyz, log_sampling_xyz).tolist()
    bd = frequency_bands(model.num_encoding_fn_dir, log_sampling_dir).tolist()
    # host arrays, copied into the launch's parameter block by the call;
    # the *_arr names keep them alive until then
    bx_arr, bx_ptr = _host_array(ctypes.c_float, bx)
    bd_arr, bd_ptr = _host_array(ctypes.c_float, bd)
    th_arr, th_ptr = _host_array(ctypes.c_float, [float(m) for m in thresholds])
    skip_mask = sum(1 << i for i in model.skips)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = (origins.data_ptr(), directions.data_ptr(), viewdirs.data_ptr(),
           z_vals.data_ptr(), dists.data_ptr())
    outs = (rgb.data_ptr(), disp.data_ptr(), acc.data_ptr(), depth.data_ptr(),
            w.data_ptr(), dex.data_ptr() if dex is not None else None)
    pe = (model.num_encoding_fn_xyz, int(model.include_input_xyz), bx_ptr,
          model.num_encoding_fn_dir, int(model.include_input_dir), bd_ptr, T, th_ptr)
    bf16 = compute_dtype == torch.bfloat16
    wide = is_wide(model)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the launcher picks the narrow or the wide kernel of the dtype by the width
    if bf16:
        wq, aux, offsets = _cached_bf16_weights(model, dev)
        if wide:
            ctas, _, _, cons = wide_occupancy(model, S)
            plan = render_plan(N, S, sms * ctas, cons)
        else:
            plan = render_plan(N, S, sms * bf16_occupancy(model, S)[0])
        entry, what = lib.dexnerf_fused_render_bf16, "fused_render bf16 kernel launch"
    else:
        wq, aux, offsets = _cached_tf32_weights(model, dev)
        if wide:  # a buffer of layer outputs and viewdir biases a worker
            ctas, _, _, cons, per_worker = tf32_wide_occupancy(model, S)
            plan = render_plan(N, S, sms * ctas, cons)
            wbuf = torch.empty(plan.grid * cons * per_worker, **f32)
            outs = (*outs, wbuf.data_ptr())
        else:
            plan = render_plan(N, S, sms * tf32_occupancy(model, S)[0], TF32_WORKERS)
            outs = (*outs, None)
        entry, what = lib.dexnerf_fused_render, "fused_render kernel launch"
    off_arr, off_ptr = _host_array(ctypes.c_int, offsets)
    code = entry(
        *ins, wq.data_ptr(), aux.data_ptr(), *outs,
        N, S, bf16_hidden(model.hidden_size), model.num_layers - 1, skip_mask,
        plan.rays_per_unit, plan.grid,
        *pe, off_ptr, int(bool(white_background)), stream,
    )
    check(lib, code, what)
    launches_wide += int(wide and bf16)
    launches_wide_f32 += int(wide and not bf16)
    launches_bf16 += int(bf16)
    launches += 1
    return VolumeRenderOutputs(
        rgb=rgb, disparity=disp, accumulation=acc, weights=w, depth=depth,
        depth_dex=dex,
    )


@torch.no_grad()
def fused_render(
    model: FlexibleNeRFModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    *,
    thresholds: Sequence[float] = (),
    white_background: bool = False,
    log_sampling_xyz: bool = True,
    log_sampling_dir: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> VolumeRenderOutputs:
    """One deterministic render pass over rays ``origins/directions/
    viewdirs`` [N, 3] at depths ``z_vals`` [N, S] with intervals ``dists``
    [N, S] (the counterpart of ``make_fused_render``'s render) at
    ``compute_dtype``. Returns [N]-shaped maps, weights [N, S] and
    ``depth_dex`` [T, N] (None when no thresholds). CUDA tensors go through
    the kernel of the dtype, CPU tensors through
    :func:`fused_render_reference`."""
    _check_compute_dtype(compute_dtype)
    kwargs = dict(
        thresholds=tuple(float(m) for m in thresholds),
        white_background=white_background,
        log_sampling_xyz=log_sampling_xyz,
        log_sampling_dir=log_sampling_dir,
        compute_dtype=compute_dtype,
    )
    if z_vals.device.type == "cuda":
        return _launch(model, origins, directions, viewdirs, z_vals, dists, **kwargs)
    if z_vals.device.type == "cpu":
        return fused_render_reference(
            model, origins, directions, viewdirs, z_vals, dists, **kwargs
        )
    raise ValueError(f"no fused render for device {z_vals.device}")


def make_fused_render_rays(
    coarse_model: FlexibleNeRFModel,
    fine_model: Optional[FlexibleNeRFModel],
    settings: RenderSettings,
    *,
    compute_dtype: torch.dtype = torch.float32,
):
    """Deterministic coarse->fine renderer over one ray batch with field
    evaluation and compositing in :func:`fused_render` at
    ``compute_dtype`` (the counterpart of ``make_fused_render_rays``): a
    ``rays_impl`` for ``render_image``, carrying its ``compute_dtype``.
    Stratified depths, the inverse-CDF resampling and the ray intervals
    stay plain PyTorch ([N, S]-sized)."""
    _check_compute_dtype(compute_dtype)
    for m in (coarse_model, fine_model):
        check_fusable(m, "the fused render kernel")
    s = settings.eval_variant()
    kw = dict(
        white_background=s.white_background,
        log_sampling_xyz=s.log_sampling_xyz,
        log_sampling_dir=s.log_sampling_dir,
        compute_dtype=compute_dtype,
    )

    def render(rays: RayBatch) -> RenderResult:
        o = rays.origins.contiguous()
        d = rays.directions.contiguous()
        v = rays.viewdirs.contiguous()
        z_vals = stratified_z_vals(rays.near, rays.far, s.num_coarse, lindisp=s.lindisp)
        coarse = fused_render(
            coarse_model, o, d, v, z_vals, ray_dists(z_vals, d), **kw
        )
        fine = None
        if fine_model is not None and s.num_fine > 0:
            z_merged, _ = hierarchical_z_vals(
                z_vals, coarse.weights, s.num_fine, det=True
            )
            fine = fused_render(
                fine_model, o, d, v, z_merged, ray_dists(z_merged, d),
                thresholds=s.m_thres_cand, **kw,
            )
        return RenderResult(coarse=coarse, fine=fine)

    render.compute_dtype = compute_dtype
    return render
