"""The weight-gradient half of the f32 training kernels, shared by the
field backward (``ops/fused_mlp_train.py``, kernel 3) and the fused train
loss (``ops/fused_train_loss.py``, kernel 4); their bf16 routes share
``ops/fused_train_loss.py::Bf16Gradients``.

Both pass kernels fill one activation/cotangent scratch (``Rows`` in
``ops/csrc/train_rows.cuh``: feature-major, row = feature, contiguous along
the chunk's samples) chunk of rays by chunk; :class:`WeightGradients` owns
that scratch and turns it into the gradient of every parameter with the
split-TF32 dW launch of ``ops/csrc/dw_tf32.cu`` (``dexnerf_dw_tf32``: TMA
boxes of 32 samples, ``wgmma`` on both operands' TF32 halves, by the plan
of :func:`tf32_dw_plan`; persistent CTAs, one per SM, each part of a unit
into its own slot of partial sums) and the fixed-order reduction of the
slots (``dexnerf_dw_tf32_reduce``): no atomics, so two runs are bitwise
equal. Above a width of 128 the plan's products are split to the kernel's
limits (:func:`_tf32_units`) and launched in parts of at most
:data:`TF32_MAX_UNITS` units (:func:`tf32_dw_parts`), one reduction over
all of them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel

# limits of ops/csrc/dw_tf32.cu (and dw_split.cuh: units a launch, launches a plan)
TF32_MAX_UNITS = 36
TF32_MAX_PARTS = 8
TF32_MAX_BOXES = 8
TF32_MAX_A_ROWS = 128    # two A boxes: one a consumer warpgroup
TF32_MAX_PART_ROWS = 128  # a part's B boxes: two
TF32_BOX_ROWS = 64       # rows of an operand box
TF32_BOX = 64 * 32 * 4   # bytes of a [64][32] f32 box
TF32_HEAD_BOX = 8 * 32 * 4
TF32_STAGE = 32          # samples of a stage: the K of one promotion
TF32_SMEM_MAX = 232448
# ring stages the dW kernel takes: at 8x128 three ran faster than four (the
# most that fit) and five (on smaller stages): perf_tools/dw_f32_variants.py
TF32_STAGES = 3
TF32_LO_BUFS = 2
ACT, DLT, DLT_HEAD = 0, 1, 2  # the kernel's tensor maps
TF32_MAPS = (("act", 64), ("dlt", 64), ("dlt", 8))  # each map's scratch and box rows
# a consumer warpgroup's parts (boxes of each) -> the kernel's shape code
TF32_SHAPES = {(): 0, (1,): 1, (2,): 2, (1, 1): 3, (2, 1): 4, (2, 2): 5}


def _param_offsets(model) -> Tuple[dict, int]:
    """Offset of every parameter in the flat gradient, in
    ``model.named_parameters()`` order, and the total count."""
    offs, pos = {}, 0
    for name, p in model.named_parameters():
        offs[name] = pos
        pos += p.numel()
    return offs, pos


def scratch_rows(model) -> dict:
    """The scratch layout (``Rows`` in ``ops/csrc/train_rows.cuh``) in rows
    of ``k`` floats: the row counts ``act_rows``/``dlt_rows``, the first row
    of each named block, and the lists ``a`` (layer1's output, then the
    trunk's) and ``d`` (their cotangents, then feat's). act: e (dx rows),
    a_0..a_nt, feat (H each), y (H/2); dlt: d_0..d_nt, feat (H each), sigma
    (1), y (H/2), rgb (3)."""
    dx, H, nt = model.dim_xyz, model.hidden_size, model.num_layers - 1
    feat = dx + (nt + 1) * H
    dsig = (nt + 2) * H
    return {"act_rows": feat + H + H // 2, "dlt_rows": dsig + 1 + H // 2 + 3, "e": 0,
            "feat": feat, "y": feat + H, "dsig": dsig, "dy": dsig + 1,
            "drgb": dsig + 1 + H // 2, "a": [dx + i * H for i in range(nt + 1)],
            "d": [i * H for i in range(nt + 2)]}


def _scratch_rows(lib, model) -> dict:
    """:func:`scratch_rows` as the kernel library defines it
    (``dexnerf_train_rows``)."""
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


# ---- the split-TF32 dW plan
class Tf32Part(NamedTuple):
    """One ``wgmma`` product of a consumer warpgroup: D[r][c] = sum_k
    A[r][k] B[c][k] over the operand boxes b..b + nb - 1 (N = 64 nb),
    written to ``base + r * ldw + c`` of the flat gradient for c < m_lim
    (and r below the warpgroup's ``n_lim``)."""

    b: int
    nb: int
    base: int
    ldw: int
    m_lim: int


class Tf32Wg(NamedTuple):
    """A consumer warpgroup's share of a unit: its A (cotangent) box, that
    box's valid rows, its parts."""

    a: int
    n_lim: int
    parts: Tuple[Tf32Part, ...]


class Tf32Head(NamedTuple):
    """A thin head on the CUDA cores: its ``rows`` cotangent rows (the
    unit's last box) times the boxes box0..box0 + nbox - 1, dW[c][m] at
    ``w + c * ldw + m`` (m < mlim), its bias at ``bias + c``."""

    rows: int
    box0: int
    nbox: int
    w: int
    ldw: int
    mlim: int
    bias: int


class Tf32Unit(NamedTuple):
    """Products read together. ``boxes`` in stage order, each (tensor map,
    first row): the ``n_a`` boxes of the cotangent block (A), the other
    ``n_op - n_a`` operand boxes (B), a head's operand boxes when they are
    no operand, the head's cotangent box last; ``a_rows`` and ``bias``: the
    cotangent block's valid rows and its bias's offset; one :class:`Tf32Wg`
    per consumer warpgroup; ``tx`` the bytes of a stage, ``cost`` its KB
    (the work split's unit)."""

    boxes: Tuple[Tuple[int, int], ...]
    n_a: int
    n_op: int
    a_rows: int
    bias: int
    head: Optional[Tf32Head]
    wgs: Tuple[Tf32Wg, Tf32Wg]
    tx: int
    cost: int


def _n_boxes(rows: int) -> int:
    return -(-rows // TF32_BOX_ROWS)


def _tf32_unit(a, blocks, head=None) -> Tf32Unit:
    """The unit of cotangent block ``a`` = (first row, rows, bias offset,
    -1 for none) against the activation ``blocks``, each (first row, rows, offset of its
    dW[0][0] in the flat gradient, row stride), and a ``head`` = (first
    cotangent row, rows, operand: a block's index or an activation block
    (first row, rows), dW offset, row stride, bias offset)."""
    a_row, a_rows, bias = a
    n_a = _n_boxes(a_rows)
    boxes = [(DLT, a_row + TF32_BOX_ROWS * i) for i in range(n_a)]
    first = []
    for row, rows, _, _ in blocks:
        first.append(len(boxes))
        boxes += [(ACT, row + TF32_BOX_ROWS * i) for i in range(_n_boxes(rows))]
    n_op = len(boxes)
    if n_a > 1:  # each warpgroup one A box against every block
        wgs = [Tf32Wg(w, min(TF32_BOX_ROWS, a_rows - TF32_BOX_ROWS * w), tuple(
            Tf32Part(f, _n_boxes(rows), off + TF32_BOX_ROWS * w * ldw, ldw, rows)
            for f, (_, rows, off, ldw) in zip(first, blocks))) for w in range(2)]
    else:  # one A box: the B boxes dealt to the warpgroups in turn
        items = [Tf32Part(f + i, 1, off + TF32_BOX_ROWS * i, ldw,
                          min(TF32_BOX_ROWS, rows - TF32_BOX_ROWS * i))
                 for f, (_, rows, off, ldw) in zip(first, blocks) for i in range(_n_boxes(rows))]
        wgs = [Tf32Wg(0, a_rows, tuple(items[w::2])) for w in range(2)]
    for w in wgs:
        if tuple(p.nb for p in w.parts) not in TF32_SHAPES:
            raise ValueError(f"no split-TF32 dW shape for parts {[p.nb for p in w.parts]}")
    h = None
    if head is not None:
        h_row, h_rows, operand, w_off, ldw, h_bias = head
        if isinstance(operand, int):
            box0, rows = first[operand], blocks[operand][1]
        else:
            box0, rows = len(boxes), operand[1]
            boxes += [(ACT, operand[0] + TF32_BOX_ROWS * i) for i in range(_n_boxes(rows))]
        h = Tf32Head(h_rows, box0, _n_boxes(rows), w_off, ldw, rows, h_bias)
        boxes.append((DLT_HEAD, h_row))
    if len(boxes) > TF32_MAX_BOXES:
        raise ValueError(f"a dW unit of {len(boxes)} boxes: the kernel takes {TF32_MAX_BOXES}")
    tx = sum(TF32_HEAD_BOX if m == DLT_HEAD else TF32_BOX for m, _ in boxes)
    return Tf32Unit(tuple(boxes), n_a, n_op, a_rows, bias, h, tuple(wgs), tx, tx // 1024)


def _tf32_units(a, blocks, head=None) -> list:
    """The units of one product, as :func:`_tf32_unit` takes it: one unit
    where it is within the kernel's limits (at most 128 cotangent rows, two
    blocks of at most 128 rows, eight boxes), as every product of a model up
    to a width of 128 is; else split. The cotangent rows in groups of 128,
    each against the blocks' rows in pieces of 128, two pieces a unit (one
    where the unit also takes a head on an operand of its own); the
    cotangent bias in each group's first unit; the head's operand rows in
    pieces of 128, each in a unit of its own (on an operand block: the first
    unit that reads that piece), its bias in the first."""
    a_row, a_rows, bias = a
    fits = (a_rows <= TF32_MAX_A_ROWS and len(blocks) <= 2
            and all(rows <= TF32_MAX_PART_ROWS for _, rows, _, _ in blocks))
    if fits:
        try:
            return [_tf32_unit(a, blocks, head)]
        except ValueError:
            pass
    P = TF32_MAX_PART_ROWS
    pieces = [(b, m0) for b, (_, rows, _, _) in enumerate(blocks) for m0 in range(0, rows, P)]
    extra = head is not None and not isinstance(head[2], int)
    heads = []
    if head is not None:
        op_rows = head[2][1] if extra else blocks[head[2]][1]
        heads = list(range(0, op_rows, P))
    specs = []  # (first cotangent row of the group, [pieces], takes a head)
    for n0 in range(0, a_rows, TF32_MAX_A_ROWS):
        i = 0
        while i < len(pieces):
            take = 1 if extra and sum(h for *_, h in specs) < len(heads) else 2
            specs.append((n0, pieces[i:i + take], take == 1 and extra))
            i += take
    # a head on an operand block: each of its pieces in the first unit that reads it
    owner = {}
    if head is not None and not extra:
        for m0 in heads:
            owner[m0] = next(k for k, (_, ps, _) in enumerate(specs)
                             if (head[2], m0) in ps and k not in owner.values())
    units, n_heads, first_of_group = [], 0, set()
    for k, (n0, ps, takes_head) in enumerate(specs):
        rows = min(TF32_MAX_A_ROWS, a_rows - n0)
        # the larger piece first: the kernel's two-part shapes are (2, 1), not (1, 2)
        ps = sorted(ps, key=lambda bp: -min(P, blocks[bp[0]][1] - bp[1]))
        ub = []
        for b, m0 in ps:
            row, brows, off, ldw = blocks[b]
            ub.append((row + m0, min(P, brows - m0), off + n0 * ldw + m0, ldw))
        h = None
        if head is not None:
            h_row, h_rows, operand, w_off, ldw, h_bias = head
            m0 = None
            if extra and takes_head:
                m0 = heads[n_heads]
                hop = (operand[0] + m0, min(P, operand[1] - m0))
            elif not extra and k in owner.values():
                m0 = next(m for m, kk in owner.items() if kk == k)
                hop = ps.index((operand, m0))
            if m0 is not None:
                h = (h_row, h_rows, hop, w_off + m0, ldw, h_bias if n_heads == 0 else -1)
                n_heads += 1
        group_bias = bias + n0 if bias >= 0 and n0 not in first_of_group else -1
        units.append(_tf32_unit((a_row + n0, rows, group_bias), ub, h))
        first_of_group.add(n0)
    return units


def tf32_dw_plan(model: FlexibleNeRFModel) -> Tuple[Tf32Unit, ...]:
    """The units of the f32 weight gradients dW[n][m] = sum_k d[n][k]
    a[m][k] over the feature-major scratch (:func:`scratch_rows`), each
    placed in the flat gradient (:func:`_param_offsets`). In order: layer1
    (d_0 x e); each trunk layer i (d_{i+1} x a_i, and on a skip layer d_{i+1}
    x e: the cotangent read once); fc_feat with the fc_alpha head (d_feat x
    a_nt, d_sigma x a_nt: a_nt read once); layers_dir.0's feat rows with
    the fc_rgb head (d_y x feat, d_rgb x y). The encoding e is read by
    layer1's unit and the skip layers' (a unit of d_0, d_{i+1}, e and a_i
    would need twice a warpgroup's registers). Above a width of 128 each
    product is split to the kernel's limits (:func:`_tf32_units`). Biases
    are the cotangent rows' sums; the viewdir rows of layers_dir.0 (K =
    rays) are the launch's own work (:func:`tf32_entries`)."""
    R = scratch_rows(model)
    offs, _ = _param_offsets(model)
    H, H2, nt, dx, dd = (model.hidden_size, model.hidden_size // 2, model.num_layers - 1,
                         model.dim_xyz, model.dim_dir)
    units = _tf32_units((R["d"][0], H, offs["layer1.bias"]),
                        [(R["e"], dx, offs["layer1.weight"], dx)])
    for i, lin in enumerate(model.layers_xyz):
        w, ldw = offs[f"layers_xyz.{i}.weight"], lin.in_features
        blocks = [(R["a"][i], H, w, ldw)]
        if i in model.skips:
            blocks.append((R["e"], dx, w + H, ldw))
        units += _tf32_units((R["d"][i + 1], H, offs[f"layers_xyz.{i}.bias"]), blocks)
    units += _tf32_units(
        (R["d"][nt + 1], H, offs["fc_feat.bias"]), [(R["a"][nt], H, offs["fc_feat.weight"], H)],
        head=(R["dsig"], 1, 0, offs["fc_alpha.weight"], H, offs["fc_alpha.bias"]))
    units += _tf32_units(
        (R["dy"], H2, offs["layers_dir.0.bias"]),
        [(R["feat"], H, offs["layers_dir.0.weight"], H + dd)],
        head=(R["drgb"], 3, (R["y"], H2), offs["fc_rgb.weight"], H2, offs["fc_rgb.bias"]))
    if len(units) > TF32_MAX_UNITS * TF32_MAX_PARTS:
        raise ValueError(f"{len(units)} dW units: the kernel takes at most "
                         f"{TF32_MAX_UNITS * TF32_MAX_PARTS} (a shallower or narrower model)")
    return tuple(units)


def tf32_dw_parts(plan) -> list:
    """The plan in launches of at most :data:`TF32_MAX_UNITS` units (one
    up to a width of 128)."""
    return [plan[i:i + TF32_MAX_UNITS] for i in range(0, len(plan), TF32_MAX_UNITS)]


def tf32_entries(unit: Tf32Unit) -> torch.Tensor:
    """The flat-gradient entries one slot of ``unit`` holds: its parts'
    dW blocks, the cotangent block's bias, the head's dW and bias."""
    idx = [unit.bias + torch.arange(unit.a_rows)] if unit.bias >= 0 else []
    for w in unit.wgs:
        for p in w.parts:
            idx.append((p.base + torch.arange(w.n_lim)[:, None] * p.ldw
                        + torch.arange(p.m_lim)).reshape(-1))
    h = unit.head
    if h is not None:
        idx.append((h.w + torch.arange(h.rows)[:, None] * h.ldw + torch.arange(h.mlim))
                   .reshape(-1))
        if h.bias >= 0:
            idx.append(h.bias + torch.arange(h.rows))
    return torch.cat(idx)


def tf32_viewdir_entries(model: FlexibleNeRFModel) -> torch.Tensor:
    """The flat-gradient entry of each viewdir dW the launch writes, in its
    order (entry o = c dd + j: layers_dir.0.weight[c][H + j])."""
    H, dd = model.hidden_size, model.dim_dir
    c, j = torch.meshgrid(torch.arange(H // 2), torch.arange(dd), indexing="ij")
    return (_param_offsets(model)[0]["layers_dir.0.weight"] + c * (H + dd) + H + j).reshape(-1)


def tf32_reduce_map(model: FlexibleNeRFModel, plan=None) -> torch.Tensor:
    """For each entry of the flat gradient: -1 - (part TF32_MAX_UNITS +
    unit) of the unit whose slots hold it (:func:`tf32_dw_parts`), or its
    index among the viewdir entries. Raises unless every entry has exactly
    one source."""
    plan = tf32_dw_plan(model) if plan is None else plan
    n = _param_offsets(model)[1]
    count = torch.zeros(n, dtype=torch.int32)
    m = torch.zeros(n, dtype=torch.int32)
    for pt, part in enumerate(tf32_dw_parts(plan)):
        for u, unit in enumerate(part):
            idx = tf32_entries(unit)
            count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
            m[idx] = -1 - (pt * TF32_MAX_UNITS + u)
    vd = tf32_viewdir_entries(model)
    count.index_add_(0, vd, torch.ones_like(vd, dtype=torch.int32))
    m[vd] = torch.arange(vd.numel(), dtype=torch.int32)
    if not bool((count == 1).all()):
        raise RuntimeError("the split-TF32 dW plan does not write every gradient entry once")
    return m


def tf32_ring(plan) -> Tuple[int, int, int]:
    """(bytes of a ring stage, of a lo buffer, stages) of the dW kernel for
    ``plan``: a stage as large as the unit with the most box bytes, a lo
    buffer as the most B operand boxes, :data:`TF32_STAGES` stages or as
    many as fit."""
    stage = -(-max(u.tx for u in plan) // 1024) * 1024
    lo = max(u.n_op - u.n_a for u in plan) * TF32_BOX
    n = min(TF32_STAGES, (TF32_SMEM_MAX - 1024 - TF32_LO_BUFS * lo) // (stage + 24))
    if n < 2:
        raise ValueError("the dW plan's stages do not fit the kernel's shared memory twice")
    return stage, lo, n


class _Tf32Part(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in ("b", "nb", "base", "ldw", "m_lim")]


class _Tf32Wg(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in ("a", "n_lim", "shape", "pad")] + [
        ("part", _Tf32Part * 2)]


class _Tf32Unit(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in ("n_box", "n_op", "tx", "cost")] + [
        (n, ctypes.c_int32 * TF32_MAX_BOXES) for n in ("map", "row", "off")] + [
        (n, ctypes.c_int32) for n in ("n_a", "a_rows", "bias", "h_rows", "h_box0", "h_nbox",
                                      "h_w", "h_ldw", "h_mlim", "h_bias")] + [
        ("wg", _Tf32Wg * 2)]


class _Tf32Args(ctypes.Structure):
    """Mirror of ``Tf32Args`` in ops/csrc/dw_tf32.cu."""

    _fields_ = [
        ("maps", ctypes.c_uint8 * (128 * len(TF32_MAPS))),
        ("units", _Tf32Unit * TF32_MAX_UNITS),
        ("partial", ctypes.c_void_p), ("vd", ctypes.c_void_p),
        ("dy_sum", ctypes.c_void_p), ("dir_enc", ctypes.c_void_p),
        ("n_params", ctypes.c_int64),
    ] + [(n, ctypes.c_int32) for n in (
        "n_units", "total_cost", "grid", "max_pieces", "n_stages", "stage_bytes", "lo_bytes",
        "n_st", "chunk", "rays", "dd", "h2")] + [("pad", ctypes.c_int32 * 2)]


def check_dw_args_size(lib) -> None:
    if lib.dexnerf_dw_tf32_args_size() != ctypes.sizeof(_Tf32Args):
        raise RuntimeError(
            f"_Tf32Args is {ctypes.sizeof(_Tf32Args)} bytes here but "
            f"{lib.dexnerf_dw_tf32_args_size()} in the kernel library"
        )


def tf32_dw_args(model: FlexibleNeRFModel, grid: int, plan=None, viewdir=True) -> _Tf32Args:
    """A ``_Tf32Args`` of the model's plan (or ``plan``, one part of it) on
    ``grid`` CTAs, without the tensor maps, the buffers and the chunk's
    fields; the launch also takes the viewdir rows when ``viewdir`` (the
    first part's)."""
    from dexnerf_tpu_torch.ops.fused_train_loss import dw_max_pieces

    plan = tf32_dw_plan(model) if plan is None else plan
    args = _Tf32Args()
    for slot, u in zip(args.units, plan):
        slot.n_box, slot.n_op, slot.tx, slot.cost = len(u.boxes), u.n_op, u.tx, u.cost
        slot.map[:len(u.boxes)] = [m for m, _ in u.boxes]
        slot.row[:len(u.boxes)] = [r for _, r in u.boxes]
        slot.off[:len(u.boxes)] = [TF32_BOX * i for i in range(len(u.boxes))]
        slot.n_a, slot.a_rows, slot.bias = u.n_a, u.a_rows, u.bias
        if u.head is not None:
            h = u.head
            slot.h_rows, slot.h_box0, slot.h_nbox = h.rows, h.box0, h.nbox
            slot.h_w, slot.h_ldw, slot.h_mlim, slot.h_bias = h.w, h.ldw, h.mlim, h.bias
        for ws, w in zip(slot.wg, u.wgs):
            ws.a, ws.n_lim = w.a, w.n_lim
            ws.shape = TF32_SHAPES[tuple(p.nb for p in w.parts)]
            for ps, p in zip(ws.part, w.parts):
                ps.b, ps.nb, ps.base, ps.ldw, ps.m_lim = p
    costs = [u.cost for u in plan]
    args.n_units, args.total_cost, args.grid = len(plan), sum(costs), grid
    args.max_pieces = dw_max_pieces(costs, grid)
    args.stage_bytes, args.lo_bytes, args.n_stages = tf32_ring(plan)
    args.n_params = _param_offsets(model)[1]
    args.dd, args.h2 = model.dim_dir, model.hidden_size // 2 if viewdir else 0
    return args


# (widths, depth, skips, encodings, grid, device) -> (the _Tf32Args template of
# each part, the reduction's map on the device): built once per shape
_tf32_templates = {}


def _cached_tf32(model: FlexibleNeRFModel, grid: int, device):
    key = (model.hidden_size, model.num_layers, tuple(model.skips), model.dim_xyz,
           model.dim_dir, grid, str(device))
    if key not in _tf32_templates:
        plan = tf32_dw_plan(model)
        parts = [tf32_dw_args(model, grid, part, viewdir=i == 0)
                 for i, part in enumerate(tf32_dw_parts(plan))]
        _tf32_templates[key] = (parts, tf32_reduce_map(model, plan).to(device))
    return _tf32_templates[key]


class WeightGradients:
    """The scratch of one pass over ``n_rays`` rays of ``s_pad`` samples
    (padded to the 64-sample tile), run in chunks of ``chunk`` rays, and
    the launches that sum it into the gradient of every parameter of
    ``model``: after the pass kernel of chunk ``c`` has filled the scratch
    (``act``, ``dlt``, ``dir_enc``, ``dy_sum``), :meth:`chunk` launches its
    weight-gradient kernel; :meth:`reduce` then sums the chunks."""

    def __init__(self, lib, model: FlexibleNeRFModel, n_rays: int, chunk: int, s_pad: int, dev):
        from dexnerf_tpu_torch.ops._build import check

        self.lib, self.model, self.s_pad = lib, model, s_pad
        self.rows = _scratch_rows(lib, model)
        if self.rows != scratch_rows(model):
            raise RuntimeError("the kernel library's scratch layout is not scratch_rows'")
        f32 = dict(dtype=torch.float32, device=dev)
        # reused by every chunk (all launches are on one stream)
        self.act = torch.empty(self.rows["act_rows"] * chunk * s_pad, **f32)
        self.dlt = torch.empty(self.rows["dlt_rows"] * chunk * s_pad, **f32)
        self.dir_enc = torch.empty(model.dim_dir * chunk, **f32)
        self.dy_sum = torch.empty(model.hidden_size // 2 * chunk, **f32)
        self.offs, self.n_params = _param_offsets(model)
        self.grad = torch.empty((self.n_params,), **f32)
        self.n_chunks = -(-n_rays // chunk)
        self.k_full = chunk * s_pad
        self.k_last = (n_rays - (self.n_chunks - 1) * chunk) * s_pad
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        templates, self.map = _cached_tf32(model, sms, dev)
        # the plan's parts (one up to a width of 128), each launched on its own slots
        self.parts = (_Tf32Args * len(templates))(*templates)
        self.n_vd = model.dim_dir * (model.hidden_size // 2)
        self.partials = [torch.empty((self.n_chunks * a.max_pieces * self.n_params,), **f32)
                         for a in self.parts]
        self.vd = torch.empty((max(1, self.n_chunks * self.n_vd),), **f32)
        for a, partial in zip(self.parts, self.partials):
            a.partial, a.vd = partial.data_ptr(), self.vd.data_ptr()
            a.dy_sum, a.dir_enc = self.dy_sum.data_ptr(), self.dir_enc.data_ptr()
            if lib.dexnerf_dw_tf32_smem(ctypes.addressof(a)) == 0:
                raise ValueError("the split-TF32 dW plan is out of the kernel's limits")
        self.maps = {k: self.tensor_maps(lib, k) for k in {self.k_full, self.k_last}}

    def tensor_maps(self, lib, k: int):
        """The kernel's tensor maps (:data:`TF32_MAPS`) of a ``k``-sample
        chunk of the scratch, encoded by ``lib``."""
        from dexnerf_tpu_torch.ops._build import check

        buf = (ctypes.c_uint8 * (128 * len(TF32_MAPS)))()
        for i, (name, box) in enumerate(TF32_MAPS):
            check(lib, lib.dexnerf_dw_tf32_tensor_map(
                ctypes.addressof(buf) + 128 * i, getattr(self, name).data_ptr(), k,
                self.rows[f"{name}_rows"], box), "split-TF32 dW tensor map")
        return buf

    def chunk(self, c: int, rays: int, stream: int) -> None:
        """Launch the weight-gradient kernel of chunk ``c`` (``rays`` rays)."""
        from dexnerf_tpu_torch.ops._build import check

        k = rays * self.s_pad
        for a in self.parts:
            ctypes.memmove(a.maps, self.maps[k], ctypes.sizeof(a.maps))
            a.n_st, a.chunk, a.rays = k // TF32_STAGE, c, rays
            check(self.lib, self.lib.dexnerf_dw_tf32(ctypes.addressof(a), stream),
                  "weight-gradient launch")

    def reduce(self, stream: int, loss_ray=None, loss=None) -> tuple:
        """Sum the chunks' slots (and ``loss_ray`` [N] into ``loss`` [] when
        given); the gradients in ``model.parameters()`` order, views of one
        flat buffer."""
        from dexnerf_tpu_torch.ops._build import check

        check(self.lib, self.lib.dexnerf_dw_tf32_reduce(
            ctypes.addressof(self.parts), len(self.parts), self.n_chunks, self.k_full // TF32_STAGE,
            self.k_last // TF32_STAGE, self.vd.data_ptr(), self.n_vd, self.map.data_ptr(),
            self.grad.data_ptr(), stream), "gradient reduce launch")
        if loss is not None:
            check(self.lib, self.lib.dexnerf_train_loss_sum(
                loss_ray.data_ptr(), loss_ray.numel(), loss.data_ptr(), stream),
                "loss sum launch")
        return tuple(
            self.grad[self.offs[name]:self.offs[name] + p.numel()].view_as(p)
            for name, p in self.model.named_parameters()
        )
