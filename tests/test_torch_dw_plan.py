"""The work plan of the bf16 weight-gradient kernel
(``dexnerf_tpu_torch/ops/fused_train_loss.py::dw_plan``, ``dw_spans``),
on the CPU: the units, boxes, output blocks, K-ranges and slots that
``train_dw_bf16_kernel`` (``ops/csrc/fused_train_loss_bf16.cu``) trusts.

A random bf16 scratch (numpy, from a seed) goes through the plan as the
card runs it: each CTA's part of each unit, each output block the product
of a 64-sample x 64-column box of cotangents and one of activations (zero
past a block's width), written to the CTA's slot, the slots summed in the
plan's order. The result is held to each layer's ``d.T @ a`` placed by
``_param_offsets``; only the summation order differs, so to 1e-6 of each
leaf's largest entry.
"""

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_train_loss as ftl

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
RTOL = 1e-6


def _model(**kw):
    return FlexibleNeRFModel(**{**FULL, **kw})


def _scratch(model, rows, seed=0):
    """Random bf16-valued blocks (as float64) of the scratch layout, every
    column filled, padding included."""
    _, _, act_w, dlt_w = ftl._scratch_layout(model)
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((rows, w)), dtype=torch.float32)
            .to(torch.bfloat16).double() for w in act_w + dlt_w]


def _box(block, col, j0, j1):
    """Stages [j0, j1) of a 64-column box at ``col``, zero past the width."""
    out = torch.zeros((64 * (j1 - j0), 64), dtype=torch.float64)
    part = block[64 * j0:64 * j1, col:col + 64]
    out[:, :part.shape[1]] = part
    return out


def _run_plan(model, blocks, n_st, grid):
    """The flat gradient's dW entries as the kernel and the reduction form
    them: per CTA part an f32 slot, slots summed in CTA order."""
    plan = ftl.dw_plan(model)
    _, n_params = ftl._param_offsets(model)
    spans = ftl.dw_spans([u.cost for u in plan], n_st, grid)
    max_pieces = ftl.dw_max_pieces([u.cost for u in plan], grid)
    slots = torch.full((max_pieces, n_params), float("nan"), dtype=torch.float32)
    pieces = [0] * len(plan)
    for parts in spans:
        for u, piece, j0, j1 in parts:
            assert piece < max_pieces
            pieces[u] = max(pieces[u], piece + 1)
            boxes = plan[u].a + plan[u].b
            for a, b, base, ldw, n_lim, m_lim in plan[u].blocks:
                prod = _box(blocks[boxes[a][0]], boxes[a][1], j0, j1).t() @ _box(
                    blocks[boxes[b][0]], boxes[b][1], j0, j1)
                idx = base + torch.arange(n_lim)[:, None] * ldw + torch.arange(m_lim)
                slots[piece, idx.reshape(-1)] = prod[:n_lim, :m_lim].float().reshape(-1)
    count, unit = ftl.dw_unit_map(model)
    grad = torch.zeros(n_params, dtype=torch.float32)
    for u in range(len(plan)):
        idx = torch.nonzero((count == 1) & (unit == -1 - u)).reshape(-1)
        for k in range(pieces[u]):  # the reduction's order
            grad[idx] += slots[k, idx]
    return grad, count


def _want(model, blocks):
    """Each weight's d.T @ a over the scratch's real columns, placed."""
    H, nt, dx, dd = model.hidden_size, model.num_layers - 1, model.dim_xyz, model.dim_dir
    offs, n_params = ftl._param_offsets(model)
    n_act = len(ftl._scratch_layout(model)[2])
    act, dlt = blocks[:n_act], blocks[n_act:]
    want = {"layer1.weight": dlt[0][:, :H].t() @ act[0][:, :dx]}
    for i in range(nt):
        w = dlt[i + 1][:, :H].t() @ act[1 + i][:, :H]
        if i in model.skips:
            w = torch.cat([w, dlt[i + 1][:, :H].t() @ act[0][:, :dx]], dim=1)
        want[f"layers_xyz.{i}.weight"] = w
    want["fc_feat.weight"] = dlt[nt + 1][:, :H].t() @ act[nt + 1][:, :H]
    want["fc_alpha.weight"] = dlt[nt + 4][:, :1].t() @ act[nt + 1][:, :H]
    want["layers_dir.0.weight"] = dlt[nt + 2][:, :H // 2].t() @ act[nt + 2][:, :H]
    want["fc_rgb.weight"] = dlt[nt + 3][:, :3].t() @ act[nt + 3][:, :H // 2]
    return want, offs


@pytest.mark.parametrize("n_st,grid", [(7, 5), (9, 132), (2, 3)], ids=["5ctas", "132ctas", "short"])
@pytest.mark.parametrize("hidden", [16, 48, 128])
def test_dw_plan_matches_each_layer(hidden, n_st, grid):
    model = _model(hidden_size=hidden)
    assert model.skips
    blocks = _scratch(model, 64 * n_st, seed=hidden + n_st)
    got, count = _run_plan(model, blocks, n_st, grid)
    want, offs = _want(model, blocks)
    H = model.hidden_size
    for name, w in want.items():
        ncol = w.shape[1]
        lo = offs[name]
        if name == "layers_dir.0.weight":  # the feat columns; the viewdir rows are the chain's
            ldw = H + model.dim_dir
            idx = lo + torch.arange(w.shape[0])[:, None] * ldw + torch.arange(ncol)
        else:
            idx = lo + torch.arange(w.numel()).reshape(w.shape)
        g = got[idx]
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        assert err <= RTOL * scale, (name, err, scale)
        assert bool((count[idx] == 1).all()), name


@pytest.mark.parametrize("hidden", [16, 128])
def test_every_weight_entry_written_once(hidden):
    """Each weight entry is written by exactly one output block of the plan,
    except the viewdir rows of layers_dir.0 and the biases, which the chain
    CTAs' slots hold (``_aux_map``)."""
    model = _model(hidden_size=hidden)
    count, unit = ftl.dw_unit_map(model)
    offs, n = ftl._param_offsets(model)
    want = torch.zeros(n, dtype=torch.int32)
    for name, p in model.named_parameters():
        if name.endswith("weight"):
            want[offs[name]:offs[name] + p.numel()] = 1
    H = model.hidden_size
    wd = torch.ones_like(model.layers_dir[0].weight, dtype=torch.int32)
    wd[:, H:] = 0
    o = offs["layers_dir.0.weight"]
    want[o:o + wd.numel()] = wd.reshape(-1)
    assert torch.equal(count, want)
    bmap, _ = ftl._aux_map(model, "cpu")
    assert bool((bmap[count == 1] == unit[count == 1]).all())
    assert bool((bmap[count == 0] >= 0).all())


@pytest.mark.parametrize("n_st,grid", [(8192, 132), (4096, 132), (2, 132), (3, 7), (100, 1)])
def test_dw_spans_split_every_stage_once(n_st, grid):
    """Every stage of every unit goes to exactly one CTA; a unit's CTAs are
    consecutive with slots 0, 1, ...; the slots fit the bound; the bytes of
    the CTAs' shares differ by at most one stage of the dearest unit."""
    costs = [u.cost for u in ftl.dw_plan(_model())]
    spans = ftl.dw_spans(costs, n_st, grid)
    seen = [np.zeros(n_st, np.int64) for _ in costs]
    owners = [[] for _ in costs]
    load = []
    for b, parts in enumerate(spans):
        load.append(sum((j1 - j0) * costs[u] for u, _, j0, j1 in parts))
        for u, piece, j0, j1 in parts:
            assert 0 <= j0 <= j1 <= n_st
            seen[u][j0:j1] += 1
            owners[u].append((b, piece))
    for u in range(len(costs)):
        assert (seen[u] == 1).all(), u
        bs = [b for b, _ in owners[u]]
        assert bs == list(range(bs[0], bs[0] + len(bs)))
        assert [p for _, p in owners[u]] == list(range(len(bs)))
        assert len(bs) <= ftl.dw_max_pieces(costs, grid)
    assert sum(load) == n_st * sum(costs)
    if n_st * sum(costs) >= grid:
        assert max(load) - min(load) <= 2 * max(costs)


@pytest.mark.parametrize(
    "arch",
    [FULL, dict(FULL, num_encoding_fn_xyz=16), dict(FULL, hidden_size=16),
     dict(FULL, num_layers=32, skip_connect_every=4)],
    ids=["8x128", "pe16", "h16", "32-layers"],
)
def test_dw_template_within_kernel_limits(arch):
    """The kernel's limits hold for the plan (``dw_smem`` refuses what they
    do not): boxes and blocks of a unit, stages in shared memory, tensor
    maps, and the work is cut into stages of 64 samples."""
    model = FlexibleNeRFModel(**arch)
    plan = ftl.dw_plan(model)
    args, smem = ftl._cached_dw_template(model, 132)
    n_maps = sum(len(w) for w in ftl._scratch_layout(model)[2:])
    assert n_maps <= ftl.DW_MAX_MAPS and len(plan) == args.n_units <= ftl.DW_MAX_UNITS
    assert smem <= ftl.DW_SMEM_MAX and args.n_stages >= 2
    assert args.total_cost == sum(u.cost for u in plan)
    for u, slot in zip(plan, args.units):
        assert len(u.a) + len(u.b) <= ftl.DW_MAX_BOXES
        assert (len(u.a) + len(u.b)) * 8192 <= args.stage_bytes
        assert 1 <= len(u.blocks) <= ftl.DW_MAX_BLOCKS
        assert (slot.n_a, slot.n_b, slot.n_blocks) == (len(u.a), len(u.b), len(u.blocks))
        for a, b, _, _, n_lim, m_lim in u.blocks:
            assert a < len(u.a) <= b < len(u.a) + len(u.b)
            assert 1 <= n_lim <= 64 and 1 <= m_lim <= 64
