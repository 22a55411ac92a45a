"""The split-TF32 weight gradients of the f32 training kernels
(``dexnerf_tpu_torch/ops/_weight_grads.py``, ``ops/csrc/dw_tf32.cu``).

On the CPU: the plan (:func:`tf32_dw_plan`: every gradient entry written
by one unit or the viewdir rows, each scratch block read once but the
encoding, every K-range of a chunk owned by one CTA, slots numbered in
CTA order); a numpy model of how the kernel's split and its order of
accumulation set the error of one product over a long K (``pytest -s``
prints its table); and an emulation of the kernel's arithmetic (TF32
rounding by bit operations; each stage's three products, every k8 step
truncated into a fresh accumulator of one or two 32-sample stages that is
then added to the part's sum in float32; the plan's slots summed in its
order) on the saved
activations and cotangents of small passes, held to the JAX package's
float32 gradients of kernels 4 and 3 in interpret mode. The JAX package is
imported inside fixtures.

On a CUDA card (marker ``gpu``): the launch alone against a float64
product on random scratch at the edge shapes, and two launches bitwise
equal:

    python -m pytest --noconftest -m gpu tests/test_torch_dw_tf32.py
"""

import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import _weight_grads as wgr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.ops.fused_render import MAX_HIDDEN
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
NARROW = dict(num_layers=8, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)
WIDE_PE = dict(num_layers=8, hidden_size=96, skip_connect_every=3, num_encoding_fn_xyz=16,
               num_encoding_fn_dir=4)
SHALLOW_PE = dict(num_layers=4, hidden_size=16, skip_connect_every=2, num_encoding_fn_xyz=16,
                  num_encoding_fn_dir=4)
ARCHS = {"8x128": FULL, "8x16": NARROW, "8x96-pe16": WIDE_PE, "4x16-pe16": SHALLOW_PE}
KC = wgr.TF32_STAGE
GRAD_RTOL = 1e-4  # the f32 contract: each leaf to 1e-4 of its own largest entry
CARD_RTOL = 1e-5  # the launch alone vs float64 on random scratch


def _model(arch, seed=0):
    return FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed))


def dw_reference(model, act, dlt, dir_enc, dy_sum) -> dict:
    """Each parameter's gradient from one chunk of scratch (``act``
    [rows, k], ``dlt`` [rows, k], ``dir_enc`` [dd, rays], ``dy_sum`` [H/2,
    rays]) in the operands' dtype: dW = d @ a.T and the bias d.sum(1) of
    every layer, as the scratch layout places them."""
    R = wgr.scratch_rows(model)
    H, H2, nt, dx = model.hidden_size, model.hidden_size // 2, model.num_layers - 1, model.dim_xyz

    def a(row, n):
        return act[row:row + n]

    def d(row, n):
        return dlt[row:row + n]

    e = a(R["e"], dx)
    out = {"layer1.weight": d(R["d"][0], H) @ e.T, "layer1.bias": d(R["d"][0], H).sum(1)}
    for i in range(nt):
        di = d(R["d"][i + 1], H)
        w = di @ a(R["a"][i], H).T
        if i in model.skips:
            w = torch.cat([w, di @ e.T], dim=1)
        out[f"layers_xyz.{i}.weight"], out[f"layers_xyz.{i}.bias"] = w, di.sum(1)
    last = a(R["a"][nt], H)
    out["fc_feat.weight"] = d(R["d"][nt + 1], H) @ last.T
    out["fc_feat.bias"] = d(R["d"][nt + 1], H).sum(1)
    out["fc_alpha.weight"] = d(R["dsig"], 1) @ last.T
    out["fc_alpha.bias"] = d(R["dsig"], 1).sum(1)
    dy = d(R["dy"], H2)
    out["layers_dir.0.weight"] = torch.cat([dy @ a(R["feat"], H).T, dy_sum @ dir_enc.T], dim=1)
    out["layers_dir.0.bias"] = dy.sum(1)
    out["fc_rgb.weight"] = d(R["drgb"], 3) @ a(R["y"], H2).T
    out["fc_rgb.bias"] = d(R["drgb"], 3).sum(1)
    return out


# ---- the plan
@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_plan_writes_every_entry_once(arch):
    """Every gradient entry has one source (a unit's slots or the viewdir
    rows; tf32_reduce_map raises otherwise), each warpgroup's parts have a
    shape the kernel takes, and two stages fit its shared memory."""
    m = _model(ARCHS[arch])
    plan = wgr.tf32_dw_plan(m)
    wmap = wgr.tf32_reduce_map(m, plan)
    assert wmap.numel() == sum(p.numel() for p in m.parameters())
    assert int(wmap.max()) == m.dim_dir * (m.hidden_size // 2) - 1
    assert wgr.tf32_ring(plan)[2] >= 2
    for u in plan:
        for w in u.wgs:
            assert tuple(p.nb for p in w.parts) in wgr.TF32_SHAPES
            for p in w.parts:
                assert u.n_a <= p.b and p.b + p.nb <= u.n_op and p.m_lim <= 64 * p.nb
                assert all(u.boxes[x][1] == u.boxes[p.b][1] + 64 * (x - p.b)
                           for x in range(p.b, p.b + p.nb))
        assert u.tx <= wgr.tf32_ring(plan)[0] and u.cost == u.tx // 1024


@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_plan_reads_each_block_once(arch):
    """Each unit's boxes are distinct and cover its blocks' rows; across the
    plan every cotangent box and every activation box is read by one unit,
    but the encoding's, which layer1's unit and each skip layer's read."""
    m = _model(ARCHS[arch])
    R = wgr.scratch_rows(m)
    plan = wgr.tf32_dw_plan(m)
    seen = {}
    for u in plan:
        assert len(set(u.boxes)) == len(u.boxes)
        for box in u.boxes:
            seen[box] = seen.get(box, 0) + 1
        a0 = u.boxes[0][1]
        assert [b for b in u.boxes[:u.n_a]] == [(wgr.DLT, a0 + 64 * i) for i in range(u.n_a)]
        assert 64 * (u.n_a - 1) < u.a_rows <= 64 * u.n_a
    e_boxes = {(wgr.ACT, R["e"] + 64 * i) for i in range(-(-m.dim_xyz // 64))}
    for box, n in seen.items():
        assert n == (1 + len(m.skips) if box in e_boxes else 1), box
    # every block's rows lie in the boxes of the units that read it
    covered = {(mp, r) for (mp, row) in seen for r in range(row, row + 64)}
    H, H2, nt = m.hidden_size, m.hidden_size // 2, m.num_layers - 1
    blocks = ([(wgr.ACT, R["e"], m.dim_xyz)] + [(wgr.ACT, r, H) for r in R["a"]]
              + [(wgr.ACT, R["feat"], H), (wgr.ACT, R["y"], H2)]
              + [(wgr.DLT, r, H) for r in R["d"]] + [(wgr.DLT, R["dy"], H2)])
    for mp, row, n in blocks:
        assert all((mp, r) in covered for r in range(row, row + n)), (mp, row)
    heads = {u.boxes[-1] for u in plan if u.head is not None}
    assert heads == {(wgr.DLT_HEAD, R["dsig"]), (wgr.DLT_HEAD, R["drgb"])}


@pytest.mark.parametrize("grid", [5, 132])
@pytest.mark.parametrize("n_st", [2, 42, 8192])
def test_spans_cover_each_stage_once(n_st, grid):
    """For a full chunk and a remainder's stage counts, each unit's stages
    [0, n_st) are split into disjoint consecutive ranges, one per CTA that
    holds a part, whose slots are numbered 0, 1, ... in CTA order and stay
    below the launch's slot count: the reduction sums them in that fixed
    order."""
    plan = wgr.tf32_dw_plan(_model(FULL))
    costs = [u.cost for u in plan]
    spans = ftl.dw_spans(costs, n_st, grid)
    bound = ftl.dw_max_pieces(costs, grid)
    for u in range(len(plan)):
        parts = [(b, piece, j0, j1) for b in range(grid) for uu, piece, j0, j1 in spans[b]
                 if uu == u]
        assert [p[1] for p in parts] == list(range(len(parts))) and len(parts) <= bound
        assert [b for b, *_ in parts] == list(range(parts[0][0], parts[0][0] + len(parts)))
        ends = [0] + [j1 for *_, j1 in parts]
        assert all(j0 == ends[i] for i, (_, _, j0, _) in enumerate(parts))
        assert ends[-1] == n_st and all(j0 <= j1 for *_, j0, j1 in parts)
    # every CTA takes an equal share of the bytes, to one stage of the largest unit
    load = [sum((j1 - j0) * costs[u] for u, _, j0, j1 in spans[b]) for b in range(grid)]
    assert max(load) - min(load) <= 2 * max(costs)


# ---- the arithmetic: TF32 by bit operations
def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32, to nearest, ties away (cvt.rna)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` truncated to TF32: the bits wgmma reads of it."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    """The kernel's split: hi as wgmma reads x, lo = tf32(x - hi)."""
    hi = tf32_trunc(x)
    return hi, tf32_rna(x - hi)


def round_rz(v: np.ndarray) -> np.ndarray:
    """float64 ``v`` to float32, toward zero (the tensor cores' accumulator)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _k8_terms(a, b, length):
    """The kernel's k8 steps of a [M, K] and b [N, K] (float32), K a
    multiple of ``length`` (32 a stage): for each stage, lo.hi and hi.lo
    per k8 step, then hi.hi; each step's eight products summed exactly.
    Returns [K / length, steps, M, N] float64."""
    (ah, al), (bh, bl) = split(a), split(b)
    M, K = a.shape
    N = b.shape[0]
    C, st = K // length, KC // 8

    def steps(x, y):
        x = x.astype(np.float64).reshape(M, C, length // KC, st, 8)
        y = y.astype(np.float64).reshape(N, C, length // KC, st, 8)
        return np.einsum("mcgsk,ncgsk->cgsmn", x, y)

    lh, hl, hh = steps(al, bh), steps(ah, bl), steps(ah, bh)
    per_stage = [np.stack([t for s in range(st) for t in (lh[:, g, s], hl[:, g, s])]
                          + [hh[:, g, s] for s in range(st)], axis=1)
                 for g in range(length // KC)]
    return np.concatenate(per_stage, axis=1)


def fresh_sums(a, b, length=KC):
    """Each ``length``-sample chunk's steps (:func:`_k8_terms`) truncated
    one by one into a fresh float32 accumulator: [chunks, M, N]."""
    terms = _k8_terms(a, b, length)
    acc = np.zeros(terms.shape[:1] + terms.shape[2:], np.float32)
    for t in range(terms.shape[1]):
        acc = round_rz(acc.astype(np.float64) + terms[:, t])
    return acc


def promoted(a, b, length=KC, total=None):
    """a @ b.T in the kernel's order: each chunk's fresh sum added to the
    running ``total`` in float32, to nearest."""
    for part in fresh_sums(a, b, length):
        total = part if total is None else (total.astype(np.float64) + part).astype(np.float32)
    return total


def kernel_order(a, b, paired):
    """a @ b.T over a CTA's stages as the kernel sums it: a fresh
    accumulator a pair of stages from the first (``paired``: a warpgroup
    with at most 64 columns of accumulators; a last odd stage alone) or a
    stage, each added to the running sum in float32."""
    k = a.shape[1]
    if not paired or k <= KC:
        return promoted(a, b, KC)
    even = k - k % (2 * KC)
    total = promoted(a[:, :even], b[:, :even], 2 * KC)
    return promoted(a[:, even:], b[:, even:], KC, total) if even < k else total


def accumulation_errors(k=262144, m=8, n=8, seed=0) -> dict:
    """RMS / max / mean error, over the RMS of the exact product, of dW =
    d @ a.T (d [m, k] cotangents of both signs, a [n, k] ReLU activations)
    summed: by one sequential float32 FMA chain (the FMA kernel's order), by
    split TF32 with every k8 step truncated into one accumulator, and in the
    kernel's order with a fresh accumulator per chunk of 32 (the stage), 64
    and 128 samples."""
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(m, k)) * 1e-3).astype(np.float32)
    a = np.maximum(rng.normal(size=(n, k)), 0).astype(np.float32)
    exact = d.astype(np.float64) @ a.astype(np.float64).T
    scale = np.sqrt((exact ** 2).mean())
    fma = np.zeros((m, n), np.float32)
    d64, a64 = d.astype(np.float64), a.astype(np.float64)
    for j in range(k):
        fma = (fma + np.outer(d64[:, j], a64[:, j])).astype(np.float32)
    terms = _k8_terms(d, a, KC).reshape(-1, m, n)
    one = np.zeros((m, n), np.float32)
    for t in terms:
        one = round_rz(one.astype(np.float64) + t)

    def err(x):
        e = (x - exact) / scale
        return {"rms": float(np.sqrt((e ** 2).mean())), "max": float(np.abs(e).max()),
                "mean": float(e.mean())}

    out = {"f32_fma": err(fma), "one_accumulator": err(one)}
    for length in (32, 64, 128):
        out[f"promoted_{length}"] = err(promoted(d, a, length))
    return out


def test_accumulation_order_model():
    """Over K = 262,144 (a fine chunk), the kernel's order (a fresh
    accumulator per 32-sample stage, added in float32) errs no more than
    the FMA kernel's sequential float32 chain, while every k8 step
    truncated into one accumulator errs beyond twice it: why the kernel
    promotes. Chunks of 64 and 128 do too; the kernel takes 64 (two
    stages) where a consumer's accumulators and two stages' fragments fit
    its registers, else 32 (``pytest -s`` prints the table)."""
    e = accumulation_errors()
    print({k: {m: float(f"{v:.3g}") for m, v in d.items()} for k, d in e.items()})
    fma, ours = e["f32_fma"], e["promoted_32"]
    assert ours["rms"] <= fma["rms"] and ours["max"] <= fma["max"]
    assert e["one_accumulator"]["rms"] > 2 * fma["rms"]
    for length in (64, 128):
        other = e[f"promoted_{length}"]
        assert other["rms"] <= fma["rms"] and other["max"] <= fma["max"]


# ---- the kernel's arithmetic on a pass's scratch, against JAX
def _seq(x, axis):
    """Sequential float32 sums along ``axis``."""
    if x.shape[axis] == 0:
        return np.zeros(np.delete(x.shape, axis), np.float32)
    return np.take(np.cumsum(x, axis=axis, dtype=np.float32), -1, axis=axis)


def bias_sums(rows):
    """Each row's sum of ``rows`` [n, 32 stages] in the kernel's order: lane
    q of a row sums, each stage, positions q, q + 4, ..., q + 28 into a
    stage sum added to its running sum; then (q0 + q1) + (q2 + q3)."""
    x = rows.reshape(rows.shape[0], -1, 8, 4)  # [row, stage, 4 k, lane q]
    lanes = _seq(_seq(x, 2), 1)  # [row, q]
    return (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])


def emulate_dw(model, chunks, grid):
    """The launch and its reduction on ``chunks`` ((rays, act [rows, k],
    dlt [rows, k], dir_enc [dd, rays], dy_sum [H/2, rays]) float32 numpy,
    k a multiple of 32) by the plan on ``grid`` CTAs: each CTA's part of
    each unit, its parts as products of the A block's rows and the part's
    rows over the part's stages in the kernel's order (:func:`kernel_order`),
    the bias rows summed in the
    kernel's order (:func:`bias_sums`), the heads and the viewdir rows as
    float32 dot products; the slots summed in chunk and slot order.
    Returns the flat gradient."""
    plan = wgr.tf32_dw_plan(model)
    costs = [u.cost for u in plan]
    n = wgr._param_offsets(model)[1]
    n_vd = model.dim_dir * (model.hidden_size // 2)
    pieces = ftl.dw_max_pieces(costs, grid)
    slots = np.zeros((len(chunks), pieces, n), np.float32)
    vd = np.zeros((len(chunks), n_vd), np.float32)

    def dot(x, y):
        return (x.astype(np.float64) @ y.astype(np.float64).T).astype(np.float32)

    for c, (rays, act, dlt, de, ds) in enumerate(chunks):
        spans = ftl.dw_spans(costs, act.shape[1] // KC, grid)
        for b in range(grid):
            for u, piece, j0, j1 in spans[b]:
                U, out = plan[u], slots[c, piece]
                cols = slice(KC * j0, KC * j1)
                a_row = U.boxes[0][1]
                for w in U.wgs:
                    A = dlt[a_row + 64 * w.a:a_row + 64 * w.a + w.n_lim, cols]
                    paired = sum(p.nb for p in w.parts) <= 2
                    for p in w.parts:
                        B = act[U.boxes[p.b][1]:U.boxes[p.b][1] + p.m_lim, cols]
                        D = (kernel_order(A, B, paired) if j1 > j0
                             else np.zeros((w.n_lim, p.m_lim)))
                        idx = p.base + np.arange(w.n_lim)[:, None] * p.ldw + np.arange(p.m_lim)
                        out[idx] = D
                out[U.bias + np.arange(U.a_rows)] = bias_sums(
                    dlt[a_row:a_row + U.a_rows, cols])
                h = U.head
                if h is not None:
                    hd = dlt[U.boxes[-1][1]:U.boxes[-1][1] + h.rows, cols]
                    opnd = act[U.boxes[h.box0][1]:U.boxes[h.box0][1] + h.mlim, cols]
                    out[h.w + np.arange(h.rows)[:, None] * h.ldw + np.arange(h.mlim)] = dot(
                        hd, opnd)
                    out[h.bias + np.arange(h.rows)] = hd.sum(1, dtype=np.float32)
        vd[c] = dot(ds, de).reshape(-1)
    m = wgr.tf32_reduce_map(model, plan).numpy()
    slot_sum = np.cumsum(slots.reshape(-1, n), axis=0, dtype=np.float32)[-1]
    vd_sum = np.cumsum(vd, axis=0, dtype=np.float32)[-1]
    return np.where(m < 0, slot_sum, vd_sum[np.maximum(m, 0)])


def saved_scratch(model, loss_of, xyz, view, chunk, s_pad):
    """The scratch the pass kernels leave for ``loss_of(model(xyz, view))``
    (xyz [N, S, dx] and view [N, dd] encodings), run by the plain model
    with hooks: each linear layer's input and the cotangent of its output,
    placed as ``Rows`` places them, ray r's samples at columns r s_pad + s
    of its chunk of ``chunk`` rays (zeros past S)."""
    lins = {"layer1": model.layer1, "fc_feat": model.fc_feat, "fc_alpha": model.fc_alpha,
            "dir": model.layers_dir[0], "fc_rgb": model.fc_rgb,
            **{f"xyz{i}": lin for i, lin in enumerate(model.layers_xyz)}}
    seen, handles = {}, []
    for name, lin in lins.items():
        def hook(mod, inp, out, name=name):
            seen[name] = {"in": inp[0].detach()}
            out.register_hook(lambda g: seen[name].__setitem__("d", g.detach()))
        handles.append(lin.register_forward_hook(hook))
    try:
        loss_of(model(xyz, view)).backward()
    finally:
        for hd in handles:
            hd.remove()
    R = wgr.scratch_rows(model)
    H, H2, nt, dx = model.hidden_size, model.hidden_size // 2, model.num_layers - 1, model.dim_xyz
    N, S = xyz.shape[:2]
    act_blocks = [(R["e"], seen["layer1"]["in"])]
    act_blocks += [(R["a"][i], seen[f"xyz{i}"]["in"][..., :H]) for i in range(nt)]
    act_blocks += [(R["a"][nt], seen["fc_feat"]["in"]), (R["feat"], seen["dir"]["in"][..., :H]),
                   (R["y"], seen["fc_rgb"]["in"])]
    dlt_blocks = [(R["d"][0], seen["layer1"]["d"])]
    dlt_blocks += [(R["d"][i + 1], seen[f"xyz{i}"]["d"]) for i in range(nt)]
    dlt_blocks += [(R["d"][nt + 1], seen["fc_feat"]["d"]), (R["dsig"], seen["fc_alpha"]["d"]),
                   (R["dy"], seen["dir"]["d"]), (R["drgb"], seen["fc_rgb"]["d"])]
    dy = seen["dir"]["d"]
    chunks = []
    for r0 in range(0, N, chunk):
        rays = min(chunk, N - r0)
        bufs = []
        for rows, blocks in ((R["act_rows"], act_blocks), (R["dlt_rows"], dlt_blocks)):
            buf = np.zeros((rows, rays, s_pad), np.float32)
            for row, t in blocks:
                v = t[r0:r0 + rays].numpy()
                buf[row:row + v.shape[-1], :, :S] = np.moveaxis(v, -1, 0)
            bufs.append(buf.reshape(rows, rays * s_pad))
        chunks.append((rays, *bufs, view[r0:r0 + rays].T.numpy().copy(),
                       dy[r0:r0 + rays].sum(1, dtype=torch.float32).T.numpy().copy()))
    return chunks


def _grads_close(model, flat, want):
    offs, _ = wgr._param_offsets(model)
    for name, p in model.named_parameters():
        g = flat[offs[name]:offs[name] + p.numel()].reshape(p.shape)
        w = np.asarray(want[name])
        assert np.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale, (name, np.abs(g - w).max(), scale)


def _jax_model(arch, seed):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

    jm = JFlex(**arch)
    in_dim = encoding_dim(3, arch["num_encoding_fn_xyz"]) + encoding_dim(
        3, arch["num_encoding_fn_dir"])
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed), jnp.ones((1, in_dim))))
    m = FlexibleNeRFModel(**arch)
    m.load_state_dict(state_dict_from_flax(tree))
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, tree=tree, model=m)


K4_ARCH = NARROW
K3_ARCH = dict(num_layers=6, hidden_size=16, skip_connect_every=2, num_encoding_fn_xyz=3,
               num_encoding_fn_dir=2)


def test_emulated_dw_matches_jax_kernel4():
    """Kernel 4's f32 pass (8x16, skip 3; 24 rays of 8 samples, s_pad 64;
    chunks of 10, 10 and 4 rays; 5 CTAs): the emulation on the plain
    pass's activations and cotangents vs the JAX package's fused train
    loss in interpret mode, every leaf to 1e-4 of its largest entry."""
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    from dexnerf_tpu_torch.core.volrend import composite, ray_dists
    from dexnerf_tpu_torch.core.sampling import stratified_z_vals

    jx = _jax_model(K4_ARCH, 0)
    with torch.no_grad():  # σ logit spread: saturated and transparent samples
        jx.tree["params"][f"Dense_{K4_ARCH['num_layers'] + 1}"]["kernel"] *= 30.0
    jx.model.load_state_dict(state_dict_from_flax(jx.tree))
    rng = np.random.default_rng(3)
    n, s = 24, 8
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = stratified_z_vals(torch.full((n,), 2.0), torch.full((n,), 6.0), s).numpy()
    z = (z + rng.uniform(0.0, 0.4, size=z.shape)).astype(np.float32)
    dists = ray_dists(torch.tensor(z), torch.tensor(rd)).numpy()
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    fn = make_fused_pass_loss(jx.jm, block_samples=128, interpret=True)
    a = [jx.jnp.asarray(x) for x in (ro, rd, z, vd, dists)]
    want = jx.jax.grad(lambda p: fn(p, *a, None, jx.jnp.asarray(target))[0])(jx.tree)
    want = state_dict_from_flax(jx.jax.tree.map(np.asarray, want))
    want = {k: v.numpy() for k, v in want.items()}

    m = jx.model
    pts = torch.tensor(ro)[:, None] + torch.tensor(rd)[:, None] * torch.tensor(z)[..., None]
    xyz = positional_encoding(pts, m.num_encoding_fn_xyz, m.include_input_xyz, True)
    view = positional_encoding(torch.tensor(vd), m.num_encoding_fn_dir, m.include_input_dir, True)

    def loss_of(raw):
        out = composite(raw, torch.tensor(z), torch.tensor(dists))
        return ((out.rgb - torch.tensor(target)) ** 2).sum()

    chunks = saved_scratch(m, loss_of, xyz, view, 10, 64)
    assert [c[0] for c in chunks] == [10, 10, 4]
    _grads_close(m, emulate_dw(m, chunks, 5), want)


def test_emulated_dw_matches_jax_kernel3():
    """Kernel 3's f32 field backward (6x16, skip 2; 5 rays of 6 samples,
    s_pad 64, chunks of 2 rays; 3 CTAs): the emulation on the plain
    field's activations and cotangents of a squared error vs the JAX
    package's training field in interpret mode, every leaf to 1e-4 of its
    largest entry."""
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_make

    jx = _jax_model(K3_ARCH, 1)
    rng = np.random.default_rng(5)
    n, s = 5, 6
    pts = rng.normal(size=(n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tgt = rng.normal(size=(n, s, 4)).astype(np.float32)
    field = j_make(jx.jm, block_samples=16, compute_dtype=jx.jnp.float32, interpret=True)
    jp, jv, jt = (jx.jnp.asarray(x) for x in (pts, vd, tgt))
    want = jx.jax.grad(lambda p: jx.jnp.sum((field(p, jp, jv) - jt) ** 2))(jx.tree)
    want = state_dict_from_flax(jx.jax.tree.map(np.asarray, want))
    want = {k: v.numpy() for k, v in want.items()}

    m = jx.model
    xyz = positional_encoding(torch.tensor(pts), m.num_encoding_fn_xyz, m.include_input_xyz, True)
    view = positional_encoding(torch.tensor(vd), m.num_encoding_fn_dir, m.include_input_dir, True)
    chunks = saved_scratch(m, lambda raw: ((raw - torch.tensor(tgt)) ** 2).sum(), xyz, view, 2,
                           64)
    assert m.skips and [c[0] for c in chunks] == [2, 2, 1]
    _grads_close(m, emulate_dw(m, chunks, 3), want)


def test_emulation_is_the_product():
    """The emulation on random scratch (8x128 at 96 samples a chunk, two
    chunks, 7 CTAs) against the float64 products of :func:`dw_reference`,
    to 1e-5 of each leaf's largest entry: the plan places every product."""
    m = _model(FULL)
    R = wgr.scratch_rows(m)
    rng = np.random.default_rng(2)
    chunks, want = [], None
    for rays in (3, 2):
        k = 32 * rays
        act = np.maximum(rng.normal(size=(R["act_rows"], k)), 0).astype(np.float32)
        dlt = (rng.normal(size=(R["dlt_rows"], k)) * 1e-3).astype(np.float32)
        de = rng.normal(size=(m.dim_dir, rays)).astype(np.float32)
        ds = (rng.normal(size=(m.hidden_size // 2, rays)) * 1e-2).astype(np.float32)
        chunks.append((rays, act, dlt, de, ds))
        ref = dw_reference(m, *(torch.tensor(x, dtype=torch.float64) for x in (act, dlt, de, ds)))
        want = ref if want is None else {k2: want[k2] + v for k2, v in ref.items()}
    flat = emulate_dw(m, chunks, 7)
    offs, _ = wgr._param_offsets(m)
    for name, p in m.named_parameters():
        g = flat[offs[name]:offs[name] + p.numel()].reshape(p.shape)
        w = want[name].numpy()
        assert float(np.abs(g - w).max()) <= CARD_RTOL * float(np.abs(w).max()), name


# ---- on the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_run(cuda, arch, n, chunk, s_pad, seed=0, repeat=1):
    """Random scratch chunk by chunk through ``WeightGradients`` (each
    chunk's cotangent columns past a ray's samples left random too: the
    launch multiplies whatever the scratch holds); returns the gradients
    of each of ``repeat`` runs and the float64 reference."""
    from dexnerf_tpu_torch.ops._build import load_library

    m = _model(arch).to(cuda)
    lib = load_library()
    wg = wgr.WeightGradients(lib, m, n, chunk, s_pad, cuda)
    R = wg.rows
    gen = torch.Generator(device=cuda).manual_seed(seed)
    H2, dd = m.hidden_size // 2, m.dim_dir
    chunks = []
    for c in range(wg.n_chunks):
        rays = min(chunk, n - c * chunk)
        k = rays * s_pad
        act = torch.relu(torch.randn((R["act_rows"], k), generator=gen, device=cuda))
        dlt = torch.randn((R["dlt_rows"], k), generator=gen, device=cuda) * 1e-3
        de = torch.randn((dd, rays), generator=gen, device=cuda)
        ds = torch.randn((H2, rays), generator=gen, device=cuda) * 1e-2
        chunks.append((rays, act, dlt, de, ds))
    want = None
    for _, act, dlt, de, ds in chunks:
        ref = dw_reference(m, act.double(), dlt.double(), de.double(), ds.double())
        want = ref if want is None else {k: want[k] + v for k, v in ref.items()}
    stream = torch.cuda.current_stream(cuda).cuda_stream
    runs = []
    for _ in range(repeat):
        for c, (rays, act, dlt, de, ds) in enumerate(chunks):
            k = rays * s_pad
            wg.act[:act.numel()].copy_(act.reshape(-1))
            wg.dlt[:dlt.numel()].copy_(dlt.reshape(-1))
            wg.dir_enc[:de.numel()].copy_(de.reshape(-1))
            wg.dy_sum[:ds.numel()].copy_(ds.reshape(-1))
            assert k % KC == 0
            wg.chunk(c, rays, stream)
        runs.append([g.clone() for g in wg.reduce(stream)])
    torch.cuda.synchronize()
    names = [name for name, _ in m.named_parameters()]
    return names, runs, want


# (arch, rays, rays a chunk, s_pad): M = 63 (PE 10) with an odd 21-ray last
# chunk of 8; H = 16 (64-row boxes past every block); dx = 99 (two encoding
# boxes: the skip layer's two-part shape (2, 2) at 96, (1, 1) at 16); one
# chunk of K = 262,144 (a fine chunk of the 8x128 path); the wide route's
# plans at 136, 256 and MAX_HIDDEN (above a width of 128: units split to the
# kernel's limits, launched in parts above 320; ops/_weight_grads.py::_tf32_units)
CARD_ARCHS = dict(ARCHS, **{f"8x{h}": dict(FULL, hidden_size=h) for h in (136, 256, MAX_HIDDEN)})
CARD_CASES = [("8x128", 301, 40, 64), ("8x16", 300, 300, 128), ("8x96-pe16", 64, 33, 64),
              ("4x16-pe16", 50, 50, 64), ("8x128", 2048, 2048, 128), ("8x136", 64, 33, 64),
              ("8x256", 40, 40, 128), (f"8x{MAX_HIDDEN}", 20, 7, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n,chunk,s_pad", CARD_CASES)
def test_dw_launch_matches_float64_on_card(cuda, arch, n, chunk, s_pad):
    names, (got,), want = _card_run(cuda, CARD_ARCHS[arch], n, chunk, s_pad)
    for name, g in zip(names, got):
        w = want[name]
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        assert err <= CARD_RTOL * scale, (name, err, scale)


@pytest.mark.gpu
def test_dw_launch_bitwise_repeatable_on_card(cuda):
    _, (one, two), _ = _card_run(cuda, FULL, 301, 40, 64, seed=3, repeat=2)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
