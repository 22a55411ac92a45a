"""Kernel 4's f32 pass (``ops/csrc/fused_train_loss.cu``: prep, forward,
compositing and cotangent chain in split TF32 on the tensor cores), on the
CPU.

The kernels run only on the card. Here: the chain's split pack
(:func:`~dexnerf_tpu_torch.ops.fused_train_loss.pack_backward_weights_tf32`:
layout, K order, padding, cache), the forward's ReLU mask words against
``a > 0``, and a plain emulation of the pass's arithmetic, kept in this file:
TF32 rounding by bit operations; every product of the forward and of the
chain per K-chunk of 32 (lo.hi and hi.lo, then hi.hi, each k8 step
truncated into a fresh accumulator that is added to the layer's sum in
float32) on the packs' hi and lo halves, but layer1's, a sequential
float32 FMA chain over the encoding as the kernel's CUDA cores take it;
compositing with the kernels' warp
scans (the transmittance a Hillis-Steele product scan over 32 lanes, the
suffix sum the same from the last lane, sums as butterflies); the viewdir
layer's per-ray cotangent sums in the kernel's order; and the weight
gradients as ``tests/test_torch_dw_tf32.py`` emulates ``dw_tf32.cu`` on the
emulated scratch. Held to the JAX package's float32 kernel 4 in interpret
mode (loss, weights, rgb, every gradient leaf to 1e-4 of its largest
entry). The JAX package is imported inside a fixture.

On a CUDA card (marker ``gpu``): the scratch, the mask words and the
per-ray buffers of one chunk against the plain version's activations and
cotangents, and two passes bitwise equal:

    python -m pytest --noconftest -m gpu tests/test_torch_train_loss_tf32.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.core.volrend import ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import _weight_grads as wgr
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from test_torch_dw_tf32 import emulate_dw, saved_scratch
from test_torch_fused_render_tf32 import promoted, split, unpack

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
NARROW = dict(num_layers=8, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)
ARCHS = {"8x16": NARROW, "8x48": dict(FULL, hidden_size=48), "8x128": FULL}
# the wide route (padded widths above 128, ops/csrc/mlp_wide_tf32.cuh), on the card
WIDE_ARCHS = {"8x136": dict(FULL, hidden_size=136), "8x256": dict(FULL, hidden_size=256),
              f"8x{fr.MAX_HIDDEN}": dict(FULL, hidden_size=fr.MAX_HIDDEN)}
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5  # weights, rgb: the f32 contract
GRAD_RTOL = 1e-4  # each leaf to 1e-4 of its own largest entry


def _model(arch, seed=0):
    return FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed))


def backward_shapes(m):
    """(N rows, K, the K of the real columns) of each operand of the chain's
    pack, in its order, at the padded width."""
    Hp = fr.bf16_hidden(m.hidden_size)
    kd = -(-(Hp // 2) // 32) * 32
    H = m.hidden_size
    return [(Hp, kd, H // 2), (Hp, Hp, H)] + [(Hp, Hp, H)] * (m.num_layers - 1)


def unpack_chunks(wq, shapes):
    """The operands of a split pack of ``shapes`` ((N, K, _) each) as (hi,
    lo) [N, K] matrices in feature order."""
    order = fr.tf32_feature_order(1024)
    pos, out = 0, []
    for n, k, _ in shapes:
        halves = ([], [])
        for _c in range(k // 32):
            for h in range(2):
                g = wq[pos:pos + n * 32].reshape(n, 8, 4)
                pos += n * 32
                j = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)
                halves[h].append(g[torch.arange(n)[:, None], j].reshape(n, 32))
        mats = []
        for h in range(2):
            w = torch.cat(halves[h], dim=1)
            nat = torch.empty_like(w)
            nat[:, order[:k]] = w
            mats.append(nat)
        out.append(tuple(mats))
    assert pos == wq.numel()
    return out


def backward_weights(m):
    """The chain's matrices [in, out] in the pack's order: layers_dir.0's
    feat rows, fc_feat, layers_xyz from the last (h rows)."""
    H = m.hidden_size
    ws = [m.layers_dir[0].weight[:, :H].t(), m.fc_feat.weight.t()]
    ws += [lin.weight[:, :H].t() for lin in reversed(m.layers_xyz)]
    return [w.detach() for w in ws]


@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_pack_backward_weights_tf32_layout(arch):
    """Every operand transposed, at the padded width with zero padding
    (layers_dir.0's K, H/2, padded to a whole K-chunk), K in the kernel's
    position order, swizzled; hi and lo TF32 halves of each weight."""
    m = _model(ARCHS[arch], 1)
    wbq = ftl.pack_backward_weights_tf32(m)
    assert wbq.dtype == torch.float32
    assert not (wbq.view(torch.int32) & 0x1FFF).any()
    shapes = backward_shapes(m)
    Hp = fr.bf16_hidden(m.hidden_size)
    assert wbq.numel() == 2 * Hp * sum(k for _, k, _ in shapes)
    for (hi, lo), w, (n, k, kr) in zip(unpack_chunks(wbq, shapes), backward_weights(m), shapes):
        assert w.shape[1] == kr
        want = F.pad(w, (0, k - kr, 0, n - w.shape[0]))
        assert torch.equal(hi, split(want)[0]) and torch.equal(lo, split(want)[1])
        assert not hi[want == 0].any() and not lo[want == 0].any()
    # the first stage: row 0 of layers_dir.0's transpose, K positions 0..7
    # holding features 0, 2, 4, 6, 1, 3, 5, 7; its lo stage follows
    wt = F.pad(backward_weights(m)[0], (0, shapes[0][1] - m.hidden_size // 2,
                                        0, Hp - m.hidden_size))
    assert torch.equal(wbq[:8], split(wt)[0][0, [0, 2, 4, 6, 1, 3, 5, 7]])
    assert torch.equal(wbq[Hp * 32:Hp * 32 + 8], split(wt)[1][0, [0, 2, 4, 6, 1, 3, 5, 7]])


@pytest.mark.parametrize("arch", list(ARCHS), ids=list(ARCHS))
def test_pack_layer1_f32(arch):
    """layer1's f32 weights for the forward's CUDA-core product: the
    transpose, outputs zero-padded to the padded width, unrounded."""
    m = _model(ARCHS[arch], 3)
    w1 = ftl.pack_layer1_f32(m)
    Hp = fr.bf16_hidden(m.hidden_size)
    assert w1.shape == (m.dim_xyz, Hp) and w1.dtype == torch.float32 and w1.is_contiguous()
    assert torch.equal(w1[:, :m.hidden_size], m.layer1.weight.detach().t())
    assert not w1[:, m.hidden_size:].any()


def test_pack_backward_weights_tf32_cached():
    """Packed once per parameter state, rebuilt after a change in place,
    apart from the forward's pack."""
    m = _model(dict(FULL, hidden_size=32), 2)
    a = ftl._cached_tf32_backward(m, "cpu")
    assert ftl._cached_tf32_backward(m, "cpu") is a
    fr._cached_tf32_weights(m, "cpu")
    assert ftl._cached_tf32_backward(m, "cpu") is a
    with torch.no_grad():
        m.fc_feat.weight.add_(1.0)
    b = ftl._cached_tf32_backward(m, "cpu")
    assert b is not a and not torch.equal(a, b)


@pytest.mark.parametrize("hp,nt", [(32, 7), (64, 3), (96, 7), (128, 7), (128, 0)])
def test_mask_words_match_relu(hp, nt):
    """The mask words of a few 64-column tiles: each bit, through
    :func:`tf32_mask_layout`, is its activation's ``> 0``; every (row,
    column) of a tile is held by one bit of one thread; the word count is
    the kernel's; thread 5 (g 1, q 1) holds row 1, column 2 in bit 0 and
    row 9, column 3 in bit 3."""
    rng = np.random.default_rng(hp + nt)
    k = 3 * 64
    acts = [torch.from_numpy(np.maximum(rng.normal(size=(k, hp)), 0).astype(np.float32))
            for _ in range(nt + 1)]
    acts.append(torch.from_numpy(rng.normal(size=(k, hp // 2)).astype(np.float32)))
    words = ftl.tf32_mask_words(acts, hp)
    mw = -(-hp // 64)
    assert words.shape == (k // 64, (nt + 1) * mw + 1, 128) and words.dtype == torch.int32
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    for li, act in enumerate(acts):
        width = hp if li <= nt else hp // 2
        rows, cols = ftl.tf32_mask_layout(width)
        assert sorted((rows * width + cols).reshape(-1).tolist()) == list(range(64 * width))
        first = li * mw if li <= nt else (nt + 1) * mw
        i = torch.arange(width // 2)
        bits = (w64[:, first + i // 32, :] >> (i % 32)[None, :, None]) & 1  # [tile, i, t]
        want = (act.reshape(k // 64, 64, width)[:, rows, cols] > 0).to(torch.int64)
        assert torch.equal(bits.transpose(1, 2), want)
    rows, cols = ftl.tf32_mask_layout(hp)
    assert (int(rows[5, 0]), int(cols[5, 0])) == (1, 2)
    assert (int(rows[5, 3]), int(cols[5, 3])) == (9, 3)


# ---- the pass's arithmetic, emulated, against JAX
def _f32(x):
    return np.asarray(x, np.float32)


def _fma(a, b, c):
    """float32 fmaf: the product and sum in float64, rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _scan(x, op, reverse=False):
    """The kernels' warp scan of ``x`` [rays, 32] (inclusive, Hillis-Steele:
    steps of 1, 2, 4, 8, 16 lanes), from the last lane with ``reverse``."""
    x = x[:, ::-1].copy() if reverse else x.copy()
    for s in (1, 2, 4, 8, 16):
        t = x.copy()
        t[:, s:] = op(x[:, s:], x[:, :-s])
        x = t
    return x[:, ::-1] if reverse else x


def _butterfly(x):
    """A warp's xor-butterfly sum of x [rays, 32] (strides 16 .. 1), lane 0."""
    x = x.copy()
    for s in (16, 8, 4, 2, 1):
        x = x + x[:, np.arange(32) ^ s]
    return x[:, 0]


def emulate_composite(raw, z, dists, noise, target, depth_gt, depth_coef, white, luma):
    """train_composite.cuh on raw [N, S, 4] (float32 numpy): (loss per ray,
    weights, rgb, raw cotangents [N, S, 4])."""
    N, S = z.shape
    P = -(-S // 32) * 32
    ok = np.arange(P) < S
    pad = lambda a, v=0.0: np.concatenate(
        [a, np.full((N, P - S) + a.shape[2:], v, np.float32)], 1)
    rw = pad(raw)
    sp = rw[..., 3] + (pad(noise) if noise is not None else 0.0)
    ds = pad(dists)
    keep = np.where(ok, _f32(np.exp(-np.maximum(sp, 0.0) * ds, dtype=np.float32)),
                    np.float32(1.0)).astype(np.float32)  # 1 - alpha, kept
    alpha = _f32(1.0 - keep)
    incl0 = np.where(ok, _f32(keep + np.float32(1e-10)), np.float32(1.0))
    w = np.zeros((N, P), np.float32)
    tr = np.zeros((N, P), np.float32)
    carry = np.ones(N, np.float32)
    sums = np.zeros((N, 32, 5), np.float32)
    c = _f32(1.0 / (1.0 + np.exp(-rw[..., :3], dtype=np.float32)))
    zz = pad(z)
    for j in range(0, P, 32):
        sl = slice(j, j + 32)
        incl = _scan(incl0[:, sl], lambda a, b: _f32(a * b))
        excl = np.concatenate([np.ones((N, 1), np.float32), incl[:, :-1]], 1)
        tr[:, sl] = _f32(carry[:, None] * excl)
        w[:, sl] = _f32(alpha[:, sl] * tr[:, sl])
        carry = _f32(carry * incl[:, 31])
        wk = np.where(ok[sl], w[:, sl], 0.0)
        for i, val in enumerate((wk * c[:, sl, 0], wk * c[:, sl, 1], wk * c[:, sl, 2],
                                 wk * zz[:, sl], wk)):
            sums[:, :, i] = _f32(sums[:, :, i] + _f32(val))
    rr, gg, bb, dep, ac = (_butterfly(sums[:, :, i]) for i in range(5))
    if white:
        rr, gg, bb = (_f32(v + _f32(1.0 - ac)) for v in (rr, gg, bb))
    e = [_f32(v - target[:, i]) for i, v in enumerate((rr, gg, bb))]
    if luma:
        ey = _f32(_f32(_f32(0.299 * e[0]) + _f32(0.587 * e[1])) + _f32(0.114 * e[2]))
        loss = _f32(ey * ey)
        g = [_f32(_f32(2.0 * ey) * np.float32(k)) for k in (0.299, 0.587, 0.114)]
    else:
        loss = _f32(_f32(e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])
        g = [_f32(2.0 * v) for v in e]
    gdep = np.zeros(N, np.float32)
    if depth_gt is not None:
        ed = _f32(dep - depth_gt)
        loss = _f32(loss + _f32(depth_coef * ed) * ed)
        gdep = _f32(_f32(2.0 * depth_coef) * ed)
    gsum = _f32(g[0] + g[1] + g[2])
    gw = _f32(g[0][:, None] * c[..., 0] + g[1][:, None] * c[..., 1] + g[2][:, None] * c[..., 2])
    if white:
        gw = _f32(gw - gsum[:, None])
    if depth_gt is not None:
        gw = _f32(gw + gdep[:, None] * zz)
    gw = np.where(ok, gw, 0.0).astype(np.float32)
    v = _f32(gw * w)
    later = np.zeros(N, np.float32)
    suffix = np.zeros((N, P), np.float32)
    for j in range(P - 32, -1, -32):
        sl = slice(j, j + 32)
        incl = _scan(v[:, sl], lambda a, b: _f32(a + b), reverse=True)
        excl = np.concatenate([incl[:, 1:], np.zeros((N, 1), np.float32)], 1)
        suffix[:, sl] = _f32(later[:, None] + excl)
        later = _f32(later + incl[:, 0])
    qd = np.maximum(_f32(keep + np.float32(1e-10)), np.float32(1e-10))
    galpha = _f32(_f32(tr * gw) - _f32(suffix / qd))
    graw = np.zeros((N, P, 4), np.float32)
    for i in range(3):
        graw[..., i] = _f32(_f32(_f32(w * g[i][:, None]) * c[..., i]) * _f32(1.0 - c[..., i]))
    graw[..., 3] = np.where(sp > 0, _f32(_f32(galpha * ds) * keep), 0.0)
    graw[:, S:] = 0.0
    return loss, w[:, :S], np.stack([rr, gg, bb], -1), graw[:, :S]


def _dy_sums(dy, s_pad):
    """The chain's per-ray sums of dy [N, s_pad, H/2]: per 64-column tile,
    thread (warp, g) adds its rows g and g + 8, the 8 g's as an xor
    butterfly (strides 4, 8, 16 of the lane: g 1, 2, 4), the 4 warps as
    (w0 + w1) + (w2 + w3); the ray's tiles in order."""
    N, _, C = dy.shape
    t = dy.reshape(N, s_pad // 64, 4, 2, 8, C)  # [ray, tile, warp, half, g, col]
    x = _f32(t[:, :, :, 0] + t[:, :, :, 1])  # [ray, tile, warp, g, col]
    for s in (1, 2, 4):
        x = _f32(x + x[:, :, :, np.arange(8) ^ s])
    w = x[:, :, :, 0]
    tile = _f32(_f32(w[:, :, 0] + w[:, :, 1]) + _f32(w[:, :, 2] + w[:, :, 3]))
    out = np.zeros((N, C), np.float32)
    for i in range(tile.shape[1]):
        out = _f32(out + tile[:, i])
    return out


def _vec(aux, off, i, n):
    return aux[off[i]:off[i] + n].numpy()


def _prod(x, pair, total=None):
    """x @ w in the kernel's split-TF32 order (``pair``: w's hi, lo [N, K])."""
    wh, wl = (w.t().numpy() for w in pair)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    xh, xl = (t.numpy() for t in split(F.pad(xt, (0, wh.shape[0] - x.shape[-1]))))
    return promoted(xh, xl, wh, wl, total=total)


def emulate_forward(m, enc, view, s_pad):
    """The f32 forward's arithmetic (kernel 4's, and the field kernels')
    on the xyz encodings ``enc`` [N s_pad, dx] (rows ray-major: ray r's
    sample s at row r s_pad + s) and the per-ray viewdir encodings ``view``
    [N, dd]: a dict of the activations at the padded width (``a``: a_0 ..
    a_nt, ``feat``, ``yv``) and ``raw`` [N, s_pad, 4]."""
    H, nt = m.hidden_size, m.num_layers - 1
    Hp = fr.bf16_hidden(H)
    wq, aux, off = fr.pack_flex_weights_tf32(m)
    fops = iter(unpack(m, wq))
    N = view.shape[0]

    def vec(i, n):
        return _vec(aux, off, i, n)

    # layer1 on the CUDA cores: a sequential f32 FMA chain over the features
    next(fops)
    w1 = ftl.pack_layer1_f32(m).numpy()
    acc = np.zeros((enc.shape[0], Hp), np.float32)
    for k in range(m.dim_xyz):
        acc = _fma(enc[:, k:k + 1], w1[k], acc)
    a = [_f32(acc + vec(0, Hp))]
    for i in range(nt):
        y = _prod(a[-1], next(fops))
        if i in m.skips:
            y = _prod(enc, next(fops), y)
        a.append(np.maximum(_f32(y + vec(1 + i, Hp)), 0.0))
    sigma = _f32(a[-1].astype(np.float64) @ vec(nt + 3, Hp) + vec(nt + 4, 1))
    feat = np.maximum(_f32(_prod(a[-1], next(fops)) + vec(nt + 1, Hp)), 0.0)
    wdv = vec(nt + 7, m.dim_dir * Hp // 2).reshape(m.dim_dir, Hp // 2)
    dirb = _f32(vec(nt + 2, Hp // 2) + _f32(view.astype(np.float64) @ wdv))
    yv = np.maximum(_f32(_prod(feat, next(fops)) + np.repeat(dirb, s_pad, 0)), 0.0)
    w_rgb = vec(nt + 5, Hp // 2 * 3).reshape(Hp // 2, 3)
    rgb_l = _f32(yv.astype(np.float64) @ w_rgb + vec(nt + 6, 3))
    raw = np.concatenate([rgb_l, sigma[:, None]], 1).reshape(N, s_pad, 4)
    return dict(a=a, feat=feat, yv=yv, raw=raw)


def emulate_chain(m, fwd, g):
    """The cotangent chain's arithmetic from the raw cotangents ``g`` [N
    s_pad, 4] (0 on padding rows) through the forward ``fwd``
    (:func:`emulate_forward`): ``dy``, ``dfeat`` and ``dl`` (d_0 .. d_nt)
    at the padded width."""
    Hp, nt = fr.bf16_hidden(m.hidden_size), m.num_layers - 1
    _, aux, off = fr.pack_flex_weights_tf32(m)
    bops = iter(unpack_chunks(ftl.pack_backward_weights_tf32(m), backward_shapes(m)))
    a = fwd["a"]
    w_rgb = _vec(aux, off, nt + 5, Hp // 2 * 3).reshape(Hp // 2, 3)
    dy = _fma(g[:, 2:3], w_rgb[:, 2], _fma(g[:, 1:2], w_rgb[:, 1], _f32(g[:, :1] * w_rgb[:, 0])))
    dy = np.where(fwd["yv"] > 0, dy, 0.0).astype(np.float32)
    dfeat = np.where(fwd["feat"] > 0, _prod(dy, next(bops)), 0.0).astype(np.float32)
    dl = [None] * (nt + 1)
    x = _fma(g[:, 3:4], _vec(aux, off, nt + 3, Hp), _prod(dfeat, next(bops)))
    dl[nt] = np.where(a[nt] > 0, x, 0.0).astype(np.float32) if nt > 0 else x
    for i in range(nt - 1, -1, -1):
        x = _prod(dl[i + 1], next(bops))
        dl[i] = np.where(a[i] > 0, x, 0.0).astype(np.float32) if i > 0 else x
    return dict(dy=dy, dfeat=dfeat, dl=dl)


def scratch_chunks(m, enc, view, fwd, bwd, g, s_pad, chunk):
    """The emulated scratch (the model's widths) of chunks of ``chunk``
    rays, as :func:`emulate_dw` takes it: (rays, act, dlt, dir_enc,
    dy_sum) each, dy_sum in the chain's order (:func:`_dy_sums`)."""
    H, nt = m.hidden_size, m.num_layers - 1
    N = view.shape[0]
    R = wgr.scratch_rows(m)
    act = np.zeros((R["act_rows"], N * s_pad), np.float32)
    dlt = np.zeros((R["dlt_rows"], N * s_pad), np.float32)
    act[:m.dim_xyz] = enc.T
    for i in range(nt + 1):
        act[R["a"][i]:R["a"][i] + H] = fwd["a"][i][:, :H].T
        dlt[R["d"][i]:R["d"][i] + H] = bwd["dl"][i][:, :H].T
    act[R["feat"]:R["feat"] + H] = fwd["feat"][:, :H].T
    act[R["y"]:R["y"] + H // 2] = fwd["yv"][:, :H // 2].T
    dlt[R["d"][nt + 1]:R["d"][nt + 1] + H] = bwd["dfeat"][:, :H].T
    dlt[R["dsig"]] = g[:, 3]
    dlt[R["dy"]:R["dy"] + H // 2] = bwd["dy"][:, :H // 2].T
    dlt[R["drgb"]:R["drgb"] + 3] = g[:, :3].T
    dys = _dy_sums(bwd["dy"][:, :H // 2].reshape(N, s_pad, H // 2), s_pad)
    chunks = []
    for r0 in range(0, N, chunk):
        n = min(chunk, N - r0)
        cols = slice(r0 * s_pad, (r0 + n) * s_pad)
        chunks.append((n, act[:, cols].copy(), dlt[:, cols].copy(),
                       view[r0:r0 + n].T.copy(), dys[r0:r0 + n].T.copy()))
    return chunks


def emulate_pass(m, inp, *, white, luma, noise, depth, chunk, grid):
    """The f32 pass's arithmetic on ``inp`` (float32 numpy): (loss sum,
    weights, rgb, flat gradient)."""
    z = inp["z_vals"]
    N, S = z.shape
    s_pad = -(-S // 64) * 64
    zp = np.concatenate([z, np.zeros((N, s_pad - S), np.float32)], 1)
    o, d = torch.tensor(inp["origins"]), torch.tensor(inp["directions"])
    pts = o[:, None] + d[:, None] * torch.from_numpy(zp)[..., None]
    enc = positional_encoding(pts, m.num_encoding_fn_xyz, m.include_input_xyz).reshape(
        N * s_pad, -1).numpy()
    view = positional_encoding(torch.tensor(inp["viewdirs"]), m.num_encoding_fn_dir,
                               m.include_input_dir).numpy()
    fwd = emulate_forward(m, enc, view, s_pad)
    loss, w, rgb, graw = emulate_composite(
        fwd["raw"][:, :S], z, inp["dists"], inp["noise"] if noise else None, inp["target"],
        inp["depth_gt"] if depth else None, inp["depth_coef"] if depth else None, white, luma)
    g = np.concatenate([graw, np.zeros((N, s_pad - S, 4), np.float32)], 1).reshape(-1, 4)
    bwd = emulate_chain(m, fwd, g)
    chunks = scratch_chunks(m, enc, view, fwd, bwd, g, s_pad, chunk)
    loss_sum = np.float32(0.0)
    for v in loss:
        loss_sum = np.float32(loss_sum + v)
    return float(loss_sum), w, rgb, emulate_dw(m, chunks, grid)


@pytest.fixture(scope="module")
def jax_mod():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    return jax, jnp, encoding_dim, JFlex, make_fused_pass_loss


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = stratified_z_vals(torch.full((n,), 2.0), torch.full((n,), 6.0), s).numpy()
    z = (z + rng.uniform(0.0, 4.0 / s, size=z.shape)).astype(np.float32)
    dists = ray_dists(torch.tensor(z), torch.tensor(rd)).numpy()
    return dict(
        origins=ro, directions=rd, z_vals=z, viewdirs=vd, dists=dists,
        noise=(0.5 * rng.normal(size=(n, s))).astype(np.float32),
        target=rng.uniform(size=(n, 3)).astype(np.float32),
        depth_gt=np.r_[0.0, np.linspace(2.5, 5.5, n - 1)].astype(np.float32),
        depth_coef=(rng.uniform(0.1, 1.0, size=n) * (np.arange(n) > 0)).astype(np.float32),
    )


CASES = {  # arch, S, rays, supervision, white, noise, depth, chunk
    "8x16-s64-rgb-noise-depth": ("8x16", 64, 7, "rgb", False, True, True, 3),
    "8x16-s128-luma-white-noise": ("8x16", 128, 5, "luminance", True, True, False, 2),
    "8x128-s64-rgb-noise-depth": ("8x128", 64, 4, "rgb", False, True, True, 3),
    "8x128-s128-luma-noise": ("8x128", 128, 3, "luminance", False, True, False, 2),
}


def _plain_grads(m, inp, dtype, *, white, sup, noise, depth):
    """The port's plain version's (loss, weights, rgb, leaves by name) at
    ``dtype`` on the same weights and inputs."""
    import copy

    md = copy.deepcopy(m).to(dtype)
    t = {k: torch.tensor(v, dtype=dtype) for k, v in inp.items()}
    out = ftl.fused_pass_loss_reference(
        md, t["origins"], t["directions"], t["z_vals"], t["viewdirs"], t["dists"],
        t["noise"] if noise else None, t["target"],
        *((t["depth_gt"], t["depth_coef"]) if depth else ()),
        white_background=white, supervision=sup)
    return out[0], out[1], out[2], {n: g.double().numpy()
                                    for (n, _), g in zip(md.named_parameters(), out[3])}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_emulated_pass_matches_jax_kernel4(jax_mod, case):
    """The emulation (forward, compositing, chain, the dW launch on 5 CTAs)
    against the JAX package's f32 fused pass loss in interpret mode on the
    same weights (σ head scaled x30: saturated and transparent samples) and
    inputs: loss, weights, rgb, and every gradient leaf to 1e-4 of its own
    largest entry (in the float64 plain version). Where the port's f32 plain
    version itself misses the JAX kernel by more than that (luminance under
    a white background: the saturated samples' cancellation, the JAX
    kernel up to 1e-2 of a leaf's scale from float64), the leaf is held to
    the float64 plain version instead, as the card tests hold the kernel:
    at most 10 times the f32 version's own error, + 1e-5 of the
    scale, where the f32 version's own error is the larger of the port's
    plain version's and the JAX kernel's (a leaf whose f32 value rounding
    alone moves by 1e-2, as fc_alpha's in that case, allows as much). The
    float64 rule holds on every leaf."""
    jax, jnp, encoding_dim, JFlex, make_fused_pass_loss = jax_mod
    arch, S, n, sup, white, noise, depth, chunk = CASES[case]
    cfg = ARCHS[arch]
    jm = JFlex(**cfg)
    in_dim = encoding_dim(3, cfg["num_encoding_fn_xyz"]) + encoding_dim(
        3, cfg["num_encoding_fn_dir"])
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(S + n), jnp.ones((1, in_dim))))
    tree["params"][f"Dense_{cfg['num_layers'] + 1}"]["kernel"] *= 30.0
    m = FlexibleNeRFModel(**cfg)
    m.load_state_dict(state_dict_from_flax(tree))
    inp = _inputs(n, S, S + n)
    fn = make_fused_pass_loss(jm, block_samples=128, white_background=white, supervision=sup,
                              interpret=True)
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    extra = (a["depth_gt"], a["depth_coef"]) if depth else ()

    def f(params):
        loss, w, rgb = fn(params, a["origins"], a["directions"], a["z_vals"], a["viewdirs"],
                          a["dists"], a["noise"] if noise else None, a["target"], *extra)
        return loss, (w, rgb)

    (j_loss, (j_w, j_rgb)), j_g = jax.value_and_grad(f, has_aux=True)(tree)
    want = {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, j_g)).items()}
    loss, w, rgb, flat = emulate_pass(m, inp, white=white, luma=sup == "luminance", noise=noise,
                                      depth=depth, chunk=chunk, grid=5)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w, np.asarray(j_w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rgb, np.asarray(j_rgb), rtol=RTOL, atol=ATOL)
    kw = dict(white=white, sup=sup, noise=noise, depth=depth)
    plain = _plain_grads(m, inp, torch.float32, **kw)[3]
    exact = _plain_grads(m, inp, torch.float64, **kw)[3]
    offs, _ = wgr._param_offsets(m)
    held_to_jax = 0
    for name, p in m.named_parameters():
        g = flat[offs[name]:offs[name] + p.numel()].reshape(p.shape).astype(np.float64)
        assert np.isfinite(g).all(), name
        scale = float(np.abs(exact[name]).max())
        err_64 = float(np.abs(g - exact[name]).max())
        own_64 = max(float(np.abs(plain[name] - exact[name]).max()),
                     float(np.abs(want[name] - exact[name]).max()))
        assert err_64 <= 10.0 * own_64 + 1e-5 * scale, (name, err_64, own_64, scale)
        if float(np.abs(plain[name] - want[name]).max()) <= GRAD_RTOL * scale:
            held_to_jax += 1
            err = float(np.abs(g - want[name]).max())
            assert err <= GRAD_RTOL * scale, (name, err, scale)
    assert held_to_jax >= (len(want) if sup == "rgb" else 1)


def test_emulated_composite_matches_plain():
    """The warp-scan compositing emulation against the plain composite
    and its autograd on one set of raw outputs (S = 100: a partial last
    warp chunk), every term on: weights, rgb, loss, raw cotangents."""
    from dexnerf_tpu_torch.core.volrend import composite

    rng = np.random.default_rng(1)
    n, s = 6, 100
    inp = _inputs(n, s, 11)
    raw = np.concatenate([rng.normal(size=(n, s, 3)), 20.0 * rng.normal(size=(n, s, 1))],
                         -1).astype(np.float32)
    loss, w, rgb, graw = emulate_composite(
        raw, inp["z_vals"], inp["dists"], inp["noise"], inp["target"], inp["depth_gt"],
        inp["depth_coef"], True, False)
    r = torch.tensor(raw, requires_grad=True)
    out = composite(r, torch.tensor(inp["z_vals"]), torch.tensor(inp["dists"]),
                    white_background=True, sigma_noise=torch.tensor(inp["noise"]))
    per_ray = ((out.rgb - torch.tensor(inp["target"])) ** 2).sum(-1) + torch.tensor(
        inp["depth_coef"]) * (out.depth - torch.tensor(inp["depth_gt"])) ** 2
    per_ray.sum().backward()
    np.testing.assert_allclose(w, out.weights.detach().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rgb, out.rgb.detach().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, per_ray.detach().numpy(), rtol=LOSS_RTOL, atol=1e-7)
    gr = r.grad.numpy()
    np.testing.assert_allclose(graw, gr, rtol=0, atol=1e-5 * float(np.abs(gr).max()))


# ---- on the card: the pass kernels' buffers against the plain version
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_pass(cuda, arch, n, s, seed=9):
    """One chunk of the f32 pass kernels on a seeded model (σ head x30) and
    inputs: the Tf32Pass, its WeightGradients, the model and the inputs."""
    from dexnerf_tpu_torch.ops._build import load_library

    m = _model({**ARCHS, **WIDE_ARCHS}[arch], seed).to(cuda)
    with torch.no_grad():
        m.fc_alpha.weight.mul_(30.0)
    inp = {k: torch.tensor(v, device=cuda) for k, v in _inputs(n, s, seed).items()}
    s_pad = -(-s // 64) * 64
    lib = load_library()
    wg = wgr.WeightGradients(lib, m, n, n, s_pad, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    bufs = dict(origins=inp["origins"], dirs=inp["directions"], viewdirs=inp["viewdirs"],
                z=inp["z_vals"], dists=inp["dists"], noise=inp["noise"], target=inp["target"],
                depth_gt=None, depth_coef=None, weights_out=torch.empty((n, s), **f32),
                rgb_out=torch.empty((n, 3), **f32), loss_ray=torch.empty((n,), **f32))
    ps = ftl.Tf32Pass(lib, m, bufs, n, s, s_pad, n, wg, white_background=False,
                      supervision="rgb", log_sampling_xyz=True, log_sampling_dir=True)
    ps.run(0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return ps, wg, m, inp, s_pad


def _chain64(m, act, graw):
    """The cotangent chain in float64 on the kernel's own saved activations
    (their ReLU masks: ``> 0``) and raw cotangents ([k, 4]): dy, d_feat,
    d_nt .. d_0 as [k, width] each, by :func:`~wgr.scratch_rows`."""
    R = wgr.scratch_rows(m)
    H, nt = m.hidden_size, m.num_layers - 1
    w = {n: p.detach().double() for n, p in m.named_parameters()}
    a = torch.from_numpy(act).double()

    def rows(r0, n):
        return a[r0:r0 + n].T

    g = torch.from_numpy(graw).double()
    dy = (g[:, :3] @ w["fc_rgb.weight"]) * (rows(R["y"], H // 2) > 0)
    d = {"dy": dy}
    x = (dy @ w["layers_dir.0.weight"][:, :H]) * (rows(R["feat"], H) > 0)
    d["dfeat"] = x
    x = x @ w["fc_feat.weight"] + g[:, 3:4] * w["fc_alpha.weight"]
    for i in range(nt, -1, -1):
        if i > 0:
            x = x * (rows(R["a"][i], H) > 0)
        d[i] = x
        if i > 0:
            x = x @ w[f"layers_xyz.{i - 1}.weight"][:, :H]
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n,s", [("8x128", 40, 64), ("8x16", 33, 100), ("8x48", 17, 128),
                                    ("8x136", 21, 100), ("8x256", 13, 64),
                                    (f"8x{fr.MAX_HIDDEN}", 5, 128)])
def test_pass_buffers_match_plain_on_card(cuda, arch, n, s):
    """One chunk's buffers. The activations against the plain f32 model's
    (every block to 1e-4 of its largest entry on the real columns; padding
    columns finite); the mask words equal to :func:`tf32_mask_words` of the
    kernel's own activations (their layout), and a bit that differs from
    the plain activations' only where the plain value lies within that
    tolerance of 0; the cotangents against a float64 chain on the kernel's
    own raw cotangents and masks (every block to 1e-4 of its largest entry;
    padding columns exactly 0: the weight gradients sum every column). A
    ReLU mask flipped by a near-zero activation moves a cotangent by a
    whole entry, so the cotangents are not held to the plain model's own
    chain. dir_enc and dy_sum against the plain version and the kernel's dy
    rows."""
    ps, wg, m, inp, s_pad = _card_pass(cuda, arch, n, s)
    H, nt = m.hidden_size, m.num_layers - 1
    Hp = fr.bf16_hidden(H)
    mc = m.cpu()
    t = {k: v.cpu() for k, v in inp.items()}
    pts = t["origins"][:, None] + t["directions"][:, None] * t["z_vals"][..., None]
    xyz = positional_encoding(pts, mc.num_encoding_fn_xyz, mc.include_input_xyz)
    view = positional_encoding(t["viewdirs"], mc.num_encoding_fn_dir, mc.include_input_dir)
    from dexnerf_tpu_torch.core.volrend import composite

    def loss_of(raw):
        out = composite(raw, t["z_vals"], t["dists"], sigma_noise=t["noise"])
        return ((out.rgb - t["target"]) ** 2).sum()

    (_, act, _, de, _), = saved_scratch(mc, loss_of, xyz, view, n, s_pad)
    R = wgr.scratch_rows(mc)
    k = n * s_pad
    got_a = wg.act.cpu()[:R["act_rows"] * k].reshape(R["act_rows"], k).numpy()
    got_d = wg.dlt.cpu()[:R["dlt_rows"] * k].reshape(R["dlt_rows"], k).numpy()
    real = (np.arange(s_pad) < s)[None, :].repeat(n, 0).reshape(-1)
    assert np.isfinite(got_a).all() and np.isfinite(got_d).all()
    assert not got_d[:, ~real].any()
    tol = {}
    for r0, w in [(0, m.dim_xyz)] + [(r, H) for r in R["a"]] + [(R["feat"], H),
                                                                (R["y"], H // 2)]:
        g, wv = got_a[r0:r0 + w, real], act[r0:r0 + w, real]
        scale = float(np.abs(wv).max())
        tol[r0] = 1e-4 * scale
        assert float(np.abs(g - wv).max()) <= tol[r0], (r0, float(np.abs(g - wv).max()), scale)
    # the mask words: the kernel's layout of its own activations, exactly;
    # against the plain activations, only near-zero values differ
    recorded = [R["a"][i] for i in range(1, nt + 1)] + [R["feat"], R["y"]]

    def words(buf):
        acts = [torch.from_numpy(buf[r:r + (H if r != R["y"] else H // 2)].T.copy())
                for r in recorded]
        acts = [F.pad(x, (0, (Hp if i < nt + 1 else Hp // 2) - x.shape[1]))
                for i, x in enumerate(acts)]
        return ftl.tf32_mask_words(acts, Hp)

    got_m = ps.masks.cpu()[:k // 64 * ps.tile_words * 128].reshape(k // 64, ps.tile_words, 128)
    assert torch.equal(got_m, words(got_a))
    for r0 in recorded:
        w = H if r0 != R["y"] else H // 2
        flip = ((got_a[r0:r0 + w] > 0) != (act[r0:r0 + w] > 0)) & real[None, :]
        assert (np.abs(act[r0:r0 + w][flip]) <= tol[r0]).all(), r0
    # the cotangents: the chain's arithmetic on its own inputs
    graw = ps.graw.cpu()[:k * 4].reshape(k, 4).numpy()
    want = _chain64(mc, got_a, graw)
    blocks = [(R["dy"], H // 2, want["dy"]), (R["d"][nt + 1], H, want["dfeat"])]
    blocks += [(R["d"][i], H, want[i]) for i in range(nt + 1)]
    blocks += [(R["dsig"], 1, graw[:, 3:4]), (R["drgb"], 3, graw[:, :3])]
    for r0, w, wv in blocks:
        wv = np.asarray(wv, np.float64)[real]
        g = got_d[r0:r0 + w, real].T
        scale = float(np.abs(wv).max())
        assert float(np.abs(g - wv).max()) <= 1e-4 * scale, (r0, float(np.abs(g - wv).max()), scale)
    np.testing.assert_allclose(wg.dir_enc.cpu()[:m.dim_dir * n].reshape(-1, n).numpy(), de,
                               rtol=1e-6, atol=1e-6)
    dys = wg.dy_sum.cpu()[:H // 2 * n].reshape(-1, n).numpy()
    want_dys = got_d[R["dy"]:R["dy"] + H // 2].astype(np.float64).reshape(H // 2, n, s_pad).sum(-1)
    assert float(np.abs(dys - want_dys).max()) <= 1e-5 * float(np.abs(want_dys).max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(WIDE_ARCHS))
def test_wide_pass_bitwise_repeatable_on_card(cuda, arch):
    """The wide route's forward and chain (``train_fwd_wide_tf32_kernel<4>``,
    ``train_chain_wide_tf32_kernel<4>``: the software-pipelined split-TF32
    product, a fresh accumulator a half-block and chunk added in a fixed
    order) run twice on the same chunk write the same scratch, mask words
    and per-ray buffers, bit for bit; so does kernel 2's wide forward
    (``train_fwd_wide_tf32_kernel<2>``) on the same points."""
    from dexnerf_tpu_torch.ops import fused_mlp

    ps, wg, m, inp, s_pad = _card_pass(cuda, arch, 45, 128)
    first = [t.clone() for t in (wg.act, wg.dlt, wg.dir_enc, wg.dy_sum, ps.masks, ps.graw)]
    ps.run(0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for a, b in zip(first, (wg.act, wg.dlt, wg.dir_enc, wg.dy_sum, ps.masks, ps.graw)):
        assert torch.equal(a, b)
    pts = (inp["origins"][:, None] + inp["directions"][:, None] * inp["z_vals"][..., None])
    before = fused_mlp.launches_wide_f32
    raw = [fused_mlp.fused_field(m, pts.contiguous(), inp["viewdirs"]) for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_mlp.launches_wide_f32 == before + 2
    assert torch.equal(raw[0], raw[1])


@pytest.mark.gpu
def test_pass_bitwise_repeatable_on_card(cuda):
    """Two runs of the same chunk write the same scratch, masks and per-ray
    buffers, bit for bit."""
    ps, wg, m, inp, s_pad = _card_pass(cuda, "8x128", 45, 128)
    first = [t.clone() for t in (wg.act, wg.dlt, wg.dir_enc, wg.dy_sum, ps.masks, ps.graw)]
    ps.run(0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for a, b in zip(first, (wg.act, wg.dlt, wg.dir_enc, wg.dy_sum, ps.masks, ps.graw)):
        assert torch.equal(a, b)
