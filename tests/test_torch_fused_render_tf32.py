"""The float32 route of the fused render (``ops/csrc/fused_render.cu``:
split TF32 on the tensor cores) and its weight pack
(``ops/fused_render.py::pack_flex_weights_tf32``), on the CPU.

The kernel runs only on the card (``tests/test_torch_fused_render.py`` holds
it to the plain version there). Here: the pack's layout, its hi/lo split and
its cache; the work plan at the route's two workers a CTA; a model of how
the order of the split products and the tensor cores' accumulator rounding
set one layer's error; and a plain emulation of the kernel's arithmetic,
kept in this file and not in the package (TF32 rounding by bit operations;
per K-chunk of 32, the lo.hi and hi.lo terms then the hi.hi terms, each k8
step rounded toward zero into a fresh accumulator that is then added to the
layer's sum in float32; on the hi and lo tensors of the pack), held at full
width to the JAX package's f32 fused render (interpret mode) and to the
port's plain version. The JAX package is imported inside a fixture.
"""

import copy
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
from dexnerf_tpu_torch.core.volrend import composite, ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_render as fr

RTOL, ATOL = 1e-4, 1e-5  # the f32 contract's tolerances
DEX_EQUAL = 0.9999
FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
N_RAYS = 48
THRESHOLDS = tuple(5.0 * (i + 1) for i in range(20))


def tf32_bits(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 (nearest, ties away from zero) by bit
    operations on its IEEE pattern."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)), by :func:`tf32_bits`."""
    hi = torch.from_numpy(tf32_bits(x.numpy()))
    return hi, torch.from_numpy(tf32_bits((x - hi).numpy()))


KC = 32  # K of a chunk: one ring stage of the kernel (kKc)


def round_rn(v: np.ndarray) -> np.ndarray:
    """float64 ``v`` to float32, to nearest."""
    return v.astype(np.float32)


def round_rz(v: np.ndarray) -> np.ndarray:
    """float64 ``v`` to float32, toward zero (truncation)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def chain(terms, rnd) -> np.ndarray:
    """The k8 steps ``terms`` ((A [M, K], B [K, N], K slice) each) summed
    into one float32 accumulator from zero, as ``wgmma`` does: each step's
    eight products exact, their sum added with one rounding ``rnd``."""
    acc = 0.0
    for a, b, ks in terms:
        acc = rnd(acc + a[:, ks].astype(np.float64) @ b[ks].astype(np.float64))
    return acc


def chunk_terms(xh, xl, wh, wl, c):
    """K-chunk ``c``'s k8 steps in the kernel's order (``chunk_terms`` of
    ``mlp_tile_tf32.cuh``): lo.hi and hi.lo per step, then hi.hi."""
    steps = [slice(k, k + 8) for k in range(c * KC, (c + 1) * KC, 8)]
    return ([t for s in steps for t in ((xl, wh, s), (xh, wl, s))]
            + [(xh, wh, s) for s in steps])


def promoted(xh, xl, wh, wl, rnd=round_rz, total=None) -> np.ndarray:
    """x @ w in the kernel's order: each K-chunk's twelve steps into a
    fresh accumulator (:func:`chain`), added to the running ``total`` in
    float32 to nearest (B operands [K, N], K a multiple of 32)."""
    for c in range(wh.shape[0] // KC):
        part = chain(chunk_terms(xh, xl, wh, wl, c), rnd)
        total = part if total is None else (total.astype(np.float64) + part).astype(np.float32)
    return total


def _operand_shapes(m):
    """(N rows, K, the K of the real columns) of each packed operand, in the
    kernel's consumption order, at the padded width."""
    Hp = fr.bf16_hidden(m.hidden_size)
    dxp = -(-m.dim_xyz // 32) * 32
    out = [(Hp, dxp, m.dim_xyz)]
    for i in range(m.num_layers - 1):
        out.append((Hp, Hp, m.hidden_size))
        if i in m.skips:
            out.append((Hp, dxp, m.dim_xyz))
    return out + [(Hp, Hp, m.hidden_size), (Hp // 2, Hp, m.hidden_size)]


def unpack(m, wq):
    """The pack's operands as (hi, lo) [N, K] matrices in feature order."""
    order = fr.tf32_feature_order(1024)
    pos, out = 0, []
    for n, k, _ in _operand_shapes(m):
        halves = []
        for c in range(k // 32):
            for h in range(2):
                g = wq[pos:pos + n * 32].reshape(n, 8, 4)
                pos += n * 32
                j = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)
                halves.append((h, c, g[torch.arange(n)[:, None], j].reshape(n, 32)))
        mats = []
        for h in range(2):
            w = torch.cat([blk for hh, _, blk in halves if hh == h], dim=1)
            nat = torch.empty_like(w)
            nat[:, order[:k]] = w  # position p holds feature order[p]
            mats.append(nat)
        out.append(tuple(mats))
    assert pos == wq.numel()
    return out


def _model(arch, seed):
    return FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed))


def _real_weights(m):
    H = m.hidden_size
    ws = [m.layer1.weight]
    for i, layer in enumerate(m.layers_xyz):
        ws.append(layer.weight[:, :H])
        if i in m.skips:
            ws.append(layer.weight[:, H:])
    return [w.detach() for w in ws + [m.fc_feat.weight, m.layers_dir[0].weight[:, :H]]]


@pytest.mark.parametrize("arch", [FULL, dict(FULL, hidden_size=48),
                                  dict(FULL, hidden_size=8, num_encoding_fn_xyz=16)],
                         ids=["8x128", "h48", "h8-pe16"])
def test_pack_flex_weights_tf32_layout(arch):
    """Every operand at the padded width with zero padding, K in the
    kernel's position order, swizzled; hi and lo TF32 values (13 low bits
    zero) that rebuild each weight to 2^-21 of its magnitude; the aux buffer
    as the bf16 pack's, with the viewdir rows unrounded."""
    m = _model(arch, 1)
    wq, aux, off = fr.pack_flex_weights_tf32(m)
    assert wq.dtype == torch.float32 and aux.dtype == torch.float32
    assert not (wq.view(torch.int32) & 0x1FFF).any()
    for (hi, lo), w, (n, k, kr) in zip(unpack(m, wq), _real_weights(m), _operand_shapes(m)):
        assert w.shape[1] == kr
        want = F.pad(w, (0, k - kr, 0, n - w.shape[0]))
        assert not hi[want == 0].any() and not lo[want == 0].any()  # padding and zeros
        assert torch.equal(hi, split(want)[0]) and torch.equal(lo, split(want)[1])
        assert bool(((hi + lo - want).abs() <= 2.0 ** -21 * want.abs()).all())
    # position 1 of the first chunk holds feature 2, position 4 feature 1;
    # row 9's first 16-byte group lies in its second
    Hp = fr.bf16_hidden(m.hidden_size)
    first = wq[:Hp * 32].reshape(Hp, 32)
    w1 = split(F.pad(m.layer1.weight.detach(), (0, 32, 0, Hp - m.hidden_size)))[0]
    assert torch.equal(first[0, :8], w1[0, [0, 2, 4, 6, 1, 3, 5, 7]])
    assert torch.equal(first[9, 4:8], w1[9, [0, 2, 4, 6]])
    _, aux_b, off_b = fr.pack_flex_weights_bf16(m)
    nt = m.num_layers - 1
    assert off == off_b and torch.equal(aux[:off[nt + 7]], aux_b[:off[nt + 7]])
    wdv = aux[off[nt + 7]:off[nt + 7] + m.dim_dir * Hp // 2].reshape(m.dim_dir, Hp // 2)
    want = F.pad(m.layers_dir[0].weight.detach()[:, m.hidden_size:].t(),
                 (0, Hp // 2 - m.hidden_size // 2))
    assert torch.equal(wdv, want)


def test_tf32_split_matches_bit_emulation():
    """The package's split equals the bit emulation, ties rounded away from
    zero, lo exact to the last bit of x - hi."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    ties = (rng.integers(1, 2 ** 10, 64).astype(np.uint32) << np.uint32(13)
            | np.uint32(0x1000) | np.uint32(0x3F800000)).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.zeros(1, np.float32)])
    hi, lo = fr.tf32_split(torch.from_numpy(x))
    want_hi, want_lo = split(torch.from_numpy(x))
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert bool((hi[4096:4160].abs() > torch.from_numpy(ties).abs()).all())  # away from zero
    xd = torch.from_numpy(x).double()
    assert bool(((hi.double() + lo.double() - xd).abs() <= 2.0 ** -22 * xd.abs()).all())


def test_pack_flex_weights_tf32_cached():
    """Packed once per parameter state, rebuilt after a change in place;
    apart from the bf16 pack of the same model."""
    m = _model(dict(FULL, hidden_size=32), 2)
    a = fr._cached_tf32_weights(m, "cpu")
    assert fr._cached_tf32_weights(m, "cpu") is a
    assert fr._cached_bf16_weights(m, "cpu")[0].dtype == torch.bfloat16
    assert fr._cached_tf32_weights(m, "cpu") is a
    with torch.no_grad():
        m.fc_feat.weight.add_(1.0)
    b = fr._cached_tf32_weights(m, "cpu")
    assert b is not a and not torch.equal(b[0], a[0])


@pytest.mark.parametrize("n_rays", [1, 3, 131, 160_000])
@pytest.mark.parametrize("S", [8, 64, 128, 192])
def test_render_plan_two_workers(S, n_rays):
    """The float32 route's plan: the bf16 route's units, one CTA per two
    units at most, every unit on one worker, worker 2 b the busiest of its
    CTA (its passes over the weights serve both)."""
    plan = fr.render_plan(n_rays, S, 132, fr.TF32_WORKERS)
    bf = fr.render_plan(n_rays, S, 132)
    assert plan[:5] == bf[:5] and plan.workers == 2
    assert plan.grid == min(132, -(-plan.units // 2))
    workers = fr.plan_workers(plan)
    assert len(workers) == 2 * plan.grid
    assert sorted(u for w in workers for u in w) == list(range(plan.units))
    counts = [len(w) for w in workers]
    assert all(counts[2 * b] >= counts[2 * b + 1] >= 0 and counts[2 * b]
               for b in range(plan.grid))


def _emulated_pass(m, wq, aux, off, o, d, v, z, dists, thresholds, white):
    """One render pass with the kernel's arithmetic: the encodings in f32,
    every product of layer1, the trunk (a skip layer's encoding chunks
    after its h chunks, into the same sum), fc_feat and layers_dir.0 as
    :func:`promoted` on the pack's hi and lo at the padded width; biases,
    ReLU, the heads and the per-ray viewdir bias in f32; compositing as the
    plain version."""
    ops = iter(unpack(m, wq))
    nt, Hp = m.num_layers - 1, fr.bf16_hidden(m.hidden_size)

    def prod(x, pair, total=None):
        wh, wl = (w.t().numpy() for w in pair)
        xh, xl = (t.reshape(-1, wh.shape[0]).numpy()
                  for t in split(F.pad(x, (0, wh.shape[0] - x.shape[-1]))))
        out = promoted(xh, xl, wh, wl,
                       total=None if total is None else total.reshape(xh.shape[0], -1).numpy())
        return torch.from_numpy(out).reshape(*x.shape[:-1], -1)

    def vec(i, n):
        return aux[off[i]:off[i] + n]

    pts = o[:, None] + d[:, None] * z[..., None]
    enc = positional_encoding(pts, m.num_encoding_fn_xyz, m.include_input_xyz)
    view = positional_encoding(v, m.num_encoding_fn_dir, m.include_input_dir)
    h = prod(enc, next(ops)) + vec(0, Hp)
    for i in range(nt):
        y = prod(h, next(ops))
        if i in m.skips:
            y = prod(enc, next(ops), y)
        h = torch.relu(y + vec(1 + i, Hp))
    sigma = h @ vec(nt + 3, Hp) + aux[off[nt + 4]]
    feat = torch.relu(prod(h, next(ops)) + vec(nt + 1, Hp))
    wdv = aux[off[nt + 7]:off[nt + 7] + m.dim_dir * Hp // 2].reshape(m.dim_dir, Hp // 2)
    dirb = vec(nt + 2, Hp // 2) + view @ wdv
    y = torch.relu(prod(feat, next(ops)) + dirb[:, None])
    rgb = y @ aux[off[nt + 5]:off[nt + 5] + Hp // 2 * 3].reshape(Hp // 2, 3) + vec(nt + 6, 3)
    raw = torch.cat([rgb, sigma[..., None]], -1)
    return composite(raw, z, dists, white_background=white, m_thres_cand=thresholds or None)


def accumulation_errors(rows: int = 4096, seed: int = 0) -> dict:
    """One 128 x 128 layer on ReLU-like inputs (seeded), its product in
    each order of the split terms, as the RMS, largest and mean error
    relative to the RMS of the exact (float64) product, beside an f32 FMA
    chain over K. Orders, each with the k8 steps rounded to nearest (rn) or
    toward zero (rz): ``per_chunk``, every chunk's steps (the kernel's order
    within a chunk) into one accumulator; ``small_first``, every lo.hi and
    hi.lo step, then every hi.hi step, into one accumulator; ``promoted``,
    the kernel's (:func:`promoted`)."""
    K = N = 128
    rng = np.random.default_rng(seed)
    x = (np.maximum(rng.normal(size=(rows, K)), 0) * 0.3).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    xh, wh = tf32_bits(x), tf32_bits(w)
    xl, wl = tf32_bits(x - xh), tf32_bits(w - wh)
    steps = [slice(k, k + 8) for k in range(0, K, 8)]
    per_chunk = [t for c in range(K // KC) for t in chunk_terms(xh, xl, wh, wl, c)]
    small_first = ([(xl, wh, s) for s in steps] + [(xh, wl, s) for s in steps]
                   + [(xh, wh, s) for s in steps])
    fma = np.zeros((rows, N), np.float32)
    for k in range(K):
        fma = (fma + x[:, k:k + 1].astype(np.float64) * w[k].astype(np.float64)).astype(np.float32)
    scale = np.sqrt((exact ** 2).mean())

    def err(a):
        e = (a - exact) / scale
        return {"rms": float(np.sqrt((e ** 2).mean())), "max": float(np.abs(e).max()),
                "mean": float(e.mean())}

    out = {"f32_fma": err(fma)}
    for tag, rnd in (("rn", round_rn), ("rz", round_rz)):
        out[f"per_chunk_{tag}"] = err(chain(per_chunk, rnd))
        out[f"small_first_{tag}"] = err(chain(small_first, rnd))
        out[f"promoted_{tag}"] = err(promoted(xh, xl, wh, wl, rnd))
    return out


def test_accumulation_order_model():
    """With truncating accumulators (the tensor cores' rounding as the
    card's tail errors show it), every k8 step into one accumulator errs
    beyond twice an f32 FMA chain, while the kernel's order (a fresh
    accumulator per K-chunk, added in f32) stays within the chain's error;
    to nearest, every order does. ``pytest -s`` prints the table."""
    e = accumulation_errors()
    print({k: {m: float(f"{v:.3g}") for m, v in d.items()} for k, d in e.items()})
    fma = e["f32_fma"]
    assert e["promoted_rz"]["max"] <= fma["max"] and e["promoted_rz"]["rms"] <= fma["rms"]
    assert e["per_chunk_rz"]["max"] > 2 * fma["max"] and e["per_chunk_rz"]["rms"] > 2 * fma["rms"]
    assert all(e[f"{o}_rn"]["max"] <= fma["max"] for o in ("per_chunk", "small_first", "promoted"))


def _rays(n=N_RAYS, seed=4):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((n,), 2.0, np.float32)
    return ro, rd, vd, near, near + 4.0


@pytest.fixture(scope="module")
def full():
    """The JAX package's f32 fused render (interpret mode) and a full-width
    model holding the same weights, its σ head scaled so that the σ logit
    over the coarse samples has mean 0 and std 30 (both Dex branches);
    coarse (64) and fine (128) depths of one ray batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.ops.fused_render import make_fused_render
    from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

    jm = JFlex(**FULL)
    in_dim = encoding_dim(3, 10) + encoding_dim(3, 4)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(7), jnp.ones((1, in_dim))))
    m = FlexibleNeRFModel(**FULL)
    m.load_state_dict(state_dict_from_flax(tree))
    ro, rd, vd, near, far = (torch.tensor(a) for a in _rays())
    z_c = stratified_z_vals(near, far, 64)
    with torch.no_grad():
        pts = ro[:, None] + rd[:, None] * z_c[..., None]
        raw = m(positional_encoding(pts, 10), positional_encoding(vd, 4))[..., 3]
        k = 30.0 / float(raw.std())
        shift = -float(raw.mean()) * k
    alpha = tree["params"][f"Dense_{FULL['num_layers'] + 1}"]  # fc_alpha
    alpha["kernel"] *= k
    alpha["bias"] = alpha["bias"] * k + shift
    m.load_state_dict(state_dict_from_flax(tree))
    with torch.no_grad():
        w_c = fr.fused_render_reference(m, ro, rd, vd, z_c, ray_dists(z_c, rd)).weights
    z_f, _ = hierarchical_z_vals(z_c, w_c, 64, det=True)
    return types.SimpleNamespace(jnp=jnp, jm=jm, make=make_fused_render, tree=tree, m=m,
                                 rays=(ro, rd, vd), z={64: z_c, 128: z_f})


def _pass_inputs(full, S):
    ro, rd, vd = full.rays
    z = full.z[S]
    return ro, rd, vd, z, ray_dists(z, rd), THRESHOLDS if S == 128 else ()


FIELDS = ("rgb", "weights", "depth", "accumulation", "disparity")


def _close(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("S", [64, 128])
def test_emulated_kernel_matches_jax_f32_render(full, S):
    """The kernel's arithmetic at full width (8x128, skip 3, PE 10/4) vs
    the JAX package's f32 render kernel in interpret mode, one pass of S
    samples (the fine pass with 20 Dex thresholds), within RTOL/ATOL
    wherever the f32 result is well conditioned. Under the scaled σ head
    (σ a small difference of large sums) some weights are not: there f32
    rounding alone moves the port's f32 plain version from its own float64
    run by up to 9x the tolerance, so two correct f32 results can differ by
    more than it. Those entries (the plain version beyond RTOL/ATOL of JAX,
    or beyond half of it from its float64 run; under 1% of 3072-6144) are
    held no further from JAX than the plain version, + the same RTOL/ATOL."""
    ro, rd, vd, z, dists, thr = _pass_inputs(full, S)
    wq, aux, off = fr.pack_flex_weights_tf32(full.m)
    with torch.no_grad():
        got = _emulated_pass(full.m, wq, aux, off, ro, rd, vd, z, dists, thr, False)
        plain = fr.fused_render_reference(full.m, ro, rd, vd, z, dists, thresholds=thr)
        exact = fr.fused_render_reference(copy.deepcopy(full.m).double(),
                                          *(t.double() for t in (ro, rd, vd, z, dists)),
                                          thresholds=thr)
    want = full.make(full.jm, block_samples=64, interpret=True)(
        full.tree, *(full.jnp.asarray(t.numpy()) for t in (ro, rd, vd, z, dists)),
        thresholds=thr)
    for f in FIELDS:
        g, p, w, e = (np.asarray(getattr(x, f), np.float64) for x in (got, plain, want, exact))
        tol = ATOL + RTOL * np.abs(w)
        plain_out = np.abs(p - w) > tol  # where the f32 contract itself is not within tol
        assert plain_out.mean() < 5e-3, (f, plain_out.sum())
        loose = plain_out | (np.abs(p - e) > tol / 2)  # or f32 rounding alone moves it by tol/2
        assert loose.mean() < 1e-2, (f, loose.sum())
        assert (np.abs(g - w)[~loose] <= tol[~loose]).all(), f
        assert (np.abs(g - w)[loose] <= (np.abs(p - w) + tol)[loose]).all(), f
    if thr:
        dex = got.depth_dex.numpy() == np.asarray(want.depth_dex)
        assert dex.mean() >= DEX_EQUAL, dex.mean()
        hit = got.depth_dex.numpy() != z[:, 0].numpy()[None]
        assert 0.05 < hit.mean() < 0.95  # both Dex branches occur


@pytest.mark.parametrize("S", [64, 128])
def test_emulated_kernel_matches_plain_version(full, S):
    """The same emulation vs the port's plain version (f32 throughout), the
    kernel's oracle on the card."""
    ro, rd, vd, z, dists, thr = _pass_inputs(full, S)
    wq, aux, off = fr.pack_flex_weights_tf32(full.m)
    with torch.no_grad():
        got = _emulated_pass(full.m, wq, aux, off, ro, rd, vd, z, dists, thr, True)
        want = fr.fused_render_reference(full.m, ro, rd, vd, z, dists, thresholds=thr,
                                         white_background=True)
    _close(got, want)
    if thr:
        assert (got.depth_dex == want.depth_dex).float().mean() >= DEX_EQUAL
