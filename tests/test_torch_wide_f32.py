"""The f32 kernels above a width of 128, on the CPU: the wide split-TF32
route (``ops/csrc/mlp_wide_tf32.cuh``) that kernels 1-4 take at
``compute_dtype=float32`` for padded widths above 128, up to
``MAX_HIDDEN``.

* The f32 packs at H in {136, 256, 320}: every padded entry exactly zero,
  each chunk's hi and lo halves the weights' TF32 split, the un-swizzled
  operands the model's, and every piece the wide kernels stream (rows c0 ..
  c0 + bn - 1 of a K-chunk's hi or lo half, at the offsets of
  ``WtStream``) one contiguous run of the pack holding those rows.
* The plain versions of kernels 1, 2-3 and 4 at f32, at H in {136, 256},
  against the JAX kernels at ``float32`` in interpret mode, on one set of
  weights (``state_dict_from_flax``) and the same numpy rays, draws and
  cotangents, gradients included for kernels 3 and 4. Tolerances, those of
  the narrow f32 parity tests (``tests/test_torch_train_loss.py``): f32 on
  both sides with the sums in another order, so values to ATOL (the loss to
  LOSS_RTOL) and each gradient leaf to GRAD_ATOL of its largest entry (at
  least 1).
* The split f32 dW plan: every unit within the kernel's limits, every
  flat-gradient entry written exactly once, the plan in parts of at most
  TF32_MAX_UNITS units.
* The mask words' layout at these widths (y's words past one), and
  ``MAX_HIDDEN`` reckoned as the largest width whose plans fit.

    python -m pytest tests/test_torch_wide_f32.py
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_wide import _grads, _inputs, _jx, _model, _pad_check

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import _build
from dexnerf_tpu_torch.ops import _weight_grads as wgr
from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl

F32 = torch.float32
PACK_WIDTHS = (136, 256, 320)
WIDTHS = (136, 256)
# f32 on both sides, the sums in another order (tests/test_torch_train_loss.py)
LOSS_RTOL = 1e-5
ATOL = 1e-5
GRAD_ATOL = 5e-5
KC = fr.TF32_KCHUNK


def _full(hidden):
    return _model(hidden, num_layers=8, skip_connect_every=3, num_encoding_fn_xyz=10,
                  num_encoding_fn_dir=4)


# ---- the packs


def _unpack(flat, k, n):
    """``flat`` [k/32 chunks][hi, lo][n rows][32] in wgmma's 128 B swizzle
    (16-byte group j of row r stored at j ^ (r % 8)) and the K positions of
    ``tf32_feature_order``, back to (hi, lo) [n, k] in feature order."""
    ch = flat.reshape(k // KC, 2, n, 8, 4)
    r = torch.arange(n)[:, None]
    ch = ch[:, :, r, torch.arange(8)[None, :] ^ (r % 8)]
    pos = ch.permute(1, 2, 0, 3, 4).reshape(2, n, k)
    out = torch.empty_like(pos)
    out[:, :, fr.tf32_feature_order(k)] = pos
    return out[0], out[1]


def _check_operand(flat, k, n, w, name):
    """The operand at ``flat`` holds the TF32 split of ``w`` [N, K] in the
    corner of its [n, k] block, zeros elsewhere."""
    hi, lo = _unpack(flat, k, n)
    want_hi, want_lo = fr.tf32_split(w.detach())
    _pad_check(hi, want_hi, f"{name} hi")
    _pad_check(lo, want_lo, f"{name} lo")
    nn, kk = w.shape
    assert float((hi[:nn, :kk] + lo[:nn, :kk] - w.detach()).abs().max()) <= (
        2.0 ** -20 * float(w.detach().abs().max())), name


def _pieces(n, kc, bmax):
    """The pieces the wide kernels stream of an operand of n rows and kc
    K-chunks (``WtStream::product``): per column block (``column_block``), per
    chunk, (chunk, first row, rows, hi offset, lo offset) in floats."""
    out, c0 = [], 0
    while c0 < n:
        r = n - c0
        bn = bmax if r >= bmax else (64 if r in (80, 112) else r)
        for c in range(kc):
            hi = c * 2 * n * KC + c0 * KC
            out.append((c, c0, bn, hi, hi + n * KC))
        c0 += bn
    return out


@pytest.mark.parametrize("hidden", PACK_WIDTHS)
def test_tf32_forward_pack_at_width(hidden):
    """``pack_flex_weights_tf32``: each operand, un-swizzled, is the TF32
    split of the model's weight in the corner of its padded [Hp or Hp/2,
    K] block, padding zero; every piece the wide forward streams (128- and
    64-row blocks) is the rows it names; the aux buffer is the model's."""
    m = _full(hidden)
    H, Hp = hidden, fr.bf16_hidden(hidden)
    assert Hp > fr.NARROW_HIDDEN and fr.is_wide(m)
    wq, aux, off = fr.pack_flex_weights_tf32(m)
    dxp = fr._round_up(m.dim_xyz, KC)
    ops = [("layer1", dxp, Hp, m.layer1.weight)]
    for i, lin in enumerate(m.layers_xyz):
        ops.append((f"layers_xyz.{i}", Hp, Hp, lin.weight[:, :H]))
        if i in m.skips:
            ops.append((f"layers_xyz.{i} xyz", dxp, Hp, lin.weight[:, H:]))
    ops.append(("fc_feat", Hp, Hp, m.fc_feat.weight))
    ops.append(("layers_dir.0 feat", Hp, Hp // 2, m.layers_dir[0].weight[:, :H]))
    pos = 0
    for name, k, n, w in ops:
        flat = wq[pos:pos + 2 * k * n]
        _check_operand(flat, k, n, w, name)
        hi, lo = _unpack(flat, k, n)
        for bmax in (128, 64):
            for c, c0, bn, o_hi, o_lo in _pieces(n, k // KC, bmax):
                for half, o in ((hi, o_hi), (lo, o_lo)):
                    piece = flat[o:o + bn * KC].reshape(bn, 8, 4)
                    rr = torch.arange(c0, c0 + bn)[:, None]
                    piece = piece[torch.arange(bn)[:, None], torch.arange(8)[None, :] ^ (rr % 8)]
                    want = half[c0:c0 + bn, fr.tf32_feature_order(k)[c * KC:(c + 1) * KC]]
                    assert torch.equal(piece.reshape(bn, KC), want), (name, c, c0, bn)
        pos += 2 * k * n
    assert pos == wq.numel()
    want_aux, want_off = fr._aux(m, dict(m.named_parameters()))
    assert off == want_off and torch.equal(aux, want_aux.detach())


@pytest.mark.parametrize("hidden", PACK_WIDTHS)
def test_tf32_backward_pack_at_width(hidden):
    """``pack_backward_weights_tf32``: [K/32][hi, lo][Hp][32] chunks of each
    transposed weight, the TF32 split of the weight in its block's corner,
    zeros elsewhere; the wide chain's pieces are rows of it as for the
    forward pack."""
    m = _full(hidden)
    H, Hp = hidden, fr.bf16_hidden(hidden)
    wbq = ftl.pack_backward_weights_tf32(m)
    mats = [(fr._round_up(Hp // 2, KC), m.layers_dir[0].weight[:, :H].t()),
            (Hp, m.fc_feat.weight.t())]
    mats += [(Hp, lin.weight[:, :H].t()) for lin in reversed(m.layers_xyz)]
    pos = 0
    for i, (k, w) in enumerate(mats):
        _check_operand(wbq[pos:pos + 2 * k * Hp], k, Hp, w, f"product {i}")
        pos += 2 * k * Hp
    assert pos == wbq.numel()


@pytest.mark.parametrize("hp,nt", [(160, 7), (256, 7), (256, 0), (fr.MAX_HIDDEN, 3)])
def test_tf32_mask_words_at_width(hp, nt):
    """``tf32_mask_words`` above 128: ceil(hp / 64) words a hidden layer and
    ceil(hp / 128) for y (one up to 128), each bit the ReLU decision of the
    accumulator entry ``tf32_mask_layout`` places there."""
    g = torch.Generator().manual_seed(hp + nt)
    k = 128
    acts = [torch.randn((k, hp), generator=g) for _ in range(nt + 1)]
    acts.append(torch.randn((k, hp // 2), generator=g))
    words = ftl.tf32_mask_words(acts, hp)
    mw = -(-hp // 64)
    assert words.shape == (k // 64, (nt + 1) * mw + -(-hp // 128), 128)
    for l, act in enumerate(acts):
        width = act.shape[1]
        rows, cols = ftl.tf32_mask_layout(width)
        for tile in range(k // 64):
            bits = act[tile * 64:(tile + 1) * 64][rows, cols] > 0  # [128, width / 2]
            for i in range(0, width // 2, 37):
                word = int(words[tile, l * mw + i // 32, 7]) & 0xFFFFFFFF
                assert bool(word >> (i % 32) & 1) == bool(bits[7, i]), (l, tile, i)


# ---- the plain versions against the JAX kernels at float32


@pytest.fixture(scope="module")
def jax_mod():
    return pytest.importorskip("jax")


def _assert_f32(got: dict, want: dict):
    """Values to ATOL (the loss to LOSS_RTOL), every gradient leaf to
    GRAD_ATOL times its largest entry (at least 1)."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert np.isfinite(g).all(), k
        if k == "loss":
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, err_msg=k)
        elif "." in k:  # a parameter's gradient
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL * scale, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_render_plain_matches_jax_f32_at_width(jax_mod, hidden):
    """Kernel 1's plain version vs the JAX fused render at float32
    (interpret mode): rgb, accumulation, depth and weights."""
    from dexnerf_tpu.ops.fused_render import make_fused_render

    jx = _jx(jax_mod, hidden)
    a = _inputs()
    keys = ("origins", "directions", "viewdirs", "z_vals", "dists")
    render = make_fused_render(jx.jm, block_samples=512, compute_dtype=jx.jnp.float32,
                               interpret=True)
    j = render(jx.tree, *(jx.jnp.asarray(a[k]) for k in keys))
    fields = ("rgb", "accumulation", "depth", "weights")
    launches = fr.launches
    out = fr.fused_render_reference(jx.model, *(torch.tensor(a[k]) for k in keys))
    _assert_f32({f: getattr(out, f).numpy() for f in fields},
                {f: np.asarray(getattr(j, f)) for f in fields})
    assert fr.launches == launches  # CPU tensors never reach a kernel


@pytest.mark.parametrize("hidden", WIDTHS)
def test_train_loss_plain_matches_jax_f32_at_width(jax_mod, hidden):
    """Kernel 4's plain version at compute_dtype = dw_dtype = float32 vs the
    JAX pass loss at float32 (interpret mode): loss, weights, rgb and every
    gradient leaf."""
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    jx = _jx(jax_mod, hidden)
    a = _inputs(seed=4)
    keys = ("origins", "directions", "z_vals", "viewdirs", "dists", "noise", "target")
    f32 = jx.jnp.float32
    fn = make_fused_pass_loss(jx.jm, block_samples=128, compute_dtype=f32, dw_dtype=f32,
                              interpret=True)
    ja = [jx.jnp.asarray(a[k]) for k in keys]

    def f(params):
        loss, w, rgb = fn(params, *ja)
        return loss, (w, rgb)

    (loss, (w, rgb)), g = jx.jax.value_and_grad(f, has_aux=True)(jx.tree)
    want = {"loss": float(loss), "weights": np.asarray(w), "rgb": np.asarray(rgb),
            **_grads(jx, g)}
    loss, w, rgb, grads = ftl.fused_pass_loss_reference(
        jx.model, *(torch.tensor(a[k]) for k in keys), compute_dtype=F32, dw_dtype=F32)
    names = [n for n, _ in jx.model.named_parameters()]
    _assert_f32({"loss": float(loss), "weights": w.numpy(), "rgb": rgb.numpy(),
                 **dict(zip(names, (t.numpy() for t in grads)))}, want)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_fields_plain_match_jax_f32_at_width(jax_mod, hidden):
    """Kernel 2's plain version (raw) and kernel 3's (through the training
    field: the loss mean((raw - t)^2) and every gradient leaf) at float32 vs
    the JAX fields at float32 (interpret mode)."""
    from dexnerf_tpu.ops import make_fused_flexible_field as j_field
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_train

    jx = _jx(jax_mod, hidden)
    a = _inputs(seed=5)
    pts, vd, tgt = (jx.jnp.asarray(a[k]) for k in ("pts", "viewdirs", "g"))
    f32 = jx.jnp.float32
    raw = j_field(jx.jm, block_samples=16, compute_dtype=f32, interpret=True)(jx.tree, pts, vd)
    fn = j_train(jx.jm, block_samples=16, compute_dtype=f32, dw_dtype=f32, interpret=True)
    loss, grads = jx.jax.value_and_grad(
        lambda p: jx.jnp.mean((fn(p, pts, vd) - tgt) ** 2))(jx.tree)
    want = {"raw": np.asarray(raw), "loss": float(loss), **_grads(jx, grads)}
    t = {k: torch.tensor(a[k]) for k in ("pts", "viewdirs", "g")}
    r = fused_mlp.fused_field_reference(jx.model, t["pts"], t["viewdirs"])
    model = copy.deepcopy(jx.model)
    field = fused_mlp_train.make_fused_flexible_field_train(model)
    loss = torch.mean((field(t["pts"], t["viewdirs"]) - t["g"]) ** 2)
    loss.backward()
    _assert_f32({"raw": r.detach().numpy(), "loss": float(loss.detach()),
                 **{k: p.grad.numpy() for k, p in model.named_parameters()}}, want)


# ---- the dW plan and the reckoning


@pytest.mark.parametrize("hidden", [136, 256, 320, 576, fr.MAX_HIDDEN])
def test_f32_dw_plan_split_within_limits(hidden):
    """Above a width of 128 the f32 dW plan splits each product to the
    kernel's limits: every unit at most two cotangent boxes, parts of
    shapes the kernel takes, at most TF32_MAX_BOXES boxes, a ring that
    fits; every flat-gradient entry written exactly once (tf32_reduce_map
    raises otherwise); the plan in parts of at most TF32_MAX_UNITS units,
    the viewdir rows the first part's alone."""
    m = FlexibleNeRFModel(num_layers=8, hidden_size=hidden, skip_connect_every=3,
                          num_encoding_fn_xyz=16, num_encoding_fn_dir=4)
    plan = wgr.tf32_dw_plan(m)
    wmap = wgr.tf32_reduce_map(m, plan)
    assert wmap.numel() == sum(p.numel() for p in m.parameters())
    parts = wgr.tf32_dw_parts(plan)
    assert sum(len(p) for p in parts) == len(plan) and 1 <= len(parts) <= wgr.TF32_MAX_PARTS
    assert all(1 <= len(p) <= wgr.TF32_MAX_UNITS for p in parts)
    assert len(plan) > m.num_layers + 2  # split: more units than products
    for part in parts:
        assert wgr.tf32_ring(part)[2] >= 2
    for u in plan:
        assert 1 <= u.n_a <= 2 and len(u.boxes) <= wgr.TF32_MAX_BOXES
        assert 64 * (u.n_a - 1) < u.a_rows <= 64 * u.n_a
        for w in u.wgs:
            assert tuple(p.nb for p in w.parts) in wgr.TF32_SHAPES
            for p in w.parts:
                assert u.n_a <= p.b and p.b + p.nb <= u.n_op and p.m_lim <= 64 * p.nb
        if u.head is not None:
            assert 1 <= u.head.nbox <= 2 and u.head.mlim <= 64 * u.head.nbox
    # the parts' map: part p's unit u as -1 - (p TF32_MAX_UNITS + u)
    dw = wmap[wmap < 0]
    assert int((-1 - dw).max()) // wgr.TF32_MAX_UNITS == len(parts) - 1


def _cuda_int(source: str, name: str) -> int:
    """The value of ``constexpr int name = ...;`` in ops/csrc/``source``."""
    import re

    with open(_build.CSRC / source) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, (source, name)
    return int(m.group(1))


@pytest.mark.parametrize("hp", list(range(160, 609, 32)))
def test_wide_chain_plan_of_64_row_pieces_fits(hp):
    """The wide f32 chain's plan (pieces of TF32_CHAIN_PIECE_ROWS = 64 rows,
    ``kChainPieceRows`` in ops/csrc/fused_train_loss.cu) at every padded
    width 160-608: it fits in 227 KB with as many consumers as the 128-row
    plan would take and at least the kernel's fewest stages, twice the
    128-row plan's stages or more; ``tf32_wide_fits`` holds there, and the
    mirror's constants are the CUDA sources'."""
    assert fr.TF32_CHAIN_PIECE_ROWS == _cuda_int("fused_train_loss.cu", "kChainPieceRows")
    for name, value in (("kWtMaxCons", fr.TF32_WIDE_MAX_CONS),
                        ("kWtMaxStages", fr.TF32_WIDE_MAX_STAGES),
                        ("kWtMinStages", fr.TF32_WIDE_MIN_STAGES),
                        ("kSmemMax", fr.SHARED_BYTES_LIMIT)):
        src = "mlp_tile_tf32.cuh" if name == "kSmemMax" else "mlp_wide_tf32.cuh"
        assert _cuda_int(src, name) == value, name
    for kx in range(1, fr.TF32_MAX_KX + 1):
        b = fr.tf32_wide_cons_bytes(hp, kx)["chain"]
        cons, rows, stages, smem = fr.tf32_wide_plan(b, fr.TF32_CHAIN_PIECE_ROWS)
        wide = fr.tf32_wide_plan(b)
        assert rows == 64 and smem <= fr.SHARED_BYTES_LIMIT and stages >= fr.TF32_WIDE_MIN_STAGES
        assert smem == 1024 + stages * (2 * 64 * 128 + 16) + cons * b
        assert cons == wide[0]
        assert stages >= min(2 * wide[2], fr.TF32_WIDE_MAX_STAGES) or wide[1] == 64
    assert fr.tf32_wide_fits(hp)
    if hp == 256:  # the 8x256 step: two consumers, five stages of 64 rows
        assert fr.tf32_wide_plan(fr.tf32_wide_cons_bytes(256, 2)["chain"], 64) == (
            2, 64, 5, 219216)


def test_max_hidden_is_the_largest_f32_plan_that_fits():
    """MAX_HIDDEN is reckoned from the wide f32 kernels' shared-memory plans
    at the kernels' widest encodings (xyz up to 128 wide: four 32-wide
    K-chunks; the render kernel at every S): it and every padded width below
    it fit, the next does not; two consumer warpgroups while two fit."""
    assert fr.MAX_HIDDEN == 608 and fr.MAX_HIDDEN % 32 == 0
    assert fr.tf32_wide_fits(fr.MAX_HIDDEN)
    assert not fr.tf32_wide_fits(fr.MAX_HIDDEN + 32)
    assert all(fr.tf32_wide_fits(hp) for hp in range(160, fr.MAX_HIDDEN + 1, 32))
    assert fr.tf32_wide_plan(fr.tf32_wide_cons_bytes(256, 2, 192)["render"])[0] == 2
    assert fr.tf32_wide_plan(fr.tf32_wide_cons_bytes(512, 2, 192)["render"])[0] == 1
    fr.check_width(fr.MAX_HIDDEN, F32, "the kernel")
    with pytest.raises(ValueError, match="item 6c"):
        fr.check_width(fr.MAX_HIDDEN + 1, F32, "the kernel")
