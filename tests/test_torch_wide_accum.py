"""The wide bf16 product's accumulation order on the CPU
(``ops/csrc/mlp_wide_bf16.cuh::wide_product``, padded widths above 128),
and the order of fresh accumulators that ROADMAP Queue 3 fault 9 tried.

The kernel multiplies bf16 operands on the tensor cores, 64-wide K-chunks
of four k16 steps each, into one f32 accumulator a column block over the
layer's whole K (each step's sixteen products exact, the sum truncated
toward zero, as the card's tail errors show the tensor cores'
accumulation); a skip layer's encoding chunks follow its hidden chunks.
:func:`span_mm` models that order for any span of chunks a fresh
accumulator (the spans added in f32, to nearest, in chunk order; the
kernel's span is the whole K), and :func:`span_forward_train` is the bf16
plain version (``ops/fused_train_loss.py::flex_forward_train``) with every
product that the wide forward and chain run through ``wide_product``
computed so: layer1, the trunk (with a skip layer's encoding), fc_feat and
layers_dir.0's feat rows, and the chain's input cotangents of the same
layers. The heads, the per-ray viewdir part and the weight gradients stay
the plain version's.

At widths 320 and 576, four layers (a skip layer), PE 3/2, 16 rays x 16
samples, the pass loss, weights, rgb and every gradient leaf of the
kernel's order and of a fresh accumulator every two chunks (SPAN; PERF.md:
on the card it cut fault 9's misses but not to none, at a cost the
registers could not hold) are held

* to the bf16 plain version, by ``tests/test_torch_wide.py``'s rule with
  the bf16 plain version as the reference: the order moves no entry by
  more than OWN_SHARE of the dtype's own effect there (the f32 plain
  version's distance to it), + 1e-5 of its largest value;
* to the JAX pass loss at bf16 (``_make_loss_kernel`` in interpret mode):
  its distance to JAX at most the bf16 plain version's + OWN_SHARE of the
  f32 plain version's distance to JAX, + 1e-5 of the entry's largest
  value. ``tests/test_torch_wide.py`` holds the plain version itself to
  OWN_SHARE of that distance up to 256; at 576, on these inputs, the plain
  version lies at 0.33 of it (``fc_rgb.weight``), so each order is held to
  what it adds.

``pytest -s`` prints the largest ratios (the distance, less the plain
version's for JAX, over the f32 plain version's).

    python -m pytest tests/test_torch_wide_accum.py
"""

import numpy as np
import pytest
import torch
from test_torch_wide import OWN_SHARE, SCALE_ATOL, _errors, _grads, _inputs, _jx

from dexnerf_tpu_torch.ops import fused_train_loss as ftl

BF16, F32 = torch.bfloat16, torch.float32
WIDTHS = (320, 576)
KCHUNK, KSTEP = 64, 16  # a K-chunk (one ring piece) and a wgmma k16 step
SPAN = 2  # K-chunks a fresh accumulator, in the order fault 9 tried
WHOLE_K = 10 ** 6  # the kernel's: one accumulator over the layer's K


def round_rz(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` to float32, toward zero."""
    f = v.to(F32)
    over = f.to(torch.float64).abs() > v.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def span_mm(a: torch.Tensor, b: torch.Tensor, span: int = SPAN, chunks=None) -> torch.Tensor:
    """``a`` [M, K] @ ``b`` [K, N] in the wide product's order: k16 steps
    truncated into a fresh accumulator a span of ``span`` 64-wide K-chunks,
    the spans added in f32 to nearest. ``chunks``: the K-chunks' (start,
    stop) columns (default: every 64 of K)."""
    K = a.shape[-1]
    chunks = chunks or [(k, min(k + KCHUNK, K)) for k in range(0, K, KCHUNK)]
    a64, b64 = a.reshape(-1, K).to(torch.float64), b.to(torch.float64)
    total = None
    for s0 in range(0, len(chunks), span):
        acc = torch.zeros(a64.shape[0], b.shape[1], dtype=torch.float64)
        for lo, hi in chunks[s0:s0 + span]:
            for k in range(lo, hi, KSTEP):
                ks = slice(k, min(k + KSTEP, hi))
                acc = round_rz(acc + a64[:, ks] @ b64[ks]).to(torch.float64)
        part = acc.to(F32)
        total = part if total is None else (total.to(torch.float64) + acc).to(F32)
    return total.reshape(*a.shape[:-1], b.shape[1])


def _round(t):
    return t.to(BF16).to(F32)


def _make_span_linear(span):
    class SpanLinear(torch.autograd.Function):
        """``x W^T`` (x [.., K], and a skip layer's encoding ``e`` after it
        in the same spans) of bf16-rounded operands by :func:`span_mm`; the
        input cotangent (of ``x``) by :func:`span_mm` too; the weight
        gradients as the plain version's (bf16 operands, f32 sums)."""

        @staticmethod
        def forward(ctx, x, w, e=None, we=None):
            xr, wr = _round(x), _round(w)
            if e is None:
                ctx.save_for_backward(xr, wr)
                return span_mm(xr, wr.t(), span)
            er, wer = _round(e), _round(we)
            ctx.save_for_backward(xr, wr, er)
            K, Ke = x.shape[-1], e.shape[-1]
            chunks = ([(k, min(k + KCHUNK, K)) for k in range(0, K, KCHUNK)]
                      + [(K + k, K + min(k + KCHUNK, Ke)) for k in range(0, Ke, KCHUNK)])
            return span_mm(torch.cat([xr, er], -1), torch.cat([wr, wer], 1).t(), span, chunks)

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            xr, wr = saved[:2]
            gb = _round(g)
            gx = span_mm(gb, wr, span) if ctx.needs_input_grad[0] else None
            g2 = gb.reshape(-1, g.shape[-1])
            gw = g2.t() @ xr.reshape(-1, xr.shape[-1])
            gwe = None
            if len(saved) == 3:
                gwe = g2.t() @ saved[2].reshape(-1, saved[2].shape[-1])
            return gx, gw, None, gwe

    return SpanLinear.apply


def span_forward_train(span):
    """``flex_forward_train`` at bf16 with the wide products in
    :func:`span_mm`'s order of ``span`` chunks a span (the same arguments)."""
    def forward(model, xyz, view, compute_dtype, dw_dtype):
        assert compute_dtype == dw_dtype == BF16
        lin = ftl._RoundedLinear.apply
        span_lin = _make_span_linear(span)
        H = model.hidden_size
        h = span_lin(xyz, model.layer1.weight) + model.layer1.bias
        for i, layer in enumerate(model.layers_xyz):
            if i in model.skips:
                y = span_lin(h, layer.weight[:, :H], xyz, layer.weight[:, H:])
            else:
                y = span_lin(h, layer.weight[:, :H])
            h = torch.relu(y + layer.bias)
        feat = torch.relu(span_lin(h, model.fc_feat.weight) + model.fc_feat.bias)
        alpha = lin(h, model.fc_alpha.weight, F32, F32, BF16, BF16) + model.fc_alpha.bias
        ld = model.layers_dir[0]
        view_s = view[..., None, :].expand(*feat.shape[:-1], view.shape[-1])
        y = torch.relu(span_lin(feat, ld.weight[:, :H])
                       + lin(view_s, ld.weight[:, H:], BF16, BF16, F32, BF16) + ld.bias)
        rgb = lin(y, model.fc_rgb.weight, F32, F32, BF16, BF16) + model.fc_rgb.bias
        return torch.cat([rgb, alpha], dim=-1)

    return forward


def test_span_mm_is_exact_where_no_rounding_occurs():
    """Integer operands small enough that every partial sum is exact: the
    span order is the product itself, at any span, over chunk boundaries
    and short last chunks."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-4, 5, (7, 200), generator=g).to(F32)
    b = torch.randint(-4, 5, (200, 9), generator=g).to(F32)
    for span in (1, 2, 16):
        assert torch.equal(span_mm(a, b, span), a @ b)


def test_span_mm_truncates_within_a_span_only():
    """Within a span the steps truncate toward zero; the spans' sum rounds
    to nearest: 1 + 2^-24 per step lands below an exact sum inside one
    span, and one span a chunk keeps more of it."""
    a = torch.ones(1, 256)
    b = torch.full((256, 1), 1.0)
    b[0, 0] = 2.0 ** 24  # a large first term: each later step's 16 is below its ulp of 2
    exact = 2.0 ** 24 + 255
    one = float(span_mm(a, b, 16))
    fresh = float(span_mm(a, b, 1))
    assert one <= exact and fresh <= exact
    assert abs(fresh - exact) <= abs(one - exact)


def _pass(model, a, forward=None, dtype=BF16):
    keys = ("origins", "directions", "z_vals", "viewdirs", "dists", "noise", "target")
    saved = ftl.flex_forward_train
    if forward is not None:
        ftl.flex_forward_train = forward
    try:
        loss, w, rgb, grads = ftl.fused_pass_loss_reference(
            model, *(torch.tensor(a[k]) for k in keys), compute_dtype=dtype, dw_dtype=dtype)
    finally:
        ftl.flex_forward_train = saved
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss), "weights": w.numpy(), "rgb": rgb.numpy(),
            **dict(zip(names, (t.numpy() for t in grads)))}


def _ratios(got: dict, ref: dict, f32: dict, base=None) -> dict:
    """Each entry's distance to ``ref`` (less ``base``'s, when given) over
    the f32 plain version's, the ratio the rules hold to OWN_SHARE (its
    atol taken off first)."""
    err, own = _errors(got, ref), _errors(f32, ref)
    less = _errors(base, ref) if base is not None else {k: 0.0 for k in ref}
    return {k: max(0.0, err[k] - less[k] - SCALE_ATOL * float(np.abs(np.asarray(ref[k])).max()))
            / own[k] if own[k] > 0 else float("inf") for k in ref}


@pytest.mark.parametrize("hidden", WIDTHS)
def test_accumulation_orders_match_jax_and_plain_at_width(hidden):
    """The kernel's order (one accumulator over the whole K) and the span
    order's pass loss, weights, rgb and every gradient leaf at widths 320
    and 576 against the bf16 plain version and the JAX pass loss at bf16 in
    interpret mode, by the module's two rules."""
    jax = pytest.importorskip("jax")
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    jx = _jx(jax, hidden)
    a = _inputs(seed=4)
    keys = ("origins", "directions", "z_vals", "viewdirs", "dists", "noise", "target")
    fn = make_fused_pass_loss(jx.jm, block_samples=128, compute_dtype=jx.jnp.bfloat16,
                              dw_dtype=jx.jnp.bfloat16, interpret=True)
    ja = [jx.jnp.asarray(a[k]) for k in keys]

    def f(params):
        loss, w, rgb = fn(params, *ja)
        return loss, (w, rgb)

    (loss, (w, rgb)), g = jax.value_and_grad(f, has_aux=True)(jx.tree)
    want = {"loss": float(loss), "weights": np.asarray(w), "rgb": np.asarray(rgb),
            **_grads(jx, g)}
    f32 = _pass(jx.model, a, dtype=F32)
    plain = _pass(jx.model, a)
    table = {}
    for order, span in (("whole_k", WHOLE_K), ("span", SPAN)):
        got = _pass(jx.model, a, span_forward_train(span))
        for ref_name, ref, base in (("plain", plain, None), ("jax", want, plain)):
            r = _ratios(got, ref, f32, base)
            table[f"{order} vs {ref_name}"] = (round(max(r.values()), 4), max(r, key=r.get))
            bad = {k: v for k, v in r.items() if not v <= OWN_SHARE}
            assert not bad, (order, ref_name, bad)
    print(f"h{hidden}: largest ratio (limit {OWN_SHARE}) {table}")
