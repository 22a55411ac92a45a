"""The bf16 card rule, the exact contract, and the spread rule that was
proposed for the wide bf16 route, where the exact contract itself misses
the card rule (ROADMAP Queue 3, fault 9).

The card rule (``chip_smoke.py`` phase 7) holds each output and gradient
leaf of a bf16 route to its bf16 plain version relative to the dtype's own
effect, own = |bf16 plain - f32 plain|: the route's distance to the bf16
plain version at most own (max) and 0.25 own (99.9th percentile), its
distance to the f32 plain version at most 1.5 own, each + 1e-5 of the
leaf's largest entry.

The contract is JAX's ``_make_loss_kernel`` / ``_make_bwd_kernel`` at
bf16: operands rounded to bf16, accumulation in f32. Its most faithful
implementation, ``exact``, is the bf16 plain version with every product of
two bf16 operands (the forward's, the chain's input cotangents and the
weight gradients) summed in float64 and rounded once to f32, every other
rounding where the plain version has it (:func:`exact_linear`,
:func:`on_linear`). On some inputs ``exact`` misses the card rule: there
no correct kernel can be held to it.

The spread rule (:func:`spread_rule`) takes its scale from several legal
orders around ``exact``. E is the bf16 plain version and ``perm``
(:func:`permuted`, the same contract with every hidden layer's units
permuted, so only its f32 sums are reordered) at permutation seeds
LEGAL_SEEDS. Per leaf, s_max is the largest of max|o - exact| over o in E,
s_999 the largest of their 99.9th percentiles, own = |bf16 plain - f32
plain| and atol 1e-5 of the leaf's largest entry. A version ``k`` holds
the rule on a leaf when (i) max|k - exact| <= SPREAD_C s_max + atol, (ii)
p99.9|k - exact| <= SPREAD_C s_999 + atol and (iii) max|k - f32 plain| <=
1.5 max(own max, s_max) + atol. ``perf_tools/wide_bf16_rule_witness.py``
checked it on the card before it held any kernel, on a legal order it was
not built from (``perm`` at HELD_OUT_SEED) and on the tensor cores'
whole-K sums (``tc``), and found it wrong: the held-out order misses it in
14 of the 48 cases (PERF.md section 6). So it holds no kernel: :func:`hold_case` holds
every case to the card rule, naming the leaves where ``exact`` misses that
rule too. The card tests (``tests/test_torch_train_loss_bf16.py``,
``tests/test_torch_fused_mlp_bf16.py``) hold the kernels by it.
"""

from __future__ import annotations

import contextlib

P999, REL, ATOL = 0.25, 1.5, 1e-5  # the card rule's limits
SPREAD_C = 2.0  # clauses (i) and (ii): multiples of the legal orders' spread
LEGAL_SEEDS = (1, 2)  # perm's permutation seeds in E
HELD_OUT_SEED = 3  # the legal order the rule is checked on, not in E


def p999(x) -> float:
    """The 99.9th percentile of ``x``'s entries (its largest for fewer than
    2000)."""
    import torch

    flat = x.flatten()
    return float(torch.topk(flat, max(1, flat.numel() // 1000)).values[-1])


def exact_linear():
    """``fused_train_loss._RoundedLinear`` with every product of two bf16
    operands summed in float64 and rounded once to float32; the rest (the
    roundings, the products with an f32 operand) as it is."""
    import torch

    from dexnerf_tpu_torch.ops.fused_train_loss import _round

    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64

    def mm(a, b, both_bf16):  # a [..., K] times b [K, N]
        if not both_bf16:
            return a @ b
        out = torch.mm(a.reshape(-1, a.shape[-1]).to(f64), b.to(f64)).to(f32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    class ExactLinear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, x_dtype, w_dtype, save_dtype, dw_dtype):
            wr = _round(w, w_dtype)
            ctx.save_for_backward(_round(x, save_dtype), wr)
            ctx.dtypes = (w_dtype, dw_dtype)
            return mm(_round(x, x_dtype), wr.t(), x_dtype == w_dtype == bf)

        @staticmethod
        def backward(ctx, g):
            saved, wr = ctx.saved_tensors
            w_dtype, dw_dtype = ctx.dtypes
            gx = mm(_round(g, w_dtype), wr, w_dtype == bf) if ctx.needs_input_grad[0] else None
            g2 = _round(g, dw_dtype).reshape(-1, g.shape[-1])
            gw = mm(g2.t(), _round(saved, dw_dtype).reshape(-1, saved.shape[-1]),
                    dw_dtype == bf)
            return gx, gw, None, None, None, None

    return ExactLinear


@contextlib.contextmanager
def on_linear(linear):
    """The training plain versions (``flex_forward_train`` and what calls
    it) with ``linear`` in place of ``_RoundedLinear`` inside the block."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    plain = ftl._RoundedLinear
    ftl._RoundedLinear = linear
    try:
        yield
    finally:
        ftl._RoundedLinear = plain


def rule_row(a, b, f):
    """[max, p99.9 of |a - b|, max |a - f|, own max, own p99.9] (own = |b -
    f|) and the leaf's atol."""
    own, e_b, e_f = (b - f).abs(), (a - b).abs(), (a - f).abs()
    return ([float(e_b.max()), p999(e_b), float(e_f.max()), float(own.max()), p999(own)],
            ATOL * float(b.abs().max()))


def card_rule(a, b, f, use_p999=True) -> bool:
    """Whether ``a`` holds the card rule against the bf16 plain version
    ``b`` and the f32 plain version ``f`` (with ``use_p999`` False: its max
    clauses alone)."""
    row, atol = rule_row(a, b, f)
    return (row[0] <= row[3] + atol and (not use_p999 or row[1] <= P999 * row[4] + atol)
            and row[2] <= REL * row[3] + atol)


def permuted(model, seed):
    """A copy of ``model`` whose hidden units are permuted in every layer by
    a CPU generator seeded ``seed`` (the same function), and ``back(grads)``:
    its gradients in ``model.parameters()`` order, permuted back to
    ``model``'s units."""
    import copy

    import torch

    gen = torch.Generator().manual_seed(seed)
    m = copy.deepcopy(model)
    H, dev = m.hidden_size, next(m.parameters()).device

    def perm(k):
        return torch.randperm(k, generator=gen).to(dev)

    def cols(p_in, width):  # a hidden input's permutation, then the rest in order
        return torch.cat([p_in, torch.arange(p_in.numel(), width, device=dev)])

    plan = {}  # linear name -> (row index, column index)
    p = perm(H)
    plan["layer1"] = (p, torch.arange(m.layer1.in_features, device=dev))
    for i, layer in enumerate(m.layers_xyz):
        q = perm(H)
        plan[f"layers_xyz.{i}"] = (q, cols(p, layer.in_features))
        p = q
    pf, pd = perm(H), perm(H // 2)
    plan["fc_feat"] = (pf, p)
    plan["fc_alpha"] = (torch.arange(1, device=dev), p)
    plan["layers_dir.0"] = (pd, cols(pf, m.layers_dir[0].in_features))
    plan["fc_rgb"] = (torch.arange(3, device=dev), pd)
    mods = dict(m.named_modules())
    with torch.no_grad():
        for name, (r, c) in plan.items():
            lin = mods[name]
            lin.weight.copy_(lin.weight[r][:, c])
            lin.bias.copy_(lin.bias[r])
    names = [n for n, _ in m.named_parameters()]

    def back(grads):
        out = []
        for name, g in zip(names, grads):
            r, c = plan[name.rsplit(".", 1)[0]]
            b = torch.zeros_like(g)
            if name.endswith("weight"):
                b[r[:, None], c[None, :]] = g
            else:
                b[r] = g
            out.append(b)
        return out

    return m, back


def spread_row(a, b, f, x, legal):
    """[max, p99.9 of |a - exact|, max |a - f32 plain|, s_max, s_999, own
    max] and the leaf's atol, for ``a`` against the bf16 plain version
    ``b``, the f32 plain version ``f``, ``exact`` ``x`` and E's other orders
    ``legal`` (a list of the leaf's values)."""
    e_x, spread = (a - x).abs(), [(o - x).abs() for o in (b, *legal)]
    return ([float(e_x.max()), p999(e_x), float((a - f).abs().max()),
             max(float(d.max()) for d in spread), max(p999(d) for d in spread),
             float((b - f).abs().max())], ATOL * float(b.abs().max()))


def spread_rule(a, b, f, x, legal) -> bool:
    """Whether ``a`` holds the spread rule (see the module's docstring) on
    one leaf."""
    row, atol = spread_row(a, b, f, x, legal)
    return (row[0] <= SPREAD_C * row[3] + atol and row[1] <= SPREAD_C * row[4] + atol
            and row[2] <= REL * max(row[5], row[3]) + atol)


def hold_case(got: dict, bp: dict, fp: dict, xp: dict, p999_min=0):
    """One case by the card rule: the leaves of ``got`` outside it, {leaf:
    [max, p99.9 vs bf16 plain, max vs f32 plain, own max, own p99.9]}, and
    the leaves where ``exact`` ``xp`` misses it too (where a kernel's miss
    is the rule's: fault 9). A leaf of fewer than ``p999_min`` entries is
    held by the max clauses alone, ``exact``'s too."""
    bad, exact_misses = {}, []
    for k in bp:
        a, b, f, x = got[k].detach(), bp[k].detach(), fp[k].detach(), xp[k].detach()
        use = b.numel() >= p999_min
        if not card_rule(a, b, f, use):
            bad[k] = [float(f"{v:.4g}") for v in rule_row(a, b, f)[0]]
        if not card_rule(x, b, f, use):
            exact_misses.append(k)
    return bad, exact_misses
