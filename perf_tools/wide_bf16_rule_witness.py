#!/usr/bin/env python3
"""Is the spread rule (``perf_tools/bf16_exact_rule.py::spread_rule``) a
rule for the wide bf16 route, and does the kernel hold it? For kernel 4
(``fused_pass_loss``) at padded widths 320 and 576, its chunked launch at
256, and kernel 3 (``fused_field_train``) at 576, on the card tests' inputs
(``tests/test_torch_train_loss_bf16.py`` and
``tests/test_torch_fused_mlp_bf16.py``: ``_card_case``, seeds 9 and 10).

    python3 perf_tools/wide_bf16_rule_witness.py [--seeds 9,10] [--only k4,k4_chunked,k3,pad]

From the repository root, on a machine with a CUDA card. Beside the
kernel, other versions of the same contract on the same inputs:

- ``exact``: the bf16 plain version with every product of two bf16
  operands summed in float64 and rounded once to f32, the spread rule's
  centre;
- ``plain``, ``perm1``, ``perm2``: E, the legal orders the rule takes its
  scale from: the bf16 plain version, and the same with every hidden
  layer's units permuted at permutation seeds 1 and 2 (the same function;
  only the order of each f32 sum over hidden units differs), gradients
  permuted back;
- ``perm3``: the held-out legal order, a permutation at seed 3, not in E;
  ``perm4``-``perm8`` more of them (seeds 4-8), counted beside it but not
  part of the rule's checks;
- ``tc``: the bf16 plain version with each product of two bf16 operands
  on the tensor cores (``torch.mm`` of bf16 tensors into float32: one
  accumulator over the whole K).

Each version gets, per case, the leaves where it misses the card rule
(phase 7's, against the bf16 and f32 plain versions) and the leaves where it
misses the spread rule, and a verdict under the spread rule. The rule is
sound only if ``perm3`` passes it in every case, and it decides something
only if ``tc`` misses it in one case at least: the last line says both,
with the kernel's verdicts. ``pad`` runs a 320-wide model and the same
model zero-padded to 576 (``perf_tools/kernel1_small_units.py::embedded``:
every added weight and bias 0, the same function) through both kernels:
the forward's outputs equal bit for bit, and the gradients on the 320
units and the added ones' (exactly 0 if the 576 route computes what the 320
route does), and two launches at 576 bit for bit.

Prints, for every case, each version's count of card-rule and spread-rule
misses and each spread-rule miss with [max, p99.9 of |v - exact|, max vs
the f32 plain version, s_max, s_999, own max]; then the card line; then one
JSON object (the last line) with the checks of the rule, the verdicts and
each case's misses. To hold another commit's kernels, copy this file and
``perf_tools/bf16_exact_rule.py`` into a ``git archive`` of it and run it
there in the same call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

EXTRA_SEEDS = (4, 5, 6, 7, 8)  # more held-out permutations, for the spread's tail
VERSIONS = ("kernel", "exact", "plain", "perm1", "perm2", "perm3", "tc",
            *(f"perm{s}" for s in EXTRA_SEEDS))
K4_CASES = [(320, 64, 300), (320, 128, 300), (576, 64, 300), (576, 128, 300), (576, 7, 301)]
K4_KW = [("rgb", False), ("rgb", True), ("luminance", False), ("luminance", True)]
K3_CASES = [(576, 64, 300), (576, 128, 300), (576, 256, 300)]


def on_units(gq, p, name, H, width):
    """The entries of ``gq`` (a leaf of the model zero-padded from ``H`` to
    ``width`` hidden units, as ``embedded`` lays it out) that stand for
    ``p``'s, in ``p``'s shape, and the mask of those entries."""
    import torch

    mask = torch.zeros_like(gq, dtype=torch.bool)
    if p.dim() == 1:
        mask[:p.shape[0]] = True
        return gq[:p.shape[0]], mask
    rows, n_in = p.shape
    if n_in in (H, H // 2) or name.startswith("layer1"):
        mask[:rows, :n_in] = True
        return gq[:rows, :n_in], mask
    mask[:rows, :H] = True
    mask[:rows, width:width + n_in - H] = True
    return torch.cat([gq[:rows, :H], gq[:rows, width:width + n_in - H]], 1), mask


def judge(label, names, versions, bp, fp, report):
    """Every leaf of one case for each version (``versions`` {name: leaves},
    :data:`VERSIONS`): its card-rule misses and its spread-rule misses, the
    rule's centre ``exact`` and its E ``plain``, ``perm1``, ``perm2``;
    prints and records them with each version's verdict."""
    from perf_tools.bf16_exact_rule import card_rule, spread_row, spread_rule

    card = {w: [] for w in versions}
    spread = {w: {} for w in versions}
    for i, (name, b, f) in enumerate(zip(names, bp, fp)):
        x, legal = versions["exact"][i], [versions["perm1"][i], versions["perm2"][i]]
        for who, leaves in versions.items():
            if not card_rule(leaves[i], b, f):
                card[who].append(name)
            if not spread_rule(leaves[i], b, f, x, legal):
                row, atol = spread_row(leaves[i], b, f, x, legal)
                spread[who][name] = {"row": [float(f"{v:.4g}") for v in row],
                                     "atol": float(f"{atol:.3g}"),
                                     "entries": leaves[i].numel()}
    verdicts = {w: "misses" if spread[w] else "passes" for w in versions}
    c_needed = {w: 0.0 for w in versions}  # the least C of clauses (i)-(ii) the version holds
    for i, (b, f) in enumerate(zip(bp, fp)):
        x, legal = versions["exact"][i], [versions["perm1"][i], versions["perm2"][i]]
        for who, leaves in versions.items():
            row, atol = spread_row(leaves[i], b, f, x, legal)
            for e, sc in ((row[0], row[3]), (row[1], row[4])):
                if e > atol:
                    c_needed[who] = max(c_needed[who], (e - atol) / sc if sc else float("inf"))
    print(f"{label}: card-rule misses " + ", ".join(f"{w} {len(m)}" for w, m in card.items())
          + "; spread-rule misses " + ", ".join(f"{w} {len(m)}" for w, m in spread.items()))
    for who, m in spread.items():
        for name, d in m.items():
            print(f"  {who} misses the spread rule on {name}: {json.dumps(d)}")
    print(f"  {label}: least C per version " + json.dumps(
        {w: float(f"{c:.3g}") for w, c in c_needed.items()}))
    report[label] = {"card_misses": card, "spread_misses": spread, "verdicts": verdicts,
                     "c_needed": {w: float(f"{c:.4g}") for w, c in c_needed.items()}}


def tensor_core_linear():
    """``fused_train_loss._RoundedLinear`` with every product of two bf16
    operands as ``torch.mm`` of bf16 tensors into float32 (the tensor
    cores), the rest as it is (as ``bf16_exact_rule.exact_linear``)."""
    import torch

    from dexnerf_tpu_torch.ops.fused_train_loss import _round

    bf, f32 = torch.bfloat16, torch.float32

    def mm(a, b, both_bf16):  # a [..., K] times b [K, N]
        if not both_bf16:
            return a @ b
        out = torch.mm(a.reshape(-1, a.shape[-1]).to(bf), b.to(bf), out_dtype=f32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    class TensorCoreLinear(torch.autograd.Function):
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

    return TensorCoreLinear


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="9,10")
    ap.add_argument("--only", default="k4,k4_chunked,k3,pad")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wide_bf16_rule_witness: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import test_torch_fused_mlp_bf16 as t3
    import test_torch_train_loss_bf16 as t4

    from dexnerf_tpu_torch.core.encoding import positional_encoding
    from dexnerf_tpu_torch.ops import fused_mlp_train
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from perf_tools.bf16_exact_rule import (HELD_OUT_SEED, LEGAL_SEEDS, exact_linear,
                                            on_linear, permuted)
    from perf_tools.kernel1_small_units import embedded

    dev = torch.device("cuda")
    bf = torch.bfloat16
    seeds = [int(s) for s in opts.seeds.split(",")]
    only = set(opts.only.split(","))
    report = {}
    perm_seeds = {"perm1": LEGAL_SEEDS[0], "perm2": LEGAL_SEEDS[1], "perm3": HELD_OUT_SEED,
                  **{f"perm{s}": s for s in EXTRA_SEEDS}}
    tc_linear, ex_linear = tensor_core_linear(), exact_linear()

    def under(linear, fn):
        with on_linear(linear):
            return fn()

    def k4_run(m, args, kw, chunk=None):
        saved = ftl.SCRATCH_SAMPLES
        try:
            if chunk:
                ftl.SCRATCH_SAMPLES = chunk
            out = ftl._launch_bf16(m, *args, **kw, log_sampling_xyz=True, log_sampling_dir=True)
        finally:
            ftl.SCRATCH_SAMPLES = saved
        torch.cuda.synchronize()
        return out

    def k4_args(inp, depth):
        return (inp["origins"], inp["directions"], inp["z_vals"], inp["viewdirs"], inp["dists"],
                inp["noise"], inp["target"],
                *((inp["depth_gt"], inp["depth_coef"]) if depth else (None, None)))

    def k4(m, inp, supervision, depth, label, chunk=None):
        kw = dict(white_background=supervision == "luminance", supervision=supervision)
        args = k4_args(inp, depth)
        plain_args = args if depth else args[:7]
        bfkw = dict(kw, compute_dtype=bf, dw_dtype=bf)

        def leaves(out, grads=None):  # loss, weights, rgb and every gradient leaf
            return [out[0].detach().reshape(1), out[1], out[2],
                    *(out[3] if grads is None else grads)]

        def plain(model=m, **k):
            return ftl.fused_pass_loss_reference(model, *plain_args, **k)

        got = leaves(k4_run(m, args, kw, chunk))
        bp, fp = leaves(plain(**bfkw)), leaves(plain(**kw))
        versions = {"kernel": got, "exact": leaves(under(ex_linear, lambda: plain(**bfkw))),
                    "plain": bp}
        for who, seed in perm_seeds.items():
            mp, back = permuted(m, seed)
            po = plain(mp, **bfkw)
            versions[who] = leaves(po, back(po[3]))
        versions["tc"] = leaves(under(tc_linear, lambda: plain(**bfkw)))
        names = ["loss", "weights", "rgb"] + [n for n, _ in m.named_parameters()]
        judge(label, names, versions, bp, fp, report)

    def k3_plain(m, pts, vd, g):
        """raw and the leaves of the bf16 plain version (flex_forward_train)."""
        xyz = positional_encoding(pts, m.num_encoding_fn_xyz, m.include_input_xyz, True)
        view = positional_encoding(vd, m.num_encoding_fn_dir, m.include_input_dir, True)
        with torch.no_grad():
            raw = ftl.flex_forward_train(m, xyz, view, bf, bf)
        return [raw] + list(fused_mlp_train.field_grads_reference(m, pts, vd, g,
                                                                  compute_dtype=bf, dw_dtype=bf))

    for seed in seeds:
        if "k4" in only:
            for hid, s, n in K4_CASES:
                m, inp = t4._card_case(dev, dict(t4.FULL, hidden_size=hid), s, n=n, seed=seed)
                for sup, depth in K4_KW:
                    k4(m, inp, sup, depth,
                       f"k4 h{hid} {n}x{s} {sup}-{'depth' if depth else 'photo'} seed {seed}")
        if "k4_chunked" in only:
            m, inp = t4._card_case(dev, dict(t4.FULL, hidden_size=256), 100, n=301, seed=seed)
            k4(m, inp, "rgb", False, f"k4 h256 301x100 chunked seed {seed}", chunk=100 * 40)
        if "k3" in only:
            for hid, s, n in K3_CASES:
                m, pts, vd, g = t3._card_case(dev, dict(t3.FULL, hidden_size=hid), n, s,
                                              seed=seed)
                raw = fused_mlp_train.fused_field_train(m, pts, vd, compute_dtype=bf,
                                                        dw_dtype=bf)
                raw.backward(g)
                torch.cuda.synchronize()
                got = [raw.detach()] + [p.grad for p in m.parameters()]
                names = ["raw"] + [n for n, _ in m.named_parameters()]
                bp, fp = t3._plain(m, pts, vd, g)
                bp, fp = [bp[k] for k in names], [fp[k] for k in names]
                versions = {"kernel": got,
                            "exact": under(ex_linear, lambda: k3_plain(m, pts, vd, g)),
                            "plain": bp}
                for who, seed_p in perm_seeds.items():
                    mp, back = permuted(m, seed_p)
                    pv = k3_plain(mp, pts, vd, g)
                    versions[who] = [pv[0]] + back(pv[1:])
                versions["tc"] = under(tc_linear, lambda: k3_plain(m, pts, vd, g))
                judge(f"k3 h{hid} {n}x{s} seed {seed}", names, versions, bp, fp, report)
        if "pad" in only:
            for s, n in ((64, 300), (7, 301)):
                m, inp = t4._card_case(dev, dict(t4.FULL, hidden_size=320), s, n=n, seed=seed)
                mp = embedded(m, 576)
                kw = dict(white_background=False, supervision="rgb")
                args = k4_args(inp, True)
                a, b = k4_run(m, args, kw), k4_run(mp, args, kw)
                again = k4_run(mp, args, kw)
                out = {"forward_equal": {k: bool(torch.equal(a[i], b[i]))
                                         for i, k in enumerate(("loss", "weights", "rgb"))},
                       "k4_576_repeat_equal": all(bool(torch.equal(u, w)) for u, w in
                                                  zip([*b[:3], *b[3]], [*again[:3], *again[3]]))}
                m3, pts, vd, g = t3._card_case(dev, dict(t3.FULL, hidden_size=320), n, s,
                                               seed=seed)
                m3p = embedded(m3, 576)
                r = [fused_mlp_train.fused_field_train(x, pts, vd, compute_dtype=bf, dw_dtype=bf)
                     for x in (m3, m3p)]
                out["k3_raw_equal"] = bool(torch.equal(r[0], r[1]))
                k3g = [[t.detach() for t in torch.autograd.grad(rr, list(x.parameters()), g)]
                       for rr, x in zip(r, (m3, m3p))]
                for tag, x, y, ga, gb in (("k4", m, mp, a[3], b[3]), ("k3", m3, m3p, *k3g)):
                    worst, off = 0.0, 0.0
                    for (name, p), gp, gq in zip(x.named_parameters(), ga, gb):
                        on, mask = on_units(gq, p, name, x.hidden_size, y.hidden_size)
                        worst = max(worst, float((on - gp).abs().max()) / (float(gp.abs().max())
                                                                            or 1.0))
                        off = max(off, float(gq[~mask].abs().max()) if bool((~mask).any())
                                  else 0.0)
                    out[f"{tag}_grads_on_320_units_rel"] = worst
                    out[f"{tag}_grads_off_them_max"] = off
                label = f"pad 320 in 576 {n}x{s} seed {seed}"
                print(f"{label}: {json.dumps(out)}")
                report[label] = out
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    cases = [k for k, r in report.items() if "verdicts" in r]
    counts = {w: {v: sum(1 for k in cases if report[k]["verdicts"][w] == v)
                  for v in ("passes", "misses")} for w in VERSIONS}
    checks = {
        "held_out_perm_passes_every_case": all(report[k]["verdicts"]["perm3"] == "passes"
                                               for k in cases),
        "tc_misses_somewhere": any(report[k]["verdicts"]["tc"] == "misses" for k in cases),
        "kernel_misses": [k for k in cases if report[k]["verdicts"]["kernel"] == "misses"],
        "card_rule_kernel_misses": sum(1 for k in cases if report[k]["card_misses"]["kernel"]),
        "card_rule_exact_misses": sum(1 for k in cases if report[k]["card_misses"]["exact"]),
        "least_c": {w: max((report[k]["c_needed"][w] for k in cases), default=0.0)
                    for w in VERSIONS}}
    print(f"spread-rule verdicts over {len(cases)} cases: {json.dumps(counts)}")
    print(f"the rule's checks: {json.dumps(checks)}")
    print(json.dumps({"cases": len(cases), "verdicts": counts, **checks, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
