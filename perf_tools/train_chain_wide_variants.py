#!/usr/bin/env python3
"""What holds the wide bf16 chain, dW and forward of kernels 2-4 (padded
widths above 128: ``train_chain_wide_kernel``, ``train_dw_bf16_kernel<true>``
and ``train_fwd_wide_kernel<4>`` in ``ops/csrc/fused_train_loss_bf16.cu``,
with ``ops/csrc/mlp_wide_bf16.cuh``) on one NVIDIA Hopper card.

    python3 perf_tools/train_chain_wide_variants.py [--only NAME,...]

From the repository root. It builds copies of ``ops/csrc`` with one change
each (edits of ``fused_train_loss_bf16.cu`` and the headers it includes),
compiles each copy's ``fused_train_loss_bf16.cu`` into its own library, and
times the three kernels on kernel 4's two passes of one 8x256 train step
(FlexibleNeRF 8x256 skip 3, PE 10/4, batch 8192, 64 + 128 samples, seeded
weights and inputs), and the forwards of kernels 2 and 3
(``train_fwd_wide_kernel<2>``, ``<3>``) and kernel 3's chain on the fine
pass (``fused_field``, ``fused_field_train`` and its backward on a random
cotangent): device ms per step from ``torch.profiler`` over 3 steps after a
warm one, each variant twice, in turns. ``--only`` times the named
variants alone (``--only full`` builds no copy: the package's own library).
To compare with a commit whose argument blocks differ (say the parent), run
the tool from a ``git archive`` of that commit with ``--only full``, in
turns with this checkout's run.

Variants (one whose edit matches nothing in the checkout's sources is
listed under ``not_built``): ``masks_const`` (every ReLU mask reads as 1,
no mask word copied), ``no_ycot`` (the y-cotangent step skipped, its
viewdir adds with it), ``no_vd_flush`` (only the viewdir rows' adds
skipped), ``no_colsum`` (no column sums and no bias sums),
``no_stores`` (no TMA stores of the cotangent tiles), ``products_only`` (all
four); the wide product's ``span1`` and ``span2`` (a fresh accumulator
every 1 or 2 k16 steps, not every K-chunk of 4) and ``no_promote`` (the fresh accumulators
not added to the block's sum), the wide tile's ``no_epilogue`` (the
forward's bias, ReLU, stores, mask words and heads) and
``no_finish_stores`` (the forward's layer stores and their barrier), each
skipped by a condition the compiler cannot decide, and ``one_consumer``
(one consumer warpgroup a CTA); the dW's ``fresh_off`` (the
narrow accumulation, one accumulator over all stages),
``one_wait_per_stage`` (every block's fresh products of a stage issued, then
one wait) and ``two_parts`` (two part accumulators, ``wait_group 1`` across
blocks); the forward's ``fwd_no_words`` (no ReLU
mask words written). The variants that skip work compute wrong gradients;
only their times are read. ``full`` also times kernel 1's wide bf16 frame
(``fused_render_wide_kernel``, 400x400 rays, 64 then 192 samples; the
package's own library in every variant). Each variant's gradients on the fine pass are
compared with ``full``'s (largest |difference| over the largest |entry|, 0
when bitwise equal).

Beside the times: each kernel's bound on these passes and its products as
bf16 ``torch.matmul`` (``chip_smoke.py``'s ``bf16_part_bounds``,
``pass_yardsticks`` and ``dw_yardsticks``: the checkout's own design).
Prints each copy's ptxas registers, spills and any C75xx line (``wgmma``
serialized) for the kernels, the card line (nvidia-smi) and, as the
last line, one JSON object. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = "fused_train_loss_bf16.cu"
HDR = "mlp_wide_bf16.cuh"

# (file, old, new): every occurrence of old is replaced; a variant whose edit
# matches nothing is not built
MASKS_CONST = [
    (SRC, "const bool masked = pi <= nt;", "const bool masked = false;"),
    (SRC, "const float vv = (wd[i & 7] >> (yb - 8 * (i >> 3))) & 1u ? dy : 0.f;",
     "const float vv = dy;"),
    (SRC, "          cp_async4(msm + ((x * mw + w) * 128 + t) * 4, tm + (first + w) * 128);\n",
     ""),
]
NO_COLSUM = [
    (SRC, "          colsum_scatter<V>(cs, lane);\n", ""),
    (SRC, "colsum[warp * hp + c0 + 8 * (kk >> 1) + 2 * q + (kk & 1)] = cs[i];", "{}"),
    (SRC, """        atomicAdd(bias + c,
                  (colsum[c] + colsum[hp + c]) + (colsum[2 * hp + c] + colsum[3 * hp + c]));
""", ""),
]
NO_VD_FLUSH = [(SRC, "vd_red(vd, p.dir_enc + (size_t)ray * dd, dd, h2, seg);", "{}")]
NO_YCOT = [(SRC, "for (int col = t; col < h2; col += 128) {",
            "for (int col = t; col < 0; col += 128) {")]
NO_STORES = [
    (SRC, "tma_store_2d(&m.blocks[n_act + nt + 1 - pi], 64 * x, (int)k0, out + x * kEncChunk);",
     "{}"),
    (SRC, "tma_store_2d(&m.blocks[n_act + nt + 2], 64 * x, (int)k0, cot0 + x * kEncChunk);",
     "{}"),
]
# the promoted product without its adds (the fresh accumulators' products
# still run: the adds are skipped by a condition the compiler cannot decide)
NO_PROMOTE = [(HDR, "for (int i = 0; i < BN / 2; ++i) acc[i] += f[i];",
               "for (int i = 0; i < BN / 2; ++i) {\n      if (wr.ns < 0) acc[i] += f[i];\n    }")]
# the wide tile's epilogues (bias, ReLU, bf16 stores, mask words, heads)
# skipped by a condition the compiler cannot decide
NO_EPILOGUE = [
    (HDR, "uint32_t out, uint32_t words) {\n",
     "uint32_t out, uint32_t words) {\n  if (bias != nullptr) return;\n"),
    (HDR, "uint32_t ytile, uint32_t words) {\n",
     "uint32_t ytile, uint32_t words) {\n  if (dirb != nullptr) return;\n"),
]
SPAN1 = [(HDR, "constexpr int kWideSpan = 4;", "constexpr int kWideSpan = 1;")]
SPAN2 = [(HDR, "constexpr int kWideSpan = 4;", "constexpr int kWideSpan = 2;")]
# finish's TMA stores of the layer outputs and mask words, and its second
# barrier, skipped by a condition the compiler cannot decide
NO_FINISH_STORES = [(HDR, "    if (maps != nullptr) {\n      if (t == 0) {",
                     "    if (maps != nullptr && T.hp < 0) {\n      if (t == 0) {")]
# the wide forward without its ReLU mask words (the chain then reads stale ones)
FWD_NO_WORDS = [(SRC, "kSave ? p.masks + (size_t)(r0 / kTile) * wide_mask_words(hp, nt) * 128"
                      " : nullptr", "nullptr")]
ONE_CONSUMER = [(HDR, "for (int c = kWideMaxCons; c >= 1; --c) {",
                 "for (int c = 1; c >= 1; --c) {")]
FRESH_OFF = [(SRC, "  if (a.fresh) {\n    err = set_smem(train_dw_bf16_kernel<true>",
              "  if (0) {\n    err = set_smem(train_dw_bf16_kernel<true>")]
_FRESH = """#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float part[32];
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kDwBox / 16; ++ks) {
          wgmma_bf16<64, 1, 1>(part,
                               small[i] ? small_desc(st + ao[i] + ks * 256)
                                        : sw128_desc(st + ao[i] + ks * 2048),
                               sw128_desc(st + bo[i] + ks * 2048), ks > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] += part[e];
      }
"""
_MMA_BLOCK = """#pragma unroll
        for (int ks = 0; ks < kDwBox / 16; ++ks) {
          wgmma_bf16<64, 1, 1>(P,
                               small[I] ? small_desc(st + ao[I] + ks * 256)
                                        : sw128_desc(st + ao[I] + ks * 2048),
                               sw128_desc(st + bo[I] + ks * 2048), ks > 0);
        }
"""
ONE_WAIT = [(SRC, _FRESH, """      float part[NB > 0 ? NB : 1][32];
#pragma unroll
      for (int i = 0; i < NB; ++i) fence_regs(part[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
""" + _MMA_BLOCK.replace("(P,", "(part[i],").replace("[I]", "[i]") + """      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        fence_regs(part[i]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] += part[i][e];
      }
""")]
TWO_PARTS = [(SRC, _FRESH, """      float part[2][32];
#pragma unroll
      for (int i = 0; i <= NB; ++i) {
        if (i < NB) {  // block i into part i % 2 ...
          fence_regs(part[i & 1]);
          wgmma_fence();
""" + _MMA_BLOCK.replace("(P,", "(part[i & 1],").replace("[I]", "[i]") + """          wgmma_commit();
        }
        if (i > 0) {  // ... while block i - 1's is added
          if (i < NB) {
            wgmma_wait1();
          } else {
            wgmma_wait0();
          }
          fence_regs(part[(i - 1) & 1]);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[i - 1][e] += part[(i - 1) & 1][e];
        }
      }
""")]
VARIANTS = {
    "full": [], "masks_const": MASKS_CONST, "no_ycot": NO_YCOT, "no_vd_flush": NO_VD_FLUSH,
    "no_colsum": NO_COLSUM, "no_stores": NO_STORES,
    "products_only": MASKS_CONST + NO_YCOT + NO_COLSUM + NO_STORES,
    "span1": SPAN1, "span2": SPAN2,
    "no_promote": NO_PROMOTE, "no_epilogue": NO_EPILOGUE,
    "no_finish_stores": NO_FINISH_STORES, "one_consumer": ONE_CONSUMER, "fresh_off": FRESH_OFF,
    "one_wait_per_stage": ONE_WAIT, "two_parts": TWO_PARTS, "fwd_no_words": FWD_NO_WORDS,
}
KERNELS = ("train_chain_wide_kernel", "train_dw_bf16_kernel", "train_fwd_wide_kernel<4>")
# kernels 2-3 on the fine pass (kernel 2's forward, kernel 3's forward and chain)
FIELD_KERNELS = {"train_fwd_wide_kernel<2>": "train_fwd_wide_kernel<2>",
                 "train_fwd_wide_kernel<3>": "train_fwd_wide_kernel<3>",
                 "train_chain_wide_kernel": "train_chain_wide_kernel (kernel 3)"}
BASES = ("train_chain_bf16_kernel", "train_dw_bf16_kernel", "train_fwd_bf16_kernel")
ENTRIES = ("dexnerf_train_bf16_size", "dexnerf_train_bf16_dw_span", "dexnerf_train_bf16_pass",
           "dexnerf_train_bf16_dw", "dexnerf_train_bf16_tensor_map", "dexnerf_train_bf16_reduce",
           "dexnerf_train_bf16_occupancy", "dexnerf_train_bf16_wide_occupancy",
           "dexnerf_train_bf16_dw_occupancy", "dexnerf_field_bf16_pass")


def edited_tree(src_dir, out_dir, edits):
    """A copy of src_dir in out_dir with edits applied; False if one of them
    matches nothing."""
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(src_dir, out_dir)
    for name, old, new in edits:
        path = os.path.join(out_dir, name)
        with open(path) as f:
            text = f.read()
        if old not in text:
            return False
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return True


def ptxas_lines(log):
    """The ptxas lines of the three kernels (registers, spills) and every
    line of a serialized wgmma (C75xx)."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = next((k for k in (*KERNELS[:2], "train_fwd_wide_kernel",
                                     "fused_render_wide_kernel") if k in line), None)
            if name:
                tag = next((f"<{i}>" for i in (2, 3, 4) if f"ILi{i}E" in line), "")
                out.append(name + ("<fresh>" if "ILb1E" in line else
                                   "<plain>" if "ILb0E" in line else tag))
        elif name and ("spill" in line or "registers" in line):
            out.append("  " + line.strip().replace("ptxas info    : ", ""))
            if "registers" in line:
                name = None
        elif "serialized" in line:
            out.append("  " + line.strip())
    return out


def build(trees):
    """name -> csrc directory: each copy's fused_train_loss_bf16.cu compiled
    into its own library, all at once. Returns name -> (library, ptxas lines)."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "train_chain_wide_variants")
    procs = {}
    for name, tree in trees.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", tree, "-shared",
               "-o", os.path.join(out_dir, f"{name}.so"), os.path.join(tree, SRC)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), ptxas_lines(log))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", metavar="NAME,...",
                    help="time these variants alone")
    opts = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("train_chain_wide_variants: no CUDA card visible to PyTorch")
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    out_dir = os.path.join(ROOT, "build", "train_chain_wide_variants")
    os.makedirs(out_dir, exist_ok=True)
    only = [n for n in opts.only.split(",") if n]
    trees, skipped = {}, []
    for name, edits in VARIANTS.items():
        if only and name not in only:
            continue
        tree = os.path.join(out_dir, name)
        if edited_tree(str(_build.CSRC), tree, edits):
            trees[name] = tree
        else:
            skipped.append(name)
    if list(trees) == ["full"]:  # the package's own library and its build log
        libs = {"full": (main_lib, ptxas_lines(_build.build_log))}
    else:
        libs = build(trees)
    for lib, _ in libs.values():
        for f in ENTRIES:
            getattr(lib, f).argtypes = getattr(main_lib, f).argtypes
            getattr(lib, f).restype = ctypes.c_int

    class Route:  # the bf16 training entry points from one variant, the rest as built
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, k):
            return getattr(self.lib if k in ENTRIES else main_lib, k)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 8192

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    o, d = tensor(rng.normal(size=(n, 3)) * 0.2), tensor(rng.normal(size=(n, 3)))
    v = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    target = tensor(rng.uniform(size=(n, 3)))
    passes = []
    for s in (64, 128):
        m = FlexibleNeRFModel(num_layers=8, hidden_size=256, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(s)).to(dev)
        with torch.no_grad():  # a σ of ~1: the loss's cotangent reaches every layer
            m.fc_alpha.bias.fill_(1.0)
        z = torch.sort(tensor(2 + 4 * rng.uniform(size=(n, s))), dim=-1).values.contiguous()
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        passes.append((m, z, dists.contiguous(), tensor(rng.normal(size=(n, s)) * 0.2)))
    bf = dict(compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)

    def step():
        for m, z, dists, noise in passes:
            ftl.fused_pass_loss(m, o, d, z, v, dists, noise, target, **bf)

    def fine_grads():
        m, z, dists, noise = passes[1]
        m.zero_grad(set_to_none=True)
        loss, _, _ = ftl.fused_pass_loss(m, o, d, z, v, dists, noise, target, **bf)
        loss.backward()
        return torch.cat([p.grad.reshape(-1) for p in m.parameters()])

    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_render as fr

    nf = 400 * 400  # kernel 1: a 400x400 frame, 64 coarse samples, then 64 + 128 fine
    fo, fd = tensor(rng.normal(size=(nf, 3)) * 0.2), tensor(rng.normal(size=(nf, 3)))
    fv = fd / torch.linalg.norm(fd, dim=-1, keepdim=True)
    frame = []
    for (m, *_), s in zip(passes, (64, 192)):
        z = torch.sort(tensor(2 + 4 * rng.uniform(size=(nf, s))), dim=-1).values.contiguous()
        frame.append((m, fo, fd, fv, z, ray_dists(z, fd).contiguous()))

    def frame_ms():
        with torch.no_grad():
            for a in frame:
                fr.fused_render(*a, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    for a in frame:
                        fr.fused_render(*a, compute_dtype=torch.bfloat16)
                torch.cuda.synchronize()
        return round(sum((e.time_range.end - e.time_range.start) / 3 / 1e3 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "fused_render_wide_kernel" in e.name), 4)

    mf, zf, _, _ = passes[1]  # kernels 2-3 on the fine pass's samples
    fpts = (o[:, None] + d[:, None] * zf[..., None]).contiguous()
    fg = 1e-2 * torch.randn(fpts.shape[:2] + (4,), generator=torch.Generator(device=dev)
                            .manual_seed(0), device=dev)

    def field_step():
        fm.fused_field(mf, fpts, v, compute_dtype=torch.bfloat16)
        mf.zero_grad(set_to_none=True)
        fmt.fused_field_train(mf, fpts, v, **bf).backward(fg)

    def field_ms():
        field_step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                field_step()
            torch.cuda.synchronize()
        out = {k: 0.0 for k in FIELD_KERNELS.values()}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = next((k for k in FIELD_KERNELS if k in e.name), None)
                if k:
                    out[FIELD_KERNELS[k]] += (e.time_range.end - e.time_range.start) / 3 / 1e3
        return {k: round(t, 4) for k, t in out.items()}

    def device_ms():
        with torch.no_grad():
            step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
        out = {k: 0.0 for k in KERNELS}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = next((k for k in KERNELS if k in e.name), None)
                if k:
                    out[k] += (e.time_range.end - e.time_range.start) / 3 / 1e3
        return {k: round(t, 4) for k, t in out.items()}

    ms, residency, grad_diff = {}, {}, {}
    ref = None
    try:
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                _build._lib = Route(lib)
                ftl._residency.clear()  # the variant's own consumers and stages
                if rnd == 0:
                    residency[name] = ftl.bf16_occupancy(passes[1][0])
                    g = fine_grads()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = g
                    scale = float(ref.abs().max())
                    grad_diff[name] = float((g - ref).abs().max()) / scale if scale else None
                t = {**device_ms(), **field_ms()}
                if name == "full":
                    t["fused_render_wide_kernel"] = frame_ms()
                for k, x in t.items():
                    ms.setdefault(name, {}).setdefault(k, []).append(x)
    finally:
        _build._lib = main_lib
        ftl._residency.clear()
    import chip_smoke as cs

    k4 = [(m, z.numel()) for m, z, *_ in passes]
    yard = {}
    cs.pass_yardsticks(yard, "k4", k4, torch, dev, torch.bfloat16)
    cs.dw_yardsticks(yard, k4, torch, dev)
    library = dict(zip(KERNELS, (yard["k4_chain_torch_matmul_bf16"], yard["dw_torch_matmul_bf16"],
                                 yard["k4_forward_torch_matmul_bf16"])))
    bounds = {}
    for k, base in zip(KERNELS, BASES):
        nb = sum(cs.bf16_part_bounds(m, n)[base][0] for m, n in k4)
        macs = sum(cs.bf16_part_bounds(m, n)[base][1] for m, n in k4)
        bounds[k] = cs.bound(2 * macs, nb, cs.BF16_FLOPS)
    for name, (_, lines) in libs.items():
        print(f"ptxas, {name}:")
        for line in lines:
            print("  " + line)
    print(card)
    print(json.dumps({"device_ms_per_step": ms, "grad_diff_vs_full": grad_diff,
                      "bound_ms": bounds, "library_ms": library, "residency": residency,
                      "not_built": skipped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
