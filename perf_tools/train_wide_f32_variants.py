#!/usr/bin/env python3
"""What holds the wide f32 (split TF32) forward and chain of kernels 2-4 and
kernel 1's wide f32 frame (padded widths above 128:
``train_fwd_wide_tf32_kernel<2|3|4>`` and ``train_chain_wide_tf32_kernel<3|4>``
in ``ops/csrc/fused_train_loss.cu``, ``fused_render_wide_tf32_kernel`` in
``ops/csrc/fused_render.cu``, both on ``ops/csrc/mlp_wide_tf32.cuh``) on one
NVIDIA Hopper card.

    python3 perf_tools/train_wide_f32_variants.py [--only NAME,...]
        [--save FILE] [--compare FILE]

From the repository root. It builds copies of ``ops/csrc`` with one change
each (edits of the two sources and the headers they include), compiles each
copy's ``fused_train_loss.cu`` and ``fused_render.cu`` into one library,
and times, at FlexibleNeRF 8x256 skip 3, PE 10/4 (seeded weights and
inputs): kernel 4's two passes of one train step (batch 8192, 64 + 128
samples), kernels 2 and 3 on the fine pass (8192 x 128 points, a seeded
cotangent) and kernel 1 on a 400x400 frame (64 + 192 samples): device ms
per step from ``torch.profiler`` over 3 steps after a warm one, each
variant twice, in turns. ``--only`` times the named variants alone
(``--only full`` builds no copy: the package's own library). To compare with
a commit whose argument blocks differ (say the parent), copy this tool into
a ``git archive`` of that commit and run it there with ``--only full``, in
turns with this checkout's run; ``--save FILE`` writes ``full``'s outputs
and gradients (kernel 4's fine pass, kernels 2-3, kernel 1's frame) and
``--compare FILE`` holds ``full``'s to those of another run bit for bit.

Variants (one whose edit matches nothing in the checkout's sources is
listed under ``not_built``): ``no_split`` (A as its hi half only: no split,
the lo.hi products gone), ``no_stores`` (no layer outputs, y or mask words
stored), ``no_readback`` (no layer output read back into the input tile),
``masks_const`` (the chain's ReLU masks all ones, no mask word read),
``products_only`` (the last three together), ``no_layer1`` (the forward's
CUDA-core layer1 skipped), ``readback1`` (the read-back one load at a time
a thread), ``no_prefetch`` (each chunk's A values loaded when it starts,
not under the chunk before), ``chain_pieces128`` (the chain's pieces 128
rows, fewer stages), ``pieces64`` (every kernel's pieces 64 rows at most),
``one_consumer`` (one consumer warpgroup a CTA), ``layer1_u1`` (layer1's
loads one feature a register set in every launch), ``layer1_u2`` (two in
kernel 2's too), ``stores_cs`` (the layer outputs stored evict-first),
``readback_cg`` (read back through L2 without the evict-first hint),
``l2_off`` (both). The
variants that skip work compute wrong outputs; only their times are read.
Each variant's kernel-4 fine-pass gradients are compared with ``full``'s
(largest |difference| over the largest |entry|, 0 when bitwise equal).

Beside the times: each kernel's split-TF32 bound on these passes and its
products as f32 ``torch.matmul`` with TF32 off (``chip_smoke.py``'s
``f32_pass_sizes`` and ``pass_yardsticks``). Prints each copy's ptxas
registers, spills and any C75xx line (``wgmma`` serialized) for the wide
f32 kernels, the card line (nvidia-smi) and, as the last line, one JSON
object. Exits non-zero without a card.
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

SRC = "fused_train_loss.cu"
RENDER = "fused_render.cu"
HDR = "mlp_wide_tf32.cuh"

# (file, old, new): every occurrence of old is replaced; a variant whose edit
# matches nothing is not built
NO_SPLIT = [
    (HDR, "for (int i = 0; i < 16; ++i) split_tf32(xv[i], ah[i], al[i]);",
     "for (int i = 0; i < 16; ++i) {\n      ah[i] = __float_as_uint(xv[i]);\n      al[i] = 0u;\n    }"),
    (HDR, """        wgmma_tf32_rs<NP>(d, al[4 * ks], al[4 * ks + 1], al[4 * ks + 2], al[4 * ks + 3],
                          kmajor_desc(wh + ks * 32), ks != 0);
        wgmma_tf32_rs<NP>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                          kmajor_desc(wl + ks * 32), 1);
""", """        wgmma_tf32_rs<NP>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                          kmajor_desc(wl + ks * 32), ks != 0);
"""),
]
# stores skipped by a condition the compiler cannot decide (their values
# stay live: a store removed outright lets it drop the products behind it)
NO_STORES = [
    (HDR, "if (col < O.nvalid) {", "if (col < O.nvalid && O.k < 0) {"),
    (HDR, "if (O.masks != nullptr && l > 0) {", "if (O.masks != nullptr && l > 0 && O.k < 0) {"),
    (HDR, "if (O.y != nullptr && col < O.nvalid / 2) {",
     "if (O.y != nullptr && col < O.nvalid / 2 && O.k < 0) {"),
    (HDR, "      if (O.masks != nullptr) {\n", "      if (O.masks != nullptr && O.k < 0) {\n"),
    (SRC, "              if (col < hm) {\n                float* d0 = dst",
     "              if (col < hm && K < 0) {\n                float* d0 = dst"),
]
NO_READBACK = [
    (HDR, "    wt_load_tile(T.in, dst, O.k, O.nvalid, hp);\n", ""),
    (SRC, "          wt_load_tile(in, dst, K, hm, hp);\n", ""),
]
MASKS_CONST = [
    (SRC, "m[w] = __ldcs(mk + ((li - 1) * MW + c0 / 64 + w) * 128);", "m[w] = 0xffffffffu;"),
    (SRC, "ym = __ldcs(mk + ((nt + 1) * MW + (4 * j) / 32) * 128);", "ym = 0xffffffffu;"),
]
NO_LAYER1 = [(HDR, "for (int k0 = 0; k0 < dx; k0 += 2 * U) {", "for (int k0 = 0; k0 < 0; k0 += 2 * U) {")]
READBACK1 = [(HDR, "  constexpr int U = 8;\n  const int t = threadIdx.x & 127, total = n * 16;",
              "  constexpr int U = 1;\n  const int t = threadIdx.x & 127, total = n * 16;")]
NO_PREFETCH = [
    (HDR, "      if (hh == 0 && c + 1 < n) load(c + 1, xv);\n", ""),
    (HDR, "    uint32_t ah[16], al[16];\n#pragma unroll\n    for (int i = 0; i < 16; ++i) split_tf32",
     "    if (c > 0) load(c, xv);\n    uint32_t ah[16], al[16];\n#pragma unroll\n"
     "    for (int i = 0; i < 16; ++i) split_tf32"),
]
CHAIN_PIECES128 = [(SRC, "constexpr int kChainPieceRows = 64;", "constexpr int kChainPieceRows = 128;")]
PIECES64 = [(HDR, "for (int bmax = bfirst; bmax >= 64; bmax -= 64) {",
             "for (int bmax = 64; bmax >= 64; bmax -= 64) {")]
ONE_CONSUMER = [(HDR, "for (int c = kWtMaxCons; c >= 1; --c) {", "for (int c = 1; c >= 1; --c) {")]
LAYER1_U1 = [(HDR, "U = BN > 64 ? 1 : L1U;", "U = 1;")]
LAYER1_U2 = [(SRC, "constexpr int kLayer1U = kOwner == kFieldFwd ? 1 : 2;",
              "constexpr int kLayer1U = 2;")]
# the layer outputs stored evict-first (they leave L2 before the read-back)
# and / or read back through L2 only
STORES_CS = [(HDR, "__stwb(d0", "__stcs(d0"), (SRC, "__stwb(d0", "__stcs(d0")]
READBACK_CG = [(HDR, "? __ldcs(reinterpret_cast<const float4*>(src + f * k + r))",
                "? __ldcg(reinterpret_cast<const float4*>(src + f * k + r))")]
VARIANTS = {
    "full": [], "no_split": NO_SPLIT, "no_stores": NO_STORES, "no_readback": NO_READBACK,
    "masks_const": MASKS_CONST, "products_only": NO_STORES + NO_READBACK + MASKS_CONST,
    "no_layer1": NO_LAYER1, "readback1": READBACK1, "no_prefetch": NO_PREFETCH,
    "chain_pieces128": CHAIN_PIECES128, "pieces64": PIECES64, "one_consumer": ONE_CONSUMER,
    "layer1_u1": LAYER1_U1, "layer1_u2": LAYER1_U2, "stores_cs": STORES_CS,
    "readback_cg": READBACK_CG, "l2_off": STORES_CS + READBACK_CG,
}
KERNELS = ("train_fwd_wide_tf32_kernel<4>", "train_chain_wide_tf32_kernel<4>",
           "train_fwd_wide_tf32_kernel<2>", "train_fwd_wide_tf32_kernel<3>",
           "train_chain_wide_tf32_kernel<3>", "fused_render_wide_tf32_kernel")
PTXAS_KERNELS = ("train_fwd_wide_tf32_kernel", "train_chain_wide_tf32_kernel",
                 "fused_render_wide_tf32_kernel")
ENTRIES = ("dexnerf_train_args_size", "dexnerf_train_rows", "dexnerf_train_tile_words",
           "dexnerf_train_tf32_occupancy", "dexnerf_train_pass", "dexnerf_field_tf32_pass",
           "dexnerf_train_loss_sum", "dexnerf_fused_render", "dexnerf_fused_render_occupancy",
           "dexnerf_fused_render_wide_occupancy")


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
    """The ptxas lines of the wide f32 kernels (registers, spills, with the
    template's tag) and every line of a serialized wgmma (C75xx)."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = next((k for k in PTXAS_KERNELS if k in line), None)
            if name and "ILi" in line:
                name += "<" + line.split("ILi")[1].split("E")[0] + ">"
            if name:
                out.append(name)
        elif name and ("spill" in line or "registers" in line):
            out.append("  " + line.strip().replace("ptxas info    : ", ""))
            if "registers" in line:
                name = None
        elif "serialized" in line or "C75" in line:
            out.append("  " + line.strip())
    return out


def build(trees):
    """name -> csrc directory: each copy's two sources compiled into one
    library, all copies at once. Returns name -> (library, ptxas lines)."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "train_wide_f32_variants")
    procs = {}
    for name, tree in trees.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", tree, "-shared",
               "-o", os.path.join(out_dir, f"{name}.so"), os.path.join(tree, SRC),
               os.path.join(tree, RENDER)]
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
    ap.add_argument("--save", default="", metavar="FILE",
                    help="write full's outputs and gradients to FILE (torch.save)")
    ap.add_argument("--compare", default="", metavar="FILE",
                    help="hold full's outputs and gradients to FILE's bit for bit")
    opts = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("train_wide_f32_variants: no CUDA card visible to PyTorch")
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    out_dir = os.path.join(ROOT, "build", "train_wide_f32_variants")
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

    class Route:  # the f32 entry points from one variant, the rest as built
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, k):
            return getattr(self.lib if k in ENTRIES else main_lib, k)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 8192

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def model(seed):
        m = FlexibleNeRFModel(num_layers=8, hidden_size=256, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(seed)).to(dev)
        with torch.no_grad():  # a σ of ~1: the loss's cotangent reaches every layer
            m.fc_alpha.bias.fill_(1.0)
        return m

    def depths(rays, s):
        return torch.sort(tensor(2 + 4 * rng.uniform(size=(rays, s))), dim=-1).values.contiguous()

    o, d = tensor(rng.normal(size=(n, 3)) * 0.2), tensor(rng.normal(size=(n, 3)))
    v = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    target = tensor(rng.uniform(size=(n, 3)))
    passes = []
    for s in (64, 128):
        m, z = model(s), depths(n, s)
        passes.append((m, z, ray_dists(z, d).contiguous(), tensor(rng.normal(size=(n, s)) * 0.2)))
    fine, z_f = passes[1][0], passes[1][1]
    pts = (o[:, None] + d[:, None] * z_f[..., None]).contiguous()
    g = tensor(rng.normal(size=(n, 128, 4)) * 1e-2)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    # kernel 1: a 400x400 frame, 64 coarse samples, then 64 + 128 fine
    nf = 400 * 400
    fo, fd = tensor(rng.normal(size=(nf, 3)) * 0.2), tensor(rng.normal(size=(nf, 3)))
    fv = fd / torch.linalg.norm(fd, dim=-1, keepdim=True)
    frame = []
    for m, s in ((passes[0][0], 64), (fine, 192)):
        z = depths(nf, s)
        frame.append((m, fo, fd, fv, z, ray_dists(z, fd).contiguous()))

    def step():
        for m, z, dists, noise in passes:
            ftl.fused_pass_loss(m, o, d, z, v, dists, noise, target)
        fm.fused_field(fine, pts, v)
        fmt._launch_backward(fine, pts, v, g, **kw)
        for args in frame:
            fr.fused_render(*args)

    def outputs():
        """The fine pass's loss, weights, rgb and gradients (kernel 4),
        kernel 2's raw, kernel 3's gradients, kernel 1's frame."""
        m, z, dists, noise = passes[1]
        m.zero_grad(set_to_none=True)
        loss, w, rgb = ftl.fused_pass_loss(m, o, d, z, v, dists, noise, target)
        loss.backward()
        out = {"k4_loss": loss.detach().reshape(1), "k4_weights": w.detach(),
               "k4_rgb": rgb.detach()}
        out.update({f"k4_grad.{k}": p.grad.detach().clone() for k, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
        with torch.no_grad():
            out["k2_raw"] = fm.fused_field(fine, pts, v)
        names = [k for k, _ in fine.named_parameters()]
        out.update({f"k3_grad.{k}": t for k, t in zip(names, fmt._launch_backward(
            fine, pts, v, g, **kw))})
        with torch.no_grad():
            for i, args in enumerate(frame):
                r = fr.fused_render(*args)
                for f_ in ("rgb", "depth", "accumulation", "weights"):
                    out[f"k1_{i}_{f_}"] = getattr(r, f_)
        torch.cuda.synchronize()
        return out

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

    def clear():
        ftl._tf32_residency.clear()  # the variant's own plans
        fr._residency.clear()

    ms, residency, grad_diff, bits = {}, {}, {}, None
    ref = None
    try:
        for rnd in range(2):
            for name, (lib, _) in libs.items():
                _build._lib = Route(lib)
                clear()
                if rnd == 0:
                    residency[name] = {"train": ftl.tf32_occupancy(fine),
                                       "frame": fr.tf32_wide_occupancy(fine, 192)}
                    got = outputs()
                    gv = torch.cat([t.reshape(-1) for k, t in got.items()
                                    if k.startswith("k4_grad.")])
                    if ref is None:
                        ref = gv
                    scale = float(ref.abs().max())
                    grad_diff[name] = float((gv - ref).abs().max()) / scale if scale else None
                    if name == "full":
                        full_out = {k: t.cpu() for k, t in got.items()}
                    del got
                t = device_ms()
                for k, x in t.items():
                    ms.setdefault(name, {}).setdefault(k, []).append(x)
    finally:
        _build._lib = main_lib
        clear()
    if "full" in libs:
        if opts.save:
            torch.save(full_out, opts.save)
        if opts.compare:
            other = torch.load(opts.compare)
            bits = {"equal": sorted(k for k in full_out if k in other
                                    and torch.equal(full_out[k], other[k])),
                    "differ": {k: float((full_out[k] - other[k]).abs().max())
                               for k in full_out if k in other
                               and not torch.equal(full_out[k], other[k])},
                    "missing": sorted(set(full_out) ^ set(other))}
            bits["equal"] = len(bits["equal"])
    import chip_smoke as cs

    k4 = [(m, z.numel()) for m, z, *_ in passes]
    yard = {}
    cs.pass_yardsticks(yard, "k4", k4, torch, dev)
    cs.pass_yardsticks(yard, "f", [(fine, pts.shape[0] * pts.shape[1])], torch, dev)
    cs.pass_yardsticks(yard, "k1", [(m, a[3].numel()) for m, *a in frame], torch, dev,
                       parts=("forward",))
    library = {"train_fwd_wide_tf32_kernel<4>": yard["k4_forward_torch_matmul_f32"],
               "train_chain_wide_tf32_kernel<4>": yard["k4_chain_torch_matmul_f32"],
               "train_fwd_wide_tf32_kernel<2>": yard["f_forward_torch_matmul_f32"],
               "train_fwd_wide_tf32_kernel<3>": yard["f_forward_torch_matmul_f32"],
               "train_chain_wide_tf32_kernel<3>": yard["f_chain_torch_matmul_f32"],
               "fused_render_wide_tf32_kernel": yard["k1_forward_torch_matmul_f32"]}

    def part_bound(owner, part, sizes):
        """As chip_smoke.f32_pass_parts: the bytes, or each peak's FLOPs."""
        b, flops = 0.0, {}
        for m_, n_, s_ in sizes:
            nb, ops = cs.f32_pass_sizes(m_, n_, s_, owner)[part]
            b += nb
            for f, p in ops:
                flops[p] = flops.get(p, 0.0) + f
        return max([1e3 * b / cs.HBM_BYTES] + [1e3 * f / p for p, f in flops.items()])

    k4_sizes = [(m, n, z.shape[1]) for m, z, *_ in passes]
    f_sizes = [(fine, n, 128)]
    bounds = {"train_fwd_wide_tf32_kernel<4>": part_bound(4, "train_fwd_tf32_kernel", k4_sizes),
              "train_chain_wide_tf32_kernel<4>": part_bound(4, "train_chain_tf32_kernel",
                                                            k4_sizes),
              "train_fwd_wide_tf32_kernel<2>": part_bound(2, "train_fwd_tf32_kernel", f_sizes),
              "train_fwd_wide_tf32_kernel<3>": part_bound(3, "train_fwd_tf32_kernel", f_sizes),
              "train_chain_wide_tf32_kernel<3>": part_bound(3, "train_chain_tf32_kernel",
                                                            f_sizes)}
    k1_macs = sum(a[3].numel() * cs.mlp_macs(m)[0] for m, *a in frame)
    bounds["fused_render_wide_tf32_kernel"] = 1e3 * 3 * 2 * k1_macs / cs.TF32_FLOPS
    for name, (_, lines) in libs.items():
        print(f"ptxas, {name}:")
        for line in lines:
            print("  " + line)
    print(card)
    print(json.dumps({"device_ms_per_step": ms, "grad_diff_vs_full": grad_diff,
                      "bits_vs_compare": bits,
                      "bound_ms": {k: round(x, 4) for k, x in bounds.items()},
                      "library_ms": {k: round(x, 4) for k, x in library.items()},
                      "residency": residency, "not_built": skipped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
