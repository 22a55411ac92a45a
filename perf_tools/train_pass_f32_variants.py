#!/usr/bin/env python3
"""Kernel 4's f32 pass on one NVIDIA Hopper card: the split-TF32 kernels
the package builds (``ops/csrc/fused_train_loss.cu``: prep, forward,
compositing, chain) beside the one-CTA-a-ray FMA ``train_pass_kernel`` they
replaced, copies of them with parts removed, and the pass's layer products
as f32 ``torch.matmul`` calls.

    python3 perf_tools/train_pass_f32_variants.py --fma DIR [--reps N]

From the repository root. ``DIR`` holds the FMA design's
``fused_train_loss.cu`` with ``mlp_chain.cuh`` and ``mlp_tile.cuh``:
``ops/csrc`` of a ``git archive`` of a commit that still had it. Timed, in
turns, on one train step's passes without their weight gradients (8x128,
skip 3, PE 10/4, batch 8192; a coarse pass of 64 samples a ray in 2 chunks
of 4096 rays and a fine pass of 128 in 4 of 2048, as ``SCRATCH_SAMPLES``
cuts them; a seeded model, rays, draws and targets):

* ``fma``: the FMA design's ``train_pass_kernel``, built from ``DIR``;
* ``route``: the package's four kernels; ``route_prep``, ``route_forward``,
  ``route_composite``, ``route_chain``: each alone (``Tf32Pass.args.parts``)
  on the buffers the full pass left;
* ``no_stores``: a copy whose forward and chain store no activation or
  cotangent to the scratch (the masks, raw and its cotangent stay);
* ``no_mma``: a copy without the wgmmas (the weight stream, the splits,
  the epilogues and every store stay);
* ``stream``: a copy with neither;
* ``staged``: a copy whose forward stores a_0 .. a_nt and feat through a
  staging tile per consumer ([H][64] f32 in shared memory, which costs
  ring stages) by one TMA store a layer, in place of streaming stores from
  the accumulator registers (its scratch is checked equal to the route's);
* ``torch_matmul``: the pass's layer products (forward: layer1, the trunk
  and its skip rows, fc_feat, fc_alpha, layers_dir.0, fc_rgb; chain: the
  transposed products of fc_rgb, layers_dir.0, fc_feat with fc_alpha, the
  trunk) as f32 ``torch.matmul`` calls (TF32 off) on random operands of the
  same shapes.

The copies compute wrong results; only their times are read. CUDA events
over ``--reps`` steps after a warm one, and the device time of every kernel
of those steps from a ``torch.profiler`` trace, by kernel; the whole round
twice. The FMA design's scratch and the route's are compared block by block
(max difference over the FMA design's largest entry of the block), and the
gradients after the package's dW launch leaf by leaf. Prints each build's
ptxas registers, the card line (nvidia-smi) and, as the last line, one JSON
object. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
BATCH = 8192
PASSES = (64, 128)  # samples a ray of the coarse and the fine pass
PART_NAMES = {1: "train_prep_tf32_kernel", 2: "train_fwd_tf32_kernel",
              4: "train_composite_tf32_kernel", 8: "train_chain_tf32_kernel"}
# the forward's and chain's scratch stores skipped (k, K < 0 never holds)
NO_STORES = {"fused_train_loss.cu": [
    ("  if (kStore && col < hm) {\n    float* d0", "  if (kStore && col < hm && k < 0) {\n    float* d0"),
    ("    if (col < hm) {\n      float* d0", "    if (col < hm && k < 0) {\n      float* d0"),
    ("          if (kSave && col < hm / 2) {", "          if (kSave && col < hm / 2 && K < 0) {"),
    ("            if (col < hm2) {", "            if (col < hm2 && K < 0) {"),
    ("            if (kSave) __stcs(ecol + (long long)f * K, val);",
     "            if (kSave && K < 0) __stcs(ecol + (long long)f * K, val);"),
]}
NO_MMA = {"mlp_tile_tf32.cuh": [
    ("wgmma_tf32_rs<N>(d, ", "if (0) wgmma_tf32_rs<N>(d, "),
    ("wgmma_tf32<N>(d, kmajor_desc(", "if (0) wgmma_tf32<N>(d, kmajor_desc("),
]}
# the forward's activations a_0 .. a_nt and feat through a staging tile per
# consumer ([H features][64 columns] f32 in shared memory, fewer ring
# stages) stored by TMA (one [64][H] box a layer from the map of
# dexnerf_variant_act_map, pass p.parts >> 4) instead of from registers;
# e and y stay register stores
STAGED = {"fused_train_loss.cu": [
    ('#include "mlp_tile_tf32.cuh"\n', '#include "dw_split.cuh"\n#include "mlp_tile_tf32.cuh"\n'),
    ("constexpr int kLoss = 4, kFieldFwd = 2, kFieldBwd = 3;\n",
     "constexpr int kLoss = 4, kFieldFwd = 2, kFieldBwd = 3;\n"
     "__device__ CUtensorMap g_act_maps[2];\n"),
    ("  size_t ring, area, area_bytes, aux, own, bars, total;",
     "  size_t ring, area, area_bytes, aux, own, stage, bars, total;"),
    ("  s.bars = s.own + kCons * kOwnBytes;\n",
     "  s.stage = (s.own + kCons * kOwnBytes + 1023) & ~(size_t)1023;\n"
     "  s.bars = s.stage + kCons * (size_t)H * 256;\n"),
    ("  if (kStore && col < hm) {\n    float* d0 = dst + (long long)col * k;\n"
     "    __stcs(d0, v0);\n"
     "    __stcs(d0 + k, v1);\n    __stcs(d0 + 8, v2);\n    __stcs(d0 + k + 8, v3);\n  }\n"
     "  if (kMask) {",
     "  if (kStore && col < hm) {\n    float* d0 = dst + (long long)col * k;\n    d0[0] = v0;\n"
     "    d0[k] = v1;\n    d0[8] = v2;\n    d0[k + 8] = v3;\n  }\n  if (kMask) {"),
    ("  float* rgbr = sig + kTile;                                              // [64][3]\n",
     "  float* rgbr = sig + kTile;\n"
     "  float* stage = reinterpret_cast<float*>(gbase + L.stage + cw * (size_t)H * 256);\n"
     "  const CUtensorMap* amap = &g_act_maps[p.parts >> 4];\n"),
    ("    wg_sync(bar);  // every warp is done with encf",
     "    if (t == 0) bulk_wait_read<0>();\n    wg_sync(bar);  // every warp is done with encf"),
    ("save_block<MW, kSave, false>(acol + R.a(0), K, hm, j, q, v0, v1, v2, v3, m);",
     "save_block<MW, kSave, false>(stage + row0, 64, hm, j, q, v0, v1, v2, v3, m);"),
    ("    fence_async_smem();\n    wg_sync(bar);\n    // ---- trunk, then fc_feat",
     "    fence_async_smem();\n    wg_sync(bar);\n"
     "    if (t == 0) {\n      tma_store_2d(amap, (int)col0, p.dx, smem_u32(stage));\n"
     "      bulk_commit();\n    }\n    // ---- trunk, then fc_feat"),
    ("      const float* bias = aux + p.aux_off[1 + i];\n      uint32_t m[MW];\n",
     "      if (t == 0) bulk_wait_read<0>();\n      wg_sync(bar);\n"
     "      const float* bias = aux + p.aux_off[1 + i];\n      uint32_t m[MW];\n"),
    ("      float* dst = acol + (i < nt ? R.a(i + 1) : R.feat());",
     "      float* dst = stage + row0;"),
    ("save_block<MW, kSave, kSave>(dst, K, hm, j, q, v0, v1, v2, v3, m);",
     "save_block<MW, kSave, kSave>(dst, 64, hm, j, q, v0, v1, v2, v3, m);"),
    ("      fence_async_smem();\n      wg_sync(bar);\n    }\n    // ---- layers_dir.0 on feat",
     "      fence_async_smem();\n      wg_sync(bar);\n      if (t == 0) {\n"
     "        tma_store_2d(amap, (int)col0, p.dx + (i + 1) * hm, smem_u32(stage));\n"
     "        bulk_commit();\n      }\n    }\n    // ---- layers_dir.0 on feat"),
    ("  // worker kCons b has more tiles: release",
     "  if (t == 0) bulk_wait_all();\n  // worker kCons b has more tiles: release"),
    ('}  // extern "C"',
     "int dexnerf_variant_act_map(int which, const float* act, long long k, long long rows,\n"
     "                            int hm) {\n"
     "  PFN_encodeTiled encode;\n"
     "  const cudaError_t err = tensor_map_encoder(&encode);\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  CUtensorMap m;\n"
     "  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};\n"
     "  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};\n"
     "  const cuuint32_t box[2] = {64, (cuuint32_t)hm};\n"
     "  const cuuint32_t unit[2] = {1, 1};\n"
     "  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(act), dims,\n"
     "             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,\n"
     "             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=\n"
     "      CUDA_SUCCESS) {\n"
     "    return (int)cudaErrorInvalidValue;\n"
     "  }\n"
     "  return (int)cudaMemcpyToSymbol(g_act_maps, &m, sizeof m, which * sizeof m);\n"
     "}\n\n}  // extern \"C\""),
]}
VARIANTS = {"no_stores": NO_STORES, "no_mma": NO_MMA, "stream": {**NO_STORES, **NO_MMA},
            "staged": STAGED}

MAX_LAYERS, MAX_FREQ = 40, 16


class _FmaArgs(ctypes.Structure):
    """The FMA design's ``TrainArgs`` (the parent's mirror)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("origins", "dirs", "viewdirs", "z", "dists", "noise", "target",
                     "depth_gt", "depth_coef", "wf", "wb", "weights_out", "rgb_out",
                     "loss_ray", "act", "dlt", "dir_enc", "dy_sum")
    ] + [("k", ctypes.c_int64)] + [
        (name, ctypes.c_int32)
        for name in ("ray0", "n_rays", "n_samples", "s_pad", "hidden", "num_trunk",
                     "skip_mask", "fx", "fd", "inc_x", "inc_d", "white_bg", "luma",
                     "has_noise", "has_depth")
    ] + [
        ("w_off", ctypes.c_int32 * MAX_LAYERS),
        ("b_off", ctypes.c_int32 * MAX_LAYERS),
        ("wb_off", ctypes.c_int32 * MAX_LAYERS),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


def edited(text, edits):
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(sources):
    """Each name -> (main file, {file name: text}, include directory): the
    files written into a directory of their own (found before the include
    directory) and the main one compiled into a shared library, all at
    once; returns name -> (ctypes library, ptxas lines)."""
    from dexnerf_tpu_torch.ops import _build

    procs = {}
    for name, (main, files, include) in sources.items():
        out_dir = os.path.join(ROOT, "build", "train_pass_f32_variants", name)
        os.makedirs(out_dir, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-shared",
               "-o", os.path.join(out_dir, "lib.so"), os.path.join(out_dir, main)]
        procs[name] = (out_dir, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out_dir, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, "lib.so")), regs)
    return libs


def pass_inputs(n, s, seed, torch, dev):
    """Seeded rays, depths, intervals, σ-noise (std 0.2) and targets."""
    from dexnerf_tpu_torch.core.sampling import stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists

    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn((n, 3), generator=gen, device=dev)
    o = 0.2 * torch.randn((n, 3), generator=gen, device=dev)
    v = d / d.norm(dim=-1, keepdim=True)
    near = torch.full((n,), 2.0, device=dev)
    z = stratified_z_vals(near, near + 4.0, s)
    z = (z + torch.rand(z.shape, generator=gen, device=dev) * (4.0 / s)).contiguous()
    return dict(origins=o, dirs=d, viewdirs=v, z=z, dists=ray_dists(z, d).contiguous(),
                noise=0.2 * torch.randn((n, s), generator=gen, device=dev),
                target=torch.rand((n, 3), generator=gen, device=dev))


class OnePass:
    """One pass (s samples a ray): its inputs, outputs, a WeightGradients
    scratch for the route and one for the FMA design, the route's
    Tf32Pass."""

    def __init__(self, lib, model, s, seed, torch, dev):
        from dexnerf_tpu_torch.ops import fused_train_loss as ftl
        from dexnerf_tpu_torch.ops._weight_grads import WeightGradients

        self.s, self.s_pad = s, -(-s // 64) * 64
        self.chunk = max(1, min(BATCH, ftl.SCRATCH_SAMPLES // self.s_pad))
        self.inp = pass_inputs(BATCH, s, seed, torch, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.out = dict(weights_out=torch.empty((BATCH, s), **f32),
                        rgb_out=torch.empty((BATCH, 3), **f32),
                        loss_ray=torch.empty((BATCH,), **f32))
        self.wg = WeightGradients(lib, model, BATCH, self.chunk, self.s_pad, dev)
        self.wg_fma = WeightGradients(lib, model, BATCH, self.chunk, self.s_pad, dev)
        self.ps = ftl.Tf32Pass(lib, model, {**self.inp, "depth_gt": None, "depth_coef": None,
                                            **self.out}, BATCH, s, self.s_pad, self.chunk,
                               self.wg, white_background=False, supervision="rgb",
                               log_sampling_xyz=True, log_sampling_dir=True)


def lib_stages(lib, model):
    """(forward, chain) ring stages that ``lib``'s launcher takes for
    ``model`` (a variant may hold more shared memory)."""
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops.fused_render import bf16_hidden

    out = (ctypes.c_int * 8)()
    lib.dexnerf_train_tf32_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    _build.check(_build.load_library(), lib.dexnerf_train_tf32_occupancy(
        bf16_hidden(model.hidden_size), model.num_layers - 1, -(-model.dim_xyz // 32),
        ctypes.addressof(out)), "occupancy query")
    return out[2], out[5]


def route_run(lib, passes, parts, torch, stages=None):
    """Launch ``parts`` of every chunk of both passes through ``lib``'s
    ``dexnerf_train_pass`` (the package's library or a variant's, at its
    ``stages``; pass i as bits 4.. of ``parts``)."""
    from dexnerf_tpu_torch.ops import _build

    lib.dexnerf_train_pass.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    for i, p in enumerate(passes):
        a = p.ps.args
        keep = a.fwd_stages, a.chain_stages
        a.parts = parts | i << 4
        if stages is not None:
            a.fwd_stages, a.chain_stages = stages
        try:
            for c in range(p.wg.n_chunks):
                a.ray0 = c * p.chunk
                a.n_rays = min(p.chunk, BATCH - a.ray0)
                a.k = a.n_rays * p.s_pad
                _build.check(_build.load_library(),
                             lib.dexnerf_train_pass(ctypes.addressof(a), stream), "pass launch")
        finally:
            a.fwd_stages, a.chain_stages = keep
            a.parts = parts


def pack_backward_weights(model, device):
    """The FMA design's chain weights (its ``pack_backward_weights``): each
    matrix ``[out, in]`` as ``nn.Linear.weight`` keeps it, cut to the input
    columns that carry a gradient, each from a 16-byte boundary:
    ``fc_rgb``, ``layers_dir.0`` [:, :H], ``fc_feat`` with ``fc_alpha`` as
    one more row, then ``layers_xyz.i`` [:, :H]. Returns the buffer and the
    offsets."""
    import torch

    H = model.hidden_size
    mats = [model.fc_rgb.weight, model.layers_dir[0].weight[:, :H],
            torch.cat([model.fc_feat.weight, model.fc_alpha.weight], dim=0),
            *(lin.weight[:, :H] for lin in model.layers_xyz)]
    chunks, offsets, pos = [], [], 0
    for m in mats:
        pad = -pos % 4
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.float32, device=m.device))
            pos += pad
        offsets.append(pos)
        flat = m.detach().reshape(-1).to(torch.float32)
        chunks.append(flat)
        pos += flat.numel()
    return torch.cat(chunks).to(device), offsets


def fma_runner(lib, model, passes, torch):
    """Every chunk of both passes through the FMA design's
    ``train_pass_kernel``, into each pass's ``wg_fma`` scratch; its
    ``launch(i, c)`` runs chunk c of pass i alone."""
    from dexnerf_tpu_torch.core.encoding import frequency_bands
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops.fused_render import pack_flex_weights

    if lib.dexnerf_train_args_size() != ctypes.sizeof(_FmaArgs):
        raise RuntimeError("the FMA design's TrainArgs is not the mirror here")
    dev = next(model.parameters()).device
    wf, f_off = pack_flex_weights(model, dev)
    wb, b_off = pack_backward_weights(model, dev)
    blocks = []
    for p in passes:
        a = _FmaArgs()
        for name, t in (*p.inp.items(), ("wf", wf), ("wb", wb), *p.out.items(),
                        ("act", p.wg_fma.act), ("dlt", p.wg_fma.dlt),
                        ("dir_enc", p.wg_fma.dir_enc), ("dy_sum", p.wg_fma.dy_sum)):
            setattr(a, name, t.data_ptr())
        a.n_samples, a.s_pad = p.s, p.s_pad
        a.hidden, a.num_trunk = model.hidden_size, model.num_layers - 1
        a.skip_mask = sum(1 << i for i in model.skips)
        a.fx, a.fd = model.num_encoding_fn_xyz, model.num_encoding_fn_dir
        a.inc_x, a.inc_d = int(model.include_input_xyz), int(model.include_input_dir)
        a.has_noise = 1
        a.w_off[:len(f_off) // 2] = f_off[0::2]
        a.b_off[:len(f_off) // 2] = f_off[1::2]
        a.wb_off[:len(b_off)] = b_off
        bx = frequency_bands(model.num_encoding_fn_xyz, True).tolist()
        bd = frequency_bands(model.num_encoding_fn_dir, True).tolist()
        a.bands_x[:len(bx)] = bx
        a.bands_d[:len(bd)] = bd
        blocks.append(a)
    lib.dexnerf_train_pass.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    main = _build.load_library()

    def launch(i, c):
        p, a = passes[i], blocks[i]
        a.ray0 = c * p.chunk
        a.n_rays = min(p.chunk, BATCH - a.ray0)
        a.k = a.n_rays * p.s_pad
        _build.check(main, lib.dexnerf_train_pass(ctypes.addressof(a),
                                                  torch.cuda.current_stream().cuda_stream),
                     "FMA pass launch")

    def run():
        for i, p in enumerate(passes):
            for c in range(p.wg.n_chunks):
                launch(i, c)

    run.launch, run.keep = launch, (wf, wb)
    return run


def pass_products(model, k, torch, dev):
    """Random f32 operands (activation [k, K], weight [K, N]) of one pass's
    layer products over k samples: the forward's, then the chain's."""
    H, h2, dx = model.hidden_size, model.hidden_size // 2, model.dim_xyz
    nt = model.num_layers - 1
    fwd = [(dx, H)] + [(H, H)] * nt + [(dx, H)] * len(model.skips)
    fwd += [(H, H), (H, 1), (H, h2), (h2, 3)]
    chain = [(3, h2), (h2, H), (H + 1, H)] + [(H, H)] * nt
    gen = torch.Generator(device=dev).manual_seed(5)
    return [(torch.randn((k, a), generator=gen, device=dev),
             torch.randn((a, b), generator=gen, device=dev)) for a, b in fwd + chain]


def scratch_diff(model, p, torch):
    """The FMA design's scratch against the route's, block by block (the
    first chunk's real columns): max difference over the FMA design's
    largest entry."""
    R = p.wg.rows
    H, nt = model.hidden_size, model.num_layers - 1
    k = p.chunk * p.s_pad
    real = (torch.arange(k, device=p.wg.act.device) % p.s_pad) < p.s
    out = {}
    blocks = {"act": [("e", R["e"], model.dim_xyz)]
              + [(f"a{i}", R["a"][i], H) for i in range(nt + 1)]
              + [("feat", R["feat"], H), ("y", R["y"], H // 2)],
              "dlt": [(f"d{i}", R["d"][i], H) for i in range(nt + 2)]
              + [("dsig", R["dsig"], 1), ("dy", R["dy"], H // 2), ("drgb", R["drgb"], 3)]}
    for buf, items in blocks.items():
        f = getattr(p.wg_fma, buf)[:R[f"{buf}_rows"] * k].view(-1, k)[:, real]
        r = getattr(p.wg, buf)[:R[f"{buf}_rows"] * k].view(-1, k)[:, real]
        for name, r0, w in items:
            a, b = f[r0:r0 + w], r[r0:r0 + w]
            out[f"{buf}.{name}"] = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fma", required=True, help="directory of the FMA design's sources")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_pass_f32_variants: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    fma_dir, csrc = os.path.abspath(args.fma), str(_build.CSRC)
    with open(os.path.join(fma_dir, "fused_train_loss.cu")) as f:
        fma_src = f.read()
    texts = {}
    for fname in ("fused_train_loss.cu", "mlp_tile_tf32.cuh"):
        with open(os.path.join(csrc, fname)) as f:
            texts[fname] = f.read()
    sources = {"fma": ("fused_train_loss.cu", {"fused_train_loss.cu": fma_src}, fma_dir)}
    for name, edits in VARIANTS.items():
        files = {fn: edited(texts[fn], edits.get(fn, [])) for fn in texts}
        sources[name] = ("fused_train_loss.cu", files, csrc)
    libs = build(sources)
    route_regs = [l.strip() for l in _build.build_log.splitlines()
                  if "registers" in l or "spill" in l]

    dev = torch.device("cuda")
    model = FlexibleNeRFModel(**FULL).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    passes = [OnePass(main_lib, model, s, 1 + i, torch, dev) for i, s in enumerate(PASSES)]
    fma_run = fma_runner(libs["fma"][0], model, passes, torch)
    runs = {"fma": fma_run, "route": lambda: route_run(main_lib, passes, 15, torch)}
    for bit, part in ((1, "prep"), (2, "forward"), (4, "composite"), (8, "chain")):
        runs[f"route_{part}"] = (lambda b=bit: route_run(main_lib, passes, b, torch))
    for name in VARIANTS:
        st = lib_stages(libs[name][0], model)
        runs[name] = (lambda n=name, st=st: route_run(libs[n][0], passes, 15, torch, st))
    # the staged copy's tensor maps, one per pass; it writes the same scratch
    staged = libs["staged"][0]
    staged.dexnerf_variant_act_map.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                               ctypes.c_longlong, ctypes.c_int]
    for i, p in enumerate(passes):
        _build.check(main_lib, staged.dexnerf_variant_act_map(
            i, p.wg.act.data_ptr(), p.chunk * p.s_pad, p.wg.rows["act_rows"],
            model.hidden_size), "staged tensor map")
    route_run(main_lib, passes, 15, torch)
    want_act = [p.wg.act.clone() for p in passes]
    runs["staged"]()
    torch.cuda.synchronize()
    staged_equal = all(bool(torch.equal(w, p.wg.act)) for w, p in zip(want_act, passes))
    del want_act
    gemms = [g for s in PASSES for g in pass_products(model, BATCH * s, torch, dev)]
    runs["torch_matmul"] = lambda: [torch.matmul(a, b) for a, b in gemms]

    # the FMA design against the route: the scratch of each pass's first
    # chunk, then the gradients of the whole pass through the dW launch
    diffs, leaves = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for i, (p, tag) in enumerate(zip(passes, ("coarse", "fine"))):
        p.ps.args.parts = 15
        for c in range(p.wg.n_chunks):
            rays = min(p.chunk, BATCH - c * p.chunk)
            p.ps.run(c, stream)
            fma_run.launch(i, c)
            if c == 0:
                torch.cuda.synchronize()
                diffs[tag] = scratch_diff(model, p, torch)
            p.wg.chunk(c, rays, stream)
            p.wg_fma.chunk(c, rays, stream)
        grads = {key: torch.cat([g.reshape(-1) for g in wg.reduce(stream)]).clone()
                 for key, wg in (("route", p.wg), ("fma", p.wg_fma))}
        torch.cuda.synchronize()
        out, off = {}, 0
        for name, prm in model.named_parameters():
            f, r = (grads[k][off:off + prm.numel()] for k in ("fma", "route"))
            off += prm.numel()
            out[name] = float((f - r).abs().max()) / max(float(f.abs().max()), 1e-30)
        leaves[tag] = out

    ms, dev_ms, by_kernel = {}, {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.reps):
                run()
            t1.record()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.reps):
                    run()
                torch.cuda.synchronize()
            evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            kern = sum(e.time_range.end - e.time_range.start for e in evs)
            ms.setdefault(name, []).append(round(t0.elapsed_time(t1) / args.reps, 3))
            dev_ms.setdefault(name, []).append(round(kern / 1e3 / args.reps, 3))
            parts = {}
            for e in evs:
                part = next((v for v in PART_NAMES.values() if v in e.name), None)
                if part is not None:
                    parts[part] = parts.get(part, 0.0) + (e.time_range.end - e.time_range.start)
            if parts:
                by_kernel.setdefault(name, []).append(
                    {k: round(v / 1e3 / args.reps, 3) for k, v in parts.items()})
    for name, (_, regs) in libs.items():
        print(f"{name}: " + "; ".join(regs[-6:]))
    print("route: " + "; ".join(l for l in route_regs if "tf32" in l or "Used" in l)[-600:])
    print("fma vs route, scratch blocks of the first chunk, max difference over the FMA "
          "design's largest entry: " + json.dumps(diffs))
    print("fma vs route, gradient leaves after the dW launch: " + json.dumps(leaves))
    print("device ms by kernel: " + json.dumps(by_kernel))
    print(card)
    worst = {tag: max(v.values()) for tag, v in leaves.items()}
    stages = {n: lib_stages(libs[n][0], model) for n in VARIANTS}
    print(f"ring stages (forward, chain): route {lib_stages(main_lib, model)}, "
          + json.dumps(stages)
          + f"; the staged copy's scratch equal to the route's: {staged_equal}")
    print(json.dumps({"card": card, "ms": ms, "device_ms": dev_ms, "fma_vs_route": worst,
                      "samples": BATCH * sum(PASSES), "np": np.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
