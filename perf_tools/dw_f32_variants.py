#!/usr/bin/env python3
"""The f32 weight gradients of kernels 3 and 4 on one NVIDIA Hopper card:
the split-TF32 launch the package builds (``ops/csrc/dw_tf32.cu``) beside
the f32 FMA design it replaced, copies of it with parts removed, and the
same products as f32 ``torch.matmul`` calls.

    python3 perf_tools/dw_f32_variants.py --fma DIR [--reps N] [--other NAME=FILE ...]
        [--chunk-samples N ...]

From the repository root. ``DIR`` holds the FMA design's
``fused_train_loss.cu`` (``dw_kernel``, ``reduce_kernel``) with
``mlp_chain.cuh`` and ``mlp_tile.cuh``: ``ops/csrc`` of a ``git archive``
of a commit that still had it. Timed, in turns, on one step's scratch of
the f32 routes (8x128, skip 3, PE 10/4, batch 8192; a coarse pass of 64
samples in 2 chunks of 4096 rays and a fine pass of 128 in 4 of 2048, as
``SCRATCH_SAMPLES`` cuts them), filled from a seed:

* ``fma``: the FMA design's dW launch (one 256-thread CTA per 128 x 128
  tile and K-range, 8 x 8 register blocks) and its reduction, built from
  ``DIR``;
* ``route``: the package's split-TF32 launch and its reduction;
* ``tf32_no_mma``: a copy without the wgmmas (the TMA stream, the
  transform's split, the consumers' A loads, bias and heads, and the
  waits stay);
* ``tf32_no_split``: a copy whose transform stores no lo halves (the
  wgmmas read stale lo buffers);
* ``tf32_stream``: a copy with neither: the TMA stream through the ring,
  the barriers, the transform's reads and the consumers' CUDA-core work;
* ``tf32_stream_notransform``: that copy without the transform's reads;
* ``tf32_kblocked``, ``tf32_stream_kblocked``: the route and the stream
  copy with each box read as if the scratch were K-blocked, [k / 64][rows]
  [64] (each box one contiguous 16 KB span, where the feature-major rows
  are a chunk long, 1 MB apart): the same boxes from other addresses;
* ``tf32_regs_P_T_C``: the producer, transform and consumer warpgroups
  at P, T and C registers after ``setmaxnreg`` (the route: 24, 40, 224);
* ``tf32_evict_first``: the loads with an evict-first L2 policy;
* ``NAME`` (``--other NAME=FILE``): another ``dw_tf32.cu``, say an earlier
  design's, built against ``ops/csrc`` and timed on the same scratch;
* ``route_stages2``, ``route_stages4``: the route with two and four ring
  stages (it takes three, ``TF32_STAGES``);
* ``route_split_skip``, ``tf32_stream_split_skip``: the route and the
  stream copy on the plan with the skip layer's encoding product a unit of
  its own (:func:`split_skip_plan`: the cotangent read twice, stages of
  33 KB, five of them);
* ``route_chunkN``, ``tf32_stream_chunkN`` (``--chunk-samples N``): the
  route and the stream copy on scratch cut in chunks of N samples (rows
  of N floats) instead of ``SCRATCH_SAMPLES``;
* ``torch_matmul``: each chunk's products as f32 ``torch.matmul`` calls
  (TF32 off) on the same scratch rows, and the bias sums.

The copies compute wrong gradients; only their times are read. CUDA events
over ``--reps`` steps after a warm one, and the device time of every kernel
of those steps (the dW launches and the reduction) from a
``torch.profiler`` trace; the whole round twice. The FMA design's gradients
and the route's are compared leaf by leaf (max difference over the leaf's
largest entry), and the worst of the leaves the route takes on ``wgmma``
and of those it sums on the CUDA cores. Prints each build's ptxas
registers, the card line (nvidia-smi) and, as the last line, one JSON
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
NO_MMA = [("    wgmma_tf32_rs<N>(d, ", "    if (0) wgmma_tf32_rs<N>(d, ")]
NO_SPLIT = [("        for (int jj = 0; jj < 4; ++jj) sts128(",
             "        for (int jj = 0; r < 0 && jj < 4; ++jj) sts128(")]
# the scratch read as if it were K-blocked, [k / 64][rows][64] (a box of 64
# rows one contiguous 16 KB span): a 3D tensor map and 3D loads; the same
# boxes from other addresses
ENCODE = ("  const CUresult r = encode(static_cast<CUtensorMap*>(out), "
          "CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ")
LOAD = "        tma_load_2d(st + U.off[x], &p.maps[U.map[x]], j * kKc, U.row[x], full + 8 * s);"
K_BLOCKED = [
    ("  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};\n"
     "  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};\n"
     "  const cuuint32_t box[2] = {(cuuint32_t)kKc, (cuuint32_t)box_rows};\n"
     "  const cuuint32_t unit[2] = {1, 1};\n" + ENCODE + "2,",
     "  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)(k / 64)};\n"
     "  const cuuint64_t strides[2] = {64 * 4, (cuuint64_t)rows * 64 * 4};\n"
     "  const cuuint32_t box[3] = {(cuuint32_t)kKc, (cuuint32_t)box_rows, 1};\n"
     "  const cuuint32_t unit[3] = {1, 1, 1};\n" + ENCODE + "3,"),
    (LOAD,
     '        asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx'
     '::bytes [%0], [%1, {%2, %3, %4}], [%5];\\n" ::"r"(st + U.off[x]), '
     '"l"(reinterpret_cast<uint64_t>(&p.maps[U.map[x]])), "r"((j & 1) * kKc), "r"(U.row[x]), '
     '"r"(j >> 1), "r"(full + 8 * s) : "memory");')]
# the transform's reads of each stage skipped (it waits and releases only)
NO_TRANSFORM = [("      for (int x = U.n_a; x < U.n_op; ++x) {\n",
                 "      for (int x = U.n_a; r < 0 && x < U.n_op; ++x) {\n")]
# the loads with an evict-first L2 policy
EVICT_FIRST = [
    (LOAD,
     "        {\n"
     "          uint64_t pol;\n"
     '          asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" '
     ': "=l"(pol));\n'
     '          asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::'
     'complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\\n" ::'
     '"r"(st + U.off[x]), "l"(reinterpret_cast<uint64_t>(&p.maps[U.map[x]])), "r"(j * kKc), '
     '"r"(U.row[x]), "r"(full + 8 * s), "l"(pol) : "memory");\n'
     "        }")]


def regs(prod, trans, cons):
    """The warpgroups' registers after setmaxnreg (the route: 24, 40, 224)."""
    return [("constexpr int kProducerRegs = 24;", f"constexpr int kProducerRegs = {prod};"),
            ("constexpr int kTransformRegs = 40;", f"constexpr int kTransformRegs = {trans};"),
            ("constexpr int kConsumerRegs = 224;", f"constexpr int kConsumerRegs = {cons};")]


VARIANTS = {"tf32_no_mma": NO_MMA, "tf32_no_split": NO_SPLIT,
            "tf32_stream": NO_MMA + NO_SPLIT, "tf32_kblocked": K_BLOCKED,
            "tf32_stream_kblocked": NO_MMA + NO_SPLIT + K_BLOCKED,
            "tf32_stream_notransform": NO_MMA + NO_SPLIT + NO_TRANSFORM,
            "tf32_regs_40_40_216": regs(40, 40, 216), "tf32_regs_32_32_224": regs(32, 32, 224),
            "tf32_evict_first": EVICT_FIRST}
ENTRIES = ("dexnerf_dw_tf32", "dexnerf_dw_tf32_reduce")

# the FMA design's argument block (the parent's ops/_weight_grads.py)
FMA_MAX_ITEMS, FMA_TILE = 40, 128


class _GemmItem(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p), ("ld", ctypes.c_int64),
                ("k", ctypes.c_int64)] + [
        (n, ctypes.c_int32)
        for n in ("m", "n", "m_tiles", "tile0", "w_off", "ldw", "col_off", "b_off")]


class _GemmArgs(ctypes.Structure):
    _fields_ = [("items", _GemmItem * FMA_MAX_ITEMS), ("partial", ctypes.c_void_p),
                ("n_params", ctypes.c_int64), ("n_items", ctypes.c_int32),
                ("n_splits", ctypes.c_int32), ("part0", ctypes.c_int32)]


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(sources):
    """Each name -> (source text, include directory) compiled into its own
    shared library, all at once; returns name -> (ctypes library, ptxas
    lines)."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "dw_f32_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-shared",
               "-o", os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), regs)
    return libs


def fma_items(wg, model, k, rays):
    """The FMA design's products of one chunk (the parent's
    ``WeightGradients._items``)."""
    from dexnerf_tpu_torch.ops._weight_grads import _param_offsets

    rows, offs = wg.rows, _param_offsets(model)[0]
    H, H2, nt = model.hidden_size, model.hidden_size // 2, model.num_layers - 1
    dx, dd = model.dim_xyz, model.dim_dir
    a, d = rows["a"], rows["d"]

    def act(r):
        return wg.act.data_ptr() + 4 * r * k

    def dlt(r):
        return wg.dlt.data_ptr() + 4 * r * k

    e = act(rows["e"])
    items = [(e, dlt(d[0]), k, k, dx, H, offs["layer1.weight"], dx, 0, offs["layer1.bias"])]
    for i, lin in enumerate(model.layers_xyz):
        w, b = offs[f"layers_xyz.{i}.weight"], offs[f"layers_xyz.{i}.bias"]
        items.append((act(a[i]), dlt(d[i + 1]), k, k, H, H, w, lin.in_features, 0, b))
        if i in model.skips:
            items.append((e, dlt(d[i + 1]), k, k, dx, H, w, lin.in_features, H, -1))
    items += [
        (act(a[nt]), dlt(d[nt + 1]), k, k, H, H, offs["fc_feat.weight"], H, 0,
         offs["fc_feat.bias"]),
        (act(a[nt]), dlt(rows["dsig"]), k, k, H, 1, offs["fc_alpha.weight"], H, 0,
         offs["fc_alpha.bias"]),
        (act(rows["feat"]), dlt(rows["dy"]), k, k, H, H2, offs["layers_dir.0.weight"], H + dd,
         0, offs["layers_dir.0.bias"]),
        (wg.dir_enc.data_ptr(), wg.dy_sum.data_ptr(), rays, rays, dd, H2,
         offs["layers_dir.0.weight"], H + dd, H, -1),
        (act(rows["y"]), dlt(rows["drgb"]), k, k, H2, 3, offs["fc_rgb.weight"], H2, 0,
         offs["fc_rgb.bias"]),
    ]
    return items


def fma_launcher(lib, wg, model, torch):
    """One pass's dW launches and reduction through the FMA design."""
    from dexnerf_tpu_torch.ops import _build

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dexnerf_train_dw.argtypes = [vp, ci, vp]
    lib.dexnerf_train_reduce.argtypes = [vp, ci, ctypes.c_longlong, vp, vp, ci, vp, vp]
    n_params = wg.n_params
    tiles0 = 0
    for it in fma_items(wg, model, wg.k_full, 1):
        tiles0 += -(-it[4] // FMA_TILE) * -(-it[5] // FMA_TILE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits = max(1, min(256, 8 * sms // tiles0))
    partial = torch.empty(wg.n_chunks * n_splits * n_params, device="cuda")
    grad = torch.empty(n_params, device="cuda")
    chunk = wg.k_full // wg.s_pad
    main = _build.load_library()

    def run(n_rays):
        stream = torch.cuda.current_stream().cuda_stream
        for c in range(wg.n_chunks):
            rays = min(chunk, n_rays - c * chunk)
            k = rays * wg.s_pad
            args, tile0 = _GemmArgs(), 0
            items = fma_items(wg, model, k, rays)
            for slot, (a, b, ld, kk, m, n, w_off, ldw, col_off, b_off) in zip(args.items, items):
                mt, nt = -(-m // FMA_TILE), -(-n // FMA_TILE)
                slot.a, slot.b, slot.ld, slot.k = a, b, ld, kk
                slot.m, slot.n, slot.m_tiles, slot.tile0 = m, n, mt, tile0
                slot.w_off, slot.ldw, slot.col_off, slot.b_off = w_off, ldw, col_off, b_off
                tile0 += mt * nt
            args.partial, args.n_params = partial.data_ptr(), n_params
            args.n_items, args.n_splits, args.part0 = len(items), n_splits, c * n_splits
            _build.check(main, lib.dexnerf_train_dw(ctypes.addressof(args), tile0, stream),
                         "FMA dW launch")
        _build.check(main, lib.dexnerf_train_reduce(
            partial.data_ptr(), wg.n_chunks * n_splits, n_params, grad.data_ptr(), None, 0,
            None, stream), "FMA reduce launch")
        return grad

    return run


def split_skip_plan(model):
    """The package's plan with each skip layer's d_{i+1} x e product a unit
    of its own, without a bias (the layer's unit keeps it)."""
    from dexnerf_tpu_torch.ops import _weight_grads as wgr

    R, offs = wgr.scratch_rows(model), wgr._param_offsets(model)[0]
    H, dx = model.hidden_size, model.dim_xyz
    plan = list(wgr.tf32_dw_plan(model))
    for i in sorted(model.skips, reverse=True):
        w, ldw = offs[f"layers_xyz.{i}.weight"], model.layers_xyz[i].in_features
        d = (R["d"][i + 1], H)
        plan[1 + i] = wgr._tf32_unit((*d, offs[f"layers_xyz.{i}.bias"]), [(R["a"][i], H, w, ldw)])
        plan.insert(2 + i, wgr._tf32_unit((*d, -1), [(R["e"], dx, w + H, ldw)]))
    return tuple(plan)


def use_plan(wg, model, plan, dev):
    """Switch ``wg`` to ``plan``: its launch block, slots and reduction map."""
    import torch

    from dexnerf_tpu_torch.ops._weight_grads import _Tf32Args, tf32_dw_args, tf32_reduce_map

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    a = tf32_dw_args(model, sms, plan)
    wg.partials = [torch.empty(wg.n_chunks * a.max_pieces * wg.n_params, device=dev)]
    a.partial, a.vd = wg.partials[0].data_ptr(), wg.vd.data_ptr()
    a.dy_sum, a.dir_enc = wg.dy_sum.data_ptr(), wg.dir_enc.data_ptr()
    wg.parts, wg.map = (_Tf32Args * 1)(a), tf32_reduce_map(model, plan).to(dev)


def route_launcher(lib, wg, main_lib, stages=None):
    """One pass's dW launches and reduction through ``lib``'s split-TF32
    entry points and tensor maps (the package's library or a variant's)."""
    from dexnerf_tpu_torch.ops import _build

    for f in ENTRIES:
        getattr(lib, f).argtypes = getattr(main_lib, f).argtypes
        getattr(lib, f).restype = ctypes.c_int

    class Route:
        def __getattr__(self, k):
            return getattr(lib if k in ENTRIES else main_lib, k)

    chunk = wg.k_full // wg.s_pad
    # the tensor maps as the copy encodes them
    lib.dexnerf_dw_tf32_tensor_map.argtypes = main_lib.dexnerf_dw_tf32_tensor_map.argtypes
    maps = {k: wg.tensor_maps(lib, k) for k in wg.maps}

    def run(n_rays):
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        wg.lib = Route()
        main_maps, wg.maps = wg.maps, maps
        main_stages = wg.parts[0].n_stages
        wg.parts[0].n_stages = stages or main_stages
        try:
            for c in range(wg.n_chunks):
                wg.chunk(c, min(chunk, n_rays - c * chunk), stream)
            return wg.reduce(stream)
        finally:
            wg.lib, wg.maps = main_lib, main_maps
            wg.parts[0].n_stages = main_stages

    return run


def matmul_launcher(wg, model, torch):
    """One pass's products as f32 torch.matmul calls on the scratch rows."""
    rows = wg.rows
    H, H2, nt, dx, dd = (model.hidden_size, model.hidden_size // 2, model.num_layers - 1,
                         model.dim_xyz, model.dim_dir)
    chunk = wg.k_full // wg.s_pad

    def run(n_rays):
        out = []
        for c in range(wg.n_chunks):
            rays = min(chunk, n_rays - c * chunk)
            k = rays * wg.s_pad
            act = wg.act[:rows["act_rows"] * k].view(rows["act_rows"], k)
            dlt = wg.dlt[:rows["dlt_rows"] * k].view(rows["dlt_rows"], k)
            pairs = [(rows["d"][0], H, rows["e"], dx)]
            for i in range(nt):
                pairs.append((rows["d"][i + 1], H, rows["a"][i], H))
                if i in model.skips:
                    pairs.append((rows["d"][i + 1], H, rows["e"], dx))
            pairs += [(rows["d"][nt + 1], H, rows["a"][nt], H), (rows["dsig"], 1, rows["a"][nt], H),
                      (rows["dy"], H2, rows["feat"], H), (rows["drgb"], 3, rows["y"], H2)]
            for dr, n, ar, m in pairs:
                out.append(torch.matmul(dlt[dr:dr + n], act[ar:ar + m].t()))
            out.append(dlt[:rows["dlt_rows"]].sum(1))
            de = wg.dir_enc[:dd * rays].view(dd, rays)
            ds = wg.dy_sum[:H2 * rays].view(H2, rays)
            out.append(torch.matmul(ds, de.t()))
        return out

    return run


def wgmma_leaves(model):
    """The weight leaves whose products the route takes on the tensor
    cores (the thin heads, the biases and layers_dir.0's viewdir columns
    are summed on the CUDA cores)."""
    names = ["layer1.weight", "fc_feat.weight", "layers_dir.0.weight[:, :H]"]
    return names + [f"layers_xyz.{i}.weight" for i in range(len(model.layers_xyz))]


def fma_vs_route(model, fma, route):
    """Leaf name -> the largest difference of the flat gradients ``fma`` and
    ``route`` over the FMA design's largest entry of that leaf; layers_dir.0's
    weight as its first H columns and its viewdir columns."""
    out, off, H = {}, 0, model.hidden_size
    for name, p in model.named_parameters():
        a, b = (g[off:off + p.numel()].view(p.shape) for g in (fma, route))
        off += p.numel()
        parts = {name: (a, b)}
        if name == "layers_dir.0.weight":
            parts = {f"{name}[:, :H]": (a[:, :H], b[:, :H]), f"{name}[:, H:]": (a[:, H:], b[:, H:])}
        for key, (x, y) in parts.items():
            out[key] = float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fma", required=True, help="directory of the FMA design's sources")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--other", nargs="*", default=[], metavar="NAME=FILE",
                    help="also time these copies of dw_tf32.cu (built against ops/csrc)")
    ap.add_argument("--chunk-samples", type=int, nargs="*", default=[],
                    help="also time the route and tf32_stream at these scratch chunks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dw_f32_variants: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops._weight_grads import WeightGradients

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    fma_dir, csrc = os.path.abspath(args.fma), str(_build.CSRC)
    with open(os.path.join(fma_dir, "fused_train_loss.cu")) as f:
        fma_src = f.read()
    with open(os.path.join(csrc, "dw_tf32.cu")) as f:
        tf32 = f.read()
    others = dict(o.split("=", 1) for o in args.other)
    sources = {"fma": (fma_src, fma_dir),
               **{name: (edited(tf32, e), csrc) for name, e in VARIANTS.items()}}
    for name, path in others.items():
        with open(path) as f:
            sources[name] = (f.read(), csrc)
    libs = build(sources)
    route_regs = [l.strip() for l in _build.build_log.splitlines()
                  if "registers" in l or "spill" in l]

    dev = torch.device("cuda")
    model = FlexibleNeRFModel(**FULL).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    def make_passes(samples, plan=None):
        """One WeightGradients a pass, chunked at ``samples`` scratch
        samples (with ``plan`` in place of the model's), filled from the
        seed."""
        out = []
        for s_pad in PASSES:
            chunk = max(1, min(BATCH, samples // s_pad))
            wg = WeightGradients(main_lib, model, BATCH, chunk, s_pad, dev)
            if plan is not None:
                use_plan(wg, model, plan, dev)
            with torch.no_grad():  # activations >= 0, cotangents of both signs
                wg.act.copy_(torch.relu(torch.randn(wg.act.shape, generator=gen, device=dev)))
                wg.dlt.copy_(torch.randn(wg.dlt.shape, generator=gen, device=dev) * 1e-3)
                wg.dir_enc.copy_(torch.randn(wg.dir_enc.shape, generator=gen, device=dev))
                wg.dy_sum.copy_(torch.randn(wg.dy_sum.shape, generator=gen, device=dev) * 1e-2)
            out.append(wg)
        return out

    passes = make_passes(ftl.SCRATCH_SAMPLES)
    on_wgmma = wgmma_leaves(model)
    runs = {"fma": [fma_launcher(libs["fma"][0], wg, model, torch) for wg in passes],
            "route": [route_launcher(main_lib, wg, main_lib) for wg in passes]}
    for name in [*VARIANTS, *others]:
        runs[name] = [route_launcher(libs[name][0], wg, main_lib) for wg in passes]
    # the route with two and four ring stages, and with the skip layer's encoding
    # product a unit of its own (smaller stages, five of them)
    for n in (2, 4):
        runs[f"route_stages{n}"] = [route_launcher(main_lib, wg, main_lib, stages=n)
                                    for wg in passes]
    split = make_passes(ftl.SCRATCH_SAMPLES, plan=split_skip_plan(model))
    runs["route_split_skip"] = [route_launcher(main_lib, wg, main_lib, stages=5)
                                for wg in split]
    runs["tf32_stream_split_skip"] = [route_launcher(libs["tf32_stream"][0], wg, main_lib,
                                                     stages=5) for wg in split]
    for samples in args.chunk_samples:  # other scratch chunks: the route and the stream
        other = make_passes(samples)
        runs[f"route_chunk{samples}"] = [route_launcher(main_lib, wg, main_lib)
                                         for wg in other]
        runs[f"tf32_stream_chunk{samples}"] = [
            route_launcher(libs["tf32_stream"][0], wg, main_lib) for wg in other]
    runs["torch_matmul"] = [matmul_launcher(wg, model, torch) for wg in passes]

    def step(name):
        return [run(BATCH) for run in runs[name]]

    # the FMA design against the route, leaf by leaf (layers_dir.0's weight
    # as its feat columns, wgmma products, and its viewdir columns)
    leaves, diff = {}, {}
    fma_g = [g.clone() for g in step("fma")]
    route_g = [torch.cat([t.reshape(-1) for t in g]) for g in step("route")]
    torch.cuda.synchronize()
    for tag, f, r in zip(("coarse", "fine"), fma_g, route_g):
        leaves[tag] = fma_vs_route(model, f, r)
        diff[tag] = {kind: max(v for k, v in leaves[tag].items() if (k in on_wgmma) == w)
                     for kind, w in (("wgmma", True), ("cuda_cores", False))}

    ms, dev_ms = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        for name in runs:
            step(name)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(args.reps):
                step(name)
            t1.record()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.reps):
                    step(name)
                torch.cuda.synchronize()
            kern = sum(e.time_range.end - e.time_range.start for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            ms.setdefault(name, []).append(round(t0.elapsed_time(t1) / args.reps, 3))
            dev_ms.setdefault(name, []).append(round(kern / 1e3 / args.reps, 3))
    samples = BATCH * sum(PASSES)
    rows = passes[0].rows
    scratch = samples * 4 * (rows["act_rows"] + rows["dlt_rows"])
    for name, (_, regs) in libs.items():
        print(f"{name}: " + "; ".join(regs))
    print("route: " + "; ".join(route_regs[-4:]))
    print(f"one step's scratch, read once: {scratch / 1e9:.4f} GB "
          f"({scratch / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s)")
    print("fma vs route, max difference over the leaf's largest entry: " + json.dumps(leaves))
    print(card)
    print(json.dumps({"card": card, "ms": ms, "device_ms": dev_ms, "fma_vs_route": diff,
                      "scratch_gb": scratch / 1e9, "samples": samples,
                      "np": np.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
