#!/usr/bin/env python3
"""Kernels 2 and 3 at float32 on one NVIDIA Hopper card: the route the
package builds (kernel 4's split-TF32 kernels in ``ops/csrc/fused_train_loss.cu``
launched with the tags 2 and 3, then the split-TF32 dW) beside the
one-CTA-a-ray FMA kernels it replaced (``field_fwd_kernel``,
``field_bwd_kernel``) and the same layer products as f32 ``torch.matmul``.

    python3 perf_tools/field_f32_variants.py --fma DIR [--reps N]

From the repository root. ``DIR`` holds the FMA design's ``fused_mlp.cu``
and ``fused_mlp_train.cu`` with ``mlp_chain.cuh``, ``mlp_tile.cuh`` and
``train_rows.cuh``: ``ops/csrc`` of a ``git archive`` of a commit that still
had them. Timed, in turns, on one field-path train step's two passes (8x128,
skip 3, PE 10/4, batch 8192; a coarse pass of 64 samples a ray and a fine
pass of 128, kernel 3 in the chunks of ``SCRATCH_SAMPLES``; a seeded model,
points, view directions and cotangent):

* ``route_fwd``, ``fma_fwd``: kernel 2, the package's route and the FMA
  ``field_fwd_kernel`` built from ``DIR``;
* ``route_bwd``, ``fma_bwd``: kernel 3, the package's route and the FMA
  ``field_bwd_kernel`` followed by the package's split-TF32 dW launch and
  reduction on its scratch;
* ``matmul_fwd``, ``matmul_bwd``: the forward's layer products (kernel 2),
  and the forward's, the chain's and the weight gradients' (kernel 3), as
  f32 ``torch.matmul`` calls (TF32 off) on random operands of the same
  shapes.

CUDA events over ``--reps`` calls after a warm one, and every kernel's
device time from a ``torch.profiler`` trace of them, by kernel; the whole
round twice. The FMA design's raw and gradients are compared with the
route's (max difference over the FMA design's largest entry of each
leaf). Prints the FMA build's ptxas registers, the card line (nvidia-smi)
and, as the last line, one JSON object. Exits non-zero without a card.
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
MAX_LAYERS, MAX_FREQ = 40, 16
TILE = 64  # the FMA kernels' samples a tile


class _FieldArgs(ctypes.Structure):
    """The FMA design's ``FieldArgs`` (``mlp_chain.cuh``; the parent's mirror)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("pts", "viewdirs", "g", "wf", "wb", "raw", "act", "dlt", "dir_enc", "dy_sum")
    ] + [("k", ctypes.c_int64)] + [
        (name, ctypes.c_int32)
        for name in ("ray0", "n_rays", "n_samples", "s_pad", "hidden", "num_trunk", "skip_mask",
                     "fx", "fd", "inc_x", "inc_d")
    ] + [
        ("w_off", ctypes.c_int32 * MAX_LAYERS),
        ("b_off", ctypes.c_int32 * MAX_LAYERS),
        ("wb_off", ctypes.c_int32 * MAX_LAYERS),
        ("bands_x", ctypes.c_float * MAX_FREQ),
        ("bands_d", ctypes.c_float * MAX_FREQ),
    ]


def build_fma(fma_dir):
    """The FMA design's two sources compiled into one shared library;
    (library, ptxas register lines)."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "field_f32_variants")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "fma.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", fma_dir, "-shared", "-o", lib_path,
           os.path.join(fma_dir, "fused_mlp.cu"), os.path.join(fma_dir, "fused_mlp_train.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the FMA design:\n{log[-4000:]}")
    lib = ctypes.CDLL(lib_path)
    for fn in (lib.dexnerf_field_forward, lib.dexnerf_field_backward):
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    lib.dexnerf_field_args_size.restype = ctypes.c_int
    if lib.dexnerf_field_args_size() != ctypes.sizeof(_FieldArgs):
        raise RuntimeError("the FMA design's FieldArgs is not the mirror here")
    return lib, [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]


def fma_args(model, dev):
    """A ``_FieldArgs`` of ``model`` (the forward pack, the chain's
    matrices, the layout) and the buffers it points to."""
    from dexnerf_tpu_torch.core.encoding import frequency_bands
    from dexnerf_tpu_torch.ops.fused_render import pack_flex_weights
    from train_pass_f32_variants import pack_backward_weights

    wf, f_off = pack_flex_weights(model, dev)
    wb, b_off = pack_backward_weights(model, dev)
    a = _FieldArgs()
    a.wf, a.wb = wf.data_ptr(), wb.data_ptr()
    a.hidden, a.num_trunk = model.hidden_size, model.num_layers - 1
    a.skip_mask = sum(1 << i for i in model.skips)
    a.fx, a.fd = model.num_encoding_fn_xyz, model.num_encoding_fn_dir
    a.inc_x, a.inc_d = int(model.include_input_xyz), int(model.include_input_dir)
    a.w_off[:len(f_off) // 2] = f_off[0::2]
    a.b_off[:len(f_off) // 2] = f_off[1::2]
    a.wb_off[:len(b_off)] = b_off
    bx = frequency_bands(model.num_encoding_fn_xyz, True).tolist()
    bd = frequency_bands(model.num_encoding_fn_dir, True).tolist()
    a.bands_x[:len(bx)] = bx
    a.bands_d[:len(bd)] = bd
    return a, (wf, wb)


def pass_inputs(s, seed, torch, dev):
    """Seeded points (o + d z, stratified z), view directions and a
    cotangent of raw."""
    from dexnerf_tpu_torch.core.sampling import stratified_z_vals

    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn((BATCH, 3), generator=gen, device=dev)
    o = 0.2 * torch.randn((BATCH, 3), generator=gen, device=dev)
    near = torch.full((BATCH,), 2.0, device=dev)
    z = stratified_z_vals(near, near + 4.0, s)
    z = z + torch.rand(z.shape, generator=gen, device=dev) * (4.0 / s)
    pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    g = 1e-3 * torch.randn((BATCH, s, 4), generator=gen, device=dev)
    return pts, (d / d.norm(dim=-1, keepdim=True)).contiguous(), g


def products(model, k, torch, dev):
    """Random f32 operands (x [k, K], w [K, N]) of one pass's products over
    k samples: the forward's, the chain's and the weight gradients' (the
    cotangents^T x activations as [N, k] x [k, M])."""
    H, h2, dx = model.hidden_size, model.hidden_size // 2, model.dim_xyz
    nt = model.num_layers - 1
    fwd = [(dx, H)] + [(H, H)] * nt + [(dx, H)] * len(model.skips)
    fwd += [(H, H), (H, 1), (H, h2), (h2, 3)]
    chain = [(3, h2), (h2, H), (H + 1, H)] + [(H, H)] * nt
    gen = torch.Generator(device=dev).manual_seed(5)

    def ops(shapes):
        return [(torch.randn((k, a), generator=gen, device=dev),
                 torch.randn((a, b), generator=gen, device=dev)) for a, b in shapes]

    dw = [(torch.randn((b, k), generator=gen, device=dev),
           torch.randn((k, a), generator=gen, device=dev)) for a, b in fwd]
    return ops(fwd), ops(chain) + dw


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fma", required=True, help="directory of the FMA design's sources")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("field_f32_variants: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build, fused_mlp, fused_mlp_train
    from dexnerf_tpu_torch.ops._weight_grads import WeightGradients

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    fma_lib, fma_regs = build_fma(os.path.abspath(args.fma))
    dev = torch.device("cuda")
    model = FlexibleNeRFModel(**FULL).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    passes = [pass_inputs(s, 1 + i, torch, dev) for i, s in enumerate(PASSES)]
    fa, _packs = fma_args(model, dev)  # the packs stay alive with fa
    stream = torch.cuda.current_stream().cuda_stream
    fma_wgs = []
    for pts, _, _ in passes:
        s_pad = -(-pts.shape[1] // TILE) * TILE
        chunk = max(1, min(BATCH, fused_mlp_train.SCRATCH_SAMPLES // s_pad))
        fma_wgs.append((WeightGradients(main_lib, model, BATCH, chunk, s_pad, dev), chunk, s_pad))

    def fma_fwd():
        outs = []
        for pts, v, _ in passes:
            raw = torch.empty((BATCH, pts.shape[1], 4), device=dev)
            fa.pts, fa.viewdirs, fa.raw = pts.data_ptr(), v.data_ptr(), raw.data_ptr()
            fa.ray0, fa.n_rays, fa.n_samples = 0, BATCH, pts.shape[1]
            _build.check(main_lib, fma_lib.dexnerf_field_forward(ctypes.addressof(fa), stream),
                         "FMA forward")
            outs.append(raw)
        return outs

    def fma_bwd():
        outs = []
        for (pts, v, g), (wg, chunk, s_pad) in zip(passes, fma_wgs):
            fa.pts, fa.viewdirs, fa.g = pts.data_ptr(), v.data_ptr(), g.data_ptr()
            fa.act, fa.dlt = wg.act.data_ptr(), wg.dlt.data_ptr()
            fa.dir_enc, fa.dy_sum = wg.dir_enc.data_ptr(), wg.dy_sum.data_ptr()
            fa.n_samples, fa.s_pad = pts.shape[1], s_pad
            for c in range(wg.n_chunks):
                rays = min(chunk, BATCH - c * chunk)
                fa.ray0, fa.n_rays, fa.k = c * chunk, rays, rays * s_pad
                _build.check(main_lib, fma_lib.dexnerf_field_backward(ctypes.addressof(fa),
                                                                      stream), "FMA backward")
                wg.chunk(c, rays, stream)
            outs.append(wg.reduce(stream))
        return outs

    def route_fwd():
        return [fused_mlp._launch(model, p, v, **kw) for p, v, _ in passes]

    def route_bwd():
        return [fused_mlp_train._launch_backward(model, p, v, g, **kw) for p, v, g in passes]

    mm = [products(model, BATCH * s, torch, dev) for s in PASSES]
    fwd_ops = [o for f, _ in mm for o in f]
    bwd_ops = [o for f, b in mm for o in f + b]
    runs = {"route_fwd": route_fwd, "fma_fwd": fma_fwd, "route_bwd": route_bwd,
            "fma_bwd": fma_bwd,
            "matmul_fwd": lambda: [torch.matmul(a, b) for a, b in fwd_ops],
            "matmul_bwd": lambda: [torch.matmul(a, b) for a, b in bwd_ops]}

    # the FMA design against the route
    raw_r, raw_f = route_fwd(), fma_fwd()
    grads_r = [[t.clone() for t in gs] for gs in route_bwd()]
    grads_f = fma_bwd()
    torch.cuda.synchronize()
    diffs = {}
    for tag, rr, rf, gr, gf in zip(("coarse", "fine"), raw_r, raw_f, grads_r, grads_f):
        out = {"raw": float((rr - rf).abs().max()) / float(rf.abs().max())}
        for (name, _), a, b in zip(model.named_parameters(), gr, gf):
            out[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        diffs[tag] = out

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
            ms.setdefault(name, []).append(round(t0.elapsed_time(t1) / args.reps, 3))
            dev_ms.setdefault(name, []).append(
                round(sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / args.reps,
                      3))
            kern = {}
            for e in evs:  # by kernel name, without namespace, return type or arguments
                key = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                key = key.split("(")[0][:48]
                kern[key] = kern.get(key, 0.0) + (e.time_range.end - e.time_range.start)
            by_kernel.setdefault(name, []).append(
                {k: round(v / 1e3 / args.reps, 3) for k, v in sorted(kern.items(),
                                                                    key=lambda kv: -kv[1])[:6]})
    print("fma: " + "; ".join(fma_regs[-8:]))
    print("fma vs route, max difference over the FMA design's largest entry: "
          + json.dumps({t: {k: f"{v:.2e}" for k, v in d.items()} for t, d in diffs.items()}))
    print("device ms by kernel: " + json.dumps(by_kernel))
    print(card)
    print(json.dumps({"card": card, "ms": ms, "device_ms": dev_ms,
                      "fma_vs_route": {t: max(d.values()) for t, d in diffs.items()},
                      "samples": BATCH * sum(PASSES)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
