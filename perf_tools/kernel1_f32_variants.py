#!/usr/bin/env python3
"""Kernel 1's float32 route on one NVIDIA Hopper card: where the f32 FMA
design (the first ``ops/csrc/fused_render.cu``, one 128-thread CTA a ray on
the CUDA cores) spends its time, and how it compares with the route the
package builds now.

    python3 perf_tools/kernel1_f32_variants.py --fma DIR [--reps N]

From the repository root. ``DIR`` holds the FMA design's ``fused_render.cu``
and ``mlp_tile.cuh`` (for example ``ops/csrc`` of a ``git archive`` of a
commit that still had it). The script builds copies of that source, each
with one part removed or swapped:

* ``fma``: as it is;
* ``no_wload``: the weights' ``__ldg`` loads swapped for values already in
  registers (the FMAs and the activations' shared-memory loads stay);
* ``no_composite``: the compositing and the Dex search removed;
* ``no_pe``: ``sincosf`` of the encoding swapped for a copy of its
  argument;
* ``no_fma``: the multiply-adds of the dense layers removed (the loads
  stay, their values summed once).

and copies of the package's own float32 route (``ops/csrc/fused_render.cu``
with ``mlp_tile_tf32.cuh`` written in, split TF32 on ``wgmma``):

* ``tf32_no_mma``: the wgmmas of every product removed (the weight
  stream, its waits and the epilogues stay);
* ``tf32_no_epilogue``: the hidden layers' epilogues removed (bias, ReLU,
  the split and the lo stores to shared memory);
* ``tf32_no_pe``: ``sincosf`` of the encoding swapped for a copy of its
  argument;
* ``tf32_no_composite``: the compositing and the Dex search removed;
* ``tf32_one_part``: every chunk product in one part of all its output
  columns (a 64-register accumulator at width 128 where the route uses two
  parts of 32): the same outputs, more registers;
* ``tf32_offset``: consumer 1 starts once consumer 0 has finished layer1
  of its first tile, so that the two, which share the weight ring, do not
  run their products and epilogues in step: the same outputs.

The variants compute wrong outputs; only their times are read. Then it
times them and the package's own float32 route (``fused_render(...,
compute_dtype=torch.float32)``, ``route``) in turns on a 160,000-ray frame (a 400x400
frame's ray count) at 8x128, skip 3, PE 10/4, with seeded random weights
whose sigma head is scaled to std 30: the coarse pass (64 samples) and the
fine pass (128 samples, 20 Dex thresholds). CUDA events over ``--reps``
back-to-back calls after a warm call, and device time from a
``torch.profiler`` trace of the same calls; the whole round twice. The FMA
copy and the package's route are compared on every output. Prints each
copy's ptxas registers, the card line (nvidia-smi) and, as the last line,
one JSON object. Exits non-zero without a card.
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

NO_WLOAD = [("const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow + c0));",
             "const float4 w0 = make_float4(a1.x, a0.y, a1.z, a0.w);"),
            ("const float4 w1 = hi ? __ldg(reinterpret_cast<const float4*>(wrow + c0 + 4))",
             "const float4 w1 = hi ? make_float4(a0.x, a1.y, a0.z, a1.w)")]
NO_COMPOSITE = [("  if (tid == 0) {\n    float trans = 1.f,",
                 "  if (tid < 0) {\n    float trans = 1.f,"),
                ("for (int t = tid; t < p.n_thr; t += kThreads) {",
                 "for (int t = tid; t < 0; t += kThreads) {")]
NO_PE = [("sincosf(__fmul_rn(p, bands[f]), &sn, &cs);", "sn = p; cs = p;")]
NO_FMA = [("    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);",
           "    for (int j = 0; j < 1; ++j) acc[i][i] += a[i] + w[i];")]
VARIANTS = {"fma": [], "no_wload": NO_WLOAD, "no_composite": NO_COMPOSITE, "no_pe": NO_PE,
            "no_fma": NO_FMA}
# the same for the package's split-TF32 source
TF32_VARIANTS = {
    "tf32_no_mma": [("    chunk_terms<NP, kRegA>(d,", "    if (0) chunk_terms<NP, kRegA>(d,")],
    "tf32_no_epilogue": [("hidden_epilogue_tf32<H, true, true>(acc",
                          "if (0) hidden_epilogue_tf32<H, true, true>(acc"),
                         ("hidden_epilogue_tf32<H, true, false>(acc",
                          "if (0) hidden_epilogue_tf32<H, true, false>(acc"),
                         ("hidden_epilogue_tf32<H, false, false>(acc",
                          "if (0) hidden_epilogue_tf32<H, false, false>(acc"),
                         ("hidden_epilogue_tf32<H, false, true>(acc",
                          "if (0) hidden_epilogue_tf32<H, false, true>(acc")],
    "tf32_no_pe": [("sincosf(__fmul_rn(pt, band(f)), &sn, &cs);", "sn = pt; cs = pt;")],
    "tf32_no_composite": [("for (int rr = warp; rr < nrays; rr += 4)",
                           "for (int rr = warp; rr < 0; rr += 4)"),
                          ("for (int i = warp; i < nrays * p.n_thr; i += 4)",
                           "for (int i = warp; i < 0; i += 4)")],
    "tf32_one_part": [("constexpr int NP = N > 64 ? N / 2 : N;", "constexpr int NP = N;")],
    "tf32_offset": [('asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");',
                     'asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");\n'
                     '  if (cw == 1) asm volatile("bar.sync 3, 256;\\n" ::: "memory");'),
                    ("      // ---- trunk, then fc_feat (layer nt + 1)\n",
                     "      if (cw == 0 && k == 0 && tile == 0) "
                     'asm volatile("bar.arrive 3, 256;\\n" ::: "memory");\n'
                     "      // ---- trunk, then fc_feat (layer nt + 1)\n")],
}
TF32_ENTRIES = ("dexnerf_fused_render", "dexnerf_fused_render_occupancy")


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def inlined(csrc, name, header):
    """``csrc/name`` with ``csrc/header`` written in, so that the edits
    reach the header's code too."""
    with open(os.path.join(csrc, header)) as f:
        text = f.read().replace("#pragma once\n", "")
    with open(os.path.join(csrc, name)) as f:
        return edited(f.read(), [(f'#include "{header}"\n', text)])


def build(sources):
    """Each name -> (source text, include directory) compiled into its own
    shared library, all at once; returns name -> (ctypes library, ptxas
    registers lines)."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "kernel1_f32_variants")
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
        regs = [l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l or "C7512" in l]
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), regs)
    return libs


def route_launcher(lib, main_lib, torch):
    """The package's float32 route with its render entry points taken from
    ``lib`` (a variant build) and everything else from ``main_lib``."""
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_render as fr

    for f in TF32_ENTRIES:
        getattr(lib, f).argtypes = getattr(main_lib, f).argtypes
        getattr(lib, f).restype = ctypes.c_int

    class Route:
        def __getattr__(self, k):
            return getattr(lib if k in TF32_ENTRIES else main_lib, k)

    def run(m, o, d, v, z, dz, thr):
        _build._lib = Route()
        try:
            return fr.fused_render(m, o, d, v, z, dz, thresholds=thr)
        finally:
            _build._lib = main_lib

    return run


def fma_launcher(lib, torch):
    """A call of the FMA design's C entry point (its own argument list) on
    one pass; returns the outputs as fused_render does."""
    from dexnerf_tpu_torch.core.encoding import frequency_bands
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_render as fr

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.dexnerf_fused_render
    fn.argtypes = [vp] * 12 + [ci] * 5 + [ci, ci, vp, ci, ci, vp, ci, vp, vp, ci, vp]
    fn.restype = ci
    packs = {}

    def run(m, o, d, v, z, dz, thr):
        if m not in packs:
            packs[m] = fr.pack_flex_weights(m, z.device)
        w, offsets = packs[m]
        N, S = z.shape
        f32 = dict(dtype=torch.float32, device=z.device)
        outs = (torch.empty((N, 3), **f32), torch.empty((N,), **f32), torch.empty((N,), **f32),
                torch.empty((N,), **f32), torch.empty((N, S), **f32),
                torch.empty((max(len(thr), 1), N), **f32))
        arrs = [(ctypes.c_float * 16)(*frequency_bands(m.num_encoding_fn_xyz).tolist()),
                (ctypes.c_float * 16)(*frequency_bands(m.num_encoding_fn_dir).tolist()),
                (ctypes.c_float * 64)(*thr), (ctypes.c_int * 80)(*offsets)]
        code = fn(*(t.data_ptr() for t in (o, d, v, z, dz, w)), *(t.data_ptr() for t in outs),
                  N, S, m.hidden_size, m.num_layers - 1, sum(1 << i for i in m.skips),
                  m.num_encoding_fn_xyz, int(m.include_input_xyz), arrs[0],
                  m.num_encoding_fn_dir, int(m.include_input_dir), arrs[1], len(thr), arrs[2],
                  arrs[3], 0, torch.cuda.current_stream().cuda_stream)
        _build.check(_build.load_library(), code, "FMA copy launch")
        return outs

    return run


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fma", required=True, help="directory of the FMA design's sources")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel1_f32_variants: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexnerf_tpu_torch.core.encoding import positional_encoding
    from dexnerf_tpu_torch.core.sampling import stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_render as fr

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    fma_dir, csrc = os.path.abspath(args.fma), str(_build.CSRC)
    src = inlined(fma_dir, "fused_render.cu", "mlp_tile.cuh")
    tf32 = inlined(csrc, "fused_render.cu", "mlp_tile_tf32.cuh")
    libs = build({**{name: (edited(src, e), fma_dir) for name, e in VARIANTS.items()},
                  **{name: (edited(tf32, e), csrc) for name, e in TF32_VARIANTS.items()},
                  "route": (tf32, csrc)})
    runs = {name: fma_launcher(libs[name][0], torch) for name in VARIANTS}
    runs["route"] = lambda m, o, d, v, z, dz, thr: fr.fused_render(m, o, d, v, z, dz,
                                                                 thresholds=thr)
    runs.update({name: route_launcher(libs[name][0], main_lib, torch)
                 for name in TF32_VARIANTS})

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 160_000
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    ro, rd, vd = (torch.tensor(a, device=dev) for a in (ro, rd, vd))
    near = torch.full((n,), 2.0, device=dev)
    cases = []
    for s_count, n_thr in ((64, 0), (128, 20)):
        m = FlexibleNeRFModel(num_layers=8, hidden_size=128, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
        z = stratified_z_vals(near, near + 4.0, s_count)
        with torch.no_grad():  # sigma logit over these samples: mean 0, std 30
            pts = ro[:, None] + rd[:, None] * z[..., None]
            raw = m(positional_encoding(pts, 10), positional_encoding(vd, 4))[..., 3]
            k = 30.0 / raw.std()
            m.fc_alpha.weight.mul_(k)
            m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
        thr = tuple(5.0 * (i + 1) for i in range(n_thr))
        cases.append((f"S{s_count}", m, (ro, rd, vd, z, ray_dists(z, rd)), thr))

    diff = {}
    with torch.inference_mode():
        for tag, m, a, thr in cases:
            want = runs["fma"](m, *a, thr)
            got = runs["route"](m, *a, thr)
            names = ("rgb", "disparity", "accumulation", "depth", "weights")
            d = {f: float((getattr(got, f) - w).abs().max()) for f, w in zip(names, want)}
            if thr:
                d["dex_equal_share"] = float((got.depth_dex == want[5]).float().mean())
            diff[tag] = d

    ms, dev_ms = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        for name, run in runs.items():
            for tag, m, a, thr in cases:
                with torch.inference_mode():
                    run(m, *a, thr)
                    torch.cuda.synchronize()
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(args.reps):
                        run(m, *a, thr)
                    t1.record()
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=acts) as prof:
                        for _ in range(args.reps):
                            run(m, *a, thr)
                        torch.cuda.synchronize()
                ms.setdefault(f"{name}_{tag}", []).append(
                    round(t0.elapsed_time(t1) / args.reps, 3))
                kern = sum(e.time_range.end - e.time_range.start for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and "fused_render" in e.name)
                dev_ms.setdefault(f"{name}_{tag}", []).append(round(kern / 1e3 / args.reps, 3))
    for name, (_, regs) in libs.items():
        print(f"{name}: " + "; ".join(regs))
    print(card)
    print(json.dumps({"card": card, "ms": ms, "device_ms": dev_ms, "route_vs_fma": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
