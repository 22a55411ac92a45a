#!/usr/bin/env python3
"""Where kernel 1's bf16 route (``ops/csrc/fused_render_bf16.cu``) spends its
time, on one NVIDIA Hopper card.

    python3 perf_tools/kernel1_phases.py

From the repository root. It builds copies of the kernel's source, each with
one part removed (the wgmmas, the epilogues of the hidden layers, the
positional encoding's sincosf, the compositing and Dex; ``loads`` removes all
four and leaves the weight stream and its waits), and one copy that sums
``clock64`` deltas per phase over every consumer warpgroup. Then it times each
copy on a 160,000-ray frame (a 400x400 frame's ray count) at 8x128, skip 3,
PE 10/4, with seeded random weights whose sigma head is scaled to std 30:
the coarse pass (64 samples) and the fine pass (128 samples, 20 Dex
thresholds), CUDA events, mean of 3 after a warm call, twice each. A copy
whose edit no longer matches the source raises. The variants compute wrong
outputs; only their times are read. Prints the card line (nvidia-smi) and, as
the last line, one JSON object. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MMA = [("wgmma_bf16_rs<NO>(", "if (0) wgmma_bf16_rs<NO>("),
       ("wgmma_bf16<H, 0, 0>(", "if (0) wgmma_bf16<H, 0, 0>(")]
EPI = [("hidden_epilogue<H, ", "if (0) hidden_epilogue<H, ")]
PE = [("sincosf(__fmul_rn(pt, band(f)), &sn, &cs);", "sn = pt; cs = pt;")]
COMP = [("for (int rr = warp; rr < nrays; rr += 4)", "for (int rr = warp; rr < 0; rr += 4)"),
        ("for (int i = warp; i < nrays * p.n_thr; i += 4)", "for (int i = warp; i < 0; i += 4)")]
VARIANTS = {"full": [], "no_wgmma": MMA, "no_epilogue": EPI, "no_pe": PE, "no_composite": COMP,
            "loads": MMA + EPI + PE + COMP}
PHASES = ["unit prologue", "encoding", "chunk waits", "products", "epilogues",
          "compositing and Dex", "unit barrier", "tail"]


def _pt(k):
    return f"{{ long long _n = clock64(); prof[{k}] += _n - prof_t; prof_t = _n; }}"


# the phase profile: each edit appends a clock64 mark to a line of the kernel
PROFILE = [
    ('asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\\n");',
     'asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\\n");\n'
     '  long long prof_t = clock64(), prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};'),
    ("    for (int tile = 0; tile < tiles; ++tile) {\n",
     "    " + _pt(0) + "\n    for (int tile = 0; tile < tiles; ++tile) {\n"),
    ("is written\n", "is written\n      " + _pt(1) + "\n"),
    ("wr.wait(kx);\n", "wr.wait(kx); " + _pt(2) + "\n"),
    ("wr.wait(n);\n", "wr.wait(n); " + _pt(2) + "\n"),
    ("wr.wait(KCH);\n", "wr.wait(KCH); " + _pt(2) + "\n"),
    ("wgmma_wait0();\n", "wgmma_wait0(); " + _pt(3) + "\n"),
    ("b_alpha, sig_rows);\n      }\n", "b_alpha, sig_rows);\n      }\n      " + _pt(4) + "\n"),
    ("b_alpha, sig_rows);\n        }\n", "b_alpha, sig_rows);\n        }\n        " + _pt(4) + "\n"),
    ("w_rgb, crgb);\n", "w_rgb, crgb); " + _pt(4) + "\n"),
    ("store_rgb(crgb, r0, b_rgb, rgbr);\n", "store_rgb(crgb, r0, b_rgb, rgbr); " + _pt(4) + "\n"),
    ("logits are written\n", "logits are written\n    " + _pt(6) + "\n"),
    ("the unit's data\n  }\n", "the unit's data\n    " + _pt(5) + "\n  }\n"),
    ("    wr.release(1);\n  }\n}\n",
     "    wr.release(1);\n  }\n  " + _pt(7) + "\n  if (t == 0) for (int i = 0; i < 8; ++i) "
     "atomicAdd(&g_prof[i], (unsigned long long)prof[i]);\n}\n"),
    ("namespace {\n\nconstexpr int kMaxUnitRows",
     "__device__ unsigned long long g_prof[8];\nnamespace {\n\nconstexpr int kMaxUnitRows"),
]
PROFILE_READ = ('\nextern "C" int prof_read(unsigned long long* out) {\n'
                '  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, 64);\n'
                '  unsigned long long z[8] = {0};\n'
                '  return e != cudaSuccess ? (int)e : (int)cudaMemcpyToSymbol(g_prof, z, 64);\n}\n')


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def kernel_source(csrc):
    """``fused_render_bf16.cu`` with the forward tile it shares with the
    training forward (``mlp_tile_bf16.cuh``) written in, so that the edits
    reach the tile's products and encoding too."""
    tile = (csrc / "mlp_tile_bf16.cuh").read_text().replace("#pragma once\n", "")
    src = (csrc / "fused_render_bf16.cu").read_text()
    return edited(src, [('#include "mlp_tile_bf16.cuh"\n', tile)])


def build(sources):
    """Each name -> source text compiled into its own shared library, all
    at once; returns name -> ctypes library."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "kernel1_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
               "-o", os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel1_phases: no CUDA card visible to PyTorch")
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
    src = kernel_source(_build.CSRC)
    sources = {name: edited(src, edits) for name, edits in VARIANTS.items()}
    sources["profile"] = edited(src, PROFILE) + PROFILE_READ
    libs = build(sources)
    entries = ("dexnerf_fused_render_bf16", "dexnerf_fused_render_bf16_occupancy")
    for lib in libs.values():
        for f in entries:
            getattr(lib, f).argtypes = getattr(main_lib, f).argtypes
            getattr(lib, f).restype = ctypes.c_int

    class Route:  # the render entry points from one variant, the rest as built
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, k):
            return getattr(self.lib if k in entries else main_lib, k)

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

    def run(m, args, thr):
        return fr.fused_render(m, *args, thresholds=thr, compute_dtype=torch.bfloat16)

    ms = {}
    try:
        for _ in range(2):
            for name in VARIANTS:
                _build._lib = Route(libs[name])
                for tag, m, args, thr in cases:
                    with torch.inference_mode():
                        run(m, args, thr)
                        torch.cuda.synchronize()
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        for _ in range(3):
                            run(m, args, thr)
                        t1.record()
                        torch.cuda.synchronize()
                    ms.setdefault(f"{name}_{tag}", []).append(round(t0.elapsed_time(t1) / 3, 3))
        prof_lib = libs["profile"]
        prof_lib.prof_read.argtypes = [ctypes.c_void_p]
        _build._lib = Route(prof_lib)
        shares = {}
        buf = (ctypes.c_ulonglong * 8)()
        for tag, m, args, thr in cases:
            with torch.inference_mode():
                run(m, args, thr)
                torch.cuda.synchronize()
                _build.check(main_lib, prof_lib.prof_read(buf), "profile reset")
                run(m, args, thr)
                torch.cuda.synchronize()
                _build.check(main_lib, prof_lib.prof_read(buf), "profile read")
            total = sum(buf)
            shares[tag] = {p: round(buf[i] / total, 4) for i, p in enumerate(PHASES)}
    finally:
        _build._lib = main_lib
    print(card)
    print(json.dumps({"ms": ms, "consumer_time_shares": shares}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
