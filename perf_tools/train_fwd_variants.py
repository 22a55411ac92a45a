#!/usr/bin/env python3
"""What holds the bf16 training forward (``train_fwd_bf16_kernel`` in
``ops/csrc/fused_train_loss_bf16.cu``, kernels 2-4) on one NVIDIA Hopper card.

    python3 perf_tools/train_fwd_variants.py

From the repository root. It builds copies of the kernel source, each with one
change, and times the forward of each on kernel 4's passes and kernel 2's
forward of one train step of the flagship config (batch 8192, 64 + 128
samples, 8x128 skip 3, PE 10/4, seeded random weights and inputs): ``full``
as committed; ``no_store`` without the activations' TMA stores (the
products, epilogues and staging writes alone); ``no_staging`` without the
staging writes either (the barriers stay); ``stmatrix`` with the staging
writes as ``stmatrix`` (four 8x8 matrices a warp instruction) instead of
32-bit stores; ``direct_stores`` with each hidden layer's activations
written straight from the A fragments by 4-byte streaming stores
(``st.global.cs``) instead of the staging tile and TMA (the encoding and y
keep theirs); ``one_staging_tile`` with one staging tile a consumer instead
of two (the ring gains the stages that frees); ``six_stages`` with the
weight ring capped at 6 stages (kernel 2's is 10); ``no_read_wait`` and
``no_barrier_a`` without the storing thread's wait for its older stores'
reads and without the barrier that hands that wait on (both unsafe: they
measure what the protocol costs). Device time of the
forward kernel per step from ``torch.profiler`` over 3 steps after a warm
one, each variant twice, in turns. A copy whose edit no longer matches the source
raises. The variants without stores compute wrong gradients; only their
times are read. Prints the card line (nvidia-smi) and, as the last line, one
JSON object. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_STORE = [("tma_store_2d(map, 64 * x, r0, src + x * kEncChunk);", "{}")]
DIRECT = [("""        wg_sync(bar);  // the first thread's last wait: the tile two stores back is read
        stage_frags<H>(stage + buf * KCH * kEncChunk, a);
        flush(blk, KCH);
""", """        unsigned* out =
            reinterpret_cast<unsigned*>(p.scratch + p.act_off[blk] + (long long)r0 * H);
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          __stcs(out + ((16 * warp + g) * H + 8 * j + 2 * q) / 2, a[2 * j]);
          __stcs(out + ((16 * warp + g + 8) * H + 8 * j + 2 * q) / 2, a[2 * j + 1]);
        }
""")]
ONE_TILE = [("constexpr int kStageBufs = 2;", "constexpr int kStageBufs = 1;"),
            ("    bulk_wait_read<1>();\n  }\n}\n", "    bulk_wait_read<0>();\n  }\n}\n"),
            ("buf ^= 1;", "buf = 0;")]
STMATRIX = [("""    sts32(dst + tile_off(row, 8 * j + 2 * q), a[2 * j]);
    sts32(dst + tile_off(row + 8, 8 * j + 2 * q), a[2 * j + 1]);
  }""", """    if (j % 2 == 0) {
      const int l = t & 31, rr = 16 * (t >> 5) + (l & 7) + 8 * ((l >> 3) & 1);
      asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\\n" ::
                   "r"(dst + tile_off(rr, 8 * j + 8 * (l >> 4))), "r"(a[2 * j]),
                   "r"(a[2 * j + 1]), "r"(a[2 * j + 2]), "r"(a[2 * j + 3]));
    }
  }""")]
NO_STAGING = NO_STORE + [("        stage_frags<H>(stage + buf * KCH * kEncChunk, a);\n", "")]
SIX_STAGES = [("for (int ns = kMaxStages; ns >= need; --ns) {",
               "for (int ns = 6; ns >= need; --ns) {")]
NO_WAIT = [("    bulk_wait_read<1>();\n  }\n}\n", "  }\n}\n")]
NO_BARRIER_A = [("        wg_sync(bar);  // the first thread's last wait: the tile two stores back is read\n",
                 "")]
VARIANTS = {"full": [], "no_store": NO_STORE, "no_staging": NO_STAGING, "stmatrix": STMATRIX,
            "direct_stores": DIRECT, "one_staging_tile": ONE_TILE, "six_stages": SIX_STAGES,
            "no_read_wait": NO_WAIT, "no_barrier_a": NO_BARRIER_A}
ENTRIES = ("dexnerf_train_bf16_pass", "dexnerf_field_bf16_pass", "dexnerf_train_bf16_occupancy")


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(sources):
    """Each name -> source text compiled into its own shared library, all
    at once; returns name -> ctypes library."""
    from dexnerf_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "train_fwd_variants")
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
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("train_fwd_variants: no CUDA card visible to PyTorch")
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    main_lib = _build.load_library()
    src = (_build.CSRC / "fused_train_loss_bf16.cu").read_text()
    libs = build({name: edited(src, edits) for name, edits in VARIANTS.items()})
    for lib in libs.values():
        for f in ENTRIES:
            getattr(lib, f).argtypes = getattr(main_lib, f).argtypes
            getattr(lib, f).restype = ctypes.c_int

    class Route:  # the forward's entry points from one variant, the rest as built
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
        m = FlexibleNeRFModel(num_layers=8, hidden_size=128, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(s)).to(dev)
        z = torch.sort(tensor(2 + 4 * rng.uniform(size=(n, s))), dim=-1).values.contiguous()
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
        passes.append((m, z, dists.contiguous(), tensor(rng.normal(size=(n, s)) * 0.2), pts))

    def kernel4():
        for m, z, dists, noise, _ in passes:
            ftl.fused_pass_loss(m, o, d, z, v, dists, noise, target,
                                compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)

    def kernel2():
        for m, *_, pts in passes:
            fm.fused_field(m, pts, v, compute_dtype=torch.bfloat16)

    def forward_ms(step, owner):
        with torch.no_grad():
            step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
        frag = f"train_fwd_bf16_kernel<{owner},"
        return round(sum(e.time_range.end - e.time_range.start for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and frag in e.name.replace(" ", "")) / 3 / 1e3, 4)

    ms, residency = {}, {}
    try:
        for _ in range(2):
            for name in VARIANTS:
                _build._lib = Route(libs[name])
                ftl._residency.clear()  # the variant's own stages and staging tiles
                occ = ftl.bf16_occupancy(passes[0][0])
                residency[name] = {k: occ[k] for k in ("forward", "field_forward")}
                ms.setdefault(name, {"kernel 4": [], "kernel 2": []})
                ms[name]["kernel 4"].append(forward_ms(kernel4, 4))
                ms[name]["kernel 2"].append(forward_ms(kernel2, 2))
    finally:
        _build._lib = main_lib
        ftl._residency.clear()
    print(card)
    print(json.dumps({"forward_ms_per_step": ms, "residency": residency}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
