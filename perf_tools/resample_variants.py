#!/usr/bin/env python3
"""Where kernels 5 and 6 (``ops/csrc/resample.cu``: ``resample_kernel``,
``sample_pdf_kernel``) spend their time, on one NVIDIA Hopper card.

    python3 perf_tools/resample_variants.py [--other PATH.cu] [--reps N]

From the repository root. It builds copies of the source, each with one
part removed: ``no_sort`` (the fine depths' bitonic sort), ``no_merge`` (the
two binary searches that place the depths in the merged row), ``no_rank``
(the search of each draw in the CDF), ``no_cdf`` (the weights' prefix scan)
and ``rest`` (all four removed: the loads, the lerp and the stores). The
variants compute wrong outputs; only their times are read. ``warps8`` and
``pdf_warps8`` undo the CTA sizes (8 warps instead of 4 for kernel 5, of 16
for kernel 6) and compute the same outputs. ``--other`` adds another
version of the source (for example the parent commit's, from a ``git
archive``), built and timed beside it, and counts the entries in which its
outputs differ from this source's in their bits.

Inputs (seeded): 64 coarse depths ascending in [2, 6) per ray, weights
like compositing weights (U(0, 1)^4 scaled to sum to a U(0, 1) opacity),
every 16th ray near-delta (one weight 1, the rest 0), uniform draws, |d| of
a normal direction; kernel 6 on the coarse midpoints and weights[1:-1]
with 64 draws, at 8192 and 65536 rays. The full source
is held to the plain PyTorch versions first (share of entries within 1e-5
for z, 1e-4 for dists and sample_pdf). Device time per call from a
``torch.profiler`` trace of ``--reps`` calls of each copy (the copies in
turns, the whole round twice) and CUDA events over ``--reps`` back-to-back
calls. Prints each copy's ptxas registers, the card line (nvidia-smi) and,
as the last line, one JSON object. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "dexnerf_tpu_torch", "ops", "csrc", "resample.cu")

SORT = [("    warp_sort<FP>(zf);\n", "")]
MERGE = [("    search<L::kLogF, CP, true>(fs, qc, pc);\n"
          "    search<L::kLogC, FP, false>(zs, qf, pf);\n",
          "    for (int c = 0; c < CP; ++c) pc[c] = 0;\n"
          "    for (int j = 0; j < FP; ++j) pf[j] = 0;\n")]
RANK = [("  search<LOG, P, false>(cdf, u, rank);\n",
         "  for (int j = 0; j < P; ++j) rank[j] = 1;\n")]
CDF = [("    warp_cdf<CP>(r.w, M, cdf);  // its __syncwarp publishes zs and bins too\n",
        "    __syncwarp();\n"),
       ("    warp_cdf<CP>(r.w, M, cdf);  // its __syncwarp publishes bs too\n",
        "    __syncwarp();\n")]
# the CTA sizes, undone: 8 warps for kernel 5 (not 4) and for kernel 6 (not 16)
WARPS8 = [("constexpr int kResampleWarps = 4,", "constexpr int kResampleWarps = 8,")]
PDF_WARPS8 = [("kPdfWarps = 16;", "kPdfWarps = 8;")]
VARIANTS = {"full": [], "no_sort": SORT, "no_merge": MERGE, "no_rank": RANK, "no_cdf": CDF,
            "rest": SORT + MERGE + RANK + CDF, "warps8": WARPS8, "pdf_warps8": PDF_WARPS8}
SHAPES = (8192, 65536)
SC, SF = 64, 64


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"edit no longer matches the source: {old!r}")
        src = src.replace(old, new)
    return src


def build(sources, workdir):
    """{name: (library path, ptxas lines)} from {name: source text}, one
    nvcc each, all started together."""
    from dexnerf_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    jobs = {}
    for name, text in sources.items():
        cu = os.path.join(workdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"lib{name}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, cu]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, ptxas_lines(log))
    return out


def ptxas_lines(log):
    """Registers and spills of the instantiations the main path launches
    (64 + 64: <2, 2>; 63 bins, 64 draws: <2, 6, 2>; or untemplated kernels)."""
    keep, lines, name = [], log.splitlines(), None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("resample_kernel" in name or "sample_pdf_kernel" in name) \
                and ("ILi" not in name or "ILi2ELi2E" in name or "ILi2ELi6ELi2E" in name) \
                and ("registers" in line or "spill" in line):
            keep.append(f"{name}: {line.strip()}")
    return keep


def load(path):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dexnerf_resample.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.dexnerf_resample.restype = ci
    lib.dexnerf_sample_pdf.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.dexnerf_sample_pdf.restype = ci
    return lib


def inputs(n, torch):
    g = torch.Generator().manual_seed(n)
    z = torch.sort(2 + 4 * torch.rand(n, SC, generator=g), dim=-1).values
    # compositing weights: a row sums to the ray's opacity, at most 1
    w = torch.rand(n, SC, generator=g) ** 4
    w = w / w.sum(dim=-1, keepdim=True) * torch.rand(n, 1, generator=g)
    w[::16] = 0.0
    w[::16, 7] = 1.0
    u = torch.rand(n, SF, generator=g)
    dn = torch.randn(n, 3, generator=g).norm(dim=-1, keepdim=True)
    cuda = {k: v.cuda().contiguous() for k, v in dict(z=z, w=w, u=u, dn=dn).items()}
    cuda["bins"] = (0.5 * (cuda["z"][:, 1:] + cuda["z"][:, :-1])).contiguous()
    cuda["w_mid"] = cuda["w"][:, 1:-1].contiguous()
    return cuda


def calls(lib, x, torch):
    """(kernel 5 launch, kernel 6 launch) on the inputs ``x``; each returns
    its outputs."""
    n = x["z"].shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    def k5():
        zo = torch.empty(n, SC + SF, device="cuda")
        do = torch.empty_like(zo)
        err = lib.dexnerf_resample(x["z"].data_ptr(), x["w"].data_ptr(), x["u"].data_ptr(),
                                   x["dn"].data_ptr(), zo.data_ptr(), do.data_ptr(), n, SC, SF,
                                   stream)
        if err:
            raise RuntimeError(f"resample launch: cudaError {err}")
        return zo, do

    def k6():
        out = torch.empty(n, SF, device="cuda")
        err = lib.dexnerf_sample_pdf(x["bins"].data_ptr(), x["w_mid"].data_ptr(),
                                     x["u"].data_ptr(), out.data_ptr(), n, SC - 2, SF, stream)
        if err:
            raise RuntimeError(f"sample_pdf launch: cudaError {err}")
        return (out,)

    return k5, k6


def hold(lib, x, torch):
    """The full source against the plain versions: [share within tol,
    worst abs err] of z, dists, sample_pdf."""
    from dexnerf_tpu_torch.ops.resample import fused_resample_reference
    from dexnerf_tpu_torch.ops.sample_pdf import sample_pdf_reference

    k5, k6 = calls(lib, x, torch)
    (zo, do), (po,) = k5(), k6()
    torch.cuda.synchronize()
    wz, wd = fused_resample_reference(x["z"], x["w"], x["u"], x["dn"])
    wp = sample_pdf_reference(x["bins"], x["w_mid"], x["u"])
    out = {}
    for key, got, want, atol in (("z", zo, wz, 1e-5), ("dists", do[:, :-1], wd[:, :-1], 1e-4),
                                 ("sample_pdf", po, wp, 1e-4)):
        err = (got - want).abs()
        out[key] = [float((err <= atol).float().mean()), float(err.max())]
    out["z sorted"] = bool((zo[:, 1:] >= zo[:, :-1]).all())
    return out


def bits_differ(lib_a, lib_b, x, torch):
    a5, a6 = calls(lib_a, x, torch)
    b5, b6 = calls(lib_b, x, torch)
    out = {}
    for key, fa, fb in (("resample", a5, b5), ("sample_pdf", a6, b6)):
        ra, rb = fa(), fb()
        torch.cuda.synchronize()
        out[key] = [int((p.view(torch.int32) != q.view(torch.int32)).sum()) for p, q in zip(ra, rb)]
    return out


def device_ms(fn, torch, reps):
    """Device ms per call of the kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` warm calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("resample_kernel" in e.name or "sample_pdf_kernel" in e.name)]
    if len(spans) != reps:  # the trace lost events: say so, do not guess
        print(f"  profile: {len(spans)} kernel events in the trace of {reps} calls")
        return None
    return sum(spans) / reps / 1e3


def event_ms(fn, torch, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="another resample.cu to build and time beside it")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    with open(SOURCE) as f:
        src = f.read()
    sources = {name: edited(src, edits) for name, edits in VARIANTS.items()}
    if args.other:
        with open(args.other) as f:
            sources["other"] = f.read()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    result = {"card": card, "device": torch.cuda.get_device_name(0), "ptxas": {}, "hold": {},
              "bits_differ_from_other": {}, "device_ms": {}, "event_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, (_, lines) in libs.items():
            result["ptxas"][name] = lines
            for line in lines:
                print(f"  {name}: {line}")
        loaded = {name: load(path) for name, (path, _) in libs.items()}
        for n in SHAPES:
            x = inputs(n, torch)
            result["hold"][n] = hold(loaded["full"], x, torch)
            if "other" in loaded:
                result["hold"][f"{n} other"] = hold(loaded["other"], x, torch)
                result["bits_differ_from_other"][n] = bits_differ(loaded["full"],
                                                                  loaded["other"], x, torch)
            for kernel in (0, 1):
                label = f"{'resample' if kernel == 0 else 'sample_pdf'} {n}"
                fns = {name: calls(lib, x, torch)[kernel] for name, lib in loaded.items()}
                rounds = [{k: device_ms(fn, torch, args.reps) for k, fn in fns.items()}
                          for _ in range(2)]
                result["device_ms"][label] = {k: [r[k] and round(r[k], 5) for r in rounds]
                                              for k in fns}
                result["event_ms"][label] = {k: round(event_ms(fn, torch, args.reps), 5)
                                             for k, fn in fns.items()}
                print(f"{label}: device ms {json.dumps(result['device_ms'][label])}")
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
