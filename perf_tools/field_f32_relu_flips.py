#!/usr/bin/env python3
"""How far kernel 3's f32 route (split TF32) and the f32 plain version
(cuBLAS) lie from float64 on a random cotangent, and how much of it is
ReLU decisions, on one NVIDIA Hopper card.

    python3 perf_tools/field_f32_relu_flips.py

From the repository root. On the card tests' inputs (seeded model,
points, view directions and cotangent): ``tests/test_torch_fused_mlp_tf32.py``'s
(301 rays) for 8x128 at S = 7, 64, 128 and 8x48 at S = 64, and
``tests/test_torch_fused_mlp.py``'s at 8x128, S = 100 (300 and 301 rays),
prints for each gradient leaf, relative to its largest entry: the route's
and the plain version's distance to the float64 model, first on the
float64 model's own ReLU decisions, then each on its own; the number of
ReLU decisions (a_1 .. a_nt, feat, y) in which the route and the plain
version differ, with the largest such activation relative to its layer's
largest; and the number in which each differs from float64. Prints the card line (nvidia-smi) and, as the last line,
one JSON object. Exits non-zero without a card.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# (test file, arch, S, rays)
CASES = (("tf32", "8x128", 64, 301), ("tf32", "8x128", 7, 301), ("tf32", "8x128", 128, 301),
         ("tf32", "8x48", 64, 301), ("fused_mlp", "8x128", 100, 300),
         ("fused_mlp", "8x128", 100, 301))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("field_f32_relu_flips: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import test_torch_fused_mlp
    import test_torch_fused_mlp_tf32
    from test_torch_fused_mlp_tf32 import CARD_ARCHS

    from dexnerf_tpu_torch.ops import fused_mlp_train
    from perf_tools.field_f32_rule import forward_on_masks, grads_on_masks, route_activations

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    out = {}
    files = {"tf32": test_torch_fused_mlp_tf32, "fused_mlp": test_torch_fused_mlp}
    for src, arch, s, rays in CASES:
        m, pts, vd, g = files[src]._card_case(dev, CARD_ARCHS[arch], rays, s)
        route = fused_mlp_train._launch_backward(m, pts, vd, g, **kw)
        plain = fused_mlp_train.field_grads_reference(m, pts, vd, g)
        with torch.no_grad():
            plain_acts = forward_on_masks(m, pts, vd)[1]
            route_acts = route_activations(m, pts, vd, g)
            exact_acts = forward_on_masks(copy.deepcopy(m).double(), pts.double(),
                                          vd.double())[1]
        masks = {"float64": [a > 0 for a in exact_acts], "route": [a > 0 for a in route_acts],
                 "plain": [a > 0 for a in plain_acts]}
        exact = {k: grads_on_masks(m, pts, vd, g, v) for k, v in masks.items()}
        leaves = {}
        for i, (name, _) in enumerate(m.named_parameters()):
            e64 = exact["float64"][i]
            scale = float(e64.abs().max())

            def rel(a, b):
                return float((a.double() - b).abs().max()) / scale

            leaves[name] = {
                "route_f64": rel(route[i], e64), "plain_f64": rel(plain[i], e64),
                "route_own": rel(route[i], exact["route"][i]),
                "plain_own": rel(plain[i], exact["plain"][i]),
            }
        flips, worst = 0, 0.0
        for ar, ap in zip(route_acts, plain_acts):
            f = (ar > 0) != (ap > 0)
            flips += int(f.sum())
            if bool(f.any()):
                worst = max(worst, float((ar - ap)[f].abs().max() / ap.abs().max()))
        off64 = {k: sum(int((a != b).sum()) for a, b in zip(masks[k], masks["float64"]))
                 for k in ("route", "plain")}
        key = f"{src}:{arch}-S{s}-N{rays}"
        out[key] = {"flips": flips, "worst_flip": worst, "flips_vs_float64": off64,
                    "max": {k: max(v[k] for v in leaves.values())
                            for k in ("route_f64", "plain_f64", "route_own", "plain_own")}}
        print(f"{key}: ReLU decisions route != plain: {flips} (largest such activation "
              f"{worst:.2e} of its layer's largest); != float64: {off64}; per leaf, relative to its largest entry "
              "[route vs float64, plain vs float64, route vs float64 on its own decisions, "
              "plain vs float64 on its own]: "
              + json.dumps({n: [f"{v:.2e}" for v in d.values()] for n, d in leaves.items()}))
        del m, pts, vd, g, route, plain, exact
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
