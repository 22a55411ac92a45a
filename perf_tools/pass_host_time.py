#!/usr/bin/env python3
"""Host time of kernel 4's bf16 passes on one NVIDIA Hopper card: what one
call of ``ops.fused_train_loss.fused_pass_loss`` costs the host to enqueue,
and what a pass costs with the card's work included.

    python3 /path/to/perf_tools/pass_host_time.py

From the root of the checkout to measure: the package is imported from the
working directory, so one call can time two checkouts in turns (a parent
commit unpacked beside this one, then this one). The flagship config's
passes (batch 8192, S = 64 and 128, 8x128 skip 3, PE 10/4, seeded random
weights and inputs), each after 3 warm calls: the enqueue as the host clock
around a call that starts on an idle card (median of 20), and the pass as
the host clock around 20 calls and one synchronize, over 20. Prints the
card line (nvidia-smi) and, as the last line, one JSON object. Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pass_host_time: no CUDA card visible to PyTorch")
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 8192

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    o, d = tensor(rng.normal(size=(n, 3)) * 0.2), tensor(rng.normal(size=(n, 3)))
    v = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    target = tensor(rng.uniform(size=(n, 3)))
    out = {}
    for s in (64, 128):
        m = FlexibleNeRFModel(num_layers=8, hidden_size=128, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(s)).to(dev)
        z = torch.sort(tensor(2 + 4 * rng.uniform(size=(n, s))), dim=-1).values.contiguous()
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        args = (m, o, d, z, v, dists.contiguous(), tensor(rng.normal(size=(n, s)) * 0.2), target)

        def call():
            ftl.fused_pass_loss(*args, compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)

        with torch.no_grad():
            for _ in range(3):
                call()
            enqueue = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            whole = (time.perf_counter() - t0) / 20
        out[f"S{s}"] = {"enqueue_ms": round(1e3 * sorted(enqueue)[10], 4),
                        "pass_ms": round(1e3 * whole, 4)}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
