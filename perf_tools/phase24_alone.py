#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 24 alone (the host-streamed ray store:
``apps.train`` with ``dataset.host_store`` on both wires on a written 40-view
800x800 lego scene, the three steps on the same draws, the timings at 8192
and 65536 rays, the depth term, the field path and NDC on the packed wire),
for iterating on that phase without the others: it writes its own scenes.

    python3 perf_tools/phase24_alone.py

From the repository root, on a machine with an NVIDIA Hopper card. Prints
the card's name and power limit, the kernels' build time, phase 24's own
lines, its wall time and its kernels-line entries; exits non-zero if a
check fails.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dexnerf_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase24_alone: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        entries = cs.host_store_phase(torch, np, card, dev, tmp)
        print(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(entries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
