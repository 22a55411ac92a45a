#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone (active-IR SG shading and data-
parallel training), on freshly written copies of the scenes of its phases 6
and 14 and phase 6's ``apps.train`` run (its checkpoint is what the rank
steps start from), for iterating on that phase without the others.

    python3 perf_tools/phase20_alone.py

From the repository root, on a machine with an NVIDIA Hopper card. Prints
the card's name, the kernels' build time, phase 20's own lines, its wall
time and its kernels-line entries; exits non-zero if a check fails.
"""

import json
import os
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dexnerf_tpu_torch.data.synthetic import (  # noqa: E402
    write_blender_dataset,
    write_messytable_dataset,
)
from dexnerf_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase20_alone: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "scene")
        write_blender_dataset(data, cs.TRAIN_HW, cs.TRAIN_HW, cs.TRAIN_VIEWS, device=dev)
        write_messytable_dataset(os.path.join(tmp, "messytable"), *cs.DEX_STORED_HW,
                                 cs.DEX_VIEWS, device=dev)
        cfg_path, logdir, *_ = cs.train_cli(tmp, data, "lego", cs.TRAIN_ITERS, torch, dev)
        shared = types.SimpleNamespace(data=data, cfg_path=cfg_path, logdir=logdir)
        t0 = time.perf_counter()
        entries = cs.sgir_parallel_phase(torch, np, card, dev, tmp, shared)
        print(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(entries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
