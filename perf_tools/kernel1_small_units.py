#!/usr/bin/env python3
"""Kernel 1's f32 routes with many rays a unit (S = 8: 16 rays, S = 16: 8)
under a steep σ logit, narrow beside wide, held by the card rules of
``tests/test_torch_fused_render.py``:

- ``narrow-128``: the narrow route (``mlp_tile_tf32.cuh``) at width 128;
- ``wide-200``: the wide route (``mlp_wide_tf32.cuh``) at width 200, the
  width of ``test_wide_kernel_small_units_on_card``;
- ``wide-128-in-200``: the ``narrow-128`` model zero-padded to width 200,
  through the wide route on the same rays: the same function as
  ``narrow-128``, so the two routes' errors compare entry for entry.

Each at the σ logit spread 30 of the S = 64 cases (thresholds 5 and 10)
and at 30 S / 64 (thresholds 5 S / 64 and 10 S / 64). For each field it
prints the entries past the plain rule (|kernel - plain| > 1e-5 + 1e-4
|plain|) and the largest such excess, the kernel's and the plain f32
version's largest distance to a float64 run, the entries where the plain
version itself lies over half the tolerance from float64, the entries where
the kernel is further from float64 than the plain version + the tolerance,
and the share of Dex depths equal to the plain version's.

    python3 perf_tools/kernel1_small_units.py

From the repository root, on a machine with an NVIDIA Hopper card; ~1 min
after the build. One JSON line a case, then the card's name and power limit.
"""

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dexnerf_tpu_torch.core.encoding import positional_encoding  # noqa: E402
from dexnerf_tpu_torch.core.sampling import stratified_z_vals  # noqa: E402
from dexnerf_tpu_torch.core.volrend import ray_dists  # noqa: E402
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel  # noqa: E402
from dexnerf_tpu_torch.ops import fused_render as fr  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # the card rule, kernel vs plain
FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
FIELDS = ("rgb", "disparity", "accumulation", "depth", "weights")


def rays(n=300, seed=9):
    """The card tests' rays (``tests/test_torch_fused_render.py::_rays``)."""
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((n,), 2.0, np.float32)
    return ro, rd, vd, near, near + 4.0


def scaled(m, ro, rd, vd, z, spread):
    """``m`` with its σ logit over these samples at mean 0, std ``spread``."""
    with torch.no_grad():
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = m(positional_encoding(pts, m.num_encoding_fn_xyz),
                positional_encoding(vd, m.num_encoding_fn_dir))[..., 3]
        k = spread / raw.std()
        m.fc_alpha.weight.mul_(k)
        m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
    return m


def embedded(m, width):
    """``m`` zero-padded to ``width`` hidden units (``width // 2`` in the
    view layer): the same function, every added weight and bias 0."""
    w = FlexibleNeRFModel(num_layers=m.num_layers, hidden_size=width,
                          skip_connect_every=m.skip_connect_every,
                          num_encoding_fn_xyz=m.num_encoding_fn_xyz,
                          num_encoding_fn_dir=m.num_encoding_fn_dir,
                          include_input_xyz=m.include_input_xyz,
                          include_input_dir=m.include_input_dir).to(m.fc_alpha.weight.device)
    H = m.hidden_size
    with torch.no_grad():
        for (name, p), (_, q) in zip(m.named_parameters(), w.named_parameters()):
            q.zero_()
            if p.dim() == 1:
                q[:p.shape[0]] = p
                continue
            n_in = p.shape[1]
            if n_in in (H, H // 2) or name.startswith("layer1"):
                q[:p.shape[0], :n_in] = p
            else:  # (h, encoding): a skip layer's or the view layer's input
                q[:p.shape[0], :H] = p[:, :H]
                q[:p.shape[0], width:width + n_in - H] = p[:, H:]
    return w


def hold(got, plain, exact, z):
    out = {}
    for f in FIELDS:
        g, p, e = (getattr(x, f).double() for x in (got, plain, exact))
        tol = ATOL + RTOL * p.abs()
        past = (g - p).abs() > tol
        te = ATOL + RTOL * e.abs()
        loose = (p - e).abs() > te / 2
        out[f] = {"past_plain_rule": int(past.sum()),
                  "worst_over_tol": float(((g - p).abs() / tol).max()),
                  "kernel_to_f64": float((g - e).abs().max()),
                  "plain_to_f64": float((p - e).abs().max()),
                  "plain_over_half_tol_from_f64": int(loose.sum()),
                  "kernel_past_plain_plus_tol_from_f64":
                      int(((g - e).abs() > (p - e).abs() + te).sum()),
                  "entries": g.numel()}
    out["dex_equal"] = float((got.depth_dex == plain.depth_dex).float().mean())
    out["dex_hit"] = float((got.depth_dex != z[None, :, 0]).float().mean())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel1_small_units: no CUDA card visible to PyTorch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ro, rd, vd, near, far = (torch.tensor(a, device=dev) for a in rays())
    for S in (8, 16):
        z = stratified_z_vals(near, far, S)
        dists = ray_dists(z, rd)
        for label, spread, thr in (("spread 30", 30.0, (5.0, 10.0)),
                                   ("spread 30 S/64", 30.0 * S / 64,
                                    (5.0 * S / 64, 10.0 * S / 64))):
            narrow = scaled(FlexibleNeRFModel(**FULL).reset_parameters(
                torch.Generator().manual_seed(0)).to(dev), ro, rd, vd, z, spread)
            wide = scaled(FlexibleNeRFModel(**dict(FULL, hidden_size=200)).reset_parameters(
                torch.Generator().manual_seed(0)).to(dev), ro, rd, vd, z, spread)
            outs = {}
            for name, m in (("narrow-128", narrow), ("wide-200", wide),
                            ("wide-128-in-200", embedded(narrow, 200))):
                w0 = fr.launches_wide_f32
                with torch.inference_mode():
                    got = fr.fused_render(m, ro, rd, vd, z, dists, thresholds=thr)
                    plain = fr.fused_render_reference(m, ro, rd, vd, z, dists, thresholds=thr)
                    exact = fr.fused_render_reference(
                        copy.deepcopy(m).double(),
                        *(t.double() for t in (ro, rd, vd, z, dists)), thresholds=thr)
                torch.cuda.synchronize()
                res = hold(got, plain, exact, z)
                res["route"] = "wide" if fr.launches_wide_f32 > w0 else "narrow"
                outs[name] = got
                print(json.dumps({"case": name, "S": S, "sigma": label, **res}))
            a, b = outs["narrow-128"], outs["wide-128-in-200"]
            print(json.dumps({"case": "wide-128-in-200 vs narrow-128", "S": S, "sigma": label,
                              **{f: float((getattr(b, f) - getattr(a, f)).abs().max())
                                 for f in FIELDS}}))
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
