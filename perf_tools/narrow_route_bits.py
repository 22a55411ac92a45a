#!/usr/bin/env python3
"""The narrow routes (padded widths up to 128) of kernels 1-4 at bf16 and
f32, saved or compared bit for bit against another checkout's: a change
to the wide routes' shared sources must leave them as they were.

    python3 perf_tools/narrow_route_bits.py --save FILE      # in one checkout
    python3 perf_tools/narrow_route_bits.py --compare FILE   # in the other

From the repository root, on a machine with a CUDA card. FlexibleNeRF 8
layers, skip 3, PE 10/4 at widths 64, 100 and 128 (seeded weights, a σ
bias of 1), 1024 rays x 64 samples: kernel 4's loss, weights, rgb and
gradient leaves; kernel 1's frame outputs; kernel 2's raw; kernel 3's raw
and leaves on a random cotangent. ``--compare`` prints the groups that
differ (none when the two checkouts agree bit for bit) and exits non-zero
if one does.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flat(x):
    import torch

    if torch.is_tensor(x):
        return [x.detach().clone()]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flat(y)]
    return []


def outputs():
    import torch

    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    dev, out = torch.device("cuda"), {}
    for hid in (64, 100, 128):
        m = FlexibleNeRFModel(num_layers=8, hidden_size=hid, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
        m = m.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
        with torch.no_grad():
            m.fc_alpha.bias.fill_(1.0)
        g = torch.Generator(device=dev).manual_seed(1)
        n, s = 1024, 64
        o = 0.2 * torch.randn(n, 3, device=dev, generator=g)
        d = torch.randn(n, 3, device=dev, generator=g)
        v = d / d.norm(dim=-1, keepdim=True)
        z = torch.sort(2 + 4 * torch.rand(n, s, device=dev, generator=g), -1).values.contiguous()
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        target = torch.rand(n, 3, device=dev, generator=g)
        pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
        cot = 1e-2 * torch.randn(n, s, 4, device=dev, generator=g)
        for dt in (torch.bfloat16, torch.float32):
            m.zero_grad(set_to_none=True)
            loss, w, rgb = ftl.fused_pass_loss(m, o, d, z, v, dists.contiguous(), None, target,
                                               compute_dtype=dt, dw_dtype=dt)
            loss.backward()
            out[f"k4 {hid} {dt}"] = flat([loss, w, rgb]) + [p.grad.clone() for p in m.parameters()]
            with torch.no_grad():
                out[f"k1 {hid} {dt}"] = flat(fr.fused_render(
                    m, o, d, v, z, ray_dists(z, d).contiguous(), compute_dtype=dt))
                out[f"k2 {hid} {dt}"] = flat(fused_mlp.fused_field(m, pts, v, compute_dtype=dt))
            m.zero_grad(set_to_none=True)
            raw = fused_mlp_train.fused_field_train(m, pts, v, compute_dtype=dt, dw_dtype=dt)
            raw.backward(cot)
            out[f"k3 {hid} {dt}"] = flat(raw) + [p.grad.clone() for p in m.parameters()]
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--save", metavar="FILE")
    group.add_argument("--compare", metavar="FILE")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("narrow_route_bits: no CUDA card visible to PyTorch")
    out = outputs()
    if opts.save:
        torch.save(out, opts.save)
        print(f"saved {len(out)} groups, {sum(len(x) for x in out.values())} tensors")
        return 0
    other = torch.load(opts.compare)
    bad = [k for k in out if len(out[k]) != len(other[k])
           or not all(torch.equal(x, y) for x, y in zip(out[k], other[k]))]
    print(f"{len(out)} groups, {sum(len(x) for x in out.values())} tensors; bitwise equal "
          f"except: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
