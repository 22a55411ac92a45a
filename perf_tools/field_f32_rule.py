"""The rule that holds kernel 3's float32 route (split TF32) to its plain
version on a card, each on its own ReLU decisions, and the masked copy of
FlexibleNeRF's forward it rests on; kernel 4's wide f32 route is held the
same way where a leaf misses the 1e-4 rule (``pass_own_decision_ratios``).
Both sum their float64 references over chunks of rays
(``own_decision_ratios``), so a whole training batch can be held. The
card tests of kernels 2-4 (``tests/test_torch_fused_mlp_tf32.py``,
``tests/test_torch_fused_mlp.py``, ``tests/test_torch_train_loss.py``),
``chip_smoke.py``'s holds and ``perf_tools/field_f32_relu_flips.py``
import it from the repository root::

    from perf_tools.field_f32_rule import GPU_GRAD_FACTOR, grads_on_masks
"""

from __future__ import annotations

import copy

import torch

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.ops import fused_mlp_train

# Gradients. The route's activations differ from the plain version's by
# ~1e-6 of their scale (split TF32), so a ReLU whose input lies that close
# to 0 can decide the other way in each of them and in float64; with a
# random cotangent each leaf is a sum of terms of random sign over
# ~1e4-1e5 samples, so one such decision moves it by ~1/sqrt(samples) of
# its largest entry (perf_tools/field_f32_relu_flips.py measures it).
# Here each version is held to the float64 model on its own ReLU
# decisions: the route's error at most GPU_GRAD_FACTOR times the f32 plain
# version's, plus GPU_GRAD_RTOL of the leaf's largest entry (the rule of
# the kernel-4 card tests, tests/test_torch_train_loss.py); and the route's
# decisions differ from the plain version's only where the plain
# activation lies within MASK_RTOL of its layer's largest entry of 0.
# This rule comes beside, not in place of, the card rule of
# tests/test_torch_fused_mlp.py, which holds the route to float64 on
# float64's own decisions.
GPU_GRAD_FACTOR = 10.0
GPU_GRAD_RTOL = 1e-5
MASK_RTOL = 1e-4
# rays a chunk of the float64 references (at 8x256 and 128 samples a ray
# one float64 activation of a chunk is 0.27 GB)
CHUNK_RAYS = 1024


def forward_on_masks(model, pts, viewdirs, masks=None):
    """(raw, acts) of ``model`` at ``pts`` along ``viewdirs``, its ReLUs
    (a_1 .. a_nt, feat, y) replaced by ``masks`` (bool [N, S, width] each)
    when given; ``acts`` are those layers' outputs."""
    xyz = positional_encoding(pts, model.num_encoding_fn_xyz, model.include_input_xyz)
    view = positional_encoding(viewdirs, model.num_encoding_fn_dir, model.include_input_dir)
    view = view[..., None, :].expand(*xyz.shape[:-1], view.shape[-1])
    acts = []

    def act(x):
        x = torch.relu(x) if masks is None else x * masks[len(acts)]
        acts.append(x)
        return x

    h = model.layer1(xyz)
    for i, layer in enumerate(model.layers_xyz):
        h = act(layer(torch.cat([h, xyz], -1) if i in model.skips else h))
    feat = act(model.fc_feat(h))
    y = act(model.layers_dir[0](torch.cat([feat, view], -1)))
    return torch.cat([model.fc_rgb(y), model.fc_alpha(h)], -1), acts


def grads_on_masks(model, pts, viewdirs, g, masks):
    """The float64 gradient of sum(g raw) with the ReLU decisions
    ``masks``."""
    m64 = copy.deepcopy(model).double()
    with torch.enable_grad():
        raw, _ = forward_on_masks(m64, pts.double(), viewdirs.double(), masks)
        return torch.autograd.grad(raw, list(m64.parameters()), g.double())


def pass_grads_on_masks(model, pts, z, dists, viewdirs, noise, target, masks, *,
                        white_background=False, supervision="rgb", depth_gt=None,
                        depth_coef=None):
    """The float64 gradient of kernel 4's pass loss (compositing, the
    squared error and the depth term of ``fused_pass_loss_reference``) at
    the sample points ``pts`` with the ReLU decisions ``masks`` (None: the
    float64 model's own)."""
    from dexnerf_tpu_torch.core.volrend import composite
    from dexnerf_tpu_torch.ops.fused_train_loss import pass_loss_sum

    m64 = copy.deepcopy(model).double()

    def f64(t):
        return None if t is None else t.double()

    with torch.enable_grad():
        raw, _ = forward_on_masks(m64, pts.double(), viewdirs.double(), masks)
        out = composite(raw, f64(z), f64(dists), white_background=white_background,
                        sigma_noise=f64(noise))
        loss = pass_loss_sum(out.rgb, f64(target), supervision)
        if depth_gt is not None:
            loss = loss + torch.sum(f64(depth_coef) * (out.depth - f64(depth_gt)) ** 2)
        return torch.autograd.grad(loss, list(m64.parameters()))


def own_decision_ratios(model, pts, viewdirs, grads, plain, exact, names=None,
                        chunk_rays=CHUNK_RAYS):
    """Leaves of ``grads`` (the route's) and ``plain`` (the plain f32
    version's), both of one loss that sums over rays, by the own-decision
    rule above. ``exact(sl, masks)`` is the float64 gradient of that loss
    over the rays ``sl`` with the ReLU decisions ``masks``; it is summed
    over chunks of ``chunk_rays`` rays, and the activations are compared
    chunk by chunk, so a batch of any size is held in bounded memory.
    ``names`` (default: every leaf) picks the leaves held. Returns
    ({leaf: its float64 error on the route's decisions over its limit},
    the number of ReLU decisions the route takes otherwise than the plain
    version, the layers with such a decision further than MASK_RTOL of the
    layer's largest entry from 0)."""
    n = pts.shape[0]
    gap, amax, flips, on_route, on_plain = None, None, 0, None, None
    for r0 in range(0, n, chunk_rays):
        sl = slice(r0, min(n, r0 + chunk_rays))
        p, v = pts[sl].contiguous(), viewdirs[sl].contiguous()
        with torch.no_grad():
            route = route_activations(model, p, v, torch.zeros(p.shape[:2] + (4,),
                                                               device=p.device))
            plain_acts = forward_on_masks(model, p, v)[1]
        if gap is None:
            gap, amax = [0.0] * len(route), [0.0] * len(route)
        for i, (ar, ap) in enumerate(zip(route, plain_acts)):
            flip = (ar > 0) != (ap > 0)
            flips += int(flip.sum())
            if bool(flip.any()):
                gap[i] = max(gap[i], float((ar - ap)[flip].abs().max()))
            amax[i] = max(amax[i], float(ap.abs().max()))
        er = exact(sl, [a > 0 for a in route])
        ep = exact(sl, [a > 0 for a in plain_acts])
        del route, plain_acts
        on_route = er if on_route is None else [a + b for a, b in zip(on_route, er)]
        on_plain = ep if on_plain is None else [a + b for a, b in zip(on_plain, ep)]
    ratios = {}
    for (name, _), gk, gp, ek, ep in zip(model.named_parameters(), grads, plain, on_route,
                                         on_plain):
        if names is not None and name not in names:
            continue
        e_k = float((gk.double() - ek).abs().max())
        e_p = float((gp.double() - ep).abs().max())
        limit = GPU_GRAD_FACTOR * e_p + GPU_GRAD_RTOL * float(ek.abs().max())
        ratios[name] = e_k / limit if limit > 0 else (float("inf") if e_k > 0 else 0.0)
    bad = [i for i, (a, b) in enumerate(zip(gap, amax)) if a > MASK_RTOL * b]
    return ratios, flips, bad


def pass_own_decision_ratios(model, args, grads, plain, names=None, *, norm=1.0,
                             white_background=False, supervision="rgb",
                             chunk_rays=CHUNK_RAYS):
    """:func:`own_decision_ratios` of kernel 4's pass loss over ``norm``:
    ``args`` are the pass's (origins, directions, z, viewdirs, dists, noise,
    target[, depth_gt, depth_coef]) as ``fused_pass_loss`` takes them, and
    ``grads`` / ``plain`` the route's and the plain version's gradients of
    that loss over ``norm``. The route's activations are kernel 3's forward
    on the same points (the same arithmetic as kernel 4's)."""
    o, d, z, v, dz, noise, target, *depth = args
    depth_gt, depth_coef = (depth + [None, None])[:2]
    pts = o[:, None] + d[:, None] * z[..., None]

    def cut(t, sl):
        return None if t is None else t[sl]

    def exact(sl, masks):
        g = pass_grads_on_masks(model, pts[sl], z[sl], dz[sl], v[sl], cut(noise, sl),
                                target[sl], masks, white_background=white_background,
                                supervision=supervision, depth_gt=cut(depth_gt, sl),
                                depth_coef=cut(depth_coef, sl))
        return [t / norm for t in g]

    return own_decision_ratios(model, pts, v, grads, plain, exact, names, chunk_rays)


def route_activations(model, pts, viewdirs, g):
    """The activations a_1 .. a_nt, feat and y [N, S, width] that kernel 3's
    f32 route saves to its scratch, chunk by chunk."""
    from dexnerf_tpu_torch.ops._build import load_library

    wg, ps = fused_mlp_train.tf32_backward_pass(load_library(), model, pts, viewdirs, g,
                                                log_sampling_xyz=True, log_sampling_dir=True)
    R, H, S = wg.rows, model.hidden_size, pts.shape[1]
    blocks = [(R["a"][i], H) for i in range(1, model.num_layers)]
    blocks += [(R["feat"], H), (R["y"], H // 2)]
    out = [[] for _ in blocks]
    stream = torch.cuda.current_stream().cuda_stream
    for c in range(wg.n_chunks):
        rays = ps.run(c, stream)
        k = rays * ps.s_pad
        act = wg.act[:R["act_rows"] * k].view(R["act_rows"], k)
        for o, (r0, w) in zip(out, blocks):
            o.append(act[r0:r0 + w].reshape(w, rays, ps.s_pad)[..., :S].permute(1, 2, 0).clone())
    return [torch.cat(o) for o in out]
