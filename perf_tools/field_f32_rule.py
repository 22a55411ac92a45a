"""The rule that holds kernel 3's float32 route (split TF32) to its plain
version on a card, each on its own ReLU decisions, and the masked copy of
FlexibleNeRF's forward it rests on. The card tests of kernels 2 and 3
(``tests/test_torch_fused_mlp_tf32.py``, ``tests/test_torch_fused_mlp.py``),
``chip_smoke.py``'s field holds and ``perf_tools/field_f32_relu_flips.py``
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
