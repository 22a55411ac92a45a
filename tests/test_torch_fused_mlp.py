"""The field kernels of the port: ``ops/fused_mlp.py`` (kernel 2, the field
forward) and ``ops/fused_mlp_train.py`` (kernel 3, the field backward).

On the CPU: the plain versions held to the JAX package's
``make_fused_flexible_field`` and ``make_fused_flexible_field_train``
(``compute_dtype=float32``, interpret mode) on one set of weights and
inputs, and the zero-input-cotangent contract. On a CUDA card (marker
``gpu``): the CUDA kernels held to the plain versions, and two runs of
kernel 3 bitwise equal. The JAX package is imported inside a fixture, so
that this file also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_mlp.py
"""

import copy
import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
from dexnerf_tpu_torch.ops.fused_render import MAX_HIDDEN
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

ENC_XYZ, ENC_DIR = 3, 2
ARCH = dict(num_layers=4, hidden_size=16, skip_connect_every=2,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
# f32 on both sides, the sums in another order: raw to 1e-5; the loss to
# 1e-5 relative and every gradient leaf to 5e-5 (the JAX test's own limit,
# tests/test_ops.py::test_fused_train_field_grad_parity)
RAW_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL = 5e-5


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tgt = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd, tgt


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.ones((1, in_dim))))
    model = FlexibleNeRFModel(**ARCH)
    model.load_state_dict(state_dict_from_flax(tree))
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, tree=tree, model=model)


# (rays, samples): 5 x 6 pads to 8 rays a block in JAX (block_samples 16)
@pytest.mark.parametrize("n,s", [(4, 6), (5, 6), (3, 16)])
def test_field_matches_jax(jx, n, s):
    from dexnerf_tpu.ops import make_fused_flexible_field as j_make

    pts, vd, _ = _inputs(n, s, seed=n + s)
    j_field = j_make(jx.jm, block_samples=16, compute_dtype=jx.jnp.float32, interpret=True)
    want = np.asarray(j_field(jx.tree, jx.jnp.asarray(pts), jx.jnp.asarray(vd)))
    launches = fused_mlp.launches
    got = fused_mlp.make_fused_flexible_field(jx.model)(torch.tensor(pts), torch.tensor(vd))
    assert fused_mlp.launches == launches  # CPU tensors never reach the kernel
    assert got.shape == (n, s, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RAW_ATOL)


@pytest.mark.parametrize("n,s", [(4, 6), (5, 6)])
def test_train_field_grads_match_jax(jx, n, s):
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_make

    pts, vd, tgt = _inputs(n, s, seed=10 + n)
    j_field = j_make(jx.jm, block_samples=16, compute_dtype=jx.jnp.float32, interpret=True)
    jp, jv, jt = (jx.jnp.asarray(a) for a in (pts, vd, tgt))
    j_loss, j_grads = jx.jax.value_and_grad(
        lambda params: jx.jnp.mean((j_field(params, jp, jv) - jt) ** 2))(jx.tree)
    want = state_dict_from_flax(jx.jax.tree.map(np.asarray, j_grads))

    model = copy.deepcopy(jx.model)
    field = fused_mlp_train.make_fused_flexible_field_train(model)
    launches = fused_mlp_train.launches
    loss = torch.mean((field(torch.tensor(pts), torch.tensor(vd)) - torch.tensor(tgt)) ** 2)
    loss.backward()
    assert fused_mlp_train.launches == launches
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def test_train_field_gives_inputs_no_cotangent():
    """The zero-input-cotangent contract: points and viewdirs that require
    a gradient get none; the parameters get autograd's."""
    model = FlexibleNeRFModel(**ARCH).reset_parameters(torch.Generator().manual_seed(1))
    pts, vd, tgt = (torch.tensor(a) for a in _inputs(3, 5, seed=2))
    pts.requires_grad_(True)
    vd.requires_grad_(True)
    raw = fused_mlp_train.fused_field_train(model, pts, vd)
    torch.sum(raw * tgt).backward()
    assert pts.grad is None and vd.grad is None
    want = torch.autograd.grad(
        torch.sum(fused_mlp.fused_field_reference(model, pts.detach(), vd.detach()) * tgt),
        list(model.parameters()))
    for p, g in zip(model.parameters(), want):
        torch.testing.assert_close(p.grad, g, rtol=1e-6, atol=1e-7)


# ---- on the card: the CUDA kernels vs their plain versions

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
# raw to the render kernel's rtol/atol (split TF32 vs cuBLAS SGEMM, TF32 off).
# Gradients: each leaf held to the float64 plain version on float64's own
# ReLU decisions, within GPU_GRAD_FACTOR times the f32 plain version's own
# error plus GPU_GRAD_RTOL of the leaf's largest entry (the rule of the
# kernel-4 card tests, tests/test_torch_train_loss.py), plus one term: the
# float64 distance between the float64 gradients on the route's ReLU
# decisions and on float64's. A random cotangent makes each leaf a sum of
# random-sign terms, so one ReLU within rounding of 0 that an f32 sum
# decides otherwise than float64 moves it by ~1/sqrt(samples) of its
# largest entry; cuBLAS and the route each decide a few such ReLUs, not the
# same ones, so the old limit alone rested on which entries each happened
# to flip (perf_tools/field_f32_relu_flips.py). Every decision the route
# makes otherwise than float64 must lie within MASK_RTOL of its layer's
# largest activation of 0 (perf_tools/field_f32_rule.py).
GPU_RTOL, GPU_ATOL = 1e-4, 1e-5
GPU_GRAD_FACTOR = 10.0
GPU_GRAD_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, arch, n, s, seed=9):
    m = FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed)).to(cuda)
    pts, vd, g = (torch.tensor(a, device=cuda) for a in _inputs(n, s, seed))
    return m, pts * 2.0, vd, g


def _assert_grads_on_card(model, pts, vd, g, kernel_grads):
    """The rule above; prints, for each leaf past the old limit, its error,
    the old limit, the flip term and the new limit."""
    from perf_tools.field_f32_rule import (
        MASK_RTOL,
        forward_on_masks,
        grads_on_masks,
        route_activations,
    )

    plain = fused_mlp_train.field_grads_reference(model, pts, vd, g)
    m64 = copy.deepcopy(model).double()
    exact = fused_mlp_train.field_grads_reference(m64, pts.double(), vd.double(), g.double())
    with torch.no_grad():
        acts64 = forward_on_masks(m64, pts.double(), vd.double())[1]
        route_acts = route_activations(model, pts, vd, g)
    for i, (ar, a64) in enumerate(zip(route_acts, acts64)):
        flip = (ar > 0) != (a64 > 0)
        assert bool(((ar.double() - a64)[flip].abs() <= MASK_RTOL * a64.abs().max()).all()), i
    on_route = grads_on_masks(model, pts, vd, g, [a > 0 for a in route_acts])
    on_f64 = grads_on_masks(model, pts, vd, g, [a > 0 for a in acts64])
    worst = (0.0, "")
    for (name, _), gk, gp, ge, er, e64 in zip(model.named_parameters(), kernel_grads, plain,
                                              exact, on_route, on_f64):
        scale = float(ge.abs().max())
        err = float((gk.double() - ge).abs().max())
        err_plain = float((gp.double() - ge).abs().max())
        old = GPU_GRAD_FACTOR * err_plain + GPU_GRAD_RTOL * scale
        flip_term = float((er - e64).abs().max())
        assert bool(torch.isfinite(gk).all()), name
        if err > old:
            print(f"  {name}: error {err:.4e}, old limit {old:.4e}, flip term "
                  f"{flip_term:.4e}, new limit {old + flip_term:.4e}")
        worst = max(worst, (err / (old + flip_term), name))
        assert err <= old + flip_term, (name, err, old, flip_term)
    print(f"  worst leaf {worst[1]}: error / new limit {worst[0]:.3f}; ReLU decisions "
          f"otherwise than float64: {sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(route_acts, acts64))}")


# (arch, rays, samples a ray): the narrow route at 4x16 and 8x128, and the
# f32 route's wide kernels (padded widths above 128: 136, 256, MAX_HIDDEN),
# each launch of those counted by ``launches_wide_f32``
CARD_CASES = [(a, 300, s) for a in ("4x16", "8x128") for s in (64, 100, 128)]
CARD_CASES += [(f"8x{h}", 64, 100) for h in (136, 256, MAX_HIDDEN)]
CARD_ARCHS = {"4x16": ARCH, "8x128": FULL,
              **{f"8x{h}": dict(FULL, hidden_size=h) for h in (136, 256, MAX_HIDDEN)}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n,s", CARD_CASES, ids=[f"{a}-{s}" for a, _, s in CARD_CASES])
def test_kernels_match_plain_on_card(cuda, arch, n, s):
    m, pts, vd, g = _card_case(cuda, CARD_ARCHS[arch], n, s)
    wide = int(m.hidden_size > 128)
    before = (fused_mlp.launches, fused_mlp_train.launches, fused_mlp.launches_wide_f32,
              fused_mlp_train.launches_wide_f32, fused_mlp.launches_bf16)
    raw = fused_mlp_train.fused_field_train(m, pts, vd)
    raw.backward(g)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp_train.launches, fused_mlp.launches_wide_f32,
            fused_mlp_train.launches_wide_f32, fused_mlp.launches_bf16) == (
        before[0] + 1, before[1] + 1, before[2] + wide, before[3] + wide, before[4])
    want = fused_mlp.fused_field_reference(m, pts, vd).detach()
    torch.testing.assert_close(raw.detach(), want, rtol=GPU_RTOL, atol=GPU_ATOL)
    torch.testing.assert_close(fused_mlp.fused_field(m, pts, vd), want, rtol=GPU_RTOL,
                               atol=GPU_ATOL)
    _assert_grads_on_card(m, pts, vd, g, [p.grad for p in m.parameters()])


@pytest.mark.gpu
def test_backward_chunks_and_repeats_on_card(cuda, monkeypatch):
    """Several scratch chunks (the last one short) give the same gradients
    as one chunk, within the card rule; two runs are bitwise equal."""
    m, pts, vd, g = _card_case(cuda, FULL, 301, 100)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    one = fused_mlp_train._launch_backward(m, pts, vd, g, **kw)
    one = [t.clone() for t in one]
    again = fused_mlp_train._launch_backward(m, pts, vd, g, **kw)
    monkeypatch.setattr(fused_mlp_train, "SCRATCH_SAMPLES", 128 * 40)
    chunked = [t.clone() for t in fused_mlp_train._launch_backward(m, pts, vd, g, **kw)]
    torch.cuda.synchronize()
    for a, b in zip(one, again):
        assert torch.equal(a, b)
    _assert_grads_on_card(m, pts, vd, g, one)
    _assert_grads_on_card(m, pts, vd, g, chunked)
