"""Active-IR SG shading in the port (``models/sg.py``, ``render/sg_ir.py``,
``run_training(supervision="sg_ir")``, ``apps.train --sg-ir`` and
``apps.eval --sg-ir``) held to the JAX package on the CPU, on the setup of
``tests/test_sg_ir.py`` (2x16 FlexibleNeRF, PE 2/1, 16 + 8 samples, σ-noise
0.1, two 16x16 views at z = 4), shared weights and JAX's draws.

Tolerances (``tests/test_torch_pose_opt.py``'s): values to VALUE_ATOL and
VALUE_RTOL; each input gradient and each gradient leaf to GRAD_RTOL of its
largest entry (float32 sums in another order); losses to LOSS_RTOL; after
three Adam updates the parameters to PARAM_ATOL
(``tests/test_torch_train_step.py``'s); the IR PNGs to
``tests/test_torch_eval.py``'s PNG_LEVELS. A gradient at a clip or max tie
is half the cotangent in both packages (``jnp.clip``, ``jnp.maximum`` and
``torch.maximum`` split it; ``torch.clamp`` would pass it whole), so the
inputs hold exact ties: values at the bounds 0 and 1, a zero normal, dots
of exactly 0 and 1.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dexnerf_tpu_torch.apps import eval as eval_app
from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
from dexnerf_tpu_torch.models import sg
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.render import sg_ir
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings, make_mlp_field
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import (
    SG_KEY,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.step import StepDraws, init_train_state, make_train_step

VALUE_ATOL, VALUE_RTOL = 2e-5, 2e-6
GRAD_RTOL = 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
PNG_LEVELS = 1

ENC_XYZ, ENC_DIR = 2, 1
ARCH = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=ENC_XYZ,
            num_encoding_fn_dir=ENC_DIR)
SETTINGS = dict(num_coarse=16, num_fine=8, perturb=True, radiance_field_noise_std=0.1,
                num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
BATCH, LR = 24, 5e-3


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.render.sg_ir import init_sg_ir_params as j_init_sg

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    key = jax.random.PRNGKey(0)
    params = {
        "coarse": jm.init(key, jnp.ones((1, in_dim))),
        "fine": jm.init(jax.random.fold_in(key, 1), jnp.ones((1, in_dim))),
        "sg": j_init_sg(jax.random.fold_in(key, 7), num_env_lobes=2),
    }
    rng = np.random.RandomState(0)
    images = rng.rand(2, 16, 16, 3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 4.0
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, params=jax.tree.map(np.asarray, params),
                                 images=images, poses=poses, hwf=[16, 16, 20.0])


def sg_params_from_jax(tree, requires_grad: bool = True):
    """JAX's ``init_sg_ir_params`` leaves (as numpy) as the port's SG
    shading leaves, in the port's order."""
    return {k: torch.tensor(np.asarray(tree[k]), dtype=torch.float32).requires_grad_(requires_grad)
            for k in sg_ir.SG_LEAVES}


def _port_models(jx, params=None):
    params = params or jx.params
    models = []
    for name in ("coarse", "fine"):
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(params[name]))
        models.append(m)
    return models


def _draws(jx, key, n, s):
    """The render draws of one key in ``render_rays``' split order."""
    jax, jnp = jx.jax, jx.jnp
    k_strat, k_noise_c, k_fine, k_noise_f = jax.random.split(key, 4)
    c, f, std = s["num_coarse"], s["num_fine"], s["radiance_field_noise_std"]

    def t(x):
        return torch.tensor(np.asarray(x))

    return RenderDraws(
        t_strat=t(jax.random.uniform(k_strat, (n, c), dtype=jnp.float32)),
        noise_coarse=t(std * jax.random.normal(k_noise_c, (n, c), dtype=jnp.float32)),
        u_fine=t(jax.random.uniform(k_fine, (n, f), dtype=jnp.float32)),
        noise_fine=t(std * jax.random.normal(k_noise_f, (n, c + f), dtype=jnp.float32)),
    )


def _step_draws(jx, key, num_rays, s=SETTINGS, batch=BATCH):
    """JAX's train-step draws of ``key``: ``k_sample, k_render = split``."""
    k_sample, k_render = jx.jax.random.split(key)
    idx = jx.jax.random.randint(k_sample, (batch,), 0, num_rays)
    return StepDraws(torch.tensor(np.asarray(idx)).to(torch.int64),
                     _draws(jx, k_render, batch, s))


def _assert_grad(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= GRAD_RTOL * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _compare(jx, name, j_fn, p_fn, inputs, seed=1):
    """Values of ``p_fn`` and ``j_fn`` on the same numpy inputs and their
    vector-Jacobian products with one random cotangent. JAX runs op by op:
    jitted, XLA's fusion reorders the float32 arithmetic, and JAX's jitted
    ``sg_shade(eval_background=True)`` is 1.04e-4 of the largest entry off
    its own op-by-op normal gradient (the port is 2e-7 off the latter)."""
    jax = jx.jax
    shape = jax.eval_shape(j_fn, *inputs).shape
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    want, vjp = jax.vjp(j_fn, *[jx.jnp.asarray(x) for x in inputs])
    want_g = vjp(jx.jnp.asarray(g))
    args = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = p_fn(*args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL, err_msg=name)
    got_g = torch.autograd.grad(got, args, torch.tensor(g), allow_unused=True)
    for k, (a, b) in enumerate(zip(got_g, want_g)):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        _assert_grad(f"{name} input {k}", a, b)


# ---- models/sg.py


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _shade_inputs(seed=0, n=12, lobes=3):
    """sg_shade's inputs with the ties in: rows 0-1 a zero normal (replaced
    by the view direction: dots of exactly 1), row 2 a normal at right
    angles to the view (a dot of exactly 0), row 3 a zero-gradient basecolor
    at 0 and 1 and metallic at exactly 0."""
    rng = np.random.default_rng(seed)
    illum = np.concatenate([np.abs(rng.normal(size=(n, lobes, 3))) * 0.5, _unit(rng, n * lobes)
                            .reshape(n, lobes, 3), rng.uniform(0.3, 40.0, (n, lobes, 1))], -1)
    base = rng.uniform(0.0, 1.0, (n, 3))
    metallic = rng.uniform(0.0, 1.0, (n, 1))
    rough = rng.uniform(0.04, 1.0, (n, 1))
    normal = _unit(rng, n)
    view = _unit(rng, n)
    view[0:3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, -1.0, 0.0]]
    normal[0:2] = 0.0
    # a zero component takes the view's (sg_shade's where is elementwise)
    normal[2] = [1.0, 1.0, 0.0]
    base[3] = [0.0, 1.0, 0.04045]
    metallic[3] = 0.0
    alpha = rng.uniform(-0.2, 1.2, (n,))
    alpha[:2] = [0.0, 1.0]
    return [x.astype(np.float32) for x in (illum, base, metallic, rough, normal, view, alpha)]


def _sg_cases(jsg):
    """name -> (JAX function, port function, inputs)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 1.5, (4, 7)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5, 0.04045]
    v3, w3 = rng.normal(size=(6, 3)).astype(np.float32), rng.normal(size=(6, 3)).astype(np.float32)
    v3[0] = 0.0
    v3[1] = [1e-4, 0.0, 0.0]
    packed = np.concatenate([np.abs(rng.normal(size=(5, 3))), rng.normal(size=(5, 3)),
                             rng.uniform(-1.0, 40.0, (5, 1))], -1).astype(np.float32)
    packed[0, 6] = 0.5
    packed[1, 6] = 30.0
    packed2 = packed[::-1].copy()
    axes = np.concatenate([_unit(rng, 4), [[0.0, 0.0, 1.0]]]).astype(np.float32)
    rough = np.concatenate([rng.uniform(0.0, 1.0, (4, 1)), [[0.0]]]).astype(np.float32)
    views = np.concatenate([_unit(rng, 4), [[0.0, 0.0, 1.0]]]).astype(np.float32)
    a2 = rng.uniform(1e-3, 1.0, (6, 1)).astype(np.float32)
    ndx = np.concatenate([rng.uniform(0.0, 1.0, (4, 1)), [[0.0], [1.0]]]).astype(np.float32)
    sh = _shade_inputs()
    diff_in = [packed, rng.uniform(0.0, 1.0, (5, 3)).astype(np.float32), axes]

    import jax.numpy as jnp

    # an SG result as one [..., 7] tensor
    def cat_j(fn):
        return lambda *a: jnp.concatenate([jnp.broadcast_to(t, (*a[0].shape[:-1], t.shape[-1]))
                                           for t in fn(*a)], -1)

    def cat_p(fn):
        return lambda *a: torch.cat([t.expand(*a[0].shape[:-1], t.shape[-1])
                                     for t in fn(*a)], -1)

    return {
        "saturate": (jsg.saturate, sg.saturate, [x]),
        "saturate_bounds": (lambda t: jsg.saturate(t, 0.04045, 0.5),
                            lambda t: sg.saturate(t, 0.04045, 0.5), [x]),
        "srgb_to_linear": (jsg.srgb_to_linear, sg.srgb_to_linear, [x]),
        "mix": (jsg.mix, sg.mix, [x, x[::-1].copy(), x[:, ::-1].copy()]),
        "dot": (jsg.dot, sg.dot, [v3, w3]),
        "safe_sqrt": (jsg.safe_sqrt, sg.safe_sqrt, [np.concatenate([x, [[1e-7] * 7]])]),
        "safe_exp": (jsg.safe_exp, sg.safe_exp, [np.concatenate([x, [[87.5] * 7]])]),
        "safe_log": (jsg.safe_log, sg.safe_log, [np.abs(x) + 0.1]),
        "magnitude": (jsg.magnitude, sg.magnitude, [v3]),
        "normalize": (jsg.normalize, sg.normalize, [v3]),
        "reflect": (jsg.reflect, sg.reflect, [v3, _unit(rng, 6)]),
        "pack_sg": (jsg.pack_sg, sg.pack_sg, [packed[:, :3], packed[:, 3:6], packed[:, 6:]]),
        "unpack_sg": (cat_j(jsg.unpack_sg), cat_p(sg.unpack_sg), [packed]),
        "unpack_sg_compressed": (cat_j(lambda t: jsg.unpack_sg(t, True, True)),
                                 cat_p(lambda t: sg.unpack_sg(t, True, True)), [packed * 0.1]),
        "sg_evaluate": (lambda p, d: jsg.sg_evaluate(jsg.unpack_sg(p), d),
                        lambda p, d: sg.sg_evaluate(sg.unpack_sg(p), d), [packed, axes]),
        "sg_integral": (lambda p: jsg.sg_integral(jsg.unpack_sg(p)),
                        lambda p: sg.sg_integral(sg.unpack_sg(p)), [packed]),
        "sg_inner_product": (
            lambda p, q: jsg.sg_inner_product(jsg.unpack_sg(p), jsg.unpack_sg(q)),
            lambda p, q: sg.sg_inner_product(sg.unpack_sg(p), sg.unpack_sg(q)), [packed, packed2]),
        "ggx_ndf_sg": (cat_j(jsg.ggx_ndf_sg), cat_p(sg.ggx_ndf_sg), [axes, rough]),
        "sg_warp_distribution": (
            cat_j(lambda n, r, v: jsg.sg_warp_distribution(jsg.ggx_ndf_sg(n, r), v)),
            cat_p(lambda n, r, v: sg.sg_warp_distribution(sg.ggx_ndf_sg(n, r), v)),
            [axes, rough, views]),
        "ggx_smith": (jsg._ggx_smith, sg._ggx_smith, [a2, ndx]),
        "evaluate_diffuse": (lambda p, a, n: jsg.evaluate_diffuse(jsg.unpack_sg(p), a, n),
                             lambda p, a, n: sg.evaluate_diffuse(sg.unpack_sg(p), a, n), diff_in),
        "evaluate_specular": (
            lambda p, f0, r, n, v: _spec(jsg, jsg.unpack_sg(p), f0, r, n, v),
            lambda p, f0, r, n, v: _spec(sg, sg.unpack_sg(p), f0, r, n, v),
            [packed, diff_in[1], rough, axes, views]),
        "sg_shade": (jsg.sg_shade, sg.sg_shade, sh[:6]),
        "sg_shade_background": (
            lambda *a: jsg.sg_shade(*a[:6], a[6], eval_background=True),
            lambda *a: sg.sg_shade(*a[:6], a[6], eval_background=True), sh),
    }


def _spec(m, illum, f0, rough, normal, view):
    """evaluate_specular on the warped NDF of ``normal``, with ``sg_shade``'s
    dots (exact 0 and 1 among them)."""
    warped = m.sg_warp_distribution(m.ggx_ndf_sg(normal, rough), view)
    ndl = m.saturate(m.dot(normal, warped.axis))
    ndv = m.saturate(m.dot(normal, view))
    h = m.normalize(warped.axis + view)
    ldh = m.saturate(m.dot(warped.axis, h))
    return m.evaluate_specular(illum, f0, rough, warped, ndl, ndv, ldh)


SG_CASES = ["saturate", "saturate_bounds", "srgb_to_linear", "mix", "dot", "safe_sqrt", "safe_exp",
            "safe_log", "magnitude", "normalize", "reflect", "pack_sg", "unpack_sg",
            "unpack_sg_compressed", "sg_evaluate", "sg_integral", "sg_inner_product",
            "ggx_ndf_sg", "sg_warp_distribution", "ggx_smith", "evaluate_diffuse",
            "evaluate_specular", "sg_shade", "sg_shade_background"]


@pytest.mark.parametrize("fn", SG_CASES)
def test_sg_functions_match_jax(jx, fn):
    """Each function's values and input gradients on seeded inputs with
    exact ties (clip bounds, a zero vector, dots of 0 and 1)."""
    from dexnerf_tpu.models import sg as jsg

    j_fn, p_fn, inputs = _sg_cases(jsg)[fn]
    _compare(jx, fn, j_fn, p_fn, inputs)


def test_ties_split_the_gradient(jx):
    """The ties are there and their gradients are JAX's halves: the
    saturates at exactly 0 and 1 give 0.5, where ``torch.clamp`` gives 1."""
    from dexnerf_tpu.models import sg as jsg

    x = torch.tensor([0.0, 1.0, 0.5, -1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(sg.saturate(x).sum(), x)
    want = jx.jax.grad(lambda t: jsg.saturate(t).sum())(jx.jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 0.5, 1.0, 0.0, 0.0]
    # sg_shade's zero normals become the view direction: dots of exactly 1
    illum, base, metallic, rough, normal, view, _ = _shade_inputs()
    n = torch.where(torch.tensor(normal) == 0.0, torch.tensor(view), torch.tensor(normal))
    assert float(sg.dot(sg.normalize(n), sg.normalize(torch.tensor(view)))[0]) == 1.0
    assert float(sg.dot(sg.normalize(n), sg.normalize(torch.tensor(view)))[2]) == 0.0


# ---- render/sg_ir.py


def _store(jx):
    return build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")


def _jax_store(jx):
    from dexnerf_tpu.data import build_ray_store as j_build

    return j_build(jx.images, jx.poses, jx.hwf, 2.0, 6.0)


def test_init_sg_ir_params_shapes_and_distributions():
    """JAX's five leaves with their shapes and values: unit axes, amplitudes
    0.05 |N(0, 1)|, sharpness 2, log 8, -2 and 0."""
    p = sg_ir.init_sg_ir_params(torch.Generator().manual_seed(0), num_env_lobes=3)
    assert list(p) == list(sg_ir.SG_LEAVES)
    assert p["illum_env"].shape == (3, 7) and p["active_log_amp"].shape == (3,)
    assert all(p[k].shape == () for k in sg_ir.SG_LEAVES[2:])
    np.testing.assert_allclose(p["illum_env"][:, 3:6].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert (p["illum_env"][:, :3] >= 0).all() and (p["illum_env"][:, 6] == 2.0).all()
    assert float(p["active_log_sharpness"]) == pytest.approx(np.log(8.0))
    assert float(p["metallic_logit"]) == -2.0 and float(p["roughness_logit"]) == 0.0
    big = sg_ir.init_sg_ir_params(torch.Generator().manual_seed(1), num_env_lobes=20000)
    # E|N(0,1)| = sqrt(2/pi)
    assert float(big["illum_env"][:, :3].mean()) == pytest.approx(0.05 * np.sqrt(2 / np.pi),
                                                                  rel=0.02)


def test_field_with_normals_matches_jax(jx):
    """raw and the normals of one forward, and the raw's parameter
    gradients through it, on JAX's test points."""
    from dexnerf_tpu.data.pipeline import sample_ray_batch
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render.renderer import make_mlp_field as j_field
    from dexnerf_tpu.render.sg_ir import _field_with_normals as j_normals

    jax, jnp = jx.jax, jx.jnp
    s = RenderSettings(**SETTINGS)
    rays, _ = sample_ray_batch(_jax_store(jx), jax.random.PRNGKey(6), 8)
    z = jnp.broadcast_to(jnp.linspace(2.0, 6.0, s.num_coarse), (8, s.num_coarse))
    pts = np.asarray(rays.origins[..., None, :] + rays.directions[..., None, :] * z[..., :, None])
    vd = np.asarray(rays.viewdirs)
    g = np.random.default_rng(0).normal(size=(8, s.num_coarse, 4)).astype(np.float32)
    field = j_field(jx.jm.apply, JSettings(**SETTINGS))

    def j_fn(params):
        raw, n = j_normals(field, params, jnp.asarray(pts), jnp.asarray(vd))
        return jnp.sum(raw * g), (raw, n)

    (_, (raw_j, n_j)), grads_j = jax.value_and_grad(j_fn, has_aux=True)(jx.params["coarse"])
    coarse, _ = _port_models(jx)
    raw, n = sg_ir._field_with_normals(make_mlp_field(coarse, s), torch.tensor(pts),
                                       torch.tensor(vd))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(raw_j), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_j), rtol=VALUE_RTOL, atol=VALUE_ATOL)
    assert not n.requires_grad
    norms = n.norm(dim=-1)
    assert bool(((norms - 1).abs() < 1e-5).all()), "unit normals where σ has a gradient"
    (raw * torch.tensor(g)).sum().backward()
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, p in coarse.named_parameters():
        _assert_grad(name, p.grad.numpy(), want[name].numpy())


@pytest.mark.parametrize("falloff", [True, False], ids=["falloff", "flat"])
def test_sg_ir_loss_and_gradients_match_jax(jx, falloff):
    """``make_sg_ir_loss``'s loss, its split and every gradient leaf
    (coarse, fine, sg) on shared weights and JAX's draws."""
    from dexnerf_tpu.data.pipeline import take_ray_batch as j_take
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render.sg_ir import make_sg_ir_loss as j_make

    jax = jx.jax
    store = _store(jx)
    idx = jax.random.randint(jax.random.PRNGKey(3), (BATCH,), 0, store.num_rays)
    key = jax.random.PRNGKey(11)
    j_loss = j_make(jx.jm, jx.jm, JSettings(**SETTINGS), distance_falloff=falloff)
    rays_j, target_j = j_take(_jax_store(jx), idx)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jx.jnp.asarray, jx.params), rays_j, target_j, key)

    coarse, fine = _port_models(jx)
    sgp = sg_params_from_jax(jx.params["sg"])
    loss_fn = sg_ir.make_sg_ir_loss(coarse, fine, sgp, RenderSettings(**SETTINGS),
                                    distance_falloff=falloff)
    rays, target = take_ray_batch(store, torch.tensor(np.asarray(idx)).to(torch.int64))
    loss, metrics = loss_fn(rays, target, _draws(jx, key, BATCH, SETTINGS))
    loss.backward()
    for k in ("loss", "coarse_loss", "fine_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(m_j[k]), rtol=LOSS_RTOL, err_msg=k)
    g_j = jax.tree.map(np.asarray, g_j)
    for name, model in (("coarse", coarse), ("fine", fine)):
        want = state_dict_from_flax(g_j[name])
        for pname, p in model.named_parameters():
            _assert_grad(f"{name}.{pname}", p.grad.numpy(), want[pname].numpy())
    for k, v in sgp.items():
        assert np.any(v.grad.numpy() != 0.0), f"no gradient reaches sg.{k}"
        _assert_grad(f"sg.{k}", v.grad.numpy(), g_j["sg"][k])


def _jax_steps(jx, keys, tx_lr=LR):
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render.sg_ir import make_sg_ir_loss as j_make
    from dexnerf_tpu.train import init_train_state as j_init
    from dexnerf_tpu.train import make_optimizer as j_opt
    from dexnerf_tpu.train import make_train_step as j_step

    js = JSettings(**SETTINGS)
    tx = j_opt(tx_lr)
    state = j_init(jx.jax.tree.map(jx.jnp.asarray, jx.params), tx)
    step = j_step(jx.jm.apply, jx.jm.apply, tx, js, BATCH, fused_loss=j_make(jx.jm, jx.jm, js))
    losses = []
    for k in keys:
        state, m = step(state, _jax_store(jx), k)
        losses.append(float(m["loss"]))
    return jx.jax.tree.map(np.asarray, state.params), losses


def test_three_train_steps_match_jax(jx):
    """Three Adam updates of ``make_train_step(fused_loss=make_sg_ir_loss)``
    with the SG leaves a group of the fields' optimizer: the losses and
    every parameter, sg's included."""
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(5), 3))
    want, want_losses = _jax_steps(jx, keys)
    coarse, fine = _port_models(jx)
    sgp = sg_params_from_jax(jx.params["sg"])
    state = init_train_state(coarse, fine, LR, sg=sgp)
    store = _store(jx)
    step = make_train_step(RenderSettings(**SETTINGS), BATCH, fused_loss=sg_ir.make_sg_ir_loss(
        coarse, fine, sgp, RenderSettings(**SETTINGS)))
    losses = [float(step(state, store, draws=[_step_draws(jx, k, store.num_rays)])["loss"])
              for k in keys]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for name, model in (("coarse", coarse), ("fine", fine)):
        ref = state_dict_from_flax(want[name])
        for pname, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")
    for k, v in sgp.items():
        np.testing.assert_allclose(v.detach().numpy(), want["sg"][k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        assert not np.allclose(v.detach().numpy(), jx.params["sg"][k]), f"sg.{k} did not move"


@pytest.mark.parametrize("block", [16, 32])
def test_render_sg_ir_image_matches_jax(jx, block):
    """The deterministic IR frame (9x7: blocks that do not divide it) at two
    block sizes against JAX's at 32; run inside ``torch.no_grad``, as the
    eval loop does."""
    from dexnerf_tpu.render.sg_ir import render_sg_ir_image as j_render

    s = dict(SETTINGS, perturb=False, radiance_field_noise_std=0.0)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    ro, rd = get_ray_bundle_c2w(9, 7, 10.0, torch.tensor(pose))
    from dexnerf_tpu.render import RenderSettings as JSettings

    want = np.asarray(j_render(jx.jm, jx.jm, jx.jax.tree.map(jx.jnp.asarray, jx.params),
                               jx.jnp.asarray(ro.numpy()), jx.jnp.asarray(rd.numpy()), 2.0, 6.0,
                               JSettings(**s), block_size=32))
    coarse, fine = _port_models(jx)
    with torch.no_grad():
        got = sg_ir.render_sg_ir_image(coarse, fine, sg_params_from_jax(jx.params["sg"], False),
                                       ro, rd, 2.0, 6.0, RenderSettings(**s), block_size=block)
    assert got.shape == (9, 7) and not got.requires_grad
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL, atol=VALUE_ATOL)


# ---- run_training, the CLIs, the checkpoint


def _raw_cfg(logdir, iters=6):
    """``tests/test_sg_ir.py``'s ``run_training`` config."""
    model = {"type": "FlexibleNeRFModel", "num_layers": 2, "hidden_size": 16,
             "num_encoding_fn_xyz": 2, "num_encoding_fn_dir": 1}
    mode = {"num_coarse": 4, "num_fine": 4, "lindisp": False}
    return {
        "experiment": {"id": "sgir-e2e", "logdir": logdir, "randomseed": 42,
                       "train_iters": iters, "validate_every": iters, "save_every": iters,
                       "print_every": 3},
        "dataset": {"near": 2.0, "far": 6.0},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5.0e-3},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True,
                 "train": {**mode, "num_random_rays": 16, "perturb": True,
                           "radiance_field_noise_std": 0.1},
                 "validation": {**mode, "perturb": False, "radiance_field_noise_std": 0.0}},
    }


def _scenes():
    rng = np.random.RandomState(0)
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    kw = dict(images=images, poses=poses, hwf=[16, 16, 20.0], i_train=np.array([0, 1]),
              i_val=np.array([2]))
    from dexnerf_tpu.train import SceneData as JScene

    return ploop.SceneData(**kw), JScene(**kw)


def _run_jax_draws(jx, seed, iters, batch, num_rays, s):
    """The draws of JAX's ``run_training`` steps: ``key, sub = split(key)``
    an iteration from ``PRNGKey(seed)``."""
    key = jx.jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, sub = jx.jax.random.split(key)
        out.append(_step_draws(jx, sub, num_rays, s, batch))
    return out


def _feed_draws(monkeypatch, draws):
    """Make ``run_training``'s steps take ``draws`` (StepDraws), one a step."""
    make_step = ploop.make_train_step
    it = iter(draws)

    def make_with_draws(*a, **k):
        step = make_step(*a, **k)
        return lambda state, store, generator: step(state, store, generator, draws=[next(it)])

    monkeypatch.setattr(ploop, "make_train_step", make_with_draws)


# the logged scalars both packages write
TAGS = ("train/loss", "train/coarse_loss", "train/fine_loss", "train/psnr", "validation/loss",
        "validation/coarse_loss", "validation/fine_loss", "validation/psnr")


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return {(r["tag"], r["step"]): r["value"] for r in map(json.loads, f) if r["tag"] in TAGS}


def _start_ckpt(jx, path):
    """JAX's seeded test weights as a reference ``.ckpt`` (no shading)."""
    coarse, fine = _port_models(jx)
    write_reference_checkpoint(path, coarse.state_dict(), fine.state_dict())


def test_run_training_sg_ir_matches_jax(jx, tmp_path, monkeypatch):
    """``run_training(supervision="sg_ir")`` (``tests/test_sg_ir.py``'s
    run) from one reference ``.ckpt`` (JAX keeps its fresh SG leaves: they
    are carried into the port) on JAX's draws: the logged losses, the
    validation (luminance) and every final parameter; the ``.ckpt`` holds
    the leaves."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.render.sg_ir import init_sg_ir_params as j_init_sg
    from dexnerf_tpu.train import run_training as j_run

    raw = _raw_cfg(str(tmp_path / "logs"))
    ckpt = str(tmp_path / "start.ckpt")
    _start_ckpt(jx, ckpt)
    p_scene, j_scene = _scenes()
    raw_j = json.loads(json.dumps(raw))
    raw_j["experiment"]["id"] = "sgir-jax"
    want = j_run(JCfg(raw_j), supervision="sg_ir", scene=j_scene, load_ckpt=ckpt,
                 use_tensorboard=False)
    jsg = j_init_sg(jx.jax.random.fold_in(jx.jax.random.PRNGKey(42), 7), num_env_lobes=2)
    monkeypatch.setattr(ploop, "init_sg_ir_params",
                        lambda *a, **k: sg_params_from_jax(jx.jax.tree.map(np.asarray, jsg)))
    s = dict(num_coarse=4, num_fine=4, radiance_field_noise_std=0.1)
    _feed_draws(monkeypatch, _run_jax_draws(jx, 42, 6, 16, 2 * 256, s))
    got = ploop.run_training(CfgNode(raw), supervision="sg_ir", scene=p_scene, load_ckpt=ckpt,
                             device="cpu")
    a, b = _records(got["logdir"]), _records(str(tmp_path / "logs" / "sgir-jax"))
    assert set(a) == set(b) and ("validation/psnr", 5) in a
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6, err_msg=str(k))
    params = jx.jax.tree.map(np.asarray, want["state"].params)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(params[name])
        for pname, p in getattr(got["state"], name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")
    for k, v in got["state"].sg.items():
        np.testing.assert_allclose(v.detach().numpy(), params["sg"][k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    ck = read_reference_checkpoint(os.path.join(got["logdir"], "checkpoints",
                                                "checkpoint_0000005.ckpt"))
    assert set(ck[SG_KEY]["params"]) == set(sg_ir.SG_LEAVES) and ck["step"] == 6
    for k, v in got["state"].sg.items():
        assert torch.equal(ck[SG_KEY]["params"][k], v.detach())
        assert int(ck[SG_KEY]["state"][k]["step"]) == 6


def test_checkpoint_round_trip_and_resume(tmp_path, monkeypatch):
    """A run of 4 steps equals 2 steps, a resume from their ``.ckpt`` and 2
    more on the same draws, in every bit (the SG leaves and their Adam
    moments come back); a reference ``.ckpt`` without the key keeps the
    fresh leaves with zero moments at its count (JAX's graft)."""
    from dexnerf_tpu_torch.render.renderer import draw_render_noise
    from dexnerf_tpu_torch.train.checkpoints import (
        load_sg_checkpoint,
        parse_reference_checkpoint,
        reference_checkpoint,
        sg_checkpoint,
    )

    p_scene, _ = _scenes()
    s = RenderSettings(num_coarse=4, num_fine=4, radiance_field_noise_std=0.1,
                       num_encoding_fn_xyz=2, num_encoding_fn_dir=1)
    gen = torch.Generator().manual_seed(0)
    draws = [StepDraws(torch.randint(0, 512, (16,), generator=gen),
                       draw_render_noise(16, s, gen, "cpu")) for _ in range(4)]

    def run(logdir, iters, steps, load=None):
        raw = _raw_cfg(logdir, iters)
        raw["experiment"].update(validate_every=0, save_every=2)
        with monkeypatch.context() as m:
            _feed_draws(m, steps)
            return ploop.run_training(CfgNode(raw), supervision="sg_ir", scene=p_scene,
                                      load_ckpt=load, device="cpu")

    straight = run(str(tmp_path / "a"), 4, draws)
    half = run(str(tmp_path / "b"), 2, draws[:2])
    ck = os.path.join(half["logdir"], "checkpoints", "checkpoint_0000001.ckpt")
    resumed = run(str(tmp_path / "c"), 4, draws[2:], load=ck)
    for k, v in straight["state"].sg.items():
        assert torch.equal(v, resumed["state"].sg[k]), k
        for n in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(straight["state"].optimizer.state[v][n],
                               resumed["state"].optimizer.state[resumed["state"].sg[k]][n])
    for a, b in zip(straight["state"].coarse.parameters(), resumed["state"].coarse.parameters()):
        assert torch.equal(a, b)

    st = straight["state"]
    entry = sg_checkpoint(st.sg, st.optimizer)
    ref = parse_reference_checkpoint(reference_checkpoint(
        st.coarse.state_dict(), st.fine.state_dict(), step=9,
        optimizer_state={"state": {}, "param_groups": [{"params": []}]}))
    fresh = sg_ir.init_sg_ir_params(torch.Generator().manual_seed(0))
    state = init_train_state(*ploop.setup_models(CfgNode(_raw_cfg("x")), 0, "cpu"), LR, sg=fresh)
    before = {k: v.detach().clone() for k, v in fresh.items()}
    assert not load_sg_checkpoint(fresh, state.optimizer, "Adam", ref)
    for k, v in fresh.items():
        assert torch.equal(v.detach(), before[k])
        st_ = state.optimizer.state[v]
        assert float(st_["step"]) == 9.0 and not st_["exp_avg"].any() and not st_["exp_avg_sq"].any()
    assert load_sg_checkpoint(fresh, state.optimizer, "Adam", {SG_KEY: entry})
    for k, v in fresh.items():
        assert torch.equal(v.detach(), st.sg[k].detach())


def _cli_cfg(tmp_path, data):
    raw = _raw_cfg(str(tmp_path / "logs"), iters=2)
    raw["dataset"].update(type="blender", basedir=data, half_res=False, testskip=1)
    raw["experiment"].update(validate_every=1, save_every=1, print_every=1)
    cfg = str(tmp_path / "sgir.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    return raw, cfg


def test_cli_train_and_eval_sg_ir(jx, tmp_path):
    """``apps.train --sg-ir`` then ``apps.eval --sg-ir``, both on the CPU:
    each IR frame a PNG under ``<savedir>/ir`` equal (to PNG_LEVELS) to
    JAX's ``render_sg_ir_image`` cast to gray on the checkpoint's weights;
    a checkpoint without the SG leaves exits both mains with JAX's words."""
    from dexnerf_tpu.apps.eval import main as j_eval
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render.sg_ir import render_sg_ir_image as j_render
    from dexnerf_tpu.utils import cast_to_gray_image as j_gray
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset

    data = str(tmp_path / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(2, 1, 1))
    raw, cfg = _cli_cfg(tmp_path, data)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--sg-ir"]) == 0
    ckpt = str(tmp_path / "logs" / "sgir-e2e" / "checkpoints" / "checkpoint_0000001.ckpt")
    ck = read_reference_checkpoint(ckpt)
    savedir = str(tmp_path / "renders")
    assert eval_app.main(["--config", cfg, "--checkpoint", ckpt, "--savedir", savedir,
                          "--num-poses", "2", "--device", "cpu", "--sg-ir"]) == 0
    assert sorted(os.listdir(os.path.join(savedir, "ir"))) == ["0000.png", "0001.png"]
    scene = ploop.load_scene(CfgNode(raw))
    jnp = jx.jnp
    params = {"coarse": ck["coarse"], "fine": ck["fine"]}
    from dexnerf_tpu.train.checkpoints import _torch_state_dict_to_flax

    jparams = {k: _torch_state_dict_to_flax({n: t.numpy() for n, t in v.items()}, True)
               for k, v in params.items()}
    jparams["sg"] = {k: jnp.asarray(v.numpy()) for k, v in ck[SG_KEY]["params"].items()}
    s = JSettings(**dict(SETTINGS, num_coarse=4, num_fine=4, perturb=False,
                         radiance_field_noise_std=0.0))
    for i in range(2):
        ro, rd = get_ray_bundle_c2w(8, 8, float(scene.hwf[2]),
                                    torch.tensor(scene.render_poses[i][:4, :4], dtype=torch.float32))
        want = j_gray(np.asarray(j_render(jx.jm, jx.jm, jparams, jnp.asarray(ro.numpy()),
                                          jnp.asarray(rd.numpy()), 2.0, 6.0, s))).astype(int)
        got = np.asarray(Image.open(os.path.join(savedir, "ir", f"{i:04d}.png"))).astype(int)
        assert got.shape == (8, 8) and np.abs(got - want).max() <= PNG_LEVELS, i
        assert got.max() > 0
    plain = str(tmp_path / "plain.ckpt")
    write_reference_checkpoint(plain, ck["coarse"], ck["fine"])
    flags = ["--config", cfg, "--checkpoint", plain, "--savedir", str(tmp_path / "r"), "--sg-ir"]
    with pytest.raises(SystemExit) as got_exit:
        eval_app.main([*flags, "--device", "cpu"])
    with pytest.raises(SystemExit) as want_exit:
        j_eval([*flags, "--platform", "cpu"])
    assert str(got_exit.value) == str(want_exit.value)


@pytest.mark.parametrize("case", ["ir", "pose-opt", "depth"])
def test_sg_ir_refusals_match_jax(jx, tmp_path, case):
    """JAX's refusals, word for word: ``--sg-ir`` with ``--ir`` (the CLI),
    with pose refinement and with a depth term (``run_training``)."""
    from dexnerf_tpu.apps.train import main as j_train
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train import run_training as j_run

    raw, cfg = _cli_cfg(tmp_path, str(tmp_path / "missing"))
    p_scene, j_scene = _scenes()
    if case == "ir":
        exc = SystemExit
        got_fn = lambda: train_app.main(["--config", cfg, "--device", "cpu", "--sg-ir",  # noqa: E731
                                         "--ir"])
        want_fn = lambda: j_train(["--config", cfg, "--platform", "cpu", "--sg-ir",  # noqa: E731
                                   "--ir"])
    else:
        exc = NotImplementedError if case == "pose-opt" else ValueError
        kw = dict(pose_opt=True) if case == "pose-opt" else dict(depth_loss_weight=0.1)
        if case == "depth":
            depths = np.full((3, 16, 16), 4.0, np.float32)
            p_scene.depths, j_scene.depths = depths, depths
        got_fn = lambda: ploop.run_training(CfgNode(raw), supervision="sg_ir",  # noqa: E731
                                            scene=p_scene, device="cpu", **kw)
        want_fn = lambda: j_run(JCfg(raw), supervision="sg_ir", scene=j_scene,  # noqa: E731
                                use_tensorboard=False, **kw)
    with pytest.raises(exc) as got:
        got_fn()
    with pytest.raises(exc) as want:
        want_fn()
    assert str(got.value) == str(want.value)
