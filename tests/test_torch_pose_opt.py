"""SE(3) camera pose refinement in the port (``core/lie.py``,
``train/pose_opt.py``, ``make_train_step(ray_source=)``,
``run_training(pose_opt=)``, ``apps.train --pose-opt`` and ``apps.eval
--refined-poses``) held to the JAX package on the CPU, and the JAX suite's
pose-recovery check (``tests/test_pose_opt.py``) on the port.

Tolerances: the Lie maps' values to VALUE_ATOL (and VALUE_RTOL of values
~50 after the NDC projection) and each gradient to
GRAD_RTOL of its largest entry (float32 sums in another order; JAX's
matmuls at HIGHEST, the port's as elementwise sums); the pose store's rows
and the refined rays to RAY_ATOL, their gradients with respect to the
twists to GRAD_RTOL of the largest entry; the base c2w of a w2c scene to
RAY_ATOL (the port inverts in float64, JAX in float32); in
``run_training`` the logged losses and twist norms to LOSS_RTOL, the
parameters and twists to PARAM_ATOL (``tests/test_torch_train_step.py``'s);
a resumed port run equal to the straight run in every bit; the refined
frames' PNGs to ``tests/test_torch_eval.py``'s PNG_LEVELS.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_depth import tiny_cfg
from test_torch_eval import PNG_LEVELS, calibrated_checkpoint
from test_torch_occupancy import _jax_draws

from dexnerf_tpu_torch.apps import eval as eval_app
from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core import lie
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
from dexnerf_tpu_torch.data.synthetic import (
    analytic_field,
    make_synthetic_scene,
    write_blender_dataset,
    write_messytable_dataset,
)
from dexnerf_tpu_torch.render.renderer import (
    RenderSettings,
    draw_render_noise,
    render_image,
    render_rays,
)
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train import pose_opt as po
from dexnerf_tpu_torch.train.checkpoints import (
    POSE_KEY,
    read_reference_checkpoint,
    state_dict_from_flax,
)
from dexnerf_tpu_torch.train.step import nerf_loss
from dexnerf_tpu_torch.utils import cast_to_image

VALUE_ATOL, VALUE_RTOL = 2e-5, 2e-6
GRAD_RTOL = 1e-4
RAY_ATOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy)


def _twists(seed=0, n=10, scale=0.5):
    """Random twists with the zero twist, one of |w| = 1e-5 (the Taylor
    branch) and one of |w| = π - 0.05 among them."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=scale, size=(n, 6))
    axis = rng.normal(size=(2, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    xi[0] = 0.0
    xi[1, :3] = 1e-5 * axis[0]
    if n > 2:
        xi[2, :3] = (np.pi - 0.05) * axis[1]
    return xi.astype(np.float32)


def _compare(jx, name, j_fn, p_fn, inputs, seed=1, finite=True):
    """Values of ``p_fn`` and ``j_fn`` on the same numpy inputs, and their
    vector-Jacobian products with one random cotangent, finite (else
    non-finite exactly where JAX's are)."""
    jax = jx.jax
    shape = jax.eval_shape(j_fn, *inputs).shape
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    @jax.jit
    def value_and_vjp(args, cot):
        out, vjp = jax.vjp(j_fn, *args)
        return out, vjp(cot)

    want, want_g = value_and_vjp([jx.jnp.asarray(x) for x in inputs], jx.jnp.asarray(g))
    args = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = p_fn(*args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL, err_msg=name)
    got_g = torch.autograd.grad(got, args, torch.tensor(g))
    for k, (a, b) in enumerate(zip(got_g, want_g)):
        a, b = a.numpy(), np.asarray(b)
        ok = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), ok) and (ok.all() or not finite), (name, k)
        err = np.abs(a - b)[ok].max()
        assert err <= GRAD_RTOL * max(np.abs(b[ok]).max(), 1.0), (name, k, err)


# ---- core/lie.py


@pytest.mark.parametrize("fn", ["so3_exp", "so3_log", "so3_V", "se3_exp", "se3_log",
                                "se3_inverse", "se3_transform", "hat_vee"])
def test_lie_matches_jax(jx, fn):
    """Each map on random twists (θ = 0, 1e-5 and π - 0.05 among them):
    values and gradients, the gradients finite, but for the logs' at the
    identity, whose arccos has an infinite slope there in both packages
    (the diagonal's entries are NaN; no pose step takes a log)."""
    from dexnerf_tpu.core import lie as jl

    xi = _twists()
    T = np.asarray(jl.se3_exp(jx.jnp.asarray(xi)))
    pts = np.random.default_rng(3).normal(size=(len(xi), 5, 3)).astype(np.float32)
    cases = {
        "so3_exp": (jl.so3_exp, lie.so3_exp, [xi[:, :3]]),
        "so3_log": (jl.so3_log, lie.so3_log, [T[:, :3, :3]]),
        "so3_V": (jl._so3_V, lie._so3_V, [xi[:, :3]]),
        "se3_exp": (jl.se3_exp, lie.se3_exp, [xi]),
        "se3_log": (jl.se3_log, lie.se3_log, [T]),
        "se3_inverse": (jl.se3_inverse, lie.se3_inverse, [T]),
        "se3_transform": (jl.se3_transform, lie.se3_transform, [T, pts]),
        "hat_vee": (lambda x: jl.se3_vee(jl.se3_hat(x)) * 2.0 + jl.se3_hat(x)[..., 0, 1, None],
                    lambda x: lie.se3_vee(lie.se3_hat(x)) * 2.0 + lie.se3_hat(x)[..., 0, 1, None],
                    [xi]),
    }
    j_fn, p_fn, inputs = cases[fn]
    _compare(jx, fn, j_fn, p_fn, inputs, finite=not fn.endswith("log"))


def test_zero_twist_gradients_finite_and_exact():
    """At xi = 0, where every pose run starts, exp is the identity and its
    Jacobian is finite and exactly the six generators ``se3_hat(e_k)``, in
    value and in the Taylor branch's gradient (the JAX comparison of
    :func:`test_lie_matches_jax` covers the zero twist too)."""
    zero = torch.zeros(6)
    np.testing.assert_array_equal(lie.se3_exp(zero).numpy(), np.eye(4, dtype=np.float32))
    jac = torch.autograd.functional.jacobian(lie.se3_exp, zero)  # [4, 4, 6]
    generators = torch.stack([lie.se3_hat(e) for e in torch.eye(6)], -1)
    assert torch.equal(jac, generators)
    base = torch.tensor(make_synthetic_scene(num_views=2, height=2, width=2)[2])
    jac = torch.autograd.functional.jacobian(lambda x: po.refined_c2w(base, x),
                                             torch.zeros(2, 6))
    assert bool(torch.isfinite(jac).all()) and float(jac.abs().max()) > 0.0


def test_products_ignore_tf32_setting():
    """The Lie products are elementwise sums: a TF32 matmul setting cannot
    reach them (on a card it would round a 4 m camera's pose by ~1e-2)."""
    xi = torch.tensor(_twists(seed=4))
    before = lie.se3_exp(xi)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not flag
        assert torch.equal(lie.se3_exp(xi), before)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# ---- the pose store and pose_rays


def _pose_case(kind):
    """(images, poses, hwf, near, far, intrinsics, use_ndc) of a small scene."""
    if kind == "w2c":
        rng = np.random.default_rng(3)
        n, H, W = 2, 5, 4
        w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(n):
            xi = torch.tensor(np.r_[rng.normal(size=3) * 0.3, 0, 0, 0], dtype=torch.float32)
            w2c[i, :3, :3] = lie.se3_exp(xi).numpy()[:3, :3]
            w2c[i, :3, 3] = rng.normal(size=3)
        K = np.tile(np.array([[20.0, 0, 2.0], [0, 23.0, 1.5], [0, 0, 1]], np.float32), (n, 1, 1))
        images = rng.random((n, H, W, 3)).astype(np.float32)
        return images, w2c, [H, W, 20.0], 0.5, 4.0, K, False
    images, _, poses, hwf = make_synthetic_scene(num_views=3 if kind == "c2w" else 2, height=6,
                                                 width=5 if kind == "c2w" else 6)
    if kind == "ndc":
        return images, poses, hwf, 0.0, 1.0, None, True
    return images, poses, hwf, 2.0, 6.0, None, False


@pytest.mark.parametrize("kind", ["c2w", "w2c", "ndc"])
def test_pose_store_and_rays_match_jax(jx, kind):
    """The store's rows and base poses, and ``pose_rays`` of every ray at
    random twists: origins, directions, viewdirs (before NDC), targets, and
    the gradient with respect to the twists."""
    from dexnerf_tpu.train.pose_opt import build_pose_ray_store as j_build
    from dexnerf_tpu.train.pose_opt import pose_rays as j_rays

    images, poses, hwf, near, far, K, ndc = _pose_case(kind)
    want = j_build(images, poses, hwf, near, far, intrinsics=K, use_ndc=ndc)
    got = po.build_pose_ray_store(images, poses, hwf, near, far, device="cpu", intrinsics=K,
                                  use_ndc=ndc)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.base_c2w.numpy(), np.asarray(want.base_c2w), rtol=0,
                               atol=RAY_ATOL)
    assert (got.num_rays, got.num_images, got.rays_per_image) == (
        want.num_rays, want.num_images, want.rays_per_image)
    xi = _twists(seed=5, n=got.num_images, scale=0.05)
    idx = np.arange(got.num_rays)

    def j_fn(t):
        rays, target = j_rays(want, t, jx.jnp.asarray(idx))
        return jx.jnp.concatenate([rays.origins, rays.directions, rays.viewdirs, target], -1)

    def p_fn(t):
        rays, target = po.pose_rays(got, t, torch.tensor(idx))
        return torch.cat([rays.origins, rays.directions, rays.viewdirs, target], -1)

    _compare(jx, kind, j_fn, p_fn, [xi])


# ---- run_training, the step and the optimizer


@pytest.fixture(scope="module")
def pose_scene(tmp_path_factory):
    """A 8x8 blender scene (3 train views) and a seeded ``.ckpt`` of
    tiny_cfg's models with calibrated σ heads."""
    tmp = tmp_path_factory.mktemp("pose_scene")
    data = str(tmp / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(3, 1, 1))
    ckpt = str(tmp / "start.ckpt")
    calibrated_checkpoint(_pose_cfg(tmp, data), ckpt)
    return data, ckpt


def _pose_cfg(tmp_path, data, iters=3, opt="Adam", run="pose"):
    raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
    raw["experiment"].update(id=run, train_iters=iters, validate_every=0, save_every=0,
                             print_every=1, randomseed=5)
    raw["optimizer"].update(type=opt, pose_lr=1e-2)
    return raw


def _records(logdir, tags=("train/loss", "train/psnr", "train/pose_twist_norm")):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in recs if r["tag"] in tags}


def _port_run(monkeypatch, raw, draws, **kw):
    """The port's ``run_training(pose_opt=True)`` of ``raw`` on the CPU,
    each step on the next of ``draws``."""
    make_step = ploop.make_train_step
    it = iter(draws)

    def make_with_draws(*a, **k):
        step = make_step(*a, **k)
        return lambda state, store, generator: step(state, store, generator, draws=[next(it)])

    monkeypatch.setattr(ploop, "make_train_step", make_with_draws)
    out = ploop.run_training(CfgNode(raw), pose_opt=True, device="cpu", **kw)
    monkeypatch.setattr(ploop, "make_train_step", make_step)
    return out


def _assert_state_close(got, want, jx):
    np.testing.assert_allclose(got["state"].pose.twists.detach().numpy(),
                               np.asarray(want["state"].params["pose"]), rtol=0, atol=PARAM_ATOL)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(jx.jax.tree.map(np.asarray, want["state"].params[name]))
        for pname, p in getattr(got["state"], name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")


@pytest.mark.parametrize("opt", ["Adam", "RMSprop"])
def test_pose_steps_match_jax(jx, tmp_path, monkeypatch, pose_scene, opt):
    """3 steps of both packages' ``run_training(pose_opt=True)`` from one
    ``.ckpt`` on JAX's draws, the model under ``opt`` and the twists under
    their own Adam at ``pose_lr``: the logged losses, PSNRs and
    ``pose_twist_norm``, the twists, every leaf and ``refined_poses``."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run

    data, ckpt = pose_scene
    raw = _pose_cfg(tmp_path, data, opt=opt)
    raw_j = json.loads(json.dumps(raw))
    raw_j["experiment"]["id"] = "pose_jax"
    want = j_run(JCfg(raw_j), load_ckpt=ckpt, pose_opt=True, use_tensorboard=False)
    s = ploop.render_settings_from_cfg(CfgNode(raw), "train")
    got = _port_run(monkeypatch, raw, _jax_draws(jx, 5, 3, 16, 3 * 64, s), load_ckpt=ckpt)

    a, b = _records(got["logdir"]), _records(str(tmp_path / "logs" / "pose_jax"))
    assert set(a) == set(b) and len(a) == 9
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=str(k))
    assert a[("train/pose_twist_norm", 2)] > 0.0
    _assert_state_close(got, want, jx)
    np.testing.assert_allclose(got["refined_poses"], want["refined_poses"], rtol=0,
                               atol=PARAM_ATOL)
    assert got["state"].pose.step == got["state"].step == 3


def test_refined_poses_match_jax(jx):
    """``refined_c2w`` of both packages on one set of twists and poses."""
    from dexnerf_tpu.train.pose_opt import refined_c2w as j_refined

    base = make_synthetic_scene(num_views=4, height=2, width=2)[2]
    xi = _twists(seed=6, n=4, scale=0.1)
    np.testing.assert_allclose(po.refined_c2w(torch.tensor(base), torch.tensor(xi)).numpy(),
                               np.asarray(j_refined(jx.jnp.asarray(base), jx.jnp.asarray(xi))),
                               rtol=0, atol=VALUE_ATOL)


def test_pose_checkpoint_round_trip_and_resumes(jx, tmp_path, monkeypatch, pose_scene):
    """The twists, their Adam state and its count go to the ``.ckpt``; a
    port resume from it equals the straight run in every bit; JAX reads
    the file; from the file without the port's entry (a reference or
    JAX-exported ``.ckpt``) both packages resume with zero twists and
    JAX's grafted Adam count, and take the same step."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.checkpoints import import_torch_checkpoint
    from dexnerf_tpu.train.loop import run_training as j_run

    data, ckpt = pose_scene
    s = ploop.render_settings_from_cfg(CfgNode(_pose_cfg(tmp_path, data)), "train")
    draws = _jax_draws(jx, 5, 3, 16, 3 * 64, s)
    straight = _port_run(monkeypatch, _pose_cfg(tmp_path, data, run="straight"), draws,
                         load_ckpt=ckpt)
    raw = _pose_cfg(tmp_path, data, iters=2, run="first")
    raw["experiment"]["save_every"] = 2
    first = _port_run(monkeypatch, raw, draws[:2], load_ckpt=ckpt)
    saved = os.path.join(first["logdir"], "checkpoints", "checkpoint_0000001.ckpt")
    entry = read_reference_checkpoint(saved)[POSE_KEY]
    assert entry["step"] == 2 and set(entry["state"]) == {"step", "exp_avg", "exp_avg_sq"}
    assert torch.equal(entry["twists"], first["state"].pose.twists.detach())
    resumed = _port_run(monkeypatch, _pose_cfg(tmp_path, data, run="resumed"), draws[2:],
                        load_ckpt=saved)
    assert torch.equal(resumed["state"].pose.twists, straight["state"].pose.twists)
    for name in ("coarse", "fine"):
        for p, q in zip(getattr(resumed["state"], name).parameters(),
                        getattr(straight["state"], name).parameters()):
            assert torch.equal(p, q)

    imported = import_torch_checkpoint(saved)
    assert imported["step"] == 2 and "optimizer_state_dict" in imported
    exported = str(tmp_path / "exported.ckpt")
    ck = torch.load(saved, weights_only=True)
    del ck[POSE_KEY]
    torch.save(ck, exported)
    raw_j = _pose_cfg(tmp_path, data, run="jax_resume")
    want = j_run(JCfg(raw_j), load_ckpt=exported, pose_opt=True, use_tensorboard=False)
    got = _port_run(monkeypatch, _pose_cfg(tmp_path, data, run="port_resume"), draws[:1],
                    load_ckpt=exported)
    assert got["state"].pose.step == 3
    a = _records(got["logdir"])
    b = _records(str(tmp_path / "logs" / "jax_resume"))
    assert set(a) == set(b) == {(t, 2) for t in ("train/loss", "train/psnr",
                                                 "train/pose_twist_norm")}
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=str(k))
    _assert_state_close(got, want, jx)


# ---- the CLIs


def _scene_cfg(tmp_path, kind):
    data = str(tmp_path / kind)
    if kind == "blender":
        write_blender_dataset(data, height=12, width=12, views_per_split=(2, 1, 1))
        raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
    else:
        write_messytable_dataset(data, 32, 40, (2, 1, 1))
        raw = tiny_cfg({"type": "messytable", "basedir": data, "near": 2.5, "far": 6.0},
                       str(tmp_path / "logs"))
    raw["experiment"].update(id=kind, train_iters=2, validate_every=2, save_every=2)
    raw["optimizer"]["pose_lr"] = 1e-2
    cfg = str(tmp_path / f"{kind}.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    return raw, cfg


@pytest.mark.parametrize("kind", ["blender", "messytable"])
def test_train_then_eval_refined_poses_match_jax(jx, tmp_path, kind):
    """``apps.train --pose-opt`` then ``apps.eval --refined-poses`` on the
    CPU: one frame a train view, each JAX's ``render_image`` of the same
    weights at JAX's ``refined_c2w`` of the checkpoint's twists (c2w rays,
    or refined c2w + K with K[0, 0] for both axes on messytable)."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.config import render_settings_from_cfg as j_settings
    from dexnerf_tpu.core.rays import _rotate, get_ray_bundle_c2w, pixel_grid
    from dexnerf_tpu.render import render_image as j_render
    from dexnerf_tpu.train.loop import load_eval_params as j_load_params
    from dexnerf_tpu.train.loop import load_scene as j_load_scene
    from dexnerf_tpu.train.loop import setup_models as j_setup
    from dexnerf_tpu.train.pose_opt import refined_c2w as j_refined

    jnp = jx.jnp
    raw, cfg = _scene_cfg(tmp_path, kind)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--pose-opt"]) == 0
    ckpt = str(tmp_path / "logs" / kind / "checkpoints" / "checkpoint_0000001.ckpt")
    out = str(tmp_path / "renders")
    assert eval_app.main(["--config", cfg, "--checkpoint", ckpt, "--savedir", out,
                          "--refined-poses", "--device", "cpu"]) == 0
    twists = read_reference_checkpoint(ckpt)[POSE_KEY]["twists"].numpy()
    assert np.abs(twists).max() > 0.0

    jcfg, params, _, _ = j_load_params(JCfg(raw), ckpt)
    apply_c, apply_f, _ = j_setup(jcfg, 3)
    scene = j_load_scene(jcfg)
    base = scene.poses[scene.i_train][:, :4, :4].astype(np.float32)
    if scene.intrinsics is not None:
        base = np.linalg.inv(base)
    T = np.asarray(j_refined(jnp.asarray(base), jnp.asarray(twists)))
    H, W, focal = (int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2]))
    s_val = j_settings(jcfg, "validation").eval_variant()
    assert sorted(os.listdir(out)) == [f"{i:04d}.png" for i in range(len(T))]
    for i, pose in enumerate(T):
        if scene.intrinsics is not None:
            K = jnp.asarray(scene.intrinsics[scene.i_train][i])
            ii, jj = pixel_grid(H, W)
            dirs = jnp.stack([(ii - K[0, 2]) / K[0, 0], (jj - K[1, 2]) / K[0, 0],
                              jnp.ones_like(ii)], -1)
            rd = _rotate(dirs, jnp.asarray(pose[:3, :3]))
            ro = jnp.broadcast_to(jnp.asarray(pose[:3, 3]), rd.shape)
        else:
            ro, rd = get_ray_bundle_c2w(H, W, focal, jnp.asarray(pose))
        res = j_render(apply_c, apply_f, params, ro, rd, float(raw["dataset"]["near"]),
                       float(raw["dataset"]["far"]), s_val)
        want = cast_to_image(np.asarray(res.fine.rgb)).astype(np.int16)
        got = np.asarray(Image.open(os.path.join(out, f"{i:04d}.png")), np.int16)
        assert got.shape == want.shape == (H, W, 3)
        assert np.abs(got - want).max() <= PNG_LEVELS, i


def test_pose_opt_ignores_a_cache(tmp_path, monkeypatch):
    """With ``--pose-opt`` a ``dataset.cachedir`` of shards is not read (a
    cache holds world rays with no image to refine), as in JAX."""
    from dexnerf_tpu_torch.apps import cache as cache_app

    raw, cfg = _scene_cfg(tmp_path, "blender")
    cachedir = str(tmp_path / "cache")
    assert cache_app.main(["--datapath", raw["dataset"]["basedir"], "--savedir", cachedir,
                           "--num-random-rays", "8", "--device", "cpu"]) == 0
    raw["dataset"]["cachedir"] = cachedir
    raw["experiment"].update(train_iters=1, validate_every=0, save_every=0)
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    stores = []
    make_step = ploop.make_train_step

    def spy(*a, **k):
        step = make_step(*a, **k)
        return lambda state, store, gen: stores.append(store) or step(state, store, gen)

    monkeypatch.setattr(ploop, "make_train_step", spy)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--pose-opt"]) == 0
    assert len(stores) == 1 and isinstance(stores[0], po.PoseRayStore)


@pytest.mark.parametrize("case", ["depth", "depth-warmup", "sg-ir", "use-pallas",
                                  "eval-test-set", "eval-no-twists", "num-devices"])
def test_pose_refusals_match_jax(jx, tmp_path, case):
    """JAX's exclusions raise (or warn) in both packages with the same
    words; with ``--num-devices 2`` (ported since, ROADMAP item 11) a depth
    term is refused before any rank starts, as in JAX."""
    from dexnerf_tpu.apps.eval import main as j_eval
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run

    raw, cfg = _scene_cfg(tmp_path, "messytable" if case.startswith("depth") else "blender")
    raw["experiment"].update(train_iters=1, validate_every=0, save_every=0)
    if case.startswith("depth"):
        kw = dict(depth_loss_weight=0.1, depth_warmup=5 if case == "depth-warmup" else None)
        with pytest.raises(ValueError) as got:
            ploop.run_training(CfgNode(raw), pose_opt=True, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            j_run(JCfg(raw), pose_opt=True, use_tensorboard=False, **kw)
    elif case == "sg-ir":
        with pytest.raises(NotImplementedError) as got:
            train_app.main(["--config", cfg, "--device", "cpu", "--pose-opt", "--sg-ir"])
        with pytest.raises(NotImplementedError) as want:
            j_run(JCfg(raw), pose_opt=True, supervision="sg_ir", use_tensorboard=False)
    elif case == "use-pallas":
        raw["nerf"]["use_pallas"] = True
        with pytest.warns(UserWarning, match="pose_opt needs ray-input gradients") as got:
            ploop.run_training(CfgNode(raw), pose_opt=True, device="cpu")
        with pytest.warns(UserWarning, match="pose_opt needs ray-input gradients") as want:
            j_run(JCfg(raw), pose_opt=True, use_tensorboard=False)
        words = [{str(w.message) for w in rec if "pose_opt" in str(w.message)}
                 for rec in (got, want)]
        assert words[0] == words[1] and len(words[0]) == 1
        return
    elif case == "num-devices":
        with pytest.raises(ValueError) as got:
            train_app.main(["--config", cfg, "--device", "cpu", "--pose-opt",
                            "--num-devices", "2", "--depth-loss", "0.1"])
        with pytest.raises(ValueError) as want:
            j_run(JCfg(raw), pose_opt=True, num_devices=2, depth_loss_weight=0.1,
                  use_tensorboard=False)
    else:
        ckpt = str(tmp_path / "model.ckpt")
        calibrated_checkpoint(raw, ckpt)
        flags = ["--config", cfg, "--checkpoint", ckpt, "--savedir", str(tmp_path / "r"),
                 "--refined-poses"] + (["--test-set"] if case == "eval-test-set" else [])
        with pytest.raises(SystemExit) as got:
            eval_app.main([*flags, "--device", "cpu"])
        with pytest.raises(SystemExit) as want:
            j_eval([*flags, "--platform", "cpu"])
    assert str(got.value) == str(want.value)


# ---- pose recovery (JAX's tests/test_pose_opt.py check, on the port)


class _AnalyticModel(torch.nn.Module):
    """The scene's analytic field as a model: the encoded features start
    with the raw xyz (``include_input_xyz``), so it needs no weights."""

    def forward(self, xyz_enc, dir_enc=None):
        return analytic_field(xyz_enc[..., :3])


def pose_recovery(device="cpu", steps=250, seed=7):
    """JAX's pose-recovery check at its sizes: targets rendered by the
    port's renderer at 4 views of 16x16 (8 + 8 samples, deterministic), the
    cameras perturbed by known twists (rotation std 0.04, translation std
    0.08), then ``steps`` pose-only Adam steps (lr 1e-2, the decay of 250k
    steps to 0.1) at 256 uniform rays. Returns the mean twist error before
    and after, against the ideal correction ``se3_log(T_true @
    inv(T_perturbed))``, and the last step's loss and twist norm."""
    s = RenderSettings(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                       num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    model = _AnalyticModel()
    _, _, poses, hwf = make_synthetic_scene(num_views=4, height=16, width=16, device=device)
    H, W, focal = hwf
    true = torch.as_tensor(poses, device=device)
    images = []
    with torch.no_grad():
        for c2w in true:
            ro, rd = get_ray_bundle_c2w(H, W, focal, c2w)
            images.append(render_image(model, model, ro, rd, 2.0, 6.0, s).fine.rgb)
    rng = np.random.default_rng(seed)
    eps = torch.tensor(np.concatenate([rng.normal(scale=0.04, size=(4, 3)),
                                       rng.normal(scale=0.08, size=(4, 3))], 1),
                       dtype=torch.float32, device=device)
    pert = lie.matmul3(lie.se3_exp(eps), true)
    ideal = lie.se3_log(lie.matmul3(true, lie.se3_inverse(pert)))
    store = po.build_pose_ray_store(torch.stack(images).cpu().numpy(), pert.cpu().numpy(), hwf,
                                    2.0, 6.0, device=device)
    pose = po.init_pose_state(4, 1e-2, 250, 0.1, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(steps):
        idx = torch.randint(0, store.num_rays, (256,), generator=gen, device=device)
        rays, target = po.pose_rays(store, pose.twists, idx)
        loss = nerf_loss(render_rays(model, model, rays, s, draw_render_noise(256, s, gen, device)),
                         target)[0]
        pose.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pose.update()
    err0 = float(torch.linalg.norm(ideal, dim=-1).mean())
    err1 = float(torch.linalg.norm(pose.twists.detach() - ideal, dim=-1).mean())
    norm = float(torch.linalg.norm(pose.twists.detach(), dim=-1).mean())
    return err0, err1, float(loss.detach()), norm


def test_pose_recovery_from_perturbed_cameras():
    """The twists recover more than half of the known correction, as JAX's
    check requires of the JAX package."""
    err0, err1, loss, norm = pose_recovery()
    assert np.isfinite(loss) and norm > 0.0
    assert err1 < 0.5 * err0, (err0, err1)
