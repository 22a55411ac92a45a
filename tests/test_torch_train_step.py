"""The train step of the port (``dexnerf_tpu_torch/train/step.py``) held to
the JAX package's ``make_train_step`` on the CPU.

Both packages start from one set of weights and one ray store; the JAX
step draws its ray indices and render draws from one key per step, and the
port is handed exactly those numbers (``StepDraws``). After a few Adam
updates the parameters and both Adam moments must agree, through the fused
loss (the JAX kernel in interpret mode vs the port's plain version of
kernel 4) and through the plain render (XLA vs autograd).
"""

import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.data.blender import pose_spherical
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import (
    StepDraws,
    exponential_decay_schedule,
    init_train_state,
    make_train_step,
    masked_depth_mse,
)

ENC_XYZ, ENC_DIR = 3, 2
ARCH = dict(num_layers=8, hidden_size=16, skip_connect_every=3,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
SETTINGS = RenderSettings(
    num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
BATCH = 24  # the JAX kernel pads it to 32 rays
STEPS = 3
LR = 5e-3
# lr_decay 0.001 -> one transition step: the rate falls 10x per update, so
# a schedule evaluated at the wrong count shows within three updates
LR_DECAY, LR_FACTOR = 0.001, 0.1
DEPTH_WEIGHT = 0.5  # the depth-supervised cases; GT depth 0 marks rays without one
DEPTH_VALID_MAX = 4.0  # the depth-vmax case: GT in [2.5, 5.5], so it masks about half

# Comparison rule after the updates, on every element (f32 both sides,
# sums in another order). Adam's first update is lr * g / (|g| + eps),
# about lr * sign(g), so an element whose |g| sits at round-off above eps
# could flip; none does here (dead ReLU units give g == 0 exactly on both
# sides, and eps 1e-8 damps the rest). The round-off of step 1 changes the
# weights that step 2 differentiates, and the 30x σ head amplifies it, so
# after three updates the parameters agree to PARAM_ATOL (2e-3 of lr;
# measured 4.6e-6) and both moments to MOMENT_RTOL of the leaf's largest
# (measured 1.1e-3).
PARAM_ATOL = 1e-5
MOMENT_RTOL = 2e-3


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    trees = {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(10 + i), jnp.ones((1, in_dim))))
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= 30.0
        alpha["bias"] = alpha["bias"] + 1.0
        trees[name] = tree
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 4, 6, 3)).astype(np.float32)
    depths = np.where(rng.uniform(size=(2, 4, 6)) < 0.25, 0.0,
                      rng.uniform(2.5, 5.5, size=(2, 4, 6))).astype(np.float32)
    poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (-40.0, 50.0)])
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jm=jm, trees=trees, images=images, depths=depths, poses=poses,
        hwf=[4, 6, 7.2],
    )


def _port_models(jx):
    models = []
    for name in ("coarse", "fine"):
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(jx.trees[name]))
        models.append(m)
    return models


def _step_draws(jx, key, num_rays):
    """The draws of one JAX train step (``k_sample, k_render =
    split(key)``; uniform ray indices from ``k_sample``; the four render
    draws from ``k_render`` in ``render_rays``' split order)."""
    jax, jnp = jx.jax, jx.jnp
    k_sample, k_render = jax.random.split(key)
    idx = jax.random.randint(k_sample, (BATCH,), 0, num_rays)
    k_strat, k_noise_c, k_fine, k_noise_f = jax.random.split(k_render, 4)
    c, f, std = SETTINGS.num_coarse, SETTINGS.num_fine, SETTINGS.radiance_field_noise_std

    def t(x):
        return torch.tensor(np.asarray(x))

    return StepDraws(
        idx=t(idx).to(torch.int64),
        render=RenderDraws(
            t_strat=t(jax.random.uniform(k_strat, (BATCH, c), dtype=jnp.float32)),
            noise_coarse=t(std * jax.random.normal(k_noise_c, (BATCH, c), dtype=jnp.float32)),
            u_fine=t(jax.random.uniform(k_fine, (BATCH, f), dtype=jnp.float32)),
            noise_fine=t(std * jax.random.normal(k_noise_f, (BATCH, c + f), dtype=jnp.float32)),
        ),
    )


def _run_jax(jx, fused: bool, depth_weight: float, keys, depth_valid_max=None):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.ops import make_fused_train_loss as j_make_loss
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train.checkpoints import _find_adam_state
    from dexnerf_tpu.train.step import init_train_state as j_init
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer
    from dexnerf_tpu.train.step import make_train_step as j_make_step

    js = JSettings(**SETTINGS.__dict__)
    store = j_build(jx.images, jx.poses, jx.hwf, 2.0, 6.0, depths=jx.depths)
    tx = j_optimizer(LR, LR_DECAY, LR_FACTOR)
    fused_loss = (
        j_make_loss(jx.jm, jx.jm, js, block_samples=128, interpret=True,
                    depth_loss_weight=depth_weight, depth_valid_max=depth_valid_max)
        if fused else None
    )
    step = j_make_step(jx.jm.apply, jx.jm.apply, tx, js, BATCH, fused_loss=fused_loss,
                       depth_loss_weight=depth_weight, depth_valid_max=depth_valid_max)
    state = j_init(jx.jax.tree.map(jx.jnp.asarray, jx.trees), tx)
    for key in keys:
        state, metrics = step(state, store, key)
    adam = _find_adam_state(state.opt_state)
    as_np = lambda tree: jx.jax.tree.map(np.asarray, tree)  # noqa: E731
    return {
        name: {
            "param": state_dict_from_flax(as_np(state.params[name])),
            "m": state_dict_from_flax(as_np(adam.mu[name])),
            "v": state_dict_from_flax(as_np(adam.nu[name])),
        }
        for name in ("coarse", "fine")
    }, {k: float(v) for k, v in metrics.items()}, int(adam.count)


@pytest.mark.parametrize("depth", [False, True, "vmax"], ids=["photo", "depth", "depth-vmax"])
@pytest.mark.parametrize("path", ["fused", "plain"])
def test_train_steps_match_jax(jx, path, depth):
    """``depth-vmax``: the depth term over ``0 < gt < depth_valid_max``."""
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(3), STEPS))
    weight = DEPTH_WEIGHT if depth else 0.0
    vmax = DEPTH_VALID_MAX if depth == "vmax" else None
    want, want_metrics, want_count = _run_jax(jx, path == "fused", weight, keys, vmax)

    coarse, fine = _port_models(jx)
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu",
                            depths=jx.depths)
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
    fused_loss = (
        make_fused_train_loss(coarse, fine, SETTINGS, depth_loss_weight=weight,
                              depth_valid_max=vmax)
        if path == "fused" else None
    )
    # the port takes all updates in one call (steps_per_call), JAX one per call
    step = make_train_step(SETTINGS, BATCH, fused_loss=fused_loss, steps_per_call=STEPS,
                           depth_loss_weight=weight, depth_valid_max=vmax)
    metrics = step(state, store, draws=[_step_draws(jx, k, store.num_rays) for k in keys])
    assert state.step == want_count == STEPS
    assert set(metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], rtol=1e-5, err_msg=k)

    for name, model in (("coarse", coarse), ("fine", fine)):
        for pname, p in model.named_parameters():
            st = state.optimizer.state[p]
            for got, key in ((st["exp_avg"], "m"), (st["exp_avg_sq"], "v")):
                w = want[name][key][pname].numpy()
                np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                           atol=MOMENT_RTOL * float(np.abs(w).max()),
                                           err_msg=f"{name}.{pname} {key}")
            np.testing.assert_allclose(p.detach().numpy(), want[name]["param"][pname].numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=f"{name}.{pname}")


@pytest.mark.parametrize("step", [0, 1, 1000, 250000])
def test_schedule_matches_optax(step):
    """lego-tpu's schedule (lr 5e-3, decay 250k steps, factor 0.1) equals
    optax's to one f32 rounding of ``pow`` (rtol 1e-6); step 0 is ``lr``."""
    pytest.importorskip("optax")
    from dexnerf_tpu.train.step import exponential_decay_schedule as j_schedule

    want = float(j_schedule(LR, 250.0, 0.1)(step))
    got = exponential_decay_schedule(LR, 250.0, 0.1)(step)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if step == 0:
        assert got == float(np.float32(LR))


def test_applied_lr_follows_schedule(jx):
    """The update of step k uses the schedule at k (optax evaluates it at
    the count before the increment)."""
    coarse, fine = _port_models(jx)
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
    step = make_train_step(SETTINGS, BATCH)
    gen = torch.Generator().manual_seed(0)
    for k in range(3):
        step(state, store, gen)
        assert state.optimizer.param_groups[0]["lr"] == state.schedule(k)
    np.testing.assert_allclose(state.schedule(2), LR * LR_FACTOR**2, rtol=1e-6)


def test_masked_depth_mse_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from dexnerf_tpu.train.step import masked_depth_mse as j_mse

    rng = np.random.default_rng(1)
    pred = rng.uniform(2, 6, size=64).astype(np.float32)
    gt = np.where(rng.uniform(size=64) < 0.3, 0.0, rng.uniform(0.5, 5, size=64)).astype(np.float32)
    for vmax in (None, 3.0):
        got = float(masked_depth_mse(torch.tensor(pred), torch.tensor(gt), vmax))
        want = float(j_mse(jnp.asarray(pred), jnp.asarray(gt), vmax))
        np.testing.assert_allclose(got, want, rtol=1e-6)
