"""The port's optimizers (``train/step.py::OPTIMIZER_REGISTRY``) held to
optax through the JAX package's ``make_train_step`` on the CPU, their
checkpoints, and training of every family through ``run_training``.

Both packages start from one set of weights and one ray store, and the
port is handed the draws the JAX step takes from its keys (as in
``tests/test_torch_train_step.py``). After three updates of each of JAX's
five optimizers at optax's defaults the parameters and the optimizer's
state must agree; AdamW's weight decay, too small to show in three
steps, is held on its own on gradients fixed in advance. A run resumed from a ``.ckpt`` after one update must
equal the uninterrupted run, for every optimizer; SGD's, RMSprop's and
Adagrad's state rides a key that JAX's ``import_torch_checkpoint`` does
not read.
"""

import functools
import os

import numpy as np
import pytest
import torch
import yaml
from test_torch_train_step import BATCH, LR, LR_DECAY, LR_FACTOR, STEPS, _step_draws

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.render.renderer import RenderSettings
from dexnerf_tpu_torch.train.checkpoints import (
    PORT_OPTIMIZER_KEY,
    load_optimizer_checkpoint,
    optimizer_checkpoint,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.step import (
    OPTIMIZER_REGISTRY,
    init_train_state,
    make_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIMIZERS = ["Adam", "AdamW", "SGD", "RMSprop", "Adagrad"]
ENC_XYZ, ENC_DIR = 3, 2
ARCH = dict(num_layers=4, hidden_size=16, skip_connect_every=2,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
# the draws of test_torch_train_step (its settings: 8 + 8 samples, σ-noise)
SETTINGS = RenderSettings(
    num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
# Comparison after three updates, each leaf against its own largest entry
# (f32 both sides, gradients summed in another order). Adam's first update
# is about lr * sign(g), so an entry whose |g| sits near eps moves by
# lr * g / (|g| + eps) with that g's rounding; RMSprop's and Adagrad's are
# lr * g * rsqrt(c g² + eps), which near g = 0 magnifies a gradient's
# rounding by up to 1/sqrt(eps) (1e4 at RMSprop's 1e-8); and step 2
# differentiates the weights step 1 moved. Measured: parameters within
# 1.8e-5 of their largest entry (Adam, AdamW), 7.3e-7 (RMSprop), 1.1e-8
# (SGD, Adagrad); the state within 1.6e-3 of its own (Adam's moments of
# fc_alpha, whose gradients are ~1e-7), 2.1e-4 (AdamW, RMSprop), 7.4e-8
# (Adagrad).
PARAM_RTOL = 5e-5
STATE_RTOL = 4e-3
# the optimizer state each package keeps: port key -> optax state field
STATE_FIELDS = {"Adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
                "AdamW": {"exp_avg": "mu", "exp_avg_sq": "nu"},
                "SGD": {}, "RMSprop": {"nu": "nu"}, "Adagrad": {"sum": "sum_of_squares"}}


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

    from dexnerf_tpu_torch.data.blender import pose_spherical

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    trees = {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(20 + i), jnp.ones((1, in_dim))))
        # σ spread as in test_torch_train_step: random weights give σ ~ 0,
        # a transparent scene whose gradients sit near Adam's eps
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= 30.0
        alpha["bias"] = alpha["bias"] + 1.0
        trees[name] = tree
    rng = np.random.default_rng(2)
    images = rng.uniform(size=(2, 4, 6, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (-40.0, 50.0)])
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, trees=trees, images=images,
                                 poses=poses, hwf=[4, 6, 7.2])


def _port_models(jx):
    models = []
    for name in ("coarse", "fine"):
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(jx.trees[name]))
        models.append(m)
    return models


def _optax_state(opt_state, field):
    """The first node of ``opt_state`` that carries ``field``."""
    import jax

    found = []
    jax.tree.map(lambda n: found.append(n) if hasattr(n, field) else None, opt_state,
                 is_leaf=lambda n: hasattr(n, field))
    return getattr(found[0], field)


def _run_jax(jx, opt_type, keys):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train.step import init_train_state as j_init
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer
    from dexnerf_tpu.train.step import make_train_step as j_make_step

    store = j_build(jx.images, jx.poses, jx.hwf, 2.0, 6.0)
    tx = j_optimizer(LR, LR_DECAY, LR_FACTOR, opt_type=opt_type)
    step = j_make_step(jx.jm.apply, jx.jm.apply, tx, JSettings(**SETTINGS.__dict__), BATCH)
    state = j_init(jx.jax.tree.map(jx.jnp.asarray, jx.trees), tx)
    for key in keys:
        state, _ = step(state, store, key)
    as_np = lambda tree: jx.jax.tree.map(np.asarray, tree)  # noqa: E731
    out = {}
    for name in ("coarse", "fine"):
        out[name] = {"param": state_dict_from_flax(as_np(state.params[name]))}
        for port_key, field in STATE_FIELDS[opt_type].items():
            out[name][port_key] = state_dict_from_flax(
                as_np(_optax_state(state.opt_state, field)[name]))
    return out


def _port_run(jx, opt_type, draws, state=None):
    if state is None:
        coarse, fine = _port_models(jx)
        state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR, opt_type=opt_type)
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    step = make_train_step(SETTINGS, BATCH, steps_per_call=len(draws))
    step(state, store, draws=draws)
    return state


def _assert_leaf(got, want, rtol, msg):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=msg)


def test_registry_holds_jax_optimizers():
    from dexnerf_tpu.train.step import OPTIMIZER_REGISTRY as J_REGISTRY

    assert sorted(OPTIMIZER_REGISTRY) == sorted(J_REGISTRY) == sorted(OPTIMIZERS)
    with pytest.raises(KeyError, match="unknown optimizer"):
        init_train_state(FlexibleNeRFModel(**ARCH), None, LR, opt_type="LBFGS")


@pytest.mark.parametrize("opt_type", OPTIMIZERS)
def test_three_steps_match_optax(jx, opt_type):
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(4), STEPS))
    want = _run_jax(jx, opt_type, keys)
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    state = _port_run(jx, opt_type, [_step_draws(jx, k, store.num_rays) for k in keys])
    assert state.step == STEPS
    for name, model in (("coarse", state.coarse), ("fine", state.fine)):
        for pname, p in model.named_parameters():
            _assert_leaf(p.detach().numpy(), want[name]["param"][pname].numpy(), PARAM_RTOL,
                         f"{opt_type} {name}.{pname}")
            st = state.optimizer.state[p]
            for port_key in STATE_FIELDS[opt_type]:
                _assert_leaf(st[port_key].numpy(), want[name][port_key][pname].numpy(),
                             STATE_RTOL, f"{opt_type} {name}.{pname} {port_key}")


# AdamW's weight decay, held on its own: PARAM_RTOL cannot see it after
# three steps at LR (optax's wd 1e-4 moves a weight by 3 * LR * 1e-4 =
# 1.5e-6 of its size, below Adam's own 1.8e-5 above). On gradients fixed
# in advance (the moments then do not depend on the weights) the AdamW
# run less the Adam run is the decay alone; at DECAY_LR over DECAY_STEPS
# updates, with the configs' schedule (250k-step 0.1 decay, not
# LR_DECAY's 0.1 per step), it is ~5e-4 of a weight, ~1e3 of its float32
# steps, and each leaf of the port's difference must lie within
# DECAY_RTOL of the largest entry of optax's. Measured: 2.2e-3; a decay
# of 1.1e-4 in its place gives 0.10, 0 gives 1, 1e-2 gives 99.
DECAY_LR, DECAY_STEPS, DECAY_RTOL = 0.5, 10, 1e-2
DECAY_SCHEDULE = (250.0, 0.1)


def _port_on_grads(ctor, params, grads):
    """``params`` (name -> array) after one update of ``ctor(params,
    lr=)`` per entry of ``grads``, the lr set before each from the port's
    schedule, as the train step sets it."""
    from dexnerf_tpu_torch.train.step import exponential_decay_schedule

    ps = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = ctor(list(ps.values()), lr=DECAY_LR)
    schedule = exponential_decay_schedule(DECAY_LR, *DECAY_SCHEDULE)
    for i, g in enumerate(grads):
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
    return {k: p.detach().numpy() for k, p in ps.items()}


def _optax_on_grads(jx, opt_type, params, grads):
    import optax

    from dexnerf_tpu.train.step import make_optimizer as j_optimizer

    tx = j_optimizer(DECAY_LR, *DECAY_SCHEDULE, opt_type=opt_type)
    ps = {k: jx.jnp.asarray(v) for k, v in params.items()}
    state = tx.init(ps)
    for g in grads:
        updates, state = tx.update({k: jx.jnp.asarray(v) for k, v in g.items()}, state, ps)
        ps = optax.apply_updates(ps, updates)
    return {k: np.asarray(v) for k, v in ps.items()}


def test_adamw_weight_decay_matches_optax(jx):
    """The registry's AdamW less its Adam, against optax's ``adamw`` less
    its ``adam``, on the coarse weights and seeded gradients; AdamW at a
    weight decay of 0 and at torch's default 1e-2 fail the same check."""
    params = {k: v.numpy() for k, v in state_dict_from_flax(jx.trees["coarse"]).items()}
    rng = np.random.default_rng(8)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(DECAY_STEPS)]
    adam = _optax_on_grads(jx, "Adam", params, grads)
    want = {k: v - adam[k] for k, v in _optax_on_grads(jx, "AdamW", params, grads).items()}
    port_adam = _port_on_grads(OPTIMIZER_REGISTRY["Adam"], params, grads)

    def worst(ctor):
        got = _port_on_grads(ctor, params, grads)
        return max(float(np.abs(got[k] - port_adam[k] - w).max()) / float(np.abs(w).max())
                   for k, w in want.items())

    assert worst(OPTIMIZER_REGISTRY["AdamW"]) <= DECAY_RTOL
    for wd in (0.0, 1e-2):
        assert worst(functools.partial(torch.optim.AdamW, weight_decay=wd, eps=1e-8)) > DECAY_RTOL


def _resume(jx, opt_type, path, draws):
    """New models and optimizer from the ``.ckpt`` at ``path``, as
    ``run_training`` resumes, then the remaining updates."""
    ck = read_reference_checkpoint(path)
    coarse, fine = (FlexibleNeRFModel(**ARCH) for _ in range(2))
    coarse.load_state_dict(ck["coarse"])
    fine.load_state_dict(ck["fine"])
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR, opt_type=opt_type)
    assert load_optimizer_checkpoint(opt_type, state.optimizer, ck)
    state.step = ck["step"]
    return _port_run(jx, opt_type, draws, state)


@pytest.mark.parametrize("opt_type", OPTIMIZERS)
def test_resume_equals_uninterrupted(jx, tmp_path, opt_type):
    """One update, a ``.ckpt`` with the optimizer's state, a resume, two
    more updates: every parameter and state tensor equal, bit for bit, to
    three uninterrupted updates on the same draws."""
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(5), STEPS))
    draws = [_step_draws(jx, k, store.num_rays) for k in keys]
    whole = _port_run(jx, opt_type, draws)
    first = _port_run(jx, opt_type, draws[:1])
    path = str(tmp_path / "k1.ckpt")
    write_reference_checkpoint(path, first.coarse.state_dict(), first.fine.state_dict(),
                               step=first.step,
                               **optimizer_checkpoint(opt_type, first.optimizer, first.step, LR))
    resumed = _resume(jx, opt_type, path, draws[1:])
    assert resumed.step == whole.step == STEPS
    for a, b in ((whole.coarse, resumed.coarse), (whole.fine, resumed.fine)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), f"{opt_type} {name}"
            sa, sb = whole.optimizer.state[p], resumed.optimizer.state[q]
            assert set(sa) == set(sb)
            for k in sa:
                assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k


@pytest.mark.parametrize("opt_type", OPTIMIZERS)
def test_checkpoint_state_in_jax(jx, tmp_path, opt_type):
    """Adam's and AdamW's moments are the reference Adam block, which JAX's
    importer grafts into its optax state; the others' state is under
    ``PORT_OPTIMIZER_KEY``, which JAX's ``import_torch_checkpoint`` does
    not read (no Adam block, the weights as written)."""
    from dexnerf_tpu.train.checkpoints import build_opt_state_from_torch, import_torch_checkpoint
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer

    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(6), 2))
    state = _port_run(jx, opt_type, [_step_draws(jx, k, store.num_rays) for k in keys])
    path = str(tmp_path / "m.ckpt")
    write_reference_checkpoint(path, state.coarse.state_dict(), state.fine.state_dict(),
                               step=state.step,
                               **optimizer_checkpoint(opt_type, state.optimizer, state.step, LR))
    raw = torch.load(path, map_location="cpu", weights_only=True)
    imported = import_torch_checkpoint(path)
    assert imported["step"] == 2
    assert (PORT_OPTIMIZER_KEY in raw) == (opt_type not in ("Adam", "AdamW"))
    assert ("optimizer_state_dict" in imported) == (opt_type in ("Adam", "AdamW"))
    got = state_dict_from_flax(jx.jax.tree.map(np.asarray, imported["coarse"]))
    for k, v in state.coarse.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    if opt_type in ("Adam", "AdamW"):
        params = {"coarse": imported["coarse"], "fine": imported["fine"]}
        tx = j_optimizer(LR, LR_DECAY, LR_FACTOR, opt_type=opt_type)
        mu = _optax_state(build_opt_state_from_torch(imported, params, tx), "mu")
        mu_sd = state_dict_from_flax(jx.jax.tree.map(np.asarray, mu["fine"]))
        for n, p in state.fine.named_parameters():
            np.testing.assert_array_equal(mu_sd[n].numpy(),
                                          state.optimizer.state[p]["exp_avg"].numpy())
    else:
        entry = raw[PORT_OPTIMIZER_KEY]
        assert entry["type"] == opt_type and entry["step"] == 2


# ---- every family through the training entry point on the CPU

FAMILY_RUNS = {
    # name: (coarse type, fine type, nerf.use_viewdirs, optimizer)
    "paper": ("PaperNeRFModel", "PaperNeRFModel", True, "Adam"),
    "replicate": ("ReplicateNeRFModel", "ReplicateNeRFModel", True, "RMSprop"),
    "multihead": ("MultiHeadNeRFModel", "MultiHeadNeRFModel", True, "Adagrad"),
    "flexible-no-viewdirs": ("FlexibleNeRFModel", "FlexibleNeRFModel", False, "AdamW"),
    "mixed": ("FlexibleNeRFModel", "PaperNeRFModel", True, "SGD"),
}


@pytest.mark.parametrize("run", list(FAMILY_RUNS))
def test_train_cli_every_family(tmp_path, run):
    """``apps.train`` on the CPU with ``nerf.use_pallas`` for 4 updates of
    a config of ``configs/tiny.yml`` with the run's model types, viewdirs
    and optimizer: finite losses, a ``.ckpt`` with the optimizer's state
    that a resume continues from (``use_viewdirs: false`` warns with JAX's
    words and trains plain)."""
    coarse, fine, vd, opt = FAMILY_RUNS[run]
    data = str(tmp_path / "scene")
    write_blender_dataset(data, height=6, width=6, views_per_split=(2, 1, 1))
    with open(os.path.join(ROOT, "configs", "tiny.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["experiment"].update(logdir=str(tmp_path / "logs"), train_iters=4, validate_every=4,
                             save_every=4, print_every=1)
    cfg["dataset"].update(basedir=data, half_res=False)
    cfg["models"]["coarse"]["type"], cfg["models"]["fine"]["type"] = coarse, fine
    cfg["nerf"].update(use_viewdirs=vd, use_pallas=True, pallas_fused_loss=False)
    cfg["nerf"]["train"]["num_random_rays"] = 8
    cfg["optimizer"]["type"] = opt
    path = str(tmp_path / "c.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    if vd:
        assert train_app.main(["--config", path, "--device", "cpu"]) == 0
    else:
        with pytest.warns(UserWarning, match="fused Pallas kernels require viewdirs"):
            assert train_app.main(["--config", path, "--device", "cpu"]) == 0
    logdir = os.path.join(str(tmp_path / "logs"), cfg["experiment"]["id"])
    ckpt = os.path.join(logdir, "checkpoints", "checkpoint_0000003.ckpt")
    saved = read_reference_checkpoint(ckpt)
    assert saved["step"] == 4
    assert ("optimizer_state_dict" in saved) == (opt in ("Adam", "AdamW"))
    assert (PORT_OPTIMIZER_KEY in saved) == (opt not in ("Adam", "AdamW"))
    assert train_app.main(["--config", path, "--device", "cpu", "--max-iters", "5",
                           "--load-checkpoint", ckpt]) == 0
    again = read_reference_checkpoint(os.path.join(logdir, "checkpoints",
                                                   "checkpoint_0000004.ckpt"))
    assert again["step"] == 5
