"""The two training configurations of this slice, held to the JAX package
on the CPU: the field path (``nerf.pallas_fused_loss: false``: the plain
render through the fused fields of ``ops/fused_mlp_train.py``) and the
fused loss with the fused resample between its passes
(``nerf.pallas_loss_resample: pallas``).

Both packages start from one set of weights and one ray store; the JAX
step draws its ray indices and render draws from one key per step and the
port is handed exactly those numbers. After three Adam updates the
parameters and both Adam moments must agree (the JAX kernels in interpret
mode vs the port's plain versions). ``run_training`` then takes a few steps
of each configuration on the CPU, through the paths the config selects.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config import load_config
from dexnerf_tpu_torch.data.blender import pose_spherical
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp_train, resample
from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.loop import maybe_fused_fields, maybe_fused_loss
from dexnerf_tpu_torch.train.step import StepDraws, init_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC_XYZ, ENC_DIR = 3, 2
ARCH = dict(num_layers=8, hidden_size=16, skip_connect_every=3,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
SETTINGS = RenderSettings(
    num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
BATCH = 24
STEPS = 3
LR = 5e-3
LR_DECAY, LR_FACTOR = 0.001, 0.1  # the rate falls 10x per update
# the rule of tests/test_torch_train_step.py: metrics to 1e-5 relative,
# parameters to 2e-3 of lr, both Adam moments to 2e-3 of the leaf's largest
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5
MOMENT_RTOL = 2e-3


@pytest.fixture(scope="module")
def jx():
    """The weights, images, poses and keys of tests/test_torch_train_step.py,
    whose comparison rule (and its note on Adam's first update) this file
    shares."""
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
    poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (-40.0, 50.0)])
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, trees=trees, images=images,
                                 poses=poses, hwf=[4, 6, 7.2])


def _step_draws(jx, key, num_rays):
    """The draws of one JAX train step (``make_train_step``'s key split,
    then ``render_rays``')."""
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


def _run_jax(jx, path, keys):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_field
    from dexnerf_tpu.ops import make_fused_train_loss as j_loss
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train.checkpoints import _find_adam_state
    from dexnerf_tpu.train.step import init_train_state as j_init
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer
    from dexnerf_tpu.train.step import make_train_step as j_make_step

    js = JSettings(**SETTINGS.__dict__)
    store = j_build(jx.images, jx.poses, jx.hwf, 2.0, 6.0)
    tx = j_optimizer(LR, LR_DECAY, LR_FACTOR)
    kw = {}
    if path == "fields":
        field = j_field(jx.jm, block_samples=128, compute_dtype=jx.jnp.float32, interpret=True)
        kw = dict(coarse_field=field, fine_field=field)
    else:
        kw = dict(fused_loss=j_loss(jx.jm, jx.jm, js, block_samples=128, interpret=True,
                                    resample="pallas"))
    step = j_make_step(jx.jm.apply, jx.jm.apply, tx, js, BATCH, **kw)
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
    }, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("path", ["fields", "resample"])
def test_train_steps_match_jax(jx, path, monkeypatch):
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(3), STEPS))
    want, want_metrics = _run_jax(jx, path, keys)

    models = []
    for name in ("coarse", "fine"):
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(jx.trees[name]))
        models.append(m)
    coarse, fine = models
    store = build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
    calls = []
    if path == "fields":
        monkeypatch.setattr(fused_mlp_train, "field_grads_reference",
                            _counted(fused_mlp_train.field_grads_reference, calls))
        kw = dict(coarse_field=make_fused_flexible_field_train(coarse),
                  fine_field=make_fused_flexible_field_train(fine))
    else:
        monkeypatch.setattr(resample, "fused_resample_reference",
                            _counted(resample.fused_resample_reference, calls))
        kw = dict(fused_loss=make_fused_train_loss(coarse, fine, SETTINGS, resample="pallas"))
    step = make_train_step(SETTINGS, BATCH, steps_per_call=STEPS, **kw)
    metrics = step(state, store, draws=[_step_draws(jx, k, store.num_rays) for k in keys])
    # the field path's backward runs once per pass, the resample once per step
    assert len(calls) == (2 if path == "fields" else 1) * STEPS
    assert set(metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], rtol=METRIC_RTOL, err_msg=k)
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


def _counted(fn, calls):
    def wrapped(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)

    return wrapped


def _config(tmp_path, data, **nerf):
    with open(os.path.join(ROOT, "configs", "tiny.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["experiment"].update(logdir=str(tmp_path / "logs"), train_iters=3,
                             validate_every=3, save_every=0, print_every=1)
    cfg["dataset"].update(basedir=data, half_res=False)
    for blk in ("coarse", "fine"):
        cfg["models"][blk].update(num_layers=4, hidden_size=16, skip_connect_every=2)
    cfg["nerf"].update(use_pallas=True, **nerf)
    path = str(tmp_path / "tiny.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, os.path.join(cfg["experiment"]["logdir"], cfg["experiment"]["id"])


@pytest.mark.parametrize("nerf", [dict(pallas_fused_loss=False),
                                  dict(pallas_loss_resample="pallas")],
                         ids=["fields", "resample"])
def test_run_training_on_cpu(tmp_path, monkeypatch, nerf):
    """``apps.train`` on the CPU for three steps of each configuration:
    the loop selects the fused fields (no fused loss) or the fused loss
    with the fused resample, every step goes through them, and the losses
    are finite."""
    data = str(tmp_path / "scene")
    write_blender_dataset(data, height=8, width=8, views_per_split=(2, 1, 1))
    cfg_path, logdir = _config(tmp_path, data, **nerf)
    cfg = load_config(cfg_path)
    coarse, fine = FlexibleNeRFModel(**ARCH), FlexibleNeRFModel(**ARCH)
    fields = maybe_fused_fields(cfg, coarse, fine, train=True)
    loss = maybe_fused_loss(cfg, SETTINGS, "rgb", coarse, fine)
    assert (loss is None) == ("pallas_fused_loss" in nerf)
    assert all(f is not None for f in fields)
    calls = []
    if "pallas_fused_loss" in nerf:
        monkeypatch.setattr(fused_mlp_train, "field_grads_reference",
                            _counted(fused_mlp_train.field_grads_reference, calls))
    else:
        monkeypatch.setattr(resample, "fused_resample_reference",
                            _counted(resample.fused_resample_reference, calls))
    assert train_app.main(["--config", cfg_path, "--device", "cpu"]) == 0
    assert len(calls) == (6 if "pallas_fused_loss" in nerf else 3)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["value"] for r in recs if r["tag"] == "train/loss"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert any(r["tag"] == "validation/psnr" for r in recs)


def test_unknown_resample_raises():
    m = FlexibleNeRFModel(**ARCH)
    with pytest.raises(ValueError, match="resample"):
        make_fused_train_loss(m, m, SETTINGS, resample="sorted")
