"""Data-parallel training and tiled frames in the port (``parallel/mesh.py``,
``parallel/sharding.py``, ``run_training(num_devices=)``, ``apps.train
--num-devices``) held to the JAX package's ``shard_map`` versions on a
2-device CPU mesh: two gloo ranks on the CPU, started once for every case
(one spawn, a few seconds), each given JAX's per-device draws
(``fold_in(key, axis_index)`` then ``split``) and the same weights.

Cases: the plain path with uniform and with per_image sampling, the fused
loss (the port's plain version of kernel 4 against JAX's kernel in
interpret mode), the pose step and one ``--sg-ir`` step, two updates each
(one for sg-ir), and ``render_image_parallel`` on a frame whose rays do
not divide by 2. Tolerances: losses to LOSS_RTOL and parameters to
PARAM_ATOL after the updates (``tests/test_torch_train_step.py``'s), the
frame to VALUE_ATOL (``tests/test_torch_pose_opt.py``'s); the ranks'
parameters equal in every bit. Every spawn has a timeout.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.parallel import mesh as pmesh
from dexnerf_tpu_torch.parallel import sharding
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import StepDraws, init_train_state

LOSS_RTOL, PARAM_ATOL, VALUE_ATOL = 1e-5, 1e-5, 2e-5
SPAWN_TIMEOUT = 240.0
ENC_XYZ, ENC_DIR = 2, 1
ARCH = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=ENC_XYZ,
            num_encoding_fn_dir=ENC_DIR)
SETTINGS = dict(num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.1,
                num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
GLOBAL_BATCH, LR, POSE_LR = 16, 5e-3, 1e-3
HWF, NEAR, FAR = [8, 8, 10.0], 2.0, 6.0
STEPS = 2
# case -> (sampling, loss, updates)
CASES = {
    "uniform": ("uniform", "plain", STEPS),
    "per_image": ("per_image", "plain", STEPS),
    "fused": ("uniform", "fused", STEPS),
    "pose": ("uniform", "pose", STEPS),
    "sg_ir": ("uniform", "sg_ir", 1),
}
FRAME = (5, 7)  # 35 rays: one padded ray over 2 ranks


def _scene():
    rng = np.random.RandomState(1)
    images = rng.rand(2, HWF[0], HWF[1], 3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 4.0
    poses[1, 0, 3] = 0.3
    return images, poses


def _models(weights):
    models = []
    for name in ("coarse", "fine"):
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict({k: torch.tensor(v) for k, v in weights[name].items()})
        models.append(m)
    return models


def _rank_cases(mesh, payload):
    """Every case on this rank: the steps on this rank's draws, then the
    tiled frame. Returns numpy results."""
    from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
    from dexnerf_tpu_torch.render.sg_ir import make_sg_ir_loss
    from dexnerf_tpu_torch.train.pose_opt import build_pose_ray_store, init_pose_state

    s = RenderSettings(**SETTINGS)
    images, poses = payload["scene"]
    out = {}
    for name, (sampling, loss, _) in CASES.items():
        coarse, fine = _models(payload["weights"])
        sg = None
        if loss == "sg_ir":
            sg = {k: torch.tensor(v) for k, v in payload["sg"].items()}
        state = init_train_state(coarse, fine, LR, sg=sg)
        kw = dict(sampling=sampling)
        if loss == "pose":
            state.pose = init_pose_state(len(images), POSE_LR, 250.0, 0.1, "cpu")
            store = build_pose_ray_store(images, poses, HWF, NEAR, FAR, device="cpu")
            step = sharding.make_parallel_pose_train_step(mesh, s, GLOBAL_BATCH, **kw)
        else:
            store = build_ray_store(images, poses, HWF, NEAR, FAR, device="cpu")
            if loss == "fused":
                kw["fused_loss"] = make_fused_train_loss(coarse, fine, s)
            elif loss == "sg_ir":
                kw["fused_loss"] = make_sg_ir_loss(coarse, fine, sg, s)
            step = sharding.make_parallel_train_step(mesh, s, GLOBAL_BATCH, **kw)
        metrics = []
        for per_rank in payload["draws"][name]:
            idx, render = per_rank[mesh.rank]
            d = StepDraws(torch.tensor(idx),
                          RenderDraws(*[None if t is None else torch.tensor(t) for t in render]))
            metrics.append({k: float(v) for k, v in step(state, store, draws=[d]).items()})
        params = {n: {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
                  for n, m in (("coarse", coarse), ("fine", fine))}
        if sg is not None:
            params["sg"] = {k: v.detach().numpy().copy() for k, v in sg.items()}
        if state.pose is not None:
            params["pose"] = state.pose.twists.detach().numpy().copy()
        out[name] = {"metrics": metrics, "params": params}
    coarse, fine = _models(payload["weights"])
    ro, rd = (torch.tensor(x) for x in payload["frame"])
    frame = sharding.render_image_parallel(mesh, coarse, fine, ro, rd, NEAR, FAR,
                                           RenderSettings(**SETTINGS), chunk=8)
    out["frame"] = {p: {k: None if v is None else v.numpy() for k, v in o._asdict().items()}
                    for p, o in (("coarse", frame.coarse), ("fine", frame.fine))}
    # a step on the generator, as the single-device step at the global batch draws it
    coarse, fine = _models(payload["weights"])
    state = init_train_state(coarse, fine, LR)
    store = build_ray_store(images, poses, HWF, NEAR, FAR, device="cpu")
    m = sharding.make_parallel_train_step(mesh, s, GLOBAL_BATCH)(
        state, store, torch.Generator().manual_seed(3))
    out["global"] = {"loss": float(m["loss"]), "params": [
        p.detach().numpy().copy() for p in state.optimizer.param_groups[0]["params"]]}
    return out


def _rank_local(jx, key, d, local, num_images, rays_per_image, sampling):
    """JAX's per-device draws of one step (``make_parallel_train_step``'s
    ``local_grads``) for device ``d``, as numpy."""
    jax, jnp = jx.jax, jx.jnp
    if sampling == "per_image":
        k_img, key = jax.random.split(key)
        key = jax.random.fold_in(key, d)
        k_pix, k_render = jax.random.split(key)
        img = jax.random.randint(k_img, (), 0, num_images)
        idx = img * rays_per_image + jax.random.randint(k_pix, (local,), 0, rays_per_image)
    else:
        key = jax.random.fold_in(key, d)
        k_sample, k_render = jax.random.split(key)
        idx = jax.random.randint(k_sample, (local,), 0, num_images * rays_per_image)
    k_strat, k_nc, k_fine, k_nf = jax.random.split(k_render, 4)
    c, f, std = SETTINGS["num_coarse"], SETTINGS["num_fine"], SETTINGS["radiance_field_noise_std"]
    render = tuple(np.asarray(x) for x in (
        jax.random.uniform(k_strat, (local, c), dtype=jnp.float32),
        std * jax.random.normal(k_nc, (local, c), dtype=jnp.float32),
        jax.random.uniform(k_fine, (local, f), dtype=jnp.float32),
        std * jax.random.normal(k_nf, (local, c + f), dtype=jnp.float32)))
    return np.asarray(idx).astype(np.int64), render


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import types

    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.parallel import make_mesh
    from dexnerf_tpu.render.sg_ir import init_sg_ir_params

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    key = jax.random.PRNGKey(0)
    params = {"coarse": jm.init(key, jnp.ones((1, in_dim))),
              "fine": jm.init(jax.random.fold_in(key, 1), jnp.ones((1, in_dim)))}
    params = jax.tree.map(np.asarray, params)
    sg = jax.tree.map(np.asarray, init_sg_ir_params(jax.random.fold_in(key, 7)))
    keys = {name: list(jax.random.split(jax.random.PRNGKey(10 + i), CASES[name][2]))
            for i, name in enumerate(CASES)}
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, params=params, sg=sg, keys=keys,
                                 mesh=make_mesh(2))


@pytest.fixture(scope="module")
def port(jx):
    """One spawn of two gloo ranks running every case; by rank."""
    images, poses = _scene()
    rpi = HWF[0] * HWF[1]
    local = GLOBAL_BATCH // 2
    draws = {name: [[_rank_local(jx, k, d, local, len(images), rpi, sampling) for d in range(2)]
                    for k in jx.keys[name]]
             for name, (sampling, _, _) in CASES.items()}
    rng = np.random.default_rng(4)
    ro = (rng.normal(size=(*FRAME, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(*FRAME, 3)).astype(np.float32)
    payload = {
        "scene": (images, poses), "draws": draws, "sg": jx.sg, "frame": (ro, rd),
        "weights": {n: {k: v.numpy() for k, v in state_dict_from_flax(jx.params[n]).items()}
                    for n in ("coarse", "fine")},
    }
    return pmesh.spawn_ranks(_rank_cases, 2, "cpu", (payload,), timeout=SPAWN_TIMEOUT)


def _jax_case(jx, name):
    """JAX's ``make_parallel_train_step`` (or the pose step) on the 2-device
    mesh: the metrics of each update and the final parameters."""
    import optax

    from dexnerf_tpu.data import build_ray_store as j_build
    from dexnerf_tpu.ops import make_fused_train_loss as j_fused
    from dexnerf_tpu.parallel import make_parallel_pose_train_step, make_parallel_train_step
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render.sg_ir import make_sg_ir_loss as j_sg_loss
    from dexnerf_tpu.train import init_train_state as j_init
    from dexnerf_tpu.train import make_optimizer
    from dexnerf_tpu.train.pose_opt import (
        build_pose_ray_store,
        init_pose_params,
        make_pose_optimizer,
    )
    from dexnerf_tpu.train.step import exponential_decay_schedule

    jax, jnp = jx.jax, jx.jnp
    sampling, loss, _ = CASES[name]
    images, poses = _scene()
    js = JSettings(**SETTINGS)
    params = jax.tree.map(jnp.asarray, jx.params)
    tx = make_optimizer(LR)
    kw = dict(sampling=sampling)
    if loss == "pose":
        params["pose"] = init_pose_params(len(images))
        tx = make_pose_optimizer(tx, optax.adam(exponential_decay_schedule(POSE_LR, 250.0, 0.1)))
        store = build_pose_ray_store(images, poses, HWF, NEAR, FAR)
        step = make_parallel_pose_train_step(jx.mesh, jx.jm.apply, jx.jm.apply, tx, js,
                                             GLOBAL_BATCH, **kw)
    else:
        store = j_build(images, poses, HWF, NEAR, FAR)
        if loss == "fused":
            kw["fused_loss"] = j_fused(jx.jm, jx.jm, js, block_samples=32, interpret=True)
        elif loss == "sg_ir":
            params["sg"] = jax.tree.map(jnp.asarray, jx.sg)
            kw["fused_loss"] = j_sg_loss(jx.jm, jx.jm, js)
        step = make_parallel_train_step(jx.mesh, jx.jm.apply, jx.jm.apply, tx, js, GLOBAL_BATCH,
                                        **kw)
    state = j_init(params, tx)
    metrics = []
    for k in jx.keys[name]:
        state, m = step(state, store, k)
        metrics.append({key: float(v) for key, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_steps_match_jax(jx, port, name):
    """Each case's updates on two gloo ranks against JAX's 2-device
    ``shard_map`` step on the same draws: the averaged metrics of each
    update, every final parameter (the SG leaves and the twists with them),
    and the two ranks' parameters equal in every bit."""
    want_metrics, want = _jax_case(jx, name)
    got = [r[name] for r in port]
    for a, b in zip(got[0]["params"].values(), got[1]["params"].values()):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict) else [(a, b)]):
            assert np.array_equal(x, y), "the ranks' parameters differ"
    assert len(got[0]["metrics"]) == len(want_metrics)
    for m, w in zip(got[0]["metrics"], want_metrics):
        assert set(w) <= set(m)
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for n in ("coarse", "fine"):
        ref = state_dict_from_flax(want[n])
        for k, v in got[0]["params"][n].items():
            np.testing.assert_allclose(v, ref[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name} {n}.{k}")
    if "sg" in want:
        for k, v in got[0]["params"]["sg"].items():
            np.testing.assert_allclose(v, want["sg"][k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    if "pose" in want:
        assert np.abs(want["pose"]).max() > 0
        np.testing.assert_allclose(got[0]["params"]["pose"], want["pose"], rtol=0,
                                   atol=PARAM_ATOL)


def test_render_image_parallel_matches_jax(jx, port):
    """The tiled frame (35 rays, one padded) on both ranks against JAX's
    ``render_image_parallel`` on the 2-device mesh: every map of both
    passes, and both ranks hold the whole frame. Where a ray accumulates
    nothing JAX's disparity is NaN and the port's the finite 1e10
    (``tests/test_torch_core.py::test_disparity_finite_where_acc_is_zero``)."""
    from dexnerf_tpu.parallel import render_image_parallel as j_render
    from dexnerf_tpu.render import RenderSettings as JSettings

    rng = np.random.default_rng(4)
    ro = (rng.normal(size=(*FRAME, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(*FRAME, 3)).astype(np.float32)
    want = j_render(jx.mesh, jx.jm.apply, jx.jm.apply, jx.params, jx.jnp.asarray(ro),
                    jx.jnp.asarray(rd), NEAR, FAR, JSettings(**SETTINGS), block_size=8)
    for p in ("coarse", "fine"):
        w = getattr(want, p)
        for k, v in port[0]["frame"][p].items():
            if v is None:
                assert getattr(w, k) is None
                continue
            assert v.shape == np.shape(getattr(w, k)), (p, k)
            assert np.array_equal(v, port[1]["frame"][p][k]), (p, k)
            ref = np.asarray(getattr(w, k))
            if k == "disparity":
                empty = np.isnan(ref)
                assert np.array_equal(empty, port[0]["frame"][p]["accumulation"] == 0.0)
                assert (v[empty] == 1e10).all()
                v, ref = v[~empty], ref[~empty]
            np.testing.assert_allclose(v, ref, rtol=VALUE_ATOL, atol=VALUE_ATOL,
                                       err_msg=f"{p}.{k}")


def test_two_ranks_equal_one_process_at_the_global_batch(jx, port):
    """``local_draws``: two ranks on one generator take the single-device
    step's batch, so their update is that step's (to PARAM_ATOL)."""
    from dexnerf_tpu_torch.train.step import make_train_step

    images, poses = _scene()
    weights = {n: {k: v.numpy() for k, v in state_dict_from_flax(jx.params[n]).items()}
               for n in ("coarse", "fine")}
    got = [r["global"] for r in port]
    coarse, fine = _models(weights)
    state = init_train_state(coarse, fine, LR)
    store = build_ray_store(images, poses, HWF, NEAR, FAR, device="cpu")
    m = make_train_step(RenderSettings(**SETTINGS), GLOBAL_BATCH)(
        state, store, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got[0]["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    for a, b, p in zip(got[0]["params"], got[1]["params"], state.optimizer.param_groups[0]
                       ["params"]):
        assert np.array_equal(a, b)
        np.testing.assert_allclose(a, p.detach().numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("flags", [[], ["--sg-ir"], ["--pose-opt"]],
                         ids=["rgb", "sg-ir", "pose-opt"])
def test_cli_num_devices_end_to_end(tmp_path, monkeypatch, flags):
    """``apps.train --num-devices 2 --device cpu`` (and with ``--sg-ir``,
    whose shaded loss is each rank's, as in JAX, or ``--pose-opt``, through
    ``make_parallel_pose_train_step``): two gloo ranks train from
    a written scene, rank 0 alone logs (each step once) and writes the
    checkpoint, validation tiled over the ranks; ``run_training``'s
    returned state is the checkpoint's, the SG leaves' included."""
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
    from test_torch_depth import tiny_cfg

    data = str(tmp_path / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(2, 1, 1))
    raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
    raw["experiment"].update(id="dp", train_iters=3, validate_every=3, save_every=3)
    cfg = str(tmp_path / "dp.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    outs, run = [], ploop.run_training
    monkeypatch.setattr(ploop, "run_training", lambda *a, **k: outs.append(run(*a, **k)) or outs[-1])
    # the product's spawn has no deadline; the suite's has SPAWN_TIMEOUT
    spawn = pmesh.spawn_ranks
    monkeypatch.setattr(pmesh, "spawn_ranks",
                        lambda *a, **k: spawn(*a, **{"timeout": SPAWN_TIMEOUT, **k}))
    assert train_app.main(["--config", cfg, "--device", "cpu", "--num-devices", "2",
                           *flags]) == 0
    logdir = tmp_path / "logs" / "dp"
    with open(logdir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if r["tag"] == "train/loss"]
    assert [r["step"] for r in losses] == [0, 1, 2]
    assert all(np.isfinite(r["value"]) for r in losses)
    psnr = [r["value"] for r in recs if r["tag"] == "validation/psnr"]
    assert len(psnr) == 2 and all(np.isfinite(psnr))
    assert os.listdir(logdir / "checkpoints") == ["checkpoint_0000002.ckpt"]
    ck = ploop.read_reference_checkpoint(str(logdir / "checkpoints" / "checkpoint_0000002.ckpt"))
    (out,) = outs
    assert out["state"].step == ck["step"] == 3
    assert out["final_train_metrics"]["loss"] == pytest.approx(losses[-1]["value"])
    for name in ("coarse", "fine"):
        for k, v in getattr(out["state"], name).state_dict().items():
            assert torch.equal(v, ck[name][k])
    if flags == ["--pose-opt"]:
        from dexnerf_tpu_torch.train.checkpoints import POSE_KEY

        assert torch.equal(out["state"].pose.twists.detach(), ck[POSE_KEY]["twists"])
        assert bool(ck[POSE_KEY]["twists"].abs().sum() > 0)
    elif flags:
        from dexnerf_tpu_torch.train.checkpoints import SG_KEY

        assert set(out["state"].sg) == set(ck[SG_KEY]["params"])
        for k, v in out["state"].sg.items():
            assert torch.equal(v.detach(), ck[SG_KEY]["params"][k])
            assert int(ck[SG_KEY]["state"][k]["step"]) == 3


class _Spawned(Exception):
    pass


def test_run_training_spawns_without_a_deadline(tmp_path, monkeypatch):
    """``run_training(num_devices=2)`` starts its ranks with no deadline on
    the run's whole life (``spawn_ranks``' default): a real training run
    lasts as long as its iterations take, and only the process group's
    collectives wait a bounded time."""
    import inspect

    from test_torch_depth import tiny_cfg

    assert inspect.signature(pmesh.spawn_ranks).parameters["timeout"].default is None
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        raise _Spawned

    monkeypatch.setattr(pmesh, "spawn_ranks", recorder)
    images, poses = _scene()
    scene = ploop.SceneData(images=images, poses=poses, hwf=HWF, i_train=np.array([0]),
                            i_val=np.array([1]))
    raw = tiny_cfg({"type": "blender", "basedir": str(tmp_path)}, str(tmp_path / "logs"))
    with pytest.raises(_Spawned):
        ploop.run_training(CfgNode(raw), scene=scene, device="cpu", num_devices=2)
    ((args, kwargs),) = calls
    assert args[1:3] == (2, "cpu")
    assert kwargs.get("timeout") is None


@pytest.mark.parametrize("case", ["uneven-batch", "depth-warmup", "host-store", "too-many"])
def test_parallel_refusals_match_jax(jx, tmp_path, case):
    """JAX's refusals, word for word: a global batch the ranks do not
    divide, a depth warmup or the host store with more than one device, and
    more devices than the machine has (whose count is each package's own)."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.parallel import make_mesh as j_make_mesh
    from dexnerf_tpu.parallel import make_parallel_train_step as j_step
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train import SceneData as JScene
    from dexnerf_tpu.train import make_optimizer
    from dexnerf_tpu.train import run_training as j_run
    from test_torch_depth import tiny_cfg

    if case == "uneven-batch":
        fake = pmesh.Mesh(rank=0, world_size=3, device=torch.device("cpu"), group=None,
                          backend="gloo")
        with pytest.raises(ValueError) as got:
            sharding.make_parallel_train_step(fake, RenderSettings(**SETTINGS), 16)
        with pytest.raises(ValueError) as want:
            j_step(j_make_mesh(3), jx.jm.apply, jx.jm.apply, make_optimizer(LR),
                   JSettings(**SETTINGS), 16)
        assert str(got.value) == str(want.value)
        return
    if case == "too-many":
        with pytest.raises(ValueError, match=r"requested 1000 devices, have \d+$"):
            pmesh.mesh_devices(1000, "cpu")
        with pytest.raises(ValueError, match=r"requested 1000 devices, have \d+$"):
            j_make_mesh(1000)
        with pytest.raises(ValueError, match=r"requested 2 devices, have 1$"):
            pmesh.mesh_devices(2, "cuda", devices=["cuda:0"])
        return
    images, poses = _scene()
    fields = dict(images=images, poses=poses, hwf=HWF, i_train=np.array([0]),
                  i_val=np.array([1]), depths=np.full((2, 8, 8), 4.0, np.float32))
    raw = tiny_cfg({"type": "blender", "basedir": str(tmp_path)}, str(tmp_path / "logs"))
    kw = dict(num_devices=2)
    if case == "depth-warmup":
        kw.update(depth_loss_weight=0.1, depth_warmup=5)
    else:
        raw["dataset"]["host_store"] = True
    with pytest.raises(ValueError) as got:
        ploop.run_training(CfgNode(raw), scene=ploop.SceneData(**fields), device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        j_run(JCfg(raw), scene=JScene(**fields), use_tensorboard=False, **kw)
    assert str(got.value) == str(want.value)
