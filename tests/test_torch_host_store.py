"""The host-streamed ray store of the port (``data/host_store.py``,
``ops/host_rows.py``, ``train/step.py::make_batch_train_step`` and
``run_training``'s host-store branch), held to the JAX package on the CPU.

Tolerances: the host rows equal the port's resident store bit for bit,
and JAX's host rows bit for bit on c2w and NDC rays, within RAY_ATOL on
w2c rays (the port inverts w2c in float64, JAX in float32); the pose
tables equal JAX's; the unpacked rays equal JAX's jitted unpack and the
host rows of the same rays within RAY_ATOL + RAY_RTOL (XLA fuses the ray
math; the unpack divides per ray) and the targets and depths exactly; the
loaders give JAX's index stream, so their batches equal JAX's; one batch
step's loss within LOSS_RTOL of JAX's and its parameters within
PARAM_ATOL (``tests/test_torch_train_step.py``'s); ``run_training``'s
losses within LOSS_RTOL of JAX's on both wires; the unpacked target
within PACKED_ATOL of the rows' (u8 * (1 / 255), an ulp from the 8-bit
image); the packed step against the rows step over 3 updates within
PACKED_LOSS_RTOL (losses), PACKED_GRAD_RTOL (the first gradients) and
PACKED_PARAM_ATOL (parameters); the native
ops equal numpy and the JAX package's native library bit for bit.

    python -m pytest tests/test_torch_host_store.py
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from test_torch_train_step import ARCH, BATCH, LR, LR_DECAY, LR_FACTOR, SETTINGS
from test_torch_train_step import _port_models, _step_draws, jx  # noqa: F401

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.data import host_store as hs
from dexnerf_tpu_torch.data.blender import pose_spherical
from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.ops import host_rows
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import (
    init_train_state,
    make_batch_train_step,
    make_train_step,
)

RAY_ATOL = 1e-6
RAY_RTOL = 1e-6  # the unpack's NDC rays, magnitudes to ~30: 2 ulp
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
PACKED_ATOL = 1e-6
# the packed step against the rows step over 3 updates on 8-bit pixels: each
# loss, the first update's gradients (over the largest gradient entry of the
# step), the parameters (measured: 1.6e-7 of the loss, 3.3e-7 of the largest
# gradient, 4.6e-6 on a parameter)
PACKED_LOSS_RTOL, PACKED_GRAD_RTOL, PACKED_PARAM_ATOL = 1e-6, 1e-5, 1e-5
CONVENTIONS = ("c2w", "w2c", "ndc")


def _views(n_img=3, H=5, W=6):
    """u8-sourced images, c2w poses (orbit views), K, depths."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n_img, H, W, 3)).astype(np.float32) / 255.0
    poses = np.stack([pose_spherical(a, -30.0 + 5 * i, 4.0)
                      for i, a in enumerate(np.linspace(-60, 60, n_img))]).astype(np.float32)
    K = np.tile(np.array([[8.0, 0, 3.0], [0, 8.0, 2.5], [0, 0, 1]], np.float32), (n_img, 1, 1))
    depths = rng.uniform(2.0, 6.0, (n_img, H, W)).astype(np.float32)
    return images, poses, [H, W, 8.0], K, depths


def _kw(convention, K):
    return {"c2w": {}, "w2c": {"intrinsics": K}, "ndc": {"use_ndc": True}}[convention]


@pytest.fixture(scope="module")
def jax():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return jax


# ---- the host rows, the tables, the unpack


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_host_rows_match_resident_store_and_jax(jax, convention, tmp_path):
    """One image at a time into host memory (and into a ``numpy.memmap``):
    the resident store's rows bit for bit; JAX's host rows bit for bit
    (w2c: within RAY_ATOL) with the same depth."""
    from dexnerf_tpu.data.host_store import build_host_ray_rows as j_rows

    images, poses, hwf, K, depths = _views()
    kw = _kw(convention, K)
    rows, depth = hs.build_host_ray_rows(images, poses, hwf, device="cpu", depths=depths, **kw)
    store = build_ray_store(images, poses, hwf, 2.0, 6.0, device="cpu", depths=depths, **kw)
    np.testing.assert_array_equal(rows, store.data.numpy())
    np.testing.assert_array_equal(depth, store.depth.numpy())
    mm = np.lib.format.open_memmap(str(tmp_path / "rows.npy"), "w+", np.float32, rows.shape)
    assert hs.build_host_ray_rows(images, poses, hwf, device="cpu", out=mm, **kw)[0] is mm
    np.testing.assert_array_equal(np.asarray(mm), rows)
    want, want_depth = j_rows(images, poses, hwf, depths=depths, **kw)
    np.testing.assert_array_equal(depth, want_depth)
    np.testing.assert_array_equal(rows[:, 9:], want[:, 9:])
    if convention == "w2c":
        np.testing.assert_allclose(rows, want, rtol=0, atol=RAY_ATOL)
    else:
        np.testing.assert_array_equal(rows, want)
    with pytest.raises(ValueError, match="out has shape"):
        hs.build_host_ray_rows(images, poses, hwf, device="cpu", out=np.empty((3, 12), np.float32))


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_pose_tables_and_unpack_match_jax(jax, convention):
    """``build_pose_tables`` equal to JAX's (fx for both axes included);
    ``make_ray_unpack`` on the same idx / rgb / depth against JAX's jitted
    unpack, and against the host rows of the same rays."""
    from dexnerf_tpu.data.host_store import build_pose_tables as j_tables
    from dexnerf_tpu.data.host_store import images_to_u8 as j_u8
    from dexnerf_tpu.data.host_store import make_ray_unpack as j_unpack

    images, poses, hwf, K, depths = _views()
    kw = _kw(convention, K)
    got, want = hs.build_pose_tables(poses, hwf, **kw), j_tables(poses, hwf, **kw)
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    u8 = hs.images_to_u8(images)
    np.testing.assert_array_equal(u8, j_u8(images))
    idx = np.random.default_rng(1).integers(0, u8.shape[0], 64)
    d = depths.reshape(-1)[idx]
    rays, target, depth = hs.make_ray_unpack(got, 2.0, 6.0)(
        {"idx": torch.tensor(idx, dtype=torch.int32), "rgb": torch.tensor(u8[idx]),
         "depth": torch.tensor(d)})
    j_rays, j_target, j_depth = jax.jit(j_unpack(want, 2.0, 6.0))(
        {"idx": idx.astype(np.uint32), "rgb": u8[idx], "depth": d})
    for name in ("origins", "directions", "viewdirs", "near", "far"):
        np.testing.assert_allclose(getattr(rays, name).numpy(), np.asarray(getattr(j_rays, name)),
                                   rtol=RAY_RTOL, atol=RAY_ATOL, err_msg=name)
    np.testing.assert_array_equal(target.numpy(), np.asarray(j_target))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(j_depth))
    rows, _ = hs.build_host_ray_rows(images, poses, hwf, device="cpu", **kw)
    for name, cols in (("origins", slice(0, 3)), ("directions", slice(3, 6)),
                       ("viewdirs", slice(6, 9))):
        np.testing.assert_allclose(getattr(rays, name).numpy(), rows[idx, cols],
                                   rtol=RAY_RTOL, atol=RAY_ATOL, err_msg=name)
    np.testing.assert_allclose(target.numpy(), rows[idx, 9:], rtol=0, atol=PACKED_ATOL)


# ---- the loaders


def test_loaders_give_jax_batches(jax):
    """The same seed gives JAX's index stream on both wires: five batches
    of each loader equal JAX's loader's, the rows wire's near/far included;
    the loaders prefetch (a thread, a queue), close, and refuse bad
    stores."""
    from dexnerf_tpu.data.host_store import HostPixelLoader as JPixel
    from dexnerf_tpu.data.host_store import HostRayLoader as JRay

    images, poses, hwf, K, depths = _views()
    rows, depth = hs.build_host_ray_rows(images, poses, hwf, device="cpu", depths=depths)
    u8 = hs.images_to_u8(images)
    with hs.HostRayLoader(rows, 2.0, 6.0, 32, seed=7, depth=depth, prefetch=3,
                          device="cpu") as rl, \
            JRay(rows, 2.0, 6.0, 32, seed=7, depth=depth) as jrl, \
            hs.HostPixelLoader(u8, 32, seed=7, depth=depth, device="cpu") as pl, \
            JPixel(u8, 32, seed=7, depth=depth) as jpl:
        assert rl.num_rays == pl.num_rays == rows.shape[0]
        assert (rl.bytes_per_ray, pl.bytes_per_ray) == (48 + 4, 4 + 3 + 4)  # with depth
        for _ in range(5):
            (rays, target, d), (j_rays, j_target, j_d) = next(rl), next(jrl)
            for name in ("origins", "directions", "viewdirs", "near", "far"):
                np.testing.assert_array_equal(getattr(rays, name).numpy(),
                                              np.asarray(getattr(j_rays, name)))
            np.testing.assert_array_equal(target.numpy(), np.asarray(j_target))
            np.testing.assert_array_equal(d.numpy(), np.asarray(j_d))
            packed, j_packed = next(pl), next(jpl)
            assert sorted(packed) == sorted(j_packed) == ["depth", "idx", "rgb"]
            assert packed["idx"].dtype == torch.int32 and packed["rgb"].dtype == torch.uint8
            for k in packed:
                np.testing.assert_array_equal(packed[k].numpy(),
                                              np.asarray(j_packed[k]).astype(packed[k].numpy()
                                                                             .dtype))
        assert rl._thread.is_alive() and rl._q.maxsize == 3
    assert not rl._thread.is_alive() and not pl._thread.is_alive()
    with pytest.raises(ValueError, match="rows must be"):
        hs.HostRayLoader(rows[:, :9], 2.0, 6.0, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="rgb_u8 must be"):
        hs.HostPixelLoader(u8.astype(np.float32), 4, 0, device="cpu")


# ---- the batch step


def _j_batch(jx, fused: bool, depth_weight: float, packed: bool):
    """JAX's batch step and its state from ``jx``'s weights."""
    from dexnerf_tpu.data.host_store import build_pose_tables as j_tables
    from dexnerf_tpu.data.host_store import make_ray_unpack as j_unpack
    from dexnerf_tpu.ops import make_fused_train_loss as j_make_loss
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train.step import init_train_state as j_init
    from dexnerf_tpu.train.step import make_batch_train_step as j_make_batch
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer

    js = JSettings(**SETTINGS.__dict__)
    tx = j_optimizer(LR, LR_DECAY, LR_FACTOR)
    fused_loss = (j_make_loss(jx.jm, jx.jm, js, block_samples=128, interpret=True,
                              depth_loss_weight=depth_weight) if fused else None)
    unpack = j_unpack(j_tables(jx.poses, jx.hwf), 2.0, 6.0) if packed else None
    step = j_make_batch(jx.jm.apply, jx.jm.apply, tx, js, fused_loss=fused_loss,
                        depth_loss_weight=depth_weight, unpack=unpack)
    return step, j_init(jx.jax.tree.map(jx.jnp.asarray, jx.trees), tx)


@pytest.mark.parametrize("wire,path,depth", [("rows", "plain", False), ("rows", "fused", True),
                                             ("packed", "plain", True)],
                         ids=["rows-plain", "rows-fused-depth", "packed-plain-depth"])
def test_batch_step_matches_jax(jx, wire, path, depth):  # noqa: F811
    """One batch (JAX's draws of one key: its indices' rows or packed
    pixels, its render draws) through JAX's ``make_batch_train_step`` and
    the port's: the loss and the updated parameters."""
    fused, dw = path == "fused", 0.5 if depth else 0.0
    step_j, state_j = _j_batch(jx, fused, dw, wire == "packed")
    key = jx.jax.random.PRNGKey(3)
    d = _step_draws(jx, key, jx.images.shape[0] * jx.hwf[0] * jx.hwf[1])
    idx = d.idx.numpy()
    depth_flat = jx.depths.reshape(-1)
    if wire == "rows":
        rows, _ = hs.build_host_ray_rows(jx.images, jx.poses, jx.hwf, device="cpu")
        j_rows = rows[idx]
        from dexnerf_tpu.render.renderer import RayBatch as JRayBatch

        j_rays = JRayBatch(origins=j_rows[:, 0:3], directions=j_rows[:, 3:6],
                           viewdirs=j_rows[:, 6:9], near=np.full((BATCH,), 2.0, np.float32),
                           far=np.full((BATCH,), 6.0, np.float32))
        state_j, metrics_j = step_j(state_j, j_rays, j_rows[:, 9:12], key,
                                    *((depth_flat[idx],) if depth else ()))
    else:
        u8 = hs.images_to_u8(jx.images)
        packed_j = {"idx": idx.astype(np.uint32), "rgb": u8[idx],
                    **({"depth": depth_flat[idx]} if depth else {})}
        state_j, metrics_j = step_j(state_j, packed_j, key)
    coarse, fine = _port_models(jx)
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
    fused_loss = (make_fused_train_loss(coarse, fine, SETTINGS, depth_loss_weight=dw)
                  if fused else None)
    if wire == "rows":
        step = make_batch_train_step(SETTINGS, fused_loss=fused_loss, depth_loss_weight=dw)
        rays, target = take_ray_batch(build_ray_store(jx.images, jx.poses, jx.hwf, 2.0, 6.0,
                                                      device="cpu"), d.idx)
        metrics = step(state, rays, target, draws=d.render,
                       depth_gt=torch.tensor(depth_flat[idx]) if depth else None)
    else:
        unpack = hs.make_ray_unpack(hs.build_pose_tables(jx.poses, jx.hwf), 2.0, 6.0)
        step = make_batch_train_step(SETTINGS, fused_loss=fused_loss, depth_loss_weight=dw,
                                     unpack=unpack)
        packed = {"idx": d.idx.to(torch.int32), "rgb": torch.tensor(u8[idx]),
                  **({"depth": torch.tensor(depth_flat[idx])} if depth else {})}
        metrics = step(state, packed, draws=d.render)
    np.testing.assert_allclose(float(metrics["loss"]), float(metrics_j["loss"]), rtol=LOSS_RTOL)
    for name, model in (("coarse", coarse), ("fine", fine)):
        ref = state_dict_from_flax(jx.jax.tree.map(np.asarray, state_j.params[name]))
        for pname, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")


def test_batch_steps_match_resident_step(jx):  # noqa: F811
    """On the same indices and render draws, 3 updates: the rows step
    equals ``make_train_step`` on the resident store bit for bit (the same
    rows, the same update body); the packed step (its rays rebuilt from the
    pose table, its target u8 * (1 / 255) of 8-bit pixels) gives each
    update's loss within
    PACKED_LOSS_RTOL of the rows step's and the parameters within
    PACKED_PARAM_ATOL."""
    num = jx.images.shape[0] * jx.hwf[0] * jx.hwf[1]
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(5), 3)
    draws = [_step_draws(jx, k, num) for k in keys]
    images = (np.round(jx.images * 255.0) / 255.0).astype(np.float32)  # 8-bit pixels
    store = build_ray_store(images, jx.poses, jx.hwf, 2.0, 6.0, device="cpu")
    rows, _ = hs.build_host_ray_rows(images, jx.poses, jx.hwf, device="cpu")
    u8 = hs.images_to_u8(images)
    unpack = hs.make_ray_unpack(hs.build_pose_tables(jx.poses, jx.hwf), 2.0, 6.0)
    states, losses, grads = {}, {}, {}
    for name in ("resident", "rows", "packed"):
        coarse, fine = _port_models(jx)
        state = states[name] = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
        losses[name] = []
        resident_step = make_train_step(SETTINGS, BATCH)
        step = make_batch_train_step(SETTINGS, unpack=unpack if name == "packed" else None)
        for d in draws:
            idx = d.idx.numpy()
            if name == "resident":
                m = resident_step(state, store, draws=[d])
            elif name == "rows":
                b = torch.tensor(rows[idx])
                rays = hs.RayBatch(origins=b[:, 0:3], directions=b[:, 3:6], viewdirs=b[:, 6:9],
                                   near=torch.full((BATCH,), 2.0), far=torch.full((BATCH,), 6.0))
                m = step(state, rays, b[:, 9:12], draws=d.render)
            else:
                m = step(state, {"idx": d.idx.to(torch.int32), "rgb": torch.tensor(u8[idx])},
                         draws=d.render)
            losses[name].append(float(m["loss"]))
            if name not in grads:  # the first update's
                grads[name] = [p.grad.clone() for p in (*coarse.parameters(),
                                                        *fine.parameters())]
    assert losses["rows"] == losses["resident"]
    np.testing.assert_allclose(losses["packed"], losses["rows"], rtol=PACKED_LOSS_RTOL)
    scale = max(float(g.abs().max()) for g in grads["rows"])
    for a, b, c in zip(grads["resident"], grads["rows"], grads["packed"]):
        assert torch.equal(a, b)
        assert float((c - b).abs().max()) <= PACKED_GRAD_RTOL * scale
    for model in ("coarse", "fine"):
        for (_, a), (_, b), (_, c) in zip(*(getattr(states[k], model).named_parameters()
                                            for k in ("resident", "rows", "packed"))):
            assert torch.equal(a, b)
            np.testing.assert_allclose(c.detach().numpy(), b.detach().numpy(), rtol=0,
                                       atol=PACKED_PARAM_ATOL)


def test_batch_step_draws_from_generator_and_needs_depth(jx):  # noqa: F811
    """Without ``draws`` the render draws come from ``generator`` (two
    equal generators give equal updates); with a depth term a batch without
    its depth raises."""
    rows, _ = hs.build_host_ray_rows(jx.images, jx.poses, jx.hwf, device="cpu")
    b = torch.tensor(rows[:BATCH])
    rays = hs.RayBatch(origins=b[:, 0:3], directions=b[:, 3:6], viewdirs=b[:, 6:9],
                       near=torch.full((BATCH,), 2.0), far=torch.full((BATCH,), 6.0))
    out = []
    for _ in range(2):
        coarse, fine = _port_models(jx)
        state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
        step = make_batch_train_step(SETTINGS)
        out.append(float(step(state, rays, b[:, 9:12], torch.Generator().manual_seed(4))["loss"]))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="GT depth"):
        make_batch_train_step(SETTINGS, depth_loss_weight=0.5)(state, rays, b[:, 9:12],
                                                               torch.Generator())


# ---- run_training


def _cfg(basedir, logdir, wire, **dataset):
    model = {"type": "FlexibleNeRFModel", "num_layers": 2, "hidden_size": 16,
             "num_encoding_fn_xyz": 2, "num_encoding_fn_dir": 1}
    mode = {"chunksize": 64, "num_coarse": 4, "num_fine": 4, "white_background": False,
            "radiance_field_noise_std": 0.0, "lindisp": False, "perturb": False}
    return {
        "experiment": {"id": f"host-{wire}", "logdir": logdir, "randomseed": 5,
                       "train_iters": 3, "validate_every": 0, "save_every": 0,
                       "print_every": 1},
        "dataset": {"type": "blender", "basedir": basedir, "near": 2.0, "far": 6.0,
                    "no_ndc": True, "half_res": False, "testskip": 1, "host_store": True,
                    "host_wire": wire, **dataset},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5.0e-3},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True, "train": {**mode, "num_random_rays": 16},
                 "validation": dict(mode)},
    }


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    from test_torch_eval import calibrated_checkpoint

    tmp = tmp_path_factory.mktemp("host_store")
    data = str(tmp / "data")
    write_blender_dataset(data, height=10, width=10, views_per_split=(2, 1, 1))
    ckpt = str(tmp / "start.ckpt")
    calibrated_checkpoint(_cfg(data, str(tmp), "packed"), ckpt)
    return types.SimpleNamespace(data=data, ckpt=ckpt)


def _losses(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]


@pytest.mark.parametrize("wire", ["packed", "rows"])
def test_run_training_host_store_matches_jax(jax, blender, tmp_path, wire):
    """3 steps of both packages' ``run_training`` with ``dataset.host_store``
    on one ``.ckpt`` (perturbation and σ-noise off, so the run's draws are
    the loader's indices alone, JAX's stream from ``randomseed``): the
    losses and the final parameters; two steps a call
    (``steps_per_call``) give the same losses at the calls' ends."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run

    raw = _cfg(blender.data, str(tmp_path), wire)
    got = ploop.run_training(CfgNode(raw), load_ckpt=blender.ckpt, device="cpu")
    raw_j = json.loads(json.dumps(raw))
    raw_j["experiment"]["id"] += "-jax"
    want = j_run(JCfg(raw_j), load_ckpt=blender.ckpt, use_tensorboard=False)
    a, b = _losses(got["logdir"]), _losses(os.path.join(str(tmp_path), raw_j["experiment"]["id"]))
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(jax.tree.map(np.asarray, want["state"].params[name]))
        for pname, p in getattr(got["state"], name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")
    raw2 = json.loads(json.dumps(raw))
    raw2["experiment"].update(id=raw["experiment"]["id"] + "-spc", train_iters=4)
    raw2["nerf"]["train"]["steps_per_call"] = 2
    two = ploop.run_training(CfgNode(raw2), load_ckpt=blender.ckpt, device="cpu")
    np.testing.assert_allclose(_losses(two["logdir"])[0], a[1], rtol=LOSS_RTOL)


def test_host_store_refusals_match_jax(jax, blender, tmp_path):
    """JAX's refusals in JAX's words: non-uniform sampling, more than one
    device, occupancy, a depth warmup, an unknown wire."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run

    raw = _cfg(blender.data, str(tmp_path), "packed")
    cases = [({"sampling": "per_image"}, {}), ({"num_devices": 2}, {}),
             ({"occupancy": 0.5}, {}), ({}, {"host_wire": "floats"})]
    for kw, dataset in cases:
        r = json.loads(json.dumps(raw))
        r["dataset"].update(dataset)
        with pytest.raises(ValueError) as got:
            ploop.run_training(CfgNode(r), device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            j_run(JCfg(json.loads(json.dumps(r))), use_tensorboard=False, **kw)
        assert str(got.value) == str(want.value), kw
    # the depth warmup: a depth term needs a scene with depth sidecars
    from dexnerf_tpu_torch.train.loop import load_scene

    scene = load_scene(CfgNode(raw))
    scene.depths = np.full(scene.images.shape[:3], 3.0, np.float32)
    with pytest.raises(ValueError) as got:
        ploop.run_training(CfgNode(raw), device="cpu", scene=scene, depth_loss_weight=0.1,
                           depth_warmup=2)
    assert str(got.value) == ("depth_warmup supports the single-device resident-store path "
                              "(the distillation protocol)")


# ---- the native ops


def test_native_ops_match_numpy_and_jax_library():
    """The port's host library against numpy and the JAX package's native
    library (``dexnerf_tpu/ops/native``): the gather of given rows of any
    dtype (a memmap too), ``pack_rays``, ``searchsorted_right`` with ties,
    ``sample_pdf_interp`` and ``sample_pdf_host``."""
    pytest.importorskip("jax")
    from dexnerf_tpu.ops import native as jn

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((50, 12)).astype(np.float32)
    idx = rng.integers(0, 50, 33)
    for src in (rows, rows.astype(np.float64), (rows * 40).astype(np.uint8),
                rows[:, 0].copy(), np.zeros((50, 3, 2), np.int16)):
        np.testing.assert_array_equal(host_rows.gather_rows(src, idx), src[idx])
    out = np.empty((33, 12), np.float32)
    assert host_rows.gather_rows(rows, idx, out) is out
    with pytest.raises(ValueError, match="C-contiguous"):
        host_rows.gather_rows(rows[:, :3], idx)
    ro, rd, rgb = (rng.standard_normal((40, 3)).astype(np.float32) for _ in range(3))
    packed = host_rows.pack_rays(ro, rd, rgb)
    np.testing.assert_array_equal(packed, jn.pack_rays(ro, rd, rgb))
    np.testing.assert_array_equal(packed[:, :6], np.concatenate([ro, rd], 1))
    np.testing.assert_allclose(packed[:, 6:9], rd / np.linalg.norm(rd, axis=1, keepdims=True),
                               rtol=1e-6)
    cdf = np.sort(rng.uniform(size=(6, 9)).astype(np.float32), 1)
    cdf[:, 3] = cdf[:, 4]  # ties
    u = np.concatenate([rng.uniform(size=(6, 5)), cdf[:, 3:4]], 1).astype(np.float32)
    got = host_rows.searchsorted_right(cdf, u)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [np.searchsorted(c, q, side="right")
                                        for c, q in zip(cdf, u)])
    bins = np.cumsum(rng.uniform(0.1, 1, (6, 9)), 1).astype(np.float32)
    np.testing.assert_array_equal(host_rows.sample_pdf_interp(cdf, bins, u, got),
                                  jn.sample_pdf_interp(cdf, bins, u, got))
    w = rng.uniform(size=(6, 8)).astype(np.float32)
    np.testing.assert_array_equal(host_rows.sample_pdf_host(bins, w, u),
                                  jn.sample_pdf_host(bins, w, u))


# ---- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("wire", ["rows", "packed"])
def test_pinned_ring_matches_synchronous_copy_on_card(wire, prefetch):
    """50 batches of a loader on the card (the pinned ring of prefetch + 1
    buffers, the copies on the loader's stream) equal the same indices'
    rows copied synchronously, while the consumer's stream runs work on
    each batch; every batch is a CUDA tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the loader's pinned ring and stream)")
    images, poses, hwf, K, depths = _views(n_img=4, H=40, W=50)
    rows, depth = hs.build_host_ray_rows(images, poses, hwf, device="cuda", depths=depths)
    u8 = hs.images_to_u8(images)
    batch, seed = 4096, 11
    rng = np.random.default_rng(seed)
    if wire == "rows":
        loader = hs.HostRayLoader(rows, 2.0, 6.0, batch, seed, depth=depth, prefetch=prefetch)
    else:
        loader = hs.HostPixelLoader(u8, batch, seed, depth=depth, prefetch=prefetch)
    with loader:
        for _ in range(50):
            got = next(loader)
            idx = rng.integers(0, rows.shape[0], batch)
            if wire == "rows":
                rays, target, d = got
                fields = {"rows": torch.cat([rays.origins, rays.directions, rays.viewdirs,
                                             target], 1), "depth": d}
                want = {"rows": rows[idx], "depth": depth[idx]}
            else:
                fields = got
                want = {"idx": idx.astype(np.int32), "rgb": u8[idx], "depth": depth[idx]}
            torch.cuda._sleep(1_000_000)  # the consumer's stream busy while the next copies run
            for k, v in fields.items():
                assert v.is_cuda, k
                assert torch.equal(v, torch.from_numpy(np.ascontiguousarray(want[k])).cuda()), k
