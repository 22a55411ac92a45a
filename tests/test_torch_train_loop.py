"""The port's data path, metrics, checkpoints and training loop
(``dexnerf_tpu_torch/{data,core/metrics,train}``, ``apps/train.py``) held
to the JAX package on the CPU, and the training CLI end to end.

Tolerances: the loaders and the ray store are held to 1e-6 absolute (f32
arithmetic in another library); checkpoints cross packages exactly.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.core import metrics as port_metrics
from dexnerf_tpu_torch.data.blender import (
    load_blender_data,
    load_blender_depths,
    pose_spherical,
)
from dexnerf_tpu_torch.data.pipeline import (
    build_ray_store,
    sample_ray_batch_per_image,
    take_ray_batch,
)
from dexnerf_tpu_torch.data.synthetic import render_analytic_image, write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.train.checkpoints import (
    adam_state_dict,
    adam_state_from_optax,
    load_adam_state,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.step import init_train_state

ATOL = 1e-6
ARCH = dict(num_layers=8, hidden_size=16, skip_connect_every=3,
            num_encoding_fn_xyz=3, num_encoding_fn_dir=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _scene(n=3, h=4, w=6, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(t, -30.0 + 5 * i, 4.0)
                      for i, t in enumerate(np.linspace(-150, 150, n))])
    return images, poses, [h, w, 1.2 * w]


def test_ray_store_rows_match_jax(jax):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.data.pipeline import take_ray_batch as j_take

    images, poses, hwf = _scene()
    depths = np.random.default_rng(1).uniform(size=images.shape[:3]).astype(np.float32)
    got = build_ray_store(images, poses, hwf, 2.0, 6.0, device="cpu", depths=depths)
    want = j_build(images, poses, hwf, 2.0, 6.0, depths=depths)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    assert (got.num_rays, got.num_images, got.rays_per_image) == (
        want.num_rays, want.num_images, want.rays_per_image)
    idx = np.random.default_rng(2).integers(0, got.num_rays, size=17)
    rays, target = take_ray_batch(got, torch.tensor(idx))
    j_rays, j_target = j_take(want, jax.numpy.asarray(idx))
    np.testing.assert_allclose(target.numpy(), np.asarray(j_target), rtol=0, atol=ATOL)
    for a, b in zip(rays, j_rays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


def test_per_image_batch_comes_from_one_image():
    images, poses, hwf = _scene(n=4)
    store = build_ray_store(images, poses, hwf, 2.0, 6.0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        rays, target = sample_ray_batch_per_image(store, 40, gen)
        rows = store.data[:, 9:12]
        hit = [(rows == t).all(-1).nonzero()[:, 0] for t in target]
        images_hit = {int(h[0]) // store.rays_per_image for h in hit}
        assert len(images_hit) == 1


@pytest.mark.parametrize("half_res", [False, True], ids=["full", "half_res"])
def test_written_dataset_loads_identically(jax, tmp_path, half_res):
    """A dataset written by the port loads the same through both packages'
    ``load_blender_data`` (PIL vs imageio; block mean vs cv2 INTER_AREA),
    and its depth sidecars the same through ``load_blender_depths``."""
    from dexnerf_tpu.data.blender import load_blender_data as j_load
    from dexnerf_tpu.data.blender import load_blender_depths as j_depths

    base = str(tmp_path / "scene")
    write_blender_dataset(base, height=8, width=8, views_per_split=(2, 1, 1))
    np.save(os.path.join(base, "train", "d_1.npy"),
            np.linspace(2, 6, 64, dtype=np.float32).reshape(8, 8))
    got = load_blender_data(base, half_res=half_res)
    want = j_load(base, half_res=half_res)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    for a, b in zip(got[4], want[4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(load_blender_depths(base, half_res=half_res),
                                  j_depths(base, half_res=half_res))


def test_analytic_render_matches_jax(jax):
    from dexnerf_tpu.data.synthetic import render_analytic_image as j_render

    c2w = pose_spherical(30.0, -30.0, 4.0)
    got = render_analytic_image(c2w, 6, 5, 7.0)
    want = j_render(c2w, 6, 5, 7.0)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-5)


def test_image_metrics_match_jax(jax):
    from dexnerf_tpu.core import metrics as jm

    rng = np.random.default_rng(3)
    a = rng.uniform(size=(20, 17, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jnp = jax.numpy
    np.testing.assert_allclose(float(port_metrics.ssim(torch.tensor(a), torch.tensor(b))),
                               float(jm.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(port_metrics.luminance(torch.tensor(a)).numpy(),
                               np.asarray(jm.luminance(jnp.asarray(a))), rtol=0, atol=ATOL)
    mse = float(port_metrics.img2mse(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(mse, float(jm.img2mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert port_metrics.mse2psnr(mse) == pytest.approx(jm.mse2psnr(mse), rel=1e-12)
    assert port_metrics.mse2psnr(0.0) == jm.mse2psnr(0.0)


def _optax_state(jax, seed=0):
    """A JAX params tree pair and an optax Adam state over it with random
    moments and count 7."""
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.train.step import make_optimizer

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ARCH["num_encoding_fn_xyz"]) + encoding_dim(3, ARCH["num_encoding_fn_dir"])
    params = {name: jm.init(jax.random.PRNGKey(seed + i), jnp.ones((1, in_dim)))
              for i, name in enumerate(("coarse", "fine"))}
    tx = make_optimizer(5e-3)
    rng = np.random.default_rng(seed)
    adam, sched = tx.init(params)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    adam = adam._replace(count=jnp.asarray(7, jnp.int32), mu=rand(adam.mu),
                         nu=jax.tree.map(jnp.abs, rand(adam.nu)))
    return params, (adam, sched), tx


def _port_models():
    return FlexibleNeRFModel(**ARCH), FlexibleNeRFModel(**ARCH)


def test_jax_checkpoint_resumes_in_port(jax, tmp_path):
    """A ``.ckpt`` from JAX's ``export_torch_checkpoint`` loads into the
    port's models and Adam; ``adam_state_from_optax`` gives the same
    state straight from the optax moments."""
    from dexnerf_tpu.train.checkpoints import export_torch_checkpoint

    params, opt_state, _ = _optax_state(jax)
    path = str(tmp_path / "jax.ckpt")
    export_torch_checkpoint(path, params, step=7, opt_state=opt_state)
    imported = read_reference_checkpoint(path)
    coarse, fine = _port_models()
    coarse.load_state_dict(imported["coarse"])
    fine.load_state_dict(imported["fine"])
    state = init_train_state(coarse, fine, 5e-3)
    assert load_adam_state(state.optimizer, imported["optimizer_state_dict"]) == 7
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = opt_state[0]
    for name, model in (("coarse", coarse), ("fine", fine)):
        want_p = state_dict_from_flax(as_np(params[name]))
        want_m = state_dict_from_flax(as_np(adam.mu[name]))
        want_v = state_dict_from_flax(as_np(adam.nu[name]))
        for pname, p in model.named_parameters():
            st = state.optimizer.state[p]
            assert torch.equal(p.detach(), want_p[pname])
            assert torch.equal(st["exp_avg"], want_m[pname])
            assert torch.equal(st["exp_avg_sq"], want_v[pname])
            assert float(st["step"]) == 7.0
    direct = adam_state_from_optax(
        as_np(adam.mu), as_np(adam.nu), 7, {"coarse": coarse, "fine": fine}, 5e-3
    )
    exported = imported["optimizer_state_dict"]
    assert direct["param_groups"] == [dict(g, betas=tuple(g["betas"])) for g in exported["param_groups"]]
    for i, st in exported["state"].items():
        assert direct["state"][i]["step"] == st["step"]
        assert torch.equal(direct["state"][i]["exp_avg"], torch.as_tensor(st["exp_avg"]))
        assert torch.equal(direct["state"][i]["exp_avg_sq"], torch.as_tensor(st["exp_avg_sq"]))


def test_port_checkpoint_resumes_in_jax(jax, tmp_path):
    """A ``.ckpt`` written by the port (models + Adam + iter) becomes the
    same optax state through ``import_torch_checkpoint`` +
    ``build_opt_state_from_torch``."""
    from dexnerf_tpu.train.checkpoints import (
        _find_adam_state,
        build_opt_state_from_torch,
        import_torch_checkpoint,
    )

    params, opt_state, tx = _optax_state(jax, seed=4)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    coarse, fine = _port_models()
    coarse.load_state_dict(state_dict_from_flax(as_np(params["coarse"])))
    fine.load_state_dict(state_dict_from_flax(as_np(params["fine"])))
    state = init_train_state(coarse, fine, 5e-3)
    adam = opt_state[0]
    load_adam_state(state.optimizer, adam_state_from_optax(
        as_np(adam.mu), as_np(adam.nu), 7, {"coarse": coarse, "fine": fine}, 5e-3))
    path = str(tmp_path / "port.ckpt")
    write_reference_checkpoint(path, coarse.state_dict(), fine.state_dict(), step=7,
                               optimizer_state=adam_state_dict(state.optimizer, 7, 5e-3))
    imported = import_torch_checkpoint(path)
    assert imported["step"] == 7
    new_params = {"coarse": imported["coarse"], "fine": imported["fine"]}
    back = _find_adam_state(build_opt_state_from_torch(imported, new_params, tx))
    assert int(back.count) == 7
    for got, want in ((new_params, params), (back.mu, adam.mu), (back.nu, adam.nu)):
        for a, b in zip(jax.tree.leaves(as_np(got)), jax.tree.leaves(as_np(want))):
            np.testing.assert_array_equal(a, b)


def _tiny_config(tmp_path, data, iters):
    with open(os.path.join(ROOT, "configs", "tiny.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["experiment"].update(logdir=str(tmp_path / "logs"), train_iters=iters,
                             validate_every=6, save_every=6, print_every=1)
    cfg["dataset"].update(basedir=data, half_res=False)
    for blk in ("coarse", "fine"):
        cfg["models"][blk].update(num_layers=8, hidden_size=16, skip_connect_every=3)
    cfg["nerf"]["use_pallas"] = True  # the fused loss (its plain version on the CPU)
    path = str(tmp_path / "tiny.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, os.path.join(cfg["experiment"]["logdir"], cfg["experiment"]["id"])


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_end_to_end(jax, tmp_path):
    """``apps.train.main`` on the CPU: 6 updates with validation and a
    save; the ``.ckpt`` loads in JAX with its Adam state; a resume starts
    at the saved iteration."""
    from dexnerf_tpu.train.checkpoints import _find_adam_state, build_opt_state_from_torch
    from dexnerf_tpu.train.checkpoints import import_torch_checkpoint
    from dexnerf_tpu.train.step import make_optimizer

    data = str(tmp_path / "scene")
    write_blender_dataset(data, height=8, width=8, views_per_split=(3, 2, 1))
    cfg, logdir = _tiny_config(tmp_path, data, 6)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--steps-per-call", "2"]) == 0
    recs = _records(logdir)
    losses = {r["step"]: r["value"] for r in recs if r["tag"] == "train/loss"}
    assert sorted(losses) == [1, 3, 5] and all(np.isfinite(list(losses.values())))
    val = [r for r in recs if r["tag"] == "validation/psnr"]
    assert val and all(np.isfinite(r["value"]) for r in val)
    assert any(r["tag"] == "validation/ssim" for r in recs)
    ckpt = os.path.join(logdir, "checkpoints", "checkpoint_0000005.ckpt")
    saved = read_reference_checkpoint(ckpt)
    names = [n for n, _ in FlexibleNeRFModel(**ARCH).named_parameters()]
    assert saved["step"] == 6 and len(saved["optimizer_state_dict"]["state"]) == 2 * len(names)

    imported = import_torch_checkpoint(ckpt)
    params = {"coarse": imported["coarse"], "fine": imported["fine"]}
    adam = _find_adam_state(build_opt_state_from_torch(imported, params, make_optimizer(5e-3)))
    assert int(adam.count) == 6
    mu_sd = state_dict_from_flax(jax.tree.map(np.asarray, adam.mu["fine"]))
    for i, n in enumerate(names):
        np.testing.assert_array_equal(
            mu_sd[n].numpy(),
            saved["optimizer_state_dict"]["state"][len(names) + i]["exp_avg"].numpy())

    assert train_app.main(["--config", cfg, "--device", "cpu", "--max-iters", "8",
                           "--load-checkpoint", ckpt]) == 0
    resumed = [r["step"] for r in _records(logdir)[len(recs):] if r["tag"] == "train/loss"]
    assert resumed == [6, 7]
    again = read_reference_checkpoint(os.path.join(logdir, "checkpoints", "checkpoint_0000007.ckpt"))
    assert again["step"] == 8


def test_train_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device trains there")
    cfg, _ = _tiny_config(tmp_path, str(tmp_path / "missing"), 1)
    with pytest.raises(SystemExit):
        train_app.main(["--config", cfg])


@pytest.mark.parametrize("flag", [
    ["--sg-ir"], ["--pose-opt"], ["--occupancy", "0.2"], ["--num-devices", "4"],
])
def test_unported_modes_raise(tmp_path, flag):
    """The modes once refused naming their ROADMAP item are ported:
    ``--occupancy``, ``--pose-opt``, ``--sg-ir`` and ``--num-devices``
    (Queue 1 items 8-11) pass the flag checks, and training goes on to load
    the (missing) dataset before any rank starts."""
    cfg, _ = _tiny_config(tmp_path, str(tmp_path / "missing"), 1)
    argv = ["--config", cfg, "--device", "cpu", *flag]
    with pytest.raises(FileNotFoundError, match="missing"):
        train_app.main(argv)
