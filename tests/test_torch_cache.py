"""The offline ray cache and the resizes that are not an integer factor in
the port (``apps/cache.py``, ``ops/host_rows.py``,
``data/pipeline.py::build_ray_store_from_cache``, ``run_training``'s cache
branch, ``data/resize.py`` and the loaders that call it), held to the JAX
package and to OpenCV on the CPU.

Tolerances: both packages' shards equal field by field, bit for bit (the
rows are gathered by the same C++ generator), except the messytable rays,
within RAY_ATOL (the port inverts w2c in float64, JAX in float32; 1 ulp
at these magnitudes); a cache store's origins, directions and rgb equal,
its viewdirs within VIEWDIR_ULPS ulp (the port emulates the fused
multiply-adds the compiler makes of JAX's packer); the training losses to LOSS_RTOL, the
parameters to PARAM_ATOL (``tests/test_torch_train_step.py``'s); the
resizes equal to OpenCV's in every byte, and the loaders to the JAX
loaders' in every array.
"""

import glob
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch
import yaml
from test_torch_depth import tiny_cfg
from test_torch_occupancy import _jax_draws

from dexnerf_tpu_torch.apps import cache as cache_app
from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.data.blender import load_blender_data, load_blender_depths
from dexnerf_tpu_torch.data.llff import load_llff_data
from dexnerf_tpu_torch.data.messytable import load_messytable_data
from dexnerf_tpu_torch.data.pipeline import build_ray_store_from_cache, per_image_ray_indices
from dexnerf_tpu_torch.data.resize import area_resize, nearest_resize
from dexnerf_tpu_torch.data.synthetic import (
    write_blender_dataset,
    write_llff_dataset,
    write_messytable_dataset,
)
from dexnerf_tpu_torch.ops.host_rows import gather_random_rows
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

RAY_ATOL = 1e-6
VIEWDIR_ULPS = 1
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
CACHE_RAYS = 40  # rays a train shard


@pytest.fixture(scope="module")
def jax():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return jax


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A blender scene (12x12, 2 train views) and a messytable scene
    (stored 32x40, loaded 16x20, 2 train views)."""
    tmp = tmp_path_factory.mktemp("cache_scenes")
    write_blender_dataset(str(tmp / "blender"), height=12, width=12, views_per_split=(2, 1, 1))
    write_messytable_dataset(str(tmp / "messytable"), 32, 40, (2, 1, 1))
    return {k: str(tmp / k) for k in ("blender", "messytable")}


def _cache_both(scenes, tmp_path, kind, fmt):
    flags = ["--datapath", scenes[kind], "--type", kind, "--num-random-rays", str(CACHE_RAYS),
             "--num-variations", "2"] + (["--torch-format"] if fmt == "torch" else [])
    from dexnerf_tpu.apps.cache import main as j_main

    dirs = {k: str(tmp_path / f"cache_{k}") for k in ("port", "jax")}
    assert cache_app.main([*flags, "--savedir", dirs["port"], "--device", "cpu"]) == 0
    assert j_main([*flags, "--savedir", dirs["jax"], "--platform", "cpu"]) == 0
    return dirs


def _read_shard(path):
    if path.endswith(".data"):
        d = torch.load(path, map_location="cpu", weights_only=False)
        return {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in d.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---- apps.cache


@pytest.mark.parametrize("fmt", ["npz", "torch"])
@pytest.mark.parametrize("kind", ["blender", "messytable"])
def test_cache_shards_match_jax(jax, scenes, tmp_path, kind, fmt):
    """Both packages' ``apps.cache`` on one scene: the same shard files,
    each field of the same type and value (the train rows gathered by the
    same generator, bit for bit)."""
    dirs = _cache_both(scenes, tmp_path, kind, fmt)
    for split, n in (("train", 4), ("val", 1)):
        names = sorted(os.listdir(os.path.join(dirs["jax"], split)))
        assert sorted(os.listdir(os.path.join(dirs["port"], split))) == names
        assert len(names) == n
        for name in names:
            got = _read_shard(os.path.join(dirs["port"], split, name))
            want = _read_shard(os.path.join(dirs["jax"], split, name))
            assert sorted(got) == sorted(want)
            for key, w in want.items():
                g = got[key]
                assert type(g) is type(w), (name, key)
                if not isinstance(w, np.ndarray):
                    assert g == w, (name, key)
                    continue
                assert g.dtype == w.dtype and g.shape == w.shape, (name, key)
                if kind == "messytable" and key in ("ray_bundle", "ray_directions"):
                    np.testing.assert_allclose(g, w, rtol=0, atol=RAY_ATOL, err_msg=key)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}")
        if split == "train":
            assert got["ray_bundle"].shape == (2, CACHE_RAYS, 3)


def test_gather_matches_jax_host_library(jax):
    """The port's copy of the gather and the JAX package's host library draw
    the same rows for every seed."""
    from dexnerf_tpu.ops.native import gather_random_rows as j_gather

    rows = np.random.default_rng(0).random((997, 9), dtype=np.float32)
    for seed in range(4):
        np.testing.assert_array_equal(gather_random_rows(rows, seed, 300),
                                      j_gather(rows, seed=seed, batch=300))


# ---- build_ray_store_from_cache


@pytest.mark.parametrize("fmt", ["npz", "torch"])
@pytest.mark.parametrize("kind", ["blender", "messytable"])
def test_cache_store_matches_jax(jax, scenes, tmp_path, kind, fmt):
    """One cache (JAX's) through both builders: origins, directions and
    rgb equal, viewdirs within VIEWDIR_ULPS ulp; no image structure."""
    from dexnerf_tpu.data import build_ray_store_from_cache as j_build

    dirs = _cache_both(scenes, tmp_path, kind, fmt)
    got = build_ray_store_from_cache(dirs["jax"], 2.0, 6.0, device="cpu")
    want = j_build(dirs["jax"], 2.0, 6.0)
    g, w = got.data.numpy(), np.asarray(want.data)
    assert g.shape == w.shape == (4 * CACHE_RAYS, 12) and g.dtype == w.dtype
    np.testing.assert_array_equal(g[:, :6], w[:, :6])
    np.testing.assert_array_equal(g[:, 9:], w[:, 9:])
    ulps = np.abs(g[:, 6:9] - w[:, 6:9]) / np.spacing(np.abs(w[:, 6:9]))
    assert ulps.max() <= VIEWDIR_ULPS
    assert (got.near, got.far, got.rays_per_image) == (2.0, 6.0, 0)


def test_cache_store_refusals_match_jax(jax, scenes, tmp_path):
    """A missing or empty cache raises FileNotFoundError in both packages;
    per-image sampling on a cache store raises with JAX's words."""
    from dexnerf_tpu.data import build_ray_store_from_cache as j_build
    from dexnerf_tpu.data.pipeline import sample_ray_batch_per_image as j_per_image

    empty = tmp_path / "empty"
    (empty / "train").mkdir(parents=True)
    for cachedir in (str(tmp_path / "missing"), str(empty)):
        with pytest.raises(FileNotFoundError) as got:
            build_ray_store_from_cache(cachedir, 2.0, 6.0, device="cpu")
        with pytest.raises(FileNotFoundError) as want:
            j_build(cachedir, 2.0, 6.0)
        assert str(got.value) == str(want.value)
    dirs = _cache_both(scenes, tmp_path, "blender", "npz")
    with pytest.raises(ValueError) as got:
        per_image_ray_indices(build_ray_store_from_cache(dirs["port"], 2.0, 6.0, device="cpu"),
                              4, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as want:
        j_per_image(j_build(dirs["port"], 2.0, 6.0), jax.random.PRNGKey(0), 4)
    assert str(got.value) == str(want.value)


# ---- run_training from a cache


def test_run_training_from_cache_matches_jax(jax, scenes, tmp_path, monkeypatch):
    """3 Adam steps of both packages' ``run_training`` on a config whose
    ``dataset.cachedir`` holds the port's cache, from one ``.ckpt`` on
    JAX's draws: the losses and the final parameters."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run
    from test_torch_eval import calibrated_checkpoint

    cachedir = str(tmp_path / "cache")
    assert cache_app.main(["--datapath", scenes["blender"], "--savedir", cachedir,
                           "--num-random-rays", str(CACHE_RAYS), "--device", "cpu"]) == 0
    raw = tiny_cfg({"type": "blender", "basedir": scenes["blender"], "cachedir": cachedir},
                   str(tmp_path / "logs"))
    raw["experiment"].update(id="cache", train_iters=3, validate_every=0, print_every=1,
                             randomseed=5)
    ckpt = str(tmp_path / "start.ckpt")
    calibrated_checkpoint(raw, ckpt)
    raw_j = json.loads(json.dumps(raw))
    raw_j["experiment"]["id"] = "cache_jax"
    want = j_run(JCfg(raw_j), load_ckpt=ckpt, use_tensorboard=False)

    s = ploop.render_settings_from_cfg(CfgNode(raw), "train")
    jx = types.SimpleNamespace(jax=jax, jnp=jax.numpy)
    draws = iter(_jax_draws(jx, 5, 3, 16, 2 * CACHE_RAYS, s))
    make_step = ploop.make_train_step

    def make_with_draws(*a, **k):
        step = make_step(*a, **k)
        return lambda state, store, generator: step(state, store, generator, draws=[next(draws)])

    stores = []
    build = ploop.build_ray_store_from_cache
    monkeypatch.setattr(ploop, "build_ray_store_from_cache",
                        lambda *a, **k: stores.append(build(*a, **k)) or stores[-1])
    monkeypatch.setattr(ploop, "make_train_step", make_with_draws)
    got = ploop.run_training(CfgNode(raw), load_ckpt=ckpt, device="cpu")
    assert len(stores) == 1 and stores[0].num_rays == 2 * CACHE_RAYS

    def losses(logdir):
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            return [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]

    a, b = losses(got["logdir"]), losses(str(tmp_path / "logs" / "cache_jax"))
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(jax.tree.map(np.asarray, want["state"].params[name]))
        for pname, p in getattr(got["state"], name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")


def test_train_cli_trains_from_cache_unless_depth(scenes, tmp_path, monkeypatch):
    """``apps.train`` trains from ``dataset.cachedir`` when it holds shards,
    from the views when a depth term is asked for (the shards carry no
    depth) or the directory holds no ``train/``, as JAX's loop chooses."""
    cachedir = str(tmp_path / "cache")
    assert cache_app.main(["--type", "messytable", "--datapath", scenes["messytable"],
                           "--savedir", cachedir, "--num-random-rays", "8",
                           "--device", "cpu"]) == 0
    used = []
    build = ploop.build_ray_store_from_cache
    monkeypatch.setattr(ploop, "build_ray_store_from_cache",
                        lambda *a, **k: used.append(a[0]) or build(*a, **k))
    for case, flags, cache in (("cache", [], cachedir), ("depth", ["--depth-loss", "0.1"],
                                                          cachedir),
                               ("no-train", [], str(tmp_path))):
        raw = tiny_cfg({"type": "messytable", "basedir": scenes["messytable"],
                        "cachedir": cache, "depth_valid_max": 6.0}, str(tmp_path / "logs"))
        raw["experiment"].update(id=case, train_iters=1, validate_every=0)
        cfg = str(tmp_path / f"{case}.yml")
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
        n = len(used)
        assert train_app.main(["--config", cfg, "--device", "cpu", *flags]) == 0
        assert len(used) - n == (case == "cache"), case


# ---- the resizes


def _random_image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_area_resize_matches_cv2(dtype, channels):
    """``area_resize`` writes OpenCV's ``INTER_AREA`` bytes on 60 random
    downscales each (integer factors, square or not, and fractional
    scales), and at the loaders' sizes."""
    import cv2

    rng = np.random.default_rng(channels)
    sizes = [((540, 960), (25, 25)), ((540, 960), (270, 480)), ((33, 47), (16, 23)),
             ((378, 504), (75, 100))]
    for k in range(60):
        sh, sw = (int(v) for v in rng.integers(2, 90, 2))
        if k % 3 == 0:
            fy, fx = (int(v) for v in rng.integers(1, 6, 2))
            size = (max(1, sh // fy), max(1, sw // fx))
        else:
            size = (int(rng.integers(1, sh + 1)), int(rng.integers(1, sw + 1)))
        sizes.append(((sh, sw), size))
    for (sh, sw), (h, w) in sizes:
        img = _random_image(rng, (sh, sw, channels), dtype)
        if channels == 1:
            img = img[..., 0]
        got = area_resize(img, (h, w))
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        assert got.dtype == want.dtype, (sh, sw, h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{sh}x{sw} -> {h}x{w}")


def test_nearest_resize_matches_cv2():
    """``nearest_resize`` is OpenCV's ``INTER_NEAREST`` on 200 random sizes,
    down and up."""
    import cv2

    rng = np.random.default_rng(7)
    for _ in range(200):
        sh, sw, h, w = (int(v) for v in rng.integers(1, 120, 4))
        img = rng.random((sh, sw), dtype=np.float32)
        np.testing.assert_array_equal(nearest_resize(img, (h, w)),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


def test_area_resize_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="downscales"):
        area_resize(np.zeros((4, 4, 3), np.float32), (8, 8))
    with pytest.raises(TypeError, match="uint8 or float32"):
        area_resize(np.zeros((4, 4, 3), np.float64), (2, 2))


# ---- the loaders at sizes that are not an integer factor


def _assert_loads_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        elif isinstance(b, list) and b and isinstance(b[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b, i


@pytest.mark.parametrize("how", ["debug", "odd-size"])
def test_messytable_resizes_match_jax(jax, tmp_path, how):
    """The 25x25 ``debug`` load (with JAX's ``hwf`` of the stored frame)
    and an odd frame's halving, against JAX's loader."""
    from dexnerf_tpu.data import load_messytable_data as j_load

    base = str(tmp_path / "mt")
    write_messytable_dataset(base, *((54, 90) if how == "debug" else (33, 47)), (2, 1, 1))
    debug = how == "debug"
    got = load_messytable_data(base, debug=debug)
    _assert_loads_equal(got, j_load(base, debug=debug))
    assert got[0].shape[1:3] == ((25, 25) if debug else (16, 23))


@pytest.mark.parametrize("factor", [3, 7])
def test_llff_minify_matches_jax(jax, tmp_path, factor):
    """LLFF at a factor that does not divide the 32x50 frame: the PNGs
    ``_minify`` writes and the loaded arrays, against JAX's OpenCV minify."""
    from dexnerf_tpu.data.llff import load_llff_data as j_load

    base = str(tmp_path / "llff")
    write_llff_dataset(base, height=32, width=50, views=3)
    copies = {k: str(tmp_path / k) for k in ("port", "jax")}
    for k in copies:
        shutil.copytree(base, copies[k])
    got = load_llff_data(copies["port"], factor=factor)
    want = j_load(copies["jax"], factor=factor)
    assert got[0].shape[1:3] == (32 // factor, 50 // factor)
    from PIL import Image

    for a, b in zip(*(sorted(glob.glob(os.path.join(c, f"images_{factor}", "*.png")))
                      for c in (copies["port"], copies["jax"]))):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("how", ["debug", "half_res"])
def test_blender_resizes_match_jax(jax, tmp_path, how):
    """Blender's 25x25 ``debug`` and ``half_res`` (÷4) loads of a 54x54
    scene, whose size divides neither, images and depth sidecars, against
    JAX's loader."""
    from dexnerf_tpu.data.blender import load_blender_data as j_load
    from dexnerf_tpu.data.blender import load_blender_depths as j_depths

    base = str(tmp_path / "b")
    write_blender_dataset(base, height=54, width=54, views_per_split=(1, 1, 1))
    np.save(os.path.join(base, "train", "d_0.npy"),
            np.random.default_rng(0).uniform(2, 6, (54, 54)).astype(np.float32))
    kw = {how: True}
    got, want = load_blender_data(base, **kw), j_load(base, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
    np.testing.assert_array_equal(load_blender_depths(base, **kw), j_depths(base, **kw))
    assert got[0].shape[1:3] == ((25, 25) if how == "debug" else (13, 13))
