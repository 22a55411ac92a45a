"""Dex-NeRF's own training mode in the port: messytable scenes (the w2c + K
rays of ``core/rays.py``, ``data/messytable.py``, the writer of
``data/synthetic.py``, ``build_ray_store(intrinsics=)``, ``load_scene``),
validation with the σ-threshold sweep, and the train CLI with ``--ir --dex
--depth-loss``, held to the JAX package on the CPU.

Tolerances: rays 1e-5 absolute (the port inverts the pose in float64, XLA
in float32); the loaders' arrays exactly, on both writers' datasets and on
a dataset of random 2x2 blocks, where the JAX loader resizes with OpenCV
(area mean for images, nearest for depths); the ray store's rows 1e-5;
``validate`` as in ``tests/test_torch_depth.py``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_depth import assert_validation_match, tiny_cfg, validate_both

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.rays import get_ray_bundle_w2c
from dexnerf_tpu_torch.data.messytable import load_messytable_data
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import (
    analytic_field,
    write_llff_dataset,
    write_messytable_dataset,
)
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.logging import load_depth_png_mm

RAY_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _w2c(seed):
    """A seeded rigid world-to-camera pose (rotation from a QR, translation
    of ~1 m) and a messytable-like K."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = q, rng.normal(size=3)
    K = np.array([[rng.uniform(300, 1400), 0, rng.uniform(200, 500)],
                  [0, rng.uniform(300, 1400), rng.uniform(100, 300)], [0, 0, 1]])
    return w2c.astype(np.float32), K.astype(np.float32)


@pytest.mark.parametrize("fx_both", [True, False], ids=["fx-both", "fx-fy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_ray_bundle_w2c_matches_jax(jax, seed, fx_both):
    from dexnerf_tpu.core.rays import get_ray_bundle_w2c as j_rays

    w2c, K = _w2c(seed)
    got = get_ray_bundle_w2c(16, 24, torch.tensor(w2c), torch.tensor(K), fx_both)
    want = j_rays(16, 24, jax.numpy.asarray(w2c), jax.numpy.asarray(K), fx_both)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (16, 24, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=RAY_ATOL)
    # the origin is the camera center, and every ray leaves from it
    center = -w2c[:3, :3].T.astype(np.float64) @ w2c[:3, 3]
    np.testing.assert_allclose(got[0][0, 0].numpy(), center, atol=RAY_ATOL)


def _write(writer, base, **kw):
    if writer == "jax":
        from dexnerf_tpu.data import write_messytable_dataset as j_write

        j_write(base, **kw)
    else:
        write_messytable_dataset(base, **kw)


def _assert_same_load(got, want):
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 3:  # [H, W, focal]
            assert a == b
        elif i == 4:  # i_split
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a.dtype == b.dtype, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("half_res", [False, True], ids=["full", "half_res"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loaders_agree_on_both_writers(jax, tmp_path, writer, half_res):
    """Each writer's dataset loads to the same arrays through both
    packages' ``load_messytable_data``."""
    from dexnerf_tpu.data import load_messytable_data as j_load

    base = str(tmp_path / writer)
    _write(writer, base, height=24, width=32, views_per_split=(2, 1, 1))
    got = load_messytable_data(base, half_res=half_res)
    _assert_same_load(got, j_load(base, half_res=half_res))
    images, poses, _, hwf, i_split, intrinsics, depths = got
    assert images.shape == (4, 12, 16, 3) and depths.shape == (4, 12, 16)
    assert [len(s) for s in i_split] == [2, 1, 1] and hwf[:2] == [12, 16]


def test_writers_agree(jax, tmp_path):
    """The port's writer (GT rendered along the port's w2c rays, PNGs by
    PIL) and the JAX writer (its rays, imageio) give the same dataset."""
    for writer in ("jax", "port"):
        _write(writer, str(tmp_path / writer), height=32, width=32, views_per_split=(2, 1, 1))
    _assert_same_load(load_messytable_data(str(tmp_path / "port")),
                      load_messytable_data(str(tmp_path / "jax")))


def test_writer_geometry(tmp_path):
    """The port writer's GT is consistent with the loader and the trainer's
    convention (w2c + K, +y down, +z forward): its depth unprojected
    through the loader's rays lands on the analytic scene's surfaces (as
    ``tests/test_data.py`` holds the JAX writer)."""
    base = str(tmp_path / "mt")
    write_messytable_dataset(base, height=48, width=48, views_per_split=(2, 1, 1))
    images, poses, _, _, _, intr, depths = load_messytable_data(base)
    H, W = images.shape[1:3]
    for v in range(len(images)):
        ro, rd = get_ray_bundle_w2c(H, W, torch.tensor(poses[v]), torch.tensor(intr[v]))
        z = torch.tensor(depths[v])
        mask = (z > 0.1) & (z < 5.9)
        sigma = analytic_field(ro + rd * z[..., None])[..., 3]
        assert float(torch.median(sigma[mask])) > 1.0, v


def _write_random_blocks(base, h=10, w=14, rgb_view=1, real_rgb=False):
    """A messytable dataset of random pixels (so the 2x2 blocks differ in
    every entry): 2 train, 1 val, 1 test view, one of them 3-channel."""
    rng = np.random.default_rng(5)
    depth_n, extri_n, intri_n = (("depth.png", "extrinsic", "intrinsic") if real_rgb
                                 else ("depthL.png", "extrinsic_l", "intrinsic_l"))
    idx = 0
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        for k in range(n):
            d = os.path.join(base, split, f"prefix-{3 - k}")  # listed out of order
            os.makedirs(d)
            shape = (h, w, 3) if idx == rgb_view else (h, w)
            Image.fromarray(rng.integers(0, 256, size=shape, dtype=np.uint8)).save(
                os.path.join(d, "img.png"))
            Image.fromarray(rng.integers(0, 65536, size=(h, w), dtype=np.uint16)).save(
                os.path.join(d, depth_n))
            w2c, K = _w2c(idx)
            with open(os.path.join(d, "meta.pkl"), "wb") as f:
                pickle.dump({extri_n: w2c.astype(np.float64), intri_n: K.astype(np.float64)}, f)
            idx += 1


@pytest.mark.parametrize("real_rgb", [False, True], ids=["ir", "real-rgb"])
def test_random_blocks_match_cv2(jax, tmp_path, real_rgb):
    """On random pixels the port's 2x2 block mean and top-left sample are
    OpenCV's ``INTER_AREA`` and ``INTER_NEAREST`` halvings (which the JAX
    loader calls), and the two loaders agree on every array."""
    import cv2

    from dexnerf_tpu.data import load_messytable_data as j_load

    base = str(tmp_path / "rand")
    _write_random_blocks(base, real_rgb=real_rgb)
    kw = dict(imgname="img.png", is_real_rgb=real_rgb)
    got = load_messytable_data(base, **kw)
    _assert_same_load(got, j_load(base, **kw))
    view = os.path.join(base, "train", "prefix-2")  # the first train view, sorted
    img = np.array(Image.open(os.path.join(view, "img.png")))
    assert img.shape == (10, 14, 3)  # the 3-channel view; the gray ones are compared above
    img = (img / 255.0).astype(np.float32)
    depth = (np.array(Image.open(os.path.join(view, "depth.png" if real_rgb else "depthL.png")))
             / 1000.0).astype(np.float32)
    np.testing.assert_array_equal(got[0][0], cv2.resize(img, (7, 5), interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(got[6][0],
                                  cv2.resize(depth, (7, 5), interpolation=cv2.INTER_NEAREST))
    assert not np.array_equal(got[0][0], img[::2, ::2])  # the blocks are not constant


@pytest.mark.parametrize("how", ["debug", "odd-size"])
def test_unported_resizes_raise(jax, tmp_path, how):
    """The resizes that raised until ROADMAP item 4c (the 25x25 ``debug``
    mode, an odd frame) now load as the JAX loader's OpenCV resizes load
    them, every array equal, ``hwf`` included (in ``debug``, the
    reference's ``H // 32`` of the stored frame beside 25x25 images)."""
    from dexnerf_tpu.data import load_messytable_data as j_load

    base = str(tmp_path / "rand")
    debug = how == "debug"
    _write_random_blocks(base, h=27 if debug else 9, w=70 if debug else 14)
    got = load_messytable_data(base, imgname="img.png", debug=debug)
    _assert_same_load(got, j_load(base, imgname="img.png", debug=debug))
    assert got[0].shape[1:3] == got[6].shape[1:] == ((25, 25) if debug else (4, 7))
    assert got[3][:2] == ([0, 2] if debug else [4, 7])


def test_ray_store_w2c_rows_match_jax(jax, tmp_path):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build

    base = str(tmp_path / "mt")
    write_messytable_dataset(base, height=16, width=20, views_per_split=(2, 1, 1))
    images, poses, _, hwf, i_split, intr, depths = load_messytable_data(base)
    tr = i_split[0]
    got = build_ray_store(images[tr], poses[tr], hwf, 0.3, 4.0, device="cpu",
                          intrinsics=intr[tr], depths=depths[tr])
    want = j_build(images[tr], poses[tr], hwf, 0.3, 4.0, intrinsics=intr[tr], depths=depths[tr])
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=RAY_ATOL)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    assert (got.num_rays, got.rays_per_image) == (want.num_rays, want.rays_per_image) == (160, 80)


def _mt_cfg(tmp_path, basedir, **dataset):
    return tiny_cfg({"type": "messytable", "basedir": basedir, "depth_valid_max": 6.0,
                     **dataset}, str(tmp_path / "logs"))


@pytest.fixture(scope="module")
def mt_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("data") / "mt")
    write_messytable_dataset(base, height=32, width=32, views_per_split=(2, 1, 1))
    return base


def test_load_scene_messytable_matches_jax(jax, tmp_path, mt_dir):
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.train.loop import load_scene as j_load_scene

    raw = _mt_cfg(tmp_path, mt_dir)
    got, want = ploop.load_scene(CfgNode(raw)), j_load_scene(JCfgNode(raw))
    for field in ("images", "poses", "i_train", "i_val", "i_test", "intrinsics", "depths",
                  "render_poses"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.hwf == want.hwf and got.images.shape == (4, 16, 16, 3)


@pytest.mark.parametrize("kind,error", [("llff", NotImplementedError), ("colmap", ValueError)])
def test_load_scene_refuses_other_datasets(jax, tmp_path, kind, error):
    """An unknown dataset type raises ``error``. An LLFF scene whose 20x30
    images do not divide by its factor of 8 raised ``error`` until ROADMAP
    item 4c; it now loads (at 2x3) as the JAX package's ``load_scene``
    loads it."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import load_scene as j_load_scene

    if kind != "llff":
        with pytest.raises(error, match="unknown"):
            ploop.load_scene(CfgNode(_mt_cfg(tmp_path, "", type=kind, downsample_factor=8)))
        return
    copies = {k: str(tmp_path / k) for k in ("port", "jax")}
    for basedir in copies.values():
        write_llff_dataset(basedir, height=20, width=30, views=3)
    got = ploop.load_scene(CfgNode(_mt_cfg(tmp_path, copies["port"], type=kind,
                                           downsample_factor=8)))
    want = j_load_scene(JCfg(_mt_cfg(tmp_path, copies["jax"], type=kind, downsample_factor=8)))
    assert got.images.shape == (3, 2, 3, 3) and got.hwf == want.hwf
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.poses, want.poses, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("supervision", ["rgb", "luminance"])
@pytest.mark.parametrize("dex", [True, False], ids=["dex", "standard"])
def test_validate_messytable_matches_jax(jax, tmp_path, mt_dir, dex, supervision):
    """Validation on the messytable scene (w2c + K rays), with the
    σ-threshold sweep (``dex``) or the expected depth alone: the metrics,
    the Dex depths, the chosen threshold and the logged tags are JAX's."""
    got, want, tags, j_tags, pred_dir, j_pred_dir = validate_both(
        jax, _mt_cfg(tmp_path, mt_dir), tmp_path, dex=dex, supervision=supervision)
    assert_validation_match(got, want)
    assert tags == j_tags, tags ^ j_tags
    names = {t for t, _ in tags}
    assert {"validation/depth_abs_err", "validation/depth_err4"} <= names
    if dex:
        assert len(got["dex_errors"]) == 3 and got["best_threshold"] in (5.0, 10.0, 15.0)
        assert {"validation/min_abs_err", "validation/err4", "validation/depth_pred_5",
                "validation/depth_pred_10", "validation/depth_pred_15"} <= names
    np.testing.assert_array_equal(
        load_depth_png_mm(os.path.join(pred_dir, "pred_depth_step_7.png")),
        load_depth_png_mm(os.path.join(j_pred_dir, "pred_depth_step_7.png")))


def test_train_cli_messytable_dex(tmp_path, mt_dir):
    """``apps.train`` on the CPU, the fused loss's plain version with the
    luminance and depth terms: ``--ir --dex --depth-loss 0.5`` for 3
    steps with a validation at the end."""
    raw = _mt_cfg(tmp_path, mt_dir)
    raw["experiment"].update(train_iters=3, validate_every=3)
    raw["nerf"]["use_pallas"] = True
    cfg = str(tmp_path / "mt.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--ir", "--dex",
                           "--depth-loss", "0.5"]) == 0
    logdir = os.path.join(raw["experiment"]["logdir"], raw["experiment"]["id"])
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    depth_loss = [r["value"] for r in recs if r["tag"] == "train/depth_loss"]
    assert len(depth_loss) == 3 and np.isfinite(depth_loss).all()
    tags = {r["tag"] for r in recs}
    assert {"validation/depth_abs_err", "validation/depth_err4", "validation/min_abs_err",
            "validation/err4", "validation/depth_gt", "validation/depth_pred_err",
            "validation/depth_pred_5", "validation/depth_pred_10",
            "validation/depth_pred_15"} <= tags
    scalars = [r["value"] for r in recs if r["tag"].startswith("validation/") and "value" in r]
    assert np.isfinite(scalars).all()
    png = load_depth_png_mm(os.path.join(logdir, "pred_depth", "pred_depth_step_2.png"))
    assert png.shape == (16, 16) and (png >= 0).all()
