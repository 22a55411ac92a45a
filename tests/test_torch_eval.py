"""The evaluation entry point of the port (``dexnerf_tpu_torch/apps/eval.py``)
and what it writes (``utils/images.py``, ``utils/pointcloud.py``,
``core/volrend.py::depth_confidence``) held to the JAX package on the CPU.

Both packages' ``apps.eval`` mains read one reference ``.ckpt`` (seeded
weights whose σ heads are calibrated on the scored view, so that the Dex
thresholds cross) on a blender scene with ``d_`` and ``d_dex_`` sidecars, a
messytable scene and an LLFF (NDC) scene. Tolerances: ``metrics.json``
PSNR 1e-4 dB, SSIM 1e-5, the mm depth errors rtol 1e-4 (atol 1e-3 mm), the
error fractions within one masked pixel, the confidence mean within one
8-bit level of one pixel,
``dex_best_m`` and ``dex_gt`` equal; every PNG and GIF frame within one
8-bit level (the jet disparity within one colormap entry; disparity not
compared where JAX's is NaN, on rays with no accumulation); the PLYs'
point counts equal. The helpers: the image casts,
the jet colormap and the PLY bytes equal to JAX's; ``depth_confidence``
to 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_depth import SIGMA_STD, tiny_cfg

from dexnerf_tpu_torch import utils as pu
from dexnerf_tpu_torch.apps import eval as eval_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.core.volrend import depth_confidence
from dexnerf_tpu_torch.data.synthetic import (
    render_analytic_image,
    write_blender_dataset,
    write_llff_dataset,
    write_messytable_dataset,
)
from dexnerf_tpu_torch.render.renderer import make_ray_batch
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import write_reference_checkpoint

PSNR_ATOL, SSIM_ATOL = 1e-4, 1e-5
MM_RTOL, MM_ATOL = 1e-4, 1e-3
CONF_ATOL = 1e-6
PNG_LEVELS = 1


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


# ---- the helpers


def _floats(seed, shape):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_images_match_jax(dtype):
    """The image casts and the jet colormap give JAX's bytes, on values
    outside [0, 1] too, and jet on NaN."""
    from dexnerf_tpu import utils as ju

    rgb = _floats(0, (9, 11, 3)).astype(dtype)
    gray = _floats(1, (9, 11)).astype(dtype)
    disp = (3.0 * _floats(2, (9, 11))).astype(dtype)
    jet_in = gray.copy()
    jet_in[0, :3] = (np.nan, 0.0, 1.0)
    for name, args in (("cast_to_image", (rgb,)), ("cast_to_gray_image", (rgb,)),
                       ("cast_to_gray_image", (gray,)), ("cast_to_disparity_image", (disp,)),
                       ("apply_jet_colormap", (jet_in,)), ("apply_jet_colormap", (gray,))):
        got, want = getattr(pu, name)(*args), getattr(ju, name)(*args)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("colors", [True, False])
@pytest.mark.parametrize("confidence", [True, False])
def test_write_ply_matches_jax(tmp_path, colors, confidence):
    """``depth_to_points`` and ``write_ply`` give JAX's points and bytes;
    ``read_ply`` reads them back."""
    from dexnerf_tpu.utils import depth_to_points as j_points
    from dexnerf_tpu.utils import write_ply as j_write

    rng = np.random.default_rng(3)
    ro = rng.normal(size=(6, 7, 3)).astype(np.float32)
    rd = rng.normal(size=(6, 7, 3)).astype(np.float32)
    depth = rng.uniform(-0.5, 4.0, (6, 7)).astype(np.float32)
    depth[0, 0] = np.nan
    rgb = _floats(4, (6, 7, 3))
    mask = rng.uniform(size=(6, 7)) > 0.3
    kw = dict(rgb=rgb if colors else None, mask=mask, return_keep=True)
    pts, cols, keep = pu.depth_to_points(ro, rd, depth, **kw)
    j_pts, j_cols, j_keep = j_points(ro, rd, depth, **kw)
    np.testing.assert_array_equal(keep, j_keep)
    np.testing.assert_array_equal(pts, j_pts)
    conf = rng.uniform(size=int(keep.sum())).astype(np.float32) if confidence else None
    pu.write_ply(str(tmp_path / "port.ply"), pts, cols, confidence=conf)
    j_write(str(tmp_path / "jax.ply"), j_pts, j_cols, confidence=conf)
    got, want = (open(tmp_path / f"{k}.ply", "rb").read() for k in ("port", "jax"))
    assert got == want
    back, back_cols = pu.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(back, pts, atol=1e-6)
    assert (back_cols is None) == (not colors)


def test_depth_confidence_matches_jax(jax):
    from dexnerf_tpu.core import depth_confidence as j_conf

    rng = np.random.default_rng(5)
    w = rng.uniform(size=(7, 9, 16)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (7, 9, 16)), -1).astype(np.float32)
    depth = (w * z).sum(-1)
    for delta in (0.05, 0.3):
        got = depth_confidence(torch.tensor(w), torch.tensor(z), torch.tensor(depth), delta)
        want = j_conf(jax.numpy.asarray(w), jax.numpy.asarray(z), jax.numpy.asarray(depth),
                      delta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---- both mains on one checkpoint


def _blender_scene(base):
    """A 16x16 blender scene with ``d_`` (the analytic expected depth) and
    ``d_dex_`` (that depth plus 3 cm: a surface GT that differs from it)
    sidecars of its test view."""
    write_blender_dataset(base, height=16, width=16, views_per_split=(2, 1, 1))
    with open(os.path.join(base, "transforms_test.json")) as f:
        meta = json.load(f)
    c2w = np.array(meta["frames"][0]["transform_matrix"], np.float32)
    focal = 0.5 * 16 / np.tan(0.5 * meta["camera_angle_x"])
    _, depth = render_analytic_image(c2w, 16, 16, focal)
    np.save(os.path.join(base, "test", "d_0.npy"), depth.astype(np.float32))
    np.save(os.path.join(base, "test", "d_dex_0.npy"), (depth + 0.03).astype(np.float32))
    return {"type": "blender", "basedir": base, "depth_valid_max": 6.0}


def _messytable_scene(base):
    """Loaded at 32x32: SSIM's 11x11 windows leave 36 positions on a 16x16
    frame, where its mean moves by 1e-5 with the renders' f32 round-off on
    this low-contrast gray scene; 484 here."""
    write_messytable_dataset(base, height=64, width=64, views_per_split=(2, 1, 1))
    return {"type": "messytable", "basedir": base, "depth_valid_max": 6.0}


def _llff_scene(base):
    write_llff_dataset(base, 16, 24, views=9)
    return {"type": "llff", "basedir": base, "near": 0.0, "far": 1.0, "no_ndc": False,
            "downsample_factor": 1, "llffhold": 8, "depth_valid_max": 10.0}


SCENES = {"blender": _blender_scene, "messytable": _messytable_scene, "llff": _llff_scene}


def calibrated_checkpoint(raw_cfg: dict, path: str, hwf=None) -> None:
    """Seeded port models whose σ heads give mean 0 and std SIGMA_STD over
    the coarse samples of the scene's first held-out view (its NDC samples
    on an LLFF scene), written as a reference ``.ckpt``."""
    cfg = CfgNode(raw_cfg)
    scene = ploop.load_scene(cfg)
    coarse, fine = ploop.setup_models(cfg, 0, "cpu")
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    idx = int(np.asarray(scene.i_test).ravel()[0])
    pose = torch.tensor(np.asarray(scene.poses[idx], np.float32))
    if scene.intrinsics is not None:
        ro, rd = get_ray_bundle_w2c(H, W, pose, torch.tensor(scene.intrinsics[idx]))
    else:
        ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
    ds = raw_cfg["dataset"]
    rays = make_ray_batch(ro, rd, ds["near"], ds["far"], use_ndc=scene.use_ndc, height=H,
                          width=W, focal_length=focal)
    z = stratified_z_vals(rays.near, rays.far, raw_cfg["nerf"]["validation"]["num_coarse"])
    pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
    for model in (coarse, fine):
        with torch.no_grad():
            raw = model(positional_encoding(pts, model.num_encoding_fn_xyz),
                        positional_encoding(rays.viewdirs, model.num_encoding_fn_dir))[..., 3]
            k = SIGMA_STD / float(raw.std())
            model.fc_alpha.weight.mul_(k)
            model.fc_alpha.bias.copy_((model.fc_alpha.bias - float(raw.mean())) * k)
    write_reference_checkpoint(path, coarse.state_dict(), fine.state_dict(), hwf=hwf)


EVAL_FLAGS = ["--test-set", "--dex-depth", "--save-pointcloud", "--pointcloud-threshold", "10",
              "--save-depth-confidence", "0.05", "--save-disparity-image",
              "--save-jet-disparity", "--save-gif"]


def run_both(tmp_path, raw_cfg: dict, flags, hwf=None):
    """Write the config and a calibrated checkpoint, run both packages'
    ``apps.eval`` main with ``flags``; returns the two save directories."""
    from dexnerf_tpu.apps.eval import main as j_main

    cfg_path, ckpt = str(tmp_path / "eval.yml"), str(tmp_path / "model.ckpt")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw_cfg, f)
    if not os.path.exists(ckpt):
        calibrated_checkpoint(raw_cfg, ckpt, hwf=hwf)
    dirs = {k: str(tmp_path / f"renders_{k}") for k in ("port", "jax")}
    common = ["--config", cfg_path, "--checkpoint", ckpt, *flags]
    assert eval_app.main([*common, "--savedir", dirs["port"], "--device", "cpu"]) == 0
    assert j_main([*common, "--savedir", dirs["jax"], "--platform", "cpu"]) == 0
    return dirs


def _scored_pixels(raw_cfg: dict) -> dict:
    """Held-out view index -> (pixels the depth_* columns are scored on,
    pixels the dex_* columns are scored on): the GT masks of both mains,
    the ``d_`` sidecar's and the ``d_dex_`` sidecar's where there is one."""
    cfg = CfgNode(raw_cfg)
    scene = ploop.load_scene(cfg)
    valid_max = float(raw_cfg["dataset"]["depth_valid_max"])
    dex_gt = eval_app._dex_gt(cfg, scene)
    counts = {}
    for idx in np.asarray(scene.i_test).ravel():
        d = np.asarray(scene.depths[idx])
        g = d if dex_gt is None else np.asarray(dex_gt[idx])
        counts[int(idx)] = tuple(int(((a > 0) & (a < valid_max)).sum()) for a in (d, g))
    return counts


def _jet_step() -> int:
    """8-bit levels between neighbouring entries of the jet colormap: a
    disparity one rounding apart may pick the next entry."""
    lut = (pu.images._jet_lut()[:-1] * 255).astype(np.uint8).astype(np.int16)
    return int(np.abs(np.diff(lut, axis=0)).max()) + PNG_LEVELS


def _assert_pngs_close(dirs):
    """Every PNG of the JAX run has a port twin within PNG_LEVELS (the jet
    disparity within one colormap entry, ``_jet_step``)."""
    n = 0
    for root, _, files in os.walk(dirs["jax"]):
        for name in files:
            if not name.endswith(".png"):
                continue
            rel = os.path.relpath(os.path.join(root, name), dirs["jax"])
            a = np.asarray(Image.open(os.path.join(dirs["port"], rel)), np.int16)
            b = np.asarray(Image.open(os.path.join(dirs["jax"], rel)), np.int16)
            assert a.shape == b.shape, rel
            err = np.abs(a - b)
            if rel.startswith("disparity"):
                # a ray with no accumulation: the port's disparity is the
                # fused kernel's finite 1e10 (255, jet's last entry), JAX's
                # XLA renderer's 0/0 (NaN, cast to 0, black)
                empty = (b.reshape(*b.shape[:2], -1) == 0).all(-1)
                err[empty] = 0
            tol = _jet_step() if rel.startswith("disparity_jet") else PNG_LEVELS
            assert err.max() <= tol, rel
            n += 1
    return n


def _gif_frames(path):
    with Image.open(path) as im:
        frames = []
        for k in range(im.n_frames):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB"), np.int16))
        return frames, im.info.get("duration"), im.info.get("loop")


@pytest.mark.parametrize("scene", list(SCENES))
def test_eval_matches_jax(jax, tmp_path, scene):
    """Both mains on one ``.ckpt`` with every output flag: ``metrics.json``,
    the PNGs, the GIF and the point clouds agree (module docstring)."""
    dataset = SCENES[scene](str(tmp_path / "data"))
    raw = tiny_cfg(dataset, str(tmp_path / "logs"))
    dirs = run_both(tmp_path, raw, EVAL_FLAGS)
    got, want = (json.load(open(os.path.join(dirs[k], "metrics.json"))) for k in ("port", "jax"))
    assert set(got) == set(want) and set(got["mean"]) == set(want["mean"])
    assert got["dex_gt"] == want["dex_gt"] == ("expected" if scene == "messytable"
                                               else "sigma_sidecar")
    assert len(got["per_image"]) == len(want["per_image"]) >= 1
    n_pix = np.asarray(Image.open(os.path.join(dirs["jax"], "0000.png"))).shape[0] * \
        np.asarray(Image.open(os.path.join(dirs["jax"], "0000.png"))).shape[1]
    # the error fractions: one pixel of the view's masked ones may fall on
    # either side of a band (the mean row: of each view's, averaged)
    scored = _scored_pixels(raw)
    one_px = [(1.0 / scored[r["index"]][0], 1.0 / scored[r["index"]][1])
              for r in want["per_image"]]
    one_px.append(tuple(np.mean(one_px, axis=0)))
    for (g, w), (px_depth, px_dex) in zip(
            [*zip(got["per_image"], want["per_image"]), (got["mean"], want["mean"])], one_px):
        assert set(g) == set(w)
        assert {"depth_abs_err", "dex_abs_err", "dex_best_m", "depth_conf"} <= set(w)
        assert g.get("index") == w.get("index") and g["dex_best_m"] == w["dex_best_m"]
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0, atol=PSNR_ATOL)
        np.testing.assert_allclose(g["ssim"], w["ssim"], rtol=0, atol=SSIM_ATOL)
        # a sample at the ±delta boundary may fall on either side: the
        # mean within one 8-bit level of one pixel, as the PNGs
        np.testing.assert_allclose(g["depth_conf"], w["depth_conf"], rtol=0,
                                   atol=CONF_ATOL + 1.0 / (255 * n_pix))
        for k in ("depth_abs_err", "depth_rmse", "dex_abs_err", "dex_rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=MM_RTOL, atol=MM_ATOL, err_msg=k)
        for k in ("depth_err2", "depth_err4", "depth_err8"):
            assert abs(g[k] - w[k]) <= px_depth + 1e-12, k
        for k in ("dex_err2", "dex_err4", "dex_err8"):
            assert abs(g[k] - w[k]) <= px_dex + 1e-12, k
    assert np.isfinite(got["mean"]["dex_abs_err"])
    # images: frames, disparity, jet, confidence, depth error
    assert _assert_pngs_close(dirs) == 5 * len(got["per_image"])
    (gf, g_dur, g_loop), (jf, j_dur, j_loop) = (
        _gif_frames(os.path.join(dirs[k], "render.gif")) for k in ("port", "jax"))
    assert len(gf) == len(jf) and (g_dur, g_loop) == (j_dur, j_loop)
    for a, b in zip(gf, jf):
        assert np.abs(a - b).max() <= PNG_LEVELS
    for name in sorted(os.listdir(os.path.join(dirs["jax"], "pointcloud"))):
        a, b = (pu.read_ply(os.path.join(dirs[k], "pointcloud", name))[0] for k in ("port", "jax"))
        assert a.shape == b.shape and a.shape[0] > 0, name


def test_eval_dataset_free_reference_ckpt(jax, tmp_path):
    """A reference ``.ckpt`` that carries its frame geometry renders the
    blender spherical path without the dataset, as JAX's main does; the
    config's declared 8x64 model is reconciled with the checkpoint's 2x16
    weights."""
    src = tiny_cfg({"type": "blender", "basedir": str(tmp_path / "data")}, str(tmp_path))
    write_blender_dataset(str(tmp_path / "data"), height=12, width=12, views_per_split=(1, 1, 1))
    calibrated_checkpoint(src, str(tmp_path / "model.ckpt"), hwf=(12, 12, 15.0))
    raw = tiny_cfg({"type": "blender", "basedir": str(tmp_path / "missing")}, str(tmp_path))
    for name in ("coarse", "fine"):
        raw["models"][name].update(num_layers=8, hidden_size=64)
    with pytest.warns(UserWarning, match="architecture"):
        dirs = run_both(tmp_path, raw, ["--num-poses", "2"])
    assert sorted(os.listdir(dirs["port"])) == ["0000.png", "0001.png"]
    assert np.asarray(Image.open(os.path.join(dirs["port"], "0000.png"))).shape == (12, 12, 3)
    assert _assert_pngs_close(dirs) == 2


@pytest.mark.parametrize("flag", [
    ["--sg-ir"], ["--refined-poses"], ["--occupancy", "0.2"], ["--occupancy-resolution", "64"],
    ["--occupancy-radius", "1.0"], ["--occupancy-center", "0", "0", "0"],
    ["--occupancy-dilate", "2"], ["--occupancy-probes", "32"], ["--occupancy-subsample", "1"],
], ids=lambda f: f[0].lstrip("-"))
def test_refused_flags_name_their_item(flag):
    """The flags of Queue 1 items 8 (occupancy), 9 (``--refined-poses``) and
    10 (``--sg-ir``), once refused naming their item, are ported: each
    passes the flag checks, and the main goes on to read the (missing)
    config."""
    argv = ["--config", "unused.yml", "--checkpoint", "unused.ckpt", "--device", "cpu", *flag]
    with pytest.raises(FileNotFoundError, match="unused.yml"):
        eval_app.main(argv)


@pytest.mark.parametrize("case", ["dex-without-test-set", "pc-threshold-without-pc",
                                  "dex-without-sidecars", "missing-llff", "missing-hwf"])
def test_eval_refusals_match_jax(jax, tmp_path, case):
    """The checks of JAX's main exit both mains with the same message."""
    from dexnerf_tpu.apps.eval import main as j_main

    data = str(tmp_path / "data")
    dataset = {"type": "blender", "basedir": data}
    flags = {"dex-without-test-set": ["--dex-depth"],
             "pc-threshold-without-pc": ["--pointcloud-threshold", "10"],
             "dex-without-sidecars": ["--test-set", "--dex-depth"]}.get(case, [])
    raw = tiny_cfg(dataset, str(tmp_path))
    write_blender_dataset(data, height=8, width=8, views_per_split=(1, 1, 1))
    calibrated_checkpoint(raw, str(tmp_path / "model.ckpt"))
    if case == "missing-llff":
        raw["dataset"].update(type="llff", basedir=str(tmp_path / "missing"))
    elif case == "missing-hwf":
        raw["dataset"]["basedir"] = str(tmp_path / "missing")
    cfg_path = str(tmp_path / "eval.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    args = ["--config", cfg_path, "--checkpoint", str(tmp_path / "model.ckpt"), *flags,
            "--savedir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as got:
        eval_app.main([*args, "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        j_main([*args, "--platform", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
