"""The depth half of the port (``dexnerf_tpu_torch/core/metrics.py``'s depth
metrics and error image, ``train/logging.py``'s millimeter PNGs, and
``train/loop.py``'s depth-scored validation, depth supervision and its
warmup) held to the JAX package on the CPU.

Tolerances: the metrics on the same inputs to 1e-6 relative (f32 sums in
another order), NaN where JAX gives NaN; the error image and the PNGs
exactly. ``validate`` of both packages on one set of weights: loss, PSNR,
SSIM and the depth errors in mm to rtol 1e-4 / atol 1e-3 (the port's
plain fused render against XLA's renderer, f32 both); the error fractions
within one masked pixel; ``best_threshold_index`` equal; Dex depths equal
(the same sample, within 1e-5) on >= 99.9% of (threshold, pixel) pairs;
the same set of logged tags.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core import metrics as pm
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.data.synthetic import (
    make_synthetic_scene,
    render_analytic_image,
    write_blender_dataset,
)
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.logging import (
    MetricsLogger,
    load_depth_png_mm,
    save_depth_png_mm,
)

METRIC_RTOL = 1e-6
VAL_RTOL, VAL_ATOL_MM = 1e-4, 1e-3
# a Dex depth is the depth of the first sample past the threshold: the same
# sample in both packages when they agree within DEX_ATOL (the fine depths
# of two f32 renders differ in the last bits)
DEX_EQUAL_SHARE, DEX_ATOL = 0.999, 1e-5
SIGMA_STD = 20.0  # σ logit spread of the shared weights (see shared_weights)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _depth_case(case, h=16, w=16, seed=0):
    """(gt, pred, mask) in meters: seeded GT in [0.3, 1.2] with 20% of
    pixels missing (0), predictions within ~10 mm of it; ``empty``: a mask
    with no pixel; ``no-gt``: no GT at all."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.3, 1.2, size=(h, w)).astype(np.float32)
    gt[rng.uniform(size=(h, w)) < 0.2] = 0.0
    pred = (gt + rng.normal(0.0, 0.006, size=(h, w))).astype(np.float32)
    if case == "no-gt":
        gt[:] = 0.0
    mask = (gt > 0) & (gt < 1.25)
    if case == "empty":
        mask[:] = False
    return gt, pred, mask


@pytest.mark.parametrize("case", ["seeded", "empty", "no-gt"])
def test_compute_err_metric_matches_jax(jax, case):
    from dexnerf_tpu.core.metrics import compute_err_metric as j_err

    gt, pred, mask = _depth_case(case)
    got = pm.compute_err_metric(gt, pred, mask)
    want = j_err(jax.numpy.asarray(gt), jax.numpy.asarray(pred), jax.numpy.asarray(mask))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, equal_nan=True, err_msg=k)
    if case == "seeded":
        assert all(np.isfinite(list(got.values()))) and 0 < got["depth_err2"] < 1
    else:  # JAX's unguarded mean over no pixel: NaN errors, fractions 0
        assert np.isnan(got["depth_abs_err"]) and np.isnan(got["depth_rmse"])
        assert got["depth_err2"] == got["depth_err4"] == got["depth_err8"] == 0.0
    # torch tensors give the same numbers
    t = pm.compute_err_metric(torch.tensor(gt), torch.tensor(pred), torch.tensor(mask))
    np.testing.assert_equal(t, got)


@pytest.mark.parametrize("case", ["seeded", "empty"])
def test_depth_error_img_matches_jax(case):
    from dexnerf_tpu.core.metrics import depth_error_img as j_img
    from dexnerf_tpu.core.metrics import gen_error_colormap_depth as j_cols

    np.testing.assert_array_equal(pm.gen_error_colormap_depth(), j_cols())
    gt, pred, mask = _depth_case(case, h=24, w=240)
    args = (pred[None] * 1000.0, gt[None] * 1000.0, mask[None])
    got = pm.depth_error_img(*(a.copy() for a in args))
    np.testing.assert_array_equal(got, j_img(*(a.copy() for a in args)))
    assert got.shape == (24, 240, 3) and got.dtype == np.float32
    # every band of the legend is stamped into the top rows
    assert len({tuple(c) for c in got[0, :220:20]}) == 11


def test_depth_png_roundtrip_both_loaders(tmp_path):
    """The port's uint32 millimeter PNG (PIL mode "I") reads back through
    both packages' loaders to the millimeter-truncated depth, and the JAX
    writer's file reads back the same through the port's loader."""
    from dexnerf_tpu.train.logging import load_depth_png_mm as j_load
    from dexnerf_tpu.train.logging import save_depth_png_mm as j_save

    depth = np.random.default_rng(4).uniform(0.0, 6.0, size=(9, 13)).astype(np.float32)
    want = (depth * 1000.0).astype(np.uint32).astype(np.float32) / 1000.0
    p, j = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    save_depth_png_mm(p, depth)
    j_save(j, depth)
    for path in (p, j):
        for load in (load_depth_png_mm, j_load):
            got = load(path)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


# ---- validate and _log_validation of both packages on one set of weights

def tiny_cfg(dataset: dict, logdir: str, *, m_thres=15, fine=True, **train) -> dict:
    """A 2x16 FlexibleNeRF config (PE 2/1, 4 + 4 samples, batch 16, Dex
    grid 5..``m_thres``) over ``dataset``."""
    model = {"type": "FlexibleNeRFModel", "num_layers": 2, "hidden_size": 16,
             "num_encoding_fn_xyz": 2, "num_encoding_fn_dir": 1}
    num_fine = 4 if fine else 0
    mode = {"chunksize": 64, "num_coarse": 4, "num_fine": num_fine, "white_background": False,
            "radiance_field_noise_std": 0.0, "lindisp": False, "m_thres": m_thres}
    return {
        "experiment": {"id": "depth", "logdir": logdir, "randomseed": 3, "train_iters": 2,
                       "validate_every": 1, "save_every": 0, "print_every": 1},
        "dataset": {"near": 2.0, "far": 6.0, "no_ndc": True, "half_res": False,
                    "testskip": 1, **dataset},
        "models": {"coarse": dict(model), **({"fine": dict(model)} if fine else {})},
        "optimizer": {"type": "Adam", "lr": 5.0e-3},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True,
                 "train": {**mode, "num_random_rays": 16, "perturb": True, **train},
                 "validation": {**mode, "perturb": False}},
    }


def shared_weights(jax, raw_cfg: dict, scene, idx: int):
    """JAX's seeded params for ``raw_cfg`` with each σ head rescaled so the
    σ logit over the view ``idx``'s coarse samples has mean 0 and std
    SIGMA_STD (random weights give ~1e-3, which crosses no Dex threshold),
    and the port's models holding the same weights."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.train.loop import setup_models as j_setup

    jcfg = JCfgNode(raw_cfg)
    apply_c, apply_f, params = j_setup(jcfg, 3)
    params = jax.tree.map(np.array, params)
    coarse, fine = ploop.setup_models(CfgNode(raw_cfg), 0, "cpu")
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    pose = torch.tensor(np.asarray(scene.poses[idx], np.float32))
    if scene.intrinsics is not None:
        ro, rd = get_ray_bundle_w2c(H, W, pose, torch.tensor(scene.intrinsics[idx]))
    else:
        ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    ds = raw_cfg["dataset"]
    z = stratified_z_vals(torch.full((H * W,), ds["near"]), torch.full((H * W,), ds["far"]),
                          raw_cfg["nerf"]["validation"]["num_coarse"])
    for name, model in (("coarse", coarse), ("fine", fine)):
        if model is None:
            continue
        model.load_state_dict(state_dict_from_flax(params[name]))
        with torch.no_grad():
            raw = model(positional_encoding(ro[:, None] + rd[:, None] * z[..., None],
                                            model.num_encoding_fn_xyz),
                        positional_encoding(vd, model.num_encoding_fn_dir))[..., 3]
        k = SIGMA_STD / float(raw.std())
        alpha = params[name]["params"][f"Dense_{model.num_layers + 1}"]  # fc_alpha
        alpha["kernel"] *= k
        alpha["bias"] = alpha["bias"] * k - float(raw.mean()) * k
        model.load_state_dict(state_dict_from_flax(params[name]))
    return types.SimpleNamespace(apply_c=apply_c, apply_f=apply_f, params=params,
                                 coarse=coarse, fine=fine)


def _tags(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return {(r["tag"], tuple(r.get("image_shape", ()))) for r in map(json.loads, f)}


def validate_both(jax, raw_cfg: dict, tmp_path, *, dex: bool, supervision="rgb", val_idx=None):
    """Each package's ``load_scene``, ``validate`` and ``_log_validation``
    on one set of weights. Returns (port metrics, JAX metrics, port tags,
    JAX tags, port pred_depth dir, JAX pred_depth dir)."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.train.logging import MetricsLogger as JLogger
    from dexnerf_tpu.train.loop import _log_validation as j_log
    from dexnerf_tpu.train.loop import load_scene as j_load_scene
    from dexnerf_tpu.train.loop import validate as j_validate

    jcfg, pcfg = JCfgNode(raw_cfg), CfgNode(raw_cfg)
    jscene, pscene = j_load_scene(jcfg), ploop.load_scene(pcfg)
    idx = int(pscene.i_val[0]) if val_idx is None else val_idx
    w = shared_weights(jax, raw_cfg, pscene, idx)
    want = j_validate(w.apply_c, w.apply_f, w.params, jscene, jcfg, dex=dex,
                      supervision=supervision, val_idx=idx)
    got = ploop.validate(w.coarse, w.fine, pscene, pcfg, supervision=supervision,
                         device="cpu", dex=dex, val_idx=idx)
    dirs = {k: str(tmp_path / f"log_{k}") for k in ("port", "jax")}
    with MetricsLogger(dirs["port"]) as logger:
        ploop._log_validation(logger, got, 7, dirs["port"])
    logger = JLogger(dirs["jax"], use_tensorboard=False)
    j_log(logger, want, 7, dirs["jax"])
    logger.close()
    return (got, want, _tags(dirs["port"]), _tags(dirs["jax"]),
            *(os.path.join(dirs[k], "pred_depth") for k in ("port", "jax")))


SCALARS = ("loss", "coarse_loss", "fine_loss", "psnr", "ssim")
MM_ERRORS = ("depth_abs_err", "depth_rmse")
FRACTIONS = ("depth_err2", "depth_err4", "depth_err8")


def _assert_errors(got: dict, want: dict, n_mask: int, err_msg=""):
    for k in MM_ERRORS:
        np.testing.assert_allclose(got[k], want[k], rtol=VAL_RTOL, atol=VAL_ATOL_MM,
                                   equal_nan=True, err_msg=f"{err_msg}{k}")
    for k in FRACTIONS:
        assert abs(got[k] - want[k]) <= 1.0 / max(n_mask, 1) + 1e-12, (err_msg, k, got[k], want[k])


def assert_validation_match(got: dict, want: dict):
    """The port's ``validate`` output against JAX's (module docstring)."""
    scored = {k for k in want if not isinstance(want[k], np.ndarray)} - {"index"}
    assert scored <= set(got), scored - set(got)
    for k in SCALARS:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=VAL_RTOL, err_msg=k)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=VAL_RTOL, atol=1e-4,
                                   err_msg=k)
    if "depth_gt" in want:
        np.testing.assert_array_equal(got["depth_gt"], want["depth_gt"])
        np.testing.assert_array_equal(got["depth_mask"], want["depth_mask"])
    n_mask = int(np.sum(want.get("depth_mask", 0)))
    if "depth_abs_err" in want:
        _assert_errors(got, want, n_mask)
    if "depth_dex" in want:
        assert got["m_thres_cand"] == tuple(want["m_thres_cand"])
        a, b = got["depth_dex"], np.asarray(want["depth_dex"])
        assert a.shape == b.shape
        same = float(np.mean(np.abs(a - b) <= DEX_ATOL))
        assert same >= DEX_EQUAL_SHARE, same
        assert len(np.unique(a)) > a.shape[0] + 1  # thresholds crossed at many depths
    if "dex_errors" in want:
        assert got["best_threshold_index"] == want["best_threshold_index"]
        assert got["best_threshold"] == want["best_threshold"]
        assert len(got["dex_errors"]) == len(want["dex_errors"])
        for t, (eg, ew) in enumerate(zip(got["dex_errors"], want["dex_errors"])):
            _assert_errors(eg, ew, n_mask, err_msg=f"threshold {t}: ")
        np.testing.assert_allclose(got["min_abs_err"], want["min_abs_err"], rtol=VAL_RTOL,
                                   atol=VAL_ATOL_MM)
        assert abs(got["err4"] - want["err4"]) <= 1.0 / max(n_mask, 1) + 1e-12
        np.testing.assert_array_equal(got["best_depth"],
                                      got["depth_dex"][got["best_threshold_index"]])


def write_blender_depth_scene(basedir: str, sidecars) -> None:
    """A 16x16 blender scene of the port's writer (2 train, 1 val, 1 test
    view) with ``d_k.npy`` sidecars of the analytic depths for the views
    named in ``sidecars`` ((split, k) pairs)."""
    write_blender_dataset(basedir, height=16, width=16, views_per_split=(2, 1, 1))
    for split, k in sidecars:
        with open(os.path.join(basedir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        c2w = np.array(meta["frames"][k]["transform_matrix"], np.float32)
        focal = 0.5 * 16 / np.tan(0.5 * meta["camera_angle_x"])
        _, depth = render_analytic_image(c2w, 16, 16, focal)
        np.save(os.path.join(basedir, split, f"d_{k}.npy"), depth.astype(np.float32))


@pytest.mark.parametrize("case", ["gt", "gt-dex", "empty-mask", "no-gt-view"])
def test_validate_blender_depth_matches_jax(jax, tmp_path, case):
    """Standard-mode validation on a blender scene with ``d_k.npy``
    sidecars (Queue 3 fault 5): the expected depth scored as JAX scores it
    (``gt``; ``gt-dex`` with the threshold sweep too); with the default
    ``depth_valid_max`` of 1.25 m the validity mask over the scene's ~4 m
    depths is empty and both give NaN errors (``empty-mask``); a view
    without a sidecar is skipped by both (``no-gt-view``)."""
    data = str(tmp_path / "scene")
    sidecars = [("train", 1)] if case == "no-gt-view" else [("val", 0), ("train", 0)]
    write_blender_depth_scene(data, sidecars)
    dataset = {"type": "blender", "basedir": data}
    if case != "empty-mask":
        dataset["depth_valid_max"] = 6.0
    got, want, tags, j_tags, pred_dir, j_pred_dir = validate_both(
        jax, tiny_cfg(dataset, str(tmp_path)), tmp_path, dex=case == "gt-dex")
    assert_validation_match(got, want)
    assert tags == j_tags, tags ^ j_tags
    names = {t for t, _ in tags}
    if case == "no-gt-view":
        assert "depth_abs_err" not in got and "validation/depth_abs_err" not in names
        assert "validation/depth_pred_err" in names  # the image is logged, as in JAX
    elif case == "empty-mask":
        assert np.isnan(got["depth_abs_err"]) and got["depth_err4"] == 0.0
    else:
        assert np.isfinite(got["depth_abs_err"]) and {
            "validation/depth_abs_err", "validation/depth_err4", "validation/depth_gt",
            "validation/depth_pred_err"} <= names
    png = os.path.join(pred_dir, "pred_depth_step_7.png")
    np.testing.assert_array_equal(load_depth_png_mm(png),
                                  load_depth_png_mm(os.path.join(j_pred_dir,
                                                                 "pred_depth_step_7.png")))


def test_validate_without_depths_logs_no_depth(jax, tmp_path):
    """A scene without any GT depth: no depth metric, image or PNG on
    either side."""
    data = str(tmp_path / "scene")
    write_blender_dataset(data, height=16, width=16, views_per_split=(2, 1, 1))
    got, want, tags, j_tags, pred_dir, _ = validate_both(
        jax, tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path)), tmp_path, dex=False)
    assert_validation_match(got, want)
    assert tags == j_tags and not any("depth" in t for t, _ in tags)
    assert not os.path.exists(pred_dir)


# ---- depth supervision in run_training, as tests/test_depth_supervision.py

def _synthetic_scene(with_depth=True):
    images, depths, poses, hwf = make_synthetic_scene(num_views=3, height=8, width=8)
    return ploop.SceneData(images=images, poses=poses, hwf=hwf, i_train=np.array([0, 1]),
                           i_val=np.array([2]), depths=depths if with_depth else None)


def _run(tmp_path, *, pallas, fine=True, iters=4, name="run", **kw):
    raw = tiny_cfg({"type": "blender", "basedir": ""}, str(tmp_path), fine=fine,
                   **kw.pop("train", {}))
    raw["experiment"].update(id=name, train_iters=iters, validate_every=0)
    raw["nerf"]["use_pallas"] = pallas
    scene = kw.pop("scene", None) or _synthetic_scene()
    out = ploop.run_training(CfgNode(raw), scene=scene, device="cpu", **kw)
    with open(os.path.join(out["logdir"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return out, recs


def _depth_steps(recs):
    return sorted(r["step"] for r in recs if r["tag"] == "train/depth_loss")


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "plain"])
def test_run_training_with_depth_loss(tmp_path, pallas):
    out, recs = _run(tmp_path, pallas=pallas, iters=2, depth_loss_weight=0.5)
    assert np.isfinite(out["final_train_metrics"]["depth_loss"])
    assert _depth_steps(recs) == [0, 1]
    with pytest.raises(ValueError, match="no GT depth"):
        _run(tmp_path, pallas=pallas, name="nod", depth_loss_weight=0.5,
             scene=_synthetic_scene(with_depth=False))


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "plain"])
def test_depth_warmup_switches_supervision_on(tmp_path, pallas):
    """A fixed warmup runs its iterations without the depth term, then the
    supervised step; a warmup longer than the run never switches."""
    out, recs = _run(tmp_path, pallas=pallas, fine=False, depth_loss_weight=0.5,
                     depth_warmup=2)
    assert _depth_steps(recs) == [2, 3]
    assert np.isfinite(out["final_train_metrics"]["depth_loss"])
    assert "depth_on_step" not in out
    out2, recs2 = _run(tmp_path, pallas=pallas, fine=False, name="long",
                       depth_loss_weight=0.5, depth_warmup=10)
    assert "depth_loss" not in out2["final_train_metrics"] and not _depth_steps(recs2)


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "plain"])
def test_depth_warmup_auto_switches_on_psnr(tmp_path, pallas):
    """Warmup -1 stays depth-free until the train PSNR at print cadence
    passes ``nerf.train.depth_warmup_psnr``, then logs and returns the
    switch step."""
    out, recs = _run(tmp_path, pallas=pallas, fine=False, depth_loss_weight=0.5,
                     depth_warmup=-1, train={"depth_warmup_psnr": -100.0})
    assert out["depth_on_step"] == 1
    assert [r["value"] for r in recs if r["tag"] == "train/depth_on_step"] == [1]
    assert _depth_steps(recs) == [1, 2, 3]
    out2, recs2 = _run(tmp_path, pallas=pallas, fine=False, name="never",
                       depth_loss_weight=0.5, depth_warmup=-1,
                       train={"depth_warmup_psnr": 1000.0})
    assert out2["depth_on_step"] is None and not _depth_steps(recs2)
    assert "depth_loss" not in out2["final_train_metrics"]
