"""The LLFF/NDC data path of the port (``core/rays.py``'s ``ndc_rays`` and
``ndc_t_to_world_depth``, ``data/llff.py``, ``write_llff_dataset``,
``build_ray_store(use_ndc=True)``, the LLFF ``load_scene``, training and
validation on NDC rays) held to the JAX package on the CPU.

Tolerances: NDC rays and world depths rtol 1e-5 / atol 1e-6 (f32 both
sides); the loaders' poses, bounds and render paths to 1e-6, ``i_test``
equal, images within one 8-bit level of the JAX loader's (whose minify is
OpenCV's ``INTER_AREA``; the port's integer-factor block mean is held to
it exactly on random pixels); the ray store's rows 1e-5; three Adam steps
as ``tests/test_torch_train_step.py``; ``validate`` as
``tests/test_torch_depth.py``.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_depth import SIGMA_STD, assert_validation_match, tiny_cfg
from test_torch_train_step import (
    ARCH,
    BATCH,
    LR,
    LR_DECAY,
    LR_FACTOR,
    MOMENT_RTOL,
    PARAM_ATOL,
    SETTINGS,
    STEPS,
    _port_models,
    _step_draws,
)
from test_torch_train_step import jx  # noqa: F401  (the fixture)

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, ndc_rays, ndc_t_to_world_depth
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.data.llff import load_llff_data, load_llff_depths
from dexnerf_tpu_torch.data.resize import area_resize
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import (
    LLFF_DEX_THRESHOLD,
    LLFF_PLANES,
    LLFF_SPHERES,
    analytic_field,
    write_llff_dataset,
)
from dexnerf_tpu_torch.ops.fused_train_loss import make_fused_train_loss
from dexnerf_tpu_torch.render.renderer import make_ray_batch
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

NDC_RTOL, NDC_ATOL = 1e-5, 1e-6
POSE_ATOL = 1e-6
RAY_ATOL = 1e-5
LLFF_HW = (32, 48)  # the written frame; 4 x 6 at factor 8
NDC_SIGMA_STD = 3.0  # σ spread of the NDC train-step test's heads (see jx_ndc)
ADAM_EPS = 1e-8  # torch.optim.Adam's and optax.adam's default


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _rays(seed, h=6, w=8):
    """Seeded forward-facing world rays: origins near 0, directions with
    z in [-1.5, -0.5] (in front of the near plane), as the loader's
    cameras give."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(scale=0.2, size=(h, w, 3)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.6, 0.6, (h, w, 2)), rng.uniform(-1.5, -0.5, (h, w, 1))],
                        -1).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ndc_rays_matches_jax(jax, seed):
    from dexnerf_tpu.core.rays import ndc_rays as j_ndc

    ro, rd = _rays(seed)
    for near in (1.0, 0.5):
        got = ndc_rays(6, 8, 7.3, near, torch.tensor(ro), torch.tensor(rd))
        want = j_ndc(6, 8, 7.3, near, jax.numpy.asarray(ro), jax.numpy.asarray(rd))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == (6, 8, 3)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=NDC_RTOL, atol=NDC_ATOL)


@pytest.mark.parametrize("shape", ["hw", "thw"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ndc_t_to_world_depth_matches_jax(jax, seed, shape):
    """[H, W] and threshold-swept [T, H, W] parameters, t = 1 included (the
    far plane at infinity, kept finite by the -1e-6 clamp)."""
    from dexnerf_tpu.core.rays import ndc_t_to_world_depth as j_depth

    ro, rd = _rays(seed)
    rng = np.random.default_rng(10 + seed)
    t = rng.uniform(0, 1, (6, 8) if shape == "hw" else (5, 6, 8)).astype(np.float32)
    t[..., 0, 0] = 1.0
    t[..., 0, 1] = 0.0
    got = ndc_t_to_world_depth(torch.tensor(t), torch.tensor(ro), torch.tensor(rd), 6, 8, 7.3)
    want = np.asarray(j_depth(jax.numpy.asarray(t), jax.numpy.asarray(ro),
                              jax.numpy.asarray(rd), 6, 8, 7.3))
    assert got.shape == t.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=NDC_RTOL, atol=NDC_ATOL)


def test_ndc_t_to_world_depth_inverts_the_projection():
    """A world point at ray distance s, projected into NDC and read back,
    gives s again."""
    ro, rd = _rays(3)
    ro_t, rd_t = torch.tensor(ro, dtype=torch.float64), torch.tensor(rd, dtype=torch.float64)
    s = torch.linspace(1.5, 9.0, 48, dtype=torch.float64).reshape(6, 8)
    unit = rd_t / torch.linalg.norm(rd_t, dim=-1, keepdim=True)
    p = ro_t + s[..., None] * unit
    o_n, d_n = ndc_rays(6, 8, 7.3, 1.0, ro_t, rd_t)
    t = (1.0 + 2.0 / p[..., 2] - o_n[..., 2]) / d_n[..., 2]  # the point's NDC z on the ray
    np.testing.assert_allclose(ndc_t_to_world_depth(t, ro_t, rd_t, 6, 8, 7.3).numpy(),
                               s.numpy(), rtol=1e-9)


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_area_downsample_matches_cv2(factor):
    """On random pixels the port's area resize at an integer factor is
    OpenCV's ``INTER_AREA``, which the JAX package's minify calls, exactly."""
    import cv2

    img = np.random.default_rng(factor).integers(0, 256, (factor * 5, factor * 7, 3),
                                                 dtype=np.uint8)
    np.testing.assert_array_equal(
        area_resize(img, (5, 7)),
        cv2.resize(img, (7, 5), interpolation=cv2.INTER_AREA))


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("data") / "llff")
    write_llff_dataset(base, *LLFF_HW, views=10)
    return base


@pytest.mark.parametrize("spherify", [False, True], ids=["spiral", "spherify"])
@pytest.mark.parametrize("factor", [1, 8])
def test_load_llff_data_matches_jax(jax, tmp_path, llff_dir, factor, spherify):
    """Each package's loader on its own copy of one written dataset (each
    minifies into it)."""
    from dexnerf_tpu.data.llff import load_llff_data as j_load

    copies = {}
    for k in ("port", "jax"):
        copies[k] = str(tmp_path / k)
        shutil.copytree(llff_dir, copies[k])
    got = load_llff_data(copies["port"], factor=factor, spherify=spherify)
    want = j_load(copies["jax"], factor=factor, spherify=spherify)
    images, poses, bds, render_poses, i_test = got
    h, w = LLFF_HW[0] // factor, LLFF_HW[1] // factor
    assert images.shape == (10, h, w, 3) and images.dtype == np.float32
    assert i_test == want[4]
    assert np.abs(images - want[0]).max() <= 1.0 / 255 + 1e-6
    for name, a, b in (("poses", poses, want[1]), ("bds", bds, want[2]),
                       ("render_poses", render_poses, want[3])):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=POSE_ATOL, atol=POSE_ATOL, err_msg=name)
    assert poses[0, 0, 4] == h and poses[0, 1, 4] == w
    assert render_poses.shape == (120, 3, 5)


def test_unported_factor_raises(jax, tmp_path, llff_dir):
    """A factor that does not divide the 32x48 frame raised until ROADMAP
    item 4c; now the minify writes OpenCV's ``INTER_AREA`` at
    ``(H // 5, W // 5)`` and the load equals the JAX loader's."""
    from dexnerf_tpu.data.llff import load_llff_data as j_load

    copies = {k: str(tmp_path / k) for k in ("port", "jax")}
    for k in copies:
        shutil.copytree(llff_dir, copies[k])
    got = load_llff_data(copies["port"], factor=5)
    want = j_load(copies["jax"], factor=5)
    assert got[0].shape == (10, LLFF_HW[0] // 5, LLFF_HW[1] // 5, 3)
    np.testing.assert_array_equal(got[0], want[0])
    for name, a, b in (("poses", got[1], want[1]), ("bds", got[2], want[2])):
        np.testing.assert_allclose(a, b, rtol=POSE_ATOL, atol=POSE_ATOL, err_msg=name)


def test_write_llff_dataset_geometry(llff_dir):
    """The writer's GT holds with the loader: each view's depth sidecar,
    a ray distance along the loaded camera's rays, lands on the analytic
    scene's surfaces, and the σ-threshold surface lies behind the expected
    depth's start and within the frame's bounds."""
    images, poses, bds, _, _ = load_llff_data(llff_dir, factor=None)
    assert float(bds.min()) == pytest.approx(4.0 / 3.0) and float(bds.max()) == 8.0
    H, W = LLFF_HW
    for v in range(len(images)):
        ro, rd = get_ray_bundle_c2w(H, W, float(poses[v, 2, 4]), torch.tensor(poses[v, :3, :4]))
        unit = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        for prefix, limit in (("d_", 1.0), ("d_dex_", LLFF_DEX_THRESHOLD)):
            d = torch.tensor(load_llff_depths(llff_dir, len(images), prefix)[v])
            assert bool((d > 1.0).all()) and bool((d < 8.5).all())
            sigma = analytic_field(ro + unit * d[..., None], spheres=LLFF_SPHERES,
                                   planes=LLFF_PLANES)[..., 3]
            assert float(torch.median(sigma)) > limit, (v, prefix)


def test_load_scene_llff_and_ndc_store_match_jax(jax, tmp_path, llff_dir):
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.train.loop import load_scene as j_load_scene

    raw = _llff_cfg(tmp_path, llff_dir)
    got, want = ploop.load_scene(CfgNode(raw)), j_load_scene(JCfgNode(raw))
    assert got.use_ndc and want.use_ndc and got.hwf == want.hwf
    np.testing.assert_allclose(got.images, want.images, atol=1.0 / 255 + 1e-6)
    for field in ("poses", "render_poses"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), atol=POSE_ATOL,
                                   err_msg=field)
    for field in ("i_train", "i_val", "i_test", "depths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert list(got.i_val) == [0, 8] and len(got.i_train) == 8
    tr = got.i_train
    store = build_ray_store(got.images[tr], got.poses[tr], got.hwf, 0.0, 1.0, device="cpu",
                            use_ndc=True)
    j_store = j_build(got.images[tr], got.poses[tr], got.hwf, 0.0, 1.0, use_ndc=True)
    np.testing.assert_allclose(store.data.numpy(), np.asarray(j_store.data), rtol=0,
                               atol=RAY_ATOL)
    # the viewdirs are the world directions' (unit); the directions are NDC's,
    # whose z is 2 near / 1 on the near plane (not unit)
    vd = store.data[:, 6:9]
    np.testing.assert_allclose(torch.linalg.norm(vd, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(store.data[:, 5].numpy(), 2.0, atol=1e-5)


def _llff_cfg(tmp_path, basedir, **dataset):
    """``tiny_cfg`` over an LLFF scene in NDC (near 0, far 1, factor 1,
    every 8th view held out) with depths scored up to 10 scene units."""
    return tiny_cfg({"type": "llff", "basedir": basedir, "near": 0.0, "far": 1.0,
                     "no_ndc": False, "downsample_factor": 1, "llffhold": 8,
                     "depth_valid_max": 10.0, **dataset}, str(tmp_path / "logs"))


# ---- three Adam steps on NDC rays, as tests/test_torch_train_step.py


@pytest.fixture(scope="module")
def jx_ndc(jx):  # noqa: F811
    """``jx`` on a two-view NDC scene, with each σ head rescaled so that its
    output over the coarse samples of the first 24 rays has mean 1 and std
    NDC_SIGMA_STD: on NDC points (within [-1, 1]^3) the train-step test's
    head gives a near-constant σ (std ~2e-3), whose gradients cancel to
    ~1e-8."""
    from dexnerf_tpu_torch.data.pipeline import take_ray_batch

    rng = np.random.default_rng(1)
    images = rng.uniform(size=(2, 4, 6, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, :3, 3] = (0.1, -0.05, 0.02)
    hwf = [4, 6, 5.0]
    store = build_ray_store(images, poses, hwf, 0.0, 1.0, device="cpu", use_ndc=True)
    rays, _ = take_ray_batch(store, torch.arange(BATCH))
    z = stratified_z_vals(rays.near, rays.far, SETTINGS.num_coarse)
    pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
    trees = {}
    for name, model in zip(("coarse", "fine"), _port_models(jx)):
        with torch.no_grad():
            raw = model(positional_encoding(pts, ARCH["num_encoding_fn_xyz"]),
                        positional_encoding(rays.viewdirs, ARCH["num_encoding_fn_dir"]))[..., 3]
        tree = jx.jax.tree.map(np.copy, jx.trees[name])
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        k = NDC_SIGMA_STD / float(raw.std())
        alpha["kernel"] *= k
        alpha["bias"] = (alpha["bias"] - float(raw.mean())) * k + 1.0
        trees[name] = tree
    return types.SimpleNamespace(**{**vars(jx), "trees": trees, "images": images,
                                    "poses": poses, "hwf": hwf})


def _run_jax_ndc(jx, images, poses, hwf, fused, keys):
    from dexnerf_tpu.data.pipeline import build_ray_store as j_build
    from dexnerf_tpu.ops import make_fused_train_loss as j_make_loss
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train.checkpoints import _find_adam_state
    from dexnerf_tpu.train.step import init_train_state as j_init
    from dexnerf_tpu.train.step import make_optimizer as j_optimizer
    from dexnerf_tpu.train.step import make_train_step as j_make_step

    js = JSettings(**SETTINGS.__dict__)
    store = j_build(images, poses, hwf, 0.0, 1.0, use_ndc=True)
    tx = j_optimizer(LR, LR_DECAY, LR_FACTOR)
    fused_loss = (j_make_loss(jx.jm, jx.jm, js, block_samples=128, interpret=True)
                  if fused else None)
    step = j_make_step(jx.jm.apply, jx.jm.apply, tx, js, BATCH, fused_loss=fused_loss)
    state = j_init(jx.jax.tree.map(jx.jnp.asarray, jx.trees), tx)
    for key in keys:
        state, metrics = step(state, store, key)
    adam = _find_adam_state(state.opt_state)
    as_np = lambda tree: jx.jax.tree.map(np.asarray, tree)  # noqa: E731
    return {
        name: {"param": state_dict_from_flax(as_np(state.params[name])),
               "m": state_dict_from_flax(as_np(adam.mu[name])),
               "v": state_dict_from_flax(as_np(adam.nu[name]))}
        for name in ("coarse", "fine")
    }, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("path", ["fused", "plain"])
def test_llff_train_steps_match_jax(jx_ndc, path):
    """Three Adam steps on an NDC ray store (near 0, far 1, non-unit NDC
    directions, world viewdirs) through the fused loss (JAX's kernel in
    interpret mode vs kernel 4's plain version) and the plain render: the
    metrics, both Adam moments and the parameters as
    ``test_train_steps_match_jax``, except that the parameters whose
    gradient is of the order of Adam's eps (sqrt(v) <= 10 eps: 9% of them
    in this 8x16 network, whose deep ReLU units are nearly dead on NDC
    points) are held to one learning rate."""
    jx = jx_ndc
    images, poses, hwf = jx.images, jx.poses, jx.hwf
    keys = list(jx.jax.random.split(jx.jax.random.PRNGKey(4), STEPS))
    want, want_metrics = _run_jax_ndc(jx, images, poses, hwf, path == "fused", keys)

    coarse, fine = _port_models(jx)
    store = build_ray_store(images, poses, hwf, 0.0, 1.0, device="cpu", use_ndc=True)
    state = init_train_state(coarse, fine, LR, LR_DECAY, LR_FACTOR)
    fused_loss = make_fused_train_loss(coarse, fine, SETTINGS) if path == "fused" else None
    step = make_train_step(SETTINGS, BATCH, fused_loss=fused_loss, steps_per_call=STEPS)
    metrics = step(state, store, draws=[_step_draws(jx, k, store.num_rays) for k in keys])
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
            # elements whose gradient is of the order of Adam's eps move by
            # lr g / (|g| + eps), where round-off in g is no longer small
            # against the update (their m and v are held above)
            v = want[name]["v"][pname].numpy()
            conditioned = np.sqrt(v) > 10 * ADAM_EPS
            dp = np.abs(p.detach().numpy() - want[name]["param"][pname].numpy())
            assert float(dp[conditioned].max(initial=0.0)) <= PARAM_ATOL, f"{name}.{pname}"
            assert float(dp.max()) <= LR, f"{name}.{pname}"



# ---- validation on NDC rays


def ndc_shared_weights(jax, raw_cfg: dict, scene, idx: int):
    """As ``test_torch_depth.shared_weights``, with each σ head calibrated
    on the view's NDC coarse samples (the points the renderer evaluates)."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.train.loop import setup_models as j_setup

    apply_c, apply_f, params = j_setup(JCfgNode(raw_cfg), 3)
    params = jax.tree.map(np.array, params)
    coarse, fine = ploop.setup_models(CfgNode(raw_cfg), 0, "cpu")
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    ro, rd = get_ray_bundle_c2w(H, W, focal, torch.tensor(scene.poses[idx]))
    rays = make_ray_batch(ro, rd, 0.0, 1.0, use_ndc=True, height=H, width=W, focal_length=focal)
    z = stratified_z_vals(rays.near, rays.far, raw_cfg["nerf"]["validation"]["num_coarse"])
    for name, model in (("coarse", coarse), ("fine", fine)):
        model.load_state_dict(state_dict_from_flax(params[name]))
        with torch.no_grad():
            raw = model(positional_encoding(rays.origins[:, None]
                                            + rays.directions[:, None] * z[..., None],
                                            model.num_encoding_fn_xyz),
                        positional_encoding(rays.viewdirs, model.num_encoding_fn_dir))[..., 3]
        k = SIGMA_STD / float(raw.std())
        alpha = params[name]["params"][f"Dense_{model.num_layers + 1}"]  # fc_alpha
        alpha["kernel"] *= k
        alpha["bias"] = alpha["bias"] * k - float(raw.mean()) * k
        model.load_state_dict(state_dict_from_flax(params[name]))
    return types.SimpleNamespace(apply_c=apply_c, apply_f=apply_f, params=params,
                                 coarse=coarse, fine=fine)


@pytest.mark.parametrize("dex", [True, False], ids=["dex", "standard"])
def test_validate_llff_ndc_matches_jax(jax, tmp_path, llff_dir, dex):
    """Validation of an NDC scene with depth sidecars: the frame on NDC
    rays as JAX renders it, its Dex depths NDC parameters, and no depth
    metric on either side."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.train.loop import load_scene as j_load_scene
    from dexnerf_tpu.train.loop import validate as j_validate

    raw = _llff_cfg(tmp_path, llff_dir)
    jcfg, pcfg = JCfgNode(raw), CfgNode(raw)
    jscene, pscene = j_load_scene(jcfg), ploop.load_scene(pcfg)
    assert pscene.depths is not None
    w = ndc_shared_weights(jax, raw, pscene, 8)
    want = j_validate(w.apply_c, w.apply_f, w.params, jscene, jcfg, dex=dex,
                      supervision="rgb", val_idx=8)
    got = ploop.validate(w.coarse, w.fine, pscene, pcfg, supervision="rgb", device="cpu",
                         dex=dex, val_idx=8)
    assert_validation_match(got, want)
    for metrics in (got, want):
        assert not {"depth_abs_err", "depth_gt", "min_abs_err", "dex_errors"} & set(metrics)
    assert float(got["depth"].max()) <= 1.0
    if dex:
        assert got["depth_dex"].shape == (3, *LLFF_HW)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_depth_loss_under_ndc_refused(jax, tmp_path, llff_dir, package):
    """Both packages refuse depth supervision on an NDC scene: its render
    depth is a ray parameter, the sidecars metric distances."""
    raw = _llff_cfg(tmp_path, llff_dir)
    if package == "port":
        with pytest.raises(ValueError, match="NDC"):
            ploop.run_training(CfgNode(raw), depth_loss_weight=0.1, max_iters=1, device="cpu")
    else:
        from dexnerf_tpu.config import CfgNode as JCfgNode
        from dexnerf_tpu.train.loop import run_training as j_run

        with pytest.raises(ValueError, match="NDC"):
            j_run(JCfgNode(raw), depth_loss_weight=0.1, max_iters=1)


def test_run_training_llff_cpu(tmp_path, llff_dir):
    """``run_training`` on the NDC scene with the fused loss's plain
    version: a finite loss and a validation at the end, with no depth
    metric."""
    raw = _llff_cfg(tmp_path, llff_dir)
    raw["experiment"].update(train_iters=3, validate_every=3)
    raw["nerf"]["use_pallas"] = True
    out = ploop.run_training(CfgNode(raw), device="cpu")
    assert out["scene"].use_ndc and np.isfinite(out["final_train_metrics"]["loss"])
    val = out["final_validation"]
    assert val["index"] in (0, 8) and "depth_abs_err" not in val
    assert os.path.exists(os.path.join(out["logdir"], "metrics.jsonl"))
    img = np.asarray(Image.open(os.path.join(llff_dir, "images", "r_000.png")))
    assert img.shape == (*LLFF_HW, 3)
