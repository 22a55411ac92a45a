"""The five model families of the port (``dexnerf_tpu_torch/models/mlp.py``)
held to the JAX package's flax modules on the CPU, and what runs them.

Each family is built by both packages' ``model_from_cfg`` from one config
block, the flax tree is carried into the port by ``state_dict_from_flax``,
and both forwards run on the same numpy inputs, with and without viewdirs
and with per-ray and per-sample view encodings. Then: FlexibleNeRF's
plain path at ``models.*.compute_dtype: bfloat16`` (ROADMAP Queue 3 fault
8), ``render_rays`` and ``render_image`` without viewdirs, the ``.ckpt``
round trip of every family and of ``fc_out``, and the selection rules of
``train/loop.py`` against JAX's ``maybe_fused_loss``, ``maybe_fused_fields``
and ``maybe_fused_render_impl`` on the same configs.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.config import CfgNode, model_from_cfg
from dexnerf_tpu_torch.models import MODEL_REGISTRY, FlexibleNeRFModel
from dexnerf_tpu_torch.ops.fused_mlp import fused_field_reference
from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderDraws,
    RenderSettings,
    render_image,
    render_rays,
)
from dexnerf_tpu_torch.train.checkpoints import (
    has_viewdir_head,
    infer_flexible_arch,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.loop import (
    align_cfg_models_to_checkpoint,
    fused_render_impl,
    maybe_fused_fields,
    maybe_fused_loss,
)

FX, FD = 2, 1  # PE frequencies, xyz and viewdirs: widths 15 and 9
# f32 on both sides, sums in another order (split vs packed products)
RTOL, ATOL = 1e-5, 1e-6
# the families at small widths; PaperNeRF is 8x256 whatever the block says
BLOCKS = {
    "VeryTinyNeRFModel": dict(hidden_size=16),
    "MultiHeadNeRFModel": dict(hidden_size=16),
    "ReplicateNeRFModel": dict(hidden_size=16),
    "PaperNeRFModel": dict(),
    "FlexibleNeRFModel": dict(num_layers=5, hidden_size=16, skip_connect_every=2),
}
NEEDS_VIEWDIRS = ("MultiHeadNeRFModel", "ReplicateNeRFModel")


def _block(name, **extra):
    return CfgNode(dict(type=name, num_encoding_fn_xyz=FX, num_encoding_fn_dir=FD,
                        include_input_xyz=True, include_input_dir=True,
                        **BLOCKS[name], **extra))


def _pair(name, use_viewdirs, seed=0, **extra):
    """(flax module, numpy tree, port model carrying it) for ``name``."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.config import model_from_cfg as j_model_from_cfg

    block = _block(name, **extra)
    jm = j_model_from_cfg(JCfgNode(dict(block)), use_viewdirs)
    xyz = jnp.ones((1, 3, 3 + 6 * FX))
    inp = (xyz, jnp.ones((1, 3 + 6 * FD))) if use_viewdirs else (xyz,)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed), inp))
    tm = model_from_cfg(block, use_viewdirs)
    tm.load_state_dict(state_dict_from_flax(tree, tm))
    return jm, tree, tm


def _inputs(n=3, s=4, per_sample=False, seed=1):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, s, 3 + 6 * FX)).astype(np.float32)
    view = rng.normal(size=(n, s, 3 + 6 * FD) if per_sample else (n, 3 + 6 * FD))
    return xyz, view.astype(np.float32)


CASES = [(name, vd) for name in BLOCKS for vd in (True, False)
         if vd or name not in NEEDS_VIEWDIRS]


@pytest.mark.parametrize("layout", ["per_ray", "per_sample"])
@pytest.mark.parametrize("name,use_viewdirs", CASES,
                         ids=[f"{n}-{'vd' if v else 'novd'}" for n, v in CASES])
def test_forward_matches_flax(name, use_viewdirs, layout):
    jm, tree, tm = _pair(name, use_viewdirs)
    xyz, view = _inputs(per_sample=layout == "per_sample")
    j_in = (jnp.asarray(xyz), jnp.asarray(view)) if use_viewdirs else (jnp.asarray(xyz),)
    want = np.asarray(jm.apply(tree, j_in))
    with torch.no_grad():
        got = tm(torch.tensor(xyz), torch.tensor(view) if use_viewdirs else None).numpy()
    assert got.shape == want.shape == (3, 4, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sum(p.numel() for p in tm.parameters()) == sum(x.size for x in jax.tree.leaves(tree))
    assert list(tm.state_dict()) == [f"{m}.{k}" for m in _registration(tm) for k in ("weight",
                                                                                      "bias")]


def _registration(model):
    return [n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)]


@pytest.mark.parametrize("name", NEEDS_VIEWDIRS)
def test_viewdir_families_refuse_no_viewdirs(name):
    """JAX's MultiHead and Replicate take ``(feat, view)`` in their rgb
    branch and fail without viewdirs; the port refuses at construction."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.config import model_from_cfg as j_model_from_cfg

    jm = j_model_from_cfg(JCfgNode(dict(_block(name))), False)
    with pytest.raises(AttributeError):
        jm.init(jax.random.PRNGKey(0), (jnp.ones((1, 3, 3 + 6 * FX)),))
    with pytest.raises(ValueError, match="needs viewdirs"):
        model_from_cfg(_block(name), False)


def test_paper_model_is_8x256():
    _, tree, tm = _pair("PaperNeRFModel", True)
    widths = [tree["params"][f"Dense_{i}"]["kernel"].shape[1] for i in range(14)]
    assert widths == [256] * 9 + [1, 128, 128, 128, 3]
    assert tm.layers_xyz[4].in_features == 256 + 3 + 6 * FX
    assert tm.layers_dir[0].in_features == 256 + 3 + 6 * FD
    assert len(tm.layers_dir) == 3


def test_very_tiny_takes_the_tiny_pipeline_width():
    """apps/tiny.py: ``VeryTinyNeRFModel(num_encoding_functions=6)`` on
    the packed xyz + viewdir encodings at 6 frequencies, fan-in 78, as the
    JAX tiny app initializes it."""
    from dexnerf_tpu.models import VeryTinyNeRFModel as JTiny

    from dexnerf_tpu_torch.models import VeryTinyNeRFModel

    tree = JTiny(num_encoding_functions=6).init(jax.random.PRNGKey(0), jnp.ones((1, 78)))
    tm = VeryTinyNeRFModel(num_encoding_functions=6)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state_dict_from_flax(
            jax.tree.map(np.asarray, tree), tm).items()}
    assert tm.layer1.in_features == 78


# Fault 8: FlexibleNeRF's plain path at models.*.compute_dtype bfloat16.
# Both sides round the same operands to bf16 and differ in the f32
# summation order of the products, which can flip single bf16 roundings;
# so the port is held relative to the dtype's own effect (PERF.md §2):
# |port - JAX bf16| max <= own, 99.9th percentile <= 0.25 own, and
# |port - JAX f32| <= 1.5 own, each + 1e-5, own = |JAX bf16 - JAX f32|.
OWN_P999, OWN_REL, OWN_ATOL = 0.25, 1.5, 1e-5


@pytest.mark.parametrize("use_viewdirs", [True, False], ids=["vd", "novd"])
def test_flexible_bf16_plain_path_matches_jax(use_viewdirs):
    jm16, tree, tm16 = _pair("FlexibleNeRFModel", use_viewdirs, compute_dtype="bfloat16")
    jm32, _, tm32 = _pair("FlexibleNeRFModel", use_viewdirs)
    assert tm16.compute_dtype == torch.bfloat16 and tm32.compute_dtype == torch.float32
    xyz, view = _inputs(n=16, s=8, seed=3)
    xyz *= 3.0
    j_in = (jnp.asarray(xyz), jnp.asarray(view)) if use_viewdirs else (jnp.asarray(xyz),)
    want16 = np.asarray(jm16.apply(tree, j_in))
    want32 = np.asarray(jm32.apply(tree, j_in))
    t_in = (torch.tensor(xyz), torch.tensor(view) if use_viewdirs else None)
    with torch.no_grad():
        got16 = tm16(*t_in)
        got32 = tm32(*t_in)
        # the kernels' plain version ignores the model's own dtype, as JAX's kernels do
        pts = torch.tensor(np.random.default_rng(4).normal(size=(5, 6, 3)).astype(np.float32))
        vd = torch.nn.functional.normalize(torch.ones(5, 3), dim=-1)
        if use_viewdirs:
            assert torch.equal(fused_field_reference(tm16, pts, vd),
                               fused_field_reference(tm32, pts, vd))
    assert got16.dtype == torch.float32
    got16 = got16.numpy()
    own = np.abs(want16 - want32)
    scale = float(np.abs(want32).max())
    err = np.abs(got16 - want16)
    assert float(own.max()) > 1e-3 * scale  # the dtype has an effect to hold against
    assert float(err.max()) <= float(own.max()) + OWN_ATOL * scale
    assert float(np.quantile(err, 0.999)) <= OWN_P999 * float(own.max()) + OWN_ATOL * scale
    assert float(np.abs(got16 - want32).max()) <= OWN_REL * float(own.max()) + OWN_ATOL * scale
    np.testing.assert_allclose(got32.numpy(), want32, rtol=RTOL, atol=ATOL)


def test_cpu_render_keeps_the_models_dtype():
    """On the CPU, where JAX renders through XLA at the models' own dtype
    unless ``nerf.use_fused_render`` is set, the port renders a FlexibleNeRF
    of ``compute_dtype: bfloat16`` on the plain path too (no fused render),
    and one of f32 through the kernel's plain version, which equals it."""
    cfg = CfgNode({"nerf": {"use_viewdirs": True}, "models": {}})
    for dtype, fused in (("bfloat16", False), ("float32", True)):
        model = model_from_cfg(_block("FlexibleNeRFModel", compute_dtype=dtype), True)
        assert (fused_render_impl(cfg, RenderSettings(), "cpu", model, model) is not None) == fused
    cfg.nerf.use_fused_render = True
    bf16 = model_from_cfg(_block("FlexibleNeRFModel", compute_dtype="bfloat16"), True)
    assert fused_render_impl(cfg, RenderSettings(), "cpu", bf16, bf16) is not None


def _jax_render_draws(key, n, s):
    """The four draws of JAX's ``render_rays`` from ``key``, in its split
    order (k_strat, k_noise_c, k_fine, k_noise_f)."""
    k_strat, k_noise_c, k_fine, k_noise_f = jax.random.split(key, 4)
    std, c, f = s.radiance_field_noise_std, s.num_coarse, s.num_fine

    def t(x):
        return torch.tensor(np.asarray(x))

    return RenderDraws(
        t_strat=t(jax.random.uniform(k_strat, (n, c), dtype=jnp.float32)),
        noise_coarse=t(std * jax.random.normal(k_noise_c, (n, c), dtype=jnp.float32)),
        u_fine=t(jax.random.uniform(k_fine, (n, f), dtype=jnp.float32)),
        noise_fine=t(std * jax.random.normal(k_noise_f, (n, c + f), dtype=jnp.float32)),
    )


def _settings(**kw):
    return dict(num_coarse=8, num_fine=8, use_viewdirs=False, num_encoding_fn_xyz=FX,
                num_encoding_fn_dir=FD, **kw)


def _spread_sigma(tree, alpha_dense):
    """Scale the σ output so that samples saturate on some rays."""
    k = tree["params"][alpha_dense]["kernel"]
    k[..., -1] *= 30.0
    tree["params"][alpha_dense]["bias"][..., -1] += 1.0


@pytest.mark.parametrize("fine_name", ["FlexibleNeRFModel", "PaperNeRFModel"])
def test_render_rays_without_viewdirs_matches_jax(fine_name):
    """Both passes, jittered depths and σ-noise on JAX's draws; the fine
    model a FlexibleNeRF or a PaperNeRF (``fc_out`` / viewdir-free
    ``layers_dir.0``)."""
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import render_rays as j_render_rays

    jc, tc_tree, tc = _pair("FlexibleNeRFModel", False, seed=5)
    jf, tf_tree, tf = _pair(fine_name, False, seed=6)
    _spread_sigma(tc_tree, "Dense_5")
    tc.load_state_dict(state_dict_from_flax(tc_tree, tc))
    s = RenderSettings(**_settings(perturb=True, radiance_field_noise_std=0.2))
    n = 6
    rng = np.random.default_rng(7)
    o = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    d = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32) + np.array([0, 0, -1], np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full((n,), 2.0, np.float32)
    arrays = (o, d, v, near, near + 4.0)
    key = jax.random.PRNGKey(11)
    want = j_render_rays(jc.apply, jf.apply, {"coarse": tc_tree, "fine": tf_tree},
                         JRayBatch(*map(jnp.asarray, arrays)), key, JSettings(**s.__dict__))
    with torch.no_grad():
        got = render_rays(tc, tf, RayBatch(*map(torch.tensor, arrays)), s,
                          _jax_render_draws(key, n, s))
    for name in ("coarse", "fine"):
        g, w = getattr(got, name), getattr(want, name)
        for field in ("rgb", "depth", "accumulation", "weights"):
            np.testing.assert_allclose(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                                       rtol=2e-4, atol=2e-5, err_msg=f"{name}.{field}")


def test_render_image_without_viewdirs_matches_jax():
    from dexnerf_tpu.core.rays import get_ray_bundle_c2w as j_bundle
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import render_image as j_render_image

    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.data.blender import pose_spherical

    jc, c_tree, tc = _pair("FlexibleNeRFModel", False, seed=8)
    jf, f_tree, tf = _pair("PaperNeRFModel", False, seed=9)
    s = RenderSettings(**_settings(perturb=False))
    pose = pose_spherical(30.0, -30.0, 4.0)
    want = j_render_image(jc.apply, jf.apply, {"coarse": c_tree, "fine": f_tree},
                          *j_bundle(5, 6, 7.0, jnp.asarray(pose)), 2.0, 6.0,
                          JSettings(**s.__dict__))
    with torch.no_grad():
        got = render_image(tc, tf, *get_ray_bundle_c2w(5, 6, 7.0, torch.tensor(pose)),
                           2.0, 6.0, s, chunk=7)
    for name in ("coarse", "fine"):
        for field in ("rgb", "depth", "disparity"):
            np.testing.assert_allclose(
                getattr(getattr(got, name), field).numpy(),
                np.asarray(getattr(getattr(want, name), field)), rtol=2e-4, atol=2e-5,
                err_msg=f"{name}.{field}")


@pytest.mark.parametrize("name,use_viewdirs", CASES,
                         ids=[f"{n}-{'vd' if v else 'novd'}" for n, v in CASES])
def test_checkpoint_round_trip(tmp_path, name, use_viewdirs):
    """Every family's weights through the port's ``.ckpt`` writer and
    reader, into a fresh model of the same config (FlexibleNeRF without
    viewdirs: ``layer1``, ``layers_xyz.*``, ``fc_out``)."""
    _, _, tm = _pair(name, use_viewdirs, seed=2)
    path = str(tmp_path / "m.ckpt")
    write_reference_checkpoint(path, tm.state_dict(), None, step=4)
    ck = read_reference_checkpoint(path)
    assert ck["step"] == 4 and ck["fine"] is None
    assert list(ck["coarse"]) == list(tm.state_dict())
    fresh = model_from_cfg(_block(name), use_viewdirs)
    fresh.load_state_dict(ck["coarse"])
    xyz, view = _inputs(seed=5)
    t_in = (torch.tensor(xyz), torch.tensor(view) if use_viewdirs else None)
    with torch.no_grad():
        assert torch.equal(fresh(*t_in), tm(*t_in))


def test_fc_out_checkpoints_cross_packages(tmp_path):
    """FlexibleNeRF without viewdirs: JAX's export loads in the port and the
    port's ``.ckpt`` in JAX's import (``use_viewdirs=False``); the
    architecture inferred from ``fc_out`` weights is JAX's; a config whose
    ``nerf.use_viewdirs`` disagrees with the heads raises."""
    from dexnerf_tpu.train.checkpoints import export_torch_checkpoint, import_torch_checkpoint
    from dexnerf_tpu.train.checkpoints import infer_flexible_arch as j_infer

    _, tree, tm = _pair("FlexibleNeRFModel", False, seed=3)
    assert list(tm.state_dict())[-2:] == ["fc_out.weight", "fc_out.bias"]
    assert not has_viewdir_head(tm.state_dict())
    jpath = str(tmp_path / "jax.ckpt")
    export_torch_checkpoint(jpath, {"coarse": tree, "fine": None}, step=2, use_viewdirs=False)
    ck = read_reference_checkpoint(jpath)
    assert list(ck["coarse"]) == list(tm.state_dict())
    for k, v in ck["coarse"].items():
        assert torch.equal(v, tm.state_dict()[k])
    ppath = str(tmp_path / "port.ckpt")
    write_reference_checkpoint(ppath, tm.state_dict(), None, step=5)
    imp = import_torch_checkpoint(ppath, use_viewdirs=False)
    for name, leaf in jax.tree_util.tree_leaves_with_path(imp["coarse"]):
        ref = tree
        for p in name:
            ref = ref[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), ref)
    assert infer_flexible_arch(tm.state_dict()) == j_infer(tree, use_viewdirs=False)
    cfg = CfgNode({"nerf": {"use_viewdirs": True},
                   "models": {"coarse": dict(_block("FlexibleNeRFModel"))}})
    with pytest.raises(ValueError, match="without viewdirs"):
        align_cfg_models_to_checkpoint(cfg, {"coarse": tm.state_dict(), "fine": None})
    cfg.nerf.use_viewdirs = False
    align_cfg_models_to_checkpoint(cfg, {"coarse": tm.state_dict(), "fine": None})


# ---- the selection rules, on the same configs in both packages

SELECTION = {
    "all-flexible": ("FlexibleNeRFModel", "FlexibleNeRFModel", True),
    "mixed": ("FlexibleNeRFModel", "PaperNeRFModel", True),
    "paper": ("PaperNeRFModel", "PaperNeRFModel", True),
    "paper-coarse-only": ("PaperNeRFModel", None, True),
    "no-viewdirs": ("FlexibleNeRFModel", "FlexibleNeRFModel", False),
}


def _selection_cfg(coarse, fine, use_viewdirs, **nerf):
    models = {"coarse": dict(_block(coarse))}
    if fine is not None:
        models["fine"] = dict(_block(fine))
    mode = dict(num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.0,
                white_background=False, lindisp=False)
    return dict(models=models, nerf=dict(use_viewdirs=use_viewdirs, use_pallas=True,
                                         train=mode, validation=dict(mode, perturb=False),
                                         **nerf))


def _is_none(x):
    return x is None if not isinstance(x, tuple) else tuple(v is None for v in x)


@pytest.mark.parametrize("case", list(SELECTION))
def test_selection_matches_jax(case):
    """The port returns None exactly where JAX does: the fused loss, the
    fields one model at a time (the loss switched off, as ``run_training``
    asks after it), and the fused render (``use_fused_render: true``, so
    that JAX's CPU default does not decide); ``use_viewdirs: false`` warns
    with JAX's words on both sides."""
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.config import render_settings_from_cfg as j_settings
    from dexnerf_tpu.train.loop import maybe_fused_fields as j_fields
    from dexnerf_tpu.train.loop import maybe_fused_loss as j_loss
    from dexnerf_tpu.train.loop import maybe_fused_render_impl as j_render

    from dexnerf_tpu_torch.config import models_from_cfg, render_settings_from_cfg

    coarse_name, fine_name, vd = SELECTION[case]
    raw = _selection_cfg(coarse_name, fine_name, vd, use_fused_render=True)
    jcfg, cfg = JCfgNode(raw), CfgNode(raw)
    coarse, fine = models_from_cfg(cfg)
    s_train, s_val = (render_settings_from_cfg(cfg, m) for m in ("train", "validation"))
    want_loss = _is_none(j_loss(jcfg, j_settings(jcfg, "train"), "rgb"))
    got_loss = _is_none(maybe_fused_loss(cfg, s_train, "rgb", coarse, fine))
    assert got_loss == want_loss
    raw_f = _selection_cfg(coarse_name, fine_name, vd, pallas_fused_loss=False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want_fields = _is_none(j_fields(JCfgNode(raw_f), train=True))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got_fields = _is_none(maybe_fused_fields(CfgNode(raw_f), coarse, fine, train=True))
    assert got_fields == want_fields
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert bool(tw) == (not vd)
    want_render = _is_none(j_render(jcfg, j_settings(jcfg, "validation")))
    got_render = _is_none(fused_render_impl(cfg, s_val, "cpu", coarse, fine))
    assert got_render == want_render
    expected = {  # (loss, fields, render) None-ness, as the rules read
        "all-flexible": (False, (False, False), False),
        "mixed": (True, (False, True), True),
        "paper": (True, (True, True), True),
        "paper-coarse-only": (True, (True, True), True),
        "no-viewdirs": (True, (True, True), True),
    }[case]
    assert (got_loss, got_fields, got_render) == expected


def test_unknown_family_raises_keyerror():
    assert sorted(MODEL_REGISTRY) == sorted([
        "VeryTinyNeRFModel", "MultiHeadNeRFModel", "ReplicateNeRFModel", "PaperNeRFModel",
        "FlexibleNeRFModel"])
    with pytest.raises(KeyError, match="unknown model type"):
        model_from_cfg(CfgNode(dict(type="TinyCudaNN")))
    assert isinstance(model_from_cfg(_block("FlexibleNeRFModel")), FlexibleNeRFModel)
