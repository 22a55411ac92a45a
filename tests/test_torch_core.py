"""Parity of the PyTorch port's config, core and pose modules with the JAX
package, on the CPU: the same numpy inputs go through both."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dexnerf_tpu.config import CfgNode as JCfgNode
from dexnerf_tpu.config import render_settings_from_cfg as j_settings
from dexnerf_tpu.core import encoding as j_enc
from dexnerf_tpu.core import rays as j_rays
from dexnerf_tpu.core import sampling as j_samp
from dexnerf_tpu.core import volrend as j_vr
from dexnerf_tpu.data.blender import pose_spherical as j_pose
from dexnerf_tpu_torch.config import CfgNode, load_config, render_settings_from_cfg
from dexnerf_tpu_torch.core import encoding, rays, sampling, volrend
from dexnerf_tpu_torch.data.blender import pose_spherical

RTOL, ATOL = 1e-5, 1e-6
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yml")))


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_like_yaml_and_jax(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    cfg = load_config(path)
    with open(path) as f:
        jcfg = JCfgNode.load_cfg(f)
    assert cfg == want == jcfg
    assert cfg.nerf.validation.num_coarse == want["nerf"]["validation"]["num_coarse"]
    if "m_thres" in want["nerf"]["validation"]:
        a = render_settings_from_cfg(cfg, "validation", dex=True)
        b = j_settings(jcfg, "validation", dex=True)
        assert tuple(float(m) for m in a.m_thres_cand) == tuple(b.m_thres_cand)
    for mode in ("train", "validation"):
        a = render_settings_from_cfg(cfg, mode)
        b = j_settings(jcfg, mode)
        assert a.__dict__ == b.__dict__


def test_cfgnode_freeze():
    cfg = CfgNode({"a": {"b": 1}})
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.a.b = 2
    cfg.defrost()
    cfg.a.b = 3
    assert cfg.a.b == 3 and cfg["a"]["b"] == 3


@pytest.mark.parametrize("num", [1, 4, 8, 20, 64, 128])
def test_linspace_bitwise(num):
    a = sampling.linspace(0.0, 1.0, num).numpy()
    b = np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("log", [True, False])
@pytest.mark.parametrize("include", [True, False])
def test_positional_encoding(log, include):
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    bands = encoding.frequency_bands(10, log).numpy()
    if log:  # exact powers of two on both sides
        np.testing.assert_array_equal(bands, np.asarray(j_enc.frequency_bands(10, log)))
    else:
        close(bands, j_enc.frequency_bands(10, log))
    a = encoding.positional_encoding(t(x), 6, include, log)
    b = j_enc.positional_encoding(jnp.asarray(x), 6, include, log)
    assert a.shape == b.shape
    assert encoding.encoding_dim(3, 6, include) == j_enc.encoding_dim(3, 6, include)
    close(a, b)


def test_ray_bundle_c2w():
    pose = pose_spherical(30.0, -40.0, 4.0)
    np.testing.assert_array_equal(pose, np.asarray(j_pose(30.0, -40.0, 4.0)))
    o, d = rays.get_ray_bundle_c2w(6, 9, 7.5, t(pose))
    jo, jd = j_rays.get_ray_bundle_c2w(6, 9, 7.5, jnp.asarray(pose))
    assert o.shape == (6, 9, 3) and d.shape == (6, 9, 3)
    close(o, jo)
    close(d, jd)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals(lindisp):
    rng = np.random.default_rng(1)
    near = rng.uniform(0.2, 1.0, size=(7,)).astype(np.float32)
    far = near + rng.uniform(1.0, 4.0, size=(7,)).astype(np.float32)
    a = sampling.stratified_z_vals(t(near), t(far), 16, lindisp=lindisp)
    b = j_samp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, lindisp=lindisp)
    close(a, b)


def _pdf_inputs(seed=2, rays_=9, m=15):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, size=(rays_, m + 1)), axis=-1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(rays_, m)).astype(np.float32)
    w[0] = 0.0  # all-zero weights: the +1e-5 guard
    w[1, 3:] = 0.0  # a flat tail: denominators below 1e-5
    return bins, w


def test_sample_pdf_det():
    bins, w = _pdf_inputs()
    a = sampling.sample_pdf(t(bins), t(w), 12, det=True)
    b = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, det=True)
    close(a, b)


def test_sample_pdf_given_u():
    """The port takes the uniform draws as an argument; the JAX function
    draws them from its key, so the port gets the same draws."""
    bins, w = _pdf_inputs(seed=3)
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (bins.shape[0], 12)))
    b = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, key, det=False)
    close(sampling.sample_pdf(t(bins), t(w), 12, det=False, u=t(u)), b)
    with pytest.raises(ValueError):
        sampling.sample_pdf(t(bins), t(w), 12, det=False)


def test_hierarchical_z_vals():
    rng = np.random.default_rng(4)
    near = np.full((6,), 2.0, np.float32)
    z = np.asarray(j_samp.stratified_z_vals(jnp.asarray(near), jnp.asarray(near + 4.0), 10))
    w = rng.uniform(0.0, 1.0, size=(6, 10)).astype(np.float32)
    a, a_s = sampling.hierarchical_z_vals(t(z), t(w), 8, det=True)
    b, b_s = j_samp.hierarchical_z_vals(None, jnp.asarray(z), jnp.asarray(w), 8, det=True)
    close(a_s, b_s)
    close(a, b)
    assert bool((a[..., 1:] >= a[..., :-1]).all())


def _field(seed=5, n=11, s=13):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32) * 3.0
    z = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=-1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return raw, z, d


@pytest.mark.parametrize("white", [False, True])
def test_volume_render(white):
    raw, z, d = _field()
    thr = (0.5, 2.0, 4.0)
    a = volrend.volume_render_radiance_field(
        t(raw), t(z), t(d), white_background=white, m_thres_cand=thr
    )
    b = j_vr.volume_render_radiance_field(
        jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
        white_background=white, m_thres_cand=thr,
    )
    for f in ("rgb", "disparity", "accumulation", "weights", "depth"):
        close(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.depth_dex.numpy(), np.asarray(b.depth_dex))
    close(volrend.ray_dists(t(z), t(d)), j_vr.ray_dists(jnp.asarray(z), jnp.asarray(d)))
    close(
        volrend.depth_confidence(a.weights, t(z), a.depth, 0.3),
        j_vr.depth_confidence(b.weights, jnp.asarray(z), b.depth, 0.3),
    )


def test_disparity_finite_where_acc_is_zero():
    """The kernel's form 1/max(1e-10, depth/max(acc, 1e-37)): finite where
    the XLA form depth/acc is NaN (acc == 0)."""
    raw, z, d = _field(n=3)
    raw[0, :, 3] = -5.0  # σ = 0 everywhere on ray 0
    a = volrend.volume_render_radiance_field(t(raw), t(z), t(d))
    b = j_vr.volume_render_radiance_field(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d))
    assert float(a.accumulation[0]) == 0.0 and bool(torch.isfinite(a.disparity).all())
    assert np.isnan(np.asarray(b.disparity)[0])
    close(a.disparity[1:], np.asarray(b.disparity)[1:])


def test_sigma_threshold_depth_exact():
    rng = np.random.default_rng(6)
    sigma = np.maximum(rng.normal(size=(4, 5, 9)) * 4.0, 0.0).astype(np.float32)
    sigma[0, 0] = 0.0  # no hit for any threshold
    sigma[1, 1, 4] = 2.0  # exactly at a threshold: σ > m is strict
    z = np.sort(rng.uniform(1.0, 5.0, size=(4, 5, 9)), axis=-1).astype(np.float32)
    thr = (0.5, 2.0, 5.0, 100.0)
    a = volrend.sigma_threshold_depth(t(sigma), t(z), thr).numpy()
    b = np.asarray(j_vr.sigma_threshold_depth(jnp.asarray(sigma), jnp.asarray(z), thr))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 4, 5)
    np.testing.assert_array_equal(a[:, 0, 0], z[0, 0, 0])
    np.testing.assert_array_equal(a[-1], np.broadcast_to(z[..., 0], a[-1].shape))
