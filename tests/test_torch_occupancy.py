"""Occupancy-guided empty-space skipping in the port
(``dexnerf_tpu_torch/render/occupancy.py``, ``RayStore.intervals``,
``render_image(occupancy=...)``, ``run_training(occupancy=...)`` and the
``--occupancy*`` flags of eval, serve and train) held to the JAX package on
the CPU, and the JAX suite's analytic-sphere checks
(``tests/test_occupancy.py``) on the port.

Both packages get one set of weights (a seeded 4x32 FlexibleNeRF carried
across with ``state_dict_from_flax``), the same lattice and the same numpy
rays. Tolerances: σ grids to rtol 1e-5 / atol 1e-5 (f32 sums in another
order); the dilation equal in every cell; the baked grid equal except in
cells whose σ lies within 1e-5 of the threshold, relative (and their
dilation), which are counted; tightened near/far to 1e-6, except on rays
with a probe coordinate within 1e-5 cells of a cell edge (where a one-ulp
difference may pick the neighbouring cell), which are counted and held
under 1%; rendered frames to ``tests/test_torch_serve.py``'s 2e-4 / 2e-5;
in ``run_training`` the store's intervals to 1e-6, the losses to rtol 1e-5
and the parameters to 1e-5 (``tests/test_torch_train_step.py``'s
``PARAM_ATOL``).
"""

import dataclasses
import io
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from test_torch_depth import tiny_cfg
from test_torch_eval import _assert_pngs_close, run_both

from dexnerf_tpu_torch.apps import eval as eval_app
from dexnerf_tpu_torch.apps import serve
from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
from dexnerf_tpu_torch.data.blender import pose_spherical
from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch, with_full_intervals
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.render import occupancy as po
from dexnerf_tpu_torch.render.renderer import (
    RenderSettings,
    make_mlp_field,
    render_image,
    render_rays,
)
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import StepDraws

ARCH = dict(num_layers=4, hidden_size=32, skip_connect_every=2, num_encoding_fn_xyz=3,
            num_encoding_fn_dir=2)
SETTINGS = dict(num_coarse=16, num_fine=16, perturb=False, num_encoding_fn_xyz=3,
                num_encoding_fn_dir=2, m_thres_cand=(5.0, 10.0))
SIGMA_GAIN = 30.0  # fc_alpha scaled so that σ spreads over a few units
RES, RADIUS, CENTER = 24, 1.5, (0.1, -0.05, 0.2)
SIGMA_RTOL, SIGMA_ATOL = 1e-5, 1e-5
THRESH_RTOL = 1e-5  # cells this close to the threshold may be decided otherwise
IV_ATOL = 1e-6
EDGE_CELLS = 1e-5  # probe coordinates this close to a cell edge may pick its neighbour
EDGE_SHARE = 0.01
RTOL, ATOL = 2e-4, 2e-5  # frames (tests/test_torch_serve.py)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import make_mlp_field as j_field
    from dexnerf_tpu.render import occupancy as jo

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ARCH["num_encoding_fn_xyz"]) + encoding_dim(
        3, ARCH["num_encoding_fn_dir"])
    trees, models = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(20 + i), jnp.ones((1, in_dim))))
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= SIGMA_GAIN
        alpha["bias"] = alpha["bias"] * SIGMA_GAIN + 2.0
        trees[name] = tree
        models[name] = FlexibleNeRFModel(**ARCH)
        models[name].load_state_dict(state_dict_from_flax(tree))
    js = JSettings(**SETTINGS)
    ps = RenderSettings(**SETTINGS)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jo=jo, jm=jm, trees=trees, models=models, js=js, ps=ps,
        j_field=j_field(jm.apply, js), p_field=make_mlp_field(models["fine"], ps),
    )


def _sigma_pair(jx, style="centers", res=RES):
    kw = dict(center=CENTER, radius=RADIUS, resolution=res, batch=1000)
    want = np.asarray(jx.jo.eval_sigma_grid(jx.j_field, jx.trees["fine"], style=style, **kw))
    got = po.eval_sigma_grid(jx.p_field, device="cpu", style=style, **kw).numpy()
    return got, want


def _threshold(sigma):
    """A σ threshold that leaves a quarter of the cells occupied, midway
    between two cells' σ (a σ of the grid itself would sit on it)."""
    s = np.sort(sigma.reshape(-1))
    k = (3 * s.size) // 4
    return float(0.5 * (s[k - 1] + s[k]))


def _grids(jx, occ):
    """One bool grid as both packages' OccupancyGrid."""
    jnp = jx.jnp
    j = jx.jo.OccupancyGrid(occ=jnp.asarray(occ), center=jnp.asarray(CENTER, jnp.float32),
                            radius=jnp.asarray(RADIUS, jnp.float32))
    p = po.OccupancyGrid(occ=torch.tensor(occ), center=torch.tensor(CENTER, dtype=torch.float32),
                         radius=torch.tensor(RADIUS, dtype=torch.float32))
    return j, p


@pytest.fixture(scope="module")
def shared_grid(jx):
    """The baked and dilated grid of the shared fine weights, as numpy."""
    _, want = _sigma_pair(jx)
    return np.asarray(jx.jo.dilate_occupancy(jx.jnp.asarray(want > _threshold(want)), 1))


def _rays(n=300, seed=0):
    """Rays from a sphere of radius 4 toward points near the origin, with
    non-unit directions and per-ray intervals; every 10th points away."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(scale=0.4, size=(n, 3)) - o
    d[::10] *= -1.0
    d *= rng.uniform(0.8, 1.2, (n, 1)) / np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(1.5, 2.5, n)
    far = rng.uniform(5.0, 6.5, n)
    return tuple(a.astype(np.float32) for a in (o, d, near, far))


def _edge_rays(grid, o, d, near, far, num_probes):
    """[N] rays with a probe coordinate within EDGE_CELLS of a cell edge."""
    t = po.probe_depths(torch.tensor(near), torch.tensor(far), num_probes)
    flag = torch.zeros(t.shape[0], dtype=torch.bool)
    for u in po.probe_coords(grid, torch.tensor(o), torch.tensor(d), t):
        flag |= ((u - u.round()).abs() < EDGE_CELLS).any(-1)
    return flag.numpy()


def _assert_intervals(got, want, edge, label, counted=None):
    """near/far to IV_ATOL off the rays ``edge``; the rays that put them
    there (``counted``, else ``edge``) under EDGE_SHARE."""
    counted = edge if counted is None else counted
    print(f"{label}: {int(counted.sum())} of {counted.size} rays with a probe within "
          f"{EDGE_CELLS:g} cells of a cell edge, {int(edge.sum())} values excluded")
    assert counted.mean() < EDGE_SHARE, (label, int(counted.sum()))
    keep = ~edge
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g)[keep], np.asarray(w)[keep], rtol=0,
                                   atol=IV_ATOL, err_msg=label)


# ---- the grid


@pytest.mark.parametrize("style", ["centers", "corners"])
def test_eval_sigma_grid_matches_jax(jx, style):
    got, want = _sigma_pair(jx, style)
    assert got.shape == (RES,) * 3 and got.min() >= 0.0
    np.testing.assert_allclose(got, want, rtol=SIGMA_RTOL, atol=SIGMA_ATOL)
    lin = po.lattice_axis(RES, RADIUS, style)
    assert lin.dtype == np.float32 and np.array_equal(
        lin, np.linspace(-RADIUS, RADIUS, RES, dtype=np.float32) if style == "corners"
        else (np.arange(RES, dtype=np.float32) + 0.5) * (2 * RADIUS / RES) - RADIUS)


@pytest.mark.parametrize("rounds", [1, 2])
def test_dilate_matches_jax(jx, rounds):
    occ = np.random.default_rng(1).uniform(size=(RES,) * 3) < 0.02
    want = np.asarray(jx.jo.dilate_occupancy(jx.jnp.asarray(occ), rounds))
    got = po.dilate_occupancy(torch.tensor(occ), rounds).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.sum() > occ.sum()


@pytest.mark.parametrize("dilate", [0, 1])
def test_build_grid_matches_jax(jx, dilate):
    """Equal in every cell but those whose σ lies within THRESH_RTOL of the
    threshold (and, after dilation, the cells they reach): counted, few."""
    _, sigma = _sigma_pair(jx)
    thr = _threshold(sigma)
    kw = dict(sigma_threshold=thr, center=CENTER, radius=RADIUS, resolution=RES, dilate=dilate,
              batch=1000)
    want = jx.jo.build_occupancy_grid(jx.j_field, jx.trees["fine"], **kw)
    got = po.build_occupancy_grid(jx.p_field, device="cpu", **kw)
    near = np.abs(sigma - thr) <= THRESH_RTOL * abs(thr)
    n_near = int(near.sum())
    if dilate:
        near = po.dilate_occupancy(torch.tensor(near), dilate).numpy()
    differ = got.occ.numpy() != np.asarray(want.occ)
    print(f"cells within {THRESH_RTOL:g} of the threshold: {n_near} ({int(near.sum())} "
          f"dilated), decided otherwise: {int(differ.sum())}")
    assert not (differ & ~near).any()
    assert n_near <= max(1, 1e-3 * near.size)
    assert got.occ.dtype == torch.bool and got.resolution == RES
    assert abs(got.occupancy_fraction() - float(want.occupancy_fraction())) <= near.mean()
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    assert float(got.radius) == float(want.radius)


# ---- tightening


@pytest.mark.parametrize("probes", [32, 128])
def test_tighten_ray_intervals_matches_jax(jx, shared_grid, probes):
    jg, pg = _grids(jx, shared_grid)
    o, d, near, far = _rays()
    want = jx.jo.tighten_ray_intervals(jg, *(jx.jnp.asarray(a) for a in (o, d, near, far)),
                                       num_probes=probes)
    got = po.tighten_ray_intervals(pg, *(torch.tensor(a) for a in (o, d, near, far)),
                                   num_probes=probes)
    _assert_intervals(got, want, _edge_rays(pg, o, d, near, far, probes), "rays")
    tn, tf = (g.numpy() for g in got)
    assert ((tn >= near) & (tf <= far) & (tn <= tf)).all()
    assert (tf - tn < far - near).any() and (tf - tn == far - near).any()


@pytest.mark.parametrize("block", [64, 1000])
def test_tighten_store_intervals_matches_jax(jx, shared_grid, block):
    """Blocks that do not divide the store (300 rays in blocks of 64) and
    one block; always from the scene's scalars."""
    jg, pg = _grids(jx, shared_grid)
    o, d, _, _ = _rays(seed=2)
    data = np.concatenate([o, d, np.zeros((o.shape[0], 6), np.float32)], -1)
    want = np.asarray(jx.jo.tighten_store_intervals(jg, jx.jnp.asarray(data), 2.0, 6.0,
                                                    num_probes=64, block=block))
    got = po.tighten_store_intervals(pg, torch.tensor(data), 2.0, 6.0, num_probes=64,
                                     block=block)
    assert got.shape == (300, 2) and got.dtype == torch.float32
    n = data.shape[0]
    edge = _edge_rays(pg, o, d, np.full(n, 2.0, np.float32), np.full(n, 6.0, np.float32), 64)
    _assert_intervals((got[:, 0], got[:, 1]), (want[:, 0], want[:, 1]), edge, "store")


def _frame(h, w):
    c2w = torch.tensor(pose_spherical(-30.0, -40.0, 4.0))
    ro, rd = get_ray_bundle_c2w(h, w, 1.1 * w, c2w)
    return ro.reshape(-1, 3).numpy(), rd.reshape(-1, 3).numpy()


@pytest.mark.parametrize("hw", [(24, 32), (15, 20)], ids=["divisible", "odd"])
def test_tighten_image_intervals_matches_jax(jx, shared_grid, hw):
    """The probed pixels' exclusions spread through the 3x3 window and the
    upsampling to every pixel they reach; the odd frame probes every ray."""
    jg, pg = _grids(jx, shared_grid)
    h, w = hw
    o, d = _frame(h, w)
    near, far = np.full(h * w, 2.0, np.float32), np.full(h * w, 6.0, np.float32)
    probes, s = 64, 2
    want = jx.jo.tighten_image_intervals(jg, *(jx.jnp.asarray(a) for a in (o, d, near, far)),
                                         hw, num_probes=probes, subsample=s)
    got = po.tighten_image_intervals(pg, *(torch.tensor(a) for a in (o, d, near, far)), hw,
                                     num_probes=probes, subsample=s)
    if h % s or w % s:
        probed = edge = _edge_rays(pg, o, d, near, far, probes)
    else:
        sub = lambda a: a.reshape(h, w, -1)[::s, ::s].reshape(-1, a.shape[-1])  # noqa: E731
        probed = _edge_rays(pg, sub(o), sub(d), sub(near[:, None])[:, 0],
                            sub(far[:, None])[:, 0], probes)
        spread = torch.nn.functional.max_pool2d(
            torch.tensor(probed, dtype=torch.float32).reshape(1, 1, h // s, w // s), 3, 1, 1)
        edge = (spread[0, 0].repeat_interleave(s, 0).repeat_interleave(s, 1) > 0)
        edge = edge.reshape(-1).numpy()
    _assert_intervals(got, want, edge, "image", counted=probed)
    tn, tf = (g.numpy() for g in got)
    assert ((tn >= near) & (tf <= far) & (tn <= tf)).all() and (tf - tn < 4.0).any()


# ---- the store's intervals


def test_store_intervals_feed_batches():
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 4, 6, 3)).astype(np.float32)
    poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in (-40.0, 50.0)])
    store = build_ray_store(images, poses, [4, 6, 7.2], 2.0, 6.0, device="cpu")
    full = with_full_intervals(store)
    assert full.intervals.shape == (48, 2) and with_full_intervals(full) is full
    idx = torch.tensor([0, 5, 47, 5])
    a, _ = take_ray_batch(store, idx)
    b, _ = take_ray_batch(full, idx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    iv = torch.stack([torch.arange(48.0), torch.arange(48.0) + 100.0], -1)
    rays, _ = take_ray_batch(dataclasses.replace(store, intervals=iv), idx)
    assert rays.near.tolist() == [0.0, 5.0, 47.0, 5.0]
    assert rays.far.tolist() == [100.0, 105.0, 147.0, 105.0]


# ---- rendering


def _render_pair(jx, grid, frame, subsample=2):
    """Both packages' render of the frame ``frame`` ([H, W]), or of the flat
    bundle of ``_rays`` when None."""
    jg, pg = _grids(jx, grid)
    o, d = _frame(*frame) if frame is not None else _rays()[:2]
    shape = frame if frame is not None else (o.shape[0],)
    ro, rd = o.reshape(*shape, 3), d.reshape(*shape, 3)
    kw = dict(occupancy_probes=64, occupancy_subsample=subsample)
    from dexnerf_tpu.render import render_image as j_render

    params = {k: jx.jax.tree.map(jx.jnp.asarray, t) for k, t in jx.trees.items()}
    want = j_render(jx.jm.apply, jx.jm.apply, params, jx.jnp.asarray(ro), jx.jnp.asarray(rd),
                    2.0, 6.0, jx.js, occupancy=jg, block_size=256, **kw)
    with torch.no_grad():
        got = render_image(jx.models["coarse"], jx.models["fine"], torch.tensor(ro),
                           torch.tensor(rd), 2.0, 6.0, jx.ps, occupancy=pg, **kw)
    return got, want


@pytest.mark.parametrize("frame", ["image", "rays"])
def test_render_image_with_occupancy_matches_jax(jx, shared_grid, frame):
    """A full frame (image tightening) and a flat ray bundle (per-ray
    tightening): rgb, depth and the Dex depths of both passes."""
    got, want = _render_pair(jx, shared_grid, (16, 20) if frame == "image" else None)
    for name in ("coarse", "fine"):
        g, w = getattr(got, name), getattr(want, name)
        for field in ("rgb", "depth", "accumulation"):
            np.testing.assert_allclose(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{name}.{field}")
    np.testing.assert_allclose(got.fine.depth_dex.numpy(), np.asarray(want.fine.depth_dex),
                               rtol=RTOL, atol=ATOL)
    crossed = got.fine.depth_dex.numpy() != got.fine.depth_dex.numpy().min()
    assert crossed.any() and not crossed.all()


# ---- the JAX suite's analytic sphere (tests/test_occupancy.py), on the port

SPHERE_R = 0.5


def sphere_field(pts, viewdirs):
    """σ 50 inside a sphere of radius 0.5 at the origin, -10 outside; rgb
    logits 4."""
    sigma = torch.where(pts.norm(dim=-1) < SPHERE_R, 50.0, -10.0)
    return torch.cat([torch.full((*pts.shape[:-1], 3), 4.0), sigma[..., None]], -1)


def _sphere_grid(dilate=1):
    return po.build_occupancy_grid(sphere_field, device="cpu", sigma_threshold=1.0,
                                   radius=1.0, resolution=32, dilate=dilate, batch=4096)


def test_sphere_bake_matches_volume():
    g0 = _sphere_grid(0)
    expect = (4.0 / 3.0) * np.pi * SPHERE_R ** 3 / 2.0 ** 3
    assert abs(g0.occupancy_fraction() - expect) < 0.25 * expect
    assert _sphere_grid(2).occupancy_fraction() > _sphere_grid(1).occupancy_fraction() > (
        g0.occupancy_fraction())


def test_sphere_chord_bracketed_and_miss_kept():
    o = torch.tensor([[0.0, 0.0, -2.0], [0.0, 2.0, -2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    n2, f2 = po.tighten_ray_intervals(_sphere_grid(), o, d, torch.full((2,), 0.5),
                                      torch.full((2,), 3.5), num_probes=128)
    # the chord is [1.5, 2.5]; slack: one dilated cell (2/32) + one probe step
    slack = 2.0 / 32 + 3.0 / 128 + 1e-3
    assert 1.5 - slack - 2.0 / 32 <= float(n2[0]) <= 1.5
    assert 2.5 <= float(f2[0]) <= 2.5 + slack + 2.0 / 32
    assert float(f2[0] - n2[0]) < 1.5
    assert float(n2[1]) == 0.5 and float(f2[1]) == 3.5


def _sphere_rays(h=12, w=12):
    ii, jj = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    d = np.stack([(ii - w / 2.0) / 15.0, (jj - h / 2.0) / 15.0, np.ones_like(ii)], -1)
    d = torch.tensor(d, dtype=torch.float32)
    return torch.tensor([0.0, 0.0, -2.0]).expand(h, w, 3).contiguous(), d


def _sphere_render(samples, occupancy=None, subsample=1):
    ro, rd = _sphere_rays()
    s = RenderSettings(num_coarse=samples, num_fine=0, perturb=False)
    return render_image(
        None, None, ro, rd, 0.5, 3.5, s, occupancy=occupancy, occupancy_probes=128,
        occupancy_subsample=subsample,
        rays_impl=lambda rays: render_rays(None, None, rays, s, coarse_field=sphere_field),
    ).coarse


def test_sphere_tightened_render_matches_full_interval():
    full = _sphere_render(256)
    for subsample in (1, 2):
        tight = _sphere_render(256, _sphere_grid(), subsample)
        np.testing.assert_allclose(tight.rgb.numpy(), full.rgb.numpy(), atol=2e-2)
        hit = full.accumulation.numpy() > 0.9
        assert hit.any()
        np.testing.assert_allclose(tight.depth.numpy()[hit], full.depth.numpy()[hit], atol=2e-2)


def test_sphere_occupancy_beats_full_interval_at_low_samples():
    ref = _sphere_render(1024)
    hit = ref.accumulation.numpy() > 0.9
    err_tight = np.abs(_sphere_render(24, _sphere_grid()).depth.numpy() - ref.depth.numpy())
    err_full = np.abs(_sphere_render(24).depth.numpy() - ref.depth.numpy())
    assert err_tight[hit].mean() < 0.5 * err_full[hit].mean()


def test_sphere_image_tightening_is_conservative():
    g = _sphere_grid()
    ro, rd = (t.reshape(-1, 3) for t in _sphere_rays())
    near, far = torch.full((144,), 0.5), torch.full((144,), 3.5)
    dn, df = po.tighten_ray_intervals(g, ro, rd, near, far, num_probes=128)
    sn, sf = po.tighten_image_intervals(g, ro, rd, near, far, (12, 12), num_probes=128,
                                        subsample=2)
    hit = (df - dn) < 2.9
    assert hit.any()
    assert bool((sn[hit] <= dn[hit] + 1e-5).all()) and bool((sf[hit] >= df[hit] - 1e-5).all())
    assert bool((sn <= sf + 1e-6).all())


def test_ndc_refused():
    ro, rd = _sphere_rays()
    with pytest.raises(ValueError, match="world-space"):
        render_image(None, None, ro, rd, 0.5, 3.5, RenderSettings(num_coarse=8, num_fine=0),
                     occupancy=_sphere_grid(), use_ndc=True, height=12, width=12,
                     focal_length=15.0, rays_impl=lambda r: None)


# ---- run_training with occupancy


def _train_cfg(tmp_path, data, iters=5):
    raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
    raw["experiment"].update(id="occ", train_iters=iters, validate_every=0, save_every=0,
                             print_every=1, randomseed=5)
    raw["nerf"]["train"].update(
        occupancy_start_iter=2, occupancy_rebake_every=2, occupancy_resolution=16,
        occupancy_radius=1.5, occupancy_dilate=1, occupancy_probes=16)
    return raw


def _jax_draws(jx, seed, iters, batch, num_rays, s):
    """The draws of JAX's run_training steps (``key, sub = split(key)`` per
    iteration from ``PRNGKey(seed)``; in each step ``k_sample, k_render =
    split(sub)``, the ray indices from ``k_sample`` and the render draws
    from ``k_render`` in ``render_rays``' split order)."""
    jax, jnp = jx.jax, jx.jnp
    from dexnerf_tpu_torch.render.renderer import RenderDraws

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        k_sample, k_render = jax.random.split(sub)
        idx = jax.random.randint(k_sample, (batch,), 0, num_rays)
        k_strat, _, k_fine, _ = jax.random.split(k_render, 4)
        t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
        out.append(StepDraws(idx=t(idx).to(torch.int64), render=RenderDraws(
            t_strat=t(jax.random.uniform(k_strat, (batch, s.num_coarse), dtype=jnp.float32)),
            noise_coarse=None,
            u_fine=t(jax.random.uniform(k_fine, (batch, s.num_fine), dtype=jnp.float32)),
            noise_fine=None)))
    return out


@pytest.fixture(scope="module")
def occ_scene(tmp_path_factory):
    from test_torch_eval import calibrated_checkpoint

    tmp = tmp_path_factory.mktemp("occ_train")
    data = str(tmp / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(3, 1, 1))
    raw = _train_cfg(tmp, data)
    ckpt = str(tmp / "start.ckpt")
    calibrated_checkpoint(raw, ckpt)
    return data, ckpt


def test_run_training_with_occupancy_matches_jax(jx, tmp_path, monkeypatch, occ_scene):
    """5 steps, bakes after steps 2 and 4, on one starting ``.ckpt`` and
    JAX's draws: the store's intervals after each bake, the losses, the
    logged occupancy scalars and the final parameters."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.render import occupancy as jo
    from dexnerf_tpu.train.loop import run_training as j_run

    data, ckpt = occ_scene
    raw = _train_cfg(tmp_path, data)
    thr = 5.0
    bakes = {"jax": [], "port": []}
    j_tighten, p_tighten = jo.tighten_store_intervals, ploop.tighten_store_intervals

    def j_spy(*a, **k):
        iv = j_tighten(*a, **k)
        bakes["jax"].append((np.asarray(a[1]), np.asarray(iv)))
        return iv

    def p_spy(*a, **k):
        iv = p_tighten(*a, **k)
        bakes["port"].append((a[1].numpy().copy(), iv.numpy().copy()))
        return iv

    monkeypatch.setattr(jo, "tighten_store_intervals", j_spy)
    monkeypatch.setattr(ploop, "tighten_store_intervals", p_spy)
    raw_j = json.loads(json.dumps(raw))
    raw_j["experiment"]["id"] = "occ_jax"
    want = j_run(JCfg(raw_j), load_ckpt=ckpt, occupancy=thr, use_tensorboard=False)

    make_step = ploop.make_train_step
    s = ploop.render_settings_from_cfg(CfgNode(raw), "train")
    num_rays = 3 * 8 * 8
    draws = iter(_jax_draws(jx, 5, 5, 16, num_rays, s))

    def make_with_draws(*a, **k):
        step = make_step(*a, **k)
        return lambda state, store, generator: step(state, store, generator, draws=[next(draws)])

    monkeypatch.setattr(ploop, "make_train_step", make_with_draws)
    got = ploop.run_training(CfgNode(raw), load_ckpt=ckpt, occupancy=thr, device="cpu")

    assert len(bakes["port"]) == len(bakes["jax"]) == 2
    for (pd, piv), (jd, jiv) in zip(bakes["port"], bakes["jax"]):
        np.testing.assert_allclose(pd[:, :6], jd[:, :6], rtol=0, atol=1e-6)
        np.testing.assert_allclose(piv, jiv, rtol=0, atol=IV_ATOL)
        assert (piv[:, 0] >= 2.0).all() and (piv[:, 1] <= 6.0).all()
    assert (bakes["port"][-1][1][:, 1] - bakes["port"][-1][1][:, 0] < 4.0).any()

    def records(logdir):
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return {(r["tag"], r["step"]): r["value"] for r in recs
                if r["tag"] in ("train/loss", "train/occ_fraction", "train/occ_interval_shrink")}

    a, b = records(got["logdir"]), records(str(tmp_path / "logs" / "occ_jax"))
    assert set(a) == set(b)
    assert sorted(s for t, s in a if t == "train/occ_fraction") == [1, 3]
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=str(k))
    assert got["occ_fraction"] == pytest.approx(want["occ_fraction"], abs=1e-6)
    assert got["occ_interval_shrink"] == pytest.approx(want["occ_interval_shrink"], abs=1e-6)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(jx.jax.tree.map(np.asarray, want["state"].params[name]))
        for pname, p in getattr(got["state"], name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{name}.{pname}")


@pytest.mark.parametrize("guard", ["ndc", "host_store", "pose_opt"])
def test_run_training_guards_match_jax(jx, tmp_path, occ_scene, guard):
    """JAX's guards raise in both packages with the same message."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import SceneData as JScene
    from dexnerf_tpu.train.loop import run_training as j_run

    raw = _train_cfg(tmp_path, occ_scene[0])
    kw = {}
    if guard == "host_store":
        raw["dataset"]["host_store"] = True
    elif guard == "pose_opt":
        raw["nerf"]["train"]["pose_opt"] = True
    else:
        scene = ploop.load_scene(CfgNode(raw))
        fields = dict(images=scene.images, poses=scene.poses, hwf=scene.hwf,
                      i_train=scene.i_train, i_val=scene.i_val, use_ndc=True)
        kw = dict(port=ploop.SceneData(**fields), jax=JScene(**fields))
    with pytest.raises(ValueError) as got:
        ploop.run_training(CfgNode(raw), occupancy=0.5, device="cpu", scene=kw.get("port"))
    with pytest.raises(ValueError) as want:
        j_run(JCfg(raw), occupancy=0.5, use_tensorboard=False, scene=kw.get("jax"))
    assert str(got.value) == str(want.value)


# ---- the CLIs on --device cpu


def test_train_cli_occupancy_logs_both_scalars(tmp_path, occ_scene):
    raw = _train_cfg(tmp_path, occ_scene[0], iters=4)
    raw["nerf"]["train"].update(occupancy_start_iter=1, occupancy_rebake_every=2)
    cfg = str(tmp_path / "train.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    assert train_app.main(["--config", cfg, "--device", "cpu", "--occupancy", "0.5"]) == 0
    with open(tmp_path / "logs" / "occ" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for tag in ("train/occ_fraction", "train/occ_interval_shrink"):
        steps = [r["step"] for r in recs if r["tag"] == tag]
        assert steps == [0, 2], tag
        assert all(0.0 <= r["value"] <= 1.0 for r in recs if r["tag"] == tag)


def test_eval_cli_occupancy_matches_jax(jx, tmp_path):
    """Both ``apps.eval`` mains with ``--occupancy``: the PNGs and the
    test-set metrics agree, and the grid's fraction is printed."""
    data = str(tmp_path / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(1, 1, 2))
    raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
    flags = ["--test-set", "--occupancy", "2.0", "--occupancy-resolution", "16",
             "--occupancy-probes", "32", "--save-disparity-image"]
    dirs = run_both(tmp_path, raw, flags)
    assert _assert_pngs_close(dirs) >= 4
    got, want = (json.load(open(os.path.join(dirs[k], "metrics.json"))) for k in ("port", "jax"))
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got["mean"][k], want["mean"][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["depth-confidence", "ndc"])
def test_eval_occupancy_refusals_match_jax(jx, tmp_path, case):
    from dexnerf_tpu.apps.eval import main as j_main
    from test_torch_eval import calibrated_checkpoint

    data = str(tmp_path / "data")
    if case == "ndc":
        from dexnerf_tpu_torch.data.synthetic import write_llff_dataset

        write_llff_dataset(data, 16, 24)
        dataset = {"type": "llff", "basedir": data, "no_ndc": False, "downsample_factor": 1,
                   "near": 0.0, "far": 1.0}
    else:
        write_blender_dataset(data, height=8, width=8, views_per_split=(1, 1, 1))
        dataset = {"type": "blender", "basedir": data}
    raw = tiny_cfg(dataset, str(tmp_path / "logs"))
    cfg_path, ckpt = str(tmp_path / "eval.yml"), str(tmp_path / "model.ckpt")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    calibrated_checkpoint(raw, ckpt)
    flags = ["--config", cfg_path, "--checkpoint", ckpt, "--occupancy", "0.5", "--savedir",
             str(tmp_path / "out")]
    if case == "depth-confidence":
        flags += ["--save-depth-confidence", "0.05"]
    with pytest.raises(SystemExit) as got:
        eval_app.main([*flags, "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        j_main([*flags, "--platform", "cpu"])
    assert str(got.value) == str(want.value) and "occupancy" in str(got.value)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_occupancy_matches_jax(jx, tmp_path):
    """Both services with ``--occupancy``: /healthz reports it, /render and
    /depth answer (the depths agree), /confidence is refused with JAX's
    message."""
    from dexnerf_tpu.apps import serve as jserve
    from test_torch_serve import CONFIG, POSE, _seeded_checkpoint

    cfg_path, ckpt = str(tmp_path / "config.yml"), str(tmp_path / "seeded.ckpt")
    with open(cfg_path, "w") as f:
        f.write(CONFIG)
    _seeded_checkpoint(cfg_path, ckpt)
    common = ["--config", cfg_path, "--checkpoint", ckpt, "--hwf", "8", "8", "10.0",
              "--occupancy", "0.5", "--occupancy-resolution", "16", "--occupancy-probes", "32"]
    services = [serve.build_service(serve.build_parser().parse_args(common + ["--device", "cpu"])),
                jserve.build_service(jserve.build_parser().parse_args(common + ["--platform",
                                                                               "cpu"]))]
    httpds = [serve.make_http_server(services[0], "127.0.0.1", 0),
              jserve.make_http_server(services[1], "127.0.0.1", 0)]
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in httpds]
    for t in threads:
        t.start()
    bases = [f"http://127.0.0.1:{h.server_address[1]}" for h in httpds]
    try:
        info = [json.loads(_get(b + "/healthz")[1]) for b in bases]
        assert info[0]["occupancy"] is info[1]["occupancy"] is True
        assert info[0]["depth_confidence"] is info[1]["depth_confidence"] is False
        for path in ("/render?" + POSE, "/depth?" + POSE, "/depth?" + POSE + "&threshold=10"):
            (code_p, body_p), (code_j, body_j) = (_get(b + path) for b in bases)
            assert code_p == code_j == 200, path
            if path.startswith("/depth"):
                np.testing.assert_allclose(np.load(io.BytesIO(body_p)), np.load(io.BytesIO(body_j)),
                                           rtol=RTOL, atol=ATOL, err_msg=path)
        (code_p, body_p), (code_j, body_j) = (_get(b + "/confidence?" + POSE) for b in bases)
        assert code_p == code_j == 400
        assert json.loads(body_p)["error"] == json.loads(body_j)["error"]
    finally:
        for h, t in zip(httpds, threads):
            h.shutdown()
            h.server_close()
            t.join(timeout=30)
