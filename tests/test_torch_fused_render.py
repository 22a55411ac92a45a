"""The fused render pass of the port (``dexnerf_tpu_torch/ops/fused_render.py``).

On the CPU: its plain PyTorch version, and ``make_fused_render_rays`` on CPU
tensors, held to the JAX fused kernel (``make_fused_render_rays(...,
interpret=True)``) and to the JAX XLA renderer on one set of weights and
rays. On a CUDA card (marker ``gpu``): the CUDA kernel held to the plain
version. The JAX package is imported inside a fixture, so that this file
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_render.py
"""

import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.core.volrend import ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderSettings, render_rays

RTOL, ATOL = 2e-4, 2e-5  # vs the JAX kernel / XLA renderer on the CPU
GPU_RTOL, GPU_ATOL = 1e-4, 1e-5  # kernel vs plain, f32 on both sides
ENC_XYZ, ENC_DIR = 3, 2
THRESHOLDS = (5.0, 10.0)
SETTINGS = RenderSettings(
    num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
    white_background=True, m_thres_cand=THRESHOLDS,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
ARCH = dict(num_layers=3, hidden_size=32, skip_connect_every=4,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)


def _rays(n=20, seed=2):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((n,), 2.0, np.float32)
    return ro, rd, vd, near, near + 4.0


def _sigma_scale(model, ro, rd, vd, z, std=20.0):
    """(k, shift) that make the σ logit over these samples mean 0, std
    ``std``: random weights give a σ spread of ~1e-3, which crosses no
    Dex threshold."""
    from dexnerf_tpu_torch.core.encoding import positional_encoding

    with torch.no_grad():
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = model(positional_encoding(pts, ENC_XYZ), positional_encoding(vd, ENC_DIR))[..., 3]
        k = std / float(raw.std())
        return k, -float(raw.mean()) * k


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: modules, flax trees for coarse and fine with a
    scaled σ head, and the port's models holding the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.ops import make_fused_render_rays as j_make
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import render_rays as j_render_rays
    from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    ro, rd, vd, near, far = (torch.tensor(a) for a in _rays())
    z = stratified_z_vals(near, far, SETTINGS.num_coarse)
    trees, models = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(i), jnp.ones((1, in_dim))))
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(tree))
        k, shift = _sigma_scale(m, ro, rd, vd, z)
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= k
        alpha["bias"] = alpha["bias"] * k + shift
        m.load_state_dict(state_dict_from_flax(tree))
        trees[name], models[name] = tree, m
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jm=jm, make=j_make, JRayBatch=JRayBatch,
        settings=JSettings(**SETTINGS.__dict__), render_rays=j_render_rays,
        params=trees, coarse=models["coarse"], fine=models["fine"],
    )


def _jax_rays(jx, ro, rd, vd, near, far):
    return jx.JRayBatch(*(jx.jnp.asarray(a) for a in (ro, rd, vd, near, far)))


def _port_rays(ro, rd, vd, near, far):
    return RayBatch(*(torch.tensor(a) for a in (ro, rd, vd, near, far)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _hit_share(model, rays, z, thresholds):
    from dexnerf_tpu_torch.core.encoding import positional_encoding

    with torch.no_grad():
        pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
        sigma = model(positional_encoding(pts, ENC_XYZ),
                      positional_encoding(rays.viewdirs, ENC_DIR))[..., 3].relu()
    m = torch.tensor(thresholds)
    return float((sigma[None] > m[:, None, None]).any(-1).float().mean())


def test_fused_rays_match_jax_kernel_and_xla(jx):
    arrays = _rays()
    launches = fr.launches
    got = fr.make_fused_render_rays(jx.coarse, jx.fine, SETTINGS)(_port_rays(*arrays))
    assert fr.launches == launches  # CPU tensors never reach the kernel
    jrays = _jax_rays(jx, *arrays)
    kernel = jx.make(jx.jm, jx.jm, jx.settings, block_samples=64, interpret=True)(
        jx.params, jrays, None
    )
    xla = jx.render_rays(jx.jm.apply, jx.jm.apply, jx.params, jrays, None, jx.settings)
    for want in (kernel, xla):
        for name in ("coarse", "fine"):
            g, w = getattr(got, name), getattr(want, name)
            for f in ("rgb", "weights", "depth", "accumulation"):
                _close(getattr(g, f), getattr(w, f))
            ok = np.asarray(w.accumulation) > 0  # XLA's depth/acc is NaN at acc == 0
            _close(np.asarray(g.disparity)[ok], np.asarray(w.disparity)[ok])
        np.testing.assert_array_equal(got.fine.depth_dex.numpy(), np.asarray(want.fine.depth_dex))
    assert got.coarse.depth_dex is None and got.fine.depth_dex.shape == (2, 20)
    # both Dex branches occur on the fine pass
    share = _hit_share(jx.fine, _port_rays(*arrays), _fine_z(got, arrays), THRESHOLDS)
    assert 0.2 <= share <= 0.8, share


def _fine_z(got, arrays):
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals

    z_c = stratified_z_vals(torch.tensor(arrays[3]), torch.tensor(arrays[4]), 8)
    return hierarchical_z_vals(z_c, got.coarse.weights, 8, det=True)[0]


def test_reference_pass_matches_jax_kernel(jx):
    """One pass of the plain version vs one pass of the JAX kernel
    (interpret mode) on shared z/dists, without white background."""
    from dexnerf_tpu.ops.fused_render import make_fused_render

    ro, rd, vd, near, far = _rays(n=13, seed=5)
    z = stratified_z_vals(torch.tensor(near), torch.tensor(far), 12)
    dists = ray_dists(z, torch.tensor(rd))
    got = fr.fused_render_reference(
        jx.fine, *(torch.tensor(a) for a in (ro, rd, vd)), z, dists,
        thresholds=THRESHOLDS, chunk=5,
    )
    want = make_fused_render(jx.jm, block_samples=48, interpret=True)(
        jx.params["fine"], *(jx.jnp.asarray(a) for a in (ro, rd, vd)),
        jx.jnp.asarray(z.numpy()), jx.jnp.asarray(dists.numpy()), thresholds=THRESHOLDS,
    )
    for f in ("rgb", "weights", "depth", "accumulation", "disparity"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.depth_dex.numpy(), np.asarray(want.depth_dex))


def test_fused_rays_match_plain_renderer(jx):
    rays = _port_rays(*_rays(n=17, seed=7))
    a = fr.make_fused_render_rays(jx.coarse, jx.fine, SETTINGS)(rays)
    with torch.no_grad():
        b = render_rays(jx.coarse, jx.fine, rays, SETTINGS)
    for name in ("coarse", "fine"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            if x is not None:
                _close(x, y, rtol=1e-6, atol=1e-7)


def test_pack_flex_weights_layout():
    m = FlexibleNeRFModel(**ARCH).reset_parameters(torch.Generator().manual_seed(0))
    flat, offsets = fr.pack_flex_weights(m)
    layers = [m.layer1, *m.layers_xyz, m.fc_feat, m.fc_alpha, m.layers_dir[0], m.fc_rgb]
    assert len(offsets) == 2 * len(layers) and all(o % 4 == 0 for o in offsets)
    for lin, wo, bo in zip(layers, offsets[0::2], offsets[1::2]):
        n_in, n_out = lin.in_features, lin.out_features
        w = flat[wo:wo + n_in * n_out].reshape(n_in, n_out)
        assert torch.equal(w, lin.weight.detach().t())
        assert torch.equal(flat[bo:bo + n_out], lin.bias.detach())


def test_unsupported_device_raises():
    m = FlexibleNeRFModel(**ARCH)
    x = torch.zeros((2, 3), device="meta")
    z = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no fused render"):
        fr.fused_render(m, x, x, x, z, z)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "arch,S,T,white",
    [
        (dict(ARCH), 8, 2, True),
        (FULL, 128, 20, False),
        (FULL, 192, 20, False),
        (FULL, 64, 1, True),
        (dict(FULL, hidden_size=8), 64, 20, False),
        (dict(FULL, hidden_size=8), 192, 1, True),
        (dict(FULL, hidden_size=16), 128, 20, True),
        (dict(FULL, hidden_size=16), 64, 1, False),
        (dict(FULL, hidden_size=48), 192, 20, False),
        (dict(FULL, hidden_size=48), 128, 1, True),
        (dict(FULL, num_encoding_fn_xyz=16), 128, 20, False),
        (dict(FULL, hidden_size=136), 128, 20, False),
        (dict(FULL, hidden_size=256), 192, 20, False),
        (dict(FULL, hidden_size=256, num_encoding_fn_xyz=16), 64, 1, True),
        (dict(FULL, hidden_size=fr.MAX_HIDDEN), 64, 20, True),
    ],
    ids=["tiny", "fine-128", "fine-192", "h128-64-t1", "h8-64", "h8-192-t1", "h16-128",
         "h16-64-t1", "h48-192", "h48-128-t1", "pe16-128", "h136-128", "h256-192",
         "h256-pe16-64-t1", "hmax-64"],
)
def test_kernel_matches_plain_on_card(cuda, arch, S, T, white):
    """The float32 route (split TF32 on wgmma) vs its plain version at widths
    8-128 (zero-padded to a multiple of 32) and on its wide route (136
    padded to 160, 256, MAX_HIDDEN: ops/csrc/mlp_wide_tf32.cuh), PE up to 16
    frequencies, 8-192 samples per ray and 1-20 thresholds, with one ray of
    zero weights (its intervals 0) and a σ head scaled so that both Dex
    branches occur."""
    m = FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(0))
    ro, rd, vd, near, far = (torch.tensor(a, device=cuda) for a in _rays(n=300, seed=9))
    m = m.to(cuda)
    z = stratified_z_vals(near, far, S)
    from dexnerf_tpu_torch.core.encoding import positional_encoding

    with torch.no_grad():  # σ logit over these samples: mean 0, std 30
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = m(positional_encoding(pts, m.num_encoding_fn_xyz),
                positional_encoding(vd, m.num_encoding_fn_dir))[..., 3]
        k = 30.0 / raw.std()
        m.fc_alpha.weight.mul_(k)
        m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
    dists = ray_dists(z, rd)
    dists[7] = 0.0  # a ray of zero weights
    thr = tuple(5.0 * (i + 1) for i in range(T))
    before, before_bf16, before_wide = fr.launches, fr.launches_bf16, fr.launches_wide_f32
    with torch.inference_mode():
        got = fr.fused_render(m, ro, rd, vd, z, dists, thresholds=thr, white_background=white)
        again = fr.fused_render(m, ro, rd, vd, z, dists, thresholds=thr, white_background=white)
        want = fr.fused_render_reference(m, ro, rd, vd, z, dists, thresholds=thr,
                                         white_background=white)
    torch.cuda.synchronize()
    assert fr.launches == before + 2 and fr.launches_bf16 == before_bf16
    assert fr.launches_wide_f32 == before_wide + 2 * int(fr.is_wide(m))
    for f in ("rgb", "disparity", "accumulation", "depth", "weights"):
        assert torch.equal(getattr(got, f), getattr(again, f)), f  # deterministic
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=GPU_RTOL, atol=GPU_ATOL)
    assert float(got.accumulation[7]) == 0.0 and not got.weights[7].any()
    assert float((got.depth_dex == want.depth_dex).float().mean()) >= 0.9999
    if T == 20:  # both Dex branches: a crossing, and z[0] where none
        hit = (got.depth_dex != z[None, :, 0]).float().mean()
        assert 0.05 < float(hit) < 0.95, float(hit)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_render(m, ro, rd, vd, z.t().contiguous().t(), dists)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render(m, ro.double(), rd, vd, z, dists)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 16])
def test_wide_kernel_small_units_on_card(cuda, S):
    """The wide f32 route with many rays a unit (S = 8: 16 rays, S = 16: 8;
    each ray its own viewdir bias) at width 200 (padded to 224: a 128- and
    a 96-column block), by the rule above. The σ logit's spread is 30 S / 64
    and the thresholds 5 S / 64 and 10 S / 64, so that σ times the interval
    (4 / S) spans what it does in the S = 64 cases above: at a spread of 30
    the weights of 8 samples are small differences of large sums, which f32
    rounding alone moves from float64 by more than the tolerance. The
    narrow route shows it too: at a spread of 30 on these rays it misses
    the rule on one weight of a 128-wide model at S = 16 (1.8 times the
    tolerance), as the wide route does at 200 and S = 8 (1.1 times), and
    the wide route gives the narrow route's result bit for bit on the same
    function (``perf_tools/kernel1_small_units.py``;
    :func:`test_wide_route_is_the_narrow_one_on_card`)."""
    m = FlexibleNeRFModel(**dict(FULL, hidden_size=200)).reset_parameters(
        torch.Generator().manual_seed(0))
    ro, rd, vd, near, far = (torch.tensor(a, device=cuda) for a in _rays(n=300, seed=9))
    m = m.to(cuda)
    z = stratified_z_vals(near, far, S)
    from dexnerf_tpu_torch.core.encoding import positional_encoding

    with torch.no_grad():  # σ logit over these samples: mean 0, std 30 S / 64
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = m(positional_encoding(pts, m.num_encoding_fn_xyz),
                positional_encoding(vd, m.num_encoding_fn_dir))[..., 3]
        k = 30.0 * S / 64 / raw.std()
        m.fc_alpha.weight.mul_(k)
        m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
    dists = ray_dists(z, rd)
    thr = (5.0 * S / 64, 10.0 * S / 64)
    before = fr.launches_wide_f32
    with torch.inference_mode():
        got = fr.fused_render(m, ro, rd, vd, z, dists, thresholds=thr)
        want = fr.fused_render_reference(m, ro, rd, vd, z, dists, thresholds=thr)
    torch.cuda.synchronize()
    assert fr.launches_wide_f32 == before + 1
    for f in ("rgb", "disparity", "accumulation", "depth", "weights"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=GPU_RTOL, atol=GPU_ATOL)
    assert float((got.depth_dex == want.depth_dex).float().mean()) >= 0.9999
    hit = (got.depth_dex != z[None, :, 0]).float().mean()
    assert 0.05 < float(hit) < 0.95, float(hit)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 128])
def test_wide_route_is_the_narrow_one_on_card(cuda, S):
    """A 128-wide model zero-padded to width 200 (every added weight and
    bias 0: the same function) through the wide f32 route gives the narrow
    route's result on the 128-wide model bit for bit, at σ spread 30 and 2
    thresholds: the wide tile keeps the narrow tile's split, its products
    and its order of sums."""
    from perf_tools.kernel1_small_units import embedded, scaled

    ro, rd, vd, near, far = (torch.tensor(a, device=cuda) for a in _rays(n=300, seed=9))
    z = stratified_z_vals(near, far, S)
    m = scaled(FlexibleNeRFModel(**FULL).reset_parameters(torch.Generator().manual_seed(0))
               .to(cuda), ro, rd, vd, z, 30.0)
    padded = embedded(m, 200)
    dists = ray_dists(z, rd)
    before = fr.launches_wide_f32
    with torch.inference_mode():
        narrow = fr.fused_render(m, ro, rd, vd, z, dists, thresholds=THRESHOLDS)
        wide = fr.fused_render(padded, ro, rd, vd, z, dists, thresholds=THRESHOLDS)
    torch.cuda.synchronize()
    assert fr.launches_wide_f32 == before + 1
    for f in ("rgb", "disparity", "accumulation", "depth", "weights", "depth_dex"):
        assert torch.equal(getattr(wide, f), getattr(narrow, f)), f


@pytest.mark.gpu
def test_kernel_residency_on_card(cuda):
    """Persistent: one CTA per SM at the full width, coarse and fine, within
    the block's shared-memory limit, with ring stages for at least two
    chunks (the one a consumer holds and the next), and every SM in the
    plan of a 400x400 frame."""
    m = FlexibleNeRFModel(**FULL).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for S in (64, 128):
        ctas, smem, stages = fr.tf32_occupancy(m, S)
        assert ctas == 1 and smem <= fr.SHARED_BYTES_LIMIT and stages >= 4, (S, ctas, smem)
        assert fr.render_plan(160_000, S, sms * ctas, fr.TF32_WORKERS).grid == sms
