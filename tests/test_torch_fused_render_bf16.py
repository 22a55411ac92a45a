"""The fused render pass at ``compute_dtype=bfloat16`` and the dtype the
port's frame renderer resolves (``dexnerf_tpu_torch/ops/fused_render.py``,
``train/loop.py::render_compute_dtype``).

On the CPU: the bf16 plain version (``flex_forward_bf16`` under
``fused_render_reference``) and ``make_fused_render_rays`` at bf16, held to
the JAX fused kernel at ``compute_dtype=jnp.bfloat16`` in interpret mode on
one set of weights and rays; the bf16 plain version differs from the f32
one by more than that tolerance; the dtype resolution. On a CUDA card
(marker ``gpu``): the bf16 tensor-core kernel held to the bf16 plain
version, its launch counter and its refusals. The JAX package is imported
inside a fixture, so that this file also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_render_bf16.py
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.core.volrend import ray_dists
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderSettings
from dexnerf_tpu_torch.train.loop import render_compute_dtype

BF16 = torch.bfloat16
ENC_XYZ, ENC_DIR = 6, 4
ARCH = dict(num_layers=8, hidden_size=64, skip_connect_every=3,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
THRESHOLDS = (-5.0, 5.0, 15.0)  # σ >= 0 always crosses -5: the hit branch everywhere
SETTINGS = RenderSettings(
    num_coarse=32, num_fine=32, perturb=False, radiance_field_noise_std=0.0,
    white_background=True, m_thres_cand=THRESHOLDS,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
N_RAYS = 64
# Port vs JAX, both at bf16 operands with f32 sums. The two sides sum each
# product in another order, so an f32 activation that lies next to a bf16
# rounding boundary can round to neighbouring bf16 values on the two sides
# (2^-8 relative of that one activation); a flipped trunk activation moves
# σ by up to ~1e-2 here, which moves weights and depth far more than rgb.
ATOL_RGB = 1e-4  # rgb, accumulation
ATOL_W = 1e-2  # weights, depth
DEX_EQUAL = 0.99  # Dex depths: a flip moves σ across a threshold


def _rays(n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((n,), 2.0, np.float32)
    return ro, rd, vd, near, near + 4.0


def _scale_sigma(model, ro, rd, vd, z, std=20.0):
    """(k, shift) that make the σ logit over these samples mean 0, std
    ``std``, so that both Dex branches occur."""
    with torch.no_grad():
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = model(positional_encoding(pts, ENC_XYZ), positional_encoding(vd, ENC_DIR))[..., 3]
        k = std / float(raw.std())
        return k, -float(raw.mean()) * k


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: its fused kernels at bf16 in interpret mode, flax
    trees for coarse and fine with a scaled σ head, and the port's models
    holding the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.ops.fused_render import make_fused_render, make_fused_render_rays
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    ro, rd, vd, near, far = (torch.tensor(a) for a in _rays())
    z = stratified_z_vals(near, far, SETTINGS.num_coarse)
    trees, models = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(10 + i), jnp.ones((1, in_dim))))
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(tree))
        k, shift = _scale_sigma(m, ro, rd, vd, z)
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= k
        alpha["bias"] = alpha["bias"] * k + shift
        m.load_state_dict(state_dict_from_flax(tree))
        trees[name], models[name] = tree, m
    return types.SimpleNamespace(
        jnp=jnp, jm=jm, render=make_fused_render, rays=make_fused_render_rays,
        JRayBatch=JRayBatch, settings=JSettings(**SETTINGS.__dict__),
        params=trees, coarse=models["coarse"], fine=models["fine"],
    )


def _pass_inputs(seed=5):
    ro, rd, vd, near, far = _rays(seed=seed)
    z = stratified_z_vals(torch.tensor(near), torch.tensor(far), SETTINGS.num_coarse)
    return (*(torch.tensor(a) for a in (ro, rd, vd)), z, ray_dists(z, torch.tensor(rd)))


def _jax_pass(jx, args, dtype):
    render = jx.render(jx.jm, block_samples=512, compute_dtype=dtype, interpret=True)
    return render(jx.params["fine"], *(jx.jnp.asarray(a.numpy()) for a in args),
                  thresholds=THRESHOLDS)


def _assert_bf16_close(got, want):
    for f in ("rgb", "accumulation"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=0, atol=ATOL_RGB, err_msg=f)
    for f in ("weights", "depth"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=0, atol=ATOL_W, err_msg=f)
    equal = np.asarray(got.depth_dex) == np.asarray(want.depth_dex)
    assert equal.mean() >= DEX_EQUAL, equal.mean()


def _hit_share(model, args, thresholds):
    ro, rd, vd, z = args[:4]
    with torch.no_grad():
        pts = ro[:, None] + rd[:, None] * z[..., None]
        sigma = model(positional_encoding(pts, ENC_XYZ),
                      positional_encoding(vd, ENC_DIR))[..., 3].relu()
    m = torch.tensor(thresholds)
    return (sigma[None] > m[:, None, None]).any(-1).float().mean(-1)


def test_bf16_reference_pass_matches_jax_kernel(jx):
    """One pass of the bf16 plain version vs one pass of the JAX kernel at
    compute_dtype=bfloat16 (interpret mode) on shared z/dists."""
    args = _pass_inputs()
    got = fr.fused_render_reference(jx.fine, *args, thresholds=THRESHOLDS,
                                    compute_dtype=BF16, chunk=24)
    want = _jax_pass(jx, args, jx.jnp.bfloat16)
    _assert_bf16_close(got, want)
    assert got.depth_dex.shape == (len(THRESHOLDS), N_RAYS)
    # the Dex branches: every ray hits -5; 5 and 15 split the rays
    share = _hit_share(jx.fine, args, THRESHOLDS)
    assert float(share[0]) == 1.0 and all(0.2 <= float(s) <= 0.95 for s in share[1:]), share


def test_bf16_rays_match_jax_kernel(jx):
    """make_fused_render_rays at bf16, coarse to fine with Dex thresholds, vs
    the JAX package's make_fused_render_rays at bf16 in interpret mode.

    The coarse pass is held to the one-pass tolerances. The fine pass runs
    at depths resampled from the coarse weights, so a coarse difference of
    ~1e-5 moves the fine depths, and with σ of std 20 a moved sample can
    change its weight by ~1e-3 or more. The fine pass is therefore held
    relative to the dtype's own effect: each field's error against the JAX
    bf16 kernel is at most a tenth of the f32 plain version's error against
    it (rgb and accumulation also within 1e-3), and the Dex depths, which
    are the moved sample depths, agree within ATOL_W on >= 99% of pairs."""
    arrays = _rays(seed=7)
    rays = RayBatch(*(torch.tensor(a) for a in arrays))
    launches = fr.launches
    got = fr.make_fused_render_rays(jx.coarse, jx.fine, SETTINGS, compute_dtype=BF16)(rays)
    assert fr.launches == launches  # CPU tensors never reach the kernel
    f32 = fr.make_fused_render_rays(jx.coarse, jx.fine, SETTINGS)(rays)
    want = jx.rays(jx.jm, jx.jm, jx.settings, block_samples=512,
                   compute_dtype=jx.jnp.bfloat16, interpret=True)(
        jx.params, jx.JRayBatch(*(jx.jnp.asarray(a) for a in arrays)), None)
    g, w = got.coarse, want.coarse
    for f in ("rgb", "accumulation"):
        np.testing.assert_allclose(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                   rtol=0, atol=ATOL_RGB, err_msg=f"coarse.{f}")
    for f in ("weights", "depth"):
        np.testing.assert_allclose(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                   rtol=0, atol=ATOL_W, err_msg=f"coarse.{f}")
    for f in ("rgb", "accumulation", "weights", "depth"):
        want_f = np.asarray(getattr(want.fine, f))
        err = np.abs(getattr(got.fine, f).numpy() - want_f).max()
        err_f32 = np.abs(getattr(f32.fine, f).numpy() - want_f).max()
        assert err <= 0.1 * err_f32, (f, err, err_f32)
        if f in ("rgb", "accumulation"):
            assert err <= 1e-3, (f, err)
    close = np.abs(got.fine.depth_dex.numpy() - np.asarray(want.fine.depth_dex)) <= ATOL_W
    assert close.mean() >= DEX_EQUAL, close.mean()


def test_bf16_differs_from_f32(jx):
    """The dtype is really applied: on the same inputs the bf16 plain
    version differs from the f32 one by more than the tolerances above, and
    so does the JAX kernel between its two dtypes."""
    args = _pass_inputs()
    kw = dict(thresholds=THRESHOLDS)
    b = fr.fused_render_reference(jx.fine, *args, compute_dtype=BF16, **kw)
    f = fr.fused_render_reference(jx.fine, *args, compute_dtype=torch.float32, **kw)
    assert float((b.rgb - f.rgb).abs().max()) > 10 * ATOL_RGB
    assert float((b.weights - f.weights).abs().max()) > ATOL_W
    jb, jf = (_jax_pass(jx, args, dt) for dt in (jx.jnp.bfloat16, jx.jnp.float32))
    assert float(np.abs(np.asarray(jb.rgb) - np.asarray(jf.rgb)).max()) > 10 * ATOL_RGB
    # and the f32 plain version is the JAX kernel's f32 form
    np.testing.assert_allclose(f.rgb.numpy(), np.asarray(jf.rgb), rtol=2e-4, atol=2e-5)


def test_flex_forward_bf16_rounds_only_the_contract_operands():
    """With weights and encodings that are already bf16 values, the rounded
    forward is the f32 model with the inputs of the trunk layers, fc_feat
    and layers_dir.0 rounded to bf16 (forward pre-hooks) and the heads'
    inputs left f32. The two sum the skip and viewdir layers' products in
    another order, which can flip the rounding of single activations
    (2^-8 of the activation), hence the atol."""
    m = FlexibleNeRFModel(**ARCH).reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(fr._bf16(p))
    rng = np.random.default_rng(0)
    xyz = fr._bf16(torch.tensor(rng.normal(size=(4, 5, m.dim_xyz)), dtype=torch.float32))
    view = fr._bf16(torch.tensor(rng.normal(size=(4, m.dim_dir)), dtype=torch.float32))
    with torch.no_grad():
        got = fr.flex_forward_bf16(m, xyz, view)
        f32 = m(xyz, view)
        hooks = [lin.register_forward_pre_hook(lambda mod, args: (fr._bf16(args[0]),))
                 for lin in (*m.layers_xyz, m.fc_feat, m.layers_dir[0])]
        want = m(xyz, view)
        for h in hooks:
            h.remove()
    assert got.shape == want.shape == (4, 5, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-3)
    # the rounding of the hidden activations is what separates it from f32
    assert float((got - f32).abs().max()) > 10 * float((got - want).abs().max())


def _cfg(**nerf):
    flex = {"type": "FlexibleNeRFModel"}
    return CfgNode({"nerf": dict(nerf), "models": {"coarse": flex, "fine": flex}})


@pytest.mark.parametrize(
    "nerf,device,want",
    [
        ({}, "cuda", BF16),
        ({}, "cpu", torch.float32),
        ({"use_fused_render": True}, "cpu", BF16),
        ({"use_fused_render": False}, "cpu", torch.float32),
        ({"pallas_compute_dtype": "float32"}, "cuda", torch.float32),
        ({"pallas_compute_dtype": "float32", "use_fused_render": True}, "cpu", torch.float32),
        ({"pallas_compute_dtype": "bfloat16"}, "cuda", BF16),
    ],
    ids=["default-cuda", "default-cpu", "fused-cpu", "unfused-cpu", "f32-cuda",
         "f32-fused-cpu", "bf16-cuda"],
)
def test_render_compute_dtype(nerf, device, want):
    assert render_compute_dtype(_cfg(**nerf), torch.device(device)) == want


def test_render_compute_dtype_rejects_unknown():
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="pallas_compute_dtype"):
            render_compute_dtype(_cfg(pallas_compute_dtype=bad), torch.device("cuda"))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_render_impl_unfused_returns_none(device):
    """``nerf.use_fused_render: false`` asks for the plain renderer on every
    device, as JAX's ``maybe_fused_render_impl`` returns None for it."""
    from dexnerf_tpu_torch.train.loop import fused_render_impl

    m = FlexibleNeRFModel(**ARCH)
    for nerf in ({"use_fused_render": False},
                 {"use_fused_render": False, "pallas_compute_dtype": "float32"}):
        assert fused_render_impl(_cfg(**nerf), SETTINGS, device, m, m) is None


def test_fused_render_impl_carries_the_dtype(jx):
    from dexnerf_tpu_torch.train.loop import fused_render_impl

    for nerf, want in (({}, torch.float32), ({"use_fused_render": True}, BF16)):
        impl = fused_render_impl(_cfg(**nerf), SETTINGS, "cpu", jx.coarse, jx.fine)
        assert impl.compute_dtype == want


def test_compute_dtype_refused():
    m = FlexibleNeRFModel(**ARCH)
    x = torch.zeros((2, 3))
    z = torch.zeros((2, 4))
    for call in (fr.fused_render, fr.fused_render_reference):
        with pytest.raises(ValueError, match="compute_dtype"):
            call(m, x, x, x, z, z, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        fr.make_fused_render_rays(m, None, SETTINGS, compute_dtype=torch.float64)


# S -> (rays per unit, rows per unit) of the bf16 kernel's work plan
PLAN_UNITS = {1: (16, 64), 8: (16, 128), 64: (2, 128), 100: (1, 128), 128: (1, 128),
              192: (1, 192), 256: (1, 256)}
SMS = 132  # CTAs an H100 holds at once at one per SM


@pytest.mark.parametrize("n_rays", [1, 3, 131, 160_000])
@pytest.mark.parametrize("S", sorted(PLAN_UNITS))
def test_render_plan(S, n_rays):
    """The work plan: every ray in exactly one unit of whole rays, units of
    a multiple of 64 rows (whole tiles), the padding and the grid as the kernel counts
    them, every unit on one worker and no CTA without work."""
    plan = fr.render_plan(n_rays, S, SMS)
    rpu, rows = PLAN_UNITS[S]
    assert (plan.rays_per_unit, plan.rows_per_unit) == (rpu, rows)
    assert rows % 64 == 0 and rpu * S <= rows <= 256
    units = -(-n_rays // rpu)
    assert plan.units == units and plan.rows == units * rows
    assert plan.padded_rows == units * rows - n_rays * S
    assert plan.grid == min(SMS, -(-units // 3))
    rays = [r for u in range(units) for r in range(u * rpu, min(n_rays, (u + 1) * rpu))]
    assert rays == list(range(n_rays))
    workers = fr.plan_workers(plan)
    assert sorted(u for w in workers for u in w) == list(range(units))
    assert all(workers[3 * b] for b in range(plan.grid))  # every CTA has a unit
    counts = [len(w) for w in workers]
    assert max(counts) - min(counts) <= 1
    # the CTA's busiest worker is 3 b: its passes over the weights serve all three
    assert all(counts[3 * b] >= max(counts[3 * b + 1:3 * b + 3]) for b in range(plan.grid))
    with pytest.raises(ValueError, match="samples per ray"):
        fr.render_plan(n_rays, 257, SMS)


def _unswizzle(wq, n, k):
    """The [n, k] matrix of ``n`` x ``k`` packed entries of the bf16 render
    pack: [k/64] K-chunks of [n][64], group j of row r stored at j ^ (r % 8)."""
    g = wq.reshape(k // 64, n, 8, 8)
    j = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)  # where group j lies
    g = g[torch.arange(k // 64)[:, None, None], torch.arange(n)[None, :, None], j[None]]
    return g.transpose(0, 1).reshape(n, k)


def test_pack_flex_weights_bf16_layout(monkeypatch):
    m = FlexibleNeRFModel(**ARCH).reset_parameters(torch.Generator().manual_seed(1))
    wq, aux, off = fr.pack_flex_weights_bf16(m)
    H, dxp = m.hidden_size, 64
    assert wq.dtype == BF16 and aux.dtype == torch.float32
    pos = 0
    for w, k in [(m.layer1.weight, dxp)] + [
        (m.layers_xyz[i].weight[:, :H], H) for i in range(3)] + [
        (m.layers_xyz[3].weight[:, :H], H), (m.layers_xyz[3].weight[:, H:], dxp)] + [
        (m.layers_xyz[i].weight[:, :H], H) for i in range(4, 7)] + [
        (m.fc_feat.weight, H), (m.layers_dir[0].weight[:, :H], H)]:
        n = w.shape[0]
        got = _unswizzle(wq[pos:pos + n * k], n, k)
        want = torch.nn.functional.pad(w.detach(), (0, k - w.shape[1])).to(BF16)
        assert torch.equal(got, want)
        # the swizzle: row 9's first 8 columns lie in its second 16-byte group
        chunk0 = wq[pos:pos + n * 64].reshape(n, 64)
        assert torch.equal(chunk0[9, 8:16], want[9, :8])
        pos += n * k
    assert pos == wq.numel()
    assert torch.equal(aux[off[0]:off[0] + H], m.layer1.bias.detach())
    nt = m.num_layers - 1
    assert torch.equal(aux[off[nt + 3]:off[nt + 3] + H], m.fc_alpha.weight.detach()[0])
    wr = aux[off[nt + 5]:off[nt + 5] + H // 2 * 3].reshape(H // 2, 3)
    assert torch.equal(wr, m.fc_rgb.weight.detach().t())
    wdv = aux[off[nt + 7]:off[nt + 7] + m.dim_dir * H // 2].reshape(m.dim_dir, H // 2)
    assert torch.equal(wdv, fr._bf16(m.layers_dir[0].weight.detach()[:, H:].t()))
    # packed once per parameter state: kernel 4's forward (bf16_args, also
    # kernels 2 and 3's) takes kernel 1's cached pack itself, and a
    # parameter change repacks it for both
    monkeypatch.setattr(ftl, "fwd_ctas", lambda model, device: 132)
    a = fr._cached_bf16_weights(m, "cpu")
    assert fr._cached_bf16_weights(m, "cpu") is a
    args, keep = ftl.bf16_args(_StructSizes(), m, 2, 4, log_sampling_xyz=True,
                               log_sampling_dir=True)
    assert keep[0] is a[0] and keep[1] is a[1]
    assert args.wq == a[0].data_ptr() and args.aux == a[1].data_ptr()
    assert list(args.aux_off[:len(a[2])]) == a[2]
    with torch.no_grad():
        m.fc_feat.weight.add_(1.0)
    b = fr._cached_bf16_weights(m, "cpu")
    assert b is not a and not torch.equal(b[0], a[0])
    assert ftl.bf16_args(_StructSizes(), m, 2, 4, log_sampling_xyz=True,
                         log_sampling_dir=True)[1][0] is b[0]


class _StructSizes:
    """Stands in for the kernel library where ``bf16_args`` only checks the
    argument blocks' sizes (there is no library on the CPU)."""

    @staticmethod
    def dexnerf_train_bf16_size(which, hidden, num_trunk, dd):
        return ctypes.sizeof((ftl._Bf16TrainArgs, ftl._DwArgs, ftl._ChainMaps)[which])


@pytest.mark.parametrize("hidden", [16, 48])
def test_pack_flex_weights_bf16_pads_to_32(hidden):
    """A width that is not a multiple of 32 is packed zero-padded to the
    next one (H/2 to half of it): the padded model, with the packed
    operands unpacked, computes the same rounded forward."""
    m = FlexibleNeRFModel(**dict(ARCH, hidden_size=hidden)).reset_parameters(
        torch.Generator().manual_seed(2))
    Hp = fr.bf16_hidden(hidden)
    wq, aux, off = fr.pack_flex_weights_bf16(m)
    p = FlexibleNeRFModel(**dict(ARCH, hidden_size=Hp))
    dxp, kh = 64, -(-Hp // 64) * 64  # K zero-padded to whole 64-wide chunks
    with torch.no_grad():
        for t in p.parameters():
            t.zero_()
        pos = 0

        def take(n, k, cols):
            nonlocal pos
            w = _unswizzle(wq[pos:pos + n * k], n, k)
            pos += n * k
            assert not w[:, cols:].any()  # the K padding is zero
            return w[:, :cols].float()

        p.layer1.weight.copy_(take(Hp, dxp, m.dim_xyz))
        for i, lin in enumerate(p.layers_xyz):
            lin.weight[:, :Hp] = take(Hp, kh, Hp)
            if i in m.skips:
                lin.weight[:, Hp:] = take(Hp, dxp, m.dim_xyz)
        p.fc_feat.weight.copy_(take(Hp, kh, Hp))
        p.layers_dir[0].weight[:, :Hp] = take(Hp // 2, kh, Hp)
        assert pos == wq.numel()
        nt = m.num_layers - 1
        for i, lin in enumerate([p.layer1, *p.layers_xyz, p.fc_feat]):
            lin.bias.copy_(aux[off[i]:off[i] + Hp])
        p.layers_dir[0].bias.copy_(aux[off[nt + 2]:off[nt + 2] + Hp // 2])
        p.fc_alpha.weight.copy_(aux[off[nt + 3]:off[nt + 3] + Hp][None])
        p.fc_alpha.bias.copy_(aux[off[nt + 4]:off[nt + 4] + 1])
        p.fc_rgb.weight.copy_(aux[off[nt + 5]:off[nt + 5] + Hp // 2 * 3].reshape(Hp // 2, 3).t())
        p.fc_rgb.bias.copy_(aux[off[nt + 6]:off[nt + 6] + 3])
        wdv = aux[off[nt + 7]:off[nt + 7] + m.dim_dir * Hp // 2].reshape(m.dim_dir, Hp // 2)
        p.layers_dir[0].weight[:, Hp:] = wdv.t()
        rng = np.random.default_rng(0)
        xyz = torch.tensor(rng.normal(size=(4, 5, m.dim_xyz)), dtype=torch.float32)
        view = torch.tensor(rng.normal(size=(4, m.dim_dir)), dtype=torch.float32)
        want = fr.flex_forward_bf16(m, xyz, view)
        got = fr.flex_forward_bf16(p, xyz, view)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# ---- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
# kernel vs the bf16 plain version on the card: the same roundings, f32
# sums in another order (tensor-core vs cuBLAS), so only rare bf16 flips
# of single activations separate them (see ATOL_*)
GPU_ATOL = {"rgb": 1e-3, "accumulation": 1e-3, "disparity": None, "weights": 2e-2,
            "depth": 2e-2}
# At 256 samples per ray one such flip moves a ray's accumulation by up to
# 1.6e-3 on the card-test inputs, for the earlier mma.sync kernel as for
# this one (the same 2 rays, to 1e-6); in a model wider than 128 (the wide
# route) by up to 3.1e-3 at 128 samples (2 of 301 rays at 8x256). Those
# rays are held, as chip_smoke.py holds a frame (BF16_*), relative to the
# dtype's own effect: the kernel's distance to the bf16 plain version at
# most the bf16 plain version's to the f32 one ("own"), and its distance to
# the f32 plain version at most 1.5 x own, each + 1e-5.
OWN_REL, OWN_ATOL = 1.5, 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize(
    "arch,S,T,white,n_rays",
    [
        (dict(num_layers=3, hidden_size=32, skip_connect_every=4, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2), 8, 2, True, 301),
        (FULL, 64, 0, False, 301),
        (FULL, 128, 20, False, 301),
        (FULL, 192, 20, True, 301),
        (dict(FULL, hidden_size=96), 100, 5, False, 301),
        (dict(FULL, hidden_size=16), 64, 5, True, 301),
        (dict(FULL, hidden_size=48), 128, 5, False, 301),
        (dict(FULL, hidden_size=32), 64, 5, False, 301),
        (dict(FULL, hidden_size=64), 128, 20, True, 301),
        (dict(FULL, num_encoding_fn_xyz=16), 128, 5, False, 301),
        (FULL, 256, 20, False, 301),  # held relative to own (see OWN_REL)
        (FULL, 128, 20, False, 3),
        (dict(FULL, hidden_size=100), 64, 5, False, 301),
        (dict(FULL, hidden_size=136), 64, 5, True, 301),
        (dict(FULL, hidden_size=256), 128, 20, False, 301),
        (dict(FULL, hidden_size=256), 64, 0, False, 3),
    ],
    ids=["tiny", "full-64", "full-128", "full-192", "h96-100", "h16-64", "h48-128", "h32-64",
         "h64-128", "pe16-128", "full-256", "full-128-3rays", "h100-64", "wide-h136-64",
         "wide-h256-128", "wide-h256-64-3rays"],
)
def test_bf16_kernel_matches_plain_on_card(cuda, arch, S, T, white, n_rays):
    """The kernel vs the bf16 plain version, at widths 16-128 (16, 48, 96
    and 100 zero-padded), PE up to 16 frequencies (a 99-wide encoding, two
    K-chunks), 8-256 samples per ray, and a frame of fewer rays than SMs;
    and the wide route (padded widths above 128: 136 padded to 160, 256),
    whose launches ``launches_wide`` counts."""
    m = FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(0))
    ro, rd, vd, near, far = (torch.tensor(a, device=cuda) for a in _rays(n=n_rays, seed=9))
    m = m.to(cuda)
    z = stratified_z_vals(near, far, S)
    with torch.no_grad():  # σ logit over these samples: mean 0, std 30
        pts = ro[:, None] + rd[:, None] * z[..., None]
        raw = m(positional_encoding(pts, m.num_encoding_fn_xyz),
                positional_encoding(vd, m.num_encoding_fn_dir))[..., 3]
        k = 30.0 / raw.std()
        m.fc_alpha.weight.mul_(k)
        m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
    dists = ray_dists(z, rd)
    thr = tuple(5.0 * (i + 1) for i in range(T))
    kw = dict(thresholds=thr, white_background=white, compute_dtype=BF16)
    before, before_bf16, before_wide = fr.launches, fr.launches_bf16, fr.launches_wide
    with torch.inference_mode():
        got = fr.fused_render(m, ro, rd, vd, z, dists, **kw)
        again = fr.fused_render(m, ro, rd, vd, z, dists, **kw)
        want = fr.fused_render_reference(m, ro, rd, vd, z, dists, **kw)
    torch.cuda.synchronize()
    assert fr.launches == before + 2 and fr.launches_bf16 == before_bf16 + 2
    assert fr.launches_wide == before_wide + 2 * int(m.hidden_size > 128)
    own_rule = S == 256 or m.hidden_size > 128  # see OWN_REL
    if own_rule:
        with torch.inference_mode():
            f32 = fr.fused_render_reference(m, ro, rd, vd, z, dists,
                                            **dict(kw, compute_dtype=torch.float32))
    for f, atol in GPU_ATOL.items():
        a, b = getattr(got, f), getattr(want, f)
        assert bool(torch.isfinite(a).all()), f
        assert torch.equal(a, getattr(again, f)), f  # deterministic
        if own_rule and atol is not None:
            own = float((b - getattr(f32, f)).abs().max())
            assert float((a - b).abs().max()) <= own + OWN_ATOL, f
            assert float((a - getattr(f32, f)).abs().max()) <= OWN_REL * own + OWN_ATOL, f
        elif atol is None:  # 1 / (depth / acc): relative
            torch.testing.assert_close(a, b, rtol=2e-2, atol=1e-5)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=atol)
    if T:
        assert float((got.depth_dex == want.depth_dex).float().mean()) >= 0.999
    else:
        assert got.depth_dex is None


@pytest.mark.gpu
def test_bf16_kernel_refusals_on_card(cuda):
    m = FlexibleNeRFModel(**dict(FULL, hidden_size=136)).to(cuda)
    ro, rd, vd, near, far = (torch.tensor(a, device=cuda) for a in _rays(n=16))
    z = stratified_z_vals(near, far, 64)
    dists = ray_dists(z, rd)
    before, before_all = fr.launches_bf16, fr.launches
    # the f32 route takes widths up to MAX_HIDDEN, the bf16 route up to
    # MAX_HIDDEN_BF16 (wider: ROADMAP Queue 2 item 6c)
    wide = FlexibleNeRFModel(**dict(FULL, hidden_size=fr.MAX_HIDDEN + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        fr.fused_render(wide, ro, rd, vd, z, dists, compute_dtype=torch.float32)
    too_wide = FlexibleNeRFModel(**dict(FULL, hidden_size=fr.MAX_HIDDEN_BF16 + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        fr.fused_render(too_wide, ro, rd, vd, z, dists, compute_dtype=BF16)
    assert fr.launches == before_all
    m = FlexibleNeRFModel(**FULL).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_render(m, ro, rd, vd, z.t().contiguous().t(), dists, compute_dtype=BF16)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render(m, ro.double(), rd, vd, z, dists, compute_dtype=BF16)
    with pytest.raises(ValueError, match="samples per ray"):
        zz = stratified_z_vals(near, far, 300)
        fr.fused_render(m, ro, rd, vd, zz, ray_dists(zz, rd), compute_dtype=BF16)
    assert fr.launches_bf16 == before
    # persistent: one CTA per SM at the full width, coarse and fine, within
    # the block's shared-memory limit, and at most one per SM in the plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for S in (64, 128):
        ctas, smem, stages = fr.bf16_occupancy(m, S)
        assert ctas == 1 and smem <= fr.SHARED_BYTES_LIMIT and stages >= 4, (S, ctas, smem)
        assert fr.render_plan(160_000, S, sms * ctas).grid == sms
