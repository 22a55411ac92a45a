"""The fused train-loss pass at ``compute_dtype = dw_dtype = bfloat16``
(``dexnerf_tpu_torch/ops/fused_train_loss.py``) and the dtype the port's
training resolves (``train/loop.py::train_compute_dtype``).

On the CPU: the bf16 plain version (``flex_forward_train`` under
``fused_pass_loss_reference``) and both passes of ``make_fused_train_loss``
at bf16, held to the JAX kernel at bf16 in interpret mode on one set of
weights, rays and draws; bf16 differs from f32 on both sides; plain
autograd through the rounded forward does not give the contract's weight
gradients; the dtype resolution; the bf16 packing. On a CUDA card (marker
``gpu``): the bf16 tensor-core kernel held to the bf16 plain version, its
repeatability, its launch counter and its refusals. The JAX package is
imported inside a fixture, so that this file also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_train_loss_bf16.py
"""

import copy
import ctypes
import itertools

import numpy as np
import pytest
import torch
from test_torch_train_loss import (  # the same weights, rays and draws as the f32 tests
    ARCH,
    ENC_DIR,
    ENC_XYZ,
    GRAD_ATOL,
    LOSS_RTOL,
    N_RAYS,
    _assert_grads,
    _grads_by_name,
    _jax_draws,
    _pass_inputs,
    jx,  # noqa: F401 (the module fixture)
)

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.volrend import composite
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderSettings
from dexnerf_tpu_torch.train.loop import maybe_fused_loss, train_compute_dtype

BF16, F32 = torch.bfloat16, torch.float32
# Port vs JAX, both at bf16: the same operands rounded on both sides, only
# the f32 summation order differs, and that order can flip the bf16
# rounding of single activations or cotangents. So each field and leaf is
# held relative to the dtype's own effect: its error against the JAX bf16
# kernel is at most OWN_SHARE of the f32 plain version's distance to it.
OWN_SHARE = 0.25


def _jax_pass(jx, inputs, dtype, *, supervision, depth):
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    jnp = jx.jnp
    fn = make_fused_pass_loss(jx.jm, block_samples=128, supervision=supervision,
                              compute_dtype=dtype, dw_dtype=dtype, interpret=True)
    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    extra = (a["depth_gt"], a["depth_coef"]) if depth else ()

    def f(params):
        loss, w, rgb = fn(params, a["origins"], a["directions"], a["z_vals"], a["viewdirs"],
                          a["dists"], a["noise"], a["target"], *extra)
        return loss, (w, rgb)

    (loss, (w, rgb)), g = jx.jax.value_and_grad(f, has_aux=True)(jx.trees["fine"])
    return {"loss": float(loss), "weights": np.asarray(w), "rgb": np.asarray(rgb),
            **_grads_by_name(jx, g)}


def _port_pass(model, inputs, dtype, *, supervision, depth, dw_dtype="same"):
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    loss, w, rgb, grads = ftl.fused_pass_loss_reference(
        model, t["origins"], t["directions"], t["z_vals"], t["viewdirs"], t["dists"],
        t["noise"], t["target"], *((t["depth_gt"], t["depth_coef"]) if depth else ()),
        supervision=supervision, compute_dtype=dtype,
        dw_dtype=dtype if dw_dtype == "same" else dw_dtype,
    )
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(loss), "weights": w.numpy(), "rgb": rgb.numpy(),
            **dict(zip(names, (g.numpy() for g in grads)))}


def _errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v).all(), k
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want}


def _assert_within_own(got: dict, f32: dict, want: dict):
    """Every field and leaf of ``got`` within OWN_SHARE of the f32 plain
    version's distance to ``want`` (see OWN_SHARE)."""
    err, own = _errors(got, want), _errors(f32, want)
    bad = {k: (err[k], own[k]) for k in want if not err[k] <= OWN_SHARE * own[k]}
    assert not bad, bad


@pytest.mark.parametrize("depth", [False, True], ids=["photo", "depth"])
@pytest.mark.parametrize("supervision", ["rgb", "luminance"])
def test_bf16_reference_pass_matches_jax_kernel(jx, supervision, depth):
    """One pass of the bf16 plain version vs the JAX kernel at
    compute_dtype = dw_dtype = bfloat16 (interpret mode): loss, weights,
    rgb and every gradient leaf."""
    inputs = _pass_inputs()
    kw = dict(supervision=supervision, depth=depth)
    want = _jax_pass(jx, inputs, jx.jnp.bfloat16, **kw)
    got = _port_pass(jx.models["fine"], inputs, BF16, **kw)
    f32 = _port_pass(jx.models["fine"], inputs, F32, **kw)
    _assert_within_own(got, f32, want)


def test_bf16_differs_from_f32(jx):
    """The dtype is really applied: bf16 and f32 differ, in every gradient
    leaf, by more than the tolerance above, on both sides."""
    inputs = _pass_inputs()
    kw = dict(supervision="rgb", depth=False)
    jb, jf = (_jax_pass(jx, inputs, dt, **kw) for dt in (jx.jnp.bfloat16, jx.jnp.float32))
    pb, pf = (_port_pass(jx.models["fine"], inputs, dt, **kw) for dt in (BF16, F32))
    own_port, own_jax = _errors(pb, pf), _errors(jb, jf)
    err = _errors(pb, jb)
    for k in jb:
        assert own_port[k] > 0 and own_jax[k] > 0, k
        if k != "loss":
            assert own_jax[k] > err[k] / OWN_SHARE, (k, own_jax[k], err[k])
    # and the f32 plain version is the JAX kernel's f32 form
    f_err = _errors(pf, jf)
    assert all(f_err[k] <= 1e-4 * max(1.0, float(np.abs(jf[k]).max())) for k in jf), f_err


def test_plain_autograd_through_rounded_forward_misses_dw(jx):
    """Autograd through ``flex_forward_bf16`` (``.to(bf16)`` in the graph)
    rounds the products of the cotangent chain and the weight gradients
    themselves, where JAX rounds the cotangent operands: its dW leaves miss
    the tolerance above. This pins why the plain version writes the
    rounded linear by hand."""
    inputs = _pass_inputs()
    model = jx.models["fine"]
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    params = list(model.parameters())
    with torch.enable_grad():
        pts = t["origins"][:, None] + t["directions"][:, None] * t["z_vals"][..., None]
        raw = fr.flex_forward_bf16(model, positional_encoding(pts, ENC_XYZ),
                                   positional_encoding(t["viewdirs"], ENC_DIR))
        out = composite(raw, t["z_vals"], t["dists"], sigma_noise=t["noise"])
        grads = torch.autograd.grad(torch.sum((out.rgb - t["target"]) ** 2), params)
    names = [n for n, _ in model.named_parameters()]
    naive = dict(zip(names, (g.numpy() for g in grads)))
    kw = dict(supervision="rgb", depth=False)
    want = _jax_pass(jx, inputs, jx.jnp.bfloat16, **kw)
    f32 = _port_pass(model, inputs, F32, **kw)
    err, own = _errors(naive, {k: want[k] for k in names}), _errors(f32, want)
    missed = [k for k in names if k.endswith("weight") and err[k] > OWN_SHARE * own[k]]
    assert missed, (err, own)


def test_mixed_dtype_pairs_on_cpu(jx):
    """The plain version takes every pair: each mixed pair differs from
    both pure ones."""
    inputs = _pass_inputs()
    kw = dict(supervision="rgb", depth=False)
    model = jx.models["fine"]
    runs = {(cd, dw): _port_pass(model, inputs, cd, dw_dtype=dw, **kw)
            for cd in (F32, BF16) for dw in (F32, BF16)}
    key = "layers_xyz.2.weight"
    for pair in ((F32, BF16), (BF16, F32)):
        for other in ((F32, F32), (BF16, BF16)):
            assert not np.array_equal(runs[pair][key], runs[other][key]), (pair, other)
    # dw_dtype=None is float32, as in JAX
    none = _port_pass(model, inputs, BF16, dw_dtype=None, **kw)
    assert np.array_equal(none[key], runs[(BF16, F32)][key])
    with pytest.raises(ValueError, match="dw_dtype"):
        _port_pass(model, inputs, BF16, dw_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        _port_pass(model, inputs, torch.float64, **kw)


def test_train_loss_both_passes_match_jax(jx):
    """make_fused_train_loss at bf16 (coarse, resample, fine) vs JAX's at
    bf16 in interpret mode on draws from one key: the loss terms and every
    leaf of both models within OWN_SHARE of the f32 port's distance."""
    from dexnerf_tpu.ops import make_fused_train_loss as j_make
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings

    settings = RenderSettings(
        num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
        num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
    )
    inp = _pass_inputs(seed=6)
    near = np.full((N_RAYS,), 2.0, np.float32)
    arrays = (inp["origins"], inp["directions"], inp["viewdirs"], near, near + 4.0)
    key = jx.jax.random.PRNGKey(7)
    draws = _jax_draws(jx, key, N_RAYS, settings)
    j_fn = j_make(jx.jm, jx.jm, JSettings(**settings.__dict__), block_samples=128,
                  compute_dtype=jx.jnp.bfloat16, dw_dtype=jx.jnp.bfloat16, interpret=True)
    jrays = JRayBatch(*(jx.jnp.asarray(a) for a in arrays))
    (_, j_metrics), j_grads = jx.jax.value_and_grad(j_fn, has_aux=True)(
        jx.trees, jrays, jx.jnp.asarray(inp["target"]), key)

    def port(dtype):
        coarse, fine = (copy.deepcopy(jx.models[n]) for n in ("coarse", "fine"))
        fn = ftl.make_fused_train_loss(coarse, fine, settings, compute_dtype=dtype,
                                       dw_dtype=dtype)
        assert fn.compute_dtype == dtype
        loss, metrics = fn(RayBatch(*(torch.tensor(a) for a in arrays)),
                           torch.tensor(inp["target"]), draws)
        loss.backward()
        out = {k: float(metrics[k]) for k in ("coarse_loss", "fine_loss")}
        for name, m in (("coarse", coarse), ("fine", fine)):
            out.update({f"{name}.{n}": p.grad.numpy() for n, p in m.named_parameters()})
        return out

    want = {k: float(j_metrics[k]) for k in ("coarse_loss", "fine_loss")}
    for name in ("coarse", "fine"):
        want.update({f"{name}.{k}": v for k, v in _grads_by_name(jx, j_grads[name]).items()})
    _assert_within_own(port(BF16), port(F32), want)


@pytest.mark.parametrize("vmax", [None, 4.0], ids=["depth", "depth-vmax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_depth_matches_jax(jx, dtype, vmax):
    """make_fused_train_loss with the depth term on the fine pass, over
    ``0 < gt`` (``depth``) or ``0 < gt < depth_valid_max`` (``depth-vmax``;
    the GT spans 2.5-5.5, so 4.0 masks half the rays), against JAX's at the
    same dtype in interpret mode: at float32 the loss terms to LOSS_RTOL
    and every leaf to GRAD_ATOL of its scale (the f32 file's rule); at
    bfloat16 every term and leaf within OWN_SHARE of the f32 port's
    distance to JAX's bf16."""
    from dexnerf_tpu.ops import make_fused_train_loss as j_make
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings

    settings = RenderSettings(
        num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
        num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
    )
    inp = _pass_inputs(seed=6)
    near = np.full((N_RAYS,), 2.0, np.float32)
    arrays = (inp["origins"], inp["directions"], inp["viewdirs"], near, near + 4.0)
    key = jx.jax.random.PRNGKey(7)
    draws = _jax_draws(jx, key, N_RAYS, settings)
    keys = ("loss", "coarse_loss", "fine_loss", "depth_loss")
    jdt = getattr(jx.jnp, dtype)
    j_fn = j_make(jx.jm, jx.jm, JSettings(**settings.__dict__), block_samples=128,
                  compute_dtype=jdt, dw_dtype=jdt, interpret=True, depth_loss_weight=0.5,
                  depth_valid_max=vmax)
    jrays = JRayBatch(*(jx.jnp.asarray(a) for a in arrays))
    (_, j_metrics), j_grads = jx.jax.value_and_grad(
        lambda p: j_fn(p, jrays, jx.jnp.asarray(inp["target"]), key,
                       jx.jnp.asarray(inp["depth_gt"])), has_aux=True)(jx.trees)

    def port(dt):
        coarse, fine = (copy.deepcopy(jx.models[n]) for n in ("coarse", "fine"))
        fn = ftl.make_fused_train_loss(coarse, fine, settings, compute_dtype=dt, dw_dtype=dt,
                                       depth_loss_weight=0.5, depth_valid_max=vmax)
        loss, metrics = fn(RayBatch(*(torch.tensor(a) for a in arrays)),
                           torch.tensor(inp["target"]), draws, torch.tensor(inp["depth_gt"]))
        loss.backward()
        out = {k: float(metrics[k]) for k in keys}
        for name, m in (("coarse", coarse), ("fine", fine)):
            out.update({f"{name}.{n}": p.grad.numpy() for n, p in m.named_parameters()})
        return out

    want = {k: float(j_metrics[k]) for k in keys}
    for name in ("coarse", "fine"):
        want.update({f"{name}.{k}": v for k, v in _grads_by_name(jx, j_grads[name]).items()})
    assert want["depth_loss"] > 0
    if dtype == "bfloat16":
        _assert_within_own(port(BF16), port(F32), want)
        return
    got = port(F32)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    _assert_grads({k: v for k, v in got.items() if k not in keys},
                  {k: v for k, v in want.items() if k not in keys}, atol=GRAD_ATOL)


def _cfg(**nerf):
    flex = {"type": "FlexibleNeRFModel"}
    return CfgNode({"nerf": dict(nerf), "models": {"coarse": flex, "fine": flex}})


@pytest.mark.parametrize(
    "nerf,want",
    [
        ({}, BF16),
        ({"pallas_compute_dtype": "bfloat16"}, BF16),
        ({"pallas_compute_dtype": "float32"}, F32),
        ({"use_fused_render": False}, BF16),
    ],
    ids=["default", "bf16", "f32", "unfused-render"],
)
def test_train_compute_dtype(nerf, want):
    """Kernel 4's dtype is the key's on every device (JAX runs its kernel
    at it, in interpret mode on the CPU), whatever the render flags."""
    assert train_compute_dtype(_cfg(**nerf)) == want
    settings = RenderSettings(num_coarse=8, num_fine=8)
    cfg = _cfg(use_pallas=True, **nerf)
    models = [FlexibleNeRFModel(**ARCH) for _ in range(2)]
    assert maybe_fused_loss(cfg, settings, "rgb", *models).compute_dtype == want


def test_train_compute_dtype_rejects_unknown():
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="pallas_compute_dtype"):
            train_compute_dtype(_cfg(pallas_compute_dtype=bad))


@pytest.mark.parametrize("hidden", [16, 48, 64])
def test_pack_backward_weights_bf16_layout(hidden):
    m = FlexibleNeRFModel(**dict(ARCH, hidden_size=hidden)).reset_parameters(
        torch.Generator().manual_seed(1))
    wbq = ftl.pack_backward_weights_bf16(m)
    H, Hp = hidden, fr.bf16_hidden(hidden)
    kp2, kp = -(-Hp // 2 // 64) * 64, -(-Hp // 64) * 64
    assert wbq.dtype == BF16 and Hp % 32 == 0
    mats = [(m.layers_dir[0].weight[:, :H].t(), kp2), (m.fc_feat.weight.t(), kp)] + [
        (lin.weight[:, :H].t(), kp) for lin in reversed(m.layers_xyz)]
    pos = 0
    for w, k in mats:
        got = wbq[pos:pos + Hp * k].reshape(k // 64, Hp, 64).transpose(0, 1).reshape(Hp, k)
        want = torch.zeros((Hp, k), dtype=BF16)
        want[:w.shape[0], :w.shape[1]] = w.detach().to(BF16)
        assert torch.equal(got, want)
        pos += Hp * k
    assert pos == wbq.numel()


@pytest.mark.parametrize("hidden", [16, 128])
def test_aux_map_covers_biases_and_viewdir_rows(hidden):
    """The chain CTAs' slots hold every bias and the viewdir rows of
    ``layers_dir.0``, each entry once; the dW slots hold the rest."""
    m = FlexibleNeRFModel(**dict(ARCH, hidden_size=hidden))
    bmap, n_aux = ftl._aux_map(m, "cpu")
    offs, n = ftl._param_offsets(m)
    assert bmap.shape == (n,)
    from_chain = bmap >= 0
    want = torch.zeros(n, dtype=torch.bool)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            want[offs[name]:offs[name] + p.numel()] = True
    H = hidden
    wd = torch.zeros_like(m.layers_dir[0].weight, dtype=torch.bool)
    wd[:, H:] = True
    o = offs["layers_dir.0.weight"]
    want[o:o + wd.numel()] = wd.reshape(-1)
    assert torch.equal(from_chain, want)
    idx = bmap[from_chain]
    assert int(idx.max()) < n_aux and idx.unique().numel() == idx.numel()


def test_bf16_kernel_dtype_checks_on_cpu():
    """A CPU tensor runs the plain version whatever the pair; an unknown
    dtype raises before any work."""
    m = FlexibleNeRFModel(**ARCH)
    t = {k: torch.tensor(v) for k, v in _pass_inputs(n=4, s=4).items()}
    args = (m, t["origins"], t["directions"], t["z_vals"], t["viewdirs"], t["dists"], None,
            t["target"])
    launches = (ftl.launches, ftl.launches_bf16)
    loss, _, _ = ftl.fused_pass_loss(*args, compute_dtype=BF16, dw_dtype=F32)
    assert bool(torch.isfinite(loss))
    assert (ftl.launches, ftl.launches_bf16) == launches
    with pytest.raises(ValueError, match="compute_dtype"):
        ftl.fused_pass_loss(*args, compute_dtype=torch.float16)


# ---- on the card: the bf16 kernel vs its plain version

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
# kernel vs the bf16 plain version on the card, each field and leaf held to
# the dtype's own effect (own = |bf16 plain - f32 plain|): max <= own, the
# 99.9th percentile <= 0.25 own, and the kernel's distance to the f32 plain
# version <= 1.5 own, each + 1e-5 of the field's or leaf's largest entry
# (perf_tools/bf16_exact_rule.py, which also gives the rule for a case where
# the exact contract itself misses this one)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, arch, s, n=300, seed=9):
    m = FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed)).to(cuda)
    with torch.no_grad():  # σ logit spread: saturated and transparent samples both occur
        m.fc_alpha.weight.mul_(30.0)
    inp = {k: torch.tensor(v, device=cuda) for k, v in _pass_inputs(n, s, seed).items()}
    return m, inp


def _fields(model, out):
    loss, w, rgb = out[:3]
    names = [n for n, _ in model.named_parameters()]
    return {"loss": loss.reshape(1), "weights": w, "rgb": rgb, **dict(zip(names, out[3]))}


def _assert_bf16_on_card(model, args, kw, kernel_out):
    """The kernel's fields and leaves by the rule above
    (``perf_tools/bf16_exact_rule.py::hold_case``); a miss names the leaves
    where the exact contract (float64 sums of the bf16 products) misses the
    rule too, where no correct kernel meets it (ROADMAP Queue 3, fault 9)."""
    from perf_tools.bf16_exact_rule import exact_linear, hold_case, on_linear

    got = _fields(model, kernel_out)
    bf = dict(kw, compute_dtype=BF16, dw_dtype=BF16)
    bp = _fields(model, ftl.fused_pass_loss_reference(model, *args, **bf))
    fp = _fields(model, ftl.fused_pass_loss_reference(model, *args, **kw))
    with on_linear(exact_linear()):
        xp = _fields(model, ftl.fused_pass_loss_reference(model, *args, **bf))
    for k, a in got.items():
        assert bool(torch.isfinite(a).all()), k
    bad, exact_misses = hold_case(got, bp, fp, xp)
    assert not bad, (bad, {"the exact contract misses too": exact_misses})


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [False, True], ids=["photo", "depth"])
@pytest.mark.parametrize("supervision", ["rgb", "luminance"])
@pytest.mark.parametrize(
    "arch,s,n",
    [(FULL, 64, 300), (FULL, 128, 300), (dict(FULL, hidden_size=16), 64, 300),
     (dict(FULL, hidden_size=48), 128, 300), (ARCH, 8, 300), (dict(FULL, hidden_size=32), 64, 300),
     (dict(FULL, hidden_size=64), 128, 300), (dict(FULL, hidden_size=96), 64, 300),
     (dict(FULL, num_encoding_fn_xyz=16), 64, 300), (dict(FULL, num_encoding_fn_dir=10), 64, 300),
     (dict(FULL, num_encoding_fn_xyz=16), 100, 300), (FULL, 256, 300), (FULL, 8, 3),
     (FULL, 7, 301), (dict(FULL, hidden_size=100), 64, 300),
     (dict(FULL, hidden_size=136), 64, 300), (dict(FULL, hidden_size=256), 128, 300),
     (dict(FULL, hidden_size=256), 7, 301), (dict(FULL, hidden_size=320), 64, 300),
     (dict(FULL, hidden_size=320), 128, 300), (dict(FULL, hidden_size=576), 64, 300),
     (dict(FULL, hidden_size=576), 128, 300), (dict(FULL, hidden_size=576), 7, 301)],
    ids=["8x128-64", "8x128-128", "h16-64", "h48-128", "8x16-8", "h32-64", "h64-128", "h96-64",
         "pe16-64", "dir10-64", "pe16-100", "8x128-256", "3rays-8", "rows-not-64", "h100-64",
         "wide-h136-64", "wide-h256-128", "wide-h256-rows-not-64", "wide-h320-64",
         "wide-h320-128", "wide-h576-64", "wide-h576-128", "wide-h576-rows-not-64"],
)
def test_bf16_kernel_matches_plain_on_card(cuda, arch, s, n, supervision, depth):
    """Kernel 4's bf16 route against its bf16 plain version: widths 16-128
    (100 zero-padded to 128), PE 16 (two encoding K-chunks), S = 8-256, a
    launch of fewer 64-row tiles than the forward has workers (3 rays x 8
    samples) and one whose rows are not a multiple of 64 (301 x 7); and the
    wide route (136 padded to 160, 256, 320 and MAX_HIDDEN_BF16 576, one
    consumer), counted by ``launches_wide``. Most 320 and 576 cases miss
    the p99.9 clause, and some at 576 the max clauses, with the parent's
    kernels as with these (ROADMAP Queue 3, fault 9, open:
    ``perf_tools/wide_bf16_rule_witness.py`` holds other versions of the
    same contract to the same rule)."""
    m, inp = _card_case(cuda, arch, s, n=n)
    kw = dict(white_background=supervision == "luminance", supervision=supervision)
    args = (inp["origins"], inp["directions"], inp["z_vals"], inp["viewdirs"], inp["dists"],
            inp["noise"], inp["target"],
            *((inp["depth_gt"], inp["depth_coef"]) if depth else ()))
    before = (ftl.launches, ftl.launches_bf16, ftl.launches_wide)
    loss, w, rgb = ftl.fused_pass_loss(m, *args, **kw, compute_dtype=BF16, dw_dtype=BF16)
    loss.backward()
    torch.cuda.synchronize()
    assert (ftl.launches, ftl.launches_bf16, ftl.launches_wide) == (
        before[0] + 1, before[1] + 1, before[2] + int(m.hidden_size > 128))
    grads = [p.grad.clone() for p in m.parameters()]
    _assert_bf16_on_card(m, args, kw, (loss.detach(), w, rgb, grads))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [FULL, dict(FULL, hidden_size=256)], ids=["8x128", "wide-h256"])
def test_bf16_kernel_chunks_and_repeats_on_card(cuda, monkeypatch, arch):
    """Several scratch chunks (the last one short, S not a multiple of the
    128-sample tile) agree with one chunk; two runs are bitwise equal; on
    the narrow route and on the wide one (whose chunked launch misses the
    p99.9 clause on seed 9's layers_dir.0.bias, ROADMAP Queue 3, fault 9)."""
    m, inp = _card_case(cuda, arch, 100, n=301)
    args = (inp["origins"], inp["directions"], inp["z_vals"], inp["viewdirs"], inp["dists"],
            inp["noise"], inp["target"], None, None)
    kw = dict(white_background=False, supervision="rgb", log_sampling_xyz=True,
              log_sampling_dir=True)
    one = ftl._launch_bf16(m, *args, **kw)
    again = ftl._launch_bf16(m, *args, **kw)
    monkeypatch.setattr(ftl, "SCRATCH_SAMPLES", 100 * 40)
    chunked = ftl._launch_bf16(m, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(one[3], again[3]):
        assert torch.equal(a, b)
    assert torch.equal(one[0], again[0]) and torch.equal(one[1], again[1])
    torch.testing.assert_close(chunked[1], one[1], rtol=0, atol=0)
    plain_kw = dict(white_background=False, supervision="rgb")
    _assert_bf16_on_card(m, args[:7], plain_kw, one)
    _assert_bf16_on_card(m, args[:7], plain_kw, chunked)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,s,n", [(320, 64, 300), (576, 7, 301)], ids=["h320", "h576"])
def test_wide_promoted_sums_repeat_bitwise_on_card(cuda, hidden, s, n):
    """The wide product's fresh tensor-core accumulators, each added to its
    block's f32 sum in a fixed span order (``ops/csrc/mlp_wide_bf16.cuh``:
    ``wide_product``, ``wide_blocks64``): two launches of kernel 4 give the
    same loss, weights, rgb and gradient leaves bit for bit, and two of
    kernel 2's forward the same raw, at 320 (two consumer warpgroups) and
    576 (one)."""
    from dexnerf_tpu_torch.ops import fused_mlp

    m, inp = _card_case(cuda, dict(FULL, hidden_size=hidden), s, n=n)
    args = (inp["origins"], inp["directions"], inp["z_vals"], inp["viewdirs"], inp["dists"],
            inp["noise"], inp["target"], None, None)
    kw = dict(white_background=False, supervision="rgb", log_sampling_xyz=True,
              log_sampling_dir=True)
    one = ftl._launch_bf16(m, *args, **kw)
    again = ftl._launch_bf16(m, *args, **kw)
    pts = (inp["origins"][:, None] + inp["directions"][:, None] * inp["z_vals"][..., None])
    raw = [fused_mlp.fused_field(m, pts.contiguous(), inp["viewdirs"], compute_dtype=BF16)
           for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip([*one[:3], *one[3]], [*again[:3], *again[3]]):
        assert torch.equal(a, b)
    assert torch.equal(raw[0], raw[1]) and bool(torch.isfinite(raw[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("entry,width", [("dexnerf_train_bf16_tensor_map", 64),
                                         ("dexnerf_dw_tf32_tensor_map", 32)],
                         ids=["bf16", "tf32"])
def test_dw_tensor_map_on_a_fresh_thread_on_card(cuda, entry, width):
    """The dW's scratch tensor maps (both routes) are encoded on a thread
    that has made no CUDA call yet, as autograd's device thread is when
    kernel 3's backward comes first on it and its scratch comes from the
    allocator's cache (ROADMAP Queue 3, fault 10: CUDA_ERROR_INVALID_CONTEXT
    before the encoder set the thread's device)."""
    import threading

    from dexnerf_tpu_torch.ops._build import load_library

    lib = load_library()
    dtype = BF16 if entry.startswith("dexnerf_train") else F32
    block = torch.zeros(128 * width, dtype=dtype, device=cuda)
    out = (ctypes.c_uint8 * 128)()
    rc = []
    t = threading.Thread(target=lambda: rc.append(getattr(lib, entry)(
        ctypes.addressof(out), block.data_ptr(), width, 128, 64)))
    t.start()
    t.join()
    assert rc == [0]


@pytest.mark.gpu
def test_bf16_kernel_refusals_on_card(cuda):
    m, inp = _card_case(cuda, FULL, 64, n=16)
    args = (inp["origins"], inp["directions"], inp["z_vals"], inp["viewdirs"], inp["dists"],
            None, inp["target"])
    before = (ftl.launches, ftl.launches_bf16)
    with pytest.raises(ValueError, match="dw_dtype"):
        ftl.fused_pass_loss(m, *args, compute_dtype=BF16, dw_dtype=F32)
    with pytest.raises(ValueError, match="dw_dtype"):
        ftl.fused_pass_loss(m, *args, compute_dtype=F32, dw_dtype=BF16)
    # the f32 route takes widths up to MAX_HIDDEN, the bf16 route up to
    # MAX_HIDDEN_BF16 (wider: ROADMAP Queue 2 item 6c)
    wide = FlexibleNeRFModel(**dict(FULL, hidden_size=fr.MAX_HIDDEN + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        ftl.fused_pass_loss(wide, *args, compute_dtype=F32, dw_dtype=F32)
    too_wide = FlexibleNeRFModel(**dict(FULL, hidden_size=fr.MAX_HIDDEN_BF16 + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        ftl.fused_pass_loss(too_wide, *args, compute_dtype=BF16, dw_dtype=BF16)
    with pytest.raises(ValueError, match="float32"):
        ftl.fused_pass_loss(m, inp["origins"].double(), *args[1:], compute_dtype=BF16,
                            dw_dtype=BF16)
    assert (ftl.launches, ftl.launches_bf16) == before
    # the forward: one persistent CTA per SM, two staging tiles per consumer
    # where it saves the activations (none for kernel 2), and a ring of at
    # least the skip layer's three chunks (more without the staging tiles)
    occ = ftl.bf16_occupancy(m)
    fwd, field = occ["forward"], occ["field_forward"]
    assert fwd[0] == 1 and fwd[2] >= 3 and fwd[3] == 2, occ
    assert field[0] == 1 and field[2] >= fwd[2] and field[3] == 0, occ
    assert occ["chain"][0] >= 1 and occ["dw"][0] == 1, occ


def _dw_on_card(ds, ns, a, m):
    """The weight-gradient kernel and its reduction on one unit: each
    cotangent block ``ds[i]`` [K, w_i] (its first ``ns[i]`` columns) against
    the activations ``a`` [K, w] (its first ``m``), as [ns[i], m] f32."""
    from dexnerf_tpu_torch.ops._build import check, load_library

    lib = load_library()
    K, dev = a.shape[0], a.device
    offs = list(itertools.accumulate([0] + [n * m for n in ns]))
    unit = ftl.dw_unit([d.shape[1] for d in ds] + [a.shape[1]],
                       [(i, len(ds), offs[i], m, n, m) for i, n in enumerate(ns)])
    args, _ = ftl.dw_template([unit], torch.cuda.get_device_properties(dev).multi_processor_count)
    for i, t in enumerate(ds + [a]):
        check(lib, lib.dexnerf_train_bf16_tensor_map(ctypes.addressof(args) + 128 * i,
                                                     t.data_ptr(), t.shape[1], K, 64),
              "tensor map")
    partial = torch.empty(args.max_pieces * offs[-1], device=dev)
    args.partial, args.n_params = partial.data_ptr(), offs[-1]
    n_st = -(-K // 64)  # rows past K are zeros (the tensor map's bounds)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib, lib.dexnerf_train_bf16_dw(ctypes.addressof(args), n_st, 0, stream), "dW launch")
    unit_of = torch.full((offs[-1],), -1, dtype=torch.int32, device=dev)
    grad = torch.empty(offs[-1], device=dev)
    check(lib, lib.dexnerf_train_bf16_reduce(ctypes.addressof(args), 1, 1, n_st, n_st, None, 0,
                                             1, unit_of.data_ptr(), grad.data_ptr(), None, 0,
                                             None, stream), "reduce")
    torch.cuda.synchronize()
    return [grad[offs[i]:offs[i + 1]].view(n, m) for i, n in enumerate(ns)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 127, 128, 4097, 262144])
@pytest.mark.parametrize("m", [63, 64, 128])
@pytest.mark.parametrize("n", [1, 3, 64, 128, 256], ids=["n1", "n3", "n64", "n128", "stacked256"])
def test_bf16_dw_kernel_matches_matmul_on_card(cuda, n, m, k):
    """The TMA + wgmma weight-gradient kernel against ``torch.matmul`` of
    the same bf16 operands in f32 (the products are exact in f32; only the
    summation order differs, so to 1e-5 of the largest entry), N = 256 as
    two stacked cotangent blocks over one activation block; two runs are
    bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(n * 1000 + m + k)

    def rnd(cols):
        return torch.randn((k, cols), generator=gen, device=cuda).to(BF16)

    ns = [128, 128] if n == 256 else [n]
    ds = [rnd(max(8, -(-c // 8) * 8)) for c in ns]
    a = rnd(-(-m // 8) * 8)
    got = _dw_on_card(ds, ns, a, m)
    again = _dw_on_card(ds, ns, a, m)
    for d, c, g, g2 in zip(ds, ns, got, again):
        want = torch.matmul(d[:, :c].t().float(), a[:, :m].float())
        assert bool(torch.isfinite(g).all())
        err = float((g - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (err, float(want.abs().max()))
        assert torch.equal(g, g2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [FULL, dict(FULL, hidden_size=16), dict(FULL, hidden_size=256)],
                         ids=["8x128", "h16", "wide-h256"])
@pytest.mark.parametrize("n_st,grid", [(8192, 132), (4096, 132), (9, 132), (7, 5), (3, 7),
                                       (2, 3), (100, 1)])
def test_bf16_dw_span_matches_plan_on_card(cuda, arch, n_st, grid):
    """The kernel's work split (``dw_span``, ``dw_pieces``, the library's
    host copies) is the plan's Python copy ``dw_spans`` that the CPU tests
    replay: the same parts, slots and stages for every CTA and unit, and
    each unit's slots within ``dw_max_pieces``; on the narrow plans and on
    the wide route's (one part at 8x256, its units split by ``dw_split``)."""
    from dexnerf_tpu_torch.ops._build import load_library

    lib = load_library()
    costs = [u.cost for u in ftl.dw_plan(FlexibleNeRFModel(**arch))]
    spans = ftl.dw_spans(costs, n_st, grid)
    pieces = [sum(u == v for parts in spans for v, *_ in parts) for u in range(len(costs))]
    out = (ctypes.c_int * 4)()
    for b in range(grid):
        want = {u: (piece, j0, j1, pieces[u]) for u, piece, j0, j1 in spans[b]}
        for u, pre in enumerate(itertools.accumulate([0] + costs[:-1])):
            mine = lib.dexnerf_train_bf16_dw_span(n_st, pre, costs[u], sum(costs), grid, b, out)
            assert bool(mine) == (u in want), (b, u)
            if mine:
                assert tuple(out) == want[u], (b, u)
                assert out[3] <= ftl.dw_max_pieces(costs, grid)
