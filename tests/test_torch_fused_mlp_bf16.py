"""The field kernels at ``compute_dtype = dw_dtype = bfloat16``:
``ops/fused_mlp.py`` (kernel 2, the field forward) and
``ops/fused_mlp_train.py`` (kernel 3, the field backward), and the dtype
the port's field path resolves (``train/loop.py::maybe_fused_fields``).

On the CPU: the bf16 plain versions held to the JAX package's
``make_fused_flexible_field`` and ``make_fused_flexible_field_train`` at
bf16 in interpret mode on one set of weights and inputs, and one
field-path train step (``render_rays`` with the bf16 fields on both
passes, loss and every gradient before Adam) held to JAX's on the same
draws; bf16 differs from f32 on both sides; the dtype resolution. On a
CUDA card (marker ``gpu``): the bf16 kernels held to their bf16 plain
versions, chunked against one-chunk backwards, repeatability, refusals and
the launch counters. The JAX package is imported inside a fixture, so that
this file also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_mlp_bf16.py
"""

import copy
import os
import types

import numpy as np
import pytest
import torch
import yaml
from test_torch_train_loss import _jax_draws  # the JAX key split of render_rays

from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.ops.fused_render import MAX_HIDDEN, MAX_HIDDEN_BF16
from dexnerf_tpu_torch.render.renderer import RayBatch, RenderSettings, render_rays
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.loop import maybe_fused_fields
from dexnerf_tpu_torch.train.step import nerf_loss

BF16, F32 = torch.bfloat16, torch.float32
ENC_XYZ, ENC_DIR = 3, 2
ARCH = dict(num_layers=4, hidden_size=32, skip_connect_every=2,
            num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
# Port vs JAX, both at bf16: the same operands rounded on both sides, only
# the f32 summation order differs, and that order can flip the bf16
# rounding of single activations or cotangents. So raw and every leaf are
# held relative to the dtype's own effect: the error against the JAX bf16
# kernel at most OWN_SHARE of the f32 plain version's distance to it (the
# rule of tests/test_torch_train_loss_bf16.py).
OWN_SHARE = 0.25
SETTINGS = RenderSettings(
    num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.2,
    num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR,
)
N_RAYS = 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jx():
    """One flax tree per pass (σ head spread so that samples saturate on
    some rays and stay transparent on others) and the port's models
    holding the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    trees, models = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(20 + i), jnp.ones((1, in_dim))))
        alpha = tree["params"][f"Dense_{ARCH['num_layers'] + 1}"]  # fc_alpha
        alpha["kernel"] *= 30.0
        alpha["bias"] = alpha["bias"] + 1.0
        m = FlexibleNeRFModel(**ARCH)
        m.load_state_dict(state_dict_from_flax(tree))
        trees[name], models[name] = tree, m
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, trees=trees, models=models)


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = (1.5 * rng.normal(size=(n, s, 3))).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    tgt = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd, tgt


def _errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v).all(), k
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want}


def _assert_within_own(got: dict, f32: dict, want: dict):
    """Every entry of ``got`` within OWN_SHARE of the f32 plain version's
    distance to ``want``, which must be > 0 (bf16 is really applied)."""
    err, own = _errors(got, want), _errors(f32, want)
    bad = {k: (err[k], own[k]) for k in want if not (own[k] > 0 and err[k] <= OWN_SHARE * own[k])}
    assert not bad, bad


def _jax_field(jx, dtype, n, s, seed):
    from dexnerf_tpu.ops import make_fused_flexible_field as j_make

    pts, vd, _ = _inputs(n, s, seed)
    fn = j_make(jx.jm, block_samples=16, compute_dtype=dtype, interpret=True)
    return np.asarray(fn(jx.trees["fine"], jx.jnp.asarray(pts), jx.jnp.asarray(vd)))


def _port_field(jx, dtype, n, s, seed):
    pts, vd, _ = _inputs(n, s, seed)
    field = fused_mlp.make_fused_flexible_field(jx.models["fine"], compute_dtype=dtype)
    assert field.compute_dtype == dtype
    raw = field(torch.tensor(pts), torch.tensor(vd))
    assert raw.shape == (n, s, 4) and not raw.requires_grad
    return raw.numpy()


# (rays, samples): 5 x 6 pads to 8 rays a block in JAX (block_samples 16)
@pytest.mark.parametrize("n,s", [(4, 6), (5, 6), (3, 16)])
def test_bf16_field_matches_jax(jx, n, s):
    """Kernel 2's bf16 plain version (``flex_forward_bf16`` on the
    encodings) vs the JAX kernel at compute_dtype=bfloat16: every raw
    entry; CPU tensors never reach a kernel."""
    seed = n + s
    want = _jax_field(jx, jx.jnp.bfloat16, n, s, seed)
    launches = (fused_mlp.launches, fused_mlp.launches_bf16)
    got = _port_field(jx, BF16, n, s, seed)
    assert (fused_mlp.launches, fused_mlp.launches_bf16) == launches
    f32 = _port_field(jx, F32, n, s, seed)
    _assert_within_own({"raw": got}, {"raw": f32}, {"raw": want})


def _jax_train_grads(jx, dtype, n, s, seed):
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_make

    pts, vd, tgt = _inputs(n, s, seed)
    fn = j_make(jx.jm, block_samples=16, compute_dtype=dtype, dw_dtype=dtype, interpret=True)
    jp, jv, jt = (jx.jnp.asarray(a) for a in (pts, vd, tgt))
    loss, g = jx.jax.value_and_grad(
        lambda params: jx.jnp.mean((fn(params, jp, jv) - jt) ** 2))(jx.trees["fine"])
    out = {k: v.numpy() for k, v in state_dict_from_flax(jx.jax.tree.map(np.asarray, g)).items()}
    return {"loss": float(loss), **out}


def _port_train_grads(jx, dtype, n, s, seed, dw_dtype="same"):
    pts, vd, tgt = _inputs(n, s, seed)
    model = copy.deepcopy(jx.models["fine"])
    dw = dtype if dw_dtype == "same" else dw_dtype
    field = fused_mlp_train.make_fused_flexible_field_train(model, compute_dtype=dtype,
                                                            dw_dtype=dw)
    assert (field.compute_dtype, field.dw_dtype) == (dtype, F32 if dw is None else dw)
    launches = (fused_mlp_train.launches, fused_mlp_train.launches_bf16)
    loss = torch.mean((field(torch.tensor(pts), torch.tensor(vd)) - torch.tensor(tgt)) ** 2)
    loss.backward()
    assert (fused_mlp_train.launches, fused_mlp_train.launches_bf16) == launches
    return {"loss": float(loss.detach()),
            **{k: p.grad.numpy() for k, p in model.named_parameters()}}


@pytest.mark.parametrize("n,s", [(4, 6), (5, 6)])
def test_bf16_train_field_grads_match_jax(jx, n, s):
    """Kernel 3's bf16 plain version (autograd through
    ``flex_forward_train``) vs the JAX training field at compute_dtype =
    dw_dtype = bfloat16: the loss and every gradient leaf."""
    seed = 10 + n
    want = _jax_train_grads(jx, jx.jnp.bfloat16, n, s, seed)
    got = _port_train_grads(jx, BF16, n, s, seed)
    f32 = _port_train_grads(jx, F32, n, s, seed)
    _assert_within_own(got, f32, want)


def test_bf16_field_differs_from_f32(jx):
    """The dtype is really applied: on the JAX side bf16 and f32 differ,
    in raw and in every gradient leaf, by more than the port's error at
    bf16 over OWN_SHARE; the port's f32 plain version is JAX's f32 form."""
    n, s, seed = 5, 6, 15
    jb = {"raw": _jax_field(jx, jx.jnp.bfloat16, n, s, seed),
          **_jax_train_grads(jx, jx.jnp.bfloat16, n, s, seed)}
    jf = {"raw": _jax_field(jx, jx.jnp.float32, n, s, seed),
          **_jax_train_grads(jx, jx.jnp.float32, n, s, seed)}
    pb = {"raw": _port_field(jx, BF16, n, s, seed), **_port_train_grads(jx, BF16, n, s, seed)}
    pf = {"raw": _port_field(jx, F32, n, s, seed), **_port_train_grads(jx, F32, n, s, seed)}
    own_jax, err = _errors(jb, jf), _errors(pb, jb)
    for k in jb:
        assert own_jax[k] > err[k] / OWN_SHARE, (k, own_jax[k], err[k])
    f_err = _errors(pf, jf)
    assert all(f_err[k] <= 1e-4 * max(1.0, float(np.abs(jf[k]).max())) for k in jf), f_err


def test_mixed_dtype_pairs_on_cpu(jx):
    """The plain backward takes every pair (dw_dtype None is float32, as in
    JAX); each mixed pair differs from both pure ones; an unknown dtype
    raises before any work."""
    n, s, seed = 4, 6, 3
    runs = {(cd, dw): _port_train_grads(jx, cd, n, s, seed, dw_dtype=dw)
            for cd in (F32, BF16) for dw in (F32, BF16)}
    key = "layers_xyz.1.weight"
    for pair in ((F32, BF16), (BF16, F32)):
        for other in ((F32, F32), (BF16, BF16)):
            assert not np.array_equal(runs[pair][key], runs[other][key]), (pair, other)
    none = _port_train_grads(jx, BF16, n, s, seed, dw_dtype=None)
    assert np.array_equal(none[key], runs[(BF16, F32)][key])
    with pytest.raises(ValueError, match="dw_dtype"):
        fused_mlp_train.make_fused_flexible_field_train(jx.models["fine"], dw_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_mlp.make_fused_flexible_field(jx.models["fine"], compute_dtype=torch.float64)


def test_field_path_step_matches_jax(jx):
    """One field-path train step before Adam: ``render_rays`` with the
    bf16 training fields on both passes, ``nerf_loss`` and the gradient of
    every parameter of both models, port vs JAX at bf16 on draws from one
    key, held relative to the dtype's own effect (the f32 port's distance)."""
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_make
    from dexnerf_tpu.render import RayBatch as JRayBatch
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import render_rays as j_render
    from dexnerf_tpu.train.step import nerf_loss as j_loss

    rng = np.random.default_rng(8)
    rd = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    ro = (0.2 * rng.normal(size=(N_RAYS, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    near = np.full((N_RAYS,), 2.0, np.float32)
    arrays = (ro, rd, vd, near, near + 4.0)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    key = jx.jax.random.PRNGKey(5)
    draws = _jax_draws(jx, key, N_RAYS, SETTINGS)

    j_field = j_make(jx.jm, block_samples=128, compute_dtype=jx.jnp.bfloat16,
                     dw_dtype=jx.jnp.bfloat16, interpret=True)
    jrays = JRayBatch(*(jx.jnp.asarray(a) for a in arrays))

    def j_fn(params):
        result = j_render(jx.jm.apply, jx.jm.apply, params, jrays, key,
                          JSettings(**SETTINGS.__dict__), coarse_field=j_field,
                          fine_field=j_field)
        return j_loss(result, jx.jnp.asarray(target))

    (_, j_metrics), j_grads = jx.jax.value_and_grad(j_fn, has_aux=True)(
        jx.jax.tree.map(jx.jnp.asarray, jx.trees))
    want = {k: float(j_metrics[k]) for k in ("loss", "coarse_loss", "fine_loss")}
    for name in ("coarse", "fine"):
        leaves = state_dict_from_flax(jx.jax.tree.map(np.asarray, j_grads[name]))
        want.update({f"{name}.{k}": v.numpy() for k, v in leaves.items()})

    def port(dtype):
        coarse, fine = (copy.deepcopy(jx.models[n]) for n in ("coarse", "fine"))
        make = fused_mlp_train.make_fused_flexible_field_train
        result = render_rays(coarse, fine, RayBatch(*(torch.tensor(a) for a in arrays)),
                             SETTINGS, draws,
                             coarse_field=make(coarse, compute_dtype=dtype, dw_dtype=dtype),
                             fine_field=make(fine, compute_dtype=dtype, dw_dtype=dtype))
        loss, metrics = nerf_loss(result, torch.tensor(target))
        loss.backward()
        out = {k: float(metrics[k].detach()) for k in ("loss", "coarse_loss", "fine_loss")}
        for name, m in (("coarse", coarse), ("fine", fine)):
            out.update({f"{name}.{n}": p.grad.numpy() for n, p in m.named_parameters()})
        return out

    _assert_within_own(port(BF16), port(F32), want)


def _cfg(**nerf):
    """``configs/tiny.yml`` (which sets no ``pallas_compute_dtype``) with the
    fused kernels on and the ``nerf`` keys overridden."""
    with open(os.path.join(ROOT, "configs", "tiny.yml")) as f:
        raw = yaml.safe_load(f)
    raw["nerf"].update(use_pallas=True, **nerf)
    return CfgNode(raw)


@pytest.mark.parametrize(
    "nerf,want",
    [({}, BF16), ({"pallas_compute_dtype": "bfloat16"}, BF16),
     ({"pallas_compute_dtype": "float32"}, F32)],
    ids=["default", "bf16", "f32"],
)
@pytest.mark.parametrize("train", [True, False], ids=["train", "forward"])
def test_maybe_fused_fields_dtype(nerf, want, train):
    """The fields' dtype is ``nerf.pallas_compute_dtype`` (default bf16) on
    the CPU too, as JAX's ``maybe_fused_fields`` gives it; kernel 3's
    ``dw_dtype`` is the same."""
    models = [FlexibleNeRFModel(**ARCH) for _ in range(2)]
    fields = maybe_fused_fields(_cfg(**nerf), *models, train=train)
    for f in fields:
        assert f.compute_dtype == want
        if train:
            assert f.dw_dtype == want


def test_maybe_fused_fields_rejects_unknown_dtype():
    models = [FlexibleNeRFModel(**ARCH) for _ in range(2)]
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError, match="pallas_compute_dtype"):
            maybe_fused_fields(_cfg(pallas_compute_dtype=bad), *models, train=True)


# ---- on the card: the bf16 kernels vs their bf16 plain versions

FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3,
            num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
SMALL = dict(num_layers=4, hidden_size=16, skip_connect_every=2,
             num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
# kernel vs the bf16 plain version on the card, raw and each leaf held to
# the dtype's own effect (own = |bf16 plain - f32 plain|): max <= own, the
# 99.9th percentile <= 0.25 own, and the kernel's distance to the f32 plain
# version <= 1.5 own, each + 1e-5 of the largest entry (the rule of the
# kernel-4 card tests, tests/test_torch_train_loss_bf16.py)
LOG = dict(log_sampling_xyz=True, log_sampling_dir=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, arch, n, s, seed=9):
    m = FlexibleNeRFModel(**arch).reset_parameters(torch.Generator().manual_seed(seed)).to(cuda)
    pts, vd, g = (torch.tensor(a, device=cuda) for a in _inputs(n, s, seed))
    return m, pts, vd, g


def _assert_own_on_card(got: dict, bp: dict, fp: dict, xp: dict, p999: bool = True):
    """The rule above (``perf_tools/bf16_exact_rule.py::hold_case``; with
    ``p999`` False its max clauses alone); a miss names the leaves where the
    exact contract ``xp`` (float64 sums of the bf16 products) misses the
    rule too, where no correct kernel meets it (ROADMAP Queue 3, fault 9)."""
    from perf_tools.bf16_exact_rule import hold_case

    for k in bp:
        assert bool(torch.isfinite(got[k]).all()), k
    bad, exact_misses = hold_case(got, bp, fp, xp, 0 if p999 else float("inf"))
    assert not bad, (bad, {"the exact contract misses too": exact_misses})


def _plain(model, pts, vd, g):
    """raw and every leaf of the bf16 and the f32 plain versions."""
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for dt in (BF16, F32):
        raw = fused_mlp.fused_field_reference(model, pts, vd, compute_dtype=dt)
        grads = fused_mlp_train.field_grads_reference(model, pts, vd, g, compute_dtype=dt,
                                                      dw_dtype=dt)
        out[dt] = {"raw": raw.detach(), **dict(zip(names, grads))}
    return out[BF16], out[F32]


def _exact(model, pts, vd, g):
    """raw and every leaf of the exact contract (the bf16 plain version of
    the training field with float64 sums of its bf16 products:
    ``perf_tools/bf16_exact_rule.py``)."""
    from perf_tools.bf16_exact_rule import exact_linear, on_linear

    names = [n for n, _ in model.named_parameters()]
    xyz = positional_encoding(pts, model.num_encoding_fn_xyz, model.include_input_xyz, True)
    view = positional_encoding(vd, model.num_encoding_fn_dir, model.include_input_dir, True)
    with on_linear(exact_linear()):
        with torch.no_grad():
            raw = ftl.flex_forward_train(model, xyz, view, BF16, BF16)
        grads = fused_mlp_train.field_grads_reference(model, pts, vd, g, compute_dtype=BF16,
                                                      dw_dtype=BF16)
    return {"raw": raw, **dict(zip(names, grads))}


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", [(300, 64), (300, 100), (300, 128), (300, 256), (3, 8), (301, 7)],
                         ids=["64", "100", "128", "256", "3rays-8", "rows-not-64"])
@pytest.mark.parametrize("arch", [FULL, SMALL, dict(FULL, hidden_size=48), dict(FULL, hidden_size=32),
                                  dict(FULL, hidden_size=64), dict(FULL, hidden_size=96),
                                  dict(FULL, num_encoding_fn_xyz=16), dict(FULL, hidden_size=100)],
                         ids=["8x128", "4x16", "h48", "h32", "h64", "h96", "pe16", "h100"])
def test_bf16_kernels_match_plain_on_card(cuda, arch, n, s):
    """Both bf16 kernels through the training field (kernel 2 forward,
    kernel 3 backward) and kernel 2 alone: one launch each of the bf16
    routes and none of the f32 ones; raw and every leaf held to the bf16
    plain version. Also PE 16 (two encoding K-chunks), S = 256, a launch of
    fewer 64-row tiles than the forward has workers (3 rays x 8 samples),
    rows that are not a multiple of 64 (301 x 7) and a width not a multiple
    of 8 (100, zero-padded to 128)."""
    _hold_field_kernels(cuda, arch, n, s)


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", [(300, 64), (300, 128), (300, 256), (301, 7)],
                         ids=["64", "128", "256", "rows-not-64"])
@pytest.mark.parametrize("arch", [dict(FULL, hidden_size=136), dict(FULL, hidden_size=256),
                                  dict(FULL, hidden_size=320), dict(FULL, hidden_size=576)],
                         ids=["h136", "h256", "h320", "h576"])
def test_wide_kernels_match_plain_on_card(cuda, arch, n, s):
    """The wide route of both kernels (padded widths above 128: 136 padded
    to 160, 256 and 320: two consumers, a dW plan in two parts; 576, one
    consumer, four parts; at 576 the 64-256 cases miss the p99.9 clause
    with the parent's kernels as with these, ROADMAP Queue 3, fault 9,
    open), counted by ``launches_wide`` too, held as above; at
    301 x 7 (rows not a multiple of 64, and 34 64-row tiles, fewer than the
    forward's 264 workers) by the rule's max clauses alone:
    each leaf sums 2107 samples and has fewer than 1000 entries, so its
    99.9th percentile is its max, and there the wide route's largest leaf
    error was 0.26-0.29 of own on the H100 (h256: layers_xyz.1), past the
    0.25 the p99.9 clause asks of a percentile. The 3 x 8 launch is not
    held here: a leaf of 24 samples' sums moves by more than the dtype's
    own effect for one bf16 flip (1.3 own at h136, layers_xyz.3.bias);
    kernel 1's 3-ray frame holds the forward's edge."""
    _hold_field_kernels(cuda, arch, n, s, p999=n * s >= 10_000)


def _hold_field_kernels(cuda, arch, n, s, p999=True):
    m, pts, vd, g = _card_case(cuda, arch, n, s)
    mods = (fused_mlp, fused_mlp_train)
    before = [(mod.launches, mod.launches_bf16, mod.launches_wide) for mod in mods]
    raw = fused_mlp_train.fused_field_train(m, pts, vd, compute_dtype=BF16, dw_dtype=BF16)
    raw.backward(g)
    torch.cuda.synchronize()
    wide = int(m.hidden_size > 128)
    assert [(mod.launches, mod.launches_bf16, mod.launches_wide) for mod in mods] == [
        (a + 1, b + 1, c + wide) for a, b, c in before]
    names = [n for n, _ in m.named_parameters()]
    got = {"raw": raw, **dict(zip(names, (p.grad for p in m.parameters())))}
    bp, fp = _plain(m, pts, vd, g)
    xp = _exact(m, pts, vd, g)
    _assert_own_on_card(got, bp, fp, xp, p999)
    alone = fused_mlp.fused_field(m, pts, vd, compute_dtype=BF16)
    _assert_own_on_card({"raw": alone}, {"raw": bp["raw"]}, {"raw": fp["raw"]},
                        {"raw": xp["raw"]}, p999)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [FULL, dict(FULL, hidden_size=256)], ids=["8x128", "wide-h256"])
def test_bf16_backward_chunks_and_repeats_on_card(cuda, monkeypatch, arch):
    """Several scratch chunks (the last one short, S not a multiple of the
    128-sample tile) agree with one chunk within the card rule; two runs
    are bitwise equal; on the narrow route and on the wide one."""
    m, pts, vd, g = _card_case(cuda, arch, 301, 100)
    kw = dict(LOG, compute_dtype=BF16, dw_dtype=BF16)
    one = [t.clone() for t in fused_mlp_train._launch_backward(m, pts, vd, g, **kw)]
    again = [t.clone() for t in fused_mlp_train._launch_backward(m, pts, vd, g, **kw)]
    monkeypatch.setattr(fused_mlp_train, "SCRATCH_SAMPLES", 100 * 40)
    chunked = [t.clone() for t in fused_mlp_train._launch_backward(m, pts, vd, g, **kw)]
    torch.cuda.synchronize()
    for a, b in zip(one, again):
        assert torch.equal(a, b)
    names = [n for n, _ in m.named_parameters()]
    bp, fp = _plain(m, pts, vd, g)
    xp = _exact(m, pts, vd, g)
    del bp["raw"], fp["raw"], xp["raw"]
    _assert_own_on_card(dict(zip(names, one)), bp, fp, xp)
    _assert_own_on_card(dict(zip(names, chunked)), bp, fp, xp)


@pytest.mark.gpu
def test_bf16_refusals_on_card(cuda):
    """A width above MAX_HIDDEN raises at f32 and one above MAX_HIDDEN_BF16
    at bf16, both naming ROADMAP Queue 2 item 6c; so do non-contiguous or
    non-f32 inputs and a mixed pair; nothing launches."""
    m, pts, vd, g = _card_case(cuda, FULL, 16, 64)
    before = (fused_mlp.launches, fused_mlp_train.launches)
    # the f32 routes take widths up to MAX_HIDDEN, the bf16 routes up to
    # MAX_HIDDEN_BF16 (wider: ROADMAP Queue 2 item 6c)
    wide = FlexibleNeRFModel(**dict(FULL, hidden_size=MAX_HIDDEN + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        fused_mlp.fused_field(wide, pts, vd, compute_dtype=F32)
    with pytest.raises(ValueError, match="item 6c"):
        fused_mlp_train._launch_backward(wide, pts, vd, g, **LOG, compute_dtype=F32,
                                         dw_dtype=F32)
    too_wide = FlexibleNeRFModel(**dict(FULL, hidden_size=MAX_HIDDEN_BF16 + 1)).to(cuda)
    with pytest.raises(ValueError, match="item 6c"):
        fused_mlp.fused_field(too_wide, pts, vd, compute_dtype=BF16)
    with pytest.raises(ValueError, match="item 6c"):
        fused_mlp_train._launch_backward(too_wide, pts, vd, g, **LOG, compute_dtype=BF16,
                                         dw_dtype=BF16)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp.fused_field(m, pts.double(), vd, compute_dtype=BF16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_field(m, pts.transpose(0, 1).contiguous().transpose(0, 1), vd,
                              compute_dtype=BF16)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp_train._launch_backward(m, pts, vd, g.to(BF16), **LOG, compute_dtype=BF16,
                                         dw_dtype=BF16)
    with pytest.raises(ValueError, match="dw_dtype"):
        fused_mlp_train.fused_field_train(m, pts, vd, compute_dtype=BF16, dw_dtype=F32)
    assert (fused_mlp.launches, fused_mlp_train.launches) == before
