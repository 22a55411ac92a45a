"""The bf16 kernels at every width the JAX kernels take, on the CPU: the
wide route (padded widths above 128, ``ops/csrc/mlp_wide_bf16.cuh``) and
widths that are not a multiple of 8 (computed zero-padded to a multiple of
32 on the narrow kernels).

* The bf16 packs at H in {20, 100, 136, 256, 320}: every padded entry
  exactly zero, the un-swizzled operands and the aux buffer equal to the
  model's weights rounded as the contract says.
* The plain versions of kernels 1, 2-3 and 4 at H in {100, 136, 256}
  against the JAX kernels at bf16 in interpret mode, on one set of weights
  (``state_dict_from_flax``) and the same numpy rays, draws and cotangents,
  gradients included for kernels 3 and 4. Tolerance, the bf16 rule of these
  files (``tests/test_torch_train_loss_bf16.py``): both sides round the same
  operands and differ only in f32 summation order, which can flip the bf16
  rounding of single activations, so each field and leaf must lie within
  OWN_SHARE of the f32 plain version's distance to the JAX bf16 kernel,
  + 1e-5 of its largest entry (PERF.md's bf16 rule).
* JAX's selection rules at 256: ``maybe_fused_loss``, ``maybe_fused_fields``
  and ``fused_render_impl`` are not None exactly where JAX's are.
* Three Adam steps of ``configs/lego-tpu.yml`` at 2x256 through
  ``apps.train --device cpu`` against JAX's ``run_training`` from one
  ``.ckpt`` on JAX's draws (at float32: see the test).
* The dW plan of the wide route (units split to the kernel's limits, in
  parts of at most DW_MAX_UNITS), the reckoned largest bf16 width and the
  refusals above each dtype's largest width, which name ROADMAP Queue 2
  item 6c.

    python -m pytest tests/test_torch_wide.py
"""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from test_torch_eval import calibrated_checkpoint

from dexnerf_tpu_torch.apps import train as train_app
from dexnerf_tpu_torch.config.cfgnode import CfgNode
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.core.volrend import ray_dists
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.render.renderer import RenderDraws
from dexnerf_tpu_torch.train import loop as ploop
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import StepDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = torch.bfloat16, torch.float32
ENC_XYZ, ENC_DIR = 3, 2
WIDTHS = (100, 136, 256)
PACK_WIDTHS = (20, 100, 136, 256, 320)
OWN_SHARE = 0.25
SCALE_ATOL = 1e-5
N_RAYS, S = 16, 16
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5  # tests/test_torch_cache.py's, f32 on both sides
# Adam's first update is about lr * sign(g): an element whose |g| sits at
# round-off moves by a share of lr (tests/test_torch_train_step.py's note).
# At 2x256 (131k weights a trunk layer) 16 of 65536 elements of
# coarse.layers_xyz.0 move by up to 2.9e-4 = 0.057 lr after three updates;
# every leaf's 99.9th percentile stays within WIDE_PARAM_ATOL: PARAM_ATOL is
# the rule of a 2x16 model, and the f32 round-off of a sum grows as the
# square root of its length, 16x longer at 256 (measured 1.07e-5 at
# fine.layers_xyz.0).
ROUNDOFF_LR = 0.1
WIDE_PARAM_ATOL = 4 * PARAM_ATOL


def _arch(hidden, **kw):
    """Four layers (a skip layer at trunk index 1), PE 3/2."""
    return dict(dict(num_layers=4, hidden_size=hidden, skip_connect_every=1,
                     num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR), **kw)


def _model(hidden, seed=0, **kw):
    m = FlexibleNeRFModel(**_arch(hidden, **kw)).reset_parameters(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():  # every parameter nonzero, so that padding is told apart
        for p in m.parameters():
            p.add_(torch.where(p == 0, 1e-3, 0.0))
    return m


# ---- the packs


def _unswizzle(flat, k, n):
    """``flat`` [k/64 chunks][n rows][64] in wgmma's 128 B swizzle (16-byte
    group j of row r stored at j ^ (r % 8)) back to [n, k]."""
    chunks = flat.reshape(k // 64, n, 8, 8)
    r = torch.arange(n)[:, None]
    stored = torch.arange(8)[None, :] ^ (r % 8)
    return chunks[:, r, stored].permute(1, 0, 2, 3).reshape(n, k)


def _pad_check(block, mat, name):
    """``block`` (padded) holds ``mat`` at its top-left, zeros elsewhere."""
    n, k = mat.shape
    assert torch.equal(block[:n, :k], mat), name
    rest = block.clone()
    rest[:n, :k] = 0
    assert not bool(rest.any()), f"{name}: padding not zero"


@pytest.mark.parametrize("hidden", PACK_WIDTHS)
def test_bf16_forward_pack_at_width(hidden):
    """``pack_flex_weights_bf16``: each operand, un-swizzled, is the model's
    weight rounded to bf16 in the corner of its padded [Hp or Hp/2, K]
    block; the aux buffer's biases and heads are the model's f32 ones and
    its viewdir rows the bf16-rounded ones, each zero-padded; nothing else
    is in the pack."""
    m = _model(hidden, num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    H, Hp = hidden, fr.bf16_hidden(hidden)
    assert Hp % 32 == 0 and Hp - 32 < H <= Hp
    wq, aux, off = fr.pack_flex_weights_bf16(m)
    assert wq.dtype == torch.bfloat16
    wq = wq.float()
    dxp, kh = fr._round_up(m.dim_xyz, 64), fr._round_up(Hp, 64)
    b = fr._bf16
    ops = [("layer1", dxp, Hp, b(m.layer1.weight))]
    for i, lin in enumerate(m.layers_xyz):
        ops.append((f"layers_xyz.{i}", kh, Hp, b(lin.weight[:, :H])))
        if i in m.skips:
            ops.append((f"layers_xyz.{i} xyz", dxp, Hp, b(lin.weight[:, H:])))
    ops.append(("fc_feat", kh, Hp, b(m.fc_feat.weight)))
    ops.append(("layers_dir.0 feat", kh, Hp // 2, b(m.layers_dir[0].weight[:, :H])))
    pos = 0
    for name, k, n, w in ops:
        _pad_check(_unswizzle(wq[pos:pos + k * n], k, n), w.detach(), name)
        pos += k * n
    assert pos == wq.numel()
    nt, Hp2 = m.num_layers - 1, Hp // 2
    vecs = [(m.layer1.bias, Hp), *((lin.bias, Hp) for lin in m.layers_xyz),
            (m.fc_feat.bias, Hp), (m.layers_dir[0].bias, Hp2),
            (m.fc_alpha.weight[0], Hp), (m.fc_alpha.bias, 1)]
    for i, (v, n) in enumerate(vecs):
        _pad_check(aux[off[i]:off[i] + n][None], v.detach()[None], f"aux {i}")
    _pad_check(aux[off[nt + 5]:off[nt + 5] + 3 * Hp2].view(Hp2, 3), m.fc_rgb.weight.detach().t(),
               "w_rgb")
    assert torch.equal(aux[off[nt + 6]:off[nt + 6] + 3], m.fc_rgb.bias.detach())
    vd = aux[off[nt + 7]:off[nt + 7] + m.dim_dir * Hp2].view(m.dim_dir, Hp2)
    _pad_check(vd, b(m.layers_dir[0].weight[:, H:]).detach().t(), "viewdir rows")


@pytest.mark.parametrize("hidden", PACK_WIDTHS)
def test_bf16_backward_pack_at_width(hidden):
    """``pack_backward_weights_bf16``: [K/64][Hp][64] chunks of each
    transposed weight (the wide chain loads them as [128][64] boxes), each
    the bf16-rounded weight in its block's corner, zeros elsewhere."""
    m = _model(hidden)
    H, Hp = hidden, fr.bf16_hidden(hidden)
    wbq = ftl.pack_backward_weights_bf16(m).float()
    mats = [(fr._round_up(Hp // 2, 64), m.layers_dir[0].weight[:, :H]),
            (fr._round_up(Hp, 64), m.fc_feat.weight)]
    mats += [(fr._round_up(Hp, 64), lin.weight[:, :H]) for lin in reversed(m.layers_xyz)]
    pos = 0
    for i, (k, w) in enumerate(mats):
        block = wbq[pos:pos + k * Hp].reshape(k // 64, Hp, 64).permute(1, 0, 2).reshape(Hp, k)
        _pad_check(block, fr._bf16(w.detach().t()), f"product {i}")
        pos += k * Hp
    assert pos == wbq.numel()


# ---- the plain versions against the JAX kernels


@pytest.fixture(scope="module")
def jax_mod():
    return pytest.importorskip("jax")


_trees = {}


def _jx(jax_mod, hidden):
    """The flax tree of a 4-layer FlexibleNeRF of width ``hidden`` (σ head
    spread so that samples saturate on some rays), the port's model holding
    the same weights, and the JAX module."""
    if hidden not in _trees:
        import jax.numpy as jnp

        from dexnerf_tpu.core.encoding import encoding_dim
        from dexnerf_tpu.models import FlexibleNeRFModel as JFlex

        jm = JFlex(**_arch(hidden))
        in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
        tree = jax_mod.tree.map(np.array, jm.init(jax_mod.random.PRNGKey(hidden),
                                                  jnp.ones((1, in_dim))))
        alpha = tree["params"]["Dense_5"]  # fc_alpha
        alpha["kernel"] *= 30.0
        alpha["bias"] = alpha["bias"] + 1.0
        m = FlexibleNeRFModel(**_arch(hidden))
        m.load_state_dict(state_dict_from_flax(tree))
        _trees[hidden] = types.SimpleNamespace(jax=jax_mod, jnp=jnp, jm=jm, tree=tree, model=m)
    return _trees[hidden]


def _inputs(seed=3, n=N_RAYS, s=S):
    rng = np.random.default_rng(seed)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    ro = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = stratified_z_vals(torch.full((n,), 2.0), torch.full((n,), 6.0), s).numpy()
    z = z + rng.uniform(0.0, 0.2, size=z.shape).astype(np.float32)
    dists = ray_dists(torch.tensor(z), torch.tensor(rd)).numpy()
    pts = ro[:, None] + rd[:, None] * z[..., None]
    return dict(origins=ro, directions=rd, viewdirs=vd, z_vals=z, dists=dists,
                noise=(0.5 * rng.normal(size=(n, s))).astype(np.float32),
                target=rng.uniform(size=(n, 3)).astype(np.float32), pts=pts.astype(np.float32),
                g=rng.normal(size=(n, s, 4)).astype(np.float32))


def _errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(np.asarray(v)).all(), k
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want}


def _assert_within_own(got: dict, f32: dict, want: dict):
    """Every entry of ``got`` (the port at bf16) within OWN_SHARE of the f32
    plain version's distance to ``want`` (JAX at bf16), which must be > 0,
    + SCALE_ATOL of the entry's largest value (PERF.md's bf16 rule: a
    saturated accumulation differs by an ulp of 1 on either side)."""
    err, own = _errors(got, want), _errors(f32, want)
    bad = {k: (err[k], own[k]) for k in want
           if not (own[k] > 0 and err[k] <= OWN_SHARE * own[k]
                   + SCALE_ATOL * float(np.abs(np.asarray(want[k])).max()))}
    assert not bad, bad


def _grads(jx, g):
    return {k: v.numpy() for k, v in state_dict_from_flax(jx.jax.tree.map(np.asarray, g)).items()}


@pytest.mark.parametrize("hidden", WIDTHS)
def test_render_plain_matches_jax_at_width(jax_mod, hidden):
    """Kernel 1's plain version at bf16 vs the JAX fused render at bf16
    (interpret mode): rgb, accumulation, depth and weights."""
    from dexnerf_tpu.ops.fused_render import make_fused_render

    jx = _jx(jax_mod, hidden)
    a = _inputs()
    keys = ("origins", "directions", "viewdirs", "z_vals", "dists")
    render = make_fused_render(jx.jm, block_samples=512, compute_dtype=jx.jnp.bfloat16,
                               interpret=True)
    j = render(jx.tree, *(jx.jnp.asarray(a[k]) for k in keys))
    fields = ("rgb", "accumulation", "depth", "weights")
    want = {f: np.asarray(getattr(j, f)) for f in fields}
    launches = fr.launches

    def port(dtype):
        out = fr.fused_render_reference(jx.model, *(torch.tensor(a[k]) for k in keys),
                                        compute_dtype=dtype)
        return {f: getattr(out, f).numpy() for f in fields}

    _assert_within_own(port(BF16), port(F32), want)
    assert fr.launches == launches  # CPU tensors never reach a kernel


@pytest.mark.parametrize("hidden", WIDTHS)
def test_train_loss_plain_matches_jax_at_width(jax_mod, hidden):
    """Kernel 4's plain version at compute_dtype = dw_dtype = bfloat16 vs the
    JAX pass loss at bf16 (interpret mode): loss, weights, rgb and every
    gradient leaf."""
    from dexnerf_tpu.ops.fused_train_loss import make_fused_pass_loss

    jx = _jx(jax_mod, hidden)
    a = _inputs(seed=4)
    keys = ("origins", "directions", "z_vals", "viewdirs", "dists", "noise", "target")
    fn = make_fused_pass_loss(jx.jm, block_samples=128, compute_dtype=jx.jnp.bfloat16,
                              dw_dtype=jx.jnp.bfloat16, interpret=True)
    ja = [jx.jnp.asarray(a[k]) for k in keys]

    def f(params):
        loss, w, rgb = fn(params, *ja)
        return loss, (w, rgb)

    (loss, (w, rgb)), g = jx.jax.value_and_grad(f, has_aux=True)(jx.tree)
    want = {"loss": float(loss), "weights": np.asarray(w), "rgb": np.asarray(rgb),
            **_grads(jx, g)}

    def port(dtype):
        loss, w, rgb, grads = ftl.fused_pass_loss_reference(
            jx.model, *(torch.tensor(a[k]) for k in keys), compute_dtype=dtype, dw_dtype=dtype)
        names = [n for n, _ in jx.model.named_parameters()]
        return {"loss": float(loss), "weights": w.numpy(), "rgb": rgb.numpy(),
                **dict(zip(names, (t.numpy() for t in grads)))}

    _assert_within_own(port(BF16), port(F32), want)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_fields_plain_match_jax_at_width(jax_mod, hidden):
    """Kernel 2's plain version (raw) and kernel 3's (through the training
    field: the loss mean((raw - t)^2) and every gradient leaf) at bf16 vs
    the JAX fields at bf16 (interpret mode)."""
    from dexnerf_tpu.ops import make_fused_flexible_field as j_field
    from dexnerf_tpu.ops import make_fused_flexible_field_train as j_train

    jx = _jx(jax_mod, hidden)
    a = _inputs(seed=5)
    pts, vd, tgt = (jx.jnp.asarray(a[k]) for k in ("pts", "viewdirs", "g"))
    bf = jx.jnp.bfloat16
    raw = j_field(jx.jm, block_samples=16, compute_dtype=bf, interpret=True)(jx.tree, pts, vd)
    fn = j_train(jx.jm, block_samples=16, compute_dtype=bf, dw_dtype=bf, interpret=True)
    loss, grads = jx.jax.value_and_grad(
        lambda p: jx.jnp.mean((fn(p, pts, vd) - tgt) ** 2))(jx.tree)
    want = {"raw": np.asarray(raw), "loss": float(loss), **_grads(jx, grads)}
    t = {k: torch.tensor(a[k]) for k in ("pts", "viewdirs", "g")}

    def port(dtype):
        r = fused_mlp.fused_field_reference(jx.model, t["pts"], t["viewdirs"],
                                            compute_dtype=dtype)
        model = copy.deepcopy(jx.model)
        field = fused_mlp_train.make_fused_flexible_field_train(model, compute_dtype=dtype,
                                                                dw_dtype=dtype)
        loss = torch.mean((field(t["pts"], t["viewdirs"]) - t["g"]) ** 2)
        loss.backward()
        return {"raw": r.detach().numpy(), "loss": float(loss.detach()),
                **{k: p.grad.numpy() for k, p in model.named_parameters()}}

    _assert_within_own(port(BF16), port(F32), want)


# ---- the selection rules at 256


@pytest.mark.parametrize("fine", ["FlexibleNeRFModel", "PaperNeRFModel"])
def test_selection_at_256_matches_jax(fine):
    """At width 256 the port's kernel selection is JAX's: the fused loss,
    the fields and the fused render are None exactly where JAX's are (no
    width rule on either side)."""
    pytest.importorskip("jax")
    from dexnerf_tpu.config import CfgNode as JCfgNode
    from dexnerf_tpu.config import render_settings_from_cfg as j_settings
    from dexnerf_tpu.train.loop import maybe_fused_fields as j_fields
    from dexnerf_tpu.train.loop import maybe_fused_loss as j_loss
    from dexnerf_tpu.train.loop import maybe_fused_render_impl as j_render

    from dexnerf_tpu_torch.config import models_from_cfg, render_settings_from_cfg

    def block(typ):
        shape = ({"num_layers": 2, "hidden_size": 256, "skip_connect_every": 3}
                 if typ == "FlexibleNeRFModel" else {})
        return {"type": typ, "num_encoding_fn_xyz": ENC_XYZ, "num_encoding_fn_dir": ENC_DIR,
                "include_input_xyz": True, "include_input_dir": True, **shape}

    mode = dict(num_coarse=8, num_fine=8, perturb=True, radiance_field_noise_std=0.0,
                white_background=False, lindisp=False)

    def raw(**nerf):
        return dict(models={"coarse": block("FlexibleNeRFModel"), "fine": block(fine)},
                    nerf=dict(use_viewdirs=True, use_pallas=True, train=mode,
                              validation=dict(mode, perturb=False), **nerf))

    def none(x):
        return x is None if not isinstance(x, tuple) else tuple(v is None for v in x)

    cfg, jcfg = CfgNode(raw(use_fused_render=True)), JCfgNode(raw(use_fused_render=True))
    coarse, fine_m = models_from_cfg(cfg)
    assert coarse.hidden_size == 256
    s_train, s_val = (render_settings_from_cfg(cfg, m) for m in ("train", "validation"))
    got = (none(ploop.maybe_fused_loss(cfg, s_train, "rgb", coarse, fine_m)),
           none(ploop.maybe_fused_fields(CfgNode(raw(pallas_fused_loss=False)), coarse, fine_m,
                                         train=True)),
           none(ploop.fused_render_impl(cfg, s_val, "cpu", coarse, fine_m)))
    want = (none(j_loss(jcfg, j_settings(jcfg, "train"), "rgb")),
            none(j_fields(JCfgNode(raw(pallas_fused_loss=False)), train=True)),
            none(j_render(jcfg, j_settings(jcfg, "validation"))))
    assert got == want
    flexible = fine == "FlexibleNeRFModel"
    assert got == ((False, (False, False), False) if flexible else (True, (False, True), True))


# ---- three Adam steps of lego-tpu at 2x256 through apps.train


def _run_draws(jax, seed, iters, batch, num_rays, s):
    """The draws of JAX's run_training steps (``key, sub = split(key)`` per
    iteration from ``PRNGKey(seed)``; in each step ``k_sample, k_render =
    split(sub)``, the ray indices from ``k_sample`` and the render draws
    from ``k_render`` in ``render_rays``' split order, σ-noise included)."""
    jnp = jax.numpy
    key = jax.random.PRNGKey(seed)
    c, f, std = s.num_coarse, s.num_fine, s.radiance_field_noise_std
    out = []

    def t(x):
        return torch.tensor(np.asarray(x))

    for _ in range(iters):
        key, sub = jax.random.split(key)
        k_sample, k_render = jax.random.split(sub)
        idx = jax.random.randint(k_sample, (batch,), 0, num_rays)
        k_strat, k_nc, k_fine, k_nf = jax.random.split(k_render, 4)
        out.append(StepDraws(idx=t(idx).to(torch.int64), render=RenderDraws(
            t_strat=t(jax.random.uniform(k_strat, (batch, c), dtype=jnp.float32)),
            noise_coarse=t(std * jax.random.normal(k_nc, (batch, c), dtype=jnp.float32)),
            u_fine=t(jax.random.uniform(k_fine, (batch, f), dtype=jnp.float32)),
            noise_fine=t(std * jax.random.normal(k_nf, (batch, c + f), dtype=jnp.float32)))))
    return out


def test_lego_tpu_2x256_steps_match_jax(jax_mod, tmp_path, monkeypatch):
    """``configs/lego-tpu.yml`` cut to a 2-layer FlexibleNeRF of width 256,
    PE 3/2 (as every JAX-kernel comparison here: at PE 10 the JAX kernel's
    own sine, ``dexnerf_tpu/ops/fused_mlp.py::_fast_sin``, moves an f32
    gradient by ~2e-4 of its leaf), batch 16 and 8 + 8 samples on an 8x8
    scene, at ``pallas_compute_dtype: float32`` (on a card the f32 kernels'
    wide route; the CPU runs the plain versions, which take any): three Adam steps
    of ``apps.train --device cpu`` on JAX's draws against JAX's
    ``run_training`` (its loss kernel in interpret mode) from one ``.ckpt``:
    the losses to LOSS_RTOL (``tests/test_torch_cache.py``'s rule), every
    parameter leaf of both models to WIDE_PARAM_ATOL on 99.9% of its entries
    and to ROUNDOFF_LR of lr on all (see both). The bf16 contract at this width
    is held pass by pass above: after Adam's first, sign-like update a bf16
    rounding flip of a near-zero gradient moves a parameter by 2 lr."""
    from dexnerf_tpu.config import CfgNode as JCfg
    from dexnerf_tpu.train.loop import run_training as j_run

    data = str(tmp_path / "scene")
    write_blender_dataset(data, height=8, width=8, views_per_split=(2, 1, 1))
    with open(os.path.join(ROOT, "configs", "lego-tpu.yml")) as f:
        raw = yaml.safe_load(f)
    raw["experiment"].update(id="wide", logdir=str(tmp_path / "logs"), train_iters=3,
                             validate_every=0, save_every=0, print_every=1, randomseed=7)
    raw["dataset"].update(basedir=data, half_res=False, cachedir="")
    for blk in ("coarse", "fine"):
        raw["models"][blk].update(num_layers=2, hidden_size=256, num_encoding_fn_xyz=ENC_XYZ,
                                  num_encoding_fn_dir=ENC_DIR)
    for mode in ("train", "validation"):
        raw["nerf"][mode].update(num_coarse=8, num_fine=8, chunksize=1024)
    raw["nerf"]["train"]["num_random_rays"] = 16
    raw["nerf"]["pallas_compute_dtype"] = "float32"
    ckpt = str(tmp_path / "start.ckpt")
    calibrated_checkpoint(raw, ckpt)
    raw_j = copy.deepcopy(raw)
    raw_j["experiment"]["id"] = "wide_jax"
    want = j_run(JCfg(raw_j), load_ckpt=ckpt, use_tensorboard=False)

    s = ploop.render_settings_from_cfg(CfgNode(raw), "train")
    draws = iter(_run_draws(jax_mod, 7, 3, 16, 2 * 8 * 8, s))
    make_step = ploop.make_train_step
    states = []

    def make_with_draws(*a, **k):
        step = make_step(*a, **k)

        def run(state, store, generator):
            states.append(state)
            return step(state, store, generator, draws=[next(draws)])

        return run

    monkeypatch.setattr(ploop, "make_train_step", make_with_draws)
    path = str(tmp_path / "wide.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    assert train_app.main(["--config", path, "--device", "cpu", "--load-checkpoint", ckpt]) == 0

    def losses(run_id):
        with open(os.path.join(str(tmp_path / "logs"), run_id, "metrics.jsonl")) as f:
            return [r["value"] for r in map(json.loads, f) if r["tag"] == "train/loss"]

    got, exp = losses("wide"), losses("wide_jax")
    assert len(got) == len(exp) == 3 and len(states) == 3
    np.testing.assert_allclose(got, exp, rtol=LOSS_RTOL)
    for name in ("coarse", "fine"):
        ref = state_dict_from_flax(jax_mod.tree.map(np.asarray, want["state"].params[name]))
        model = getattr(states[-1], name)
        assert model.hidden_size == 256
        for pname, p in model.named_parameters():
            d = np.abs(p.detach().numpy() - ref[pname].numpy())
            assert np.quantile(d, 0.999) <= WIDE_PARAM_ATOL, (name, pname)
            assert d.max() <= ROUNDOFF_LR * raw["optimizer"]["lr"], (name, pname, d.max())


# ---- the plan and the contract


@pytest.mark.parametrize("hidden", [136, 256, 320, 512, 576])
def test_wide_dw_plan_within_limits(hidden):
    """The wide route's dW plan: every unit within the kernel's limits (at
    most DW_MAX_BOXES boxes and DW_MAX_BLOCKS output blocks), every weight
    entry of every product written by exactly one block (the biases and the
    viewdir rows are the chain's), the plan in parts of at most
    DW_MAX_UNITS units, each with fresh accumulators, each within the
    kernel's shared memory."""
    m = FlexibleNeRFModel(**_arch(hidden, num_layers=8, skip_connect_every=3,
                                  num_encoding_fn_xyz=10, num_encoding_fn_dir=4))
    plan = ftl.dw_plan(m)
    for u in plan:
        assert len(u.a) + len(u.b) <= ftl.DW_MAX_BOXES and len(u.blocks) <= ftl.DW_MAX_BLOCKS
        assert all(1 <= n <= 64 and 1 <= k <= 64 for *_, n, k in u.blocks)
    count, _ = ftl.dw_unit_map(m)
    offs, n_params = ftl._param_offsets(m)
    want = torch.zeros(n_params, dtype=torch.int32)
    H, dd = m.hidden_size, m.dim_dir
    for name, p in m.named_parameters():
        if name.endswith(".weight"):
            o = offs[name]
            if name == "layers_dir.0.weight":  # its feat columns
                want[o:o + p.numel()].view(p.shape)[:, :H] = 1
            else:
                want[o:o + p.numel()] = 1
    assert torch.equal(count, want)
    parts = ftl._cached_dw_parts(m, 132)
    assert sum(a.n_units for a, _ in parts) == len(plan) and len(parts) <= ftl.DW_MAX_PARTS
    for a, smem in parts:
        assert 1 <= a.n_units <= ftl.DW_MAX_UNITS and a.fresh == 1
        assert smem <= ftl.DW_SMEM_MAX
    assert ftl.bf16_hidden(hidden) > fr.NARROW_HIDDEN and fr.is_wide(m)


@pytest.mark.parametrize("hidden", [16, 100, 128])
def test_narrow_dw_plan_is_one_part(hidden):
    """Up to a padded width of 128 the plan is one launch of whole units
    (none split), without fresh accumulators, as before the wide route."""
    m = FlexibleNeRFModel(**_arch(hidden, num_layers=8, skip_connect_every=3,
                                  num_encoding_fn_xyz=10, num_encoding_fn_dir=4))
    plan = ftl.dw_plan(m)
    assert len(plan) == m.num_layers - 1 + 3  # layer1, each trunk layer, feat+alpha, dir+rgb
    (args, _), = ftl._cached_dw_parts(m, 132)
    assert args.fresh == 0 and args.n_units == len(plan) and not fr.is_wide(m)


def _cuda_int(source: str, name: str) -> int:
    """The value of ``constexpr int name = ...;`` in ops/csrc/``source``."""
    import re

    from dexnerf_tpu_torch.ops import _build

    with open(_build.CSRC / source) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, (source, name)
    return int(m.group(1))


@pytest.mark.parametrize("hp", list(range(160, fr.MAX_HIDDEN_BF16 + 1, 32)))
def test_wide_chain_plan_and_mask_words(hp):
    """The wide bf16 kernels' plan of 64-column blocks at every padded width
    160-576: the mirrors' constants are the CUDA sources' (the block, the
    ring's [64][64] stages, their counts, the consumers, the fresh
    accumulator's span); the chain's plan (its two tiles, the column sums
    and two products' mask words a consumer) fits, two consumers up to 320
    and one above, and so do the forward's (two layers' mask words) and the
    render kernel's at every S, each ring holding at least the bytes of the
    plan of [128][64] stages before it (16 KB stages, 2 to 8 of them);
    a thread's mask words of a tile cover each layer's columns (32 bits a
    64 of them; y's half as many), 34 at 8x256."""
    for name, value in (("kWideBlock", fr.WIDE_BLOCK), ("kWideSpan", fr.WIDE_SPAN),
                        ("kWideMaxStages", fr.WIDE_MAX_STAGES),
                        ("kWideMinStages", fr.WIDE_MIN_STAGES),
                        ("kWideMaxCons", fr.WIDE_MAX_CONS)):
        assert _cuda_int("mlp_wide_bf16.cuh", name) == value, name
    assert _cuda_int("mlp_tile_bf16.cuh", "kSmemMax") == fr.SHARED_BYTES_LIMIT
    assert fr.WIDE_STAGE == fr.WIDE_BLOCK * 128 and ftl.WIDE_BOX_ROWS == fr.WIDE_BLOCK

    def plan_128(cons_bytes):  # the plan of [128][64] stages
        for cons in (2, 1):
            for ns in range(8, 1, -1):
                total = 1024 + ns * (128 * 128 + 16) + cons * cons_bytes
                if total <= fr.SHARED_BYTES_LIMIT:
                    return cons, ns, total
        return None

    for kx, dd in ((1, 27), (2, 3 + 6 * fr.MAX_FREQ)):
        for S in (1, 64, 192, fr.MAX_SAMPLES):
            for kind, b in fr.wide_cons_bytes(hp, kx, dd, S).items():
                cons, ns, smem = fr.wide_plan(b)
                old = plan_128(b)
                assert smem == 1024 + ns * (fr.WIDE_STAGE + 16) + cons * b, (kind, S)
                assert smem <= fr.SHARED_BYTES_LIMIT and ns >= fr.WIDE_MIN_STAGES, (kind, S)
                assert cons == old[0] and ns * fr.WIDE_STAGE >= old[1] * 128 * 128, (kind, S)
    chain = fr.wide_plan(fr.wide_cons_bytes(hp, 2, 3 + 6 * fr.MAX_FREQ)["chain"])
    assert chain[0] == (2 if hp <= 320 else 1), hp
    nt = 7
    bits = [ftl.wide_mask_layout(w)[0].shape[1] for w in (hp, hp // 2)]
    assert 32 * ftl.wide_mask_words(hp, nt) == (nt + 1) * bits[0] + bits[1]
    assert ftl.wide_mask_words(256, 7) == 34


@pytest.mark.parametrize("hp", [160, 256, 320, 576])
def test_wide_mask_word_addressing(hp):
    """The bits of the wide route's mask words (``wide_mask_layout``, the
    C's ``wide_mask_bit``): every entry of a 64-row tile in exactly one bit;
    the forward's packing (``mask_flags``: each bf16 pair's (half & 0x7fff)
    + 0x7fff, its top bits shifted by j, or 8 + j for rows h = 1) sets the
    bit of the entry (j, h, e) of its 64-column group, and only where the
    bf16 half is > 0 (+-0 and every positive half, the bit patterns a ReLU
    leaves); the chain's products read bit (h ? 7 : 15) + 16 e - j of word
    c0 / 64 + j / 8 and its y-cotangent step bit (15 or 31) - (c % 64) / 8
    - 8 ((r % 16) / 8) of word 32 (r / 16) + 4 (r % 8) + (c % 8) / 2 of the
    column's group."""
    rows, cols = ftl.wide_mask_layout(hp)
    bit_of = {}
    for t in range(128):
        for i in range(rows.shape[1]):
            if int(cols[t, i]) < hp:
                bit_of[(int(rows[t, i]), int(cols[t, i]))] = ((i // 32) * 128 + t, i % 32)
    assert len(bit_of) == 64 * hp

    def flags(pair, j, h):  # mask_flags in ops/csrc/mlp_wide_bf16.cuh
        s = j + (8 if h else 0)
        return (((pair & 0x7FFF7FFF) + 0x7FFF7FFF) >> s) & (0x80008000 >> s) & 0xFFFFFFFF

    halves = [0x0000, 0x8000, 0x0001, 0x3F80, 0x7F80]  # +0, -0, the least, 1, inf
    for lo in halves:
        for hi in halves:
            for j in range(8):
                for h in range(2):
                    f = flags(lo | hi << 16, j, h)
                    want = [x not in (0x0000, 0x8000) for x in (lo, hi)]
                    b0 = (7 if h else 15) - j
                    assert f == (want[0] << b0) | (want[1] << (b0 + 16))
    for t in range(128):  # the products' epilogue, column blocks of WIDE_BLOCK (64)
        w, lane = t // 32, t % 32
        g, q = lane // 4, lane % 4
        for c0 in range(0, hp, fr.WIDE_BLOCK):
            for j in range(min(fr.WIDE_BLOCK, hp - c0) // 8):
                for h in range(2):
                    for e in range(2):
                        row, col = 16 * w + g + 8 * h, c0 + 8 * j + 2 * q + e
                        want = ((c0 // 64 + j // 8) * 128 + t, (7 if h else 15) + 16 * e - j % 8)
                        assert bit_of[(row, col)] == want
    y_rows, y_cols = ftl.wide_mask_layout(hp // 2)
    y_bit = {(int(y_rows[t, i]), int(y_cols[t, i])): ((i // 32) * 128 + t, i % 32)
             for t in range(128) for i in range(y_rows.shape[1]) if int(y_cols[t, i]) < hp // 2}
    for r in range(64):  # the y-cotangent step, a thread a column
        for c in range(hp // 2):
            word = (c // 64) * 128 + 32 * (r // 16) + 4 * (r % 8) + (c % 8) // 2
            bit = 15 + 16 * (c % 2) - (c % 64) // 8 - 8 * ((r % 16) // 8)
            assert y_bit[(r, c)] == (word, bit)


def test_max_hidden_bf16_is_the_largest_plan_that_fits():
    """MAX_HIDDEN_BF16 is reckoned from the wide kernels' shared-memory
    plans at the kernels' widest encodings (xyz up to 128 wide: two K-chunks;
    viewdirs at 16 frequencies: 99 wide): it fits, the next padded width
    does not; the f32 route's own reckoning gives MAX_HIDDEN
    (tests/test_torch_wide_f32.py)."""
    kx, dd = 2, 3 + 6 * fr.MAX_FREQ
    assert fr.MAX_HIDDEN_BF16 == 576 and fr.MAX_HIDDEN == 608
    assert fr.wide_fits(fr.MAX_HIDDEN_BF16, kx, dd)
    assert not fr.wide_fits(fr.MAX_HIDDEN_BF16 + 32, kx, dd)
    assert not fr.wide_fits(fr.MAX_HIDDEN_BF16 + 32, 1, 27)  # nor at the default PE
    # two consumer warpgroups up to 320, one above (fr.wide_plan)
    assert fr.wide_plan(fr.wide_cons_bytes(256, 1, 27)["forward"])[0] == 2
    assert fr.wide_plan(fr.wide_cons_bytes(512, 1, 27)["forward"])[0] == 1


@pytest.mark.parametrize("hidden,dtype,ok", [
    (1, F32, True), (20, F32, True), (100, F32, True), (128, F32, True), (129, F32, True),
    (256, F32, True), (fr.MAX_HIDDEN + 1, F32, False), (20, BF16, True), (100, BF16, True),
    (136, BF16, True), (576, BF16, True), (577, BF16, False)])
def test_width_contract(hidden, dtype, ok):
    """Every width up to MAX_HIDDEN at float32 and up to MAX_HIDDEN_BF16 at
    bfloat16 (no multiple-of-8 rule); the refusals above them name ROADMAP
    Queue 2 item 6c."""
    if ok:
        fr.check_width(hidden, dtype, "the kernel")
    else:
        with pytest.raises(ValueError, match="item 6c"):
            fr.check_width(hidden, dtype, "the kernel")
