"""Kernels 2 and 3 at float32: the field forward and backward as launches of
kernel 4's split-TF32 kernels (``ops/csrc/fused_train_loss.cu``: prep and
forward with the launcher tag 2; prep, forward and chain with the tag 3 on
the caller's cotangent, then the split-TF32 weight gradients), driven by
``ops/fused_mlp.py`` and ``ops/fused_mlp_train.py`` through
``fused_train_loss.Tf32Pass``.

On the CPU: the argument block's mirror (``_TrainArgs``, with its ``pts``
field) against the C struct in the source; where the chain takes the
caller's cotangent (``fused_mlp_train.cotangent_columns``); and an
emulation of the route's arithmetic (the points padded to whole 64-sample
tiles at the origin; layer1 a sequential float32 FMA chain; every other
product in split TF32 per K-chunk of 32 into a fresh accumulator; the chain
on ``g`` with zeros on the padding columns; the per-ray dy sums and the dW
launch as the kernels order them: ``tests/test_torch_train_loss_tf32.py``'s
and ``tests/test_torch_dw_tf32.py``'s emulations) held to the JAX package's
float32 kernels 2 and 3 in interpret mode: raw at rtol 1e-4 / atol 1e-5,
every gradient leaf to 1e-4 of its own largest entry. The JAX package is
imported inside a fixture.

On a CUDA card (marker ``gpu``): both kernels against their plain versions
at widths 8-128 (4x16 with a skip), S from 7 to 300 (past kernel 4's cap of
256) and batches that do not divide into scratch chunks, the gradients
against float64 on the route's own ReLU decisions; bitwise repeats;
kernel 2's raw equal, bit for bit, to the raw of kernel 3's forward; the
chain's raw-cotangent rows equal to ``cotangent_columns``:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_mlp_tf32.py
"""

import copy
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.ops import _weight_grads as wgr
from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.ops import fused_train_loss as ftl
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from test_torch_dw_tf32 import emulate_dw
from test_torch_train_loss_tf32 import emulate_chain, emulate_forward, scratch_chunks

from perf_tools.field_f32_rule import (
    GPU_GRAD_FACTOR,
    GPU_GRAD_RTOL,
    MASK_RTOL,
    forward_on_masks,
    grads_on_masks,
    route_activations,
)

SOURCE = Path(ftl.__file__).resolve().parent / "csrc" / "fused_train_loss.cu"
NARROW = dict(num_layers=8, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)
FULL = dict(num_layers=8, hidden_size=128, skip_connect_every=3, num_encoding_fn_xyz=10,
            num_encoding_fn_dir=4)
ARCHS = {"8x16": NARROW, "8x48": dict(FULL, hidden_size=48)}
RTOL, ATOL = 1e-4, 1e-5  # raw: the f32 contract (phase 10 of chip_smoke.py)
GRAD_RTOL = 1e-4  # each leaf to 1e-4 of its own largest entry


# ---- the argument block and the cotangent's columns
_CTYPES = {"int": ctypes.c_int32, "long long": ctypes.c_int64, "float": ctypes.c_float}


def c_struct_fields(src: str, name: str):
    """(field, ctypes type) of ``struct name`` in a C++ source, in order:
    pointers as ``c_void_p``, arrays with their ``constexpr int`` lengths."""
    consts = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", src, re.M):  # at file scope
        for item in decl.split(","):
            k, v = item.split("=")
            consts[k.strip()] = eval(v, {}, dict(consts))  # noqa: S307 (the repository's source)
    body = re.search(r"struct %s \{\n(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(?:const )?(long long|int|float|uint32_t)(\*?) (.+);", line)
        assert m, line
        base, ptr, names = m.groups()
        for item in names.split(","):
            n = re.fullmatch(r"(\w+)(?:\[(\w+)\])?", item.strip())
            t = ctypes.c_void_p if ptr else _CTYPES[base]
            if n.group(2):
                t = t * consts[n.group(2)]
            fields.append((n.group(1), t))
    return fields


def _same_type(a, b) -> bool:
    if hasattr(a, "_length_") or hasattr(b, "_length_"):
        return (getattr(a, "_type_", None), getattr(a, "_length_", None)) == (
            getattr(b, "_type_", None), getattr(b, "_length_", None))
    return a is b


def test_train_args_mirror_matches_source():
    """``_TrainArgs`` is ``TrainArgs`` of ``fused_train_loss.cu`` field by
    field (name, type, array length), ``pts`` right after ``viewdirs``:
    the field kernels' points, which kernel 4 leaves null."""
    want = c_struct_fields(SOURCE.read_text(), "TrainArgs")
    got = ftl._TrainArgs._fields_
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), name
    names = [n for n, _ in got]
    assert names[names.index("viewdirs") + 1] == "pts"
    assert ctypes.sizeof(ftl._TrainArgs) == ctypes.sizeof(
        type("C", (ctypes.Structure,), {"_fields_": want}))


@pytest.mark.parametrize("n,s,ray0,rays", [(5, 7, 2, 3), (3, 64, 0, 3), (4, 100, 3, 1),
                                           (2, 300, 0, 2)])
def test_cotangent_columns(n, s, ray0, rays):
    """The chain's column r s_pad + s of a chunk holds g[ray0 + r, s] for s
    < S and 0 on the padding columns up to the 64-sample tile."""
    g = torch.arange(n * s * 4, dtype=torch.float32).reshape(n, s, 4) + 1.0
    s_pad = ftl.s_pad_of(s)
    assert s_pad % 64 == 0 and s <= s_pad < s + 64
    cols = fused_mlp_train.cotangent_columns(g, ray0, rays, s_pad)
    assert cols.shape == (rays * s_pad, 4)
    for r in range(rays):
        for c in range(s_pad):
            want = g[ray0 + r, c] if c < s else torch.zeros(4)
            assert torch.equal(cols[r * s_pad + c], want), (r, c)


# ---- the route's arithmetic, emulated, against JAX
def emulate_field(m, pts, viewdirs, g, chunk, grid):
    """(raw [N, S, 4], flat gradient) of the f32 field route on float32
    numpy ``pts`` [N, S, 3], ``viewdirs`` [N, 3] and cotangent ``g`` [N, S,
    4]: kernel 2's forward (kernel 3's recomputes the same), kernel 3's chain
    on ``g``'s columns and its dW over chunks of ``chunk`` rays on ``grid``
    CTAs."""
    N, S = pts.shape[:2]
    s_pad = ftl.s_pad_of(S)
    padded = np.zeros((N, s_pad, 3), np.float32)
    padded[:, :S] = pts  # padding samples at the origin, as the forward takes them
    enc = positional_encoding(torch.from_numpy(padded), m.num_encoding_fn_xyz,
                              m.include_input_xyz).reshape(N * s_pad, -1).numpy()
    view = positional_encoding(torch.from_numpy(viewdirs), m.num_encoding_fn_dir,
                               m.include_input_dir).numpy()
    fwd = emulate_forward(m, enc, view, s_pad)
    gc = fused_mlp_train.cotangent_columns(torch.from_numpy(g), 0, N, s_pad).numpy()
    bwd = emulate_chain(m, fwd, gc)
    return fwd["raw"][:, :S], emulate_dw(m, scratch_chunks(m, enc, view, fwd, bwd, gc, s_pad,
                                                           chunk), grid)


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = (1.5 * rng.normal(size=(n, s, 3))).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd, g


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.ops import make_fused_flexible_field, make_fused_flexible_field_train

    models = {}
    for name, arch in ARCHS.items():
        jm = JFlex(**arch)
        in_dim = encoding_dim(3, arch["num_encoding_fn_xyz"]) + encoding_dim(
            3, arch["num_encoding_fn_dir"])
        tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(len(models)),
                                              jnp.ones((1, in_dim))))
        m = FlexibleNeRFModel(**arch)
        m.load_state_dict(state_dict_from_flax(tree))
        fwd = make_fused_flexible_field(jm, compute_dtype=jnp.float32, interpret=True)
        train = make_fused_flexible_field_train(jm, compute_dtype=jnp.float32, interpret=True)
        models[name] = (tree, m, fwd, train)
    return jax, jnp, models


@pytest.mark.parametrize("s", [7, 64, 100])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_emulated_route_matches_jax_kernels_2_and_3(jx, arch, s):
    """The emulation against the JAX package's float32 kernel 2 (raw) and
    kernel 3 (the gradient of sum(g raw)) in interpret mode, on one set of
    weights and inputs, with the dW over 2 chunks on 5 CTAs: raw at rtol
    1e-4 / atol 1e-5; every leaf to 1e-4 of its largest entry (in the
    float64 plain version), and within 10 times the port's f32 plain
    version's own distance to float64 + 1e-5 of that scale."""
    jax, jnp, models = jx
    tree, m, j_fwd, j_train = models[arch]
    n = 4
    pts, vd, g = _inputs(n, s, seed=s)
    jp, jv = jnp.asarray(pts), jnp.asarray(vd)
    want_raw = np.asarray(j_fwd(tree, jp, jv))
    _, vjp = jax.vjp(lambda p: j_train(p, jp, jv), tree)
    (j_g,) = vjp(jnp.asarray(g))
    want = {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, j_g)).items()}
    raw, flat = emulate_field(m, pts, vd, g, chunk=3, grid=5)
    np.testing.assert_allclose(raw, want_raw, rtol=RTOL, atol=ATOL)
    t = [torch.tensor(a) for a in (pts, vd, g)]
    plain = fused_mlp_train.field_grads_reference(m, *t)
    m64 = copy.deepcopy(m).double()
    exact = fused_mlp_train.field_grads_reference(m64, *(a.double() for a in t))
    offs, _ = wgr._param_offsets(m)
    for (name, p), gp, ge in zip(m.named_parameters(), plain, exact):
        got = flat[offs[name]:offs[name] + p.numel()].reshape(p.shape).astype(np.float64)
        assert np.isfinite(got).all(), name
        ge = ge.numpy()
        scale = float(np.abs(ge).max())
        err = float(np.abs(got - want[name]).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
        own = float(np.abs(gp.double().numpy() - ge).max())
        assert float(np.abs(got - ge).max()) <= 10.0 * own + 1e-5 * scale, name


# ---- on the card: the route against the plain versions
CARD_ARCHS = {
    "4x16": dict(num_layers=4, hidden_size=16, skip_connect_every=2, num_encoding_fn_xyz=3,
                 num_encoding_fn_dir=2),
    "8x16": NARROW, "8x48": ARCHS["8x48"], "8x128": FULL,
    "8x8": dict(FULL, hidden_size=8), "8x24": dict(FULL, hidden_size=24),
}
CARD_RAYS, CARD_CHUNK = 301, 40  # 7 chunks of 40 rays and one of 21
# Gradients: the own-decision rule of perf_tools/field_f32_rule.py
# (GPU_GRAD_FACTOR, GPU_GRAD_RTOL, MASK_RTOL).


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


def check_mask_helpers(model, pts, viewdirs, g):
    """``forward_on_masks`` without masks is the plain version bit for bit,
    and ``grads_on_masks`` on the float64 model's own ReLU decisions is the
    float64 plain gradient (within 1e-12 of each leaf's largest entry): the
    copy of the model's forward that the rule uses as its reference is the
    model's."""
    raw, _ = forward_on_masks(model, pts, viewdirs)
    assert torch.equal(raw, fused_mlp.fused_field_reference(model, pts, viewdirs))
    m64 = copy.deepcopy(model).double()
    p64, v64, g64 = pts.double(), viewdirs.double(), g.double()
    with torch.no_grad():
        masks = [a > 0 for a in forward_on_masks(m64, p64, v64)[1]]
    want = fused_mlp_train.field_grads_reference(m64, p64, v64, g64)
    for (name, _), got, w in zip(model.named_parameters(),
                                 grads_on_masks(model, pts, viewdirs, g, masks), want):
        assert float((got - w).abs().max()) <= 1e-12 * float(w.abs().max()), name


@pytest.mark.parametrize("arch", ["4x16", "8x24"])
def test_mask_helpers_match_model(arch):
    """The masked copy of the forward against the model on the CPU (a skip
    layer in both)."""
    m = FlexibleNeRFModel(**CARD_ARCHS[arch]).reset_parameters(torch.Generator().manual_seed(3))
    check_mask_helpers(m, *(torch.tensor(a) for a in _inputs(5, 9, seed=3)))


def _assert_grads_on_card(model, pts, vd, g, kernel_grads):
    """Every leaf by the rule above, and the route's ReLU decisions against
    the plain version's (the route's from a second run of kernel 3, which
    repeats the first bit for bit)."""
    check_mask_helpers(model, pts, vd, g)
    plain = fused_mlp_train.field_grads_reference(model, pts, vd, g)
    with torch.no_grad():
        plain_acts = forward_on_masks(model, pts, vd)[1]
        route_acts = route_activations(model, pts, vd, g)
    for i, (ar, ap) in enumerate(zip(route_acts, plain_acts)):
        flip = (ar > 0) != (ap > 0)
        assert bool(((ar - ap)[flip].abs() <= MASK_RTOL * ap.abs().max()).all()), i
    exact_k = grads_on_masks(model, pts, vd, g, [a > 0 for a in route_acts])
    exact_p = grads_on_masks(model, pts, vd, g, [a > 0 for a in plain_acts])
    for (name, _), gk, gp, ek, ep in zip(model.named_parameters(), kernel_grads, plain, exact_k,
                                         exact_p):
        scale = float(ek.abs().max())
        err = float((gk.double() - ek).abs().max())
        err_plain = float((gp.double() - ep).abs().max())
        assert bool(torch.isfinite(gk).all()), name
        assert err <= GPU_GRAD_FACTOR * err_plain + GPU_GRAD_RTOL * scale, (
            name, err, err_plain, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [7, 64, 100, 128, 300])
@pytest.mark.parametrize("arch", list(CARD_ARCHS))
def test_route_matches_plain_on_card(cuda, monkeypatch, arch, s):
    """Through the training field (kernel 2 forward, kernel 3 backward,
    one launch each) on 301 rays in scratch chunks of 40: raw against the
    plain version at rtol 1e-4 / atol 1e-5, every leaf by the float64 rule
    on each version's own ReLU decisions (above); kernel 3 again gives the
    same gradients bit for bit."""
    monkeypatch.setattr(fused_mlp_train, "SCRATCH_SAMPLES", CARD_CHUNK * ftl.s_pad_of(s))
    m, pts, vd, g = _card_case(cuda, CARD_ARCHS[arch], CARD_RAYS, s)
    before = (fused_mlp.launches, fused_mlp.launches_bf16, fused_mlp_train.launches,
              fused_mlp_train.launches_bf16)
    raw = fused_mlp_train.fused_field_train(m, pts, vd)
    raw.backward(g)
    torch.cuda.synchronize()
    after = (fused_mlp.launches, fused_mlp.launches_bf16, fused_mlp_train.launches,
             fused_mlp_train.launches_bf16)
    assert after == (before[0] + 1, before[1], before[2] + 1, before[3])
    want = fused_mlp.fused_field_reference(m, pts, vd).detach()
    torch.testing.assert_close(raw.detach(), want, rtol=RTOL, atol=ATOL)
    grads = [p.grad.clone() for p in m.parameters()]
    _assert_grads_on_card(m, pts, vd, g, grads)
    again = fused_mlp_train._launch_backward(m, pts, vd, g, log_sampling_xyz=True,
                                             log_sampling_dir=True)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,s", [(136, 7), (256, 300), (fr.MAX_HIDDEN, 100)])
def test_wide_route_matches_plain_on_card(cuda, monkeypatch, hidden, s):
    """The same on the wide route (padded widths above 128), with S = 7 (a
    tile of mostly padding samples) and S = 300 (tiles across rays' ends),
    in scratch chunks of 40 rays: each launch counted by
    ``launches_wide_f32``."""
    monkeypatch.setattr(fused_mlp_train, "SCRATCH_SAMPLES", CARD_CHUNK * ftl.s_pad_of(s))
    m, pts, vd, g = _card_case(cuda, dict(FULL, hidden_size=hidden), 81, s)
    before = (fused_mlp.launches_wide_f32, fused_mlp_train.launches_wide_f32)
    raw = fused_mlp_train.fused_field_train(m, pts, vd)
    raw.backward(g)
    torch.cuda.synchronize()
    assert (fused_mlp.launches_wide_f32, fused_mlp_train.launches_wide_f32) == (
        before[0] + 1, before[1] + 1)
    want = fused_mlp.fused_field_reference(m, pts, vd).detach()
    torch.testing.assert_close(raw.detach(), want, rtol=RTOL, atol=ATOL)
    grads = [p.grad.clone() for p in m.parameters()]
    _assert_grads_on_card(m, pts, vd, g, grads)
    again = fused_mlp_train._launch_backward(m, pts, vd, g, log_sampling_xyz=True,
                                             log_sampling_dir=True)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("8x128", 100), ("8x16", 300), ("8x24", 7)])
def test_forward_raw_and_cotangent_rows_on_card(cuda, monkeypatch, arch, s):
    """Chunk by chunk of kernel 3's route: the raw its forward computes
    equals kernel 2's, bit for bit, and the chain's rgb and sigma
    cotangent rows of the scratch equal ``cotangent_columns`` of the
    caller's g (zeros on the padding columns)."""
    from dexnerf_tpu_torch.ops._build import load_library

    monkeypatch.setattr(fused_mlp_train, "SCRATCH_SAMPLES", CARD_CHUNK * ftl.s_pad_of(s))
    m, pts, vd, g = _card_case(cuda, CARD_ARCHS[arch], CARD_RAYS, s)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    raw2 = fused_mlp.fused_field(m, pts, vd)
    wg, ps = fused_mlp_train.tf32_backward_pass(load_library(), m, pts, vd, g, **kw)
    assert wg.n_chunks == -(-CARD_RAYS // CARD_CHUNK)
    R, s_pad = wg.rows, ps.s_pad
    stream = torch.cuda.current_stream().cuda_stream
    for c in range(wg.n_chunks):
        rays = ps.run(c, stream)
        torch.cuda.synchronize()
        ray0, k = c * ps.chunk, rays * s_pad
        raw3 = ps.raw[:4 * k].view(rays, s_pad, 4)[:, :s]
        assert torch.equal(raw3, raw2[ray0:ray0 + rays]), c
        dlt = wg.dlt[:R["dlt_rows"] * k].view(R["dlt_rows"], k)
        cols = fused_mlp_train.cotangent_columns(g, ray0, rays, s_pad)
        assert torch.equal(dlt[R["drgb"]:R["drgb"] + 3].T, cols[:, :3]), c
        assert torch.equal(dlt[R["dsig"]], cols[:, 3]), c
