"""The resample kernels of the port: ``ops/resample.py`` (kernel 5, the
hierarchical resample between the passes) and ``ops/sample_pdf.py``
(kernel 6, the inverse-CDF op).

On the CPU: the plain versions held to the JAX package's
``make_fused_resample`` and ``sample_pdf_pallas`` / ``sample_pdf_branchless``
in interpret mode, on the cases of ``tests/test_ops.py``: perturbed draws,
the deterministic grid, zero-weight rays, a near-delta ray and ray counts
that need padding in JAX. On a CUDA card (marker ``gpu``): the CUDA kernels
held to the plain versions on the same cases and at the train step's size.
The JAX package is imported inside a fixture, so that this file also runs
where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_resample.py
"""

import types

import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.core.sampling import linspace
from dexnerf_tpu_torch.ops import resample, sample_pdf

# the JAX test's tolerances (tests/test_ops.py::test_fused_resample_matches_xla):
# merged depths to 1e-5, intervals to 1e-4 (x |d|, last 1e10 |d|); the
# near-delta ray on the deterministic grid meets the u == 1.0 == cdf[-1]
# tie: the last ulp of the CDF's tail depends on the order of the
# cumulative sum (0.99999994 in torch's, 1.0 in JAX's for this ray), so
# that one fine depth may land in another bin, which also shifts the
# merged positions between the two; there >= 90% of the ray's merged
# depths must have a counterpart within 1e-5 in the other row. sample_pdf
# to 1e-4 (test_ops.py:66-115)
Z_ATOL, D_ATOL = 1e-5, 1e-4
DELTA_SHARE = 0.9
PDF_ATOL = 1e-4
# On the card, kernel vs plain at the train step's size (8192 rays): a few
# draws fall within an ulp of a CDF entry, where the kernel's scan and
# torch's cumsum round the last bit apart and the 1e-5 denominator guard
# switches; the rule of chip_smoke.py: >= 99.99% of entries within the
# tolerances above, every row sorted, nothing non-finite
CARD_SHARE = 0.9999
SC, SF, N = 16, 8, 21  # 21 rays: not a multiple of JAX's block of 16
ZERO_RAY, DELTA_RAY = 3, 5
PDF_DELTA_ROW = 2


def _resample_case(n=N, sc=SC, sf=SF, seed=0, floor=0.0):
    """Sorted coarse depths, weights floor + |N(0, 1)| with a zero-mass ray
    (3) and a near-delta ray (5) where there are that many rays, direction
    norms, and perturbed draws."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(2, 6, (n, sc)).astype(np.float32), axis=1)
    w = (floor + np.abs(rng.randn(n, sc))).astype(np.float32)
    if n > DELTA_RAY:
        w[ZERO_RAY] = 0.0
        w[DELTA_RAY] = 0.0
        w[DELTA_RAY, 2] = 100.0
    dirs = rng.randn(n, 3).astype(np.float32)
    dn = np.linalg.norm(dirs, axis=-1, keepdims=True).astype(np.float32)
    u = rng.uniform(size=(n, sf)).astype(np.float32)
    return z, w, dn, u


def _det_grid(n, sf, device="cpu"):
    return linspace(0.0, 1.0, sf, device=device).expand(n, sf).contiguous()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dexnerf_tpu.ops.resample_pallas import make_fused_resample
    from dexnerf_tpu.ops.sample_pdf_pallas import sample_pdf_branchless, sample_pdf_pallas

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, make_fused_resample=make_fused_resample,
        sample_pdf_pallas=sample_pdf_pallas, sample_pdf_branchless=sample_pdf_branchless,
    )


def _check_rows(z, d, z_ref, d_ref, near_delta_ok, share=1.0):
    smooth = np.ones(z.shape[0], bool)
    if near_delta_ok and z.shape[0] > DELTA_RAY:
        smooth[DELTA_RAY] = False
        near = np.abs(z[DELTA_RAY][:, None] - z_ref[DELTA_RAY][None, :]) < Z_ATOL
        assert np.mean(near.any(axis=1)) >= DELTA_SHARE
    for a, b, atol in ((z, z_ref, Z_ATOL), (d, d_ref, D_ATOL)):
        if share == 1.0:
            np.testing.assert_allclose(a[smooth], b[smooth], rtol=0, atol=atol)
        else:
            assert np.mean(np.abs(a[smooth] - b[smooth]) <= atol) >= share
    assert np.all(np.diff(z, axis=1) >= 0) and np.isfinite(z).all() and np.isfinite(d).all()


@pytest.mark.parametrize("det", [False, True], ids=["perturbed", "det"])
def test_resample_matches_jax(jx, det):
    z, w, dn, u = _resample_case()
    u_t = _det_grid(N, SF) if det else torch.tensor(u)
    rs = jx.make_fused_resample(SC, SF, block_rays=16, interpret=True)
    jz, jd = (np.asarray(a) for a in rs(*(jx.jnp.asarray(a) for a in (z, w, u_t.numpy(), dn))))
    launches = resample.launches
    gz, gd = resample.make_fused_resample(SC, SF)(
        torch.tensor(z), torch.tensor(w), u_t, torch.tensor(dn))
    assert resample.launches == launches  # CPU tensors never reach the kernel
    assert gz.shape == gd.shape == (N, SC + SF)
    _check_rows(gz.numpy(), gd.numpy(), jz, jd, near_delta_ok=det)


def test_resample_rejects_other_counts():
    z, w, dn, u = (torch.tensor(a) for a in _resample_case())
    with pytest.raises(ValueError, match="built for"):
        resample.make_fused_resample(SC, SF + 1)(z, w, u, dn)


def _pdf_case(b=16, m=30, n=16, seed=3, floor=0.0):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(2, 6, (b, m + 1)).astype(np.float32), axis=1)
    w = (floor + np.abs(rng.randn(b, m))).astype(np.float32)
    if b > PDF_DELTA_ROW:
        w[1] = 0.0  # zero mass: the +1e-5 guard
        w[PDF_DELTA_ROW] = 0.0
        w[PDF_DELTA_ROW, min(7, m - 1)] = 100.0  # near-delta
    u = rng.uniform(size=(b, n)).astype(np.float32)
    return bins, w, u


def _check_pdf(got, want, det, share=1.0):
    """Within PDF_ATOL (on ``share`` of the entries); on the deterministic
    grid the near-delta row meets the u == 1.0 tie (see above): there >=
    DELTA_SHARE of its entries."""
    rows = np.ones(got.shape[0], bool)
    if det and got.shape[0] > PDF_DELTA_ROW:
        rows[PDF_DELTA_ROW] = False
        assert np.mean(np.abs(got[PDF_DELTA_ROW] - want[PDF_DELTA_ROW]) < PDF_ATOL) >= DELTA_SHARE
    if share == 1.0:
        np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=PDF_ATOL)
    else:
        assert np.mean(np.abs(got[rows] - want[rows]) <= PDF_ATOL) >= share
    assert np.isfinite(got).all()


def test_sample_pdf_matches_jax(jx):
    bins, w, u = _pdf_case()
    want = np.asarray(jx.sample_pdf_pallas(*(jx.jnp.asarray(a) for a in (bins, w, u)),
                                           block_rays=8, interpret=True))
    launches = sample_pdf.launches
    got = sample_pdf.sample_pdf_pallas(torch.tensor(bins), torch.tensor(w), torch.tensor(u))
    assert sample_pdf.launches == launches
    _check_pdf(got.numpy(), want, det=False)


def test_sample_pdf_branchless_det_matches_jax(jx):
    """The deterministic grid, u == 1.0 included (the "none above" branch)."""
    bins, w, _ = _pdf_case(b=8, m=30, n=16)
    want = np.asarray(jx.sample_pdf_branchless(
        jx.jnp.asarray(bins), jx.jnp.asarray(w), 16, det=True, use_pallas=True, interpret=True))
    got = sample_pdf.sample_pdf_branchless(torch.tensor(bins), torch.tensor(w), 16, det=True)
    _check_pdf(got.numpy(), want, det=True)
    with pytest.raises(ValueError, match="draws"):
        sample_pdf.sample_pdf_branchless(torch.tensor(bins), torch.tensor(w), 16, det=False)


# ---- on the card: the CUDA kernels vs their plain versions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hold_resample_on_card(cuda, z, w, dn, u, det):
    z, w, dn, u = (torch.as_tensor(a, device=cuda).contiguous() for a in (z, w, dn, u))
    before = resample.launches
    got = resample.fused_resample(z, w, u, dn)
    torch.cuda.synchronize()
    assert resample.launches == before + 1
    want = resample.fused_resample_reference(z, w, u, dn)
    _check_rows(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                want[1].cpu().numpy(), near_delta_ok=det, share=CARD_SHARE)


@pytest.mark.gpu
@pytest.mark.parametrize("det", [False, True], ids=["perturbed", "det"])
@pytest.mark.parametrize("shape", [(N, SC, SF), (8192, 64, 64), (37, 64, 128)])
def test_resample_kernel_matches_plain_on_card(cuda, shape, det):
    n, sc, sf = shape
    z, w, dn, u = _resample_case(n, sc, sf, seed=n)
    if det:
        u = _det_grid(n, sf)
    _hold_resample_on_card(cuda, z, w, dn, u, det)


@pytest.mark.gpu
@pytest.mark.parametrize("det", [False, True], ids=["random", "det"])
@pytest.mark.parametrize("shape", [(16, 30, 16), (8192, 62, 64)])
def test_sample_pdf_kernel_matches_plain_on_card(cuda, shape, det):
    b, m, n = shape
    bins, w, u = (torch.tensor(a, device=cuda) for a in _pdf_case(b, m, n))
    before = sample_pdf.launches
    if det:
        got = sample_pdf.sample_pdf_branchless(bins, w, n, det=True)
        u = _det_grid(b, n, cuda)
    else:
        got = sample_pdf.sample_pdf_pallas(bins, w, u)
    torch.cuda.synchronize()
    assert sample_pdf.launches == before + 1
    want = sample_pdf.sample_pdf_reference(bins, w, u)
    _check_pdf(got.cpu().numpy(), want.cpu().numpy(), det, share=CARD_SHARE)


# Cases where a redesign of the searches or of the merge would break, held
# by the rules above: ray counts 1, 37 and 65536; counts that are not
# multiples of 32 or of 4; the widest rows (256 + 256 samples, 512 bins).
# Their weights (but the zero and near-delta rays') are 0.1 + |N(0, 1)|: the
# kernels sum the CDF in another order than torch's cumsum, and where a
# bin's probability is ~1e-4 one ulp of the CDF moves a depth by ~1e-5, so
# that at a few dozen rays one such draw would exhaust CARD_SHARE, which
# counts on thousands of rays; with no probability below ~1e-3 an ulp moves
# a depth by ~1e-6 and the rules hold the searches and the merge, not the
# order of a sum.
FLOOR = 0.1
RESAMPLE_SHAPES = [(1, 64, 64), (37, 37, 45), (37, 5, 3), (37, 33, 1), (37, 62, 30),
                   (65536, 64, 64), (64, 256, 256)]
PDF_SHAPES = [(1, 62, 64), (37, 29, 45), (37, 1, 3), (37, 30, 1), (65536, 62, 64),
              (64, 511, 256)]
# (kind, rays): the near-delta case at 2048 rays, so that some of its
# rays' scans come out of order and the kernels' suffix minimum runs
KINDS = [("near_delta", 2048), ("zero_weights", 37), ("equal_depths", 37),
         ("repeated_draws", 37), ("cdf_entries", 37)]


def _edge_case(kind, n, sc=64, sf=64, seed=11):
    """A resample case of ``kind`` (weights as in :data:`FLOOR`): every
    third ray near-delta (one weight of 1-1000 at a random place, the rest
    0); every weight 0; all coarse depths of a ray equal (JAX's padding
    rows: z = 1.0, zero weights on half of them); draws repeated (eight
    values, 0.0 among them); or each draw exactly a CDF entry."""
    z, w, dn, u = _resample_case(n, sc, sf, seed=seed, floor=FLOOR)
    rng = np.random.RandomState(seed + 1)
    if kind == "near_delta":
        rows = np.arange(0, n, 3)
        w[rows] = 0.0
        w[rows, rng.randint(1, sc - 1, rows.size)] = 10 ** rng.uniform(0, 3, rows.size)
    elif kind == "zero_weights":
        w[:] = 0.0
    elif kind == "equal_depths":
        z[:] = 1.0
        w[::2] = 0.0
    elif kind == "repeated_draws":
        u = np.floor(u * 8).astype(np.float32) / 8
    elif kind == "cdf_entries":
        from dexnerf_tpu_torch.core.sampling import weights_to_cdf

        # weights 256 k (k >= 1, summing to 256 over weights[1:-1]): w + 1e-5
        # rounds to w, every PDF entry is k / 256 and every partial sum is
        # exact, so the kernels' CDF and the plain version's have the same
        # bits and each draw sits exactly on an entry of both (0.0 and 1.0
        # among them)
        m = sc - 2
        k = 1 + np.stack([rng.multinomial(256 - m, np.full(m, 1.0 / m)) for _ in range(n)])
        w[:, 1:-1] = 256.0 * k
        cdf = weights_to_cdf(torch.tensor(w[:, 1:-1])).numpy()
        u = np.take_along_axis(cdf, rng.randint(0, m + 1, (n, sf)), axis=1)
    return z, w, dn, u


@pytest.mark.gpu
@pytest.mark.parametrize("det", [False, True], ids=["perturbed", "det"])
@pytest.mark.parametrize("shape", RESAMPLE_SHAPES)
def test_resample_kernel_shapes_on_card(cuda, shape, det):
    n, sc, sf = shape
    z, w, dn, u = _resample_case(n, sc, sf, seed=n + sc, floor=FLOOR)
    if det:
        u = _det_grid(n, sf)
    _hold_resample_on_card(cuda, z, w, dn, u, det)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS, ids=[k for k, _ in KINDS])
def test_resample_kernel_edge_cases_on_card(cuda, kind):
    _hold_resample_on_card(cuda, *_edge_case(*kind), det=False)


def _hold_pdf_on_card(cuda, bins, w, u, det):
    bins, w, u = (torch.as_tensor(a, device=cuda).contiguous() for a in (bins, w, u))
    before = sample_pdf.launches
    got = sample_pdf.sample_pdf_pallas(bins, w, u)
    torch.cuda.synchronize()
    assert sample_pdf.launches == before + 1
    want = sample_pdf.sample_pdf_reference(bins, w, u)
    _check_pdf(got.cpu().numpy(), want.cpu().numpy(), det, share=CARD_SHARE)


@pytest.mark.gpu
@pytest.mark.parametrize("det", [False, True], ids=["random", "det"])
@pytest.mark.parametrize("shape", PDF_SHAPES)
def test_sample_pdf_kernel_shapes_on_card(cuda, shape, det):
    b, m, n = shape
    bins, w, u = _pdf_case(b, m, n, seed=b + m, floor=FLOOR)
    if det:
        u = _det_grid(b, n)
    _hold_pdf_on_card(cuda, bins, w, u, det)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS, ids=[k for k, _ in KINDS])
def test_sample_pdf_kernel_edge_cases_on_card(cuda, kind):
    """Kernel 5's cases on kernel 6's contract: the coarse midpoints as
    bins, weights[1:-1], the same draws."""
    z, w, _, u = _edge_case(*kind)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    _hold_pdf_on_card(cuda, bins, w[:, 1:-1], u, det=False)
