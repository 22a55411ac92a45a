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


def _resample_case(n=N, sc=SC, sf=SF, seed=0):
    """Sorted coarse depths, |weights| with a zero-mass ray (3) and a
    near-delta ray (5), direction norms, and perturbed draws."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(2, 6, (n, sc)).astype(np.float32), axis=1)
    w = np.abs(rng.randn(n, sc)).astype(np.float32)
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
    if near_delta_ok:
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


def _pdf_case(b=16, m=30, n=16, seed=3):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(2, 6, (b, m + 1)).astype(np.float32), axis=1)
    w = np.abs(rng.randn(b, m)).astype(np.float32)
    w[1] = 0.0  # zero mass: the +1e-5 guard
    w[PDF_DELTA_ROW] = 0.0
    w[PDF_DELTA_ROW, 7] = 100.0  # near-delta
    u = rng.uniform(size=(b, n)).astype(np.float32)
    return bins, w, u


def _check_pdf(got, want, det, share=1.0):
    """Within PDF_ATOL (on ``share`` of the entries); on the deterministic
    grid the near-delta row meets the u == 1.0 tie (see above): there >=
    DELTA_SHARE of its entries."""
    rows = np.ones(got.shape[0], bool)
    if det:
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


@pytest.mark.gpu
@pytest.mark.parametrize("det", [False, True], ids=["perturbed", "det"])
@pytest.mark.parametrize("shape", [(N, SC, SF), (8192, 64, 64), (37, 64, 128)])
def test_resample_kernel_matches_plain_on_card(cuda, shape, det):
    n, sc, sf = shape
    z, w, dn, u = (torch.tensor(a, device=cuda) for a in _resample_case(n, sc, sf, seed=n))
    if det:
        u = _det_grid(n, sf, cuda)
    before = resample.launches
    got = resample.fused_resample(z, w, u, dn)
    torch.cuda.synchronize()
    assert resample.launches == before + 1
    want = resample.fused_resample_reference(z, w, u, dn)
    _check_rows(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(),
                want[1].cpu().numpy(), near_delta_ok=det, share=CARD_SHARE)


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
