"""The port's σ-isosurface export (``dexnerf_tpu_torch/utils/mesh.py``,
``dexnerf_tpu_torch/apps/mesh.py``) held to the JAX package on the CPU.

The marching-tetrahedra copy gives JAX's vertices and faces exactly on one
σ grid (the same numpy code), and its PLY JAX's bytes, read back. The two
``apps.mesh`` mains on one reference ``.ckpt`` evaluate σ on the corner
lattice to rtol 1e-5 / atol 1e-5 (f32 sums in another order,
``tests/test_torch_occupancy.py``), which moves each vertex by far less
than 1e-3 of a grid spacing but can tip the deduplication's quantization
(1e-4 of a spacing) of a vertex: every vertex of either mesh lies within
1e-3 of a spacing of one of the other's, and the counts agree to 0.1%.
"""

import numpy as np
import pytest
import yaml
from test_torch_depth import tiny_cfg

from dexnerf_tpu_torch.apps import mesh as mesh_app
from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
from dexnerf_tpu_torch.utils import mesh as pm


def _sigma(n=20, seed=0):
    """A sphere's σ (radius 0.6 at the center of [-1, 1]³) plus smooth
    noise: a closed surface with a few bumps."""
    lin = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    noise = np.random.default_rng(seed).normal(size=(n, n, n)).astype(np.float32)
    return (20.0 * (0.6 - r) + 2.0 * noise).astype(np.float32), 2.0 / (n - 1)


def _read_ply_mesh(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    nv = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    nf = int(next(l for l in lines if l.startswith("element face")).split()[-1])
    verts = np.array([[float(v) for v in l.split()] for l in lines[end + 1:end + 1 + nv]])
    faces = np.array([[int(v) for v in l.split()] for l in lines[end + 1 + nv:end + 1 + nv + nf]])
    assert (faces[:, 0] == 3).all()
    return verts.astype(np.float32), faces[:, 1:]


@pytest.mark.parametrize("iso", [0.0, 5.0, 100.0])
def test_marching_tetrahedra_matches_jax(iso):
    from dexnerf_tpu.utils.mesh import marching_tetrahedra as j_mt

    sigma, spacing = _sigma()
    kw = dict(origin=(-1.0, -1.0, -1.0), spacing=(spacing,) * 3)
    verts, faces = pm.marching_tetrahedra(sigma, iso, **kw)
    j_verts, j_faces = j_mt(sigma, iso, **kw)
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(faces, j_faces)
    if iso == 100.0:
        assert verts.shape == (0, 3) and faces.shape == (0, 3)
    else:
        assert verts.shape[0] > 100 and faces.max() < verts.shape[0]


def test_write_ply_mesh_matches_jax(tmp_path):
    from dexnerf_tpu.utils.mesh import write_ply_mesh as j_write

    verts, faces = pm.marching_tetrahedra(*_sigma()[:1], 0.0)
    pm.write_ply_mesh(str(tmp_path / "port.ply"), verts, faces)
    j_write(str(tmp_path / "jax.ply"), verts, faces)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back_v, back_f = _read_ply_mesh(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(back_v, verts, atol=1e-6)
    np.testing.assert_array_equal(back_f, faces)


def test_marching_tetrahedra_rejects_non_3d():
    with pytest.raises(ValueError, match="X, Y, Z"):
        pm.marching_tetrahedra(np.zeros((4, 4)), 0.0)


@pytest.fixture(scope="module")
def mesh_case(tmp_path_factory):
    """A config and a calibrated reference ``.ckpt`` (σ spread 20)."""
    from test_torch_eval import calibrated_checkpoint

    tmp = tmp_path_factory.mktemp("mesh")
    data = str(tmp / "data")
    write_blender_dataset(data, height=8, width=8, views_per_split=(1, 1, 1))
    raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp / "logs"))
    cfg_path, ckpt = str(tmp / "mesh.yml"), str(tmp / "model.ckpt")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    calibrated_checkpoint(raw, ckpt)
    return cfg_path, ckpt


def test_mesh_cli_matches_jax(mesh_case, tmp_path, capsys):
    """Both ``apps.mesh`` mains write a PLY of the same mesh."""
    from dexnerf_tpu.apps.mesh import main as j_main

    cfg_path, ckpt = mesh_case
    common = ["--config", cfg_path, "--checkpoint", ckpt, "--sigma-threshold", "5",
              "--resolution", "24", "--radius", "1.2", "--center", "0.1", "0", "-0.1",
              "--batch", "5000"]
    assert mesh_app.main([*common, "--out", str(tmp_path / "port.ply"), "--device", "cpu"]) == 0
    assert "vertices" in capsys.readouterr().out
    assert j_main([*common, "--out", str(tmp_path / "jax.ply"), "--platform", "cpu"]) == 0
    verts, faces = _read_ply_mesh(str(tmp_path / "port.ply"))
    j_verts, j_faces = _read_ply_mesh(str(tmp_path / "jax.ply"))
    assert verts.shape[0] > 100
    for a, b in ((verts, j_verts), (faces, j_faces)):
        assert abs(a.shape[0] - b.shape[0]) <= 1e-3 * b.shape[0]
    spacing = 2.4 / 23
    assert _farthest(verts, j_verts) <= 1e-3 * spacing
    assert _farthest(j_verts, verts) <= 1e-3 * spacing


def _farthest(a, b, chunk=512):
    """The largest distance from a point of ``a`` to its nearest in ``b``."""
    worst = 0.0
    for i in range(0, a.shape[0], chunk):
        d = ((a[i:i + chunk, None] - b[None]) ** 2).sum(-1).min(1)
        worst = max(worst, float(np.sqrt(d.max())))
    return worst


def test_mesh_cli_without_surface_exits_1(mesh_case, tmp_path, capsys):
    """An isovalue above every σ: no PLY, exit 1 and JAX's message."""
    from dexnerf_tpu.apps.mesh import main as j_main

    cfg_path, ckpt = mesh_case
    common = ["--config", cfg_path, "--checkpoint", ckpt, "--sigma-threshold", "1e6",
              "--resolution", "12"]
    capsys.readouterr()
    assert mesh_app.main([*common, "--out", str(tmp_path / "p.ply"), "--device", "cpu"]) == 1
    got = capsys.readouterr().out.splitlines()[-1]
    assert j_main([*common, "--out", str(tmp_path / "j.ply"), "--platform", "cpu"]) == 1
    want = capsys.readouterr().out.splitlines()[-1]
    assert got == want and got.startswith("no surface at σ = 1000000.0")
    assert not (tmp_path / "p.ply").exists()


def test_mesh_cli_needs_a_card_unless_told_cpu(mesh_case, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device evaluates there")
    cfg_path, ckpt = mesh_case
    with pytest.raises(SystemExit, match="no CUDA card"):
        mesh_app.main(["--config", cfg_path, "--checkpoint", ckpt, "--out",
                       str(tmp_path / "m.ply")])
