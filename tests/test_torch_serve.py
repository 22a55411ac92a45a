"""The port's render/depth service (``dexnerf_tpu_torch/apps/serve.py``)
against the JAX service (``dexnerf_tpu/apps/serve.py``), both on the CPU
and both serving the same reference ``.ckpt``: every route's decoded
output is compared. Also: the port's PNG writers, and that importing the
port loads no JAX."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from dexnerf_tpu_torch.apps import serve
from dexnerf_tpu_torch.config import load_config
from dexnerf_tpu_torch.core.encoding import positional_encoding
from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
from dexnerf_tpu_torch.core.sampling import stratified_z_vals
from dexnerf_tpu_torch.data.blender import pose_spherical
from dexnerf_tpu_torch.ops import fused_render as fr
from dexnerf_tpu_torch.train.checkpoints import write_reference_checkpoint
from dexnerf_tpu_torch.train.loop import setup_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5
CONFIG = """
experiment: {id: serve, logdir: logs, randomseed: 1}
dataset: {type: blender, basedir: '', near: 2.0, far: 6.0, no_ndc: True}
models:
  coarse: {type: FlexibleNeRFModel, num_layers: 2, hidden_size: 16,
           num_encoding_fn_xyz: 2, num_encoding_fn_dir: 1}
  fine: {type: FlexibleNeRFModel, num_layers: 2, hidden_size: 16,
         num_encoding_fn_xyz: 2, num_encoding_fn_dir: 1}
nerf:
  use_viewdirs: True
  train: {num_random_rays: 16, chunksize: 64, perturb: True, num_coarse: 4,
          num_fine: 4, white_background: False, radiance_field_noise_std: 0.0}
  validation: {chunksize: 64, perturb: False, num_coarse: 4, num_fine: 4,
               white_background: False, radiance_field_noise_std: 0.0,
               lindisp: False, m_thres: 10}
"""
POSE = "theta=-30&phi=-45&radius=4"


def _seeded_checkpoint(cfg_path, ckpt_path):
    """Seeded weights whose σ head spreads the σ logit (std 8 over the
    default camera's coarse samples) so the Dex thresholds 5 and 10 are
    crossed on some rays and not on others."""
    cfg = load_config(cfg_path)
    coarse, fine = setup_models(cfg, 0, "cpu")
    ro, rd = get_ray_bundle_c2w(8, 8, 10.0, torch.tensor(pose_spherical(-30, -45, 4)))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    z = stratified_z_vals(torch.full((64,), 2.0), torch.full((64,), 6.0), 8)
    with torch.no_grad():
        for m in (coarse, fine):
            raw = m(
                positional_encoding(ro[:, None] + rd[:, None] * z[..., None], 2),
                positional_encoding(rd / rd.norm(dim=-1, keepdim=True), 1),
            )[..., 3]
            k = 8.0 / raw.std()
            m.fc_alpha.weight.mul_(k)
            m.fc_alpha.bias.copy_((m.fc_alpha.bias - raw.mean()) * k)
    write_reference_checkpoint(ckpt_path, coarse.state_dict(), fine.state_dict())


def _start(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from dexnerf_tpu.apps import serve as jserve

    tmp = tmp_path_factory.mktemp("serve_torch")
    cfg_path, ckpt = str(tmp / "config.yml"), str(tmp / "seeded.ckpt")
    with open(cfg_path, "w") as f:
        f.write(CONFIG)
    _seeded_checkpoint(cfg_path, ckpt)
    common = ["--config", cfg_path, "--checkpoint", ckpt, "--hwf", "8", "8", "10.0"]
    port_service = serve.build_service(serve.build_parser().parse_args(common + ["--device", "cpu"]))
    jax_service = jserve.build_service(jserve.build_parser().parse_args(common + ["--platform", "cpu"]))
    httpds = [serve.make_http_server(port_service, "127.0.0.1", 0),
              jserve.make_http_server(jax_service, "127.0.0.1", 0)]
    started = [_start(h) for h in httpds]
    yield started[0][0], started[1][0], port_service
    for h, (_, thread) in zip(httpds, started):
        h.shutdown()
        h.server_close()
        thread.join(timeout=30)


def _get(url, body=None):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _both(servers, path, body=None):
    port_base, jax_base, _ = servers
    a, b = _get(port_base + path, body), _get(jax_base + path, body)
    assert a[0] == b[0] == 200 and a[1] == b[1]
    return a[2], b[2]


def test_healthz(servers):
    a, b = (json.loads(x) for x in _both(servers, "/healthz"))
    for k in ("status", "height", "width", "focal", "num_coarse", "num_fine",
              "m_thres_cand", "depth_confidence"):
        assert a[k] == b[k], k
    assert a["m_thres_cand"] == [5.0, 10.0] and a["device"] == "cpu"


def test_depth_matches_jax(servers):
    a, b = (np.load(io.BytesIO(x)) for x in _both(servers, "/depth?" + POSE))
    assert a.shape == (8, 8) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [5, 6, 10])
def test_dex_depth_matches_jax(servers, m):
    a, b = (np.load(io.BytesIO(x)) for x in _both(servers, f"/depth?{POSE}&threshold={m}"))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 2.0) & (a <= 6.0)).all()


def test_dex_depth_both_branches(servers):
    """Across the two thresholds some pixels cross (depth past the first
    sample) and some do not, so the test above sees both branches."""
    port_base = servers[0]
    near_plane = []
    for m in (5, 10):
        d = np.load(io.BytesIO(_get(f"{port_base}/depth?{POSE}&threshold={m}")[2]))
        near_plane.append(d == 2.0)  # the first sample: no crossing past it
    share = np.mean(near_plane)
    assert 0.0 < share < 1.0


def test_depth_png_matches_jax(servers):
    a, b = _both(servers, f"/depth?{POSE}&threshold=10&format=png")
    ia, ib = Image.open(io.BytesIO(a)), Image.open(io.BytesIO(b))
    assert ia.mode == ib.mode and ia.size == ib.size == (8, 8)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


def test_render_png_matches_jax(servers):
    a, b = (np.asarray(Image.open(io.BytesIO(x))) for x in _both(servers, "/render?" + POSE))
    assert a.shape == (8, 8, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1  # 8-bit rounding


def test_confidence_matches_jax(servers):
    a, b = (np.load(io.BytesIO(x)) for x in _both(servers, f"/confidence?{POSE}&delta=0.5"))
    for k in ("depth", "confidence"):
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
    ga, gb = (np.asarray(Image.open(io.BytesIO(x)))
              for x in _both(servers, f"/confidence?{POSE}&delta=0.5&format=png"))
    assert ga.shape == (8, 8) and np.abs(ga.astype(int) - gb.astype(int)).max() <= 1


def test_post_render_matches_jax(servers):
    c2w = pose_spherical(10.0, -30.0, 4.0).tolist()
    a, b = _both(servers, "/render", json.dumps({"c2w": c2w, "output": "depth"}).encode())
    np.testing.assert_allclose(np.load(io.BytesIO(a)), np.load(io.BytesIO(b)), rtol=RTOL, atol=ATOL)
    a, b = _both(servers, "/render", json.dumps({"c2w": c2w}).encode())
    ia, ib = (np.asarray(Image.open(io.BytesIO(x))).astype(int) for x in (a, b))
    assert np.abs(ia - ib).max() <= 1


def test_cpu_frames_never_launch_the_kernel(servers):
    before = fr.launches
    _get(servers[0] + "/render?" + POSE)
    assert fr.launches == before


def test_errors(servers):
    port_base = servers[0]
    for path in ("/nope", f"/depth?{POSE}&format=bmp", f"/depth?{POSE}&threshold=abc"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port_base + path)
        assert e.value.code in (400, 404)
    with pytest.raises(urllib.error.HTTPError):
        _get(port_base + "/render", json.dumps({"c2w": [[1, 0], [0, 1]]}).encode())


def test_png_writers_decode_like_pil():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(-0.1, 1.1, size=(5, 7, 3)).astype(np.float32)
    got = np.asarray(Image.open(io.BytesIO(serve._png_bytes(rgb))))
    np.testing.assert_array_equal(got, np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
    gray = rng.uniform(0, 1, size=(4, 6))
    assert np.asarray(Image.open(io.BytesIO(serve._png_bytes(gray)))).shape == (4, 6)
    depth = np.array([[0.0, 0.0015, 2.5], [65.535, 65.536, 1e4]], np.float32)
    want = io.BytesIO()
    Image.fromarray((depth * 1000.0).astype(np.uint32).astype(np.int32), mode="I").save(
        want, format="PNG"
    )
    a = Image.open(io.BytesIO(serve._depth_png_bytes(depth)))
    b = Image.open(want)
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dexnerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(dexnerf_tpu_torch.__path__, 'dexnerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import dexnerf_tpu_torch.apps.serve\n"
        "for name in ('data.messytable', 'apps.eval', 'data.llff', 'utils', 'utils.images',\n"
        "             'utils.pointcloud', 'render.occupancy', 'utils.mesh', 'apps.mesh',\n"
        "             'apps.tiny', 'models.mlp', 'models.registry', 'train.step',\n"
        "             'apps.cache', 'core.lie', 'train.pose_opt', 'data.resize',\n"
        "             'ops.host_rows', 'models.sg', 'render.sg_ir', 'parallel.mesh',\n"
        "             'parallel.sharding', 'parallel.multiscene', 'parallel.multihost',\n"
        "             'apps.multiscene'):\n"
        "    assert 'dexnerf_tpu_torch.' + name in sys.modules, name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dexnerf_tpu', 'cv2', 'imageio', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
