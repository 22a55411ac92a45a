"""The tiny-NeRF pipeline of the port (``dexnerf_tpu_torch/apps/tiny.py``)
on the CPU: ``VeryTinyNeRFModel`` trained coarse-only (no fine model, no
fine samples) held to the JAX tiny pipeline's step and render on shared
weights and draws, and the entry point end to end with ``--device cpu``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexnerf_tpu_torch.apps import tiny as tiny_app
from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import make_synthetic_scene
from dexnerf_tpu_torch.models import VeryTinyNeRFModel
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings, render_image
from dexnerf_tpu_torch.train.checkpoints import state_dict_from_flax
from dexnerf_tpu_torch.train.step import StepDraws, init_train_state, make_train_step

ENC = 6  # the tiny pipeline's frequencies, xyz and viewdirs
SETTINGS = RenderSettings(num_coarse=8, num_fine=0, perturb=True, num_encoding_fn_xyz=ENC,
                          num_encoding_fn_dir=ENC)
BATCH, STEPS, LR = 32, 3, 5e-3
# f32 both sides, sums in another order; Adam's first update ~lr * sign(g)
# (as tests/test_torch_train_step.py): parameters to PARAM_ATOL after three
# updates, the render to RTOL/ATOL
PARAM_ATOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model and its tree (initialized as its app does: packed
    input of width 78), and a small synthetic scene."""
    from dexnerf_tpu.models import VeryTinyNeRFModel as JTiny

    jm = JTiny(num_encoding_functions=ENC, filter_size=16)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.ones((1, 78))))
    # σ (layer3's last output) spread: at random init it is ≤ 0 everywhere,
    # an empty scene
    tree["params"]["Dense_2"]["kernel"][:, 3] *= 10.0
    tree["params"]["Dense_2"]["bias"][3] += 1.0
    images, _, poses, hwf = make_synthetic_scene(num_views=3, height=6, width=6,
                                                 num_gt_samples=16)
    return jm, tree, images, poses, hwf


def _port_model(tree):
    tm = VeryTinyNeRFModel(filter_size=16, num_encoding_functions=ENC)
    tm.load_state_dict(state_dict_from_flax(tree, tm))
    return tm


def _draws(key, num_rays):
    """The JAX step's draws: ``k_sample, k_render = split(key)``, the ray
    indices from ``k_sample``, the stratified jitter from the first of
    ``render_rays``' four keys (no σ-noise, no fine pass)."""
    k_sample, k_render = jax.random.split(key)
    idx = jax.random.randint(k_sample, (BATCH,), 0, num_rays)
    k_strat = jax.random.split(k_render, 4)[0]
    t_strat = jax.random.uniform(k_strat, (BATCH, SETTINGS.num_coarse), dtype=jnp.float32)
    return StepDraws(torch.tensor(np.asarray(idx)).to(torch.int64),
                     RenderDraws(torch.tensor(np.asarray(t_strat)), None, None, None))


def test_coarse_only_steps_match_jax(tiny):
    """Three Adam updates of the coarse-only state (``make_train_step``
    with no fine model), as JAX's tiny app takes them."""
    from dexnerf_tpu.data import build_ray_store as j_build
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.train import init_train_state as j_init
    from dexnerf_tpu.train import make_optimizer as j_optimizer
    from dexnerf_tpu.train import make_train_step as j_make_step

    jm, tree, images, poses, hwf = tiny
    tm = _port_model(tree)
    keys = list(jax.random.split(jax.random.PRNGKey(3), STEPS))
    tx = j_optimizer(LR, lr_decay=250, lr_decay_factor=0.1)
    j_step = j_make_step(jm.apply, None, tx, JSettings(**SETTINGS.__dict__), BATCH)
    j_state = j_init({"coarse": jax.tree.map(jnp.asarray, tree)}, tx)
    for key in keys:
        j_state, j_metrics = j_step(j_state, j_build(images, poses, hwf, 2.0, 6.0), key)

    store = build_ray_store(images, poses, hwf, 2.0, 6.0, device="cpu")
    state = init_train_state(tm, None, LR, lr_decay=250, lr_decay_factor=0.1)
    step = make_train_step(SETTINGS, BATCH, steps_per_call=STEPS)
    metrics = step(state, store, draws=[_draws(k, store.num_rays) for k in keys])
    assert state.step == STEPS and state.fine is None
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    assert float(metrics["fine_loss"]) == 0.0
    want = state_dict_from_flax(jax.tree.map(np.asarray, j_state.params["coarse"]), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_coarse_only_render_matches_jax(tiny):
    from dexnerf_tpu.core.rays import get_ray_bundle_c2w as j_bundle
    from dexnerf_tpu.render import RenderSettings as JSettings
    from dexnerf_tpu.render import render_image as j_render_image

    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w

    jm, tree, images, poses, hwf = tiny
    tm = _port_model(tree)
    s = SETTINGS.eval_variant()
    H, W, focal = hwf
    want = j_render_image(jm.apply, None, {"coarse": tree},
                          *j_bundle(H, W, focal, jnp.asarray(poses[-1])), 2.0, 6.0,
                          JSettings(**s.__dict__))
    with torch.no_grad():
        got = render_image(tm, None, *get_ray_bundle_c2w(H, W, focal, torch.tensor(poses[-1])),
                           2.0, 6.0, s)
    assert got.fine is None and want.fine is None
    assert float(got.coarse.accumulation.max()) > 0.5  # a scene with matter
    for field in ("rgb", "depth", "accumulation"):
        np.testing.assert_allclose(getattr(got.coarse, field).numpy(),
                                   np.asarray(getattr(want.coarse, field)), rtol=RTOL, atol=ATOL,
                                   err_msg=field)


def test_tiny_cli_on_cpu(tmp_path):
    """``apps.tiny`` with ``--device cpu`` on the synthetic 64x64 scene: the
    loss falls, the hold-out PSNR rises, and the renders, ``psnr.txt`` and
    (where matplotlib imports) the snapshots are written."""
    out = str(tmp_path / "tiny")
    assert tiny_app.main(["--device", "cpu", "--iters", "25", "--batch-rays", "256",
                          "--num-samples", "16", "--display-every", "8", "--outdir", out]) == 0
    psnr = np.loadtxt(os.path.join(out, "psnr.txt"))
    assert psnr[:, 0].tolist() == [0, 8, 16, 24]
    assert psnr[-1, 1] > psnr[0, 1] + 1.0
    files = set(os.listdir(out))
    assert {f"render_{i:05d}.png" for i in (0, 8, 16, 24)} <= files
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert {f"snapshot_{i:05d}.png" for i in (0, 8, 16, 24)} <= files


def test_tiny_cli_npz_data(tmp_path):
    """``--data`` takes the classic npz (images, poses, focal)."""
    images, _, poses, hwf = make_synthetic_scene(num_views=3, height=8, width=8,
                                                 num_gt_samples=16)
    path = str(tmp_path / "tiny_nerf_data.npz")
    np.savez(path, images=images, poses=poses, focal=np.float32(hwf[2]))
    out = str(tmp_path / "out")
    assert tiny_app.main(["--device", "cpu", "--data", path, "--iters", "2", "--batch-rays",
                          "16", "--num-samples", "8", "--outdir", out]) == 0
    assert np.loadtxt(os.path.join(out, "psnr.txt")).shape == (2, 2)


def test_tiny_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device trains there")
    with pytest.raises(SystemExit):
        tiny_app.main(["--iters", "1", "--outdir", str(tmp_path)])
