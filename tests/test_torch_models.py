"""Parity of the port's FlexibleNeRF and checkpoint interchange with the
JAX package: one flax param tree, converted with ``state_dict_from_flax``,
drives both forwards; ``.ckpt`` files written by either package load in
the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexnerf_tpu.core.encoding import encoding_dim
from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
from dexnerf_tpu.train.checkpoints import export_torch_checkpoint, import_torch_checkpoint
from dexnerf_tpu.train.checkpoints import infer_flexible_arch as j_infer
from dexnerf_tpu_torch.config import CfgNode, model_from_cfg
from dexnerf_tpu_torch.models import FlexibleNeRFModel, build_model
from dexnerf_tpu_torch.train.checkpoints import (
    infer_flexible_arch,
    read_reference_checkpoint,
    state_dict_from_flax,
    write_reference_checkpoint,
)
from dexnerf_tpu_torch.train.loop import align_cfg_models_to_checkpoint

# (num_layers, hidden, skip_every, pe_xyz, pe_dir): small, and the full
# messytable width on a few points
ARCHS = [(3, 32, 4, 3, 2), (8, 128, 3, 10, 4), (6, 16, 2, 2, 1)]
RTOL, ATOL = 1e-5, 1e-5


def _pair(arch, seed=0):
    L, H, skip, fx, fd = arch
    kw = dict(num_layers=L, hidden_size=H, skip_connect_every=skip,
              num_encoding_fn_xyz=fx, num_encoding_fn_dir=fd)
    jm = JFlex(**kw)
    in_dim = encoding_dim(3, fx) + encoding_dim(3, fd)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.ones((1, in_dim))))
    tm = FlexibleNeRFModel(**kw)
    tm.load_state_dict(state_dict_from_flax(tree))
    return jm, tree, tm


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: "x".join(map(str, a)))
def test_forward_matches_flax(arch):
    jm, tree, tm = _pair(arch)
    L, H, skip, fx, fd = arch
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(5, 7, encoding_dim(3, fx))).astype(np.float32)
    view = rng.normal(size=(5, encoding_dim(3, fd))).astype(np.float32)
    want = np.asarray(jm.apply(tree, (jnp.asarray(xyz), jnp.asarray(view))))
    with torch.no_grad():
        got = tm(torch.tensor(xyz), torch.tensor(view)).numpy()
    assert got.shape == (5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        x.size for x in jax.tree.leaves(tree)
    )


def test_full_width_parameter_count():
    tm = FlexibleNeRFModel(num_layers=8, hidden_size=128, skip_connect_every=3,
                           num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    assert sum(p.numel() for p in tm.parameters()) == 158660
    assert tm.skips == {3}
    assert tm.layers_xyz[3].in_features == 128 + 63


@pytest.mark.parametrize("arch", ARCHS[:2], ids=lambda a: "x".join(map(str, a)))
def test_jax_export_loads_in_port(tmp_path, arch):
    jm, tree, tm = _pair(arch)
    _, tree_f, _ = _pair(arch, seed=1)
    path = str(tmp_path / "jax.ckpt")
    export_torch_checkpoint(path, {"coarse": tree, "fine": tree_f}, step=7, hwf=(8, 9, 10.5))
    ck = read_reference_checkpoint(path)
    assert ck["step"] == 7 and (ck["height"], ck["width"], ck["focal_length"]) == (8, 9, 10.5)
    assert list(ck["coarse"]) == list(tm.state_dict())  # registration order
    for name, sd_tree in (("coarse", tree), ("fine", tree_f)):
        want = state_dict_from_flax(sd_tree)
        for k, v in ck[name].items():
            np.testing.assert_array_equal(v.numpy(), want[k].numpy())


@pytest.mark.parametrize("arch", ARCHS[:2], ids=lambda a: "x".join(map(str, a)))
def test_port_checkpoint_loads_in_jax(tmp_path, arch):
    jm, tree, tm = _pair(arch)
    path = str(tmp_path / "port.ckpt")
    write_reference_checkpoint(path, tm.state_dict(), tm.state_dict(), step=3, hwf=(4, 5, 6.0))
    imp = import_torch_checkpoint(path)
    assert imp["step"] == 3 and imp["height"] == 4 and imp["focal_length"] == 6.0
    for k, v in jax.tree_util.tree_leaves_with_path(imp["coarse"]):
        ref = tree
        for p in k:
            ref = ref[p.key]
        np.testing.assert_array_equal(np.asarray(v), ref)
    assert infer_flexible_arch(tm.state_dict()) == j_infer(imp["fine"])


@pytest.mark.parametrize("arch", ARCHS + [(5, 32, 9, 2, 1)], ids=lambda a: "x".join(map(str, a)))
def test_infer_flexible_arch(arch):
    jm, tree, tm = _pair(arch)
    got = infer_flexible_arch(tm.state_dict())
    assert got == j_infer(tree)
    rebuilt = FlexibleNeRFModel(
        num_encoding_fn_xyz=arch[3], num_encoding_fn_dir=arch[4], **got
    )
    rebuilt.load_state_dict(tm.state_dict())  # shapes agree


def test_align_cfg_to_checkpoint():
    _, _, tm = _pair((6, 16, 2, 2, 1))
    cfg = CfgNode({
        "nerf": {"use_viewdirs": True},
        "models": {"coarse": {"type": "FlexibleNeRFModel", "num_layers": 8,
                              "hidden_size": 256, "skip_connect_every": 4,
                              "num_encoding_fn_xyz": 2, "num_encoding_fn_dir": 1}},
    })
    cfg.freeze()
    with pytest.warns(UserWarning, match="overrides the config"):
        align_cfg_models_to_checkpoint(cfg, {"coarse": tm.state_dict(), "fine": None})
    assert cfg.is_frozen()
    m = model_from_cfg(cfg.models.coarse)
    m.load_state_dict(tm.state_dict())


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="unknown model type"):
        build_model("NoSuchModel", hidden_size=8)


def test_seeded_init_is_reproducible():
    kw = dict(num_layers=3, hidden_size=16, num_encoding_fn_xyz=2, num_encoding_fn_dir=1)
    a = FlexibleNeRFModel(**kw).reset_parameters(torch.Generator().manual_seed(3))
    b = FlexibleNeRFModel(**kw).reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
        bound = 1.0 / va.shape[-1] ** 0.5 if va.ndim == 2 else None
        if bound is not None:
            assert float(va.abs().max()) <= bound
