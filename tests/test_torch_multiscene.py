"""Multi-scene training in the port (``parallel/multiscene.py``,
``apps/multiscene.py``) held to the JAX package's ``parallel/multiscene.py``
and ``apps/multiscene.py`` on the CPU, with small models (2x16, PE 2/1,
4 + 4 samples, σ-noise 0.1) on 8x8 synthetic scenes.

* The stacked stores and parameters, and the refusals, against JAX's.
* The port's multi-scene step against JAX's ``make_multi_scene_train_step``
  for 3 updates on shared weights (fresh, and carried from an optax Adam
  state through ``stack_adam_states``) and JAX's ``fold_in(key, i)`` draws:
  losses to LOSS_RTOL, parameters to PARAM_ATOL
  (``tests/test_torch_parallel.py``'s).
* Scene ``i`` of the port's step against the port's single-scene plain
  step on scene ``i``'s generator, with every optimizer of the registry,
  within JAX's own 1e-6 (losses) and 2e-6 (parameters)
  (``tests/test_multiscene.py``).
* The ``(scene, rays)`` step on 2x2 gloo ranks against JAX's
  ``make_multi_scene_parallel_train_step`` on a (2, 2) CPU mesh, and the
  2x2, 1x2 and 4x1 layouts against the one-process step on the same
  generators: one spawn of four ranks, with a timeout.
* ``apps.multiscene --device cpu`` on two configs, one process and two
  gloo ranks, each scene's ``.ckpt`` read by ``apps.eval`` and equal to
  ``apps.train``'s of its config; JAX's refusals of mismatched configs.
"""

import json
import os
import types
import warnings

import numpy as np
import pytest
import torch
import yaml

from dexnerf_tpu_torch.data.pipeline import build_ray_store
from dexnerf_tpu_torch.data.synthetic import make_synthetic_scene, write_blender_dataset
from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
from dexnerf_tpu_torch.parallel import mesh as pmesh
from dexnerf_tpu_torch.parallel import multiscene as ms
from dexnerf_tpu_torch.render.renderer import RenderDraws, RenderSettings
from dexnerf_tpu_torch.train.checkpoints import (
    adam_state_from_optax,
    load_adam_state,
    read_reference_checkpoint,
    stack_adam_states,
    state_dict_from_flax,
)
from dexnerf_tpu_torch.train.step import (
    OPTIMIZER_REGISTRY,
    StepDraws,
    init_train_state,
    make_train_step,
)

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
# an Adam moment to this share of its leaf's largest entry
# (tests/test_torch_train_step.py's rule)
MOMENT_RTOL = 2e-3
# scene i of the multi-scene step vs the single-scene step: JAX's own
# tolerances for the same invariant (tests/test_multiscene.py:112-127)
SCENE_LOSS_ATOL, SCENE_PARAM_ATOL = 1e-6, 2e-6
SPAWN_TIMEOUT = 240.0
ENC_XYZ, ENC_DIR = 2, 1
ARCH = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=ENC_XYZ,
            num_encoding_fn_dir=ENC_DIR)
SETTINGS = dict(num_coarse=4, num_fine=4, perturb=True, radiance_field_noise_std=0.1,
                num_encoding_fn_xyz=ENC_XYZ, num_encoding_fn_dir=ENC_DIR)
BATCH, LR, STEPS, RANK_STEPS = 32, 5e-3, 3, 2
NEAR, FAR = 2.0, 6.0
NUM_SCENES = 4  # the 4x1 layout's; the other cases take the first two


def _scene(s, height=8, width=8):
    images, _, poses, hwf = make_synthetic_scene(num_views=2, height=height, width=width, seed=s)
    return images, poses, hwf


def _stores(n, height=8, width=8):
    return [build_ray_store(*_scene(s, height, width), NEAR, FAR, device="cpu") for s in range(n)]


def _port_state(weights, scenes, opt_type="Adam"):
    stacked = ms.stack_params([
        {n: {k: torch.tensor(v) for k, v in weights[s][n].items()} for n in ("coarse", "fine")}
        for s in scenes])
    return ms.init_multi_scene_state(FlexibleNeRFModel(**ARCH), FlexibleNeRFModel(**ARCH),
                                     stacked, LR, opt_type=opt_type)


def _as_draws(idx, render):
    return StepDraws(torch.tensor(idx),
                     RenderDraws(*[None if t is None else torch.tensor(t) for t in render]))


def _params_np(state, i):
    return {n: {k: v.detach().numpy().copy() for k, v in sd.items()}
            for n, sd in ms.scene_params(state.params, i).items()}


def _generators(scenes):
    return [torch.Generator().manual_seed(20 + s) for s in scenes]


def _rank_layouts(mesh, payload):
    """Every rank case on this rank of four: the 2x2 layout on JAX's
    per-rank draws, then the 2x2, 1x2 and 4x1 layouts on the scenes'
    generators. Returns numpy results by case."""
    s = RenderSettings(**SETTINGS)
    weights = payload["weights"]
    stores = _stores(NUM_SCENES)
    out = {}
    layouts = {"2x2": ms.make_scene_data_mesh(2, 2, mesh),
               "1x2": ms.make_scene_data_mesh(1, 2, mesh), "4x1": ms.make_scene_mesh(mesh)}
    for case in ("jax", "2x2", "1x2", "4x1"):
        smesh = layouts["2x2" if case == "jax" else case]
        if smesh is None:  # a rank past the layout
            continue
        scenes = list(range(NUM_SCENES if case == "4x1" else 2))
        state, store = ms.shard_multi_scene(_port_state(weights, scenes),
                                            ms.stack_ray_stores([stores[i] for i in scenes]),
                                            smesh)
        m_local = store.num_scenes
        local = scenes[smesh.scene_index * m_local:(smesh.scene_index + 1) * m_local]
        if smesh.data is None:
            step = ms.make_multi_scene_train_step(s, BATCH)
        else:
            step = ms.make_multi_scene_parallel_train_step(smesh, s, BATCH)
        gens = _generators(local)
        metrics = []
        for t in range(RANK_STEPS):
            if case == "jax":
                draws = [[_as_draws(*payload["draws"][t][j][smesh.data_index]) for j in local]]
                m = step(state, store, draws=draws)
            else:
                m = step(state, store, gens)
            metrics.append({k: v.numpy().copy() for k, v in m.items()})
        out[case] = {"scenes": local, "metrics": metrics, "data_index": smesh.data_index,
                     "params": [_params_np(state, i) for i in range(m_local)]}
    return out


def _jax_scene_draws(jx, key, folds, n_rays, batch):
    """JAX's draws of one scene's step after ``fold_in`` by each of
    ``folds`` (``make_multi_scene_train_step``: the scene;
    ``make_multi_scene_parallel_train_step``: the scene, then the rank's
    index on the rays axis): the row indices, then the render draws, as
    numpy."""
    jax, jnp = jx.jax, jx.jnp
    for f in folds:
        key = jax.random.fold_in(key, f)
    k_sample, k_render = jax.random.split(key)
    idx = jax.random.randint(k_sample, (batch,), 0, n_rays)
    k_strat, k_nc, k_fine, k_nf = jax.random.split(k_render, 4)
    c, f, std = SETTINGS["num_coarse"], SETTINGS["num_fine"], SETTINGS["radiance_field_noise_std"]
    render = tuple(np.asarray(x) for x in (
        jax.random.uniform(k_strat, (batch, c), dtype=jnp.float32),
        std * jax.random.normal(k_nc, (batch, c), dtype=jnp.float32),
        jax.random.uniform(k_fine, (batch, f), dtype=jnp.float32),
        std * jax.random.normal(k_nf, (batch, c + f), dtype=jnp.float32)))
    return np.asarray(idx).astype(np.int64), render


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from dexnerf_tpu.core.encoding import encoding_dim
    from dexnerf_tpu.data import build_ray_store as j_build
    from dexnerf_tpu.models import FlexibleNeRFModel as JFlex
    from dexnerf_tpu.render import RenderSettings as JSettings

    jm = JFlex(**ARCH)
    in_dim = encoding_dim(3, ENC_XYZ) + encoding_dim(3, ENC_DIR)
    params = []
    for s in range(NUM_SCENES):
        key = jax.random.PRNGKey(s)
        params.append(jax.tree.map(np.asarray, {
            "coarse": jm.init(key, jnp.ones((1, in_dim))),
            "fine": jm.init(jax.random.fold_in(key, 1), jnp.ones((1, in_dim)))}))
    weights = [{n: {k: v.numpy() for k, v in state_dict_from_flax(p[n]).items()}
                for n in ("coarse", "fine")} for p in params]
    j_stores = [j_build(*_scene(s), NEAR, FAR) for s in range(NUM_SCENES)]
    return types.SimpleNamespace(jax=jax, jnp=jnp, jm=jm, params=params, weights=weights,
                                 j_stores=j_stores, js=JSettings(**SETTINGS))


@pytest.fixture(scope="module")
def ranks(jx):
    """One spawn of four gloo ranks running every layout case; by rank."""
    n_rays = jx.j_stores[0].num_rays
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(11), RANK_STEPS)
    draws = [[[_jax_scene_draws(jx, k, (s, d), n_rays, BATCH // 2) for d in range(2)]
              for s in range(2)] for k in keys]
    payload = {"weights": jx.weights, "draws": draws}
    return {"keys": keys,
            "out": pmesh.spawn_ranks(_rank_layouts, 4, "cpu", (payload,), timeout=SPAWN_TIMEOUT)}


def test_stack_and_slice_roundtrip_matches_jax(jx):
    """``stack_ray_stores`` / ``scene_store`` and ``stack_params`` /
    ``scene_params`` against JAX's on the same scenes and weights."""
    from dexnerf_tpu.parallel import scene_params as j_scene_params
    from dexnerf_tpu.parallel import scene_store as j_scene_store
    from dexnerf_tpu.parallel import stack_params as j_stack_params
    from dexnerf_tpu.parallel import stack_ray_stores as j_stack

    stores = _stores(3)
    got, want = ms.stack_ray_stores(stores), j_stack(jx.j_stores[:3])
    assert (got.num_scenes, got.num_rays, got.rays_per_image) == (
        want.num_scenes, want.num_rays, want.rays_per_image)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.near.numpy(), np.asarray(want.near))
    np.testing.assert_array_equal(got.far.numpy(), np.asarray(want.far))
    back, j_back = ms.scene_store(got, 1), j_scene_store(want, 1)
    assert torch.equal(back.data, stores[1].data)
    assert (back.near, back.far, back.rays_per_image) == (j_back.near, j_back.far,
                                                          j_back.rays_per_image)
    stacked = ms.stack_params([{n: {k: torch.tensor(v) for k, v in w[n].items()}
                                for n in ("coarse", "fine")} for w in jx.weights[:3]])
    j_stacked = j_stack_params(jx.params[:3])
    for n in ("coarse", "fine"):
        for k, v in stacked[n].items():
            assert v.shape[0] == 3
            for i in range(3):
                ref = state_dict_from_flax(jx.jax.tree.map(
                    np.asarray, j_scene_params(j_stacked, i)[n]))[k]
                assert torch.equal(ms.scene_params(stacked, i)[n][k], ref)


@pytest.mark.parametrize("case", ["unequal", "empty", "per_image", "sampling", "batch",
                                  "axes", "too-few", "shard"])
def test_refusals_match_jax(jx, case):
    """JAX's refusals, word for word: stores of different ray counts, no
    store, per_image or an unknown sampling, a batch the rays axis does not
    divide, a mesh without a rays axis, too few devices for the layout,
    scenes the scene axis does not divide."""
    from dexnerf_tpu.parallel import (
        init_multi_scene_state,
        make_multi_scene_parallel_train_step,
        make_multi_scene_train_step,
        make_scene_data_mesh,
        make_scene_mesh,
        shard_multi_scene,
        stack_params,
        stack_ray_stores,
    )
    from dexnerf_tpu.train import make_optimizer

    s = RenderSettings(**SETTINGS)
    tx = make_optimizer(LR)
    world = pmesh.Mesh(rank=0, world_size=8, device=torch.device("cpu"), group=None,
                       backend="gloo")
    two_by_four = ms.SceneMesh(world=world, scene_devices=2, data_devices=4, data=world)
    exc = ValueError
    if case == "unequal":
        from dexnerf_tpu.data import build_ray_store as j_build

        port = lambda: ms.stack_ray_stores(_stores(1) + _stores(1, 8, 4))  # noqa: E731
        jaxs = lambda: stack_ray_stores(  # noqa: E731
            [jx.j_stores[0], j_build(*_scene(0, 8, 4), NEAR, FAR)])
    elif case == "empty":
        port, jaxs = (lambda: ms.stack_ray_stores([])), (lambda: stack_ray_stores([]))
    elif case in ("per_image", "sampling"):
        mode = "per_image" if case == "per_image" else "bogus"
        exc = NotImplementedError if case == "per_image" else ValueError
        port = lambda: ms.make_multi_scene_train_step(s, BATCH, sampling=mode)  # noqa: E731
        jaxs = lambda: make_multi_scene_train_step(  # noqa: E731
            jx.jm.apply, jx.jm.apply, tx, jx.js, BATCH, sampling=mode)
    elif case == "batch":
        port = lambda: ms.make_multi_scene_parallel_train_step(two_by_four, s, 30)  # noqa: E731
        jaxs = lambda: make_multi_scene_parallel_train_step(  # noqa: E731
            make_scene_data_mesh(2, 4), jx.jm.apply, jx.jm.apply, tx, jx.js, 30)
    elif case == "axes":
        port = lambda: ms.make_multi_scene_parallel_train_step(  # noqa: E731
            ms.make_scene_mesh(world), s, BATCH)
        jaxs = lambda: make_multi_scene_parallel_train_step(  # noqa: E731
            make_scene_mesh(), jx.jm.apply, jx.jm.apply, tx, jx.js, BATCH)
    elif case == "too-few":
        port = lambda: ms.make_scene_data_mesh(4, 4, world)  # noqa: E731
        jaxs = lambda: make_scene_data_mesh(4, 4)  # noqa: E731
    else:
        port = lambda: ms.shard_multi_scene(  # noqa: E731
            _port_state(jx.weights, [0, 1, 2]), ms.stack_ray_stores(_stores(3)),
            ms.make_scene_mesh(world))
        jaxs = lambda: shard_multi_scene(  # noqa: E731
            init_multi_scene_state(stack_params(jx.params[:3]), tx),
            stack_ray_stores(jx.j_stores[:3]), make_scene_mesh())
    with pytest.raises(exc) as got:
        port()
    with pytest.raises(exc) as want:
        jaxs()
    assert str(got.value) == str(want.value)


def _jax_multi_state(jx, tx, carried):
    """JAX's multi-scene state of scenes 0 and 1 and, when ``carried``, the
    Adam state replaced by count 7 and random moments; with the port's
    reference-layout Adam state of each scene."""
    from dexnerf_tpu.parallel import init_multi_scene_state, stack_params

    jax, jnp = jx.jax, jx.jnp
    state = init_multi_scene_state(stack_params(jax.tree.map(jnp.asarray, jx.params[:2])), tx)
    if not carried:
        return state, None
    rng = np.random.default_rng(5)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    adam = state.opt_state[0]
    adam = adam._replace(count=jnp.full_like(adam.count, 7), mu=rand(adam.mu),
                         nu=jax.tree.map(jnp.abs, rand(adam.nu)))
    state = state._replace(opt_state=(adam, *state.opt_state[1:]))
    models = {"coarse": FlexibleNeRFModel(**ARCH), "fine": FlexibleNeRFModel(**ARCH)}
    as_np = lambda t, i: jax.tree.map(lambda x: np.asarray(x)[i], t)  # noqa: E731
    per_scene = [adam_state_from_optax(as_np(adam.mu, i), as_np(adam.nu, i), 7, models, LR)
                 for i in range(2)]
    return state, per_scene


@pytest.mark.parametrize("start", ["fresh", "carried"])
def test_multiscene_steps_match_jax(jx, start):
    """Three updates of the port's multi-scene step against JAX's
    ``make_multi_scene_train_step`` on JAX's ``fold_in(key, i)`` draws, from
    shared weights (and, ``carried``, a shared Adam state: JAX's moments
    through ``adam_state_from_optax`` and ``stack_adam_states``): each
    scene's metrics of each update, every parameter and both Adam moments
    after them."""
    from dexnerf_tpu.parallel import make_multi_scene_train_step as j_step
    from dexnerf_tpu.parallel import stack_ray_stores as j_stack
    from dexnerf_tpu.train import make_optimizer

    jax = jx.jax
    tx = make_optimizer(LR)
    jstate, per_scene = _jax_multi_state(jx, tx, start == "carried")
    state = _port_state(jx.weights, [0, 1])
    if per_scene is not None:
        assert load_adam_state(state.optimizer, stack_adam_states(per_scene)) == 7
    store, jstore = ms.stack_ray_stores(_stores(2)), j_stack(jx.j_stores[:2])
    jstep = j_step(jx.jm.apply, jx.jm.apply, tx, jx.js, batch_per_scene=BATCH)
    step = ms.make_multi_scene_train_step(RenderSettings(**SETTINGS), BATCH)
    key = jax.random.PRNGKey(7)
    for t in range(STEPS):
        key, sub = jax.random.split(key)
        draws = [[_as_draws(*_jax_scene_draws(jx, sub, (i,), store.num_rays, BATCH))
                  for i in range(2)]]
        got = step(state, store, draws=draws)
        jstate, want = jstep(jstate, jstore, sub)
        assert set(want) <= set(got)
        for k in want:
            assert got[k].shape == (2,)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"update {t} {k}")
    adam = jstate.opt_state[0]
    for n in ("coarse", "fine"):
        for leaf, tree in (("param", jstate.params), ("exp_avg", adam.mu),
                           ("exp_avg_sq", adam.nu)):
            for i in range(2):
                ref = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x)[i], tree[n]))
                for k, p in state.params[n].items():
                    got = p if leaf == "param" else state.optimizer.state[p][leaf]
                    atol = (PARAM_ATOL if leaf == "param"
                            else MOMENT_RTOL * float(ref[k].abs().max()))
                    np.testing.assert_allclose(got.detach()[i].numpy(), ref[k].numpy(),
                                               rtol=0, atol=atol,
                                               err_msg=f"{leaf} scene {i} {n}.{k}")


@pytest.mark.parametrize("opt_type", sorted(OPTIMIZER_REGISTRY))
def test_scene_matches_single_scene_step(opt_type):
    """Scene ``i`` of the multi-scene step is the single-scene plain step
    (``make_train_step``) on scene ``i``'s generator, with each optimizer
    of the registry (each updates element by element, so one optimizer over
    the stacked tensors is M optimizers): the losses of 3 updates, then the
    parameters and every optimizer state tensor of ``scene_train_state``,
    within JAX's tolerances for the same invariant."""
    weights = []
    for s in range(2):
        g = torch.Generator().manual_seed(s)
        weights.append({n: {k: v.numpy() for k, v in
                            FlexibleNeRFModel(**ARCH).reset_parameters(g).state_dict().items()}
                        for n in ("coarse", "fine")})
    stores = _stores(2)
    s = RenderSettings(**SETTINGS)
    state = _port_state(weights, [0, 1], opt_type)
    step = ms.make_multi_scene_train_step(s, BATCH)
    singles = []
    for w in weights:
        c, f = FlexibleNeRFModel(**ARCH), FlexibleNeRFModel(**ARCH)
        c.load_state_dict({k: torch.tensor(v) for k, v in w["coarse"].items()})
        f.load_state_dict({k: torch.tensor(v) for k, v in w["fine"].items()})
        singles.append(init_train_state(c, f, LR, opt_type=opt_type))
    single_step = make_train_step(s, BATCH)
    gens, single_gens = _generators([0, 1]), _generators([0, 1])
    store = ms.stack_ray_stores(stores)
    for t in range(STEPS):
        got = step(state, store, gens)
        for i in range(2):
            want = single_step(singles[i], stores[i], single_gens[i])
            assert abs(float(got["loss"][i]) - float(want["loss"])) <= SCENE_LOSS_ATOL, (t, i)
    for i in range(2):
        one = ms.scene_train_state(state, i)
        assert one.step == singles[i].step == STEPS
        mine = [p for g in one.optimizer.param_groups for p in g["params"]]
        theirs = [p for g in singles[i].optimizer.param_groups for p in g["params"]]
        for p, q in zip(mine, theirs):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0,
                                       atol=SCENE_PARAM_ATOL)
            st, sq = one.optimizer.state[p], singles[i].optimizer.state[q]
            assert set(st) == set(sq)
            for k, v in sq.items():
                if torch.is_tensor(v):
                    np.testing.assert_allclose(st[k].numpy(), v.numpy(), rtol=1e-5,
                                               atol=SCENE_PARAM_ATOL, err_msg=k)


def test_step_has_no_vmap_fallback():
    """Every op of the multi-scene step has a ``torch.func.vmap`` batching
    rule: vmap warns where one is missing and loops over the scenes."""
    weights = [{n: {k: v.numpy() for k, v in FlexibleNeRFModel(**ARCH).reset_parameters(
        torch.Generator().manual_seed(s)).state_dict().items()} for n in ("coarse", "fine")}
        for s in range(2)]
    state = _port_state(weights, [0, 1])
    step = ms.make_multi_scene_train_step(RenderSettings(**SETTINGS), BATCH)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(state, ms.stack_ray_stores(_stores(2)), _generators([0, 1]))
    assert not [str(w.message) for w in caught if "batching rule" in str(w.message)]


def test_steps_per_call_equals_single_calls():
    """``steps_per_call=3`` in one call takes the three updates that three
    calls of one update take on the same generators, bit for bit."""
    weights = [{n: {k: v.numpy() for k, v in FlexibleNeRFModel(**ARCH).reset_parameters(
        torch.Generator().manual_seed(s)).state_dict().items()} for n in ("coarse", "fine")}
        for s in range(2)]
    store = ms.stack_ray_stores(_stores(2))
    s = RenderSettings(**SETTINGS)
    a, b = _port_state(weights, [0, 1]), _port_state(weights, [0, 1])
    ga, gb = _generators([0, 1]), _generators([0, 1])
    ma = ms.make_multi_scene_train_step(s, BATCH, steps_per_call=3)(a, store, ga)
    one = ms.make_multi_scene_train_step(s, BATCH)
    for _ in range(3):
        mb = one(b, store, gb)
    assert a.step == b.step == 3
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    assert all(torch.equal(p, q) for p, q in zip(a.leaves(), b.leaves()))


def test_scene_data_2x2_matches_jax(jx, ranks):
    """The ``(scene, rays)`` step on 2x2 gloo ranks against JAX's
    ``make_multi_scene_parallel_train_step`` on a (2, 2) CPU mesh, on JAX's
    per-rank draws (``fold_in`` by scene, then by the rank's rays index):
    each scene's metrics of each update and its parameters after them; the
    two ranks of a scene's row equal in every bit."""
    from dexnerf_tpu.parallel import (
        init_multi_scene_state,
        make_multi_scene_parallel_train_step,
        make_scene_data_mesh,
        shard_multi_scene,
        stack_params,
        stack_ray_stores,
    )
    from dexnerf_tpu.train import make_optimizer

    jax, jnp = jx.jax, jx.jnp
    tx = make_optimizer(LR)
    mesh = make_scene_data_mesh(2, 2)
    jstate, jstore = shard_multi_scene(
        init_multi_scene_state(stack_params(jax.tree.map(jnp.asarray, jx.params[:2])), tx),
        stack_ray_stores(jx.j_stores[:2]), mesh)
    jstep = make_multi_scene_parallel_train_step(mesh, jx.jm.apply, jx.jm.apply, tx, jx.js,
                                                 batch_per_scene=BATCH)
    want = []
    for k in ranks["keys"]:
        jstate, m = jstep(jstate, jstore, k)
        want.append({key: np.asarray(v) for key, v in m.items()})
    out = [r["jax"] for r in ranks["out"]]
    for row in range(2):
        a, b = out[2 * row], out[2 * row + 1]
        assert a["scenes"] == b["scenes"] == [row] and (a["data_index"], b["data_index"]) == (0, 1)
        for x, y in zip(a["params"], b["params"]):
            assert all(np.array_equal(x[n][k], y[n][k]) for n in x for k in x[n])
        for t, w in enumerate(want):
            for key in w:
                np.testing.assert_allclose(a["metrics"][t][key][0], w[key][row], rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=f"update {t} {key}")
        for n in ("coarse", "fine"):
            ref = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x)[row],
                                                    jstate.params[n]))
            for k, v in a["params"][0][n].items():
                np.testing.assert_allclose(v, ref[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"scene {row} {n}.{k}")


@pytest.mark.parametrize("layout", ["2x2", "1x2", "4x1"])
def test_layouts_match_one_process(jx, ranks, layout):
    """Every layout's rows together take the one-process multi-scene step on
    the same generators (each rank of a row its slice of the scene's global
    batch; the 4x1 layout each rank one scene, no collective): each scene's
    metrics of each update and its parameters, and a row's ranks equal in
    every bit."""
    scenes = list(range(NUM_SCENES if layout == "4x1" else 2))
    state = _port_state(jx.weights, scenes)
    store = ms.stack_ray_stores([_stores(NUM_SCENES)[i] for i in scenes])
    step = ms.make_multi_scene_train_step(RenderSettings(**SETTINGS), BATCH)
    gens = _generators(scenes)
    want = [{k: v.numpy() for k, v in step(state, store, gens).items()}
            for _ in range(RANK_STEPS)]
    out = [r[layout] for r in ranks["out"] if layout in r]
    assert len(out) == (2 if layout == "1x2" else 4)
    seen = set()
    for r in out:
        for n_local, j in enumerate(r["scenes"]):
            seen.add(j)
            for t, w in enumerate(want):
                for key in w:
                    np.testing.assert_allclose(r["metrics"][t][key][n_local], w[key][j],
                                               rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
            ref = _params_np(state, j)
            for n in ref:
                for k, v in ref[n].items():
                    np.testing.assert_allclose(r["params"][n_local][n][k], v, rtol=0,
                                               atol=PARAM_ATOL, err_msg=f"scene {j} {n}.{k}")
    assert seen == set(scenes)
    rows = {}
    for r in out:
        rows.setdefault(tuple(r["scenes"]), []).append(r["params"])
    for group in rows.values():
        for other in group[1:]:
            for x, y in zip(group[0], other):
                assert all(np.array_equal(x[n][k], y[n][k]) for n in x for k in x[n])


def _cli_cfgs(tmp_path, ids=("scene_a", "scene_b")):
    """Two 2x16 configs over one written blender scene, seeds 1 and 2, 4
    iterations at 16 rays, validation every 2."""
    from test_torch_depth import tiny_cfg

    data = str(tmp_path / "blender")
    if not os.path.isdir(data):
        write_blender_dataset(data, height=8, width=8, views_per_split=(2, 1, 1))
    paths = []
    for seed, ident in enumerate(ids, start=1):
        raw = tiny_cfg({"type": "blender", "basedir": data}, str(tmp_path / "logs"))
        raw["experiment"].update(id=ident, randomseed=seed, train_iters=4, print_every=2,
                                 validate_every=2, save_every=4)
        raw["nerf"]["train"]["radiance_field_noise_std"] = 0.1
        path = str(tmp_path / f"{ident}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``apps.multiscene --device cpu`` on two configs in one process, and
    with ``--data-devices 2`` on two gloo ranks."""
    from dexnerf_tpu_torch.apps import multiscene as app

    out = {}
    for name, flags in (("one", []), ("ranks", ["--data-devices", "2"])):
        tmp = tmp_path_factory.mktemp(name)
        paths = _cli_cfgs(tmp)
        spawn = pmesh.spawn_ranks
        pmesh.spawn_ranks = lambda *a, **k: spawn(*a, **{"timeout": SPAWN_TIMEOUT, **k})
        try:
            assert app.main(["--configs", *paths, "--device", "cpu", *flags]) == 0
        finally:
            pmesh.spawn_ranks = spawn
        out[name] = (tmp, paths)
    return out


@pytest.mark.parametrize("run", ["one", "ranks"])
def test_cli_end_to_end(cli_run, run):
    """Each scene's logdir: ``config.yml``; ``metrics.jsonl`` with the train
    lines of steps 2 and 4 and the validation lines; the validation PNGs;
    one ``.ckpt`` with the models, Adam state and 4 updates, which
    ``apps.eval --device cpu`` renders. The two gloo ranks' checkpoints
    equal the one process's to PARAM_ATOL."""
    from PIL import Image

    from dexnerf_tpu_torch.apps import eval as eval_app

    tmp, paths = cli_run[run]
    for path, ident in zip(paths, ("scene_a", "scene_b")):
        logdir = tmp / "logs" / ident
        assert (logdir / "config.yml").exists()
        with open(logdir / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f if line.strip()]
        train = [line for line in lines if "loss" in line]
        val = [line for line in lines if "val_psnr" in line]
        assert [line["step"] for line in train] == [2, 4]
        assert all(set(line) == {"step", "loss", "psnr"} for line in train)
        assert [line["step"] for line in val] == [2, 4]
        assert all(np.isfinite(line["val_psnr"]) and np.isfinite(line["val_ssim"])
                   for line in val)
        for step in (2, 4):
            png = np.asarray(Image.open(logdir / "validation" / f"rgb_{step:07d}.png"))
            assert png.shape == (8, 8, 3) and png.dtype == np.uint8
        assert os.listdir(logdir / "checkpoints") == ["checkpoint_0000003.ckpt"]
        ck = read_reference_checkpoint(str(logdir / "checkpoints" / "checkpoint_0000003.ckpt"))
        assert ck["step"] == 4 and "optimizer_state_dict" in ck
        if run == "ranks":
            ref = read_reference_checkpoint(
                str(cli_run["one"][0] / "logs" / ident / "checkpoints" / "checkpoint_0000003.ckpt"))
            for n in ("coarse", "fine"):
                for k, v in ck[n].items():
                    np.testing.assert_allclose(v.numpy(), ref[n][k].numpy(), rtol=0,
                                               atol=PARAM_ATOL)
        savedir = str(tmp / f"renders-{ident}")
        ckpt = str(logdir / "checkpoints" / "checkpoint_0000003.ckpt")
        assert eval_app.main(["--config", path, "--checkpoint", ckpt, "--savedir", savedir,
                              "--device", "cpu", "--test-set"]) == 0
        with open(os.path.join(savedir, "metrics.json")) as f:
            assert np.isfinite(json.load(f)["mean"]["psnr"])


def test_cli_scene_equals_apps_train(cli_run, tmp_path):
    """A scene of ``apps.multiscene`` trains as ``apps.train`` of its config
    alone: the same seeded weights, the same generator's draws, so the same
    ``.ckpt`` (parameters and Adam moments), within JAX's tolerance for
    scene ``i`` against the single-scene step."""
    from dexnerf_tpu_torch.apps import train as train_app

    tmp, paths = cli_run["one"]
    with open(paths[1]) as f:
        raw = yaml.safe_load(f)
    raw["experiment"].update(id="alone", logdir=str(tmp_path / "logs"))
    alone = str(tmp_path / "alone.yml")
    with open(alone, "w") as f:
        yaml.safe_dump(raw, f)
    assert train_app.main(["--config", alone, "--device", "cpu"]) == 0
    want = read_reference_checkpoint(str(tmp_path / "logs" / "alone" / "checkpoints"
                                         / "checkpoint_0000003.ckpt"))
    got = read_reference_checkpoint(str(tmp / "logs" / "scene_b" / "checkpoints"
                                        / "checkpoint_0000003.ckpt"))
    assert got["step"] == want["step"] == 4
    for n in ("coarse", "fine"):
        for k, v in got[n].items():
            np.testing.assert_allclose(v.numpy(), want[n][k].numpy(), rtol=0,
                                       atol=SCENE_PARAM_ATOL, err_msg=f"{n}.{k}")
    for i, st in got["optimizer_state_dict"]["state"].items():
        ref = want["optimizer_state_dict"]["state"][i]
        assert st["step"] == ref["step"] == 4
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(st[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=SCENE_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("section", ["models", "nerf.train"])
def test_cli_rejects_mismatched_configs_like_jax(tmp_path, section):
    """Configs whose models, or whose train-render settings, differ: JAX's
    ``SystemExit`` words."""
    from dexnerf_tpu.apps.multiscene import main as j_main

    from dexnerf_tpu_torch.apps import multiscene as app

    paths = _cli_cfgs(tmp_path)
    with open(paths[1]) as f:
        txt = f.read()
    old, new = (("hidden_size: 16", "hidden_size: 32") if section == "models"
                else ("num_random_rays: 16", "num_random_rays: 16\n    lindisp: true"))
    with open(paths[1], "w") as f:
        f.write(txt.replace(old, new, 1))
    with pytest.raises(SystemExit) as got:
        app.main(["--configs", *paths, "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        j_main(["--configs", *paths])
    assert str(got.value) == str(want.value)
    assert "differ" in str(got.value)


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without ``--device`` the run asks for the card, and a machine
    without one exits, as ``apps.train`` does."""
    from dexnerf_tpu_torch.apps import multiscene as app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card is visible"):
        app.main(["--configs", *_cli_cfgs(tmp_path)])
