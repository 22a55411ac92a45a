"""Multi-scene training: N independent NeRFs trained in lockstep.

Counterpart of ``dexnerf_tpu/parallel/multiscene.py``. The reference scales
out with one Kubernetes job per scene (``job-example.yaml``); here every
scene is an independent NeRF (its own parameters, optimizer state and ray
store) and N scenes train together in one process: the parameters are
stacked on a leading scene axis and one step renders every scene's batch
through ``torch.func.vmap`` of the single-scene plain render
(``render_rays`` + ``nerf_loss`` through ``torch.func.functional_call`` of
one model), then takes one ``backward()`` of the sum of the per-scene
losses (the scenes share no parameter, so each scene's gradient is its own
loss's) and one optimizer step over the stacked tensors. Every optimizer
of ``train.step.OPTIMIZER_REGISTRY`` updates element by element (Adam's
and AdamW's step count is one scalar a tensor, and the scenes advance in
lockstep), so one optimizer over the stacked tensors is exactly M
per-scene optimizers.

Scope, as in JAX: the plain render path. JAX's multi-scene step is its XLA
path, not its Pallas kernels, so ``nerf.use_pallas``,
``nerf.pallas_fused_loss`` and ``nerf.pallas_compute_dtype`` do not apply;
the kernels run at validation, one scene at a time (``apps.multiscene``).

Across processes (``parallel.mesh``, one process a device): the 1-D scene
layout (:func:`make_scene_mesh`) gives each rank its own scenes with no
collective; the 2-D ``(scene, rays)`` layout (:func:`make_scene_data_mesh`)
splits each scene's batch over its row of ranks as
``parallel.sharding.make_parallel_train_step`` splits one scene's, and
averages the gradients within the row only.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, vmap

from dexnerf_tpu_torch.data.pipeline import RayStore, uniform_ray_indices
from dexnerf_tpu_torch.parallel.mesh import Mesh
from dexnerf_tpu_torch.parallel.sharding import local_draws, make_grad_mean
from dexnerf_tpu_torch.render.renderer import (
    RayBatch,
    RenderDraws,
    RenderSettings,
    draw_render_noise,
    render_rays,
)
from dexnerf_tpu_torch.train.step import (
    StepDraws,
    TrainState,
    exponential_decay_schedule,
    init_train_state,
    make_optimizer,
    nerf_loss,
)

SCENE_AXIS = "scene"
RAY_AXIS = "rays"
MODEL_NAMES = ("coarse", "fine")


@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """A rank's place on a scene layout: ``world`` is its place in the whole
    group; the scenes are split over ``scene_devices`` rows of
    ``data_devices`` ranks each, scene-major (rank ``r`` is row ``r //
    data_devices``, place ``r % data_devices`` in it, as JAX lays its
    ``(scene, rays)`` mesh out). ``data`` is the rank's place in its row's
    own process group (the ``rays`` axis, over which a scene's gradients
    are averaged), None on the 1-D scene layout."""

    world: Mesh
    scene_devices: int
    data_devices: int
    data: Optional[Mesh] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (SCENE_AXIS,) if self.data is None else (SCENE_AXIS, RAY_AXIS)

    @property
    def scene_index(self) -> int:
        return self.world.rank // self.data_devices

    @property
    def data_index(self) -> int:
        return self.world.rank % self.data_devices


def make_scene_mesh(mesh: Mesh) -> SceneMesh:
    """The 1-D ``scene`` layout over every rank of ``mesh``: each rank its
    own scenes, no collective (JAX's ``make_scene_mesh``)."""
    return SceneMesh(world=mesh, scene_devices=mesh.world_size, data_devices=1)


def make_scene_data_mesh(scene_devices: int, data_devices: int, mesh: Mesh
                         ) -> Optional[SceneMesh]:
    """The 2-D ``(scene, rays)`` layout on the first ``scene_devices *
    data_devices`` ranks of ``mesh``, scene-major, with one process group a
    row for the gradient mean within a scene (no communication across
    scenes). Every rank of ``mesh`` must call it (``dist.new_group``); a
    rank past the layout gets None. Too few ranks raise JAX's words."""
    need = scene_devices * data_devices
    if mesh.world_size < need:
        raise ValueError(
            f"scene_devices*data_devices = {need} but only "
            f"{mesh.world_size} devices available"
        )
    rows = [dist.new_group(list(range(s * data_devices, (s + 1) * data_devices)))
            for s in range(scene_devices)]
    if mesh.rank >= need:
        return None
    row = mesh.rank // data_devices
    data = Mesh(rank=mesh.rank % data_devices, world_size=data_devices, device=mesh.device,
                group=rows[row], backend=mesh.backend)
    return SceneMesh(world=mesh, scene_devices=scene_devices, data_devices=data_devices,
                     data=data)


@dataclasses.dataclass(frozen=True)
class MultiSceneStore:
    """Stacked ray stores: ``data[s]`` is scene ``s``'s packed rays.
    ``near``/``far`` are per-scene tensors (scenes may have different depth
    ranges); ``rays_per_image`` is 0 unless every scene agrees on it."""

    data: torch.Tensor  # [M, N, 12]
    near: torch.Tensor  # [M]
    far: torch.Tensor  # [M]
    rays_per_image: int = 0

    @property
    def num_scenes(self) -> int:
        return self.data.shape[0]

    @property
    def num_rays(self) -> int:
        return self.data.shape[1]


def stack_ray_stores(stores: Sequence[RayStore]) -> MultiSceneStore:
    """Stack single-scene stores along a new scene axis. Every scene must
    have the same ray count (JAX's words otherwise)."""
    if not stores:
        raise ValueError("no stores to stack")
    counts = {s.num_rays for s in stores}
    if len(counts) != 1:
        raise ValueError(
            f"scenes have different ray counts {sorted(counts)}; "
            "multi-scene training needs equal-sized stores"
        )
    rpis = {s.rays_per_image for s in stores}
    rpi = rpis.pop() if len(rpis) == 1 else 0
    dev = stores[0].data.device
    return MultiSceneStore(
        data=torch.stack([s.data for s in stores]),
        near=torch.tensor([s.near for s in stores], dtype=torch.float32, device=dev),
        far=torch.tensor([s.far for s in stores], dtype=torch.float32, device=dev),
        rays_per_image=rpi,
    )


def scene_store(ms: MultiSceneStore, i: int) -> RayStore:
    """Scene ``i`` back out as a single-scene ``RayStore``."""
    return RayStore(data=ms.data[i], near=float(ms.near[i]), far=float(ms.far[i]),
                    rays_per_image=ms.rays_per_image)


def _tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of nested mappings of one structure (None
    stays None)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def stack_params(params_list: Sequence[Any]) -> Any:
    """Stack per-scene parameter trees (``{"coarse": state_dict, "fine":
    state_dict}``) along a new leading scene axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def scene_params(stacked: Any, i: int) -> Any:
    """Scene ``i``'s parameters back out of a stacked tree."""
    return _tree_map(lambda x: x[i], stacked)


@dataclasses.dataclass
class MultiSceneState:
    """Stacked per-scene parameters ``params`` (``{"coarse": {name: [M,
    ...]}, "fine": ...}``, leaf tensors in ``coarse``/``fine``'s
    ``named_parameters`` order), one optimizer over them (registry name
    ``opt_type``), its schedule and the number of updates (one count: the
    scenes advance in lockstep). ``coarse``/``fine`` give the architecture
    that ``functional_call`` runs; their own weights are not used."""

    coarse: nn.Module
    fine: Optional[nn.Module]
    params: Dict[str, Dict[str, torch.Tensor]]
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    opt_type: str = "Adam"
    # coarse/fine as the step's vmap runs them (_scene_template)
    templates: Tuple[Optional[nn.Module], ...] = dataclasses.field(default=(), repr=False)

    @property
    def num_scenes(self) -> int:
        return next(iter(self.params["coarse"].values())).shape[0]

    def leaves(self) -> List[torch.Tensor]:
        """The stacked tensors in the optimizer's order (coarse, then fine)."""
        return [t for name in MODEL_NAMES if name in self.params
                for t in self.params[name].values()]


def _model_items(coarse: nn.Module, fine: Optional[nn.Module]):
    return [(n, m) for n, m in zip(MODEL_NAMES, (coarse, fine)) if m is not None]


def init_multi_scene_state(
    coarse: nn.Module,
    fine: Optional[nn.Module],
    stacked_params: Mapping,
    lr: float,
    lr_decay: float = 250.0,
    lr_decay_factor: float = 0.1,
    opt_type: str = "Adam",
) -> MultiSceneState:
    """The state over ``stacked_params`` (:func:`stack_params` of per-scene
    state dicts, on the device to train on): leaf copies that require grad,
    and one optimizer of the registry over them, as ``init_train_state``
    builds one scene's (JAX vmaps ``tx.init``; ``step`` is one count)."""
    params = {}
    for name, model in _model_items(coarse, fine):
        want = [k for k, _ in model.named_parameters()]
        got = stacked_params[name]
        if sorted(got) != sorted(want):
            raise ValueError(f"{name}: stacked parameters {sorted(got)} vs the model's {want}")
        params[name] = {k: got[k].detach().clone().requires_grad_(True) for k in want}
    dev = next(iter(params["coarse"].values())).device
    state = MultiSceneState(
        coarse=coarse.to(dev), fine=None if fine is None else fine.to(dev), params=params,
        optimizer=None, schedule=exponential_decay_schedule(lr, lr_decay, lr_decay_factor),
        opt_type=opt_type,
        templates=tuple(None if m is None else _scene_template(m) for m in (coarse, fine)),
    )
    state.optimizer = make_optimizer(state.leaves(), lr, opt_type)
    return state


def _select(state: MultiSceneState, sel, device=None) -> MultiSceneState:
    """The state of scenes ``sel`` (a slice) on ``device``: new leaves, and a
    new optimizer holding the selected slice of every per-element state
    tensor (the scalar step counts as they are)."""
    device = device or next(iter(state.params["coarse"].values())).device
    params = {n: {k: v.detach()[sel].to(device) for k, v in sd.items()}
              for n, sd in state.params.items()}
    out = init_multi_scene_state(state.coarse, state.fine, params, 1.0, opt_type=state.opt_type)
    out.schedule, out.step = state.schedule, state.step
    _copy_optimizer_state(state, out.optimizer, out.leaves(), lambda v: v[sel].to(device))
    return out


def _copy_optimizer_state(src: MultiSceneState, dst: torch.optim.Optimizer,
                          targets: Sequence[torch.Tensor], pick: Callable) -> None:
    """Put ``pick`` of each per-element state tensor of ``src``'s optimizer
    (the scalar ones, such as Adam's step count, as they are) into ``dst``'s
    state of ``targets``, parameter by parameter in order."""
    for p, q in zip(src.leaves(), targets):
        st = src.optimizer.state.get(p)
        if not st:
            continue
        dst.state[q] = {
            k: (pick(v).clone() if torch.is_tensor(v) and v.shape == p.shape
                else (v.clone() if torch.is_tensor(v) else v))
            for k, v in st.items()
        }


def scene_models(state: MultiSceneState, i: int) -> Tuple[nn.Module, Optional[nn.Module]]:
    """Scene ``i``'s models: copies of the architecture holding its weights
    (for its validation and its checkpoint)."""
    models = []
    for name, model in _model_items(state.coarse, state.fine):
        m = copy.deepcopy(model)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(state.params[name][k][i])
        models.append(m)
    return models[0], (models[1] if len(models) > 1 else None)


def scene_train_state(state: MultiSceneState, i: int) -> TrainState:
    """Scene ``i`` as a single-scene ``TrainState`` on the same device
    (JAX's ``scene_params`` of the parameters and the optimizer state): its
    models (:func:`scene_models`), an optimizer holding its slice of the
    state, the schedule and the update count."""
    coarse, fine = scene_models(state, i)
    out = init_train_state(coarse, fine, 1.0, opt_type=state.opt_type)
    out.schedule, out.step = state.schedule, state.step
    _copy_optimizer_state(state, out.optimizer,
                          [p for g in out.optimizer.param_groups for p in g["params"]],
                          lambda v: v[i])
    return out


class _StackedLinear(torch.autograd.Function):
    """``y[m] = x[m] @ w[m].T + b[m]`` for each scene ``m`` of a leading
    axis, one batched GEMM forward; in the backward each scene's weight
    gradient is a GEMM of its own. The batched GEMM that autograd would
    take for it, ``[M, out, N] @ [M, N, in]`` with N a step's 1M samples,
    runs on cuBLAS's 32x32-tile kernel without a split of N: 567 ms of a
    682 ms step of two ``lego-tpu.yml`` scenes at 8192 rays on an H100
    80GB HBM3 (700 W), where the scenes' own GEMMs take ~20 ms."""

    @staticmethod
    def forward(x, w, b):
        m = x.shape[0]
        y = torch.baddbmm(b[:, None, :], x.reshape(m, -1, x.shape[-1]), w.transpose(1, 2))
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        m = x.shape[0]
        g = gy.reshape(m, -1, gy.shape[-1])
        xs = x.reshape(m, -1, x.shape[-1])
        gx = torch.bmm(g, w).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = torch.stack([g[i].t() @ xs[i] for i in range(m)])
        return gx, gw, g.sum(1)


class _SceneLinear(torch.autograd.Function):
    """``F.linear`` for the scenes' ``torch.func.vmap`` only, whose batched
    form is :class:`_StackedLinear` (it is never differentiated unbatched)."""

    @staticmethod
    def forward(x, w, b):
        return torch.nn.functional.linear(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        def scene_major(t, d):
            if d is None:
                return t.expand(info.batch_size, *t.shape)
            return t.movedim(d, 0)

        return _StackedLinear.apply(*map(scene_major, (x, w, b), in_dims)), 0


class _SceneLinearModule(nn.Linear):
    """An ``nn.Linear`` computing through :class:`_SceneLinear`."""

    def forward(self, x):
        return _SceneLinear.apply(x, self.weight, self.bias)


def _scene_template(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose ``nn.Linear`` layers compute through
    :class:`_SceneLinear`, for ``functional_call`` under the scenes'
    ``vmap``; the families whose ``models.mlp.dense`` slices a layer's
    weight (all but FlexibleNeRF at f32) keep those products as they are."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if type(m) is nn.Linear and m.bias is not None:
            m.__class__ = _SceneLinearModule
    return model


def _batched_loss(state: MultiSceneState, settings: RenderSettings, supervision: str):
    """``loss(rows [M, B, 12], near [M], far [M], render) -> (losses [M],
    metrics of [M])``: the single-scene plain render and loss of each scene
    on its own parameters, under ``torch.func.vmap``."""

    def scene_loss(params, rows, near, far, draws):
        n = rows.shape[0]
        rays = RayBatch(origins=rows[:, 0:3], directions=rows[:, 3:6], viewdirs=rows[:, 6:9],
                        near=near.expand(n), far=far.expand(n))
        fields = [(lambda *a, m=model, p=params[name]: functional_call(m, p, a))
                  for name, model in _model_items(*state.templates)]
        result = render_rays(fields[0], fields[1] if len(fields) > 1 else None, rays, settings,
                             draws)
        loss, metrics = nerf_loss(result, rows[:, 9:12], supervision=supervision)
        return loss, {k: v.detach() for k, v in metrics.items()}

    def loss(rows, near, far, render: RenderDraws):
        draw_dims = RenderDraws(*[None if t is None else 0 for t in render])
        return vmap(scene_loss, in_dims=(0, 0, 0, 0, draw_dims))(
            state.params, rows, near, far, render)

    return loss


def _stack_draws(per_scene: Sequence[StepDraws]) -> StepDraws:
    """M scenes' draws of one update, stacked on a leading scene axis."""
    render = RenderDraws(*[
        None if per_scene[0].render[k] is None
        else torch.stack([d.render[k] for d in per_scene])
        for k in range(len(RenderDraws._fields))
    ])
    return StepDraws(torch.stack([d.idx for d in per_scene]), render)


def _make_step(settings: RenderSettings, draw: Callable, steps_per_call: int, supervision: str,
               sync: Optional[Callable] = None):
    """The multi-scene ``train_step(state, store, generators=None,
    draws=None) -> metrics`` over ``draw(store, generators) -> [StepDraws a
    scene]``; ``sync(state, metrics) -> metrics`` between the backward and
    the update may replace the gradients and metrics."""

    def one_step(state: MultiSceneState, store: MultiSceneStore,
                 per_scene: Sequence[StepDraws]) -> Dict[str, torch.Tensor]:
        if len(per_scene) != store.num_scenes:
            raise ValueError(f"need {store.num_scenes} scenes' draws, got {len(per_scene)}")
        d = _stack_draws(per_scene)
        rows = torch.gather(store.data, 1, d.idx[..., None].expand(-1, -1, store.data.shape[-1]))
        losses, metrics = _batched_loss(state, settings, supervision)(
            rows, store.near, store.far, d.render)
        state.optimizer.zero_grad(set_to_none=True)
        # the scenes share no parameter: each scene's gradient is its own loss's
        losses.sum().backward()
        if sync is not None:
            metrics = sync(state, metrics)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp(metrics["loss"], min=1e-10))
        return metrics

    def train_step(state: MultiSceneState, store: MultiSceneStore,
                   generators: Optional[Sequence[torch.Generator]] = None,
                   draws: Optional[Sequence[Sequence[StepDraws]]] = None
                   ) -> Dict[str, torch.Tensor]:
        if draws is not None and len(draws) != steps_per_call:
            raise ValueError(f"need {steps_per_call} updates' draws, got {len(draws)}")
        metrics = {}
        for j in range(steps_per_call):
            metrics = one_step(state, store,
                               draws[j] if draws is not None else draw(store, generators))
        return metrics

    return train_step


def _check_sampling(sampling: str) -> None:
    if sampling == "per_image":
        raise NotImplementedError(
            "multi-scene per_image sampling: use uniform (the store-wide "
            "sampling variant); per-image draws need the per-scene image "
            "structure threaded through — train scenes separately for "
            "reference-exact sampling"
        )
    if sampling != "uniform":
        raise ValueError(f"unknown sampling mode: {sampling}")


def make_multi_scene_train_step(
    settings: RenderSettings,
    batch_per_scene: int,
    *,
    supervision: str = "rgb",
    sampling: str = "uniform",
    steps_per_call: int = 1,
):
    """The multi-scene step ``train_step(state, store, generators=None,
    draws=None) -> metrics``, every metric a per-scene ``[M]`` tensor (the
    last update's of ``steps_per_call``). Scene ``i`` draws its row indices
    and then its render draws from ``generators[i]`` as the single-scene
    plain step (``make_train_step``) draws them, so its trajectory is that
    step's on that generator; or the draws are given, ``draws[j][i]`` scene
    ``i``'s ``StepDraws`` of update ``j`` (e.g. JAX's, from ``fold_in(key,
    i)``). ``sampling`` "per_image" raises JAX's words."""
    _check_sampling(sampling)

    def draw(store, generators):
        if generators is None or len(generators) != store.num_scenes:
            raise ValueError(f"need one generator a scene ({store.num_scenes})")
        dev = store.data.device
        return [StepDraws(uniform_ray_indices(store, batch_per_scene, g),
                          draw_render_noise(batch_per_scene, settings, g, dev))
                for g in generators]

    return _make_step(settings, draw, steps_per_call, supervision)


def shard_multi_scene(state: MultiSceneState, store: MultiSceneStore, mesh: SceneMesh
                      ) -> Tuple[MultiSceneState, MultiSceneStore]:
    """This rank's scenes of the stacked state and store, on its device:
    row ``r`` of the layout holds scenes ``r * m_local`` to ``(r + 1) *
    m_local - 1`` (JAX's scene-axis sharding; on the 2-D layout every rank
    of a row holds the row's scenes). The scene count must divide by the
    number of rows (JAX's words otherwise)."""
    n_dev = mesh.scene_devices
    m = store.num_scenes
    if m % n_dev:
        raise ValueError(f"{m} scenes not divisible by {n_dev} devices")
    m_local = m // n_dev
    sel = slice(mesh.scene_index * m_local, (mesh.scene_index + 1) * m_local)
    dev = mesh.world.device
    local = MultiSceneStore(data=store.data[sel].to(dev), near=store.near[sel].to(dev),
                            far=store.far[sel].to(dev), rays_per_image=store.rays_per_image)
    return _select(state, sel, dev), local


def make_multi_scene_parallel_train_step(
    mesh: SceneMesh,
    settings: RenderSettings,
    batch_per_scene: int,
    *,
    supervision: str = "rgb",
    steps_per_call: int = 1,
):
    """The ``(scene, rays)`` step of one rank, ``train_step(state, store,
    generators=None, draws=None) -> metrics`` over this rank's scenes
    (:func:`shard_multi_scene`): each local scene renders ``batch_per_scene
    / data_devices`` rays, the gradients and metrics are averaged over the
    scene's row (``parallel.sharding.make_grad_mean``), and every rank of the row takes
    the same update. Scene ``s0 + i`` draws its global batch from
    ``generators[i]`` (one a local scene, in the same state on every rank
    of the row) as the one-process step does and takes this rank's slice
    (``parallel.sharding.local_draws``), so the rows together take the
    one-process multi-scene step; or the draws are given, ``draws[j][i]``
    this rank's ``StepDraws`` of local scene ``i`` in update ``j`` (e.g.
    JAX's: ``fold_in`` by scene, then by the rank's index on the rays
    axis). A mesh without a rays axis or a batch the row does not divide
    raise JAX's words."""
    if set(mesh.axis_names) != {SCENE_AXIS, RAY_AXIS}:
        raise ValueError(f"need a (scene, rays) mesh, got axes {mesh.axis_names}")
    n_data = mesh.data_devices
    if batch_per_scene % n_data:
        raise ValueError(
            f"batch_per_scene {batch_per_scene} not divisible by "
            f"{n_data} data devices"
        )

    def draw(store, generators):
        if generators is None or len(generators) != store.num_scenes:
            raise ValueError(f"need one generator a local scene ({store.num_scenes})")
        return [local_draws(mesh.data, store, batch_per_scene, settings, g) for g in generators]

    return _make_step(settings, draw, steps_per_call, supervision, sync=make_grad_mean(mesh.data))
