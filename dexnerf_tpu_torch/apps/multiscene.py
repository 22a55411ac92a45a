"""Multi-scene training CLI, on a CUDA card unless ``--device cpu`` is given.

Counterpart of ``dexnerf_tpu/apps/multiscene.py``. The reference scales to
many scenes with one Kubernetes job per scene (``job-example.yaml``); this
command trains them together, each scene an independent NeRF on a stacked
scene axis (``parallel/multiscene.py``)::

    python -m dexnerf_tpu_torch.apps.multiscene \\
        --configs configs/scene_a.yml configs/scene_b.yml [--max-iters N] --device cuda

All configs must agree on the models and the train-time render settings
(one step runs every scene); datasets, near/far, seeds and logdirs stay per
scene. The step is the plain render, batched over the scenes, as JAX's
multi-scene step is its XLA path; each scene's validation frame goes
through the fused render kernel (kernel 1), as ``apps.train``'s does. Scene
``i`` initializes its models from its own ``experiment.randomseed`` and
draws its rays from a generator of that seed, as ``apps.train`` of its
config alone would. Each scene's ``<logdir>/<id>`` gets ``config.yml``,
``metrics.jsonl`` (``{"step", "loss", "psnr"}`` and ``{"step",
"val_psnr", "val_ssim"}`` lines), ``validation/rgb_<step>.png`` and
``checkpoints/checkpoint_<last iteration>.ckpt`` in the reference schema
with its slice of the optimizer state, which ``apps.eval`` reads.

``--data-devices k > 1`` trains on the ``(scene, rays)`` layout: one rank a
card, the scenes split over card-count / k rows of k ranks, each scene's
batch split over its row (on ``--device cpu``, k gloo processes holding
every scene). Otherwise, on more than one card whose count divides the
scene count, each card trains its own scenes; else one process trains
them all.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train several NeRFs together with the PyTorch port")
    p.add_argument("--configs", type=str, nargs="+", required=True,
                   help="one YAML config per scene")
    p.add_argument("--max-iters", type=int, default=None,
                   help="override train_iters (from the first config)")
    p.add_argument(
        "--validate-every", type=int, default=None,
        help="full-frame validation render per scene every N iters (default: the first "
        "config's experiment.validate_every; 0 off): PSNR/SSIM appended to each scene's "
        "metrics.jsonl, the render saved under <logdir>/validation/",
    )
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="optimizer steps per call of the train step")
    p.add_argument("--batch", type=int, default=None, help="override rays per scene per step")
    p.add_argument(
        "--data-devices", type=int, default=None,
        help="data-parallel devices PER SCENE: train on a 2-D (scene, rays) layout, the scenes "
        "split over the rows, each scene's ray batch split over its own row of ranks (the "
        "gradient mean stays within the row; no communication across scenes)",
    )
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the models train (default: the card)")
    return p


def _require_matching(cfgs, paths):
    """The scenes share one step: the models and the train-render settings
    must agree. Compare the dumped sections, report the first offender."""
    from dexnerf_tpu_torch.config import render_settings_from_cfg

    ref_models = cfgs[0].models.dump()
    ref_settings = render_settings_from_cfg(cfgs[0], "train")
    for cfg, path in zip(cfgs[1:], paths[1:]):
        if cfg.models.dump() != ref_models:
            raise SystemExit(
                f"{path}: models section differs from {paths[0]} — "
                "multi-scene training compiles one program across scenes"
            )
        if render_settings_from_cfg(cfg, "train") != ref_settings:
            raise SystemExit(
                f"{path}: nerf.train render settings differ from {paths[0]}"
            )
    return ref_settings


def train_scenes(paths, args, device, mesh=None):
    """Train the scenes of ``paths`` per ``args`` on ``device``: all of them
    in this process, or with ``mesh`` (a ``parallel.multiscene.SceneMesh``)
    this rank's share of the layout, whose row's first rank writes its
    scenes' outputs. Returns ``{"state", "scenes", "metrics", "val",
    "elapsed_sec", "rays_per_sec", "logdirs"}``: this rank's
    ``MultiSceneState``, the global indices of its scenes, their last train
    metrics and last validation scores (scene -> dict), and the logdirs of
    every scene."""
    import numpy as np
    import torch

    from dexnerf_tpu_torch.config import load_config
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.parallel import multiscene as ms
    from dexnerf_tpu_torch.train.checkpoints import write_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import (
        _checkpoint_of,
        _get,
        load_scene,
        setup_models,
        validate,
    )
    from dexnerf_tpu_torch.utils import cast_to_image, write_png

    cfgs = [load_config(p) for p in paths]
    settings = _require_matching(cfgs, paths)
    cfg0 = cfgs[0]
    writer = mesh is None or mesh.data_index == 0
    stores, params_list, logdirs, scenes, seeds = [], [], [], [], []
    for cfg in cfgs:
        scene = load_scene(cfg)
        scenes.append(scene)
        tr = scene.i_train
        stores.append(build_ray_store(
            scene.images[tr], scene.poses[tr], scene.hwf, float(cfg.dataset.near),
            float(cfg.dataset.far), device=device,
            intrinsics=None if scene.intrinsics is None else scene.intrinsics[tr],
            use_ndc=scene.use_ndc,
        ))
        seeds.append(int(_get(cfg.experiment, "randomseed", 42)))
        coarse, fine = setup_models(cfg, seeds[-1], device)
        params_list.append({"coarse": coarse.state_dict(),
                            **({"fine": fine.state_dict()} if fine is not None else {})})
        logdirs.append(os.path.join(str(cfg.experiment.logdir), str(cfg.experiment.id)))

    coarse, fine = setup_models(cfg0, 0, device)
    lr = float(cfg0.optimizer.lr)
    state = ms.init_multi_scene_state(
        coarse, fine, ms.stack_params(params_list), lr,
        float(_get(cfg0.scheduler, "lr_decay", 250.0)),
        float(_get(cfg0.scheduler, "lr_decay_factor", 0.1)),
        opt_type=str(_get(cfg0.optimizer, "type", "Adam")),
    )
    store = ms.stack_ray_stores(stores)
    del stores, params_list
    batch = args.batch or int(cfg0.nerf.train.num_random_rays)
    iters = args.max_iters if args.max_iters is not None else int(cfg0.experiment.train_iters)
    spc = args.steps_per_call or int(_get(cfg0.nerf.train, "steps_per_call", 1) or 1)
    local = list(range(len(cfgs)))
    if mesh is None:
        step = ms.make_multi_scene_train_step(settings, batch, steps_per_call=spc)
    else:
        state, store = ms.shard_multi_scene(state, store, mesh)
        m_local = store.num_scenes
        local = list(range(mesh.scene_index * m_local, (mesh.scene_index + 1) * m_local))
        if mesh.data is None:
            step = ms.make_multi_scene_train_step(settings, batch, steps_per_call=spc)
        else:
            step = ms.make_multi_scene_parallel_train_step(mesh, settings, batch,
                                                           steps_per_call=spc)
    generators = [torch.Generator(device=device).manual_seed(seeds[j]) for j in local]
    metrics_files = {}
    if writer:
        for j in local:
            os.makedirs(logdirs[j], exist_ok=True)
            with open(os.path.join(logdirs[j], "config.yml"), "w") as f:
                f.write(cfgs[j].dump())
            metrics_files[j] = open(os.path.join(logdirs[j], "metrics.jsonl"), "a")
    print_every = int(_get(cfg0.experiment, "print_every", 100) or 100)
    validate_every = int(
        args.validate_every if args.validate_every is not None
        else _get(cfg0.experiment, "validate_every", 0) or 0
    )
    last_val = {}

    def validate_scenes(upto):
        """Each local scene's validation frame on its own weights, through
        the single-scene ``validate`` (kernel 1 on a card)."""
        for i, j in enumerate(local):
            scene = scenes[j]
            val = validate(
                *ms.scene_models(state, i), scene, cfgs[j], supervision="rgb", device=device,
                val_idx=int(scene.i_val[(upto // max(validate_every, 1)) % len(scene.i_val)]),
            )
            last_val[j] = {"val_psnr": float(val["psnr"]), "val_ssim": float(val["ssim"])}
            f = metrics_files[j]
            f.write(json.dumps({"step": upto, **last_val[j]}) + "\n")
            f.flush()
            vdir = os.path.join(logdirs[j], "validation")
            os.makedirs(vdir, exist_ok=True)
            write_png(os.path.join(vdir, f"rgb_{upto:07d}.png"),
                      cast_to_image(np.clip(val["rgb"], 0, 1)))
            print(f"[val {upto}] s{j}: {val['psnr']:.2f} dB ssim {val['ssim']:.3f}", flush=True)

    t0 = time.time()
    i = 0
    metrics = None
    while i < iters:
        metrics = step(state, store, generators)
        last = min(i + spc, iters) - 1
        if writer and validate_every and (
                (last + 1) % validate_every < spc or last == iters - 1):
            validate_scenes(last + 1)
        if writer and ((last + 1) % print_every < spc or last == iters - 1):
            loss = metrics["loss"].cpu().numpy()
            psnr = metrics["psnr"].cpu().numpy()
            print(f"[iter {last + 1}] " + " ".join(
                f"s{j}:{loss[k]:.4f}/{psnr[k]:.1f}dB" for k, j in enumerate(local)), flush=True)
            for k, j in enumerate(local):
                metrics_files[j].write(json.dumps(
                    {"step": last + 1, "loss": float(loss[k]), "psnr": float(psnr[k])}) + "\n")
                metrics_files[j].flush()
        i += spc
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    final = {}
    if metrics is not None:
        final = {j: {k: float(v[n]) for k, v in metrics.items()} for n, j in enumerate(local)}
    if writer and metrics is not None:
        for n, j in enumerate(local):
            ckpt_dir = os.path.join(logdirs[j], "checkpoints")
            os.makedirs(ckpt_dir, exist_ok=True)
            write_reference_checkpoint(
                os.path.join(ckpt_dir, f"checkpoint_{iters - 1:07d}.ckpt"),
                **_checkpoint_of(ms.scene_train_state(state, n), lr, final[j]))
    for f in metrics_files.values():
        f.close()
    return {"state": state, "scenes": local, "metrics": final, "val": last_val,
            "elapsed_sec": dt, "rays_per_sec": len(cfgs) * batch * iters / max(dt, 1e-9),
            "logdirs": logdirs, "iters": iters}


def _scene_rank(mesh, paths, args, layout):
    """One rank of a multi-scene run (``parallel.mesh.spawn_ranks``) on the
    layout ``(scene_devices, data_devices)``: rank 0 returns its summary
    without the state, the others None."""
    from dexnerf_tpu_torch.parallel import multiscene as ms

    scene_devices, data_devices = layout
    smesh = (ms.make_scene_mesh(mesh) if data_devices == 1
             else ms.make_scene_data_mesh(scene_devices, data_devices, mesh))
    out = train_scenes(paths, args, mesh.device, smesh)
    if mesh.rank != 0:
        return None
    out.pop("state")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from dexnerf_tpu_torch.config import load_config
    from dexnerf_tpu_torch.parallel.mesh import spawn_ranks

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")
    paths = args.configs
    _require_matching([load_config(p) for p in paths], paths)
    m = len(paths)
    # the devices of the layout: the cards, or on the CPU the ranks asked for
    n_dev = torch.cuda.device_count() if device.type == "cuda" else (args.data_devices or 1)
    layout = None
    if args.data_devices and args.data_devices > 1:
        k = args.data_devices
        if n_dev % k:
            raise SystemExit(
                f"--data-devices {k} does not divide the {n_dev} available "
                f"devices — {n_dev % k} chips would sit idle"
            )
        n_scene_dev = n_dev // k
        if n_scene_dev < 1 or m % max(n_scene_dev, 1):
            raise SystemExit(
                f"--data-devices {k}: needs {m} scenes divisible "
                f"over {n_dev}//{k} = {n_scene_dev} scene-axis devices"
            )
        layout = (n_scene_dev, k)
        print(f"2-D mesh: {m} scenes over {n_scene_dev} scene-devices x {k} data-devices each")
    elif m % n_dev == 0 and n_dev > 1:
        layout = (n_dev, 1)
        print(f"sharding {m} scenes over {n_dev} devices")
    if layout is None:
        out = train_scenes(paths, args, device)
    else:
        out = spawn_ranks(_scene_rank, n_dev, device.type, (paths, args, layout))[0]
    print(
        f"done: {m} scenes x {out['iters']} iters in {out['elapsed_sec']:.1f}s "
        f"({out['rays_per_sec']:.0f} rays/s aggregate)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
