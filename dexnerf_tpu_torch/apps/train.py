"""Training CLI, on a CUDA card unless ``--device cpu`` is given.

Counterpart of ``dexnerf_tpu/apps/train.py``:

    python -m dexnerf_tpu_torch.apps.train --config configs/lego-tpu.yml --device cuda
    python -m dexnerf_tpu_torch.apps.train --config ... --ir          # luminance loss
    python -m dexnerf_tpu_torch.apps.train --config ... --load-checkpoint model.ckpt
    python -m dexnerf_tpu_torch.apps.train --config configs/messytable-obj.yml \
        --ir --dex --depth-loss 0.1 --depth-warmup 1000   # Dex-NeRF on messytable
    python -m dexnerf_tpu_torch.apps.train --config ... --occupancy 0.2  # empty-space skipping
    python -m dexnerf_tpu_torch.apps.train --config ... --pose-opt  # refine the camera poses
    python -m dexnerf_tpu_torch.apps.train --config ... --sg-ir     # shaded active-IR loss
    python -m dexnerf_tpu_torch.apps.train --config ... --num-devices 4  # data-parallel

With ``nerf.use_pallas`` every render pass of every step goes through the
fused train-loss kernel (with ``nerf.pallas_loss_resample: pallas``, the
resample between the passes through the fused resample kernel), or, with
``nerf.pallas_fused_loss: false``, through the fused field kernels
(forward and backward). ``--dex`` validates with the σ-threshold depth
sweep; ``--depth-loss`` / ``--depth-warmup`` supervise the expected depth
with the dataset's GT depth (inside the fused train-loss kernel when it
runs). ``--pose-opt`` trains a correction twist per train view with the
fields (through the plain render: the kernels give no ray gradients).
``--sg-ir`` supervises the shaded active-IR luminance of ``render/sg_ir.py``
(the plain render too, for the point gradients of its normals; validation
through the fused render). ``--num-devices N`` trains data-parallel over N
ranks, one a card (NCCL) or, with ``--device cpu``, N processes (gloo). A
``dataset.cachedir`` holding ``apps.cache`` shards is trained from, as in
the JAX package.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a NeRF with the PyTorch port")
    p.add_argument("--config", type=str, required=True, help="YAML config path")
    p.add_argument(
        "--load-checkpoint", type=str, default="",
        help="resume from a reference .ckpt (models + Adam moments + iter) or the "
        "latest checkpoint_<i>.ckpt of a directory",
    )
    p.add_argument(
        "--auto-resume", action="store_true",
        help="resume from the latest checkpoint under <logdir>/checkpoints when one exists",
    )
    p.add_argument("--max-iters", type=int, default=None, help="override train_iters")
    p.add_argument(
        "--sampling", type=str, default=None, choices=("uniform", "per_image"),
        help="uniform over all training rays, or one image per iteration "
        "(train_nerf_rgb.py:222-241); overrides cfg.nerf.train.sampling",
    )
    p.add_argument(
        "--steps-per-call", type=int, default=None,
        help="optimizer steps per call of the train step; overrides "
        "cfg.nerf.train.steps_per_call",
    )
    p.add_argument("--ir", action="store_true", help="Rec.601-luminance MSE instead of RGB MSE")
    p.add_argument(
        "--dex", action="store_true",
        help="Dex-NeRF validation: sigma-threshold depth sweep, the threshold of least "
        "abs error kept",
    )
    p.add_argument(
        "--depth-loss", type=float, default=None,
        help="GT-depth supervision weight: adds weight * masked depth MSE of the expected "
        "depth (valid mask 0 < d < depth_valid_max of nerf.train, else of the dataset); "
        "overrides cfg.nerf.train.depth_loss_weight",
    )
    p.add_argument(
        "--depth-warmup", type=int, default=None, metavar="N",
        help="with --depth-loss: the first N iterations without the depth term (-1: until "
        "the train PSNR passes nerf.train.depth_warmup_psnr, default 14 dB); overrides "
        "cfg.nerf.train.depth_warmup",
    )
    p.add_argument(
        "--occupancy", type=float, default=None, metavar="SIGMA",
        help="occupancy-guided training: bake a σ > SIGMA occupancy grid from the "
        "in-progress field (at cfg.nerf.train.occupancy_start_iter, re-baked every "
        "occupancy_rebake_every iters) and tighten every stored ray's [near, far] to its "
        "occupied span; overrides cfg.nerf.train.occupancy. World-space scenes only (not "
        "NDC). Use a σ far below the scene's surface threshold (~0.2)",
    )
    p.add_argument(
        "--pose-opt", action="store_true",
        help="SE(3) camera-pose refinement: a correction twist per train view trains with the "
        "fields (train/pose_opt.py); its Adam's lr is cfg.optimizer.pose_lr (default 1e-3)",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=("cuda", "cpu"),
        help="where the models train (default: the card)",
    )
    p.add_argument(
        "--sg-ir", action="store_true",
        help="active-IR supervision through the SG shader (render/sg_ir.py): a learnable "
        "co-located projector + environment lobes shade density-gradient normals; the "
        "shaded luminance is matched to the IR frames. Exclusive with --ir",
    )
    p.add_argument(
        "--num-devices", type=int, default=None,
        help="train data-parallel over this many devices, one process each (default: 1)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sg_ir and args.ir:
        raise SystemExit("--sg-ir and --ir are mutually exclusive")  # JAX's words
    if args.pose_opt and args.sg_ir:
        raise NotImplementedError("pose_opt + sg_ir is not supported")  # JAX's words
    from dexnerf_tpu_torch.config import load_config
    from dexnerf_tpu_torch.train.loop import run_training

    out = run_training(
        load_config(args.config),
        dex=args.dex,
        supervision="sg_ir" if args.sg_ir else ("luminance" if args.ir else "rgb"),
        load_ckpt=args.load_checkpoint or None,
        auto_resume=args.auto_resume,
        max_iters=args.max_iters,
        sampling=args.sampling,
        steps_per_call=args.steps_per_call,
        depth_loss_weight=args.depth_loss,
        depth_warmup=args.depth_warmup,
        occupancy=args.occupancy,
        pose_opt=args.pose_opt or None,
        num_devices=args.num_devices,
        device=args.device,
    )
    print(
        f"done: {out['rays_per_sec']:.0f} rays/s, "
        f"final train metrics {out['final_train_metrics']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
