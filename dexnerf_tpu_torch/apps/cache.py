"""Offline ray cache (the reference's ``cache_dataset.py``), on a CUDA card
unless ``--device cpu`` is given.

Counterpart of ``dexnerf_tpu/apps/cache.py``:

    python -m dexnerf_tpu_torch.apps.cache --datapath data/lego --savedir cache/legocache
    python -m dexnerf_tpu_torch.apps.cache --type messytable --datapath ... --torch-format

Writes ``--num-variations`` train shards a train image, each
``--num-random-rays`` of its rays drawn with replacement by the host
gather of ``ops/csrc/host_rows.cc`` (the JAX package's generator, so the
two packages cache the same rows), and one full-image bundle a
validation image. Shard schema (reference ``cache_dataset.py:104-132``):
``train/NNNN`` ``{height, width, focal_length, ray_bundle[2, N, 3],
target[N, 3]}``, ``val/NNNN`` ``{height, width, focal_length,
ray_origins, ray_directions, target}``, as ``.npz`` or, with
``--torch-format``, as the reference's ``torch.save`` ``.data``. The rays
are c2w rays for blender and LLFF, w2c + K rays for messytable, never in
NDC. ``run_training`` trains from ``dataset.cachedir/train`` when it
exists and no depth supervision is asked for.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Write an offline ray cache with the PyTorch port")
    p.add_argument("--datapath", type=str, required=True)
    p.add_argument("--type", type=str, default="blender",
                   choices=["blender", "llff", "messytable"])
    p.add_argument("--savedir", type=str, required=True)
    p.add_argument("--halfres", action="store_true")
    p.add_argument("--num-random-rays", type=int, default=8192)
    p.add_argument("--num-variations", type=int, default=1,
                   help="sampled shards per train image")
    p.add_argument("--testskip", type=int, default=1)
    p.add_argument("--torch-format", action="store_true",
                   help="write reference-format torch.save .data shards "
                        "(cache_dataset.py:104-132) instead of .npz")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the rays are generated (default: the card)")
    return p


def load_views(args):
    """``(images, poses, hwf, i_train, i_val, intrinsics)`` of the dataset
    named by ``args``: c2w poses, or w2c poses with their K (messytable)."""
    intrinsics = None
    if args.type == "blender":
        from dexnerf_tpu_torch.data.blender import load_blender_data

        images, poses, _, hwf, i_split = load_blender_data(
            args.datapath, half_res=args.halfres, testskip=args.testskip)
        i_train, i_val = i_split[0], i_split[1]
    elif args.type == "messytable":
        from dexnerf_tpu_torch.data.messytable import load_messytable_data

        images, poses, _, hwf, i_split, intrinsics, _ = load_messytable_data(
            args.datapath, half_res=args.halfres, testskip=args.testskip)
        i_train, i_val = i_split[0], i_split[1]
    else:
        from dexnerf_tpu_torch.data.llff import load_llff_data

        images, poses_llff, _, _, i_test = load_llff_data(args.datapath)
        hwf = [int(poses_llff[0, 0, 4]), int(poses_llff[0, 1, 4]), float(poses_llff[0, 2, 4])]
        n = images.shape[0]
        poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        poses[:, :3, :4] = poses_llff[:, :3, :4]
        i_val = np.array([i_test])
        i_train = np.array([i for i in range(n) if i != i_test])
    return images, poses, hwf, i_train, i_val, intrinsics


def cache_nerf_dataset(args) -> None:
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, get_ray_bundle_w2c
    from dexnerf_tpu_torch.ops.host_rows import gather_random_rows

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")
    images, poses, hwf, i_train, i_val, intrinsics = load_views(args)
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    for split in ("train", "val"):
        os.makedirs(os.path.join(args.savedir, split), exist_ok=True)

    def save_shard(split: str, stem: str, payload: dict) -> None:
        if args.torch_format:
            out = {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                   else v for k, v in payload.items()}
            torch.save(out, os.path.join(args.savedir, split, stem + ".data"))
        else:
            np.savez(os.path.join(args.savedir, split, stem + ".npz"), **payload)

    def bundle(idx: int):
        pose = torch.as_tensor(np.asarray(poses[idx], np.float32), device=device)
        if intrinsics is not None:
            K = torch.as_tensor(np.asarray(intrinsics[idx], np.float32), device=device)
            ro, rd = get_ray_bundle_w2c(H, W, pose, K)
        else:
            ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
        return ro.cpu().numpy(), rd.cpu().numpy()

    shard = 0
    for idx in i_train:
        ro, rd = bundle(int(idx))
        target = images[int(idx)][..., :3].reshape(-1, 3)
        packed = np.concatenate([ro.reshape(-1, 3), rd.reshape(-1, 3), target], axis=-1)
        for _ in range(args.num_variations):
            rows = gather_random_rows(packed, seed=shard,
                                      batch=min(args.num_random_rays, packed.shape[0]))
            save_shard("train", f"{shard:04d}", dict(
                height=H, width=W, focal_length=focal,
                ray_bundle=np.stack([rows[:, 0:3], rows[:, 3:6]], 0), target=rows[:, 6:9]))
            shard += 1
    for k, idx in enumerate(i_val):
        ro, rd = bundle(int(idx))
        save_shard("val", f"{k:04d}", dict(
            height=H, width=W, focal_length=focal, ray_origins=ro, ray_directions=rd,
            target=images[int(idx)][..., :3]))
    print(f"cached {shard} train shards, {len(i_val)} val bundles -> {args.savedir}")


def main(argv=None) -> int:
    cache_nerf_dataset(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
