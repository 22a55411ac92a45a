"""Tiny-NeRF teaching pipeline, on a CUDA card unless ``--device cpu`` is
given.

Counterpart of ``dexnerf_tpu/apps/tiny.py`` (reference ``tiny_nerf.py``):
a self-contained, coarse-only NeRF (uniform depth samples with jitter, no
hierarchy), ``VeryTinyNeRFModel`` (3 layers of 128 over position encodings
at 6 frequencies), Adam at 5e-3 with the 250k-step 0.1 decay, trained on
``--data`` (the classic ``tiny_nerf_data.npz``) or, without it, on a
synthetic 64x64 scene of 16 views; the last view is held out::

    python -m dexnerf_tpu_torch.apps.tiny --outdir tiny_nerf_out --iters 1000
    python -m dexnerf_tpu_torch.apps.tiny --device cpu --iters 50 --batch-rays 256

Every ``--display-every`` iterations (and at the last) the held-out view
is rendered and scored: ``render_<iter>.png``, the matplotlib snapshot
``snapshot_<iter>.png`` where matplotlib imports, and at the end
``psnr.txt`` (iteration, PSNR).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Tiny-NeRF with the PyTorch port")
    p.add_argument("--data", type=str, default="",
                   help="path to tiny_nerf_data.npz (optional)")
    p.add_argument("--outdir", type=str, default="tiny_nerf_out")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--num-samples", type=int, default=32)
    p.add_argument("--batch-rays", type=int, default=1024)
    p.add_argument("--display-every", type=int, default=100)
    p.add_argument(
        "--device", type=str, default="cuda", choices=("cuda", "cpu"),
        help="where the model trains (default: the card)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from dexnerf_tpu_torch.core.metrics import mse2psnr
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from dexnerf_tpu_torch.models import VeryTinyNeRFModel
    from dexnerf_tpu_torch.render.renderer import RenderSettings, render_image
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step
    from dexnerf_tpu_torch.utils.images import cast_to_image, write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")

    near, far = 2.0, 6.0
    if args.data and os.path.exists(args.data):
        z = np.load(args.data)
        images = z["images"].astype(np.float32)
        poses = z["poses"].astype(np.float32)
        H, W = images.shape[1:3]
        focal = float(z["focal"])
    else:
        images, _, poses, (H, W, focal) = make_synthetic_scene(
            num_views=16, height=64, width=64, device=device
        )
    hwf = [H, W, focal]
    # hold out the last view
    train_imgs, train_poses = images[:-1], poses[:-1]
    test_img = torch.as_tensor(images[-1], device=device)
    test_pose = torch.as_tensor(poses[-1], device=device)

    enc = 6
    settings = RenderSettings(
        num_coarse=args.num_samples,
        num_fine=0,
        perturb=True,
        num_encoding_fn_xyz=enc,
        num_encoding_fn_dir=enc,
        include_input_xyz=True,
        include_input_dir=True,
    )
    model = VeryTinyNeRFModel(num_encoding_functions=enc)
    # a fixed seed for the weights and the draws, as JAX's PRNGKey(0)
    model.reset_parameters(torch.Generator().manual_seed(0)).to(device)
    store = build_ray_store(train_imgs, train_poses, hwf, near, far, device=device)
    state = init_train_state(model, None, 5e-3, lr_decay=250, lr_decay_factor=0.1)
    step = make_train_step(settings, args.batch_rays)
    generator = torch.Generator(device=device).manual_seed(0)
    ro, rd = get_ray_bundle_c2w(H, W, focal, test_pose)

    os.makedirs(args.outdir, exist_ok=True)
    psnrs = []
    t0 = time.time()
    for i in range(args.iters):
        metrics = step(state, store, generator)
        if i % args.display_every == 0 or i == args.iters - 1:
            with torch.no_grad():
                out = render_image(model, None, ro, rd, near, far, settings.eval_variant())
            rgb = out.coarse.rgb
            psnr = mse2psnr(float(torch.mean((rgb - test_img) ** 2)))
            psnrs.append((i, psnr))
            print(f"iter {i}: train loss {float(metrics['loss']):.4f}, "
                  f"holdout PSNR {psnr:.2f} ({time.time() - t0:.1f}s)", flush=True)
            rgb = rgb.cpu().numpy()
            write_png(os.path.join(args.outdir, f"render_{i:05d}.png"), cast_to_image(rgb))
            _save_snapshot(os.path.join(args.outdir, f"snapshot_{i:05d}.png"), rgb, psnrs)
    np.savetxt(os.path.join(args.outdir, "psnr.txt"), np.asarray(psnrs))
    return 0


def _save_snapshot(path: str, rgb: np.ndarray, psnrs) -> None:
    """The reference's matplotlib snapshot: held-out render next to the
    PSNR curve (``tiny_nerf.py:302-332``). Skipped where matplotlib does
    not import (the card's machine has none)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    arr = np.asarray(psnrs, dtype=np.float64).reshape(-1, 2)
    fig, (ax_img, ax_psnr) = plt.subplots(1, 2, figsize=(9, 4))
    ax_img.imshow(np.clip(rgb, 0, 1))
    ax_img.set_title(f"iter {int(arr[-1, 0])}")
    ax_img.axis("off")
    ax_psnr.plot(arr[:, 0], arr[:, 1])
    ax_psnr.set_title("holdout PSNR")
    ax_psnr.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


if __name__ == "__main__":
    raise SystemExit(main())
