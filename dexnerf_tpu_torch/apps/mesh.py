"""σ-isosurface mesh export from a checkpoint (marching tetrahedra), on a
CUDA card unless ``--device cpu`` is given.

Counterpart of ``dexnerf_tpu/apps/mesh.py``: extracts the density field's
σ = m surface, the threshold family of the Dex-NeRF depth (reference
``volume_rendering_utils.py:51-58``), as a triangle mesh (ASCII PLY)::

    python -m dexnerf_tpu_torch.apps.mesh --config configs/lego.yml \\
        --checkpoint model.ckpt --out lego.ply \\
        --sigma-threshold 15 --resolution 128 --radius 1.5 --device cuda

σ is evaluated on the device in batches of grid points through the plain
field the renderer uses (the fine model when the checkpoint has one), on a
lattice of corner nodes (``render/occupancy.py::eval_sigma_grid``);
extraction runs on the host (``utils/mesh.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a NeRF's σ isosurface with the PyTorch port")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True, help="a reference .ckpt")
    p.add_argument("--out", type=str, default="mesh.ply")
    p.add_argument(
        "--sigma-threshold", type=float, default=15.0,
        help="σ isovalue m (the Dex-NeRF threshold family; the depth sweep's best threshold "
        "is a good choice)",
    )
    p.add_argument("--resolution", type=int, default=128, help="grid resolution per axis")
    p.add_argument("--radius", type=float, default=1.5,
                   help="half-extent of the sampled cube around --center")
    p.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="world-space center of the sampled cube")
    p.add_argument("--batch", type=int, default=65536, help="grid points per device batch")
    p.add_argument(
        "--device", type=str, default="cuda", choices=("cuda", "cpu"),
        help="where the field evaluates σ (default: the card)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.render.occupancy import eval_sigma_grid
    from dexnerf_tpu_torch.render.renderer import make_mlp_field
    from dexnerf_tpu_torch.train.loop import load_eval_params, setup_models
    from dexnerf_tpu_torch.utils.mesh import marching_tetrahedra, write_ply_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")
    cfg = load_config(args.config)
    cfg, sds, _, _ = load_eval_params(cfg, args.checkpoint)
    coarse, fine = setup_models(cfg, int(cfg.experiment.randomseed), device)
    use_fine = fine is not None and "fine" in sds
    model = fine if use_fine else coarse
    model.load_state_dict(sds["fine" if use_fine else "coarse"])
    s = render_settings_from_cfg(cfg, "validation").eval_variant()
    print(f"sampling σ on a {args.resolution}^3 grid ({'fine' if use_fine else 'coarse'} field)")

    n = args.resolution
    spacing = 2.0 * float(args.radius) / max(n - 1, 1)
    center = np.asarray(args.center, np.float32)
    t0 = time.time()
    # corner nodes, not cell centers: marching tetrahedra interpolates
    # between lattice nodes, so the nodes must span the cube inclusively
    sigma = eval_sigma_grid(
        make_mlp_field(model, s), device=device, center=tuple(center),
        radius=float(args.radius), resolution=n, batch=int(args.batch), style="corners",
    ).cpu().numpy()
    print(f"σ grid in {time.time() - t0:.1f}s (min {sigma.min():.2f}, max {sigma.max():.1f}, "
          f"mean {sigma.mean():.2f})")

    verts, faces = marching_tetrahedra(
        sigma, float(args.sigma_threshold), origin=tuple(center - args.radius),
        spacing=(spacing,) * 3,
    )
    if verts.shape[0] == 0:
        print(
            f"no surface at σ = {args.sigma_threshold} — pick an isovalue "
            f"inside the grid's range [{sigma.min():.2f}, "
            f"{sigma.max():.2f}], or change --radius/--center"
        )
        return 1
    write_ply_mesh(args.out, verts, faces)
    print(f"wrote {args.out}: {verts.shape[0]} vertices, {faces.shape[0]} faces")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
