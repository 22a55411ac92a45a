"""Novel-view rendering and held-out scoring from a checkpoint, on a CUDA
card unless ``--device cpu`` is given.

Counterpart of ``dexnerf_tpu/apps/eval.py`` (reference ``eval_nerf.py``):
loads a config and a reference ``.ckpt``, renders the dataset's camera path
(``render_poses``), or with ``--test-set`` its held-out views scored against
ground truth, to PNGs, with optional disparity, jet disparity, depth
confidence, point clouds and a GIF. Blender, messytable (w2c + K rays) and
LLFF (NDC rays) scenes share one path; every frame goes through the fused
render kernel (kernel 1) at ``train/loop.py::render_compute_dtype``.

    python -m dexnerf_tpu_torch.apps.eval --config configs/messytable-obj.yml \\
        --checkpoint model.ckpt --test-set --dex-depth \\
        --save-pointcloud --pointcloud-threshold 50 --device cuda

``--test-set`` writes ``<savedir>/metrics.json``: per-image and mean PSNR
and SSIM, with GT depth the expected depth's millimeter errors, and with
``--dex-depth`` the σ-threshold sweep's errors at the threshold of least
abs error (``dex_*``, ``dex_best_m``) and which GT they were scored against
(``dex_gt``). LLFF depths, NDC ray parameters, are scored as metric ray
distances through ``core.rays.ndc_t_to_world_depth``. ``--occupancy SIGMA``
bakes a σ-occupancy grid from the checkpoint once and tightens every
frame's ray intervals to their occupied spans (``render/occupancy.py``).
``--refined-poses`` renders the train views at the cameras that ``apps.train
--pose-opt`` refined (the twists of the checkpoint). ``--sg-ir`` also renders
each frame's shaded active-IR view of a checkpoint trained with ``apps.train
--sg-ir`` (``render/sg_ir.py``, the plain field: its normals need point
gradients) into ``<savedir>/ir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

def add_occupancy_flags(p: argparse.ArgumentParser) -> None:
    """The seven ``--occupancy*`` flags that eval and serve share."""
    p.add_argument(
        "--occupancy", type=float, default=None, metavar="SIGMA",
        help="empty-space skipping: bake a σ > SIGMA occupancy grid from the checkpoint once, "
        "then tighten each ray's [near, far] to its occupied span before sampling. Pick SIGMA "
        "far below the surface threshold (~0.2) so semi-transparent fringes stay inside the "
        "interval. World-space scenes only (not NDC/llff)",
    )
    p.add_argument("--occupancy-resolution", type=int, default=128,
                   help="occupancy grid resolution per axis")
    p.add_argument("--occupancy-radius", type=float, default=1.5,
                   help="half-extent of the occupancy cube around --occupancy-center")
    p.add_argument("--occupancy-center", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   help="world-space center of the occupancy cube")
    p.add_argument("--occupancy-dilate", type=int, default=1,
                   help="binary dilation rounds on the baked grid (safety margin)")
    p.add_argument("--occupancy-probes", type=int, default=128,
                   help="fixed probe count per ray for interval tightening")
    p.add_argument(
        "--occupancy-subsample", type=int, default=2,
        help="probe every Nth pixel per axis and spread the intervals conservatively; 1 "
        "probes every ray",
    )


def bake_occupancy(args, coarse, fine, settings, device):
    """The occupancy grid of ``--occupancy`` (None without it), baked from
    the fine field when there is one: the plain model on ``device``."""
    if args.occupancy is None:
        return None
    from dexnerf_tpu_torch.render.occupancy import build_occupancy_grid
    from dexnerf_tpu_torch.render.renderer import make_mlp_field

    t0 = time.time()
    grid = build_occupancy_grid(
        make_mlp_field(fine if fine is not None else coarse, settings), device=device,
        sigma_threshold=float(args.occupancy), center=tuple(args.occupancy_center),
        radius=float(args.occupancy_radius), resolution=int(args.occupancy_resolution),
        dilate=int(args.occupancy_dilate),
    )
    frac = grid.occupancy_fraction()
    print(f"occupancy grid {args.occupancy_resolution}^3 (σ > {args.occupancy}) baked in "
          f"{time.time() - t0:.1f}s — {100.0 * frac:.1f}% occupied")
    if frac == 0.0:
        print("WARNING: grid is empty — no tightening will happen; lower --occupancy or move "
              "--occupancy-center/radius")
    return grid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render and score a NeRF with the PyTorch port")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True, help="a reference .ckpt")
    p.add_argument("--savedir", type=str, default="renders")
    p.add_argument("--save-disparity-image", action="store_true")
    p.add_argument(
        "--save-jet-disparity", action="store_true",
        help="also save jet-colormapped disparity (reference eval_nerf.py:196-205)",
    )
    p.add_argument(
        "--save-depth-confidence", type=float, default=None, metavar="DELTA",
        help="write per-pixel depth-confidence maps (the weight mass within ±DELTA of the "
        "expected depth, in z units: meters, or NDC units for llff) to <savedir>/confidence/; "
        "with --test-set the per-image mean joins metrics.json",
    )
    p.add_argument("--num-poses", type=int, default=None, help="limit the render path length")
    p.add_argument(
        "--hwf", type=float, nargs=3, default=None, metavar=("H", "W", "FOCAL"),
        help="frame height/width/focal override; also enables dataset-free rendering of "
        "blender scenes (the spherical path) when the dataset is absent",
    )
    p.add_argument(
        "--save-gif", action="store_true",
        help="also assemble the rendered frames into <savedir>/render.gif",
    )
    p.add_argument("--gif-fps", type=float, default=10.0, help="frames per second for --save-gif")
    p.add_argument(
        "--save-pointcloud", action="store_true",
        help="back-project each frame's depth into a colored point cloud "
        "(<savedir>/pointcloud/NNNN.ply, ASCII PLY): the expected depth, or the Dex-NeRF "
        "σ-threshold depth with --pointcloud-threshold",
    )
    p.add_argument(
        "--pointcloud-threshold", type=float, default=None,
        help="σ threshold of the point cloud's depth: the nearest configured candidate",
    )
    p.add_argument(
        "--samples", type=int, nargs=2, default=None, metavar=("COARSE", "FINE"),
        help="override nerf.validation.num_coarse/num_fine",
    )
    p.add_argument(
        "--test-set", action="store_true",
        help="render the held-out test views and score them (<savedir>/metrics.json)",
    )
    p.add_argument(
        "--dex-depth", action="store_true",
        help="with --test-set: also score the σ-threshold depth over the "
        "nerf.validation.m_thres sweep at the threshold of least abs error "
        "(train_dexnerf_rgb.py:393-427), against d_dex_<k>.npy sidecars when the dataset "
        "has them, else against the expected-depth GT",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=("cuda", "cpu"),
        help="where the field lives and renders (default: the card)",
    )
    p.add_argument(
        "--refined-poses", action="store_true",
        help="render the TRAIN views at their pose-refined cameras, the twists of a checkpoint "
        "written by apps.train --pose-opt (one PNG per train view)",
    )
    add_occupancy_flags(p)
    p.add_argument(
        "--sg-ir", action="store_true",
        help="also render the shaded active-IR view (render/sg_ir.py) into <savedir>/ir; "
        "requires a checkpoint trained with --sg-ir (it carries the SG shading leaves)",
    )
    return p


def _load_scene_or_path(cfg, args, ck_hwf):
    """The dataset's scene, or, when it is absent, a blender scene with only
    the spherical render path (dataset-free rendering of a reference
    ``.ckpt`` that carries, or is given, its frame geometry)."""
    from dexnerf_tpu_torch.data.blender import spherical_render_poses
    from dexnerf_tpu_torch.train.loop import SceneData, load_scene

    try:
        return load_scene(cfg)
    except (FileNotFoundError, OSError):
        hwf = args.hwf if args.hwf is not None else ck_hwf
        is_blender = str(cfg.dataset.type).lower() == "blender"
        needs_dataset = args.test_set or args.refined_poses
        if needs_dataset or not is_blender or hwf is None:
            if needs_dataset:
                raise
            if not is_blender:
                raise SystemExit(
                    f"dataset at {cfg.dataset.basedir} not found; dataset-free rendering "
                    "synthesizes the blender spherical orbit only (this config is "
                    f"'{cfg.dataset.type}') — restore the dataset"
                )
            raise SystemExit(
                f"dataset at {cfg.dataset.basedir} not found, and dataset-free rendering "
                "needs the frame geometry: pass --hwf H W FOCAL (the shipped *-lowres "
                "scenes are `--hwf 400 400 555.555`)"
            )
    print(
        f"dataset at {cfg.dataset.basedir} not found; rendering the spherical path at "
        f"H/W/focal {int(hwf[0])}/{int(hwf[1])}/{float(hwf[2]):.3f}"
    )
    return SceneData(
        images=np.zeros((0, 1, 1, 3), np.float32),
        poses=np.zeros((0, 4, 4), np.float32),
        hwf=[int(hwf[0]), int(hwf[1]), float(hwf[2])],
        i_train=np.zeros((0,), np.int64),
        i_val=np.zeros((0,), np.int64),
        render_poses=spherical_render_poses(),
    )


def _dex_gt(cfg, scene):
    """The σ-surface sidecars (``d_dex_<k>.npy``) of a blender or LLFF
    scene, or None."""
    ds = cfg.dataset
    kind = str(ds.type).lower()
    if kind == "blender":
        from dexnerf_tpu_torch.data.blender import load_blender_depths

        return load_blender_depths(
            ds.basedir, testskip=int(ds.get("testskip", 1) or 1),
            half_res=bool(ds.get("half_res", False)), debug=bool(ds.get("debug", False)),
            prefix="d_dex_",
        )
    if kind == "llff":
        from dexnerf_tpu_torch.data.llff import load_llff_depths

        return load_llff_depths(ds.basedir, len(scene.images), prefix="d_dex_")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.test_set and args.refined_poses:
        raise SystemExit(
            "--test-set scores the held-out views; --refined-poses renders "
            "the train views — pick one"
        )
    if args.save_depth_confidence is not None and args.occupancy is not None:
        raise SystemExit(
            "--save-depth-confidence reconstructs full-interval z-values; "
            "--occupancy tightens per-ray intervals — pick one"
        )
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.metrics import compute_err_metric, depth_error_img, mse2psnr, ssim
    from dexnerf_tpu_torch.core.rays import (
        _rotate,
        get_ray_bundle_c2w,
        get_ray_bundle_w2c,
        ndc_t_to_world_depth,
    )
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import depth_confidence
    from dexnerf_tpu_torch.render.renderer import render_image
    from dexnerf_tpu_torch.train.loop import fused_render_impl, load_eval_params, setup_models
    from dexnerf_tpu_torch.train.pose_opt import camera_dirs
    from dexnerf_tpu_torch.utils import (
        apply_jet_colormap,
        cast_to_disparity_image,
        cast_to_gray_image,
        cast_to_image,
        depth_to_points,
        write_gif,
        write_ply,
        write_png,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")
    cfg = load_config(args.config)
    cfg, sds, ck_hwf, imported = load_eval_params(cfg, args.checkpoint)
    scene = _load_scene_or_path(cfg, args, ck_hwf)
    coarse, fine = setup_models(cfg, int(cfg.experiment.randomseed), device)
    coarse.load_state_dict(sds["coarse"])
    if fine is not None and "fine" in sds:
        fine.load_state_dict(sds["fine"])
    else:
        fine = None

    H, W, focal = scene.hwf
    if ck_hwf is not None:
        H, W, focal = ck_hwf
    if args.hwf is not None:
        H, W, focal = int(args.hwf[0]), int(args.hwf[1]), float(args.hwf[2])

    want_dex_pc = args.pointcloud_threshold is not None
    if want_dex_pc and not args.save_pointcloud:
        raise SystemExit("--pointcloud-threshold needs --save-pointcloud")
    if args.dex_depth and not args.test_set:
        raise SystemExit("--dex-depth scores the test set: add --test-set")
    s_val = render_settings_from_cfg(
        cfg, "validation", dex=want_dex_pc or args.dex_depth).eval_variant()
    cands = tuple(s_val.m_thres_cand)
    if args.dex_depth and not cands:
        raise SystemExit(
            "--dex-depth: the config defines no dex threshold candidates "
            "(set nerf.validation.m_thres)"
        )
    pc_thres_idx = None
    if want_dex_pc:
        if not cands:
            raise SystemExit(
                "--pointcloud-threshold: the config defines no dex threshold candidates "
                "(nerf.validation.m_thres)"
            )
        pc_thres_idx = int(np.argmin(np.abs(np.asarray(cands) - args.pointcloud_threshold)))
        print(f"pointcloud: σ-threshold depth at m={cands[pc_thres_idx]} "
              f"(nearest to requested {args.pointcloud_threshold})")
    if args.samples is not None:
        s_val = dataclasses.replace(
            s_val, num_coarse=int(args.samples[0]), num_fine=int(args.samples[1]))
        print(f"sample counts overridden: {s_val.num_coarse} coarse + {s_val.num_fine} fine")
    rays_impl = fused_render_impl(cfg, s_val, device, coarse, fine)
    if args.occupancy is not None and scene.use_ndc:
        raise SystemExit(
            "--occupancy is world-space; NDC (llff) scenes reparameterize the frustum — "
            "unsupported"
        )
    occupancy = bake_occupancy(args, coarse, fine, s_val, device)

    test_indices = test_intrinsics = refined_intrinsics = None
    if args.refined_poses:
        from dexnerf_tpu_torch.train.checkpoints import POSE_KEY
        from dexnerf_tpu_torch.train.pose_opt import c2w_from_w2c, refined_c2w

        if POSE_KEY not in imported:
            raise SystemExit(
                "--refined-poses: checkpoint has no 'pose' twists subtree "
                "(train with apps.train --pose-opt first)"
            )
        base = scene.poses[scene.i_train][:, :4, :4].astype(np.float32)
        if scene.intrinsics is not None:
            # messytable: the twists act on c2w = inv(w2c), with the train views' K
            base = c2w_from_w2c(base)
            refined_intrinsics = scene.intrinsics[scene.i_train]
        poses = refined_c2w(torch.as_tensor(base),
                            torch.as_tensor(imported[POSE_KEY]["twists"])).numpy()
    elif args.test_set:
        held_out = scene.i_test if scene.i_test is not None else scene.i_val
        test_indices = [int(t) for t in np.asarray(held_out).ravel()]
        poses = scene.poses[test_indices]
        if scene.intrinsics is not None:
            test_intrinsics = scene.intrinsics[test_indices]
    else:
        poses = scene.render_poses
    if args.num_poses:
        poses = poses[: args.num_poses]
        if test_indices is not None:
            test_indices = test_indices[: args.num_poses]

    os.makedirs(args.savedir, exist_ok=True)
    for flag, sub in ((args.save_disparity_image, "disparity"),
                      (args.save_jet_disparity, "disparity_jet"),
                      (args.save_pointcloud, "pointcloud"),
                      (args.save_depth_confidence is not None, "confidence")):
        if flag:
            os.makedirs(os.path.join(args.savedir, sub), exist_ok=True)

    sg_params = None
    if args.sg_ir:
        from dexnerf_tpu_torch.render.sg_ir import render_sg_ir_image
        from dexnerf_tpu_torch.train.checkpoints import SG_KEY

        if SG_KEY not in imported:
            # JAX's words (dexnerf_tpu/apps/eval.py:394-399)
            raise SystemExit(
                "--sg-ir: checkpoint has no 'sg' shading subtree "
                "(train with apps.train --sg-ir first)"
            )
        os.makedirs(os.path.join(args.savedir, "ir"), exist_ok=True)
        sg_params = {k: torch.as_tensor(v).to(device)
                     for k, v in imported[SG_KEY]["params"].items()}
        # the falloff the model was trained with (train/loop.py passes the same key)
        sg_falloff = bool(cfg.nerf.train.get("sg_distance_falloff", True))
    need_test_depth = args.test_set and scene.depths is not None
    score_dex = args.dex_depth and need_test_depth
    depths_dex_gt = None
    if score_dex:
        depths_dex_gt = _dex_gt(cfg, scene)
        print("dex-depth GT: " + ("σ-surface sidecars (d_dex_*.npy)" if depths_dex_gt is not None
                                  else "expected-depth sidecars (no d_dex_*.npy found)"))
    if args.dex_depth and args.test_set and scene.depths is None:
        raise SystemExit(
            "--dex-depth: the dataset carries no depth sidecars (d_*.npy) — no ground truth "
            "to sweep against. Generate the dataset with --save-depth (and --save-depth-dex "
            "for σ-surface GT), or drop --dex-depth."
        )
    near_f, far_f = float(cfg.dataset.near), float(cfg.dataset.far)
    valid_max = float(cfg.dataset.get("depth_valid_max", 1.25) or 1.25)

    def render_frame(i, pose):
        """Render one view and return, on the host, only what this run
        writes or scores."""
        pose_t = torch.as_tensor(np.asarray(pose[:4, :4], np.float32), device=device)
        if refined_intrinsics is not None:
            # the rays the twists were trained on: refined c2w + K, K[0, 0] for both axes
            K = torch.as_tensor(np.asarray(refined_intrinsics[i], np.float32), device=device)
            rd = _rotate(camera_dirs(H, W, K), pose_t[:3, :3])
            ro = pose_t[:3, 3].expand(rd.shape)
        elif test_intrinsics is not None:
            K = torch.as_tensor(np.asarray(test_intrinsics[i], np.float32), device=device)
            ro, rd = get_ray_bundle_w2c(H, W, pose_t, K)
        else:
            ro, rd = get_ray_bundle_c2w(H, W, focal, pose_t)
        out = render_image(
            coarse, fine, ro, rd, near_f, far_f, s_val, rays_impl=rays_impl,
            use_ndc=scene.use_ndc, height=H, width=W, focal_length=focal,
            occupancy=occupancy, occupancy_probes=int(args.occupancy_probes),
            occupancy_subsample=int(args.occupancy_subsample),
        )
        r = out.fine if out.fine is not None else out.coarse
        if (score_dex or pc_thres_idx is not None) and r.depth_dex is None:
            raise SystemExit(
                "σ-threshold depth rides the fine pass (reference semantics) — set "
                "nerf.validation.num_fine > 0"
            )
        res = {"rgb": r.rgb}
        if args.save_disparity_image or args.save_jet_disparity:
            res["disparity"] = r.disparity
        if need_test_depth or (args.save_pointcloud and pc_thres_idx is None):
            res["depth"] = r.depth
        if score_dex:
            res["depth_dex_all"] = r.depth_dex  # [T, H, W]
        if need_test_depth and scene.use_ndc:
            # NDC depths are ray parameters; the sidecars are metric ray
            # distances. Only the scored depths convert: disparity and the
            # point cloud keep their NDC semantics, as in the JAX package.
            for k in ("depth", "depth_dex_all"):
                if k in res:
                    res[k] = ndc_t_to_world_depth(res[k], ro, rd, H, W, focal)
        if args.save_pointcloud:
            res["accumulation"] = r.accumulation
            res["ro"], res["rd"] = ro, rd
            if pc_thres_idx is not None:
                res["depth_dex"] = r.depth_dex[pc_thres_idx]
        if args.save_depth_confidence is not None:
            # eval z-values are deterministic, so they come back from the
            # coarse weights; the fine pass's are its resampled depths
            nearb = torch.full(out.coarse.weights.shape[:-1], near_f, device=device)
            z_c = stratified_z_vals(nearb, torch.full_like(nearb, far_f), s_val.num_coarse,
                                    lindisp=s_val.lindisp)
            if out.fine is not None:
                z_w, _ = hierarchical_z_vals(z_c, out.coarse.weights, s_val.num_fine, det=True)
                w = out.fine.weights
            else:
                z_w, w = z_c, out.coarse.weights
            delta = float(args.save_depth_confidence)
            res["depth_conf"] = depth_confidence(w, z_w, r.depth, delta)
            if args.save_pointcloud and pc_thres_idx is not None:
                # the point cloud is the σ-threshold surface: its confidence too
                res["depth_conf_pc"] = depth_confidence(
                    w, z_w, r.depth_dex[pc_thres_idx], delta)
        if sg_params is not None:
            res["ir"] = render_sg_ir_image(
                coarse, fine, sg_params, ro, rd, near_f, far_f, s_val,
                distance_falloff=sg_falloff, use_ndc=scene.use_ndc, height=H, width=W,
                focal_length=focal,
            )
        return {k: v.cpu().numpy() for k, v in res.items()}

    times, per_image, gif_frames = [], [], []
    for i, pose in enumerate(poses):
        t0 = time.time()
        with torch.no_grad():
            res = render_frame(i, pose)
        rgb = res["rgb"]
        times.append(time.time() - t0)
        write_png(os.path.join(args.savedir, f"{i:04d}.png"), cast_to_image(rgb))
        if args.save_gif:
            gif_frames.append(cast_to_image(rgb))
        if args.save_disparity_image:
            write_png(os.path.join(args.savedir, "disparity", f"{i:04d}.png"),
                      cast_to_disparity_image(res["disparity"]))
        if args.save_jet_disparity:
            write_png(os.path.join(args.savedir, "disparity_jet", f"{i:04d}.png"),
                      apply_jet_colormap(np.clip(res["disparity"], 0.0, 2.0) / 2.0))
        if args.save_depth_confidence is not None:
            write_png(os.path.join(args.savedir, "confidence", f"{i:04d}.png"),
                      (np.clip(res["depth_conf"], 0.0, 1.0) * 255.0).astype(np.uint8))
        if args.save_pointcloud:
            d = res["depth_dex"] if pc_thres_idx is not None else res["depth"]
            # keep pixels whose ray hit something (the σ-threshold depth
            # lands on the first sample when nothing crosses)
            pts, cols, keep = depth_to_points(res["ro"], res["rd"], d, rgb=rgb,
                                              mask=res["accumulation"] > 0.5, return_keep=True)
            conf_pts = None
            if args.save_depth_confidence is not None:
                key = "depth_conf_pc" if pc_thres_idx is not None else "depth_conf"
                conf_pts = res[key].reshape(-1)[keep]
            write_ply(os.path.join(args.savedir, "pointcloud", f"{i:04d}.ply"), pts, cols,
                      confidence=conf_pts)
        if args.sg_ir:
            write_png(os.path.join(args.savedir, "ir", f"{i:04d}.png"),
                      cast_to_gray_image(res["ir"]))
        if test_indices is not None:
            idx = test_indices[i]
            gt = np.asarray(scene.images[idx][..., :3], np.float32)
            row = {
                "index": idx,
                "psnr": mse2psnr(float(np.mean((rgb - gt) ** 2))),
                "ssim": float(ssim(torch.as_tensor(rgb), torch.as_tensor(gt))),
            }
            if args.save_depth_confidence is not None:
                row["depth_conf"] = float(np.mean(res["depth_conf"]))
            if scene.depths is not None:
                d_gt = np.asarray(scene.depths[idx], np.float32)
                mask = (d_gt > 0) & (d_gt < valid_max)
                if mask.any():
                    row.update(compute_err_metric(d_gt, res["depth"], mask))
                    err_dir = os.path.join(args.savedir, "depth_err")
                    os.makedirs(err_dir, exist_ok=True)
                    err_img = depth_error_img(res["depth"][None], d_gt[None], mask[None])
                    write_png(os.path.join(err_dir, f"{i:04d}.png"),
                              (np.clip(err_img, 0.0, 1.0) * 255.0).astype(np.uint8))
                if "depth_dex_all" in res:
                    # the reference's protocol: sweep the candidates, keep the
                    # one of least abs error (train_dexnerf_rgb.py:393-427)
                    gt_dex, m_dex = d_gt, mask
                    if depths_dex_gt is not None:
                        gt_dex = np.asarray(depths_dex_gt[idx], np.float32)
                        m_dex = (gt_dex > 0) & (gt_dex < valid_max)
                    if m_dex.any():
                        errs = [compute_err_metric(gt_dex, dt, m_dex)
                                for dt in res["depth_dex_all"]]
                        best = int(np.argmin([e["depth_abs_err"] for e in errs]))
                        row.update({"dex_" + k.removeprefix("depth_"): v
                                    for k, v in errs[best].items()})
                        row["dex_best_m"] = float(cands[best])
            per_image.append(row)
        print(f"frame {i}: {times[-1]:.3f}s")

    print(f"Avg time per image: {np.mean(times):.3f}s")
    if args.save_gif and gif_frames:
        gif_path = os.path.join(args.savedir, "render.gif")
        write_gif(gif_path, gif_frames, args.gif_fps)
        print(f"wrote {gif_path} ({len(gif_frames)} frames)")
    if test_indices is not None:
        keys = sorted({k for r in per_image for k in r} - {"index"})
        mean = {k: float(np.mean([r[k] for r in per_image if k in r])) for k in keys}
        report = {"per_image": per_image, "mean": mean, "avg_s_per_image": float(np.mean(times))}
        if score_dex:
            # which GT the dex_* columns were scored against
            report["dex_gt"] = "sigma_sidecar" if depths_dex_gt is not None else "expected"
        with open(os.path.join(args.savedir, "metrics.json"), "w") as f:
            json.dump(report, f, indent=1)
        print("test set: " + " ".join(f"{k}={v:.4g}" for k, v in sorted(mean.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
