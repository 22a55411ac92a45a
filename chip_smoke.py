#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

From the repository root, on a machine with an NVIDIA card (Hopper, for the
sm_90a kernels). Phases, each of which raises on failure (exit code != 0):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels from ``dexnerf_tpu_torch/ops/csrc`` and time the build;
3. hold the fused render kernel to its plain PyTorch version on one
   400x400 frame of ``configs/messytable-obj.yml`` at full width (8x128,
   skip 3, PE 10/4): the coarse pass (S=64) and the fine pass (S=128, 20
   Dex thresholds), with seeded weights whose σ head is scaled so that
   both Dex branches (hit, no hit) occur;
4. serve: write those weights to a reference ``.ckpt``, start
   ``dexnerf_tpu_torch.apps.serve`` on the card, request every route, check
   the decoded outputs and that every frame launched the kernel twice;
5. time the kernel and the plain version on the same frame;
6. train: write a 400x400 synthetic blender dataset (16 train, 2 val
   views), point ``configs/lego-tpu.yml`` at it and run
   ``dexnerf_tpu_torch.apps.train`` for 40 steps on the card at full width
   (8x128 skip 3, PE 10/4, 64 + 64 samples, σ-noise 0.2, batch 8192);
   check that the fused train-loss kernel launched once per pass per step,
   that validation went through the fused render kernel, that every loss
   is finite and falls, and that the ``.ckpt`` and its Adam state read back;
7. hold the fused train-loss kernel to its plain version on one batch of
   8192 rays of that run, coarse (S=64) and fine (S=128) pass: loss,
   weights, rgb and every gradient leaf;
8. time both passes, kernel and plain, and whole train steps through the
   kernel and through the plain autograd path; profile three kernel-path
   steps (kernel 4, glue, Adam, idle).

Each kernel's line holds its bound: the larger of its FLOPs (multiply-adds
counted from the model's shapes) over the 67 TFLOP/s f32 peak and its
bytes (inputs read once, outputs written once) over 3.35 TB/s.
The line before the last is ``{"kernels": [...]}`` with this run's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "messytable-obj.yml")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "lego-tpu.yml")
TRAIN_HW = 400  # frame size of the synthetic training scene
TRAIN_VIEWS = (16, 2, 1)
TRAIN_ITERS = 40
# kernel vs plain, train pass: f32 both sides. Loss sums over 8192 rays in
# another order (rtol); weights/rgb as the render kernel; each gradient
# leaf, summed over 0.5-1M samples in another order, to GRAD_RTOL of that
# leaf's own largest entry
TRAIN_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
F32_FLOPS = 67e12  # H100 SXM f32 (non-tensor) peak, 700 W
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor-core peak (dense), 700 W
HBM_BYTES = 3.35e12
HWF = (400, 400, 555.555)
POSE = (-30.0, -45.0, 4.0)  # theta, phi, radius: the service's default camera
SEED = 0
RTOL, ATOL = 1e-4, 1e-5  # f32 on both sides; only the summation order differs
DEX_EQUAL_SHARE = 0.9999
SIGMA_SCALE = 20.0  # σ head output: standardized, times this (see calibrate)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def calibrate_sigma_head(model, xyz_enc, view_enc, torch):
    """Scale and shift ``fc_alpha`` so that the raw σ over the sampled
    points has mean 0 and std SIGMA_SCALE: random weights give σ spread of
    ~1e-3, which crosses no Dex threshold (5..100)."""
    with torch.no_grad():
        raw = model(xyz_enc, view_enc)[..., 3]
        mu, sd = raw.mean(), raw.std()
        k = SIGMA_SCALE / sd
        model.fc_alpha.weight.mul_(k)
        model.fc_alpha.bias.copy_((model.fc_alpha.bias - mu) * k)


def timed_ms(fn, torch, reps=3):
    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, torch):
    """Max abs error of each map; raises outside rtol/atol or on non-finite."""
    worst = 0.0
    for field in ("rgb", "disparity", "accumulation", "depth", "weights"):
        a, b = getattr(got, field), getattr(want, field)
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}.{field}: shape {tuple(a.shape)} or non-finite values")
        err = (a - b).abs()
        bad = int((err > ATOL + RTOL * b.abs()).sum())
        worst = max(worst, float(err.max()))
        print(f"  {name}.{field}: max abs err {float(err.max()):.3e}, outside tol {bad}")
        if bad:
            raise AssertionError(f"{name}.{field}: {bad} values outside rtol={RTOL} atol={ATOL}")
    return worst


def check_dex(got, want, sigma, z, thresholds, torch):
    """Dex depths equal on >= DEX_EQUAL_SHARE of (ray, threshold) pairs;
    every mismatch has the plain σ within 1e-3 relative of m at one of the
    two samples; both branches (hit / no hit) cover >= 20% of the pairs."""
    m = torch.tensor(thresholds, device=sigma.device)
    eq = got == want
    share = float(eq.float().mean())
    hit = (sigma[None] > m[:, None, None]).any(-1)  # [T, N]
    hit_share = float(hit.float().mean())
    print(f"  dex: equal on {share:.6f} of {eq.numel()} pairs "
          f"({int((~eq).sum())} differ), hit share {hit_share:.3f}")
    if share < DEX_EQUAL_SHARE:
        raise AssertionError(f"dex depths equal on only {share:.6f} of pairs")
    for t, r in (~eq).nonzero().tolist():
        near_m = lambda zz: (  # noqa: E731
            (sigma[r] - m[t]).abs()[z[r] == zz] <= 1e-3 * m[t]
        ).any()
        if not (near_m(got[t, r]) or near_m(want[t, r])):
            raise AssertionError(f"dex mismatch at ray {r}, threshold {thresholds[t]} is not a tie")
    if not 0.2 <= hit_share <= 0.8:
        raise AssertionError(f"hit share {hit_share:.3f}: both Dex branches need >= 20%")


def mlp_macs(model):
    """Multiply-adds of the FlexibleNeRF forward: (per sample, per ray).
    The viewdir part of ``layers_dir.0`` is per ray (both kernels fold it
    into a per-ray bias)."""
    h2 = model.hidden_size // 2
    linears = [model.layer1, *model.layers_xyz, model.fc_feat, model.fc_alpha, model.fc_rgb]
    per_sample = sum(l.in_features * l.out_features for l in linears) + model.hidden_size * h2
    return per_sample, model.dim_dir * h2


def backward_macs(model):
    """Multiply-adds per sample of the cotangent chain: rgb head, viewdir
    layer, feat + σ heads, then every trunk layer down to layer1's output."""
    H, h2 = model.hidden_size, model.hidden_size // 2
    return 3 * h2 + h2 * H + (H + 1) * H + (model.num_layers - 1) * H * H


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it) at the H100 SXM's published peaks."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def train_phase(torch, np, card, dev):
    """Phases 6-8 on ``dev``: train through the port's CLI, then kernel 4
    vs plain and timings at the run's shapes. Returns the kernels-line
    entry."""
    import yaml

    from dexnerf_tpu_torch.apps import train as train_app
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.render.renderer import draw_render_noise, jittered_z_vals
    from dexnerf_tpu_torch.train.checkpoints import load_adam_state, read_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import load_scene, setup_models
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 6: the training entry point, 40 steps at full width
        t0 = time.perf_counter()
        data = os.path.join(tmp, "scene")
        write_blender_dataset(data, TRAIN_HW, TRAIN_HW, TRAIN_VIEWS, device=dev)
        with open(TRAIN_CONFIG) as f:
            raw = yaml.safe_load(f)
        raw["dataset"].update(basedir=data, half_res=False, cachedir="")
        raw["experiment"].update(
            logdir=os.path.join(tmp, "logs"), validate_every=TRAIN_ITERS,
            save_every=TRAIN_ITERS, print_every=1,
        )
        cfg_path = os.path.join(tmp, "lego-tpu-smoke.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        logdir = os.path.join(tmp, "logs", raw["experiment"]["id"])
        dataset_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ftl.launches = 0
        fr.launches = 0
        t0 = time.perf_counter()
        train_app.main(["--config", cfg_path, "--device", dev.type,
                        "--max-iters", str(TRAIN_ITERS)])
        train_s = time.perf_counter() - t0
        launches, render_launches = ftl.launches, fr.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["value"] for r in sorted(
            (r for r in recs if r["tag"] == "train/loss"), key=lambda r: r["step"])]
        val_psnr = [r["value"] for r in recs if r["tag"] == "validation/psnr"]
        ckpt = read_reference_checkpoint(
            os.path.join(logdir, "checkpoints", f"checkpoint_{TRAIN_ITERS - 1:07d}.ckpt"))
        cfg = load_config(cfg_path)
        coarse, fine = setup_models(cfg, 0, dev)
        coarse.load_state_dict(ckpt["coarse"])
        fine.load_state_dict(ckpt["fine"])
        state = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        load_adam_state(state.optimizer, ckpt["optimizer_state_dict"])
        moments_finite = all(
            bool(torch.isfinite(st["exp_avg"]).all() and torch.isfinite(st["exp_avg_sq"]).all())
            for st in state.optimizer.state.values()
        )
        print(f"phase 6: trained {TRAIN_ITERS} steps in {train_s:.2f} s (dataset {dataset_s:.2f} s); "
              f"fused_train_loss launches {launches}, fused_render launches {render_launches}; "
              f"peak {peak_gb:.2f} GiB; loss first {losses[0]:.5f} last {losses[-1]:.5f}; "
              f"validation psnr {val_psnr}")
        checks = {
            f"{TRAIN_ITERS} finite losses": len(losses) == TRAIN_ITERS
            and bool(np.isfinite(losses).all()),
            "loss falls (mean of last 10 < first 10)": np.mean(losses[-10:]) < np.mean(losses[:10]),
            f"kernel 4 launched {2 * TRAIN_ITERS} times": launches == 2 * TRAIN_ITERS,
            "validation through kernel 1": render_launches >= 2 and len(val_psnr) >= 1
            and bool(np.isfinite(val_psnr).all()),
            ".ckpt reads back with Adam": ckpt["step"] == TRAIN_ITERS and moments_finite
            and len(state.optimizer.state) == len(list(coarse.parameters())) * 2,
        }
        for name, ok in checks.items():
            print(f"  {'ok  ' if ok else 'FAIL'} {name}")
        if not all(checks.values()):
            raise AssertionError("training checks failed")
        scene = load_scene(cfg)

    # ---- phase 7: kernel vs plain on one batch of the run
    s_train = render_settings_from_cfg(cfg, "train")
    batch = int(cfg.nerf.train.num_random_rays)
    store = build_ray_store(scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf,
                            float(cfg.dataset.near), float(cfg.dataset.far), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, store.num_rays, (batch,), generator=gen, device=dev)
    rays, target = take_ray_batch(store, idx)
    draws = draw_render_noise(batch, s_train, gen, dev)
    o, d, v = (t.contiguous() for t in rays[:3])
    target = target.contiguous()
    norm = float(3 * batch)
    z_c = jittered_z_vals(rays, s_train, draws)
    passes = {"coarse": (coarse, z_c, draws.noise_coarse)}
    worst, per_pass = 0.0, {}
    for name in ("coarse", "fine"):
        model, z, noise = passes[name]
        args = (model, o, d, z, v, ray_dists(z, d), noise, target)
        model.zero_grad(set_to_none=True)
        loss, w, rgb = ftl.fused_pass_loss(*args)
        (loss / norm).backward()
        torch.cuda.synchronize()
        got_g = [p.grad for p in model.parameters()]
        want = ftl.fused_pass_loss_reference(*args)
        errs = {
            "loss": float((loss.detach() - want[0]).abs()) / norm,
            "weights": float((w - want[1]).abs().max()),
            "rgb": float((rgb - want[2]).abs().max()),
        }
        bad = []
        if abs(float(loss.detach()) - float(want[0])) > TRAIN_LOSS_RTOL * abs(float(want[0])):
            bad.append("loss")
        for key, a, b in (("weights", w, want[1]), ("rgb", rgb, want[2])):
            if not bool(torch.isfinite(a).all()) or bool(((a - b).abs() > ATOL + RTOL * b.abs()).any()):
                bad.append(key)
        grad_err, leaves = 0.0, {}
        for (pname, _), g, gw in zip(model.named_parameters(), got_g, want[3]):
            gw = gw / norm
            err, scale = float((g - gw).abs().max()), float(gw.abs().max())
            grad_err = max(grad_err, err)
            leaves[pname] = (err, scale)
            if not bool(torch.isfinite(g).all()) or err > GRAD_RTOL * scale:
                bad.append(pname)
        errs["grads"] = grad_err
        worst = max(worst, *errs.values())
        print(f"phase 7: {name} pass, {batch} rays x {z.shape[1]} samples: max abs err "
              + json.dumps({k: float(f"{e:.3e}") for k, e in errs.items()}))
        print(f"  gradient leaves, [max abs err, max |g| of the plain version, err / max |g|] "
              f"(limit {GRAD_RTOL:g}): " + json.dumps(
                  {k: [float(f"{e:.3e}"), float(f"{m:.3e}"), float(f"{e / m if m else 0:.3e}")]
                   for k, (e, m) in leaves.items()}))
        if bad:
            raise AssertionError(f"{name} pass: kernel and plain differ in {bad}")
        per_pass[name] = args
        if name == "coarse":
            z_f, _ = hierarchical_z_vals(z_c, want[1], s_train.num_fine, det=False, u=draws.u_fine)
            passes["fine"] = (fine, z_f, draws.noise_fine)

    # ---- phase 8: timings, bound, profile of the kernel path
    ms = {}
    flops = byts = dw_flops = 0.0
    for name, args in per_pass.items():
        model, z = args[0], args[3]
        n, s = z.shape
        ps, pr = mlp_macs(model)
        # forward and weight gradients: the same multiply-adds; plus the chain
        dw_flops += 2 * (n * s * ps + n * pr)
        flops += 2 * (2 * (n * s * ps + n * pr) + n * s * backward_macs(model))
        params = list(model.parameters())
        byts += nbytes(*args[1:]) + 2 * nbytes(*params) + nbytes(z) + 3 * 4 * n + 4
        ms[f"{name}_kernel"] = timed_ms(lambda: ftl.fused_pass_loss(*args), torch)
        ms[f"{name}_plain"] = timed_ms(lambda: ftl.fused_pass_loss_reference(*args), torch)
    bound_ms, bound_by = bound(flops, byts)

    def step_ms(fused, reps=5):
        st = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        loss = ftl.make_fused_train_loss(coarse, fine, s_train) if fused else None
        step = make_train_step(s_train, batch, fused_loss=loss)
        step(st, store, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(st, store, gen)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps, (lambda: step(st, store, gen))

    torch.cuda.reset_peak_memory_stats()
    ms["step_kernel"], kernel_step = step_ms(True)
    peak_kernel = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ms["step_plain"], _ = step_ms(False)
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 8: ms on {card} (passes: CUDA events, mean of 3; steps: host clock "
          f"around synchronize, mean of 5): " + json.dumps({k: round(t, 3) for k, t in ms.items()}))
    print(f"  kernel 4 bound for both passes: {bound_ms:.3f} ms ({bound_by}; "
          f"{flops / 1e12:.4f} TFLOP, of which {dw_flops / 1e12:.4f} weight gradients, "
          f"{byts / 1e6:.2f} MB; at the bf16 tensor-core peak "
          f"{1e3 * flops / BF16_FLOPS:.3f} ms); achieved "
          f"{flops / (ms['coarse_kernel'] + ms['fine_kernel']) / 1e9:.2f} TFLOP/s f32; "
          f"peak memory: kernel step {peak_kernel:.2f} GiB, plain step {peak_plain:.2f} GiB")
    profile_steps(torch, kernel_step)
    return {
        "name": "fused_train_loss",
        "route": "cuda",
        "source": "dexnerf_tpu_torch/ops/csrc/fused_train_loss.cu",
        "replaces": "dexnerf_tpu/ops/fused_train_loss.py:99",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms["coarse_kernel"] + ms["fine_kernel"],
        "plain_ms": ms["coarse_plain"] + ms["fine_plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def profile_steps(torch, step, n=3):
    """Device time of ``n`` train steps by part: kernel 4's launches, Adam
    (the foreach multi-tensor kernels), the rest (glue), and idle (the span
    from the first kernel's start to the last one's end, minus the union of
    kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not kernels:
        print("  profile: torch.profiler recorded no device events (not measured)")
        return
    parts = {"kernel 4": 0.0, "Adam": 0.0, "glue": 0.0}
    names = {}
    for name, t0, t1 in kernels:
        if any(k in name for k in ("train_pass_kernel", "dw_kernel", "reduce_kernel",
                                   "sum_rays_kernel")):
            part = "kernel 4"
        elif "multi_tensor" in name or "adam" in name.lower():
            part = "Adam"
        else:
            part = "glue"
        parts[part] += t1 - t0
        names[name[:60]] = names.get(name[:60], 0.0) + t1 - t0
    spans = sorted((t0, t1) for _, t0, t1 in kernels)
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = spans[-1][1] - spans[0][0]
    per_step = {k: round(v / n / 1e3, 3) for k, v in parts.items()}
    per_step["idle"] = round((span - busy) / n / 1e3, 3)
    per_step["span"] = round(span / n / 1e3, 3)
    print(f"  profile, ms per step over {n} kernel-path steps ({len(kernels)} device events): "
          + json.dumps(per_step))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    print("  top device ops, ms per step: "
          + json.dumps({k: round(v / n / 1e3, 3) for k, v in top}))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible to PyTorch")
    sys.path.insert(0, ROOT)
    from dexnerf_tpu_torch.apps import serve
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.encoding import positional_encoding
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.blender import pose_spherical
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.render.renderer import make_ray_batch, render_image
    from dexnerf_tpu_torch.train.checkpoints import write_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import setup_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card {card} ({kind}, {torch.cuda.device_count()} visible)")

    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    print("phase 2: kernels " + (f"built in {built:.2f} s" if built is not None
                                 else "current in build/, not rebuilt")
          + f" (load {time.perf_counter() - t0:.2f} s)")
    print("\n".join(l for l in _build.build_log.splitlines() if "registers" in l or "spill" in l))

    # ---- phase 3: kernel vs plain at the slice's shapes
    cfg = load_config(CONFIG)
    settings = render_settings_from_cfg(cfg, "validation", dex=True).eval_variant()
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    coarse, fine = setup_models(cfg, SEED, dev)
    H, W, focal = HWF
    pose = torch.as_tensor(pose_spherical(*POSE), device=dev)
    ro, rd = get_ray_bundle_c2w(H, W, focal, pose)
    rays = make_ray_batch(ro, rd, near, far)
    o, d, v = (t.contiguous() for t in rays[:3])
    kw = dict(white_background=settings.white_background)
    thresholds = tuple(settings.m_thres_cand)
    z_c = stratified_z_vals(rays.near, rays.far, settings.num_coarse)
    # calibrate both σ heads on every 40th ray of the frame
    sub = slice(0, None, 40)
    for model in (coarse, fine):
        pts = o[sub, None] + d[sub, None] * z_c[sub, :, None]
        calibrate_sigma_head(
            model,
            positional_encoding(pts, model.num_encoding_fn_xyz),
            positional_encoding(v[sub], model.num_encoding_fn_dir),
            torch,
        )
    with torch.inference_mode():
        dist_c = ray_dists(z_c, d)
        args_c = (coarse, o, d, v, z_c, dist_c)
        got_c = fr.fused_render(*args_c, **kw)
        want_c = fr.fused_render_reference(*args_c, **kw)
        torch.cuda.synchronize()
        print(f"phase 3: kernel vs plain on {o.shape[0]} rays")
        err = compare("coarse", got_c, want_c, torch)
        z_f, _ = hierarchical_z_vals(z_c, want_c.weights, settings.num_fine, det=True)
        dist_f = ray_dists(z_f, d)
        args_f = (fine, o, d, v, z_f, dist_f)
        got_f = fr.fused_render(*args_f, thresholds=thresholds, **kw)
        want_f = fr.fused_render_reference(*args_f, thresholds=thresholds, **kw)
        torch.cuda.synchronize()
        err = max(err, compare("fine", got_f, want_f, torch))
        sigma = torch.cat([
            fine(
                positional_encoding(
                    o[i:i + 8192, None] + d[i:i + 8192, None] * z_f[i:i + 8192, :, None],
                    fine.num_encoding_fn_xyz,
                ),
                positional_encoding(v[i:i + 8192], fine.num_encoding_fn_dir),
            )[..., 3].relu()
            for i in range(0, o.shape[0], 8192)
        ])
        check_dex(got_f.depth_dex, want_f.depth_dex, sigma, z_f, thresholds, torch)

        # ---- phase 5 (timing), on the same inputs
        ms = {
            "coarse_kernel": timed_ms(lambda: fr.fused_render(*args_c, **kw), torch),
            "coarse_plain": timed_ms(lambda: fr.fused_render_reference(*args_c, **kw), torch),
            "fine_kernel": timed_ms(
                lambda: fr.fused_render(*args_f, thresholds=thresholds, **kw), torch),
            "fine_plain": timed_ms(
                lambda: fr.fused_render_reference(*args_f, thresholds=thresholds, **kw), torch),
        }
        impl = fr.make_fused_render_rays(coarse, fine, settings)
        frame = render_image(coarse, fine, ro, rd, near, far, settings, rays_impl=impl)
        ms["frame_kernel"] = timed_ms(
            lambda: render_image(coarse, fine, ro, rd, near, far, settings, rays_impl=impl), torch)
        ms["frame_plain"] = timed_ms(
            lambda: render_image(coarse, fine, ro, rd, near, far, settings, chunk=8192), torch)
        # bound of the two passes timed above: forward multiply-adds, and
        # the inputs, weights and outputs of each pass
        flops = sum(2 * (z.numel() * mlp_macs(m)[0] + z.shape[0] * mlp_macs(m)[1])
                    for m, z in ((coarse, z_c), (fine, z_f)))
        byts = sum(
            nbytes(o, d, v, z, dz, *m.parameters(), g.rgb, g.disparity, g.accumulation,
                   g.depth, g.weights, g.depth_dex)
            for m, z, dz, g in ((coarse, z_c, dist_c, got_c), (fine, z_f, dist_f, got_f))
        )
        render_bound, render_bound_by = bound(flops, byts)
        print(f"  fused_render bound for both passes: {render_bound:.3f} ms ({render_bound_by}; "
              f"{flops / 1e12:.4f} TFLOP, {byts / 1e6:.2f} MB); at the bf16 tensor-core "
              f"peak {1e3 * flops / BF16_FLOPS:.3f} ms")

    # ---- phase 4: serve through the port's entry points
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "seeded.ckpt")
        write_reference_checkpoint(ckpt, coarse.state_dict(), fine.state_dict())
        args = serve.build_parser().parse_args([
            "--config", CONFIG, "--checkpoint", ckpt,
            "--hwf", *map(str, HWF), "--device", "cuda",
        ])
        service = serve.build_service(args)
        httpd = serve.make_http_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        q = "theta=%g&phi=%g&radius=%g" % POSE
        try:
            fr.launches = 0
            frames0 = service.renders_served

            request_ms = {}

            def get(path, body=None):
                req = urllib.request.Request(base + path, data=body)
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    if r.status != 200:
                        raise AssertionError(f"{path}: HTTP {r.status}")
                    out = r.read()
                key = ("POST " if body else "GET ") + path.split("?")[0]
                key += " threshold" * ("threshold" in path) + " png" * ("png" in path)
                request_ms[key] = round((time.perf_counter() - t0) * 1e3, 3)
                return out

            info = json.loads(get("/healthz"))
            rgb_png = get("/render?" + q)
            depth = np.load(io.BytesIO(get("/depth?" + q)))
            dex = np.load(io.BytesIO(get("/depth?" + q + "&threshold=50")))
            dex_png = get("/depth?" + q + "&threshold=50&format=png")
            conf = np.load(io.BytesIO(get("/confidence?" + q)))
            c2w = pose_spherical(*POSE).tolist()
            post_png = get("/render", json.dumps({"c2w": c2w}).encode())
            launches = fr.launches
            frames = service.renders_served - frames0
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    from PIL import Image

    rgb = np.asarray(Image.open(io.BytesIO(rgb_png)))
    post = np.asarray(Image.open(io.BytesIO(post_png)))
    dex_mm = np.asarray(Image.open(io.BytesIO(dex_png)))
    print(f"phase 4: served {frames} frames, {launches} kernel launches; "
          f"healthz m_thres {info['m_thres_cand'][0]}..{info['m_thres_cand'][-1]}; "
          f"request ms (host clock, first requests) {json.dumps(request_ms)}")
    checks = {
        "rgb png 400x400x3": rgb.shape == (H, W, 3) and rgb.dtype == np.uint8,
        "POST rgb equals GET rgb": np.array_equal(post, rgb),
        "depth 400x400 finite": depth.shape == (H, W) and bool(np.isfinite(depth).all()),
        "dex 400x400 in [near, far]": dex.shape == (H, W)
        and bool(((dex >= near) & (dex <= far)).all()),
        "dex mm png": dex_mm.shape == (H, W)
        and np.array_equal(dex_mm, np.clip((dex * 1000.0).astype(np.uint32), 0, 65535)),
        "confidence finite in [0, 1]": conf["confidence"].shape == (H, W)
        and bool(((conf["confidence"] >= 0) & (conf["confidence"] <= 1 + 1e-5)).all()),
        "served depth = direct kernel render": np.allclose(
            depth, frame.fine.depth.cpu().numpy(), rtol=RTOL, atol=ATOL),
        "2 launches per frame": frames == 6 and launches == 2 * frames,
    }
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError("serving checks failed")

    print("phase 5: ms per call on " + card + ": " + json.dumps(
        {k: round(t, 3) for k, t in ms.items()}))
    train_kernel = train_phase(torch, np, card, dev)
    print(json.dumps({"kernels": [{
        "name": "fused_render",
        "route": "cuda",
        "source": "dexnerf_tpu_torch/ops/csrc/fused_render.cu",
        "replaces": "dexnerf_tpu/ops/fused_render.py:115",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms["coarse_kernel"] + ms["fine_kernel"],
        "plain_ms": ms["coarse_plain"] + ms["fine_plain"],
        "bound_ms": render_bound,
        "bound_by": render_bound_by,
        "library_ms": None,
    }, train_kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
