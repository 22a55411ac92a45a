#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path, its training
configurations, its evaluation entry point, its LLFF/NDC path, its
occupancy-guided paths and mesh export, its other model families,
optimizers and tiny pipeline, its ray cache, its pose refinement, its
active-IR SG shading, its data-parallel step, its multi-scene training,
its multi-host entry and its host-streamed ray store on one CUDA card.

    python3 chip_smoke.py

From the repository root, on a machine with an NVIDIA card (Hopper, for the
sm_90a kernels). Phases, each of which raises on failure (exit code != 0):

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the kernels from ``dexnerf_tpu_torch/ops/csrc`` and time the build;
3. hold the fused render kernels (kernel 1: the f32 kernel, split TF32 on
   the tensor cores, and the bf16 tensor-core kernel) to their plain
   PyTorch versions on one 400x400
   frame of ``configs/messytable-obj.yml`` at full width (8x128, skip 3,
   PE 10/4): the coarse pass (S=64) and the fine pass (S=128, 20 Dex
   thresholds), with seeded weights whose σ head is scaled so that both
   Dex branches (hit, no hit) occur; the bf16 kernel also against the f32
   plain version, within 1.5x the bf16 plain version's own distance to it;
4. serve: write those weights to a reference ``.ckpt``, start
   ``dexnerf_tpu_torch.apps.serve`` on the card at the config's default
   compute dtype (bf16), request every route, check the decoded outputs
   and that every frame launched the bf16 kernel twice and the f32 kernel
   never; then serve one frame with ``nerf.pallas_compute_dtype: float32``
   (the f32 kernel twice, the bf16 kernel never);
5. time both kernels and both plain versions on the same frame, each pass
   and the whole frame; print each kernel's time of each pass beside that
   pass's own bound (the f32 kernel's at the split-TF32 rate, its f32 FMA
   bound beside it), its work plan (units, rows, grid) and residency (CTAs
   per SM, shared bytes, weight stages), and profile three frames at each
   dtype (kernel 1, glue, idle);
   Then serve ``configs/tiny.yml``'s 2x16 model (hidden size 16, run
   zero-padded to 32 by the bf16 kernel) at bf16, and the messytable
   frame once with ``nerf.use_fused_render: false`` (the plain renderer:
   no kernel-1 launch);
6. train: write a 400x400 synthetic blender dataset (16 train, 2 val
   views), point ``configs/lego-tpu.yml`` at it and run
   ``dexnerf_tpu_torch.apps.train`` for 40 steps on the card at full width
   (8x128 skip 3, PE 10/4, 64 + 64 samples, σ-noise 0.2, batch 8192) at
   the config's default dtype, bf16; check that kernel 4's bf16 route
   launched once per pass per step and its f32 route never, that
   validation went through the fused render kernel, that every loss is
   finite and falls, and that the ``.ckpt`` and its Adam state read back;
   then 10 steps with ``nerf.pallas_compute_dtype: float32`` (the f32
   route, 20 launches);
7. hold both routes of the fused train-loss kernel to their plain versions
   on one batch of 8192 rays of that run, coarse (S=64) and fine (S=128)
   pass: loss, weights, rgb and every gradient leaf; the bf16 route
   relative to the dtype's own effect (as kernel 1's, see BF16_*);
8. time both passes of both routes, kernel and plain, the bf16 route's
   weight-gradient GEMMs as ``torch.matmul`` calls (library yardstick), and
   whole train steps through kernel 4 at bf16 and at f32, through the
   plain autograd path and through kernel 4 with the fused resample at
   bf16, with each step's peak memory; print the weight-gradient plan;
   profile three steps at bf16 and three at f32 (kernel 4, glue, Adam,
   idle), with the bf16 forward, chain and dW kernels' device time each
   beside its own bound (the ``parts`` of the kernels line; the bytes and
   operations behind each bound on a line of their own), the f32 route's
   pass kernels (prep, forward, compositing, chain: split TF32 on the
   tensor cores) each beside its bound (the forward's and chain's three TF32
   products a multiply-add, or their bytes) and the forward's and chain's
   layer products as f32 ``torch.matmul`` (TF32 off), and the f32
   routes' split-TF32 dW kernel (``dw_tf32_kernel``) beside its bound (the
   scratch read and the gradient written once; its three TF32 products a
   multiply-add printed beside) and the same products as f32
   ``torch.matmul``; print the bf16
   forward's residency (CTAs per SM, shared bytes, ring stages, staging
   tiles) and each of its launches' 64-row tiles and CTAs;
9. train the field path (``nerf.pallas_fused_loss: false``) through
   ``apps.train`` for 20 steps at the config's default dtype, bf16: the
   field forward (kernel 2) and backward (kernel 3) launched once per pass
   per step through their bf16 routes and never through their f32 ones,
   kernel 4 never, validation through kernel 1, every loss finite and
   falling; then 10 steps with ``nerf.pallas_compute_dtype: float32`` (the
   f32 routes, 20 launches each, the bf16 routes none);
10. hold both routes of kernels 2 and 3 to their plain versions on phase
   7's batch with that run's models, coarse (S=64) and fine (S=128) pass,
   with the cotangent of each pass's loss: raw and every gradient leaf; the
   bf16 routes relative to the dtype's own effect (as kernel 4's); and, at
   f32 (kernel 4's split-TF32 kernels with the launcher tags 2 and 3), that
   kernel 2's raw equals the raw of kernel 3's forward, chunk by chunk, and
   that two kernel-3 calls give the same gradients, bit for bit;
11. train with ``nerf.pallas_loss_resample: pallas`` for 20 steps: the
   resample kernel (kernel 5) once per step between kernel 4's two passes;
12. hold kernels 5 and 6 to their plain versions on the coarse weights of
   phase 7's batch under that run's coarse model (plus a zero-weight and a
   near-delta ray), on the batch's draws and on the deterministic grid,
   each output, like the f32 plain version, against a float64 run of the
   plain version; kernel 6 is driven through its public op
   ``sample_pdf_branchless``;
13. time both routes of kernels 2 and 3, kernels 5 and 6 (CUDA events,
   and kernels 5 and 6's device time alone from ``torch.profiler``) and
   their plain versions, the dW share of kernel 3 as ``torch.matmul`` calls
   at f32 (TF32 off) and bf16, the f32 passes' layer products (kernel 2's
   forward, kernel 3's forward and chain) as f32 ``torch.matmul``, and
   whole field-path steps at bf16 and at f32; profile three field-path
   steps at each dtype (kernel 2, kernel 3, glue, Adam, idle), with kernel
   3's bf16 kernels beside their bounds as in phase 8, kernel 2's bf16
   forward beside its route's bound, and the f32 routes' kernels (kernel
   2's prep and forward, kernel 3's prep, forward, chain and split-TF32 dW)
   each beside its bound and, for the forwards, the chain and dW, their
   products as f32 ``torch.matmul``, as in phase 8; the forward's residency
   and launches for kernels 2 and 3, as in phase 8;
14. Dex-NeRF on messytable: write a synthetic messytable scene (stored
   540x960, loaded at 270x480) and train ``configs/messytable-obj.yml`` on
   it (``nerf.use_pallas: true``, ``dataset.depth_valid_max: 6``) through
   ``apps.train --ir --dex --depth-loss 0.1 --depth-warmup 10`` for 20
   steps: kernel 4's bf16 route launched 40 times with its luminance and
   depth terms (f32 route never), the depth term absent before step 10
   and finite after, each validation (steps 0 and 19) two launches of
   kernel 1's bf16 route at T = 20 with the depth metrics, the 20
   ``depth_pred_<m>`` images, the error image and the millimeter PNG; hold
   kernel 4's bf16 route with both terms on to its plain version on one
   1024-ray batch of the run (both passes, phase 7's BF16_* rule) and
   kernel 1's on the 270x480 validation frame (phase 3's); time both
   passes, a depth-supervised step (host clock, profile) and the frame;
15. evaluate phase 14's weights (σ heads calibrated on the test view, as
   in phase 3) through ``apps.eval --test-set --dex-depth`` with a point
   cloud at a σ threshold, depth confidence, disparity, jet disparity and a
   GIF: two launches of kernel 1's bf16 route per frame and none of its f32
   route, ``metrics.json`` and the PLY, eval's expected-depth and Dex
   errors equal to ``validate(dex=True)``'s on the same view; hold the
   test frame to its plain versions (phase 3's rule) and time it (host
   clock) and the kernel's two passes (CUDA events);
16. LLFF: write a forward-facing scene (``write_llff_dataset``, 378x504,
   fern's factor-8 size, loaded at factor 1) and train
   ``configs/llff.yml`` (NDC, batch 1024, 64 + 64 samples) on it with
   ``nerf.use_pallas: true`` through ``apps.train`` for 20 steps: 40
   launches of kernel 4's bf16 route on NDC rays, the loss falls,
   validations through kernel 1 on NDC rays; hold kernel 4's bf16 route to
   its plain version on one batch of the run (phase 7's rule) and kernel
   1's on one NDC frame; time a step (host clock, profile) and the frame;
   score the held-out views through ``apps.eval --test-set``, the depths
   as metric ray distances (``ndc_t_to_world_depth``);
17. occupancy-guided empty-space skipping on phase 6's weights: bake a
   128³ σ-occupancy grid on the card at a σ threshold that leaves 5-95% of
   the cells occupied, held to a CPU bake of the same weights (cells within
   1e-5 of the threshold excepted and counted); ``apps.eval --occupancy``
   on the held-out 400x400 view (128 probes, subsample 2: two kernel-1
   bf16 launches, none f32; every tightened interval inside the full one,
   the mean shrink > 0; kernel 1 on the tightened rays vs its plain
   versions by phase 3's rule; the tightening and the frame without
   occupancy, with it, and with it at 32 + 32 samples timed);
   ``apps.serve --occupancy`` (/render and /depth through kernel 1's bf16
   route, /healthz reports occupancy, /confidence refused); ``apps.train
   --occupancy`` for 30 steps at bf16, bakes after steps 9, 19 and 29 (60
   launches of kernel 4's bf16 route, none f32; every stored interval
   inside the full one; the loss falls), kernel 4's bf16 route on a
   tightened batch vs its plain version (phase 7's rule), a step and a
   re-bake of the 2.56M-ray store timed; ``apps.mesh`` at 128³ writes a
   PLY, its σ grid timed;
18. the other model families, FlexibleNeRF without viewdirs and the
   optimizers beyond Adam: nine configurations of ``configs/lego-tpu.yml``
   (``FAMILY_RUNS``: PaperNeRF, ReplicateNeRF, MultiHead, FlexibleNeRF
   without viewdirs, FlexibleNeRF coarse + PaperNeRF fine, and AdamW, SGD,
   RMSprop, Adagrad), each trained through ``apps.train`` for 10 steps at
   batch 8192, 64 + 64 on phase 6's scene: no kernel launched on the
   all-plain configs, on the mixed config kernels 2 and 3 (bf16) once a
   step for the coarse pass and kernels 1 and 4 never (JAX's selection
   rules), kernel 4 on the optimizer runs; each run's loss on a fixed batch
   below its seeded init's, its ``.ckpt`` with the optimizer's state, a
   step's host-clock ms and peak memory, ``apps.eval --test-set`` on it;
   kernels 2 and 3 on the mixed run's coarse pass vs plain (the f32 leaves
   by the own-decision rule of ``perf_tools/field_f32_rule.py``) and
   timed; the mixed step at ``pallas_compute_dtype: float32`` held to the
   plain autograd step by its loss; 3 updates of each
   optimizer on the card held to the CPU's on shared gradients; ``apps.tiny`` for 200 iterations
   on the card, its hold-out PSNR rising;
19. the ray cache and SE(3) pose refinement: ``apps.cache`` on phase 6's
   scene (8192 rays a shard) and ``apps.train`` of ``configs/lego-tpu.yml``
   from that cache for 20 steps (40 launches of kernel 4's bf16 route, 0 of
   its f32 route; validation through kernel 1; the loss falls), kernel 4
   on a cache batch vs plain (phase 7's rule), the store's build time and
   a step on the cache and on the resident store in turns; ``apps.train
   --pose-opt`` of ``configs/messytable-obj.yml`` (8x128, 64 + 64, batch
   1024, ``nerf.use_pallas: true``) on phase 14's scene with its train
   cameras moved by known twists, 20 steps: JAX's warning, kernels 2-6
   never, validation through kernel 1, ``pose_twist_norm`` above 0, the
   twists in the ``.ckpt``; a pose step's host-clock time, device time,
   idle share and peak memory; one pose step held to the CPU's by phase
   18's rule (the loss, the updates on shared gradients); JAX's analytic
   pose-recovery check at its sizes (250 steps, the twist error under half
   its start); ``apps.eval --refined-poses`` on that checkpoint (two
   kernel-1 launches a train view, the first frame the refined camera's,
   held to its plain versions by phase 3's rule);
20. active-IR SG shading and data-parallel training: ``apps.train
   --sg-ir`` of ``configs/messytable-obj.yml`` (``nerf.use_pallas: true``)
   on phase 14's scene for 20 steps: the shaded loss supersedes every
   training kernel (kernels 2-6 never, as in JAX), validation through
   kernel 1's bf16 route, the loss finite and falling, the SG leaves in the
   ``.ckpt``; a step's host-clock time, device time, idle share and peak
   memory; one step's loss and every gradient leaf (fields and SG) held to
   the CPU's, and its update on the CPU's gradients by phase 18's rule; ``apps.eval
   --test-set --sg-ir`` (two kernel-1 launches a frame, an IR PNG a frame
   equal to a direct render, the IR frame timed, kernel 1 on the frame vs
   plain); ``make_parallel_train_step`` at one NCCL rank equal in every
   bit to ``make_train_step`` on the same draws through kernel 4's bf16
   route (2 launches a step), two gloo ranks on the one card at phase 6's
   batch held to the one-rank step by phase 7's rule, their parameters
   equal in every bit, kernel 4 on a rank's batch vs plain; ``apps.train
   --num-devices 2`` on the one card raises ``make_mesh``'s words (phase
   20 alone: ``python3 perf_tools/phase20_alone.py``);
21. multi-scene training and the multi-host entry: two scenes written from
   ``make_synthetic_scene``'s seeds 0 and 1 and two configs of
   ``configs/lego-tpu.yml`` trained together by ``apps.multiscene
   --max-iters 10 --validate-every 5`` at 8192 rays a scene (the plain step
   under ``torch.func.vmap``, as JAX's multi-scene step is its XLA path:
   kernels 2-6 never, kernel 1's bf16 route twice a scene a validation; the
   loss falls in each scene), each scene's ``.ckpt`` through ``apps.eval
   --test-set``; the multi-scene step's and the single-scene plain step's
   host-clock ms, busy and idle time, launches and peak memory; kernel 1 on
   a scene's validation frame vs plain; one multi-scene step held to
   ``make_train_step``'s plain step of each scene (loss, every gradient
   leaf); the ``(scene, rays)`` step at one NCCL rank equal in every bit
   to the one-process step, and as two gloo ranks on the card at 1 x 2 and
   2 x 1 held to it; ``multihost.initialize`` by ``tcp://`` in a process
   of its own (one NCCL rank, one ``all_reduce``) and its no-op outside a
   cluster (phase 21 alone: ``python3 perf_tools/phase21_alone.py``);
22. the wide bf16 route (padded widths above 128): ``configs/lego-tpu.yml``
   at FlexibleNeRF 8x256 (the NeRF paper's width; the config written at run
   time) on phase 6's scene through ``apps.train`` for 10 steps each at the
   default bf16: kernel 4 (2 wide launches a step), the field path (kernels
   2 and 3, 2 wide launches each a step) and kernel 4 with the fused
   resample (kernel 5 once a step), validation through kernel 1's wide
   route, every loss finite and falling; ``apps.serve`` of the kernel-4 run's ``.ckpt``
   answering three frames through kernel 1's wide route; kernel 4 on one
   batch of that run (both passes) and kernels 2-3 on its fine pass held to
   their plain versions by phase 7's rule, kernel 1 on the 400x400
   validation frame by phase 3's; the same at H = 100 (the narrow kernels,
   a width not a multiple of 8; also the f32 routes of kernels 1, 2 and 4),
   136, 320 and 576 on that batch's coarse samples (kernel 1 on its 8192 rays,
   kernels 2-4 on 512 of them; kernel 4 on the seeded model and on a copy
   with its σ head calibrated, whose loss reaches the trunk), and every f32
   wrapper refusing a width above its MAX_HIDDEN (ROADMAP Queue 2 item 6c's
   words) with no launch; each wide kernel's time beside its bound and its
   products as bf16 ``torch.matmul``, its registers, spills and shared
   bytes, an 8x256 step's and frame's host-clock time, peak memory and the
   launches (phase 22 alone: ``python3 perf_tools/phase22_alone.py``);
23. the wide f32 route (split TF32, padded widths above 128 up to
   MAX_HIDDEN): phase 22's 8x256 config at ``pallas_compute_dtype:
   float32`` (written at run time) on phase 6's scene through
   ``apps.train`` for 10 steps each: kernel 4 (2 wide f32 launches a step),
   the field path (kernels 2 and 3, 2 each a step) and kernel 4 with the
   fused resample, no bf16 launch, validation through kernel 1's wide f32
   route, every loss finite and falling; ``apps.serve`` of the kernel-4
   run's ``.ckpt`` answering three frames through it; kernel 4 on one
   batch of that run (both passes, phase 7's rule), kernels 2-3 on its fine
   pass (phase 10's raw rule, ``perf_tools/field_f32_rule.py``'s leaves) and
   kernel 1 on the 400x400 validation frame (phase 3's rule, Dex depths
   equal on DEX_EQUAL_SHARE of pairs) held to their plain versions; the same
   at H = 136, 320 and MAX_HIDDEN on that batch's coarse samples; each
   wide f32 kernel's time beside its split-TF32 bound and its products as
   f32 ``torch.matmul`` (TF32 off), its registers, spills and shared bytes,
   an 8x256 step's and frame's host-clock time, peak memory and the
   launches (phase 23 alone: ``python3 perf_tools/phase23_alone.py``);
24. the host-streamed ray store (``dataset.host_store``): ``apps.train``
   of ``configs/lego-tpu.yml`` on a written lego scene of 40 views at
   800x800 (1.23 GB of f32 rows) on the packed and the rows wire, 20 steps
   each (kernel 4's bf16 route twice a step, every batch on the card, no
   resident store, the loss falling); the resident step, the rows step and
   the packed step on the same indices and render draws for 5 updates at
   bf16 (rows = resident bit for bit, packed's first loss within 1e-6 of
   rows') and 3 through kernel 4's f32 route (packed's losses and first
   gradients within the CPU test's tolerances of rows'); the three steps' host-clock ms at 8192 and 65536 rays, each
   loader's gather and copy ms, the device idle share and the wire bytes a
   ray; kernel 4 on a batch of the scene held to plain; a messytable run
   with the depth term, a field-path run (kernels 2-3) and an LLFF (NDC)
   run on the packed wire (phase 24 alone: ``python3
   perf_tools/phase24_alone.py``).

Each kernel's line holds its bound: the larger of its FLOPs (multiply-adds
counted from the model's shapes; compares and arithmetic counted from the
shapes for kernels 5 and 6) over the 67 TFLOP/s f32 peak (the bf16 routes
of kernels 1-4 over the 989 TFLOP/s dense bf16 tensor-core peak; the f32
routes of kernels 1-4, split TF32, three times their FLOPs over the 495
TFLOP/s dense TF32 peak, ``bound_by`` naming it; their f32 FMA bounds are
on phase 3's, phase 8's and phase 13's bounds lines) and its bytes
(inputs read once, outputs written once) over 3.35 TB/s. Kernels 1-4 have
a library yardstick: their layer products (kernel 1's and 2's forward on
the frame's or the passes' samples; kernels 3 and 4's forward, chain and
weight gradients) as ``torch.matmul`` calls in each route's dtype (f32
with TF32 off; timed here, never called by the port), on the main paths'
entries (the eval and LLFF frames of phases 15-16 time none).
The line before the last is ``{"kernels": [...]}`` with this run's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "messytable-obj.yml")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "lego-tpu.yml")
TRAIN_HW = 400  # frame size of the synthetic training scene
TRAIN_VIEWS = (16, 2, 1)
TRAIN_ITERS = 40
SLICE_ITERS = 20  # steps of each of the field path and the resample path
# kernel 4's __global__ kernels, by name (the profile's part)
# the f32 route's pass kernels (split TF32 on the tensor cores), then its dW, reduction
# and loss sum
F32_PASS_NAMES = ("train_prep_tf32_kernel", "train_fwd_tf32_kernel",
                  "train_composite_tf32_kernel", "train_chain_tf32_kernel")
KERNEL4_NAMES = (*F32_PASS_NAMES, "dw_tf32_kernel", "dw_tf32_reduce_kernel", "sum_rays_kernel")
KERNEL4_BF16_NAMES = ("train_prep_kernel", "train_fwd_bf16_kernel", "train_composite_kernel",
                      "train_chain_bf16_kernel", "train_dw_bf16_kernel", "reduce_bf16_kernel",
                      "sum_rays_bf16_kernel")
# kernels 2 and 3's bf16 kernels (kernel 4's, with the launcher's tag), by name
FIELD_FWD_BF16_NAMES = ("train_prep_kernel<2>", "train_fwd_bf16_kernel<2,")
FIELD_BWD_BF16_NAMES = ("train_prep_kernel<3>", "train_fwd_bf16_kernel<3,",
                        "train_chain_bf16_kernel", "train_dw_bf16_kernel", "reduce_bf16_kernel")
# and their f32 kernels (kernel 4's split-TF32 pass kernels with the tag), by name
FIELD_FWD_F32_NAMES = ("train_prep_tf32_kernel<2>", "train_fwd_tf32_kernel<2,")
FIELD_BWD_F32_NAMES = ("train_prep_tf32_kernel<3>", "train_fwd_tf32_kernel<3,",
                       "train_chain_tf32_kernel<3,")
# steps of the f32 routes of kernel 4 and of kernels 2-3 (pallas_compute_dtype: float32)
F32_TRAIN_ITERS = 10
TINY_CONFIG = os.path.join(ROOT, "configs", "tiny.yml")
# phase 14: Dex-NeRF on messytable (configs/messytable-obj.yml): the scene's
# stored frame (loaded halved, at the real scene's 270x480) and views, the
# run's steps, its depth term's weight, warmup and validity limit (the
# synthetic scene lies ~4 m away, beyond the 1.25 m default)
DEX_STORED_HW = (540, 960)
DEX_VIEWS = (4, 1, 1)
DEX_ITERS, DEX_WARMUP, DEX_WEIGHT, DEX_VALID_MAX = 20, 10, 0.1, 6.0
DEX_VAL_TAGS = tuple(f"validation/{k}" for k in ("depth_abs_err", "depth_err4", "min_abs_err",
                                                 "err4"))
# phase 15: the σ threshold of the evaluation's point cloud (on the m_thres grid)
EVAL_PC_THRESHOLD = 50.0
# phase 16: LLFF (configs/llff.yml, NDC) on a written forward-facing scene at
# fern's factor-8 frame, loaded at factor 1; its views (every 8th held out),
# steps, and the limit of the scored depths (scene units; the scene lies
# 2-7.7 units from the cameras, beyond the 1.25 default)
LLFF_CONFIG = os.path.join(ROOT, "configs", "llff.yml")
LLFF_HW = (378, 504)
LLFF_VIEWS, LLFF_ITERS, LLFF_VALID_MAX = 10, 20, 10.0
# phase 17: occupancy on phase 6's lego-tpu weights: the grid (the JAX
# default 128^3, radius 1.5), the dilated share of occupied cells the σ
# threshold aims at, the cells near the threshold that a CPU bake may
# decide otherwise, the probes a ray (a frame: apps.eval's default and its
# subsample; the store: nerf.train.occupancy_probes' default), and the
# occupancy-guided run: steps, first bake, bakes' period
OCC_RES = 128
OCC_FRACTION_RANGE, OCC_FRACTION_GOAL = (0.05, 0.95), 0.5
OCC_THRESH_RTOL = 1e-5
OCC_PROBES_FRAME, OCC_SUBSAMPLE, OCC_PROBES_STORE = 128, 2, 64
OCC_ITERS, OCC_START, OCC_EVERY = 30, 10, 10
OCC_GEMM_NAMES = ("gemm", "xmma", "cutlass")  # cuBLAS's device kernels, by name
# phase 18: the other model families, FlexibleNeRF without viewdirs and the
# optimizers beyond Adam, each configuration lego-tpu.yml with its model
# types, nerf.use_viewdirs or optimizer.type overridden in memory (batch
# 8192, 64 + 64, phase 6's scene): name -> (models.{block}.type, nerf keys,
# optimizer.type)
FAMILY_RUNS = {
    "paper": ({"coarse": "PaperNeRFModel", "fine": "PaperNeRFModel"}, {}, None),
    "replicate": ({"coarse": "ReplicateNeRFModel", "fine": "ReplicateNeRFModel"}, {}, None),
    "multihead": ({"coarse": "MultiHeadNeRFModel", "fine": "MultiHeadNeRFModel"}, {}, None),
    "flexible-no-viewdirs": ({}, {"use_viewdirs": False}, None),
    "mixed": ({"fine": "PaperNeRFModel"}, {}, None),
    "adamw": ({}, {}, "AdamW"),
    "sgd": ({}, {}, "SGD"),
    "rmsprop": ({}, {}, "RMSprop"),
    "adagrad": ({}, {}, "Adagrad"),
}
FAMILY_ITERS = 10
# each run's loss is read on one fixed batch of this many rays (eval
# settings), at the seeded init and from its checkpoint: the training
# losses of 10 random batches are too noisy to show SGD's and Adagrad's
# small steps at lr 5e-3
HELD_RAYS = 4096
# each optimizer's updates on the card held to the same updates on the CPU
# on shared gradients (the CPU's plain-path step's), each leaf within these
# shares of its largest entry: the two devices differ only in the update's
# own rounding. Full steps are not held so: an entry whose gradient sum lies
# within rounding of 0 takes Adam's first update, lr * g / (|g| + eps),
# with either sign (2.2e-2 of a leaf's largest entry on the card against
# the CPU from phase 6's weights)
OPT_RAYS, OPT_STEPS = 1024, 3
OPT_PARAM_RTOL, OPT_STATE_RTOL = 1e-6, 1e-5
TINY_ITERS = 200
# phase 19: the ray cache (rays a shard of apps.cache on phase 6's scene, the
# run's steps) and pose refinement (the pose run's steps on phase 14's scene,
# the std of the known twists that move its train cameras: rotation,
# translation, as JAX's pose-recovery check; that check's steps and rays)
CACHE_RAYS, CACHE_ITERS, POSE_ITERS = 8192, 20, 20
POSE_EPS = (0.04, 0.08)
RECOVERY_STEPS, RECOVERY_RAYS = 250, 256
# phase 20: the --sg-ir run's steps on phase 14's scene; the updates of the
# one-rank NCCL comparison, and the seconds a spawned group of ranks may take
SG_ITERS, RANK_STEPS, RANK_TIMEOUT = 20, 2, 300.0
# phase 21: multi-scene training of two lego-tpu.yml scenes written from
# make_synthetic_scene's seeds (the views of phase 6's scene, its frame
# size): the run's steps and validation period, the layouts of the rank
# steps ((scene rows, ranks a row) on the one card), and the seconds the
# multihost worker may take
MS_SEEDS, MS_ITERS, MS_VALIDATE = (0, 1), 10, 5
MS_LAYOUTS = ((1, 2), (2, 1))
# the ranks' f32 gradients vs the one-process step's: the same sums in
# another order, each within f32's own distance to float64 ("own"): at
# most F32_OWN_REL x own, + F32_OWN_ATOL x the leaf's largest entry
F32_OWN_REL, F32_OWN_ATOL = 2.0, 1e-6
MULTIHOST_TIMEOUT = 120
# kernels 5 and 6 vs plain: the CPU tests' tolerances (tests/test_torch_resample.py).
# With trained weights the CDF has steps of ~1e-5, where one ulp of the CDF
# moves a depth by up to ~1e-4 through the guarded lerp, so each output is
# held to a float64 run of the plain version: the kernel's share of
# entries within the tolerances at least the f32 plain version's own, less
# RESAMPLE_SLACK; rows sorted, nothing non-finite
RESAMPLE_Z_ATOL, RESAMPLE_D_ATOL, PDF_ATOL = 1e-5, 1e-4, 1e-4
RESAMPLE_SLACK = 1e-4
# phase 13 also times kernels 5 and 6 on the batch 8 times over (bench.py's
# default batch)
BIG_RAYS = 65536
# the library yardsticks' torch.matmul operands hold at most this many
# samples: a frame's layer outputs at once exceed the card's memory
YARDSTICK_CHUNK = 1 << 20
# kernel vs plain, train pass: f32 both sides. Loss sums over 8192 rays in
# another order (rtol); weights/rgb as the render kernel; each gradient
# leaf, summed over 0.5-1M samples in another order, to GRAD_RTOL of that
# leaf's own largest entry
TRAIN_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
F32_FLOPS = 67e12  # H100 SXM f32 (non-tensor) peak, 700 W
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor-core peak (dense), 700 W
# what bounds the f32 render route: 3 TF32 products a multiply-add
SPLIT_TF32 = f" (split TF32: 3 TF32 products a multiply-add at {TF32_FLOPS / 1e12:g} TFLOP/s)"
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor-core peak (dense), 700 W
HBM_BYTES = 3.35e12
HWF = (400, 400, 555.555)
POSE = (-30.0, -45.0, 4.0)  # theta, phi, radius: the service's default camera
SEED = 0
# f32 kernels vs their plain f32 versions: sums in another order, and in
# kernel 1's f32 route split TF32 products (each f32 operand as hi + lo
# TF32 halves, lo.lo dropped, ~2^-21 a product)
RTOL, ATOL = 1e-4, 1e-5
DEX_EQUAL_SHARE = 0.9999
# bf16 render kernel vs its plain version: the same bf16 roundings of the
# same operands, f32 sums in another order (tensor cores vs cuBLAS), so an
# activation next to a bf16 rounding boundary can round to the neighbouring
# value on one side; with σ of std 20 one such flip can move a weight by
# ~1e-2. Each map is therefore held relative to the dtype's own effect, the
# bf16 plain version's distance to the f32 plain version ("own"): the
# kernel's distance to the bf16 plain version at most own (max) and
# BF16_P999 x own (99.9th percentile), + BF16_REL_ATOL; and the kernel's
# distance to the f32 plain version at most BF16_REL x own (max and 99.9th
# percentile), + BF16_REL_ATOL.
BF16_P999 = 0.25
BF16_REL, BF16_REL_ATOL = 1.5, 1e-5
BF16_DEX_SHARE = 0.999
SIGMA_SCALE = 20.0  # σ head output: standardized, times this (see calibrate)


# phase 22: the wide bf16 route, configs/lego-tpu.yml at FlexibleNeRF 8x256
# (the NeRF paper's width, every reference pretrained config's); the widths
# held on a small batch: 100 (the narrow kernels, not a multiple of 8), 136
# (the narrow kernels' old refusal), 320 (past JAX's 256 loss-block switch),
# 576 (MAX_HIDDEN_BF16: one consumer, the dW plan in parts)
WIDE_HIDDEN = 256
WIDE_ITERS = 10
WIDE_WIDTHS = (100, 136, 320, 576)
WIDE_SMALL_RAYS = 512
# the wide route's training kernels, by name (the profile's parts); the dW,
# reduction and the rest are the narrow route's
WIDE4_NAMES = ("train_prep_kernel", "train_fwd_wide_kernel", "train_composite_kernel",
               "train_chain_wide_kernel", "train_dw_bf16_kernel", "reduce",
               "sum_rays_bf16_kernel")
WIDE_PARTS = {"train_fwd_bf16_kernel": "train_fwd_wide_kernel<4>",
              "train_chain_bf16_kernel": "train_chain_wide_kernel",
              "train_dw_bf16_kernel": "train_dw_bf16_kernel"}
WIDE_KERNELS = ("fused_render_wide_kernel", "train_fwd_wide_kernel", "train_chain_wide_kernel",
                "train_dw_bf16_kernel")
# phase 23: the wide f32 route at 8x256 (phase 22's config at float32); the
# widths held on a small batch: 136 (the first past the narrow tile, two
# consumers), 320 (one consumer) and MAX_HIDDEN (None)
WIDE_F32_WIDTHS = (136, 320, None)
WIDE_F32_THRESHOLDS = tuple(5.0 * (i + 1) for i in range(20))  # the 8x256 frame's Dex thresholds
WIDE_F32_KERNELS = ("fused_render_wide_tf32_kernel", "train_fwd_wide_tf32_kernel",
                    "train_chain_wide_tf32_kernel", "dw_tf32_kernel")
# the wide f32 route's training kernels, by name (the profile's parts)
WIDE_F32_NAMES = ("train_prep_tf32_kernel", "train_fwd_wide_tf32_kernel",
                  "train_composite_tf32_kernel", "train_chain_wide_tf32_kernel",
                  "dw_tf32_kernel", "dw_tf32_reduce_kernel", "sum_rays_kernel")


# phase 24: the host-streamed store (dataset.host_store) on a synthetic
# lego scene whose f32 rows pass 1 GB: 40 views at 800x800 (25.6 M rays,
# 1.23 GB of rows, 77 MB of u8 rgb); the entry point's steps on each wire,
# the updates of the three-step comparison through kernel 4's bf16 and f32
# routes, the batches of the timings and the steps a timed turn, the steps
# of (d)'s runs; the packed step against the rows step: the CPU test's
# tolerances (tests/test_torch_host_store.py, 3 updates on the f32 path) on
# the losses and the first update's gradients (over the step's largest
# gradient entry), on the first bf16 update's loss and on 3 updates through
# the f32 route
HOST_HW, HOST_VIEWS = 800, (40, 1, 1)
HOST_ITERS, HOST_UPDATES, HOST_F32_UPDATES, HOST_SMALL_ITERS = 20, 5, 3, 4
HOST_BATCHES, HOST_TIMED = (8192, 65536), 30
PACKED_LOSS_RTOL, PACKED_GRAD_RTOL = 1e-6, 1e-5


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


def calibrate_on(models, rays, s_val, torch):
    """:func:`calibrate_sigma_head` of each of ``models`` (in place) on the
    coarse samples of every 40th ray of ``rays`` (a flat RayBatch)."""
    from dexnerf_tpu_torch.core.encoding import positional_encoding
    from dexnerf_tpu_torch.core.sampling import stratified_z_vals

    sub = slice(0, None, 40)
    z = stratified_z_vals(rays.near[sub], rays.far[sub], s_val.num_coarse, lindisp=s_val.lindisp)
    for m in models:
        pts = rays.origins[sub, None] + rays.directions[sub, None] * z[..., None]
        calibrate_sigma_head(m, positional_encoding(pts, m.num_encoding_fn_xyz),
                             positional_encoding(rays.viewdirs[sub], m.num_encoding_fn_dir), torch)


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


def host_ms(torch, fn, n=3):
    """Host-clock ms of a warm ``fn()`` to its synchronize, mean of ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


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


def p999(err, torch):
    """99.9th percentile of ``err`` (torch.quantile takes at most 2^24
    entries; a frame's weights have 20M)."""
    flat = err.flatten()
    return float(torch.topk(flat, max(1, flat.numel() // 1000)).values[-1])


def compare_bf16(name, got, want, want_f32, torch):
    """The bf16 kernel ``got`` vs the bf16 plain version ``want`` and the
    f32 plain version ``want_f32``, each map relative to the bf16 plain
    version's own distance to ``want_f32`` (see BF16_*). Returns the max
    abs error vs ``want``."""
    worst, bad = 0.0, []
    for field in ("rgb", "disparity", "accumulation", "depth", "weights"):
        a, b, f = getattr(got, field), getattr(want, field), getattr(want_f32, field)
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}.{field}: shape {tuple(a.shape)} or non-finite values")
        e_b, e_k, e_p = (a - b).abs(), (a - f).abs(), (b - f).abs()
        b_max, k_max, p_max = float(e_b.max()), float(e_k.max()), float(e_p.max())
        b_999, k_999, p_999 = p999(e_b, torch), p999(e_k, torch), p999(e_p, torch)
        if field != "disparity":
            worst = max(worst, b_max)
        ok = (b_max <= p_max + BF16_REL_ATOL and b_999 <= BF16_P999 * p_999 + BF16_REL_ATOL
              and k_max <= BF16_REL * p_max + BF16_REL_ATOL
              and k_999 <= BF16_REL * p_999 + BF16_REL_ATOL)
        print(f"  {'ok  ' if ok else 'FAIL'} {name}.{field}: vs bf16 plain max {b_max:.3e} "
              f"p99.9 {b_999:.3e}; vs f32 plain: kernel max {k_max:.3e} p99.9 {k_999:.3e}, "
              f"bf16 plain (own) max {p_max:.3e} p99.9 {p_999:.3e}")
        if not ok:
            bad.append(field)
    if bad:
        raise AssertionError(f"{name}: bf16 kernel outside its tolerances in {bad}")
    return worst


def plain_rays(coarse, fine, settings, compute_dtype, torch):
    """``make_fused_render_rays``'s coarse -> fine renderer with both passes
    through ``fused_render_reference`` (the plain versions' frame)."""
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.render.renderer import RenderResult

    s = settings.eval_variant()
    kw = dict(white_background=s.white_background, compute_dtype=compute_dtype)

    def render(rays):
        o, d, v = (t.contiguous() for t in rays[:3])
        z = stratified_z_vals(rays.near, rays.far, s.num_coarse, lindisp=s.lindisp)
        c = fr.fused_render_reference(coarse, o, d, v, z, ray_dists(z, d), **kw)
        zf, _ = hierarchical_z_vals(z, c.weights, s.num_fine, det=True)
        f = fr.fused_render_reference(fine, o, d, v, zf, ray_dists(zf, d),
                                      thresholds=s.m_thres_cand, **kw)
        return RenderResult(coarse=c, fine=f)

    return render


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


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS):
    """(least ms, what bounds it) at the H100 SXM's published peaks: the
    f32 CUDA-core rate, or ``peak``."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_modules():
    """Every kernel wrapper module of the port, by name; each holds its
    launch counter ``launches``."""
    from dexnerf_tpu_torch.ops import (
        fused_mlp,
        fused_mlp_train,
        fused_render,
        fused_train_loss,
        resample,
        sample_pdf,
    )

    return {"fused_render": fused_render, "fused_mlp": fused_mlp,
            "fused_mlp_train": fused_mlp_train, "fused_train_loss": fused_train_loss,
            "resample": resample, "sample_pdf": sample_pdf}


# the counters besides ``launches``: bf16 routes, wide bf16 ones, wide f32 ones
ROUTE_COUNTS = ("bf16", "wide", "wide_f32")


def zero_counts():
    """Set every wrapper's launch counts (``launches``, ``launches_bf16``,
    ``launches_wide``, ``launches_wide_f32``) to 0."""
    for m in kernel_modules().values():
        m.launches = 0
        for route in ROUTE_COUNTS:
            if hasattr(m, f"launches_{route}"):
                setattr(m, f"launches_{route}", 0)


def read_counts():
    """Every wrapper's launch counts, by module (``<module>_bf16`` for the
    bf16 routes, ``<module>_wide`` for the wide bf16 route,
    ``<module>_wide_f32`` for the wide f32 route)."""
    mods = kernel_modules()
    counts = {k: m.launches for k, m in mods.items()}
    for route in ROUTE_COUNTS:
        counts.update({f"{k}_{route}": getattr(m, f"launches_{route}") for k, m in mods.items()
                       if hasattr(m, f"launches_{route}")})
    return counts


def eval_cli(cfg_path, ckpt, savedir, flags, dev):
    """``dexnerf_tpu_torch.apps.eval`` on ``dev`` with ``cfg_path``,
    ``ckpt`` and the extra CLI ``flags``, every launch counter set to 0 just
    before and read just after. Returns the counts, the ``metrics.json``
    (None without ``--test-set``) and the seconds."""
    from dexnerf_tpu_torch.apps import eval as eval_app

    zero_counts()
    t0 = time.perf_counter()
    eval_app.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir", savedir,
                   "--device", dev.type, *flags])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    path = os.path.join(savedir, "metrics.json")
    metrics = None
    if os.path.exists(path):
        with open(path) as f:
            metrics = json.load(f)
    return counts, metrics, seconds


def device_ms(torch, calls, n=3):
    """Device ms per call of each kernel of ``calls`` (name fragment ->
    a function that launches it), from one ``torch.profiler`` trace of
    ``n`` warm calls of each; None for a kernel the trace does not hold
    (then the device events it holds are printed)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for frag in calls:
        spans = [e.time_range.end - e.time_range.start for e in events if frag in e.name]
        out[frag] = sum(spans) / n / 1e3 if spans else None
    if None in out.values():
        print(f"  profile: no device event for {[k for k, v in out.items() if v is None]}; "
              f"its device events: {sorted({e.name[:60] for e in events})}")
    return out


def device_all_ms(torch, fn, n=3):
    """Device ms per call of ``fn``, all its device events summed, from a
    ``torch.profiler`` trace of ``n`` warm calls (None if the trace holds
    none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / n / 1e3 if spans else None


def train_cli(tmp, data, name, iters, torch, dev, config=TRAIN_CONFIG, dataset=None, flags=(),
              train=None, models=None, optimizer=None, **nerf):
    """``config`` (``configs/lego-tpu.yml``) pointed at the dataset ``data``,
    with the ``dataset``, ``nerf.train`` (``train``) and ``nerf`` keys, the
    model blocks' types (``models``: block -> type) and ``optimizer.type``
    overridden, trained through
    ``dexnerf_tpu_torch.apps.train`` (with the extra CLI ``flags``) for
    ``iters`` steps on ``dev`` with every launch counter set to 0 just
    before and read just after. Returns the config path, the log directory,
    the counts, the losses, the validation PSNRs, the seconds and the peak
    device memory (GiB)."""
    import yaml

    from dexnerf_tpu_torch.apps import train as train_app

    with open(config) as f:
        raw = yaml.safe_load(f)
    raw["dataset"].update({"basedir": data, "half_res": False, "cachedir": "", **(dataset or {})})
    raw["experiment"].update(
        id=name, logdir=os.path.join(tmp, "logs"), validate_every=iters,
        save_every=iters, print_every=1,
    )
    raw["nerf"].update(nerf)
    raw["nerf"]["train"].update(train or {})
    for blk, typ in (models or {}).items():
        raw["models"][blk]["type"] = typ
    if optimizer is not None:
        raw["optimizer"]["type"] = optimizer
    cfg_path = os.path.join(tmp, f"{name}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    train_app.main(["--config", cfg_path, "--device", dev.type, "--max-iters", str(iters),
                    *flags])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    logdir = os.path.join(tmp, "logs", name)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["value"] for r in sorted(
        (r for r in recs if r["tag"] == "train/loss"), key=lambda r: r["step"])]
    val_psnr = [r["value"] for r in recs if r["tag"] == "validation/psnr"]
    return cfg_path, logdir, counts, losses, val_psnr, seconds, peak_gb


def run_checks(title, checks):
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if not all(checks.values()):
        raise AssertionError(f"{title} checks failed")


def run_models(cfg_path, logdir, iters, dev):
    """The config, the models of a run's last checkpoint and the checkpoint."""
    from dexnerf_tpu_torch.config import load_config
    from dexnerf_tpu_torch.train.checkpoints import read_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import setup_models

    ckpt = read_reference_checkpoint(
        os.path.join(logdir, "checkpoints", f"checkpoint_{iters - 1:07d}.ckpt"))
    cfg = load_config(cfg_path)
    coarse, fine = setup_models(cfg, 0, dev)
    coarse.load_state_dict(ckpt["coarse"])
    fine.load_state_dict(ckpt["fine"])
    return cfg, coarse, fine, ckpt


def train_phase(torch, np, card, dev, tmp):
    """Phases 6-8 on ``dev``, in the directory ``tmp``: train through the
    port's CLI, then kernel 4 vs plain and timings at the run's shapes.
    Returns kernel 4's kernels-line entry and what the later phases share
    (the dataset, the settings, one batch of rays and its draws, a
    field-path step)."""
    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
    from dexnerf_tpu_torch.render.renderer import draw_render_noise, jittered_z_vals
    from dexnerf_tpu_torch.train.checkpoints import load_adam_state
    from dexnerf_tpu_torch.train.loop import load_scene
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

    # ---- phase 6: the training entry point, 40 steps at full width
    t0 = time.perf_counter()
    data = os.path.join(tmp, "scene")
    write_blender_dataset(data, TRAIN_HW, TRAIN_HW, TRAIN_VIEWS, device=dev)
    dataset_s = time.perf_counter() - t0
    cfg_path, logdir, counts, losses, val_psnr, train_s, peak_gb = train_cli(
        tmp, data, "lego-tpu-smoke", TRAIN_ITERS, torch, dev)
    launches, render_launches = counts["fused_train_loss"], counts["fused_render"]
    launches_bf16 = counts["fused_train_loss_bf16"]
    cfg, coarse, fine, ckpt = run_models(cfg_path, logdir, TRAIN_ITERS, dev)
    state = init_train_state(coarse, fine, float(cfg.optimizer.lr))
    load_adam_state(state.optimizer, ckpt["optimizer_state_dict"])
    moments_finite = all(
        bool(torch.isfinite(st["exp_avg"]).all() and torch.isfinite(st["exp_avg_sq"]).all())
        for st in state.optimizer.state.values()
    )
    print(f"phase 6: trained {TRAIN_ITERS} steps in {train_s:.2f} s (dataset {dataset_s:.2f} s); "
          f"fused_train_loss launches {launches} (bf16 route {launches_bf16}), fused_render "
          f"launches {render_launches}; "
          f"peak {peak_gb:.2f} GiB; loss first {losses[0]:.5f} last {losses[-1]:.5f}; "
          f"validation psnr {val_psnr}")
    run_checks("training", {
        f"{TRAIN_ITERS} finite losses": len(losses) == TRAIN_ITERS
        and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 10 < first 10)": np.mean(losses[-10:]) < np.mean(losses[:10]),
        f"kernel 4's bf16 route launched {2 * TRAIN_ITERS} times, its f32 route never":
            launches_bf16 == 2 * TRAIN_ITERS and launches == launches_bf16,
        "validation through kernel 1 at bf16": render_launches >= 2
        and counts["fused_render_bf16"] == render_launches and len(val_psnr) >= 1
        and bool(np.isfinite(val_psnr).all()),
        ".ckpt reads back with Adam": ckpt["step"] == TRAIN_ITERS and moments_finite
        and len(state.optimizer.state) == len(list(coarse.parameters())) * 2,
    })
    # the f32 route through the same entry point
    _, _, counts_f, losses_f, val_f, secs_f, _ = train_cli(
        tmp, data, "lego-tpu-f32", F32_TRAIN_ITERS, torch, dev, pallas_compute_dtype="float32")
    launches_f32 = counts_f["fused_train_loss"]
    print(f"phase 6: pallas_compute_dtype float32, {F32_TRAIN_ITERS} steps in {secs_f:.2f} s; "
          f"kernel 4 launches {launches_f32} (bf16 route {counts_f['fused_train_loss_bf16']}); "
          f"loss first {losses_f[0]:.5f} last {losses_f[-1]:.5f}")
    run_checks("training at float32", {
        f"{F32_TRAIN_ITERS} finite losses": len(losses_f) == F32_TRAIN_ITERS
        and bool(np.isfinite(losses_f).all()),
        f"kernel 4's f32 route launched {2 * F32_TRAIN_ITERS} times, its bf16 route never":
            launches_f32 == 2 * F32_TRAIN_ITERS and counts_f["fused_train_loss_bf16"] == 0,
        "validation through kernel 1's f32 route": counts_f["fused_render"] >= 2
        and counts_f["fused_render_bf16"] == 0 and bool(np.isfinite(val_f).all()),
    })
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
    worst, worst_b, per_pass = 0.0, 0.0, {}
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
        print_leaves(leaves)
        if bad:
            raise AssertionError(f"{name} pass: kernel and plain differ in {bad}")
        worst_b = max(worst_b, check_train_bf16(name, model, args, norm, want, torch))
        per_pass[name] = args
        if name == "coarse":
            z_f, _ = hierarchical_z_vals(z_c, want[1], s_train.num_fine, det=False, u=draws.u_fine)
            passes["fine"] = (fine, z_f, draws.noise_fine)

    # ---- phase 8: timings, bound, profile of the kernel path
    ms = {}
    flops, byts, byts_b, dw_flops = kernel4_sizes(per_pass, dev)
    bf = dict(compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)
    for name, args in per_pass.items():
        for tag, kw in (("", {}), ("_bf16", bf)):
            ms[f"{name}_kernel{tag}"] = timed_ms(lambda: ftl.fused_pass_loss(*args, **kw), torch)
            ms[f"{name}_plain{tag}"] = timed_ms(
                lambda: ftl.fused_pass_loss_reference(*args, **kw), torch)
    # the f32 route in split TF32: three TF32 products a multiply-add
    bound_ms, bound_by = bound(3 * flops, byts, TF32_FLOPS)
    bound_fma, _ = bound(flops, byts)
    bound_b, bound_b_by = bound(flops, byts_b, BF16_FLOPS)
    # library yardsticks: each route's weight-gradient products of both
    # passes (cotangents^T x activations over every sample) as torch.matmul
    # calls in its dtype (f32 without TF32); the f32 pass's forward and chain
    # products the same way
    dw_yardsticks(ms, [(a[0], a[3].numel()) for a in per_pass.values()], torch, dev)
    k4_passes = [(a[0], a[3].numel()) for a in per_pass.values()]
    pass_yardsticks(ms, "k4", k4_passes, torch, dev)
    pass_yardsticks(ms, "k4", k4_passes, torch, dev, torch.bfloat16)

    def step_ms(path, reps=5):
        """(ms per train step, the step) through ``path``: kernel 4
        (``kernel``), the fields (``fields``), kernel 4 with kernel 5
        (``resample``), each at f32 or with ``_bf16``; or ``plain``."""
        st = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        kw = {}
        dt = torch.bfloat16 if path.endswith("_bf16") else torch.float32
        if path.startswith(("kernel", "resample")):
            kw["fused_loss"] = ftl.make_fused_train_loss(
                coarse, fine, s_train,
                resample="pallas" if path.startswith("resample") else "auto",
                compute_dtype=dt, dw_dtype=dt)
        elif path.startswith("fields"):
            kw["coarse_field"], kw["fine_field"] = (
                make_fused_flexible_field_train(m, compute_dtype=dt, dw_dtype=dt)
                for m in (coarse, fine))
        step = make_train_step(s_train, batch, **kw)
        return host_ms(torch, lambda: step(st, store, gen), n=reps), (lambda: step(st, store, gen))

    peaks = {}
    steps = {}
    for path in ("kernel_bf16", "kernel", "plain", "resample_bf16"):
        torch.cuda.reset_peak_memory_stats()
        ms[f"step_{path}"], steps[path] = step_ms(path)
        peaks[path] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 8: ms on {card} (passes: CUDA events, mean of 3; steps: host clock "
          f"around synchronize, mean of 5): " + json.dumps({k: round(t, 3) for k, t in ms.items()}))
    kernel_b = ms["coarse_kernel_bf16"] + ms["fine_kernel_bf16"]
    print(f"  kernel 4 bound for both passes: {bound_ms:.3f} ms f32 route ({bound_by}"
          f"{SPLIT_TF32 if bound_by == 'operations' else ''}; {flops / 1e12:.4f} TFLOP, of "
          f"which {dw_flops / 1e12:.4f} weight gradients, {byts / 1e6:.2f} MB), "
          f"{bound_fma:.3f} ms at the f32 FMA peak; bf16 route {bound_b:.3f} ms ({bound_b_by}; "
          f"{byts_b / 1e6:.2f} MB); achieved "
          f"{flops / (ms['coarse_kernel'] + ms['fine_kernel']) / 1e9:.2f} TFLOP/s (f32 route), "
          f"{flops / kernel_b / 1e9:.2f} TFLOP/s (bf16 route); rays/s per step: "
          + json.dumps({k: round(batch / (ms[f"step_{k}"] / 1e3)) for k in steps})
          + "; peak memory of a step (GiB): "
          + json.dumps({k: round(v, 2) for k, v in peaks.items()}))
    print("  bf16 route residency (CUDA occupancy API; CTAs per SM, shared bytes per CTA; the "
          "forwards also ring stages, staging tiles per consumer): "
          + json.dumps(ftl.bf16_occupancy(fine)))
    print_fwd_plan("kernel 4", fine, {k: tuple(a[3].shape) for k, a in per_pass.items()},
                   ftl.SCRATCH_SAMPLES, torch, dev)
    print_dw_plan(fine, *per_pass["fine"][3].shape, torch, dev)
    print("  bf16 steps:")
    prof = profile_steps(torch, steps["kernel_bf16"], {"kernel 4 bf16": KERNEL4_BF16_NAMES})
    parts, sizes = bf16_parts(prof, 4, k4_passes, bf16_library(ms, "k4"))
    print("  bf16 route's kernels, device ms per step (profile) beside their bounds: "
          + json.dumps(parts))
    print("  bytes and operations behind those bounds (scratch layout, this run's shapes): "
          + json.dumps(sizes))
    print("  f32 steps (pallas_compute_dtype: float32):")
    prof_f = profile_steps(torch, steps["kernel"], {"kernel 4": KERNEL4_NAMES})
    shapes = [(a[0], *a[3].shape) for a in per_pass.values()]
    pass_f32 = f32_pass_parts(prof_f, shapes, ms, "k4")
    dw_f32 = f32_dw_share(prof_f, ms["dw_torch_matmul_f32"], shapes)
    entry = dict(route="cuda", replaces="dexnerf_tpu/ops/fused_train_loss.py:99")
    train_kernels = [{
        "name": "fused_train_loss",
        **entry,
        "source": "dexnerf_tpu_torch/ops/csrc/fused_train_loss.cu",
        "launches": launches_f32,
        "max_abs_err": worst,
        "ms": ms["coarse_kernel"] + ms["fine_kernel"],
        "plain_ms": ms["coarse_plain"] + ms["fine_plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by + (SPLIT_TF32 if bound_by == "operations" else ""),
        "library_ms": ms["dw_torch_matmul_f32"] + ms["k4_forward_torch_matmul_f32"]
        + ms["k4_chain_torch_matmul_f32"],
        "parts": pass_f32 + dw_f32,
    }, {
        "name": "fused_train_loss_bf16",
        **entry,
        "source": "dexnerf_tpu_torch/ops/csrc/fused_train_loss_bf16.cu",
        "launches": launches_bf16,
        "max_abs_err": worst_b,
        "ms": kernel_b,
        "plain_ms": ms["coarse_plain_bf16"] + ms["fine_plain_bf16"],
        "bound_ms": bound_b,
        "bound_by": bound_b_by,
        "library_ms": sum(bf16_library(ms, "k4").values()),
        "parts": parts,
    }]
    shared = types.SimpleNamespace(data=data, cfg_path=cfg_path, logdir=logdir,
                                   s_train=s_train, o=o, d=d, v=v, target=target,
                                   z_c=z_c, draws=draws, step_ms=step_ms)
    return train_kernels, shared


def kernel4_sizes(per_pass, dev):
    """(FLOPs, f32 route bytes, bf16 route bytes, weight-gradient FLOPs) of
    kernel 4's passes ``per_pass`` (name -> the pass's positional args):
    the forward, the chain and the weight gradients (the forward's
    multiply-adds again); the inputs read once, the weights read (the bf16
    route reads its bf16 packs and the f32 heads instead) and the
    gradients, rgb, weights and loss written once."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    flops = byts = byts_b = dw_flops = 0.0
    for args in per_pass.values():
        model, z = args[0], args[3]
        n, s = z.shape
        ps, pr = mlp_macs(model)
        dw_flops += 2 * (n * s * ps + n * pr)
        flops += train_flops(model, n, s)
        params = list(model.parameters())
        io = nbytes(*args[1:]) + nbytes(z) + 3 * 4 * n + 4
        byts += io + 2 * nbytes(*params)
        byts_b += io + nbytes(*params) + nbytes(*ftl._cached_bf16_weights(model, dev)[:2],
                                                ftl.pack_backward_weights_bf16(model, dev))
    return flops, byts, byts_b, dw_flops


def dw_gemm_operands(model, k, torch, dev, dtype):
    """Random ``dtype`` operands of a route's weight-gradient products of
    one pass over ``k`` samples, as (cotangents [k, N], activations
    [k, M]): layer1, the trunk (and skip) layers, fc_feat, fc_alpha,
    layers_dir.0 (its feat rows) and fc_rgb."""
    H, h2, dx = model.hidden_size, model.hidden_size // 2, model.dim_xyz
    shapes = [(H, dx)] + [(H, H)] * (model.num_layers - 1) + [(H, dx)] * len(model.skips)
    shapes += [(H, H), (1, H), (h2, H), (3, h2)]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(cols):
        return torch.randn((k, cols), generator=gen, device=dev).to(dtype)

    return [(rnd(n), rnd(m)) for n, m in shapes]


def dw_yardsticks(ms, passes, torch, dev):
    """``ms["dw_torch_matmul_f32"]`` and ``ms["dw_torch_matmul_bf16"]``:
    the weight-gradient products of ``passes`` ((model, samples) each) as
    torch.matmul calls at f32 (TF32 off) and at bf16, CUDA events."""
    for tag, dt in (("_f32", torch.float32), ("_bf16", torch.bfloat16)):
        gemms = [g for m, k in passes for g in dw_gemm_operands(m, k, torch, dev, dt)]
        ms["dw_torch_matmul" + tag] = timed_ms(
            lambda: [torch.matmul(d.t(), a) for d, a in gemms], torch)
        del gemms


def pass_gemm_operands(model, k, part, torch, dev, dtype):
    """Random ``dtype`` operands (inputs [k, K], weights [K, N]) of one
    pass's layer products over ``k`` samples: the forward's (layer1, the
    trunk and its skip rows, fc_feat, fc_alpha, layers_dir.0's feat rows,
    fc_rgb) or the cotangent chain's (the transposes of fc_rgb,
    layers_dir.0's feat rows, fc_feat with fc_alpha, the trunk's h rows)."""
    H, h2, dx, nt = model.hidden_size, model.hidden_size // 2, model.dim_xyz, model.num_layers - 1
    if part == "forward":
        shapes = [(dx, H)] + [(H, H)] * nt + [(dx, H)] * len(model.skips)
        shapes += [(H, H), (H, 1), (H, h2), (h2, 3)]
    else:
        shapes = [(3, h2), (h2, H), (H + 1, H)] + [(H, H)] * nt
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return [(torch.randn((k, a), generator=gen, device=dev).to(dtype),
             torch.randn((a, b), generator=gen, device=dev).to(dtype)) for a, b in shapes]


def pass_yardsticks(ms, tag, passes, torch, dev, dtype=None, parts=("forward", "chain")):
    """``ms[f"{tag}_{part}_torch_matmul_{f32|bf16}"]`` for each of
    ``parts``: the forward's or the cotangent chain's layer products of
    ``passes`` ((model, samples) each) as torch.matmul calls in ``dtype``
    (float32 by default, TF32 off; or bfloat16), CUDA events. Operands of
    at most ``YARDSTICK_CHUNK`` samples, their products called again for
    each chunk of a larger pass (a frame's samples)."""
    chunk = YARDSTICK_CHUNK
    dtype = torch.float32 if dtype is None else dtype
    name = "f32" if dtype == torch.float32 else "bf16"

    def run(calls):
        for x, w in calls:  # each product dropped once done: a frame's outputs exceed the card
            torch.matmul(x, w)

    for part in parts:
        calls = []
        for m, k in passes:
            ops = pass_gemm_operands(m, min(k, chunk), part, torch, dev, dtype)
            calls += [(x[:min(chunk, k - i)], w) for i in range(0, k, chunk) for x, w in ops]
        ms[f"{tag}_{part}_torch_matmul_{name}"] = timed_ms(lambda: run(calls), torch)
        del calls


def bf16_library(ms, tag):
    """The bf16 route's kernels' products as bf16 torch.matmul, by kernel
    name (``ms`` of :func:`pass_yardsticks` under ``tag`` and of
    :func:`dw_yardsticks`)."""
    return {"train_fwd_bf16_kernel": ms[f"{tag}_forward_torch_matmul_bf16"],
            "train_chain_bf16_kernel": ms[f"{tag}_chain_torch_matmul_bf16"],
            "train_dw_bf16_kernel": ms["dw_torch_matmul_bf16"]}


def f32_pass_sizes(model, n, s, owner=4):
    """(bytes, [(FLOPs, peak FLOP/s), ...]) of the f32 pass's kernels over
    one pass of ``n`` rays x ``s`` samples, each input read once and each
    output written once: prep (viewdirs in; encodings and the per-ray
    viewdir bias out), forward (points, depths and the bias in; every
    activation, raw and the ReLU mask words out; layer1 on the CUDA cores,
    the rest three TF32 products a multiply-add), compositing (raw, depths,
    intervals, noise, targets in; weights, rgb, losses, raw's cotangent
    out), chain (raw's cotangent and the mask words in; every cotangent and
    the per-ray dy sums out; three TF32 products a multiply-add). For the
    launcher ``owner`` 4 (kernel 4), 3 (kernel 3: the points, 12 B a
    sample, in place of the ray and its depths; no compositing; the chain on
    the caller's cotangent) or 2 (kernel 2: prep and forward, the points in
    and raw out, no encodings and no scratch)."""
    from dexnerf_tpu_torch.ops import _weight_grads as wgr
    from dexnerf_tpu_torch.ops.fused_render import bf16_hidden

    rows = wgr.scratch_rows(model)
    H, nt, dd = model.hidden_size, model.num_layers - 1, model.dim_dir
    hp = bf16_hidden(H)
    mask_b = 4 * ((nt + 1) * -(-hp // 64) + -(-hp // 128)) * 128 / 64  # mask words a sample
    ps, pr = mlp_macs(model)
    l1 = model.dim_xyz * H  # layer1's multiply-adds a sample
    k = n * s
    prep_ops = [(2 * n * pr, F32_FLOPS)]
    fwd_ops = [(3 * 2 * k * (ps - l1), TF32_FLOPS), (2 * k * l1, F32_FLOPS)]
    chain = (k * (16 + mask_b + 4 * rows["dlt_rows"]) + n * 2 * H,
             [(3 * 2 * k * backward_macs(model), TF32_FLOPS)])
    if owner == 2:
        return {"train_prep_tf32_kernel": (n * (12 + 2 * hp), prep_ops),
                "train_fwd_tf32_kernel": (n * 2 * hp + k * (12 + 16), fwd_ops)}
    sizes = {
        "train_prep_tf32_kernel": (n * (12 + 4 * dd + 4 * hp // 2), prep_ops),
        "train_fwd_tf32_kernel": (n * (24 + 2 * hp) + k * (4 + 4 * rows["act_rows"] + 16 + mask_b),
                                  fwd_ops),
        "train_composite_tf32_kernel": (n * (12 + 12 + 4) + k * (16 + 16 + 4 + 16), []),
        "train_chain_tf32_kernel": chain,
    }
    if owner == 3:
        del sizes["train_composite_tf32_kernel"]
        sizes["train_fwd_tf32_kernel"] = (
            n * 2 * hp + k * (12 + 4 * rows["act_rows"] + 16 + mask_b), fwd_ops)
    return sizes


def f32_pass_parts(prof, passes, ms, tag, owner=4, wide=False):
    """The f32 pass kernels of launcher ``owner`` (kernel 4, or kernels 3
    and 2 on the field path: :func:`f32_pass_sizes`) by device ms per step
    from a profile, each beside its bound over ``passes`` ((model, rays,
    samples) each: the forward's layer1 at the f32 FMA rate, its other
    products and the chain's at the split-TF32 rate, or the bytes) and, for
    the forward and the chain, their products as f32 torch.matmul (``ms``,
    of :func:`pass_yardsticks` under ``tag``); printed and returned as a
    ``parts`` list. Raises if the profile holds events but any of them
    reads 0 ms, or holds one of the FMA kernels they replaced
    (``train_pass_kernel``, ``field_fwd_kernel``, ``field_bwd_kernel``).
    ``wide``: the forward and the chain are the wide route's
    (``train_fwd_wide_tf32_kernel``, ``train_chain_wide_tf32_kernel``)."""
    sizes = {}  # name -> (bytes, FLOPs at each peak, the peaks)
    for model, n, s in passes:
        for name, (b, ops) in f32_pass_sizes(model, n, s, owner).items():
            ob, oflops, _ = sizes.get(name, (0.0, [0.0] * len(ops), None))
            sizes[name] = (ob + b, [x + f for x, (f, _) in zip(oflops, ops)],
                           [p for _, p in ops])
    fma = [k for k in prof if any(f in k for f in ("train_pass_kernel", "field_fwd_kernel",
                                                    "field_bwd_kernel"))]
    if fma:
        raise AssertionError(f"f32 pass: the profile holds the FMA kernels {fma}")
    lib = {"train_fwd_tf32_kernel": ms[f"{tag}_forward_torch_matmul_f32"],
           "train_chain_tf32_kernel": ms[f"{tag}_chain_torch_matmul_f32"]}
    parts, line = [], {}
    for name in F32_PASS_NAMES:
        if name not in sizes:
            continue
        # the templates carry the launcher's tag: train_fwd_tf32_kernel<3, 8>
        kname = name
        if wide and name in ("train_fwd_tf32_kernel", "train_chain_tf32_kernel"):
            kname = name.replace("_tf32", "_wide_tf32")
        frag = name if name == "train_composite_tf32_kernel" else f"{kname}<{owner}"
        dev_ms = sum(t for k, t in prof.items() if frag in k)
        if prof and dev_ms <= 0:
            raise AssertionError(f"f32 pass: profile time {dev_ms} ms of {frag}; kernels "
                                 f"{sorted(k[:60] for k in prof)}")
        b, flops, peaks = sizes[name]
        t_ops = max([1e3 * f / p for f, p in zip(flops, peaks)], default=0.0)
        b_ms = max(t_ops, 1e3 * b / HBM_BYTES)
        b_by = "operations" if t_ops >= 1e3 * b / HBM_BYTES else "bytes"
        if b_by == "operations" and peaks[0] == TF32_FLOPS:
            b_by += SPLIT_TF32
        parts.append({"name": kname if owner == 4 else f"{kname}<{owner}>",
                      "ms": dev_ms if prof else None, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib.get(name)})
        line[kname] = [round(dev_ms, 3), round(b_ms, 3), f"{b / 1e9:.4f} GB",
                      [f"{f / 1e12:.4f} TFLOP at {p / 1e12:g}" for f, p in zip(flops, peaks)]]
    print(f"  kernel {owner}'s f32 pass kernels, device ms per step (profile) [ms, bound ms, "
          "bytes, FLOPs at their peak (TF32: three products a multiply-add)]: "
          + json.dumps(line) + "; their products as f32 torch.matmul (TF32 off): "
          + json.dumps({k: round(v, 3) for k, v in lib.items() if k in sizes})
          + f"; the pass's kernels {sum(p['ms'] or 0.0 for p in parts):.3f}")
    return parts


def f32_dw_bound(passes):
    """(bound ms, what bounds it, bytes, TF32 FLOPs, TF32 product ms) of
    the f32 routes' weight gradients over ``passes`` ((model, rays,
    samples) each): the function's compulsory traffic, the scratch read
    once (every activation and cotangent row of each padded sample) and the
    gradient written once, at 3.35 TB/s; three TF32 products of every
    multiply-add at the TF32 peak."""
    from dexnerf_tpu_torch.ops import _weight_grads as wgr

    nbytes = flops = 0.0
    for model, n, s in passes:
        s_pad = -(-s // 64) * 64
        rows = wgr.scratch_rows(model)
        nbytes += 4.0 * n * s_pad * (rows["act_rows"] + rows["dlt_rows"])
        nbytes += 4.0 * sum(p.numel() for p in model.parameters())
        ps, pr = mlp_macs(model)
        flops += 3 * 2 * (n * s_pad * ps + n * pr)
    ms, by = bound(flops, nbytes, TF32_FLOPS)
    return ms, by, nbytes, flops, 1e3 * flops / TF32_FLOPS


def f32_dw_share(prof, library_ms, passes):
    """The f32 routes' weight-gradient kernel (``dw_tf32_kernel``, which
    kernels 3 and 4 launch) by device ms per step from a profile, beside
    its bound (:func:`f32_dw_bound` of ``passes``) and its f32 torch.matmul
    yardstick, with its reduction's device ms; printed and returned as a
    ``parts`` list. Raises if the profile holds events but none of the
    kernel, or one of the FMA ``dw_kernel`` it replaced."""
    dw = sum(t for k, t in prof.items() if "dw_tf32_kernel" in k)
    red = sum(t for k, t in prof.items() if "dw_tf32_reduce_kernel" in k)
    if prof and (dw <= 0 or any("::dw_kernel(" in k for k in prof)):
        raise AssertionError(f"f32 dW: profile time {dw} ms of dw_tf32_kernel; kernels "
                             f"{sorted(k[:60] for k in prof)}")
    b_ms, b_by, b_bytes, b_flops, ops_ms = f32_dw_bound(passes)
    print(f"  f32 route's dW kernel (split TF32), device ms per step (profile): {dw:.3f} "
          f"(its reduction {red:.3f}), bound {b_ms:.3f} ({b_by}; {b_bytes / 1e9:.4f} GB of "
          f"scratch read and gradients written once at {HBM_BYTES / 1e12:g} TB/s); its "
          f"{b_flops / 1e12:.4f} TFLOP of TF32 products {ops_ms:.3f} at "
          f"{TF32_FLOPS / 1e12:g} TFLOP/s; the same products as f32 torch.matmul (TF32 off): "
          f"{library_ms:.3f}")
    return [{"name": "dw_tf32_kernel", "ms": dw if prof else None, "bound_ms": b_ms,
             "bound_by": b_by + (SPLIT_TF32 if b_by == "operations" else ""),
             "library_ms": library_ms}]


def f32_field_bits(model, pts, v, g, raw, grads, kw, torch):
    """(kernel 2's raw equal to the raw of kernel 3's forward on every
    scratch chunk, a second kernel-3 call's gradients equal to ``grads``),
    bit for bit, at f32: kernel 3's route driven chunk by chunk through its
    ``Tf32Pass``, whose forward writes raw as kernel 4's does."""
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops._build import load_library

    wg, ps = fmt.tf32_backward_pass(load_library(), model, pts, v, g, **kw)
    stream = torch.cuda.current_stream().cuda_stream
    equal = True
    for c in range(wg.n_chunks):
        rays, r0 = ps.run(c, stream), c * ps.chunk
        got = ps.raw[:4 * rays * ps.s_pad].view(rays, ps.s_pad, 4)[:, :pts.shape[1]]
        equal = equal and bool(torch.equal(got, raw[r0:r0 + rays]))
    again = fmt._launch_backward(model, pts, v, g, **kw)
    torch.cuda.synchronize()
    return equal, all(bool(torch.equal(a, b)) for a, b in zip(grads, again))


def check_train_bf16(name, model, args, norm, want_f32, torch, phase=7, p999_min=0, **kw):
    """Kernel 4's bf16 route vs its bf16 plain version on one pass (the
    loss over ``norm``; ``kw`` the pass's supervision and background):
    loss, weights, rgb and every gradient leaf, each
    held relative to the dtype's own effect, own = |bf16 plain - f32 plain|
    (``want_f32``): the kernel's distance to the bf16 plain version at most
    own (max) and BF16_P999 x own (99.9th percentile), its distance to the
    f32 plain version at most BF16_REL x own, each + BF16_REL_ATOL x the
    largest entry (the 99.9th percentile on entries of at least
    ``p999_min`` values: see :func:`hold_to_own`). Returns the largest max
    abs error against the bf16 plain version."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    bf = dict(kw, compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)
    model.zero_grad(set_to_none=True)
    loss, w, rgb = ftl.fused_pass_loss(*args, **bf)
    (loss / norm).backward()
    torch.cuda.synchronize()
    plain = ftl.fused_pass_loss_reference(*args, **bf)
    got = {"loss": loss.detach().reshape(1) / norm, "weights": w, "rgb": rgb}
    want = {"loss": plain[0].reshape(1) / norm, "weights": plain[1], "rgb": plain[2]}
    f32 = {"loss": want_f32[0].reshape(1) / norm, "weights": want_f32[1],
           "rgb": want_f32[2]}
    for (pname, p), gp, gf in zip(model.named_parameters(), plain[3], want_f32[3]):
        got[pname], want[pname], f32[pname] = p.grad, gp / norm, gf / norm
    return max(hold_to_own(f"phase {phase}: {name} pass, bf16 route vs plain,", got, want, f32,
                           torch, p999_min).values())


def hold_to_own(title, got, want, want_f32, torch, p999_min=0):
    """Each entry of ``got`` (a bf16 route's output or gradient leaf) held to
    the bf16 plain version ``want`` relative to the dtype's own effect, own
    = |bf16 plain - f32 plain| (``want_f32``): the route's distance to the
    bf16 plain version at most own (max) and BF16_P999 x own (99.9th
    percentile), its distance to the f32 plain version at most BF16_REL x
    own, each + BF16_REL_ATOL x the entry's largest value. An entry of
    fewer than ``p999_min`` values is held by the max clauses alone (its
    99.9th percentile is its max, as in the card tests' small launches).
    Prints one line and raises if an entry is outside; returns each
    entry's max abs error against the bf16 plain version."""
    bad, lines, errs = [], {}, {}
    for key in want:
        a, b, f = got[key], want[key], want_f32[key]
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{title} {key}: shape {tuple(a.shape)} or non-finite values")
        atol = BF16_REL_ATOL * float(b.abs().max())
        e_b, e_k, e_p = (a - b).abs(), (a - f).abs(), (b - f).abs()
        b_max, k_max, p_max = float(e_b.max()), float(e_k.max()), float(e_p.max())
        b_999, p_999 = p999(e_b, torch), p999(e_p, torch)
        errs[key] = b_max
        lines[key] = [float(f"{v:.3e}") for v in (b_max, b_999, k_max, p_max, p_999)]
        if not (b_max <= p_max + atol
                and (a.numel() < p999_min or b_999 <= BF16_P999 * p_999 + atol)
                and k_max <= BF16_REL * p_max + atol):
            bad.append(key)
    small = f" on entries of {p999_min} values or more" if p999_min else ""
    print(f"{title} [max, p99.9 vs the bf16 plain version; max vs the f32 plain version; "
          f"own max, own p99.9] (limits: max <= own, p99.9 <= {BF16_P999:g} own{small}, vs f32 "
          f"<= {BF16_REL:g} own, + {BF16_REL_ATOL:g} x scale): " + json.dumps(lines))
    if bad:
        raise AssertionError(f"{title} outside the bf16 tolerances in {bad}")
    return errs


def print_leaves(leaves, limit=f"limit {GRAD_RTOL:g}"):
    print(f"  gradient leaves, [max abs err, max |g| of the plain version, err / max |g|] "
          f"({limit}): " + json.dumps(
              {k: [float(f"{e:.3e}"), float(f"{m:.3e}"), float(f"{e / m if m else 0:.3e}")]
               for k, (e, m) in leaves.items()}))


def train_flops(model, n, s):
    """FLOPs of one pass's training work: the forward, the cotangent chain
    and the weight gradients (multiply-adds counted from the shapes)."""
    ps, pr = mlp_macs(model)
    return 2 * (2 * (n * s * ps + n * pr) + n * s * backward_macs(model))


def bf16_part_bounds(model, n_samples):
    """(bytes, multiply-adds) of the bf16 route's forward, chain and dW
    kernels over ``n_samples`` samples, from the scratch layout: the
    forward writes every activation block and raw; the chain reads raw's
    cotangent and the ReLU masks (the saved y, feat, a_nt .. a_1; on the
    wide route the mask words the forward writes, 8 B a sample a word of
    ``wide_mask_words``) and writes every cotangent block; dW reads every
    block once and writes its products."""
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    Hp, _, act_w, dlt_w = ftl._scratch_layout(model)
    nt = model.num_layers - 1
    ps, _ = mlp_macs(model)
    dw_macs = sum(n * m for u in ftl.dw_plan(model) for *_, n, m in u.blocks)
    words = 8 * ftl.wide_mask_words(Hp, nt) if fr.is_wide(model) else 0
    masks = words or 2 * (Hp // 2 + Hp + nt * Hp)
    return {
        "train_fwd_bf16_kernel": (n_samples * (2 * sum(act_w) + 16 + words), n_samples * ps),
        "train_chain_bf16_kernel": (n_samples * (16 + masks + 2 * sum(dlt_w)),
                                    n_samples * backward_macs(model)),
        "train_dw_bf16_kernel": (n_samples * 2 * (sum(act_w) + sum(dlt_w)) + 4 * dw_macs,
                                 n_samples * dw_macs),
    }


def bf16_parts(prof, owner, passes, library):
    """The bf16 route's forward (of ``owner``, the launcher's tag), chain
    and dW kernels: device ms per step from the profile ``prof`` (name ->
    ms), each beside its bound over ``passes`` ((model, samples) of the
    step's passes) and its products as torch.matmul (``library``: kernel
    name -> ms, where measured). Also the bytes and operations behind each
    bound, for a text line."""
    parts, sizes = [], {}
    for name in ("train_fwd_bf16_kernel", "train_chain_bf16_kernel", "train_dw_bf16_kernel"):
        nbytes_ = macs = 0
        for model, n in passes:
            b, m = bf16_part_bounds(model, n)[name]
            nbytes_, macs = nbytes_ + b, macs + m
        frag = f"{name}<{owner}," if name == "train_fwd_bf16_kernel" else name
        dev_ms = sum(v for k, v in prof.items() if frag in k.replace(" ", ""))
        b_ms, b_by = bound(2 * macs, nbytes_, BF16_FLOPS)
        parts.append({"name": name, "ms": dev_ms if prof else None, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library.get(name)})
        sizes[name] = f"{nbytes_ / 1e9:.4f} GB, {2 * macs / 1e12:.4f} TFLOP"
    return parts, sizes


def print_fwd_plan(label, model, shapes, scratch_samples, torch, dev):
    """The bf16 training forward's residency for ``model`` and its launches
    on each pass ((rays, samples) in ``shapes``): chunks of
    ``scratch_samples`` samples where it saves the activations (kernels 4
    and 3), one launch where it does not (kernel 2, ``scratch_samples``
    None); each launch as [64-row tiles, persistent CTAs]."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    save = scratch_samples is not None
    occ = ftl.bf16_occupancy(model)["forward" if save else "field_forward"]
    ctas = ftl.fwd_ctas(model, dev)

    def grid(rows):  # as launch_fwd in ops/csrc/fused_train_loss_bf16.cu
        tiles = 2 * -(-rows // 128) if save else -(-rows // 64)
        return [tiles, min(ctas, -(-tiles // 3))]

    plans = {}
    for name, (n, s) in shapes.items():
        chunk = max(1, min(n, scratch_samples // s)) if save else n
        plans[name] = [grid(min(chunk, n - r) * s) for r in range(0, n, chunk)]
    print(f"  {label} bf16 forward: {occ[0]} CTA(s) per SM, {occ[1]} B shared, {occ[2]} weight "
          f"ring stages, {occ[3]} staging tiles per consumer; launches [64-row tiles, CTAs]: "
          + json.dumps(plans))


def print_dw_plan(model, n, s, torch, dev):
    """The dW plan of one pass of ``n`` rays x ``s`` samples: its units,
    the chunks' stages and the CTAs' shares."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    plan = ftl.dw_plan(model)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = max(1, min(n, ftl.SCRATCH_SAMPLES // s))
    n_chunks = -(-n // chunk)
    n_st = [2 * -(-min(chunk, n - c * chunk) * s // 128) for c in range(n_chunks)]
    spans = ftl.dw_spans([u.cost for u in plan], n_st[0], grid)
    stages = [sum(j1 - j0 for _, _, j0, j1 in parts) for parts in spans]
    parts = ftl._cached_dw_parts(model, grid)
    args, smem = parts[0]
    print(f"  dW plan, {n} rays x {s} samples: {len(plan)} units in {len(parts)} launch(es) "
          f"[boxes A+B, output blocks, "
          f"bytes/sample]: " + json.dumps([[f"{len(u.a)}+{len(u.b)}", len(u.blocks), 16 * u.cost]
                                           for u in plan])
          + f"; {n_chunks} chunks of {n_st} stages of 64 samples; {grid} CTAs, each "
          f"{min(stages)}-{max(stages)} stages and {min(map(len, spans))}-"
          f"{max(map(len, spans))} unit parts; <= {args.max_pieces} slots a unit; ring "
          f"{args.n_stages} x {args.stage_bytes} B ({smem} B shared)")


def field_phase(torch, np, card, dev, tmp, sh):
    """Phase 9 (the field path, ``nerf.pallas_fused_loss: false``, through
    the CLI: kernels 2 and 3 at the config's default bf16, then at
    ``float32``), phase 10 (both routes of both kernels vs their plain
    versions on the batch ``sh`` of phase 7 with the run's models, the
    coarse pass S = 64 and the fine pass S = 128, with the cotangent of each
    pass's loss) and phase 13's part for them (times, bounds, the bf16 dW
    share as ``torch.matmul``, field-path steps and their profiles). Returns
    their kernels-line entries."""
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import composite, ray_dists
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    cfg_path, logdir, counts, losses, val, secs, peak = train_cli(
        tmp, sh.data, "lego-tpu-fields", SLICE_ITERS, torch, dev, pallas_fused_loss=False)
    print(f"phase 9: field path, {SLICE_ITERS} steps in {secs:.2f} s; launches "
          f"{json.dumps(counts)}; peak {peak:.2f} GiB; loss first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}; validation psnr {val}")
    n_b = 2 * SLICE_ITERS
    run_checks("field path", {
        f"{SLICE_ITERS} finite losses": len(losses) == SLICE_ITERS
        and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
        f"kernel 2's bf16 route launched {n_b} times, its f32 route never":
            counts["fused_mlp_bf16"] == n_b and counts["fused_mlp"] == n_b,
        f"kernel 3's bf16 route launched {n_b} times, its f32 route never":
            counts["fused_mlp_train_bf16"] == n_b and counts["fused_mlp_train"] == n_b,
        "kernel 4 not launched": counts["fused_train_loss"] == 0,
        "validation through kernel 1": counts["fused_render"] >= 2 and len(val) >= 1
        and bool(np.isfinite(val).all()),
    })
    # the f32 routes through the same entry point
    _, _, counts_f, losses_f, val_f, secs_f, _ = train_cli(
        tmp, sh.data, "lego-tpu-fields-f32", F32_TRAIN_ITERS, torch, dev,
        pallas_fused_loss=False, pallas_compute_dtype="float32")
    n_f = 2 * F32_TRAIN_ITERS
    print(f"phase 9: field path at pallas_compute_dtype float32, {F32_TRAIN_ITERS} steps in "
          f"{secs_f:.2f} s; launches {json.dumps(counts_f)}; loss first {losses_f[0]:.5f} "
          f"last {losses_f[-1]:.5f}")
    run_checks("field path at float32", {
        f"{F32_TRAIN_ITERS} finite losses": len(losses_f) == F32_TRAIN_ITERS
        and bool(np.isfinite(losses_f).all()),
        f"kernels 2 and 3's f32 routes launched {n_f} times each, their bf16 routes never":
            counts_f["fused_mlp"] == n_f and counts_f["fused_mlp_train"] == n_f
            and counts_f["fused_mlp_bf16"] == 0 and counts_f["fused_mlp_train_bf16"] == 0,
        "kernel 4 not launched": counts_f["fused_train_loss"] == 0,
        "validation through kernel 1's f32 route": counts_f["fused_render"] >= 2
        and counts_f["fused_render_bf16"] == 0 and bool(np.isfinite(val_f).all()),
    })
    _, coarse, fine, _ = run_models(cfg_path, logdir, SLICE_ITERS, dev)
    s, o, d, v, target, draws = sh.s_train, sh.o, sh.d, sh.v, sh.target, sh.draws
    kw = dict(log_sampling_xyz=s.log_sampling_xyz, log_sampling_dir=s.log_sampling_dir)
    bf = dict(compute_dtype=torch.bfloat16)
    bf2 = dict(bf, dw_dtype=torch.bfloat16)
    cases, err_fwd, err_bwd, err_fwd_b, err_bwd_b = {}, 0.0, 0.0, 0.0, 0.0
    z = sh.z_c
    for name, model, noise in (("coarse", coarse, draws.noise_coarse),
                               ("fine", fine, draws.noise_fine)):
        pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
        raw_plain = fm.fused_field_reference(model, pts, v, **kw).detach()
        leaf = raw_plain.clone().requires_grad_(True)
        out = composite(leaf, z, ray_dists(z, d), sigma_noise=noise)
        g = torch.autograd.grad(torch.mean((out.rgb - target) ** 2), leaf)[0].contiguous()
        raw = fm.fused_field(model, pts, v, **kw)
        grads = fmt._launch_backward(model, pts, v, g, **kw)
        torch.cuda.synchronize()
        want = fmt.field_grads_reference(model, pts, v, g, **kw)
        bad = []
        e_raw = float((raw - raw_plain).abs().max())
        if not bool(torch.isfinite(raw).all()) or bool(
                ((raw - raw_plain).abs() > ATOL + RTOL * raw_plain.abs()).any()):
            bad.append("raw")
        leaves = {}
        for (pname, _), gk, gp in zip(model.named_parameters(), grads, want):
            err, scale = float((gk - gp).abs().max()), float(gp.abs().max())
            leaves[pname] = (err, scale)
            err_bwd = max(err_bwd, err)
            if not bool(torch.isfinite(gk).all()) or err > GRAD_RTOL * scale:
                bad.append(pname)
        err_fwd = max(err_fwd, e_raw)
        raw_equal, grads_equal = f32_field_bits(model, pts, v, g, raw, grads, kw, torch)
        print(f"phase 10: {name} pass, {z.shape[0]} rays x {z.shape[1]} samples: kernel 2 raw "
              f"max abs err {e_raw:.3e} (rtol {RTOL:g}, atol {ATOL:g}); bit for bit: kernel 2's "
              f"raw and kernel 3's forward's {raw_equal}, two kernel-3 calls {grads_equal}; "
              "kernel 3:")
        print_leaves(leaves)
        if not (raw_equal and grads_equal):
            bad.append("bitwise equality")
        if bad:
            raise AssertionError(f"{name} pass: field kernels and plain differ in {bad}")
        # the bf16 routes, on the same cotangent, relative to the dtype's own effect
        names = [n for n, _ in model.named_parameters()]
        raw_b = fm.fused_field(model, pts, v, **kw, **bf)
        grads_b = fmt._launch_backward(model, pts, v, g, **kw, **bf2)
        torch.cuda.synchronize()
        plain_b = {"raw": fm.fused_field_reference(model, pts, v, **kw, **bf).detach(),
                   **dict(zip(names, fmt.field_grads_reference(model, pts, v, g, **kw, **bf2)))}
        errs = hold_to_own(
            f"phase 10: {name} pass, bf16 routes of kernels 2 (raw) and 3 (leaves) vs plain,",
            {"raw": raw_b, **dict(zip(names, grads_b))}, plain_b,
            {"raw": raw_plain, **dict(zip(names, want))}, torch)
        err_fwd_b = max(err_fwd_b, errs.pop("raw"))
        err_bwd_b = max(err_bwd_b, *errs.values())
        cases[name] = (model, pts, g)
        if name == "coarse":
            z, _ = hierarchical_z_vals(z, out.weights.detach(), s.num_fine, det=False,
                                       u=draws.u_fine)

    # ---- phase 13, kernels 2 and 3: times, bounds
    ms = {f"{k}{t}": 0.0 for k in ("fwd_kernel", "fwd_plain", "bwd_kernel", "bwd_plain")
          for t in ("", "_bf16")}
    fwd_flops = bwd_flops = fwd_bytes = bwd_bytes = fwd_bytes_b = bwd_bytes_b = 0.0
    for model, pts, g in cases.values():
        n, s_ = pts.shape[:2]
        ps, pr = mlp_macs(model)
        fwd_flops += 2 * (n * s_ * ps + n * pr)
        bwd_flops += train_flops(model, n, s_)
        params = list(model.parameters())
        # the bf16 routes read the bf16 packs and the f32 heads instead of the weights
        packs = nbytes(*ftl._cached_bf16_weights(model, dev)[:2])
        fwd_bytes += nbytes(pts, v, *params) + n * s_ * 4 * 4
        fwd_bytes_b += nbytes(pts, v) + packs + n * s_ * 4 * 4
        bwd_bytes += nbytes(pts, v, g) + 2 * nbytes(*params)
        bwd_bytes_b += nbytes(pts, v, g, *params) + packs + nbytes(
            ftl.pack_backward_weights_bf16(model, dev))
        for tag, dt in (("", {}), ("_bf16", bf)):
            with torch.no_grad():
                ms[f"fwd_kernel{tag}"] += timed_ms(
                    lambda: fm.fused_field(model, pts, v, **kw, **dt), torch)
                ms[f"fwd_plain{tag}"] += timed_ms(
                    lambda: fm.fused_field_reference(model, pts, v, **kw, **dt), torch)
            dt2 = dict(dt, dw_dtype=dt["compute_dtype"]) if dt else {}
            ms[f"bwd_kernel{tag}"] += timed_ms(
                lambda: fmt._launch_backward(model, pts, v, g, **kw, **dt2), torch)
            ms[f"bwd_plain{tag}"] += timed_ms(
                lambda: fmt.field_grads_reference(model, pts, v, g, **kw, **dt2), torch)
    # library yardsticks of kernel 3's routes: their weight-gradient
    # products of both passes as torch.matmul calls
    dw_yardsticks(ms, [(m, p.shape[0] * p.shape[1]) for m, p, _ in cases.values()], torch, dev)
    # and their f32 passes' layer products (kernel 2: the forward; kernel 3:
    # the forward again and the chain)
    k3_passes = [(m, p.shape[0] * p.shape[1]) for m, p, _ in cases.values()]
    pass_yardsticks(ms, "k3", k3_passes, torch, dev)
    pass_yardsticks(ms, "k3", k3_passes, torch, dev, torch.bfloat16)
    # the f32 routes in split TF32: three TF32 products a multiply-add; the
    # f32 FMA bounds beside them
    fwd_bound, fwd_by = bound(3 * fwd_flops, fwd_bytes, TF32_FLOPS)
    bwd_bound, bwd_by = bound(3 * bwd_flops, bwd_bytes, TF32_FLOPS)
    fwd_fma, _ = bound(fwd_flops, fwd_bytes)
    bwd_fma, _ = bound(bwd_flops, bwd_bytes)
    fwd_bound_b, fwd_by_b = bound(fwd_flops, fwd_bytes_b, BF16_FLOPS)
    bwd_bound_b, bwd_by_b = bound(bwd_flops, bwd_bytes_b, BF16_FLOPS)
    print(f"phase 13: kernels 2 and 3, both passes, both routes, ms on {card} (CUDA events, "
          f"mean of 3): " + json.dumps({k: round(t, 3) for k, t in ms.items()}))
    print(f"  kernel 2 bound {fwd_bound:.3f} ms f32 route ({fwd_by}"
          f"{SPLIT_TF32 if fwd_by == 'operations' else ''}; {fwd_flops / 1e12:.4f} TFLOP, "
          f"{fwd_bytes / 1e6:.2f} MB), {fwd_fma:.3f} ms at the f32 FMA peak, bf16 route "
          f"{fwd_bound_b:.3f} ms ({fwd_by_b}; {fwd_bytes_b / 1e6:.2f} MB); kernel 3 bound "
          f"{bwd_bound:.3f} ms f32 route ({bwd_by}; {bwd_flops / 1e12:.4f} TFLOP, "
          f"{bwd_bytes / 1e6:.2f} MB), {bwd_fma:.3f} ms at the f32 FMA peak, bf16 route "
          f"{bwd_bound_b:.3f} ms ({bwd_by_b}; {bwd_bytes_b / 1e6:.2f} MB); achieved TFLOP/s: "
          + json.dumps({k: round(f / ms[m] / 1e9, 2) for k, f, m in (
              ("kernel 2 f32", fwd_flops, "fwd_kernel"),
              ("kernel 2 bf16", fwd_flops, "fwd_kernel_bf16"),
              ("kernel 3 f32", bwd_flops, "bwd_kernel"),
              ("kernel 3 bf16", bwd_flops, "bwd_kernel_bf16"))}))
    batch = sh.o.shape[0]
    steps, st_ms, peaks = {}, {}, {}
    for path in ("fields_bf16", "fields"):
        torch.cuda.reset_peak_memory_stats()
        st_ms[path], steps[path] = sh.step_ms(path)
        peaks[path] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    print(f"  field-path steps, ms (host clock around synchronize, mean of 5): "
          + json.dumps({k: round(t, 3) for k, t in st_ms.items()}) + "; rays/s: "
          + json.dumps({k: round(batch / (t / 1e3)) for k, t in st_ms.items()})
          + "; peak memory of a step (GiB): " + json.dumps(peaks))
    print("  bf16 field-path steps:")
    prof = profile_steps(torch, steps["fields_bf16"], {
        "kernel 2 bf16": FIELD_FWD_BF16_NAMES, "kernel 3 bf16": FIELD_BWD_BF16_NAMES})
    parts, sizes = bf16_parts(prof, 3, k3_passes, bf16_library(ms, "k3"))
    print("  kernel 3's bf16 kernels, device ms per step (profile) beside their bounds: "
          + json.dumps(parts))
    fwd2 = sum(t for k, t in prof.items() if "train_fwd_bf16_kernel<2," in k.replace(" ", ""))
    prep2 = sum(t for k, t in prof.items() if "train_prep_kernel<2>" in k.replace(" ", ""))
    parts2 = [{"name": "train_fwd_bf16_kernel", "ms": fwd2 if prof else None,
               "bound_ms": fwd_bound_b, "bound_by": fwd_by_b,
               "library_ms": ms["k3_forward_torch_matmul_bf16"]}]
    print(f"  kernel 2's bf16 route, device ms per step (profile): forward {fwd2:.3f}, prep "
          f"{prep2:.3f}, beside the route's bound {fwd_bound_b:.3f} ({fwd_by_b})")
    shapes = {k: tuple(p.shape[:2]) for k, (_, p, _) in cases.items()}
    print_fwd_plan("kernel 2", cases["fine"][0], shapes, None, torch, dev)
    print_fwd_plan("kernel 3", cases["fine"][0], shapes, fmt.SCRATCH_SAMPLES, torch, dev)
    print("  bytes and operations behind those bounds (scratch layout, this run's shapes): "
          + json.dumps(sizes))
    print("  f32 field-path steps (pallas_compute_dtype: float32):")
    # kernel 4's split-TF32 kernels with the launchers' tags; kernel 3 also runs
    # kernel 4's dW and reduce launches
    prof_f = profile_steps(torch, steps["fields"], {
        "kernel 2": FIELD_FWD_F32_NAMES,
        "kernel 3": (*FIELD_BWD_F32_NAMES, "dw_tf32_kernel", "dw_tf32_reduce_kernel"),
    })
    shapes_f = [(m, *p.shape[:2]) for m, p, _ in cases.values()]
    parts2_f = f32_pass_parts(prof_f, shapes_f, ms, "k3", owner=2)
    parts3_f = f32_pass_parts(prof_f, shapes_f, ms, "k3", owner=3)
    dw_f32 = f32_dw_share(prof_f, ms["dw_torch_matmul_f32"], shapes_f)
    entry = dict(route="cuda", source="dexnerf_tpu_torch/ops/csrc/fused_train_loss_bf16.cu")
    entry_f = dict(route="cuda", source="dexnerf_tpu_torch/ops/csrc/fused_train_loss.cu")
    fwd, bwd = ("dexnerf_tpu/ops/fused_mlp.py:481", "dexnerf_tpu/ops/fused_mlp_train.py:221")
    split = SPLIT_TF32 if fwd_by == "operations" else ""
    return [
        {"name": "fused_field", **entry_f, "replaces": fwd,
         "launches": counts_f["fused_mlp"], "max_abs_err": err_fwd, "ms": ms["fwd_kernel"],
         "plain_ms": ms["fwd_plain"], "bound_ms": fwd_bound, "bound_by": fwd_by + split,
         "library_ms": ms["k3_forward_torch_matmul_f32"], "parts": parts2_f},
        {"name": "fused_field_backward", **entry_f, "replaces": bwd,
         "launches": counts_f["fused_mlp_train"], "max_abs_err": err_bwd,
         "ms": ms["bwd_kernel"], "plain_ms": ms["bwd_plain"], "bound_ms": bwd_bound,
         "bound_by": bwd_by + (SPLIT_TF32 if bwd_by == "operations" else ""),
         "library_ms": ms["dw_torch_matmul_f32"]
         + ms["k3_forward_torch_matmul_f32"] + ms["k3_chain_torch_matmul_f32"],
         "parts": parts3_f + dw_f32},
        {"name": "fused_mlp_bf16", **entry, "replaces": fwd,
         "launches": counts["fused_mlp_bf16"], "max_abs_err": err_fwd_b,
         "ms": ms["fwd_kernel_bf16"], "plain_ms": ms["fwd_plain_bf16"],
         "bound_ms": fwd_bound_b, "bound_by": fwd_by_b,
         "library_ms": ms["k3_forward_torch_matmul_bf16"], "parts": parts2},
        {"name": "fused_mlp_train_bf16", **entry, "replaces": bwd,
         "launches": counts["fused_mlp_train_bf16"], "max_abs_err": err_bwd_b,
         "ms": ms["bwd_kernel_bf16"], "plain_ms": ms["bwd_plain_bf16"],
         "bound_ms": bwd_bound_b, "bound_by": bwd_by_b,
         "library_ms": sum(bf16_library(ms, "k3").values()), "parts": parts},
    ]


def share_within(got, want, atol, torch):
    """(share of entries within atol, worst abs error)."""
    err = (got - want).abs()
    return float((err <= atol).float().mean()), float(err.max())


def resample_phase(torch, np, card, dev, tmp, sh):
    """Phase 11 (the fused loss with ``nerf.pallas_loss_resample: pallas``
    through the CLI: kernel 5 between the passes of kernel 4), phase 12
    (kernels 5 and 6 vs plain on the coarse weights of the batch ``sh`` of
    phase 7 under the run's coarse model, with a zero-weight and a
    near-delta ray, on the batch's draws and on the deterministic grid;
    kernel 6 driven through its public op) and phase 13's part for them.
    Returns their kernels-line entries."""
    from dexnerf_tpu_torch.core.sampling import linspace
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops import resample as rs
    from dexnerf_tpu_torch.ops import sample_pdf as spdf

    cfg_path, logdir, counts, losses, val, secs, _ = train_cli(
        tmp, sh.data, "lego-tpu-resample", SLICE_ITERS, torch, dev,
        pallas_loss_resample="pallas")
    print(f"phase 11: resample path, {SLICE_ITERS} steps in {secs:.2f} s; launches "
          f"{json.dumps(counts)}; loss first {losses[0]:.5f} last {losses[-1]:.5f}; "
          f"validation psnr {val}")
    run_checks("resample path", {
        f"{SLICE_ITERS} finite losses": len(losses) == SLICE_ITERS
        and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
        f"kernel 5 launched {SLICE_ITERS} times": counts["resample"] == SLICE_ITERS,
        f"kernel 4 launched {2 * SLICE_ITERS} times":
            counts["fused_train_loss"] == 2 * SLICE_ITERS,
    })
    _, coarse, _, _ = run_models(cfg_path, logdir, SLICE_ITERS, dev)
    s, o, d, v, target, z_c, draws = (sh.s_train, sh.o, sh.d, sh.v, sh.target, sh.z_c,
                                      sh.draws)
    n = z_c.shape[0]
    with torch.no_grad():
        w = ftl.fused_pass_loss_reference(coarse, o, d, z_c, v, ray_dists(z_c, d),
                                          draws.noise_coarse, target)[1].clone()
    w[0] = 0.0  # no mass: the +1e-5 guard
    w[1] = 0.0
    w[1, 5] = 100.0  # near-delta
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    grid = linspace(0.0, 1.0, s.num_fine, device=z_c.device).expand(n, s.num_fine).contiguous()
    bins = (0.5 * (z_c[:, 1:] + z_c[:, :-1])).contiguous()
    w_mid = w[:, 1:-1].contiguous()

    # kernel 6 through its public op: the drop-in of core.sampling.sample_pdf
    spdf.launches = 0
    pdf_out = {"draws": spdf.sample_pdf_branchless(bins, w_mid, s.num_fine, det=False,
                                                   u=draws.u_fine),
               "det grid": spdf.sample_pdf_branchless(bins, w_mid, s.num_fine, det=True)}
    pdf_launches = spdf.launches
    # each output against a float64 run of the plain version: the kernel's
    # share within the tolerances must reach the f32 plain version's own
    # (less RESAMPLE_SLACK); the share against the f32 plain version is printed
    f64 = [t.double() for t in (z_c, w, dn, bins, w_mid)]
    bad, lines, err5, err6 = [], {}, 0.0, 0.0
    for case, u in (("draws", draws.u_fine), ("det grid", grid)):
        zm, dd = rs.fused_resample(z_c, w, u, dn)
        torch.cuda.synchronize()
        plain = {"z": rs.fused_resample_reference(z_c, w, u, dn)}
        exact = {"z": rs.fused_resample_reference(f64[0], f64[1], u.double(), f64[2])}
        plain["pdf"] = spdf.sample_pdf_reference(bins, w_mid, u)
        exact["pdf"] = spdf.sample_pdf_reference(f64[3], f64[4], u.double())
        line = {}
        for key, got, want, want64, atol in (
            ("z", zm, plain["z"][0], exact["z"][0], RESAMPLE_Z_ATOL),
            # the last interval is 1e10 |d|, rounded to f32 on both sides
            ("dists", dd[:, :-1], plain["z"][1][:, :-1], exact["z"][1][:, :-1],
             RESAMPLE_D_ATOL),
            ("sample_pdf", pdf_out[case], plain["pdf"], exact["pdf"], PDF_ATOL),
        ):
            share, worst = share_within(got, want, atol, torch)
            share64, _ = share_within(got.double(), want64, atol, torch)
            plain64, _ = share_within(want.double(), want64, atol, torch)
            line[key] = {"vs plain": [share, worst], "kernel vs f64": share64,
                         "plain vs f64": plain64}
            if key == "sample_pdf":
                err6 = max(err6, worst)
            else:
                err5 = max(err5, worst)
            if share64 < plain64 - RESAMPLE_SLACK or not bool(torch.isfinite(got).all()):
                bad.append(f"{case} {key}")
        if not bool((zm[:, 1:] >= zm[:, :-1]).all()):
            bad.append(f"{case} z unsorted")
        lines[case] = line
    print(f"phase 12: kernels 5 and 6 vs plain, {n} rays x ({s.num_coarse} + {s.num_fine}): "
          f"shares within z {RESAMPLE_Z_ATOL:g} / dists {RESAMPLE_D_ATOL:g} / sample_pdf "
          f"{PDF_ATOL:g} ([share, worst abs err] vs the f32 plain version; kernel and f32 "
          f"plain vs a float64 plain run, slack {RESAMPLE_SLACK:g}): " + json.dumps(lines))
    print(f"  kernel 6 through sample_pdf_branchless: {pdf_launches} launches")
    if bad or pdf_launches != 2:
        raise AssertionError(f"kernels 5/6 and plain differ: {bad}, {pdf_launches} launches")

    u = draws.u_fine
    ms = {
        "resample_kernel": timed_ms(lambda: rs.fused_resample(z_c, w, u, dn), torch),
        "resample_plain": timed_ms(lambda: rs.fused_resample_reference(z_c, w, u, dn), torch),
        "sample_pdf_kernel": timed_ms(lambda: spdf.sample_pdf_pallas(bins, w_mid, u), torch),
        "sample_pdf_plain": timed_ms(lambda: spdf.sample_pdf_reference(bins, w_mid, u), torch),
        # context only, parts of the two functions (no single call computes either)
        "torch_searchsorted": timed_ms(lambda: torch.searchsorted(bins, u, right=True), torch),
        "torch_sort": timed_ms(lambda: torch.sort(torch.cat([z_c, u], -1), -1), torch),
    }
    # device time alone (the CUDA events above include the host gaps between
    # calls), at the batch and at BIG_RAYS (the batch 8 times over), the
    # context calls likewise (every device event of a call)
    reps = BIG_RAYS // n
    big = [t.repeat(reps, 1) for t in (z_c, w, u, dn, bins, w_mid)]
    for tag, (zc_, w_, u_, dn_, bins_, wm_) in (("", (z_c, w, u, dn, bins, w_mid)),
                                                (f"_{BIG_RAYS}", big)):
        dev_ms = device_ms(torch, {
            "resample_kernel": lambda: rs.fused_resample(zc_, w_, u_, dn_),
            "sample_pdf_kernel": lambda: spdf.sample_pdf_pallas(bins_, wm_, u_)})
        ms["resample_device" + tag] = dev_ms["resample_kernel"]
        ms["sample_pdf_device" + tag] = dev_ms["sample_pdf_kernel"]
        ms["torch_searchsorted_device" + tag] = device_all_ms(
            torch, lambda: torch.searchsorted(bins_, u_, right=True))
        ms["torch_sort_device" + tag] = device_all_ms(
            torch, lambda: torch.sort(torch.cat([zc_, u_], -1), -1))
    sc, sf = s.num_coarse, s.num_fine
    m = sc - 2

    def lg(k):  # ceil(log2 k)
        return (k - 1).bit_length()

    # operations of the kernels' algorithm: the CDF (add, divide, a 5-level
    # scan a weight), a binary search and a lerp a draw; kernel 5 also the
    # midpoints, the bitonic sort of the fine depths (min and max a pair a
    # stage), a binary search a merged depth and the intervals
    pdf_ops = 7 * m + sf * (lg(m + 2) + 6)
    ns = 32 * (1 << lg(-(-sf // 32)))
    rs_ops = (pdf_ops + 2 * sc + ns * lg(ns) * (lg(ns) + 1) // 2
              + sc * lg(sf + 1) + sf * lg(sc + 1) + 2 * (sc + sf))
    bounds = {}
    for tag, (zc_, w_, u_, dn_, bins_, wm_) in (("", (z_c, w, u, dn, bins, w_mid)),
                                                (f"_{BIG_RAYS}", big)):
        rays = zc_.shape[0]
        bounds["resample" + tag] = bound(rays * rs_ops,
                                         nbytes(zc_, w_, u_, dn_) + 2 * 4 * rays * (sc + sf))
        bounds["sample_pdf" + tag] = bound(rays * pdf_ops, nbytes(bins_, wm_, u_) + 4 * rays * sf)
    print(f"phase 13: kernels 5 and 6, ms on {card} (CUDA events, mean of 3; *_device: "
          f"torch.profiler device time per call, mean of 3; _{BIG_RAYS}: {BIG_RAYS} rays): "
          + json.dumps({k: None if t is None else round(t, 5) for k, t in ms.items()}))
    for tag in ("", f"_{BIG_RAYS}"):
        share = {k: None if ms[f"{k}_device{tag}"] is None
                 else round(bounds[k + tag][0] / ms[f"{k}_device{tag}"], 3)
                 for k in ("resample", "sample_pdf")}
        print(f"  at {reps * n if tag else n} rays: kernel 5 bound "
              f"{1e3 * bounds['resample' + tag][0]:.3f} us ({bounds['resample' + tag][1]}), "
              f"kernel 6 bound {1e3 * bounds['sample_pdf' + tag][0]:.3f} us "
              f"({bounds['sample_pdf' + tag][1]}); share of bound by device time "
              + json.dumps(share))
    entry = dict(route="cuda", source="dexnerf_tpu_torch/ops/csrc/resample.cu", library_ms=None)
    return [
        {"name": "fused_resample", **entry, "replaces": "dexnerf_tpu/ops/resample_pallas.py:119",
         "launches": counts["resample"], "max_abs_err": err5, "ms": ms["resample_kernel"],
         "device_ms": ms["resample_device"],
         f"device_ms_{BIG_RAYS}": ms[f"resample_device_{BIG_RAYS}"],
         "plain_ms": ms["resample_plain"], "bound_ms": bounds["resample"][0],
         "bound_by": bounds["resample"][1],
         f"bound_ms_{BIG_RAYS}": bounds[f"resample_{BIG_RAYS}"][0]},
        {"name": "sample_pdf", **entry, "replaces": "dexnerf_tpu/ops/sample_pdf_pallas.py:37",
         "launches": pdf_launches, "max_abs_err": err6, "ms": ms["sample_pdf_kernel"],
         "device_ms": ms["sample_pdf_device"],
         f"device_ms_{BIG_RAYS}": ms[f"sample_pdf_device_{BIG_RAYS}"],
         "plain_ms": ms["sample_pdf_plain"], "bound_ms": bounds["sample_pdf"][0],
         "bound_by": bounds["sample_pdf"][1],
         f"bound_ms_{BIG_RAYS}": bounds[f"sample_pdf_{BIG_RAYS}"][0]},
    ]


def hold_train_bf16(label, phase, models, store, s_train, lr, batch, norm, loss_kw, torch, dev,
                    extra_of=None):
    """Kernel 4's bf16 route on a seeded batch of ``batch`` rays of
    ``store``: both passes of ``models`` (coarse, fine; the fine depths from the coarse plain
    weights) held to the plain versions by :func:`check_train_bf16` (the
    loss over ``norm``; ``loss_kw`` the supervision and depth-loss settings
    of ``make_fused_train_loss`` / ``make_train_step``; ``extra_of(idx)``
    the pass's extra arguments, the GT depths and their coefficients);
    both passes timed (CUDA events, mean of 3) beside their plain versions,
    the dW ``torch.matmul`` yardstick and their bound; a step on copies of
    the models timed on the host clock (mean of 5) and profiled. Returns a
    namespace of ``ms``, ``worst``, ``bound_ms``, ``bound_by``, ``flops``,
    ``bytes``, ``parts``, ``sizes`` and ``per_pass``."""
    import copy

    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.pipeline import take_ray_batch
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.render.renderer import draw_render_noise, jittered_z_vals
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

    coarse, fine = models
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, store.num_rays, (batch,), generator=gen, device=dev)
    rays, target = take_ray_batch(store, idx)
    print(f"{label}, {batch} rays, both passes:")
    extra = tuple(extra_of(idx)) if extra_of is not None else ()
    draws = draw_render_noise(batch, s_train, gen, dev)
    o, d, v = (t.contiguous() for t in rays[:3])
    target = target.contiguous()
    kw = dict(supervision=loss_kw.get("supervision", "rgb"),
              white_background=s_train.white_background)
    z_c = jittered_z_vals(rays, s_train, draws)
    passes = {"coarse": (coarse, z_c, draws.noise_coarse)}
    per_pass, worst = {}, 0.0
    for name in ("coarse", "fine"):
        model, z, noise = passes[name]
        args = (model, o, d, z, v, ray_dists(z, d), noise, target, *extra)
        want = ftl.fused_pass_loss_reference(*args, **kw)
        worst = max(worst, check_train_bf16(name, model, args, norm, want, torch, phase=phase,
                                            **kw))
        per_pass[name] = args
        if name == "coarse":
            z_f, _ = hierarchical_z_vals(z_c, want[1], s_train.num_fine, det=False, u=draws.u_fine)
            passes["fine"] = (fine, z_f, draws.noise_fine)
    ms, gemms = {}, []
    bf = dict(kw, compute_dtype=torch.bfloat16, dw_dtype=torch.bfloat16)
    for name, args in per_pass.items():
        ms[f"{name}_kernel"] = timed_ms(lambda: ftl.fused_pass_loss(*args, **bf), torch)
        ms[f"{name}_plain"] = timed_ms(lambda: ftl.fused_pass_loss_reference(*args, **bf), torch)
        gemms += dw_gemm_operands(args[0], args[3].numel(), torch, dev, torch.bfloat16)
    ms["dw_torch_matmul"] = timed_ms(lambda: [torch.matmul(a.t(), b) for a, b in gemms], torch)
    del gemms
    flops, _, byts_b, _ = kernel4_sizes(per_pass, dev)
    bound_ms, bound_by = bound(flops, byts_b, BF16_FLOPS)
    st = init_train_state(copy.deepcopy(coarse), copy.deepcopy(fine), lr)
    fused = ftl.make_fused_train_loss(st.coarse, st.fine, s_train, compute_dtype=torch.bfloat16,
                                      dw_dtype=torch.bfloat16, **loss_kw)
    step = make_train_step(s_train, batch, fused_loss=fused, **loss_kw)
    ms["step"] = host_ms(torch, lambda: step(st, store, gen), n=5)
    metrics = step(st, store, gen)
    if not all(bool(torch.isfinite(t)) for t in metrics.values()):
        raise AssertionError(f"phase {phase}: non-finite step metrics {metrics}")
    print("  steps:")
    prof = profile_steps(torch, lambda: step(st, store, gen),
                         {"kernel 4 bf16": KERNEL4_BF16_NAMES})
    parts, sizes = bf16_parts(prof, 4, [(a[0], a[3].numel()) for a in per_pass.values()],
                              {"train_dw_bf16_kernel": ms["dw_torch_matmul"]})
    return types.SimpleNamespace(ms=ms, worst=worst, bound_ms=bound_ms, bound_by=bound_by,
                                 flops=flops, bytes=byts_b, parts=parts, sizes=sizes,
                                 per_pass=per_pass)


def train_entry(name, launches, k4):
    """A kernels-line entry of kernel 4's bf16 route from :func:`hold_train_bf16`."""
    return {
        "name": name, "route": "cuda",
        "source": "dexnerf_tpu_torch/ops/csrc/fused_train_loss_bf16.cu",
        "replaces": "dexnerf_tpu/ops/fused_train_loss.py:99", "launches": launches,
        "max_abs_err": k4.worst, "ms": k4.ms["coarse_kernel"] + k4.ms["fine_kernel"],
        "plain_ms": k4.ms["coarse_plain"] + k4.ms["fine_plain"], "bound_ms": k4.bound_ms,
        "bound_by": k4.bound_by, "library_ms": k4.ms["dw_torch_matmul"], "parts": k4.parts,
    }


def dex_phase(torch, np, card, dev, tmp):
    """Phase 14, Dex-NeRF on messytable: write a synthetic messytable scene
    (stored 540x960, loaded at the real scene's 270x480) with the port's
    writer, train ``configs/messytable-obj.yml`` on it through
    ``apps.train --ir --dex --depth-loss --depth-warmup`` (kernel 4's bf16
    route with its luminance and depth terms; validation through kernel
    1's bf16 route at T = 20) and check the launches, the warmup, the
    validation's depth metrics and artifacts; hold kernel 4's bf16 route
    with both terms on to its plain version on one batch of the run, both
    passes; time both passes, a depth-supervised step (host clock and
    profile) and the validation frame (kernel 1 held to its plain versions
    there on the run's weights with σ heads calibrated as in phase 3).
    Returns the two kernels-line entries of this path, the run's config
    and its log directory."""
    import copy

    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_w2c
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_depth
    from dexnerf_tpu_torch.data.synthetic import write_messytable_dataset
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.render.renderer import make_ray_batch, render_image
    from dexnerf_tpu_torch.train.logging import load_depth_png_mm
    from dexnerf_tpu_torch.train.loop import load_scene, validate

    # ---- the entry point: 20 steps, the depth term from step DEX_WARMUP
    t0 = time.perf_counter()
    data = os.path.join(tmp, "messytable")
    write_messytable_dataset(data, *DEX_STORED_HW, DEX_VIEWS, device=dev)
    dataset_s = time.perf_counter() - t0
    cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb = train_cli(
        tmp, data, "messytable-dex", DEX_ITERS, torch, dev, config=CONFIG,
        dataset={"depth_valid_max": DEX_VALID_MAX},
        flags=["--ir", "--dex", "--depth-loss", str(DEX_WEIGHT), "--depth-warmup",
               str(DEX_WARMUP)],
        use_pallas=True)
    cfg = load_config(cfg_path)
    thresholds = tuple(render_settings_from_cfg(cfg, "validation", dex=True).m_thres_cand)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    tags = {r["tag"] for r in recs}
    depth_loss = {r["step"]: r["value"] for r in recs if r["tag"] == "train/depth_loss"}
    val_depth = {r["tag"]: r["value"] for r in recs if r["tag"] in DEX_VAL_TAGS}
    png = os.path.join(logdir, "pred_depth", f"pred_depth_step_{DEX_ITERS - 1}.png")
    depth_png = load_depth_png_mm(png) if os.path.exists(png) else None
    out_hw = (DEX_STORED_HW[0] // 2, DEX_STORED_HW[1] // 2)
    print(f"phase 14: messytable-obj ({out_hw[0]}x{out_hw[1]}, {DEX_VIEWS[0]} train views, "
          f"written in {dataset_s:.2f} s), "
          f"--ir --dex --depth-loss {DEX_WEIGHT} --depth-warmup {DEX_WARMUP}: {DEX_ITERS} steps "
          f"in {secs:.2f} s; launches {json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; depth_loss "
          + json.dumps({k: round(v, 6) for k, v in sorted(depth_loss.items())})
          + f"; validation psnr {val_psnr}, last depth metrics {json.dumps(val_depth)}")
    n_val = len(val_psnr)
    run_checks("Dex-NeRF on messytable", {
        f"kernel 4's bf16 route launched {2 * DEX_ITERS} times, its f32 route never":
            counts["fused_train_loss_bf16"] == 2 * DEX_ITERS
            and counts["fused_train_loss"] == counts["fused_train_loss_bf16"],
        # the loop validates at iteration 0 and at the last (as the JAX loop)
        "validations at steps 0 and last, each 2 launches of kernel 1's bf16 route":
            n_val == 2 and counts["fused_render_bf16"] == 2 * n_val == counts["fused_render"],
        f"{DEX_ITERS} finite losses": len(losses) == DEX_ITERS
        and bool(np.isfinite(losses).all()),
        f"train/depth_loss absent before step {DEX_WARMUP}, finite from it":
            sorted(depth_loss) == list(range(DEX_WARMUP, DEX_ITERS))
            and bool(np.isfinite(list(depth_loss.values())).all()),
        "validation/{depth_abs_err,depth_err4,min_abs_err,err4} logged, finite":
            set(val_depth) == set(DEX_VAL_TAGS)
            and bool(np.isfinite(list(val_depth.values())).all()),
        f"{len(thresholds)} depth_pred_<m> images, depth_pred_err, depth_gt":
            len(thresholds) == 20
            and all(f"validation/depth_pred_{int(m)}" in tags for m in thresholds)
            and {"validation/depth_pred_err", "validation/depth_gt"} <= tags,
        f"pred_depth PNG reads back at {out_hw[0]}x{out_hw[1]}": depth_png is not None
        and depth_png.shape == out_hw and bool(np.isfinite(depth_png).all()),
    })

    # ---- kernel 4's bf16 route with luminance + depth vs plain, one batch of the run
    cfg, coarse, fine, _ = run_models(cfg_path, logdir, DEX_ITERS, dev)
    scene = load_scene(cfg)
    s_train = render_settings_from_cfg(cfg, "train")
    batch = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    tr = scene.i_train
    store = build_ray_store(scene.images[tr], scene.poses[tr], scene.hwf, near, far, device=dev,
                            intrinsics=scene.intrinsics[tr], depths=scene.depths[tr])
    norm = float(batch)  # luminance: one channel a ray

    def depth_args(idx):
        depth_gt = take_depth(store, idx).contiguous()
        mask = ((depth_gt > 0) & (depth_gt < DEX_VALID_MAX)).to(torch.float32)
        print(f"  {int(mask.sum())} of the {batch} rays with valid GT depth")
        return depth_gt, (norm * DEX_WEIGHT / torch.clamp(mask.sum(), min=1.0)) * mask

    k4 = hold_train_bf16(
        "phase 14: kernel 4 bf16 route, luminance + depth", 14, (coarse, fine), store, s_train,
        float(cfg.optimizer.lr), batch, norm,
        dict(supervision="luminance", depth_loss_weight=DEX_WEIGHT, depth_valid_max=DEX_VALID_MAX),
        torch, dev, extra_of=depth_args)
    print_fwd_plan("kernel 4 (messytable)", fine,
                   {k: tuple(a[3].shape) for k, a in k4.per_pass.items()}, ftl.SCRATCH_SAMPLES,
                   torch, dev)
    print_dw_plan(fine, *k4.per_pass["fine"][3].shape, torch, dev)
    ms = k4.ms

    # ---- the validation frame: kernel 1's bf16 route at T = 20 vs its plain versions
    s_val = render_settings_from_cfg(cfg, "validation", dex=True).eval_variant()
    H, W = int(scene.hwf[0]), int(scene.hwf[1])
    vi = int(scene.i_val[0])
    ro, rd = get_ray_bundle_w2c(H, W, torch.as_tensor(scene.poses[vi], device=dev),
                                torch.as_tensor(scene.intrinsics[vi], device=dev))
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    vrays = make_ray_batch(ro, rd, near, far)
    calibrate_on((vc, vf), vrays, s_val, torch)
    err_r, ms_r, render_bound, render_bound_by = hold_frame(
        f"phase 14: validation frame {H}x{W}", vc, vf, vrays, s_val, torch)
    ms.update({f"frame_{k}": t for k, t in ms_r.items()})
    impl = fr.make_fused_render_rays(vc, vf, s_val, compute_dtype=torch.bfloat16)
    with torch.inference_mode():
        ms["frame"] = timed_ms(
            lambda: render_image(vc, vf, ro, rd, near, far, s_val, rays_impl=impl), torch)
        profile_steps(torch, lambda: render_image(vc, vf, ro, rd, near, far, s_val,
                                                  rays_impl=impl),
                      {"kernel 1 bf16": ("fused_render_bf16_kernel",)}, unit="frame")
    t0 = time.perf_counter()
    val = validate(coarse, fine, scene, cfg, supervision="luminance", device=dev, dex=True)
    torch.cuda.synchronize()
    ms["validate"] = 1e3 * (time.perf_counter() - t0)
    print(f"phase 14: ms on {card} (passes and frame: CUDA events, mean of 3; step: host clock "
          f"around synchronize, mean of 5; validate: host clock, one call on the run's "
          f"weights, best threshold {val.get('best_threshold')}): "
          + json.dumps({k: round(t, 3) for k, t in ms.items()}))
    print(f"  kernel 4 bound for both passes {k4.bound_ms:.3f} ms ({k4.bound_by}; "
          f"{k4.flops / 1e12:.4f} TFLOP, {k4.bytes / 1e6:.2f} MB); its kernels, device ms per "
          f"step (profile) beside their bounds: " + json.dumps(k4.parts) + "; sizes "
          + json.dumps(k4.sizes))
    print(f"  rays/s per step {round(batch / (ms['step'] / 1e3))}")
    return cfg_path, logdir, [
        train_entry("fused_train_loss_bf16@messytable-dex", counts["fused_train_loss_bf16"], k4),
        render_entry("fused_render_bf16@messytable-dex", counts["fused_render_bf16"], err_r, ms_r,
                     render_bound, render_bound_by)]


def hold_frame(label, coarse, fine, rays, s_val, torch):
    """Kernel 1's bf16 route on one frame ``rays`` (a flat RayBatch) of
    ``coarse``/``fine``: both passes vs the bf16 and f32 plain versions by
    the BF16_* rule of phase 3, the Dex depths (``s_val``'s thresholds)
    equal to the bf16 plain version's on >= BF16_DEX_SHARE of pairs; both
    passes timed (CUDA events, mean of 3) beside their plain versions and
    their bound. Returns (max abs error, ms, bound ms, bound_by)."""
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.ops import fused_render as fr

    vo, vd, vv = (t.contiguous() for t in rays[:3])
    vc, vf = coarse, fine
    zc = stratified_z_vals(rays.near, rays.far, s_val.num_coarse, lindisp=s_val.lindisp)
    thresholds = tuple(s_val.m_thres_cand)
    rkw = dict(white_background=s_val.white_background)
    bkw = dict(rkw, compute_dtype=torch.bfloat16)
    ms = {}
    with torch.inference_mode():
        dc = ray_dists(zc, vd)
        args_c = (vc, vo, vd, vv, zc, dc)
        print(f"{label}: {vo.shape[0]} rays, T = {len(thresholds)}, kernel 1 bf16 vs bf16 plain "
              f"and vs f32 plain (BF16_* as phase 3):")
        want_c = fr.fused_render_reference(*args_c, **bkw)
        err = compare_bf16("coarse", fr.fused_render(*args_c, **bkw), want_c,
                           fr.fused_render_reference(*args_c, **rkw), torch)
        zf, _ = hierarchical_z_vals(zc, want_c.weights, s_val.num_fine, det=True)
        df = ray_dists(zf, vd)
        args_f = (vf, vo, vd, vv, zf, df)
        got_f = fr.fused_render(*args_f, thresholds=thresholds, **bkw)
        want_f = fr.fused_render_reference(*args_f, thresholds=thresholds, **bkw)
        err = max(err, compare_bf16("fine", got_f, want_f, fr.fused_render_reference(
            *args_f, thresholds=thresholds, **rkw), torch))
        if thresholds:
            dex_eq = float((got_f.depth_dex == want_f.depth_dex).float().mean())
            hit = float((want_f.depth_dex != zf[None, :, 0]).float().mean())
            print(f"  dex: bf16 kernel = bf16 plain on {dex_eq:.6f} of "
                  f"{got_f.depth_dex.numel()} pairs (limit {BF16_DEX_SHARE}); past sample 0 on "
                  f"{hit:.3f} of them")
            if dex_eq < BF16_DEX_SHARE:
                raise AssertionError(f"{label}: bf16 dex depths equal on only {dex_eq:.6f}")
        for name, args, th in (("coarse", args_c, ()), ("fine", args_f, thresholds)):
            ms[f"{name}_kernel"] = timed_ms(
                lambda: fr.fused_render(*args, thresholds=th, **bkw), torch)
            ms[f"{name}_plain"] = timed_ms(
                lambda: fr.fused_render_reference(*args, thresholds=th, **bkw), torch)
        r_flops = r_bytes = 0
        for m, z, dz, g in ((vc, zc, dc, None), (vf, zf, df, got_f)):
            ps, pr = mlp_macs(m)
            r_flops += 2 * (z.numel() * ps + z.shape[0] * pr)
            # in: rays, depths, intervals, the bf16 pack; out: rgb, disparity,
            # accumulation, depth, weights (and the fine pass's Dex depths)
            r_bytes += (nbytes(vo, vd, vv, z, dz, *fr.pack_flex_weights_bf16(m)[:2])
                        + 4 * z.numel() + 4 * 6 * z.shape[0]
                        + (nbytes(g.depth_dex) if g is not None else 0))
    b_ms, b_by = bound(r_flops, r_bytes, BF16_FLOPS)
    print(f"  kernel 1 bound for the frame's two passes {b_ms:.3f} ms ({b_by}; "
          f"{r_flops / 1e12:.4f} TFLOP, {r_bytes / 1e6:.2f} MB)")
    return err, ms, b_ms, b_by


def render_entry(name, launches, err, ms, b_ms, b_by):
    """A kernels-line entry of kernel 1's bf16 route from :func:`hold_frame`."""
    return {
        "name": name, "route": "cuda", "source": "dexnerf_tpu_torch/ops/csrc/fused_render_bf16.cu",
        "replaces": "dexnerf_tpu/ops/fused_render.py:115", "launches": launches,
        "max_abs_err": err, "ms": ms["coarse_kernel"] + ms["fine_kernel"],
        "plain_ms": ms["coarse_plain"] + ms["fine_plain"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def eval_phase(torch, np, card, dev, tmp, cfg_path, logdir):
    """Phase 15, evaluation of phase 14's messytable weights (its last
    checkpoint, σ heads calibrated on the test view as in phase 3, so that
    the Dex thresholds cross, written as a reference ``.ckpt``) through
    ``apps.eval --test-set --dex-depth`` with every output (point cloud at
    a σ threshold, confidence, disparity, jet, GIF): two launches of kernel
    1's bf16 route per frame and none of its f32 route; the test frame held
    to its plain versions; eval's expected-depth and Dex errors equal to
    ``validate(dex=True)``'s on the same weights and view; ``metrics.json``
    and the PLY; the frame's host-clock ms and the kernel's two passes.
    Returns the kernels-line entry."""
    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_w2c
    from dexnerf_tpu_torch.render.renderer import make_ray_batch, render_image
    from dexnerf_tpu_torch.train.checkpoints import write_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import fused_render_impl, load_scene, validate
    from dexnerf_tpu_torch.utils import read_ply

    cfg, coarse, fine, _ = run_models(cfg_path, logdir, DEX_ITERS, dev)
    scene = load_scene(cfg)
    idx = int(scene.i_test[0])
    s_val = render_settings_from_cfg(cfg, "validation", dex=True).eval_variant()
    H, W = int(scene.hwf[0]), int(scene.hwf[1])
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    ro, rd = get_ray_bundle_w2c(H, W, torch.as_tensor(scene.poses[idx], device=dev),
                                torch.as_tensor(scene.intrinsics[idx], device=dev))
    rays = make_ray_batch(ro, rd, near, far)
    calibrate_on((coarse, fine), rays, s_val, torch)
    ckpt = os.path.join(tmp, "messytable-calibrated.ckpt")
    write_reference_checkpoint(ckpt, coarse.state_dict(), fine.state_dict())
    savedir = os.path.join(tmp, "eval-messytable")
    counts, metrics, secs = eval_cli(cfg_path, ckpt, savedir, [
        "--test-set", "--dex-depth", "--save-pointcloud", "--pointcloud-threshold",
        str(EVAL_PC_THRESHOLD), "--save-depth-confidence", "0.05", "--save-disparity-image",
        "--save-jet-disparity", "--save-gif"], dev)
    frames = len(metrics["per_image"])
    row = metrics["per_image"][0]
    val = validate(coarse, fine, scene, cfg, supervision="luminance", device=dev, dex=True,
                   val_idx=idx)
    ply = read_ply(os.path.join(savedir, "pointcloud", "0000.ply"))[0]
    print(f"phase 15: apps.eval --test-set --dex-depth on phase 14's weights, {frames} "
          f"frame(s) in {secs:.2f} s (kernels built, first call); launches {json.dumps(counts)}; "
          f"metrics.json mean {json.dumps(metrics['mean'])}, dex_gt {metrics.get('dex_gt')}; "
          f"validate(dex=True) on view {idx}: depth_abs_err {val.get('depth_abs_err')}, "
          f"min_abs_err {val.get('min_abs_err')} at m = {val.get('best_threshold')}; PLY "
          f"{ply.shape[0]} points")
    run_checks("evaluation", {
        "2 launches of kernel 1's bf16 route per frame, none of its f32 route":
            frames >= 1 and counts["fused_render_bf16"] == 2 * frames
            and counts["fused_render"] == counts["fused_render_bf16"],
        "no other kernel launched": all(v == 0 for k, v in counts.items()
                                        if not k.startswith("fused_render")),
        "metrics.json keys": {"per_image", "mean", "avg_s_per_image", "dex_gt"} <= set(metrics)
        and {"psnr", "ssim", "depth_abs_err", "dex_abs_err", "dex_best_m", "depth_conf"}
        <= set(row) and all(np.isfinite(v) for v in metrics["mean"].values()),
        "eval's depth_abs_err and dex_abs_err = validate(dex=True)'s":
            row["depth_abs_err"] == val["depth_abs_err"]
            and row["dex_abs_err"] == val["min_abs_err"]
            and row["dex_best_m"] == val["best_threshold"],
        f"view {idx} scored first": int(row["index"]) == idx,
        "PLY not empty, finite": ply.shape[0] > 0 and bool(np.isfinite(ply).all()),
        "frame, disparity, jet, confidence and error PNGs, GIF": all(
            os.path.exists(os.path.join(savedir, p)) for p in (
                "0000.png", "disparity/0000.png", "disparity_jet/0000.png",
                "confidence/0000.png", "depth_err/0000.png", "render.gif")),
    })

    # the test frame, as eval rendered it, vs the plain versions
    err, ms, b_ms, b_by = hold_frame("phase 15: the test frame", coarse, fine, rays, s_val,
                                     torch)
    impl = fused_render_impl(cfg, s_val, dev, coarse, fine)
    with torch.inference_mode():
        ms["frame_host"] = host_ms(torch, lambda: render_image(
            coarse, fine, ro, rd, near, far, s_val, rays_impl=impl))
    ms["eval_avg_s_per_image"] = metrics["avg_s_per_image"]
    print(f"phase 15: ms on {card} (passes: CUDA events, mean of 3; frame_host: host clock of "
          f"a warm render_image to its synchronize, mean of 3; eval_avg_s_per_image: apps.eval's "
          f"own seconds per frame, first call): " + json.dumps(
              {k: round(t, 4) for k, t in ms.items()}))
    return [render_entry("fused_render_bf16@messytable-eval", counts["fused_render_bf16"], err,
                         ms, b_ms, b_by)]


def llff_phase(torch, np, card, dev, tmp):
    """Phase 16, the LLFF/NDC path: write a forward-facing scene with the
    port's writer at fern's factor-8 size (378x504, loaded at factor 1),
    train ``configs/llff.yml`` (``nerf.use_pallas: true``) on it through
    ``apps.train`` for 20 steps (40 launches of kernel 4's bf16 route on
    NDC rays, the loss falls; validations through kernel 1 on NDC rays),
    hold kernel 4's bf16 route to its plain version on one batch of the run
    and kernel 1's on one NDC frame, time a step and the frame, and score
    the held-out views through ``apps.eval --test-set`` (depths as metric
    ray distances through ``ndc_t_to_world_depth``). Returns the two
    kernels-line entries."""
    import copy

    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.metrics import compute_err_metric
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w, ndc_t_to_world_depth
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.data.synthetic import write_llff_dataset
    from dexnerf_tpu_torch.render.renderer import make_ray_batch, render_image
    from dexnerf_tpu_torch.train.loop import fused_render_impl, load_scene

    t0 = time.perf_counter()
    data = os.path.join(tmp, "llff")
    write_llff_dataset(data, *LLFF_HW, views=LLFF_VIEWS, device=dev)
    dataset_s = time.perf_counter() - t0
    cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb = train_cli(
        tmp, data, "llff", LLFF_ITERS, torch, dev, config=LLFF_CONFIG,
        dataset={"downsample_factor": 1, "depth_valid_max": LLFF_VALID_MAX}, use_pallas=True)
    print(f"phase 16: llff ({LLFF_HW[0]}x{LLFF_HW[1]}, {LLFF_VIEWS} views written in "
          f"{dataset_s:.2f} s, NDC): {LLFF_ITERS} steps in {secs:.2f} s; launches "
          f"{json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}; validation psnr {val_psnr}")
    n_val = len(val_psnr)
    run_checks("LLFF training", {
        f"kernel 4's bf16 route launched {2 * LLFF_ITERS} times, its f32 route never":
            counts["fused_train_loss_bf16"] == 2 * LLFF_ITERS
            and counts["fused_train_loss"] == counts["fused_train_loss_bf16"],
        "validations at steps 0 and last, each 2 launches of kernel 1's bf16 route":
            n_val == 2 and counts["fused_render_bf16"] == 2 * n_val == counts["fused_render"],
        f"{LLFF_ITERS} finite losses": len(losses) == LLFF_ITERS
        and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
    })

    # ---- kernel 4's bf16 route vs plain on one NDC batch of the run
    cfg, coarse, fine, _ = run_models(cfg_path, logdir, LLFF_ITERS, dev)
    ckpt = os.path.join(logdir, "checkpoints", f"checkpoint_{LLFF_ITERS - 1:07d}.ckpt")
    scene = load_scene(cfg)
    s_train = render_settings_from_cfg(cfg, "train")
    batch = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    tr = scene.i_train
    store = build_ray_store(scene.images[tr], scene.poses[tr], scene.hwf, near, far, device=dev,
                            use_ndc=True)
    k4 = hold_train_bf16("phase 16: kernel 4 bf16 route on NDC rays", 16, (coarse, fine), store,
                         s_train, float(cfg.optimizer.lr), batch, 3.0 * batch, {}, torch, dev)
    ms = k4.ms

    # ---- kernel 1's bf16 route on one NDC frame (the run's weights, σ calibrated)
    s_val = render_settings_from_cfg(cfg, "validation").eval_variant()
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    vi = int(scene.i_val[0])
    ro, rd = get_ray_bundle_c2w(H, W, focal, torch.as_tensor(scene.poses[vi], device=dev))
    ndc = dict(use_ndc=True, height=H, width=W, focal_length=focal)
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    vrays = make_ray_batch(ro, rd, near, far, **ndc)
    calibrate_on((vc, vf), vrays, s_val, torch)
    err_r, ms_r, r_bound, r_by = hold_frame("phase 16: an NDC frame", vc, vf, vrays, s_val, torch)
    impl = fused_render_impl(cfg, s_val, dev, coarse, fine)
    with torch.inference_mode():
        ms_r["host"] = host_ms(torch, lambda: render_image(
            coarse, fine, ro, rd, near, far, s_val, rays_impl=impl, **ndc))

    # ---- apps.eval --test-set: the held-out views scored as metric distances
    savedir = os.path.join(tmp, "eval-llff")
    e_counts, metrics, e_secs = eval_cli(cfg_path, ckpt, savedir, ["--test-set"], dev)
    frames = len(metrics["per_image"])
    row = metrics["per_image"][0]
    ti = int(row["index"])
    ro, rd = get_ray_bundle_c2w(H, W, focal, torch.as_tensor(scene.poses[ti], device=dev))
    with torch.inference_mode():
        depth = render_image(coarse, fine, ro, rd, near, far, s_val, rays_impl=impl,
                             **ndc).fine.depth
        world = ndc_t_to_world_depth(depth, ro, rd, H, W, focal).cpu().numpy()
    gt = scene.depths[ti]
    mask = (gt > 0) & (gt < LLFF_VALID_MAX)
    recomputed = compute_err_metric(gt, world, mask)["depth_abs_err"]
    print(f"phase 16: apps.eval --test-set, {frames} views in {e_secs:.2f} s; launches "
          f"{json.dumps(e_counts)}; metrics.json mean {json.dumps(metrics['mean'])}; view {ti}: "
          f"depth_abs_err {row.get('depth_abs_err')} (scene mm; through ndc_t_to_world_depth "
          f"here {recomputed}; the NDC parameter itself would read "
          f"{compute_err_metric(gt, depth.cpu().numpy(), mask)['depth_abs_err']})")
    run_checks("LLFF evaluation", {
        "2 launches of kernel 1's bf16 route per held-out view, none of its f32 route":
            frames == len(scene.i_test) and e_counts["fused_render_bf16"] == 2 * frames
            and e_counts["fused_render"] == e_counts["fused_render_bf16"],
        "depth scored through ndc_t_to_world_depth, finite":
            row["depth_abs_err"] == recomputed and bool(np.isfinite(recomputed)),
        "PSNR and SSIM finite": all(np.isfinite([row["psnr"], row["ssim"]])),
    })
    print(f"phase 16: ms on {card} (kernel passes: CUDA events, mean of 3; step and frame_host: "
          f"host clock to synchronize, mean of 5 and 3): " + json.dumps(
              {k: round(t, 4) for k, t in {**ms, **{f"frame_{k}": t for k, t in ms_r.items()},
                                           "eval_avg_s_per_image": metrics["avg_s_per_image"]
                                           }.items()}))
    print(f"  kernel 4 bound for both passes {k4.bound_ms:.3f} ms ({k4.bound_by}); its "
          f"kernels, device ms per step (profile) beside their bounds: " + json.dumps(k4.parts)
          + f"; rays/s per step {round(batch / (ms['step'] / 1e3))}")
    return [train_entry("fused_train_loss_bf16@llff-ndc", counts["fused_train_loss_bf16"], k4),
            render_entry("fused_render_bf16@llff-ndc", counts["fused_render_bf16"], err_r, ms_r,
                    r_bound, r_by)]


def profile_steps(torch, step, kernels_of, n=3, unit="step", summary=None):
    """Device time of ``n`` train steps (or other ``unit``s) by part: each entry of
    ``kernels_of`` (label -> kernel name fragments), Adam (the foreach
    multi-tensor kernels), the rest (glue), and idle (the span from the
    first kernel's start to the last one's end, minus the union of kernel
    intervals). Returns the device ms per unit of each kernel, by name;
    ``summary``, a dict, receives the parts, ``idle`` and ``span`` per unit
    and the device events (``launches``) per unit."""
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
        return {}
    parts = {**{k: 0.0 for k in kernels_of}, "Adam": 0.0, "glue": 0.0}
    names, full = {}, {}
    for name, t0, t1 in kernels:
        full[name] = full.get(name, 0.0) + (t1 - t0) / n / 1e3
        part = next((k for k, frags in kernels_of.items() if any(f in name for f in frags)),
                    None)
        if part is None:
            part = "Adam" if "multi_tensor" in name or "adam" in name.lower() else "glue"
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
    if summary is not None:
        summary.update(per_step, launches=len(kernels) / n)
    print(f"  profile, ms per {unit} over {n} {unit}s ({len(kernels)} device events): "
          + json.dumps(per_step))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    print(f"  top device ops, ms per {unit}: "
          + json.dumps({k: round(v / n / 1e3, 3) for k, v in top}))
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"  top host ops (self CPU time, profiler on), ms per {unit}: "
          + json.dumps({e.key[:50]: round(e.self_cpu_time_total / n / 1e3, 3) for e in host}))
    return full


def pick_occupancy_threshold(sigma, torch):
    """A positive σ threshold (0 turns occupancy off), midway between two
    cells' σ, whose grid dilated once holds OCC_FRACTION_GOAL of the cells
    or less, and at least OCC_FRACTION_RANGE[0]: the quantiles of the
    positive σ are tried from the median up. Returns (threshold, dilated
    fraction)."""
    from dexnerf_tpu_torch.render.occupancy import dilate_occupancy

    flat = torch.sort(sigma[sigma > 0]).values
    for q in (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98, 0.99, 0.995):
        k = max(1, int(q * flat.numel()))
        thr = float(0.5 * (flat[k - 1] + flat[k]))
        frac = float(dilate_occupancy(sigma > thr).float().mean())
        if thr > 0 and OCC_FRACTION_RANGE[0] <= frac <= OCC_FRACTION_GOAL:
            return thr, frac
    raise AssertionError(f"no σ threshold leaves {OCC_FRACTION_RANGE[0]:g}-"
                         f"{OCC_FRACTION_GOAL:g} of the cells occupied")


def occupancy_phase(torch, np, card, dev, tmp, shared):
    """Phase 17, occupancy-guided empty-space skipping on phase 6's trained
    ``lego-tpu`` weights: (a) bake a 128³ grid on the card at a σ
    threshold that leaves 5-95% of the cells occupied, held to a CPU bake of
    the same weights (cells whose σ lies within OCC_THRESH_RTOL of the
    threshold, and their dilation, excepted and counted); (b) ``apps.eval
    --occupancy`` on the held-out view (two kernel-1 bf16 launches, none
    f32; every tightened interval inside the full one, the mean shrink > 0;
    kernel 1 on the tightened rays vs its plain versions by phase 3's rule;
    the tightening and the frame without occupancy, with it, and with it at
    32 + 32 samples); (c) ``apps.serve --occupancy``: /render and /depth
    (two bf16 launches a frame), /healthz, /confidence refused; (d)
    ``apps.train --occupancy`` for OCC_ITERS steps at bf16 with a bake at
    step OCC_START and every OCC_EVERY after (60 launches of kernel 4's
    bf16 route, none f32; the bakes logged; the final store's intervals
    inside the full one; the loss falls), kernel 4's bf16 route on a
    tightened batch vs plain (phase 7's rule), a step and a re-bake (the
    bake and the tightening of the store) timed; (e) ``apps.mesh`` at 128³
    writes a PLY. Returns the kernels-line entries."""
    import copy

    from dexnerf_tpu_torch.apps import mesh as mesh_app
    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.render import occupancy as occ
    from dexnerf_tpu_torch.render.renderer import make_mlp_field, make_ray_batch, render_image
    from dexnerf_tpu_torch.train.loop import fused_render_impl, load_scene

    cfg, coarse, fine, _ = run_models(shared.cfg_path, shared.logdir, TRAIN_ITERS, dev)
    ckpt = os.path.join(shared.logdir, "checkpoints", f"checkpoint_{TRAIN_ITERS - 1:07d}.ckpt")
    s_val = render_settings_from_cfg(cfg, "validation").eval_variant()
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    ms = {}

    # ---- (a) the bake, on the card and on the CPU
    field = make_mlp_field(fine, s_val)
    sigma = occ.eval_sigma_grid(field, device=dev, resolution=OCC_RES)
    thr, _ = pick_occupancy_threshold(sigma, torch)
    kw = dict(sigma_threshold=thr, resolution=OCC_RES)
    grid = occ.build_occupancy_grid(field, device=dev, **kw)
    ms["sigma_grid"] = timed_ms(lambda: occ.eval_sigma_grid(field, device=dev,
                                                            resolution=OCC_RES), torch)
    ms["bake"] = timed_ms(lambda: occ.build_occupancy_grid(field, device=dev, **kw), torch)
    print("phase 17: the bake on the card (the plain model's products, the rest):")
    profile_steps(torch, lambda: occ.build_occupancy_grid(field, device=dev, **kw),
                  {"matmul": OCC_GEMM_NAMES}, unit="bake")
    t0 = time.perf_counter()
    grid_cpu = occ.build_occupancy_grid(make_mlp_field(copy.deepcopy(fine).cpu(), s_val),
                                        device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    near_thr = (sigma - thr).abs() <= OCC_THRESH_RTOL * abs(thr)
    excepted = occ.dilate_occupancy(near_thr).cpu()
    differ = grid.occ.cpu() != grid_cpu.occ
    frac = grid.occupancy_fraction()
    print(f"phase 17: lego-tpu (phase 6's weights), {OCC_RES}^3 grid at σ > {thr:.6g} (σ on "
          f"the grid: min {float(sigma.min()):.4g}, median {float(sigma.median()):.4g}, max "
          f"{float(sigma.max()):.4g}): {100 * frac:.2f}% occupied after one dilation; vs the "
          f"CPU bake ({cpu_s:.2f} s): {int(differ.sum())} cells differ, {int(near_thr.sum())} "
          f"cells within {OCC_THRESH_RTOL:g} of the threshold ({int(excepted.sum())} "
          f"dilated)")
    run_checks("occupancy bake", {
        "5-95% of the cells occupied": 0.05 <= frac <= 0.95,
        "card bake = CPU bake off the cells near the threshold": not bool(
            (differ & ~excepted).any()),
        "cells near the threshold few (<= 0.1%)": int(near_thr.sum()) <= 1e-3 * near_thr.numel(),
    })

    # ---- (b) apps.eval --occupancy on the held-out view
    savedir = os.path.join(tmp, "eval-occupancy")
    occ_flags = ["--occupancy", repr(thr), "--occupancy-resolution", str(OCC_RES),
                 "--occupancy-probes", str(OCC_PROBES_FRAME), "--occupancy-subsample",
                 str(OCC_SUBSAMPLE)]
    counts, metrics, secs = eval_cli(shared.cfg_path, ckpt, savedir,
                                     ["--test-set", "--num-poses", "1", *occ_flags], dev)
    scene = load_scene(cfg)
    idx = int(scene.i_test[0])
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    ro, rd = get_ray_bundle_c2w(H, W, focal, torch.as_tensor(scene.poses[idx], device=dev))
    rays = make_ray_batch(ro, rd, near, far)
    tighten = lambda: occ.tighten_image_intervals(  # noqa: E731
        grid, rays.origins, rays.directions, rays.near, rays.far, (H, W),
        num_probes=OCC_PROBES_FRAME, subsample=OCC_SUBSAMPLE)
    with torch.inference_mode():
        t_near, t_far = tighten()
    shrink = 1.0 - float((t_far - t_near).mean()) / (far - near)
    inside = bool(((t_near >= near) & (t_far <= far) & (t_near <= t_far)).all())
    print(f"phase 17: apps.eval --test-set --occupancy {thr:.6g} on view {idx} ({H}x{W}) in "
          f"{secs:.2f} s (first call); launches {json.dumps(counts)}; psnr "
          f"{metrics['mean']['psnr']:.4f}; tightened intervals: mean shrink {shrink:.4f}, "
          f"{float((t_far - t_near < far - near).float().mean()):.4f} of the rays tightened")
    run_checks("evaluation with occupancy", {
        "2 launches of kernel 1's bf16 route, none of its f32 route":
            counts["fused_render_bf16"] == 2 and counts["fused_render"] == 2,
        "no other kernel launched": all(v == 0 for k, v in counts.items()
                                        if not k.startswith("fused_render")),
        "every tightened interval inside the full one": inside,
        "mean shrink > 0": shrink > 0.0,
        "psnr and ssim finite": bool(np.isfinite([metrics["mean"][k] for k in ("psnr", "ssim")])
                                     .all()),
    })
    tight = rays._replace(near=t_near, far=t_far)
    err, fms, b_ms, b_by = hold_frame("phase 17: the tightened frame", coarse, fine, tight, s_val,
                                      torch)
    ms.update({f"frame_{k}": v for k, v in fms.items()})
    s32 = dataclasses.replace(s_val, num_coarse=32, num_fine=32)
    impl, impl32 = (fused_render_impl(cfg, s, dev, coarse, fine) for s in (s_val, s32))
    okw = dict(occupancy=grid, occupancy_probes=OCC_PROBES_FRAME,
               occupancy_subsample=OCC_SUBSAMPLE)
    with torch.inference_mode():
        ms["tighten_frame"] = timed_ms(tighten, torch)
        ms["frame_full"] = timed_ms(lambda: render_image(
            coarse, fine, ro, rd, near, far, s_val, rays_impl=impl), torch)
        ms["frame_occupancy"] = timed_ms(lambda: render_image(
            coarse, fine, ro, rd, near, far, s_val, rays_impl=impl, **okw), torch)
        ms["frame_occupancy_32_32"] = timed_ms(lambda: render_image(
            coarse, fine, ro, rd, near, far, s32, rays_impl=impl32, **okw), torch)
    eval_entry = render_entry("fused_render_bf16@occupancy-eval", counts["fused_render_bf16"],
                              err, fms, b_ms, b_by)

    # ---- (c) apps.serve --occupancy
    q = "theta=%g&phi=%g&radius=%g" % POSE
    out, info, request_ms, frames, launches, launches_b = serve_requests(
        shared.cfg_path, ckpt, [("/healthz", None), ("/render?" + q, None),
                                ("/depth?" + q, None), ("/confidence?" + q, None)], torch,
        flags=occ_flags, refused=("/confidence",))
    depth = np.load(io.BytesIO(out[2]))
    print(f"phase 17: apps.serve --occupancy: served {frames} frames, kernel-1 launches "
          f"{launches} (bf16 {launches_b}); healthz occupancy {info.get('occupancy')}, "
          f"depth_confidence {info.get('depth_confidence')}; /confidence: {out[3]}; request ms "
          f"(host clock, first requests) {json.dumps(request_ms)}")
    run_checks("serving with occupancy", {
        "/render and /depth: 2 bf16 launches a frame, no f32 launch": frames == 2
        and launches_b == 4 and launches == 4,
        "/healthz reports occupancy": info.get("occupancy") is True
        and info.get("depth_confidence") is False,
        "/depth 400x400 finite": depth.shape == (HWF[0], HWF[1])
        and bool(np.isfinite(depth).all()),
        "/confidence refused": "occupancy" in out[3].get("error", ""),
    })

    # ---- (d) apps.train --occupancy, kernel 4 on the tightened store
    train = dict(occupancy_start_iter=OCC_START, occupancy_rebake_every=OCC_EVERY,
                 occupancy_resolution=OCC_RES, occupancy_probes=OCC_PROBES_STORE)
    cfg_occ, logdir, counts_t, losses, _, secs_t, peak_gb = train_cli(
        tmp, shared.data, "lego-tpu-occupancy", OCC_ITERS, torch, dev,
        flags=("--occupancy", repr(thr)), train=train)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    bakes = {r["step"]: r["value"] for r in recs if r["tag"] == "train/occ_fraction"}
    shrinks = {r["step"]: r["value"] for r in recs if r["tag"] == "train/occ_interval_shrink"}
    cfg_t, coarse_t, fine_t, _ = run_models(cfg_occ, logdir, OCC_ITERS, dev)
    s_train = render_settings_from_cfg(cfg_t, "train")
    store = build_ray_store(scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf,
                            near, far, device=dev)
    # the last bake's intervals again: the final weights, the whole store
    field_t = make_mlp_field(fine_t, s_train)
    kw_t = dict(sigma_threshold=thr, resolution=OCC_RES)

    def rebake():
        g = occ.build_occupancy_grid(field_t, device=dev, **kw_t)
        return occ.tighten_store_intervals(g, store.data, near, far, num_probes=OCC_PROBES_STORE)

    iv = rebake()
    ms["rebake_store"] = timed_ms(rebake, torch, reps=1)
    g_t = occ.build_occupancy_grid(field_t, device=dev, **kw_t)
    ms["tighten_store"] = timed_ms(lambda: occ.tighten_store_intervals(
        g_t, store.data, near, far, num_probes=OCC_PROBES_STORE), torch, reps=1)
    print(f"phase 17: the tightening of the {store.num_rays}-ray store on the card:")
    profile_steps(torch, lambda: occ.tighten_store_intervals(
        g_t, store.data, near, far, num_probes=OCC_PROBES_STORE), {"gather": ("index",)}, n=1,
        unit="tightening")
    store_shrink = 1.0 - float((iv[:, 1] - iv[:, 0]).mean()) / (far - near)
    want_steps = list(range(OCC_START - 1, OCC_ITERS, OCC_EVERY))
    print(f"phase 17: apps.train --occupancy {thr:.6g}, {OCC_ITERS} steps in {secs_t:.2f} s "
          f"(bakes after steps {sorted(bakes)}: fraction {json.dumps(bakes)}, shrink "
          f"{json.dumps(shrinks)}); launches {json.dumps(counts_t)}; peak {peak_gb:.2f} GiB; loss "
          f"first {losses[0]:.5f} last {losses[-1]:.5f}; the final store ({iv.shape[0]} rays): "
          f"shrink {store_shrink:.6f}")
    run_checks("training with occupancy", {
        f"kernel 4's bf16 route launched {2 * OCC_ITERS} times, its f32 route never":
            counts_t["fused_train_loss_bf16"] == 2 * OCC_ITERS
            and counts_t["fused_train_loss"] == counts_t["fused_train_loss_bf16"],
        f"a bake and {len(want_steps) - 1} re-bakes logged, after steps {want_steps}":
            sorted(bakes) == want_steps and sorted(shrinks) == want_steps,
        "the store's intervals inside the full one, shrink > 0 and = the last logged": bool(
            ((iv[:, 0] >= near) & (iv[:, 1] <= far) & (iv[:, 0] <= iv[:, 1])).all())
        and store_shrink > 0 and abs(store_shrink - shrinks[want_steps[-1]]) < 1e-4,
        f"{OCC_ITERS} finite losses, falling": len(losses) == OCC_ITERS
        and bool(np.isfinite(losses).all()) and np.mean(losses[-10:]) < np.mean(losses[:10]),
    })
    tightened = dataclasses.replace(store, intervals=iv)
    batch = int(cfg_t.nerf.train.num_random_rays)
    k4 = hold_train_bf16("phase 17: kernel 4 bf16 route on the tightened store", 17,
                         (coarse_t, fine_t), tightened, s_train, float(cfg_t.optimizer.lr), batch,
                         float(3 * batch), {}, torch, dev)
    ms.update({f"k4_{k}": v for k, v in k4.ms.items()})

    # ---- (e) apps.mesh at 128³
    ply = os.path.join(tmp, "lego-occupancy.ply")
    t0 = time.perf_counter()
    rc = mesh_app.main(["--config", shared.cfg_path, "--checkpoint", ckpt, "--out", ply,
                        "--sigma-threshold", repr(thr), "--resolution", str(OCC_RES),
                        "--device", dev.type])
    mesh_s = time.perf_counter() - t0
    with open(ply) as f:
        header = [next(f) for _ in range(9)]
    n_verts = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
    n_faces = int(next(l for l in header if l.startswith("element face")).split()[-1])
    ms["mesh_sigma_grid"] = timed_ms(lambda: occ.eval_sigma_grid(
        field, device=dev, resolution=OCC_RES, style="corners"), torch)
    print(f"phase 17: apps.mesh at {OCC_RES}^3, σ = {thr:.6g}: exit {rc}, {n_verts} vertices, "
          f"{n_faces} faces in {mesh_s:.2f} s (host clock, first call)")
    run_checks("mesh", {"exit 0, a PLY with vertices and faces": rc == 0 and n_verts > 0
                        and n_faces > 0})
    print(f"phase 17: ms on {card} (CUDA events, mean of 3; rebake_store and tighten_store one "
          f"call; k4_step host clock, mean of 5): " + json.dumps(
              {k: round(t, 4) for k, t in ms.items()}))
    return [eval_entry, train_entry("fused_train_loss_bf16@occupancy",
                                    counts_t["fused_train_loss_bf16"], k4)]


def hold_fields_f32(label, model, pts, v, g, kw, torch):
    """Kernels 2 and 3's f32 routes on one pass (``pts`` [N, S, 3], the
    per-ray ``v``, the cotangent ``g`` of raw) held to their plain
    versions: raw within RTOL / ATOL (phase 10's rule) and each kernel-3
    leaf by the rule ``perf_tools/field_f32_rule.py`` holds that route to
    (see :func:`field_pass_hold`). Returns the max abs errors (``fwd``,
    ``bwd``), the plain raw and the plain leaves."""
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt

    from perf_tools.field_f32_rule import (
        GPU_GRAD_FACTOR,
        GPU_GRAD_RTOL,
        grads_on_masks,
        own_decision_ratios,
    )

    names = [n for n, _ in model.named_parameters()]
    raw_p = fm.fused_field_reference(model, pts, v, **kw).detach()
    want = fmt.field_grads_reference(model, pts, v, g, **kw)
    raw = fm.fused_field(model, pts, v, **kw)
    grads = fmt._launch_backward(model, pts, v, g, **kw)
    torch.cuda.synchronize()
    bad, leaves, err = [], {}, {"fwd": float((raw - raw_p).abs().max()), "bwd": 0.0}
    if not bool(torch.isfinite(raw).all()) or bool(
            ((raw - raw_p).abs() > ATOL + RTOL * raw_p.abs()).any()):
        bad.append("raw")
    ratios, flips, layers = own_decision_ratios(
        model, pts, v, grads, want, lambda sl, masks: grads_on_masks(model, pts[sl], v[sl],
                                                                     g[sl], masks))
    bad += [f"ReLU decisions of layer {i}" for i in layers]
    rule = {}
    for pname, gk, gp in zip(names, grads, want):
        e, scale = float((gk - gp).abs().max()), float(gp.abs().max())
        leaves[pname] = (e, scale)
        err["bwd"] = max(err["bwd"], e)
        rule[pname] = float(f"{ratios[pname]:.3e}")
        if not bool(torch.isfinite(gk).all()) or ratios[pname] > 1.0:
            bad.append(pname)
    print(f"{label}: f32 routes, kernel 2 raw max abs err {err['fwd']:.3e} (rtol {RTOL:g}, "
          f"atol {ATOL:g}); kernel 3 ({flips} ReLU decisions otherwise than the plain version):")
    print_leaves(leaves, f"phase 10's limit {GRAD_RTOL:g}, beside the rule below")
    print(f"  each leaf's float64 error on its own decisions over its limit ({GPU_GRAD_FACTOR:g} x "
          f"the plain version's + {GPU_GRAD_RTOL:g} of the largest entry): " + json.dumps(rule))
    if bad:
        raise AssertionError(f"{label}: field kernels and plain differ in {bad}")
    return err, raw_p, want


def field_pass_hold(label, model, pts, v, g, kw, torch, dev):
    """Kernels 2 and 3 on one pass of a run (``pts`` [N, S, 3], the per-ray
    ``v``, the pass loss's cotangent ``g``), both routes, held to their
    plain versions, then timed (CUDA events, mean of 3) beside their plain
    versions, their bounds and their products as ``torch.matmul``. The f32
    routes: raw within RTOL / ATOL (phase 10's rule) and each kernel-3 leaf
    by the rule ``perf_tools/field_f32_rule.py`` holds that route to
    (ROADMAP Queue 3 fault 7): each version to float64 on its own ReLU
    decisions, the route within GPU_GRAD_FACTOR times the plain version's
    error + GPU_GRAD_RTOL of the leaf's largest entry, every decision it
    makes otherwise than the plain version within MASK_RTOL of its layer's
    largest activation (phase 10's GRAD_RTOL of the plain f32 leaf is
    printed beside it; a ReLU within rounding of 0 decided otherwise moves a
    leaf by ~1/sqrt(samples) of its largest entry, past it on 1 of 13
    batches of the mixed run's coarse pass). The bf16 routes: relative to
    the dtype's own effect. Returns a namespace of ``err`` (by route),
    ``ms`` and ``bounds``."""
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    bf = dict(compute_dtype=torch.bfloat16)
    bf2 = dict(bf, dw_dtype=torch.bfloat16)
    names = [n for n, _ in model.named_parameters()]
    err, raw_p, want = hold_fields_f32(label, model, pts, v, g, kw, torch)
    err["fwd_bf16"], err["bwd_bf16"] = hold_fields_bf16(
        label, model, pts, v, g, torch, kw, {"raw": raw_p, **dict(zip(names, want))})
    ms = {}
    for tag, dt, dt2 in (("", {}, {}), ("_bf16", bf, bf2)):
        with torch.no_grad():
            ms["fwd_kernel" + tag] = timed_ms(lambda: fm.fused_field(model, pts, v, **kw, **dt),
                                              torch)
            ms["fwd_plain" + tag] = timed_ms(
                lambda: fm.fused_field_reference(model, pts, v, **kw, **dt), torch)
        ms["bwd_kernel" + tag] = timed_ms(
            lambda: fmt._launch_backward(model, pts, v, g, **kw, **dt2), torch)
        ms["bwd_plain" + tag] = timed_ms(
            lambda: fmt.field_grads_reference(model, pts, v, g, **kw, **dt2), torch)
    n, s = pts.shape[:2]
    passes = [(model, n * s)]
    dw_yardsticks(ms, passes, torch, dev)
    pass_yardsticks(ms, "k", passes, torch, dev)
    pass_yardsticks(ms, "k", passes, torch, dev, torch.bfloat16)
    ps, pr = mlp_macs(model)
    fwd_flops, bwd_flops = 2 * (n * s * ps + n * pr), train_flops(model, n, s)
    params = list(model.parameters())
    packs = nbytes(*ftl._cached_bf16_weights(model, dev)[:2])
    raw_bytes = n * s * 4 * 4
    bounds = {
        "fwd": bound(3 * fwd_flops, nbytes(pts, v, *params) + raw_bytes, TF32_FLOPS),
        "bwd": bound(3 * bwd_flops, nbytes(pts, v, g) + 2 * nbytes(*params), TF32_FLOPS),
        "fwd_bf16": bound(fwd_flops, nbytes(pts, v) + packs + raw_bytes, BF16_FLOPS),
        "bwd_bf16": bound(bwd_flops, nbytes(pts, v, g, *params) + packs
                          + nbytes(ftl.pack_backward_weights_bf16(model, dev)), BF16_FLOPS),
    }
    print(f"{label}: ms (CUDA events, mean of 3): "
          + json.dumps({k: round(t, 3) for k, t in ms.items()}) + "; bounds (ms): "
          + json.dumps({k: [round(b, 3), by] for k, (b, by) in bounds.items()}))
    return types.SimpleNamespace(err=err, ms=ms, bounds=bounds)


def field_entries(name, route, launches, hold):
    """The kernels-line entries of kernels 2 and 3's ``route`` ("f32" or
    "bf16") on a run's pass from :func:`field_pass_hold`, with
    ``launches`` (kernel 2's, kernel 3's) of that run."""
    ms, b = hold.ms, hold.bounds
    tag = "" if route == "f32" else "_bf16"
    src = ("dexnerf_tpu_torch/ops/csrc/fused_train_loss.cu" if route == "f32"
           else "dexnerf_tpu_torch/ops/csrc/fused_train_loss_bf16.cu")
    names = (("fused_field", "fused_field_backward") if route == "f32"
             else ("fused_mlp_bf16", "fused_mlp_train_bf16"))
    lib = "_f32" if route == "f32" else "_bf16"

    def by(key):
        return b[key][1] + (SPLIT_TF32 if route == "f32" and b[key][1] == "operations" else "")

    return [
        {"name": f"{names[0]}@{name}", "route": "cuda", "source": src,
         "replaces": "dexnerf_tpu/ops/fused_mlp.py:481", "launches": launches[0],
         "max_abs_err": hold.err["fwd" + tag], "ms": ms["fwd_kernel" + tag],
         "plain_ms": ms["fwd_plain" + tag], "bound_ms": b["fwd" + tag][0],
         "bound_by": by("fwd" + tag), "library_ms": ms["k_forward_torch_matmul" + lib]},
        {"name": f"{names[1]}@{name}", "route": "cuda", "source": src,
         "replaces": "dexnerf_tpu/ops/fused_mlp_train.py:221", "launches": launches[1],
         "max_abs_err": hold.err["bwd" + tag], "ms": ms["bwd_kernel" + tag],
         "plain_ms": ms["bwd_plain" + tag], "bound_ms": b["bwd" + tag][0],
         "bound_by": by("bwd" + tag),
         "library_ms": ms["dw_torch_matmul" + lib] + ms["k_forward_torch_matmul" + lib]
         + ms["k_chain_torch_matmul" + lib]},
    ]


def families_phase(torch, np, card, dev, tmp, shared):
    """Phase 18, the other model families, FlexibleNeRF without viewdirs,
    the optimizers beyond Adam and JAX's kernel-selection rules: (a) each
    configuration of FAMILY_RUNS (``configs/lego-tpu.yml`` with its model
    types, ``nerf.use_viewdirs`` or ``optimizer.type`` overridden in
    memory, printed) trained through ``apps.train`` for FAMILY_ITERS steps
    at full width on phase 6's scene, every launch counter set to 0 just
    before and read just after: no kernel on the all-plain configs, kernels
    2 and 3 (bf16) once a step and kernel 4 never on the mixed FlexibleNeRF
    + PaperNeRF config (the coarse pass through the field kernels, the fine
    pass plain), kernel 4 twice a step on the optimizer runs; the loss on a
    fixed batch lower after than at the seeded init, the ``.ckpt`` with the
    optimizer's state, a step's host-clock ms, peak memory and profile, and
    ``apps.eval --test-set`` on the checkpoint; (b) kernels 2 and 3 on the
    mixed run's coarse pass, both routes, vs plain (:func:`field_pass_hold`)
    and timed; (c) the mixed config's step at ``pallas_compute_dtype:
    float32`` (one launch each of kernels 2 and 3's f32 routes) held to the
    plain autograd step on the same draws by its loss, its leaves printed;
    (d) OPT_STEPS updates of each optimizer on the
    card held to the CPU's on the CPU's gradients from phase 6's weights; (e)
    ``apps.tiny`` for TINY_ITERS iterations on the card (no kernel), its
    hold-out PSNR rising. Returns the kernels-line entries of (b)-(c)."""
    import copy

    from dexnerf_tpu_torch.apps import tiny as tiny_app
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.volrend import composite, ray_dists
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
    from dexnerf_tpu_torch.render.renderer import (
        draw_render_noise,
        jittered_z_vals,
        render_rays,
    )
    from dexnerf_tpu_torch.train.checkpoints import PORT_OPTIMIZER_KEY, read_reference_checkpoint
    from dexnerf_tpu_torch.train.loop import (
        load_scene,
        maybe_fused_fields,
        maybe_fused_loss,
        setup_models,
    )
    from dexnerf_tpu_torch.train.step import (
        OPTIMIZER_REGISTRY,
        StepDraws,
        init_train_state,
        make_train_step,
        nerf_loss,
    )

    cfg0 = load_config(shared.cfg_path)
    scene = load_scene(cfg0)
    near, far = float(cfg0.dataset.near), float(cfg0.dataset.far)
    train_views = (scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf, near, far)
    store = build_ray_store(*train_views, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    held_rays, held_target = take_ray_batch(
        store, torch.randint(0, store.num_rays, (HELD_RAYS,), generator=gen, device=dev))

    def held_loss(cfg, coarse, fine):
        s = render_settings_from_cfg(cfg, "validation").eval_variant()
        with torch.no_grad():
            return float(nerf_loss(render_rays(coarse, fine, held_rays, s), held_target)[0])

    def step_of(cfg, coarse, fine, batch):
        """The run's train step, its kernels selected as ``run_training``
        selects them."""
        s = render_settings_from_cfg(cfg, "train")
        fused = maybe_fused_loss(cfg, s, "rgb", coarse, fine)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the no-viewdirs warning, printed by the run
            fields = (None, None) if fused is not None else maybe_fused_fields(
                cfg, coarse, fine, train=True)
        return make_train_step(s, batch, fused_loss=fused, coarse_field=fields[0],
                               fine_field=fields[1])

    # ---- (a) every configuration through apps.train, then apps.eval
    rows, mixed = {}, None
    batch = int(cfg0.nerf.train.num_random_rays)
    for name, (types_, nerf, opt) in FAMILY_RUNS.items():
        over = {**{f"models.{b}.type": t for b, t in types_.items()},
                **{f"nerf.{k}": v for k, v in nerf.items()},
                **({"optimizer.type": opt} if opt else {})}
        cfg_path, logdir, counts, losses, val, secs, peak_cli = train_cli(
            tmp, shared.data, f"family-{name}", FAMILY_ITERS, torch, dev, models=types_,
            optimizer=opt, **nerf)
        cfg = load_config(cfg_path)
        ck_path = os.path.join(logdir, "checkpoints", f"checkpoint_{FAMILY_ITERS - 1:07d}.ckpt")
        ck = read_reference_checkpoint(ck_path)
        before = held_loss(cfg, *setup_models(cfg, int(cfg.experiment.randomseed), dev))
        coarse, fine = setup_models(cfg, SEED, dev)
        coarse.load_state_dict(ck["coarse"])
        fine.load_state_dict(ck["fine"])
        after = held_loss(cfg, coarse, fine)
        if name == "mixed":
            mixed = (cfg_path, cfg, copy.deepcopy(coarse), copy.deepcopy(fine), counts)
        st = init_train_state(coarse, fine, float(cfg.optimizer.lr),
                              opt_type=str(cfg.optimizer.type))
        step = step_of(cfg, coarse, fine, batch)
        torch.cuda.reset_peak_memory_stats()
        step_ms = host_ms(torch, lambda: step(st, store, gen), n=3)
        peak_step = torch.cuda.max_memory_allocated() / 2**30
        print(f"phase 18: {name}: a step's device time by part")
        profile_steps(torch, lambda: step(st, store, gen), (
            {"kernel 4 bf16": KERNEL4_BF16_NAMES} if opt is not None
            else {"kernel 2 bf16": FIELD_FWD_BF16_NAMES, "kernel 3 bf16": FIELD_BWD_BF16_NAMES}
            if name == "mixed" else {}), n=2)
        del st, step, coarse, fine
        e_counts, metrics, e_secs = eval_cli(cfg_path, ck_path, os.path.join(tmp, f"eval-{name}"),
                                             ["--test-set"], dev)
        e_psnr = metrics["mean"]["psnr"] if metrics else float("nan")
        rows[name] = dict(overrides=over, step_ms=round(step_ms, 3),
                          peak_step_gib=round(peak_step, 2), peak_cli_gib=round(peak_cli, 2),
                          cli_s=round(secs, 2), held_loss=[round(before, 6), round(after, 6)],
                          eval_psnr=round(e_psnr, 3), eval_s=round(e_secs, 2),
                          launches={k: v for k, v in counts.items() if v},
                          eval_launches={k: v for k, v in e_counts.items() if v})
        print(f"phase 18: {name}: " + json.dumps(rows[name]) + f"; loss first {losses[0]:.5f} "
              f"last {losses[-1]:.5f}; validation psnr {val}")
        n2 = FAMILY_ITERS
        checks = {
            f"{FAMILY_ITERS} finite losses": len(losses) == FAMILY_ITERS
            and bool(np.isfinite(losses).all()),
            "loss on the fixed batch falls from the seeded init": after < before,
            ".ckpt after the last step, the optimizer's state in it": ck["step"] == FAMILY_ITERS
            and (("optimizer_state_dict" in ck) if (opt or "Adam") in ("Adam", "AdamW")
                 else ck.get(PORT_OPTIMIZER_KEY, {}).get("type") == opt),
            "apps.eval --test-set scores one view": metrics is not None
            and len(metrics["per_image"]) == 1 and bool(np.isfinite(e_psnr)),
        }
        if opt is not None:
            checks[f"kernel 4's bf16 route {2 * n2} times, kernel 1 at validation and eval"] = (
                counts["fused_train_loss_bf16"] == counts["fused_train_loss"] == 2 * n2
                and counts["fused_mlp"] == counts["fused_mlp_train"] == 0
                and counts["fused_render_bf16"] >= 2 and e_counts["fused_render_bf16"] == 2)
        elif name == "mixed":
            checks[f"kernels 2 and 3's bf16 routes {n2} times each (the coarse pass), kernels "
                   "1 and 4 never"] = (
                counts["fused_mlp_bf16"] == counts["fused_mlp"] == n2
                and counts["fused_mlp_train_bf16"] == counts["fused_mlp_train"] == n2
                and counts["fused_train_loss"] == counts["fused_render"] == 0
                and not any(e_counts.values()))
        else:
            checks["no kernel launched (kernels 1-4 read 0)"] = (
                not any(counts.values()) and not any(e_counts.values()))
        run_checks(f"phase 18 {name}", checks)

    # ---- (b) kernels 2 and 3 on the mixed run's coarse pass, both routes
    cfg_path, cfg, coarse, fine, mixed_counts = mixed
    s_train = render_settings_from_cfg(cfg, "train")
    gen = torch.Generator(device=dev).manual_seed(SEED)  # its own batch, as phase 7's
    idx = torch.randint(0, store.num_rays, (batch,), generator=gen, device=dev)
    rays, target = take_ray_batch(store, idx)
    draws = draw_render_noise(batch, s_train, gen, dev)
    o, d, v = (t.contiguous() for t in rays[:3])
    z = jittered_z_vals(rays, s_train, draws)
    pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    kw = dict(log_sampling_xyz=s_train.log_sampling_xyz, log_sampling_dir=s_train.log_sampling_dir)
    from dexnerf_tpu_torch.ops import fused_mlp as fm

    leaf = fm.fused_field_reference(coarse, pts, v, **kw).detach().requires_grad_(True)
    out = composite(leaf, z, ray_dists(z, d), sigma_noise=draws.noise_coarse)
    g = torch.autograd.grad(torch.mean((out.rgb - target) ** 2), leaf)[0].contiguous()
    hold = field_pass_hold(f"phase 18: mixed config, coarse pass ({batch} rays x {z.shape[1]} "
                           "samples)", coarse, pts, v, g, kw, torch, dev)
    entries = field_entries("mixed-paper", "bf16", (mixed_counts["fused_mlp_bf16"],
                                                    mixed_counts["fused_mlp_train_bf16"]), hold)

    # ---- (c) the mixed config's step at pallas_compute_dtype float32 vs plain, on
    # (b)'s rays and draws. The coarse leaves are kernel 3's, held in (b); the
    # fine PaperNeRF's are plain on both sides and move with the depths its
    # pass resamples from the coarse weights (6.7e-5 to 3.1e-4 of their
    # largest entry on 12 batches), so the leaves are printed and the loss held
    cfg32 = load_config(cfg_path)
    cfg32.nerf.pallas_compute_dtype = "float32"
    params = [p for m in (coarse, fine) for p in m.parameters()]
    names = [f"{t}.{n}" for t, m in (("coarse", coarse), ("fine", fine))
             for n, _ in m.named_parameters()]

    def loss_grads(coarse_field):
        result = render_rays(coarse, fine, rays, s_train, draws, coarse_field=coarse_field)
        loss = nerf_loss(result, target)[0]
        return loss.detach(), torch.autograd.grad(loss, params)

    zero_counts()
    cf, ff = maybe_fused_fields(cfg32, coarse, fine, train=True)
    loss_k, grads_k = loss_grads(cf)
    torch.cuda.synchronize()
    counts32 = read_counts()
    loss_p, grads_p = loss_grads(None)
    leaves = {n_: (float((gk - gp).abs().max()), float(gp.abs().max()))
              for n_, gk, gp in zip(names, grads_k, grads_p)}
    e_loss = abs(float(loss_k) - float(loss_p))
    print(f"phase 18: mixed config at pallas_compute_dtype float32, one step's loss and "
          f"gradients through kernels 2 and 3 (coarse) vs the plain autograd step on the same "
          f"draws: loss {float(loss_k):.7f} vs {float(loss_p):.7f}; launches "
          + json.dumps({k: c for k, c in counts32.items() if c}))
    print_leaves(leaves, "printed: the coarse leaves are held in (b)")
    run_checks("phase 18 mixed float32 step", {
        "fine field plain (PaperNeRF), coarse through the f32 kernels": ff is None
        and cf is not None,
        "kernels 2 and 3's f32 routes once each, nothing else": counts32["fused_mlp"] == 1
        and counts32["fused_mlp_train"] == 1 and counts32["fused_mlp_bf16"] == 0
        and counts32["fused_mlp_train_bf16"] == 0 and sum(counts32.values()) == 2,
        f"loss within {TRAIN_LOSS_RTOL:g}": e_loss <= TRAIN_LOSS_RTOL * abs(float(loss_p)),
        "every leaf finite": all(bool(torch.isfinite(gk).all()) for gk in grads_k),
    })
    entries += field_entries("mixed-paper-f32", "f32", (
        counts32["fused_mlp"] - counts32["fused_mlp_bf16"],
        counts32["fused_mlp_train"] - counts32["fused_mlp_train_bf16"]), hold)
    del coarse, fine, cf, grads_k, grads_p

    # ---- (d) each optimizer's updates on the card vs the CPU, on shared gradients
    _, base_c, base_f, _ = run_models(shared.cfg_path, shared.logdir, TRAIN_ITERS, dev)
    cpu_store = build_ray_store(*train_views, device="cpu")
    cpu_gen = torch.Generator().manual_seed(SEED)
    s_opt = render_settings_from_cfg(cfg0, "train")
    cpu_draws = [StepDraws(torch.randint(0, cpu_store.num_rays, (OPT_RAYS,), generator=cpu_gen),
                           draw_render_noise(OPT_RAYS, s_opt, cpu_gen, "cpu"))
                 for _ in range(OPT_STEPS)]
    cpu_step = make_train_step(s_opt, OPT_RAYS)
    lr = float(cfg0.optimizer.lr)
    opt_rows = {}
    for opt in OPTIMIZER_REGISTRY:
        cpu = init_train_state(copy.deepcopy(base_c).cpu(), copy.deepcopy(base_f).cpu(), lr,
                               opt_type=opt)
        on_card = init_train_state(copy.deepcopy(base_c), copy.deepcopy(base_f), lr,
                                   opt_type=opt)
        pairs = [(pc, ph) for mc, mh in ((on_card.coarse, cpu.coarse), (on_card.fine, cpu.fine))
                 for pc, ph in zip(mc.parameters(), mh.parameters())]
        for dr in cpu_draws:
            cpu_step(cpu, cpu_store, draws=[dr])  # the CPU's step leaves its gradients
            for pc, ph in pairs:
                pc.grad = ph.grad.to(dev)
            for group in on_card.optimizer.param_groups:
                group["lr"] = on_card.schedule(on_card.step)
            on_card.optimizer.step()
            on_card.step += 1
        worst_p = worst_s = 0.0
        for pc, ph in pairs:
            worst_p = max(worst_p, float((pc.detach().cpu() - ph.detach()).abs().max())
                          / float(ph.detach().abs().max()))
            sc, sh_ = on_card.optimizer.state[pc], cpu.optimizer.state[ph]
            for k in sh_:
                if k == "step" or not torch.is_tensor(sh_[k]):
                    continue
                worst_s = max(worst_s, float((sc[k].cpu() - sh_[k]).abs().max())
                              / max(float(sh_[k].abs().max()), 1e-30))
        opt_rows[opt] = [float(f"{worst_p:.3e}"), float(f"{worst_s:.3e}")]
    print(f"phase 18: {OPT_STEPS} updates of each optimizer on the card vs the CPU, on the "
          f"CPU's plain-path gradients from phase 6's weights ({OPT_RAYS} rays a step), "
          f"[worst parameter, worst state] error over its leaf's largest entry (limits "
          f"{OPT_PARAM_RTOL:g}, {OPT_STATE_RTOL:g}): " + json.dumps(opt_rows))
    run_checks("phase 18 optimizers card vs CPU", {
        f"{k} within its limits": p <= OPT_PARAM_RTOL and s <= OPT_STATE_RTOL
        for k, (p, s) in opt_rows.items()})
    del base_c, base_f, cpu_store

    # ---- (e) apps.tiny on the card
    out_dir = os.path.join(tmp, "tiny")
    zero_counts()
    t0 = time.perf_counter()
    tiny_app.main(["--iters", str(TINY_ITERS), "--display-every", str(TINY_ITERS // 4),
                   "--outdir", out_dir, "--device", dev.type])
    tiny_s = time.perf_counter() - t0
    tiny_counts = read_counts()
    psnr = np.loadtxt(os.path.join(out_dir, "psnr.txt"))
    print(f"phase 18: apps.tiny, {TINY_ITERS} iterations on the card in {tiny_s:.2f} s "
          f"({1e3 * tiny_s / TINY_ITERS:.3f} ms an iteration with the hold-out renders, host "
          f"clock); hold-out PSNR {psnr[:, 1].round(3).tolist()} at "
          f"{psnr[:, 0].astype(int).tolist()}")
    run_checks("phase 18 apps.tiny", {
        "hold-out PSNR rises": psnr[-1, 1] > psnr[0, 1],
        "render PNGs written": os.path.exists(
            os.path.join(out_dir, f"render_{TINY_ITERS - 1:05d}.png")),
        "no kernel launched": not any(tiny_counts.values()),
    })
    print(f"phase 18: steps (host clock, mean of 3) and peak memory on {card}: " + json.dumps(
        {k: [r["step_ms"], r["peak_step_gib"]] for k, r in rows.items()}))
    return entries


def perturb_train_cameras(base, np, torch):
    """Move each train view's camera of the messytable scene at ``base`` (in
    place: its ``meta.pkl`` w2c) by a known twist, ``c2w' = se3_exp(eps) @
    c2w``, eps of rotation std POSE_EPS[0] and translation std POSE_EPS[1].
    Returns eps [n, 6] in the loader's view order."""
    import pickle

    from dexnerf_tpu_torch.core.lie import se3_exp

    rng = np.random.default_rng(SEED)
    train = os.path.join(base, "train")
    views = sorted(os.listdir(train))
    eps = np.concatenate([rng.normal(scale=POSE_EPS[0], size=(len(views), 3)),
                          rng.normal(scale=POSE_EPS[1], size=(len(views), 3))], 1)
    for view, e in zip(views, eps):
        path = os.path.join(train, view, "meta.pkl")
        with open(path, "rb") as f:
            meta = pickle.load(f)
        moved = se3_exp(torch.tensor(e, dtype=torch.float64)).numpy() @ np.linalg.inv(
            meta["extrinsic_l"])
        meta["extrinsic_l"] = np.linalg.inv(moved)
        with open(path, "wb") as f:
            pickle.dump(meta, f)
    return eps.astype(np.float32)


def pose_recovery(torch, np, dev):
    """The JAX package's pose-recovery check (``tests/test_pose_opt.py``) at
    its sizes on ``dev``: targets rendered by the port's renderer at 4
    views of 16x16 of the analytic scene (8 + 8 samples, deterministic, the
    field the model), the cameras moved by known twists (std 0.04 and
    0.08), then RECOVERY_STEPS pose-only Adam steps (lr 1e-2) of
    RECOVERY_RAYS uniform rays. Returns the mean twist error against the
    ideal correction ``se3_log(T_true @ inv(T_moved))`` before and after,
    the last loss and the mean twist norm."""
    from dexnerf_tpu_torch.core import lie
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.data.synthetic import analytic_field, make_synthetic_scene
    from dexnerf_tpu_torch.render.renderer import (
        RenderSettings,
        draw_render_noise,
        render_image,
        render_rays,
    )
    from dexnerf_tpu_torch.train import pose_opt as po
    from dexnerf_tpu_torch.train.step import nerf_loss

    class Analytic(torch.nn.Module):
        """The encoded features start with the raw xyz: the field needs no weights."""

        def forward(self, xyz_enc, dir_enc=None):
            return analytic_field(xyz_enc[..., :3])

    s = RenderSettings(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                       num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    model = Analytic()
    _, _, poses, hwf = make_synthetic_scene(num_views=4, height=16, width=16, device=dev)
    true = torch.as_tensor(poses, device=dev)
    with torch.no_grad():
        images = torch.stack([render_image(model, model, *get_ray_bundle_c2w(*hwf, c2w), 2.0,
                                           6.0, s).fine.rgb for c2w in true])
    rng = np.random.default_rng(7)
    eps = torch.tensor(np.concatenate([rng.normal(scale=0.04, size=(4, 3)),
                                       rng.normal(scale=0.08, size=(4, 3))], 1),
                       dtype=torch.float32, device=dev)
    moved = lie.matmul3(lie.se3_exp(eps), true)
    ideal = lie.se3_log(lie.matmul3(true, lie.se3_inverse(moved)))
    store = po.build_pose_ray_store(images.cpu().numpy(), moved.cpu().numpy(), hwf, 2.0, 6.0,
                                    device=dev)
    pose = po.init_pose_state(4, 1e-2, 250, 0.1, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    for _ in range(RECOVERY_STEPS):
        idx = torch.randint(0, store.num_rays, (RECOVERY_RAYS,), generator=gen, device=dev)
        rays, target = po.pose_rays(store, pose.twists, idx)
        draws = draw_render_noise(RECOVERY_RAYS, s, gen, dev)
        loss = nerf_loss(render_rays(model, model, rays, s, draws), target)[0]
        pose.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pose.update()
    twists = pose.twists.detach()
    return (float(torch.linalg.norm(ideal, dim=-1).mean()),
            float(torch.linalg.norm(twists - ideal, dim=-1).mean()), float(loss.detach()),
            float(torch.linalg.norm(twists, dim=-1).mean()))


def cache_pose_phase(torch, np, card, dev, tmp, shared):
    """Phase 19, the ray cache and SE(3) pose refinement. (a) ``apps.cache``
    on phase 6's scene (CACHE_RAYS rays a shard), then ``apps.train`` of
    ``configs/lego-tpu.yml`` with ``dataset.cachedir`` pointed at it for
    CACHE_ITERS steps: the store built from the cache, kernel 4's bf16
    route twice a step and its f32 route never, kernel 1 at validation, the
    loss falling; kernel 4 on a cache batch vs plain (phase 7's rule), the
    store's build time, and a step on the cache store and on the resident
    store of the same views in turns (host clock). (b) ``apps.train
    --pose-opt`` of ``configs/messytable-obj.yml`` (``nerf.use_pallas:
    true``) on phase 14's scene with its train cameras moved by known
    twists, POSE_ITERS steps: the kernels bypassed with JAX's warning
    (kernels 2-6 never), kernel 1 at validation, ``pose_twist_norm`` above
    0, the twists in the ``.ckpt``; a pose step's host-clock ms, device time,
    idle share and peak memory; one pose step on the card held to the same
    step on the CPU by phase 18's rule (the loss; the updates of the twists
    and leaves on the CPU's gradients). (c) JAX's analytic pose-recovery
    check at its sizes on the card. (d) ``apps.eval --refined-poses`` on
    (b)'s checkpoint: two kernel-1 launches a train view, its first frame
    the refined camera's, and that frame's kernel vs plain (phase 3's
    rule). Returns the kernels-line entries of (a) and (d)."""
    import copy
    import shutil

    from PIL import Image

    from dexnerf_tpu_torch.apps import cache as cache_app
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import _rotate
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, build_ray_store_from_cache
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.render.renderer import (
        RenderDraws,
        draw_render_noise,
        make_ray_batch,
        render_image,
        render_rays,
    )
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.checkpoints import (
        POSE_KEY,
        load_adam_state,
        load_pose_checkpoint,
    )
    from dexnerf_tpu_torch.train.pose_opt import (
        build_pose_ray_store,
        c2w_from_w2c,
        camera_dirs,
        init_pose_state,
        pose_ray_source,
        pose_rays,
        refined_c2w,
    )
    from dexnerf_tpu_torch.train.step import (
        StepDraws,
        init_train_state,
        make_train_step,
        nerf_loss,
    )
    from dexnerf_tpu_torch.utils import cast_to_image

    bf16 = torch.bfloat16
    # ---- (a) the ray cache
    cachedir = os.path.join(tmp, "legocache")
    zero_counts()
    t0 = time.perf_counter()
    cache_app.main(["--datapath", shared.data, "--savedir", cachedir, "--num-random-rays",
                    str(CACHE_RAYS), "--device", dev.type])
    cache_s = time.perf_counter() - t0
    cache_counts = read_counts()
    built, build = [], ploop.build_ray_store_from_cache
    ploop.build_ray_store_from_cache = lambda *a, **k: built.append(a[0]) or build(*a, **k)
    try:
        cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb = train_cli(
            tmp, shared.data, "lego-cache", CACHE_ITERS, torch, dev,
            dataset={"cachedir": cachedir})
    finally:
        ploop.build_ray_store_from_cache = build
    cfg = load_config(cfg_path)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    t0 = time.perf_counter()
    store = build_ray_store_from_cache(cachedir, near, far, device=dev)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    shards = len(os.listdir(os.path.join(cachedir, "train")))
    print(f"phase 19 (a): apps.cache on phase 6's scene: {shards} train shards of {CACHE_RAYS} "
          f"rays in {cache_s:.2f} s; the store of {store.num_rays} rows built in {build_ms:.1f} "
          f"ms (host clock to synchronize); apps.train from the cache, {CACHE_ITERS} steps in "
          f"{secs:.2f} s, launches {json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; validation psnr {val_psnr}")
    run_checks("phase 19 (a) training from the ray cache", {
        f"{TRAIN_VIEWS[0]} shards, {TRAIN_VIEWS[0] * CACHE_RAYS} rows, no kernel in apps.cache":
            shards == TRAIN_VIEWS[0] and store.num_rays == TRAIN_VIEWS[0] * CACHE_RAYS
            and not any(cache_counts.values()),
        "the run's store built from the cache": built == [cachedir],
        f"kernel 4's bf16 route {2 * CACHE_ITERS} times, its f32 route never":
            counts["fused_train_loss_bf16"] == counts["fused_train_loss"] == 2 * CACHE_ITERS,
        "validations at steps 0 and last, each 2 launches of kernel 1's bf16 route":
            len(val_psnr) == 2 and counts["fused_render_bf16"] == counts["fused_render"] == 4,
        f"{CACHE_ITERS} finite losses": len(losses) == CACHE_ITERS
        and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
    })
    _, coarse, fine, _ = run_models(cfg_path, logdir, CACHE_ITERS, dev)
    s_train = render_settings_from_cfg(cfg, "train")
    batch, lr = int(cfg.nerf.train.num_random_rays), float(cfg.optimizer.lr)
    k4 = hold_train_bf16("phase 19 (a): kernel 4 bf16 route on a cache batch", 19,
                         (coarse, fine), store, s_train, lr, batch, 3.0 * batch, {}, torch, dev)
    scene = ploop.load_scene(cfg)
    resident = build_ray_store(scene.images[scene.i_train], scene.poses[scene.i_train],
                               scene.hwf, near, far, device=dev)
    st = init_train_state(copy.deepcopy(coarse), copy.deepcopy(fine), lr)
    step = make_train_step(s_train, batch, fused_loss=ftl.make_fused_train_loss(
        st.coarse, st.fine, s_train, compute_dtype=bf16, dw_dtype=bf16))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    turns = {"resident": [], "cache": []}
    for name in ("resident", "cache", "cache", "resident"):
        turns[name].append(round(host_ms(torch, lambda: step(
            st, resident if name == "resident" else store, gen), n=5), 3))
    del st, step, resident
    print(f"phase 19 (a): ms on {card}: a kernel-4 bf16 step (host clock around synchronize, "
          f"mean of 5, in turns resident, cache, cache, resident) {json.dumps(turns)}; the "
          f"held batch's passes " + json.dumps({k: round(v, 3) for k, v in k4.ms.items()}))
    entries = [train_entry("fused_train_loss_bf16@lego-cache", counts["fused_train_loss_bf16"],
                           k4)]

    # ---- (b) pose refinement on phase 14's scene, its train cameras moved
    data = os.path.join(tmp, "messytable-moved")
    shutil.copytree(os.path.join(tmp, "messytable"), data)
    eps = perturb_train_cameras(data, np, torch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb = train_cli(
            tmp, data, "messytable-pose", POSE_ITERS, torch, dev, config=CONFIG,
            flags=["--pose-opt"], use_pallas=True)
    said = {str(w.message) for w in caught if "pose_opt" in str(w.message)}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        norms = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/pose_twist_norm"]
    ckpt = os.path.join(logdir, "checkpoints", f"checkpoint_{POSE_ITERS - 1:07d}.ckpt")
    cfg, coarse, fine, ck = run_models(cfg_path, logdir, POSE_ITERS, dev)
    twists = ck[POSE_KEY]["twists"]
    ideal = -torch.tensor(eps)  # the correction: se3_log(T @ inv(exp(eps) @ T)) = -eps
    err_ideal = float((twists - ideal).norm(dim=-1).mean())
    print(f"phase 19 (b): apps.train --pose-opt on messytable-obj (phase 14's scene, its "
          f"{len(eps)} train cameras moved by twists of std {POSE_EPS}): {POSE_ITERS} steps in "
          f"{secs:.2f} s, launches {json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; pose_twist_norm first {norms[0]:.3e} last "
          f"{norms[-1]:.3e}; mean twist error vs -eps {err_ideal:.4f} (at 0: "
          f"{float(ideal.norm(dim=-1).mean()):.4f}); the warning: {sorted(said)}")
    run_checks("phase 19 (b) pose training", {
        "JAX's warning that the fused kernels are bypassed": said == {
            "pose_opt needs ray-input gradients; the fused Pallas train kernels are bypassed "
            "(XLA path)"},
        "kernels 2-6 never launched": all(v == 0 for k, v in counts.items()
                                          if not k.startswith("fused_render")),
        "validations at steps 0 and last, each 2 launches of kernel 1's bf16 route":
            len(val_psnr) == 2 and counts["fused_render_bf16"] == counts["fused_render"] == 4,
        f"{POSE_ITERS} finite losses": len(losses) == POSE_ITERS
        and bool(np.isfinite(losses).all()),
        "pose_twist_norm logged each step, finite, above 0": len(norms) == POSE_ITERS
        and bool(np.isfinite(norms).all()) and min(norms) > 0.0,
        "the .ckpt holds the twists after the last step": ck[POSE_KEY]["step"] == POSE_ITERS
        and tuple(twists.shape) == (len(eps), 6) and bool(torch.isfinite(twists).all()),
    })

    scene = ploop.load_scene(cfg)
    tr = scene.i_train
    s_train = render_settings_from_cfg(cfg, "train")
    batch, lr = int(cfg.nerf.train.num_random_rays), float(cfg.optimizer.lr)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    pose_lr = float(ploop._get(cfg.optimizer, "pose_lr", 1e-3))

    def state_on(device):
        """The run's last state (models, Adam, twists, their Adam) on
        ``device``, from a copy of the checkpoint (Adam updates its moments
        in place)."""
        ck_ = copy.deepcopy(ck)
        c, f_ = copy.deepcopy(coarse).to(device), copy.deepcopy(fine).to(device)
        state = init_train_state(c, f_, lr, float(cfg.scheduler.lr_decay),
                                 float(cfg.scheduler.lr_decay_factor))
        load_adam_state(state.optimizer, ck_["optimizer_state_dict"])
        state.step = int(ck_["step"])
        state.pose = init_pose_state(len(tr), pose_lr, float(cfg.scheduler.lr_decay),
                                     float(cfg.scheduler.lr_decay_factor), device)
        load_pose_checkpoint(state.pose, ck_)
        return state, build_pose_ray_store(scene.images[tr], scene.poses[tr], scene.hwf, near,
                                           far, device=device, intrinsics=scene.intrinsics[tr])

    st, store = state_on(dev)
    step = make_train_step(s_train, batch, ray_source=pose_ray_source)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ms = {"pose_step": host_ms(torch, lambda: step(st, store, gen), n=5)}
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 19 (b): a pose step (batch {batch}, {s_train.num_coarse} + "
          f"{s_train.num_fine}, plain f32 fields, TF32 off):")
    summary = {}
    profile_steps(torch, lambda: step(st, store, gen), {}, summary=summary)
    span, idle = summary.get("span", float("nan")), summary.get("idle", float("nan"))
    del st, step

    # one pose step on the card against the CPU's, on the CPU's draws and gradients
    on_card, card_store = state_on(dev)
    on_cpu, cpu_store = state_on("cpu")
    cpu_gen = torch.Generator().manual_seed(SEED)
    d_cpu = StepDraws(torch.randint(0, cpu_store.num_rays, (batch,), generator=cpu_gen),
                      draw_render_noise(batch, s_train, cpu_gen, "cpu"))
    d_card = StepDraws(d_cpu.idx.to(dev), RenderDraws(
        *[None if t is None else t.to(dev) for t in d_cpu.render]))
    with torch.no_grad():
        rays, target = pose_rays(card_store, on_card.pose.twists, d_card.idx)
        loss_card = float(nerf_loss(render_rays(on_card.coarse, on_card.fine, rays, s_train,
                                                d_card.render), target)[0])
    loss_cpu = float(make_train_step(s_train, batch, ray_source=pose_ray_source)(
        on_cpu, cpu_store, draws=[d_cpu])["loss"])
    leaves = [(pc, ph) for mc, mh in ((on_card.coarse, on_cpu.coarse),
                                      (on_card.fine, on_cpu.fine))
              for pc, ph in zip(mc.parameters(), mh.parameters())]
    for pc, ph in [*leaves, (on_card.pose.twists, on_cpu.pose.twists)]:
        pc.grad = ph.grad.to(dev)
    for group in on_card.optimizer.param_groups:
        group["lr"] = on_card.schedule(on_card.step)
    on_card.optimizer.step()
    on_card.step += 1
    on_card.pose.update()

    def worst(pairs, state_of):
        w_p = w_s = 0.0
        for pc, ph in pairs:
            w_p = max(w_p, float((pc.detach().cpu() - ph.detach()).abs().max())
                      / float(ph.detach().abs().max()))
            sc, sh_ = state_of(pc, ph)
            for k in sh_:
                if k != "step" and torch.is_tensor(sh_[k]):
                    w_s = max(w_s, float((sc[k].cpu() - sh_[k]).abs().max())
                              / max(float(sh_[k].abs().max()), 1e-30))
        return w_p, w_s

    leaf_err = worst(leaves, lambda pc, ph: (on_card.optimizer.state[pc],
                                             on_cpu.optimizer.state[ph]))
    twist_err = worst([(on_card.pose.twists, on_cpu.pose.twists)],
                      lambda pc, ph: (on_card.pose.optimizer.state[pc],
                                      on_cpu.pose.optimizer.state[ph]))
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"phase 19 (b): ms on {card}: pose step {ms['pose_step']:.3f} (host "
          f"clock around synchronize, mean of 5), device busy {span - idle:.3f} of a "
          f"{span:.3f} span, idle {idle:.3f} ({idle / span:.1%} of the span), peak "
          f"{peak_step:.2f} GiB (max_memory_allocated); one step card vs CPU on the CPU's draws: "
          f"loss {loss_card:.7f} vs {loss_cpu:.7f} (rel {loss_err:.2e}, limit "
          f"{TRAIN_LOSS_RTOL:g}); on the CPU's gradients, [worst parameter, worst state] over "
          f"the leaf's largest entry: leaves {leaf_err}, twists {twist_err} (limits "
          f"{OPT_PARAM_RTOL:g}, {OPT_STATE_RTOL:g})")
    run_checks("phase 19 (b) pose step card vs CPU", {
        f"loss within {TRAIN_LOSS_RTOL:g}": loss_err <= TRAIN_LOSS_RTOL,
        "leaves' updates within their limits": leaf_err[0] <= OPT_PARAM_RTOL
        and leaf_err[1] <= OPT_STATE_RTOL,
        "twists' update within its limits": twist_err[0] <= OPT_PARAM_RTOL
        and twist_err[1] <= OPT_STATE_RTOL,
    })
    del on_card, on_cpu, card_store, cpu_store

    # ---- (c) pose recovery on the card
    t0 = time.perf_counter()
    err0, err1, rec_loss, rec_norm = pose_recovery(torch, np, dev)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    print(f"phase 19 (c): pose recovery (JAX's check, {RECOVERY_STEPS} steps of "
          f"{RECOVERY_RAYS} rays) in {rec_s:.2f} s: mean twist error {err0:.4f} -> {err1:.4f}, "
          f"last loss {rec_loss:.3e}, twist norm {rec_norm:.4f}")
    run_checks("phase 19 (c) pose recovery", {
        "twist error under half its start": err1 < 0.5 * err0,
        "loss finite, twists moved": np.isfinite(rec_loss) and rec_norm > 0.0,
    })

    # ---- (d) apps.eval --refined-poses on (b)'s checkpoint
    savedir = os.path.join(tmp, "eval-refined")
    e_counts, _, e_secs = eval_cli(cfg_path, ckpt, savedir, ["--refined-poses"], dev)
    frames = sorted(f for f in os.listdir(savedir) if f.endswith(".png"))
    s_val = render_settings_from_cfg(cfg, "validation").eval_variant()
    H, W = int(scene.hwf[0]), int(scene.hwf[1])
    T = refined_c2w(torch.as_tensor(c2w_from_w2c(scene.poses[tr])), twists)[0].to(dev)
    K = torch.as_tensor(scene.intrinsics[tr][0], device=dev)
    rd = _rotate(camera_dirs(H, W, K), T[:3, :3])
    ro = T[:3, 3].expand(rd.shape)
    impl = ploop.fused_render_impl(cfg, s_val, dev, coarse, fine)
    with torch.inference_mode():
        direct = render_image(coarse, fine, ro, rd, near, far, s_val, rays_impl=impl)
    png = np.asarray(Image.open(os.path.join(savedir, "0000.png")), np.int16)
    png_err = int(np.abs(png - cast_to_image(direct.fine.rgb.cpu().numpy()).astype(np.int16))
                  .max())
    print(f"phase 19 (d): apps.eval --refined-poses, {len(frames)} frames in {e_secs:.2f} s "
          f"(first call); launches {json.dumps(e_counts)}; frame 0 vs a direct render at the "
          f"refined camera: max {png_err} levels")
    run_checks("phase 19 (d) evaluation at the refined poses", {
        f"one frame a train view ({len(tr)})": len(frames) == len(tr),
        "2 launches of kernel 1's bf16 route a frame, nothing else":
            e_counts["fused_render_bf16"] == e_counts["fused_render"] == 2 * len(frames)
            and all(v == 0 for k, v in e_counts.items() if not k.startswith("fused_render")),
        "frame 0 is the refined camera's (within 1 level)": png_err <= 1,
    })
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    rays = make_ray_batch(ro, rd, near, far)
    calibrate_on((vc, vf), rays, s_val, torch)
    err, f_ms, b_ms, b_by = hold_frame("phase 19 (d): the first refined-pose frame", vc, vf, rays,
                                       s_val, torch)
    print(f"phase 19 (d): ms on {card}: " + json.dumps({k: round(v, 3) for k, v in f_ms.items()}))
    entries.append(render_entry("fused_render_bf16@refined-poses", e_counts["fused_render_bf16"],
                                err, f_ms, b_ms, b_by))
    return entries


def _rank_state(cfg_path, ckpt_path, dev, torch):
    """A rank's set-up for phase 20 (c): the config's train store of the
    views on ``dev``, its train settings and batch, and a function that
    builds a fresh state from the checkpoint with kernel 4's bf16 loss."""
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.checkpoints import read_reference_checkpoint
    from dexnerf_tpu_torch.train.step import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(cfg_path)
    scene = ploop.load_scene(cfg)
    tr = scene.i_train
    store = build_ray_store(scene.images[tr], scene.poses[tr], scene.hwf,
                            float(cfg.dataset.near), float(cfg.dataset.far), device=dev)
    ck = read_reference_checkpoint(ckpt_path)
    s = render_settings_from_cfg(cfg, "train")

    def fresh():
        coarse, fine = ploop.setup_models(cfg, 0, dev)
        coarse.load_state_dict(ck["coarse"])
        fine.load_state_dict(ck["fine"])
        st = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        loss = ftl.make_fused_train_loss(coarse, fine, s, compute_dtype=torch.bfloat16,
                                         dw_dtype=torch.bfloat16)
        return st, loss

    return store, s, int(cfg.nerf.train.num_random_rays), fresh


def rank_one_nccl(mesh, cfg_path, ckpt_path, steps):
    """Phase 20 (c), one NCCL rank: ``make_parallel_train_step`` and
    ``make_train_step`` from one checkpoint on the same draws through
    kernel 4's bf16 route, ``steps`` updates each; returns whether every
    parameter, Adam moment and metric is equal in every bit, the parallel
    step's kernel-4 launches per update, and both steps' host-clock ms."""
    import torch

    from dexnerf_tpu_torch.data.pipeline import uniform_ray_indices
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.parallel.sharding import make_parallel_train_step
    from dexnerf_tpu_torch.render.renderer import draw_render_noise
    from dexnerf_tpu_torch.train.step import StepDraws, make_train_step

    dev = mesh.device
    store, s, batch, fresh = _rank_state(cfg_path, ckpt_path, dev, torch)
    (a, loss_a), (b, loss_b) = fresh(), fresh()
    par = make_parallel_train_step(mesh, s, batch, fused_loss=loss_a)
    one = make_train_step(s, batch, fused_loss=loss_b)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches, same_metrics = [], True
    for _ in range(steps):
        d = StepDraws(uniform_ray_indices(store, batch, gen), draw_render_noise(batch, s, gen, dev))
        ftl.launches = ftl.launches_bf16 = 0
        ma = par(a, store, draws=[d])
        torch.cuda.synchronize()
        launches.append((ftl.launches_bf16, ftl.launches))
        mb = one(b, store, draws=[d])
        same_metrics &= all(torch.equal(ma[k], mb[k]) for k in mb) and set(ma) == set(mb)
    pa = [p for g in a.optimizer.param_groups for p in g["params"]]
    pb = [p for g in b.optimizer.param_groups for p in g["params"]]
    same_params = all(torch.equal(x, y) for x, y in zip(pa, pb))
    same_state = all(torch.equal(a.optimizer.state[x][k], b.optimizer.state[y][k])
                     for x, y in zip(pa, pb) for k in ("exp_avg", "exp_avg_sq"))
    gen_a = torch.Generator(device=dev).manual_seed(SEED)
    ms = {"parallel_1rank": host_ms(torch, lambda: par(a, store, gen_a), n=5),
          "make_train_step": host_ms(torch, lambda: one(b, store, gen_a), n=5)}
    # the field path (nerf.pallas_fused_loss: false): kernels 2 and 3 in the rank's step
    from dexnerf_tpu_torch.config import load_config
    from dexnerf_tpu_torch.ops import fused_mlp, fused_mlp_train
    from dexnerf_tpu_torch.train import loop as ploop

    cfg = load_config(cfg_path)
    cfg.nerf.pallas_fused_loss = False
    (c, _), (e, _) = fresh(), fresh()
    par_f = make_parallel_train_step(mesh, s, batch, **dict(zip(
        ("coarse_field", "fine_field"), ploop.maybe_fused_fields(cfg, c.coarse, c.fine, train=True))))
    one_f = make_train_step(s, batch, **dict(zip(
        ("coarse_field", "fine_field"), ploop.maybe_fused_fields(cfg, e.coarse, e.fine, train=True))))
    d = StepDraws(uniform_ray_indices(store, batch, gen), draw_render_noise(batch, s, gen, dev))
    for m in (fused_mlp, fused_mlp_train, ftl):
        m.launches = m.launches_bf16 = 0
    mc = par_f(c, store, draws=[d])
    torch.cuda.synchronize()
    field_launches = {"kernel2_bf16": fused_mlp.launches_bf16, "kernel2": fused_mlp.launches,
                      "kernel3_bf16": fused_mlp_train.launches_bf16,
                      "kernel3": fused_mlp_train.launches, "kernel4": ftl.launches}
    me = one_f(e, store, draws=[d])
    same_field = (all(torch.equal(mc[k], me[k]) for k in me) and all(
        torch.equal(x, y) for x, y in zip(c.optimizer.param_groups[0]["params"],
                                          e.optimizer.param_groups[0]["params"])))
    return {"same_params": same_params, "same_state": same_state, "same_metrics": same_metrics,
            "launches": launches, "ms": ms, "backend": mesh.backend, "batch": batch,
            "field_launches": field_launches, "same_field": same_field}


def rank_two_gloo(mesh, cfg_path, ckpt_path):
    """Phase 20 (c), two gloo ranks on the one card: one update of
    ``make_parallel_train_step`` at the config's global batch on the
    generator of seed SEED (each rank its half of the single-device step's
    draws), through kernel 4's bf16 route; returns the averaged gradients
    and the parameters after it (on the CPU), the metrics, the launches and
    a step's host-clock ms."""
    import torch

    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.parallel.sharding import make_parallel_train_step

    dev = mesh.device
    store, s, batch, fresh = _rank_state(cfg_path, ckpt_path, dev, torch)
    st, loss = fresh()
    par = make_parallel_train_step(mesh, s, batch, fused_loss=loss)
    ftl.launches = ftl.launches_bf16 = 0
    m = par(st, store, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = (ftl.launches_bf16, ftl.launches)
    out = {
        "grads": {f"{name}.{k}": p.grad.detach().cpu() for name, model in
                  (("coarse", st.coarse), ("fine", st.fine)) for k, p in model.named_parameters()},
        "params": [p.detach().cpu() for p in st.optimizer.param_groups[0]["params"]],
        "metrics": {k: float(v) for k, v in m.items()}, "launches": launches,
    }
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out["ms"] = host_ms(torch, lambda: par(st, store, gen), n=5)
    return out


def sgir_parallel_phase(torch, np, card, dev, tmp, shared):
    """Phase 20, active-IR SG shading and data-parallel training. (a)
    ``apps.train --sg-ir`` of ``configs/messytable-obj.yml``
    (``nerf.use_pallas: true``) on phase 14's scene, SG_ITERS steps: the
    shaded loss supersedes every training kernel (kernels 2-6 never, as in
    JAX), validations through kernel 1's bf16 route, the loss finite and
    falling, the SG leaves and their Adam state in the ``.ckpt``; a step's
    host-clock ms, device time, idle share and peak memory; one step on the
    card held to the CPU's: its loss, the card's own gradients of every
    field and SG leaf (to GRAD_RTOL of the leaf's largest entry), and the
    update on the CPU's gradients by phase 18's rule. (b) ``apps.eval --test-set
    --sg-ir`` on that checkpoint: two kernel-1 launches a frame, an IR PNG a
    frame equal to a direct render, the IR frame timed; kernel 1 on the
    frame vs plain (phase 3's rule). (c) ``make_parallel_train_step`` at one
    NCCL rank equal in every bit to ``make_train_step`` on the same draws
    through kernel 4's bf16 route (2 launches a step); two gloo ranks on the
    one card at phase 6's global batch held to the one-rank step by phase
    7's rule, their parameters equal in every bit; kernel 4 on a rank's
    batch vs plain. (d) ``apps.train --num-devices 2`` on the one card
    raises ``make_mesh``'s words. Returns the kernels-line entries."""
    import copy

    from PIL import Image

    from dexnerf_tpu_torch.apps import train as train_app
    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_w2c
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.pipeline import (
        build_ray_store,
        take_ray_batch,
        uniform_ray_indices,
    )
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.parallel.mesh import spawn_ranks
    from dexnerf_tpu_torch.render import sg_ir
    from dexnerf_tpu_torch.render.renderer import (
        RenderDraws,
        draw_render_noise,
        jittered_z_vals,
        make_ray_batch,
    )
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.checkpoints import SG_KEY, load_adam_state, load_sg_checkpoint
    from dexnerf_tpu_torch.train.step import StepDraws, init_train_state, make_train_step
    from dexnerf_tpu_torch.utils import cast_to_gray_image

    bf16 = torch.bfloat16
    # ---- (a) apps.train --sg-ir on phase 14's scene
    data = os.path.join(tmp, "messytable")
    cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb = train_cli(
        tmp, data, "messytable-sgir", SG_ITERS, torch, dev, config=CONFIG,
        dataset={"depth_valid_max": DEX_VALID_MAX}, flags=["--sg-ir"], use_pallas=True)
    ckpt = os.path.join(logdir, "checkpoints", f"checkpoint_{SG_ITERS - 1:07d}.ckpt")
    cfg, coarse, fine, ck = run_models(cfg_path, logdir, SG_ITERS, dev)
    entry = ck.get(SG_KEY, {})
    print(f"phase 20 (a): apps.train --sg-ir on messytable-obj (phase 14's scene, "
          f"nerf.use_pallas: true): {SG_ITERS} steps in {secs:.2f} s, launches "
          f"{json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}; validation psnr (luminance) {val_psnr}; the .ckpt's SG leaves "
          + json.dumps({k: [round(float(x), 5) for x in v.flatten()[:4]]
                        for k, v in entry.get("params", {}).items()}))
    run_checks("phase 20 (a) sg-ir training", {
        "kernels 2-6 never launched": all(v == 0 for k, v in counts.items()
                                          if not k.startswith("fused_render")),
        "validations at steps 0 and last, each 2 launches of kernel 1's bf16 route":
            len(val_psnr) == 2 and counts["fused_render_bf16"] == counts["fused_render"] == 4,
        f"{SG_ITERS} finite losses": len(losses) == SG_ITERS and bool(np.isfinite(losses).all()),
        "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
        "the .ckpt holds the 5 SG leaves and their Adam state after the last step":
            sorted(entry.get("params", {})) == sorted(sg_ir.SG_LEAVES)
            and all(int(entry["state"][k]["step"]) == SG_ITERS for k in sg_ir.SG_LEAVES)
            and all(bool(torch.isfinite(v).all()) for v in entry["params"].values()),
    })
    scene = ploop.load_scene(cfg)
    tr = scene.i_train
    s_train = render_settings_from_cfg(cfg, "train")
    batch, lr = int(cfg.nerf.train.num_random_rays), float(cfg.optimizer.lr)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    falloff = bool(ploop._get(cfg.nerf.train, "sg_distance_falloff", True))

    def state_on(device):
        """The run's last state (models, SG leaves, their Adam) on ``device``
        from a copy of the checkpoint, its store and its shaded loss."""
        ck_ = copy.deepcopy(ck)
        sgp = sg_ir.init_sg_ir_params(torch.Generator().manual_seed(0), device=device)
        st = init_train_state(copy.deepcopy(coarse).to(device), copy.deepcopy(fine).to(device),
                              lr, float(cfg.scheduler.lr_decay),
                              float(cfg.scheduler.lr_decay_factor), sg=sgp)
        load_adam_state(st.optimizer, ck_["optimizer_state_dict"])
        load_sg_checkpoint(sgp, st.optimizer, "Adam", ck_)
        st.step = int(ck_["step"])
        store = build_ray_store(scene.images[tr], scene.poses[tr], scene.hwf, near, far,
                                device=device, intrinsics=scene.intrinsics[tr])
        loss = sg_ir.make_sg_ir_loss(st.coarse, st.fine, sgp, s_train, distance_falloff=falloff)
        return st, store, loss

    st, store, loss = state_on(dev)
    step = make_train_step(s_train, batch, fused_loss=loss)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms = host_ms(torch, lambda: step(st, store, gen), n=5)
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    step_counts = read_counts()
    print(f"phase 20 (a): an sg-ir step (batch {batch}, {s_train.num_coarse} + "
          f"{s_train.num_fine}, plain f32 fields with the point gradients of the normals, TF32 "
          f"off):")
    summary = {}
    profile_steps(torch, lambda: step(st, store, gen), {}, summary=summary)
    span, idle = summary.get("span", float("nan")), summary.get("idle", float("nan"))
    del st, step

    on_card, card_store, card_loss = state_on(dev)
    on_cpu, cpu_store, cpu_loss = state_on("cpu")
    cpu_gen = torch.Generator().manual_seed(SEED)
    d_cpu = StepDraws(torch.randint(0, cpu_store.num_rays, (batch,), generator=cpu_gen),
                      draw_render_noise(batch, s_train, cpu_gen, "cpu"))
    d_card = StepDraws(d_cpu.idx.to(dev), RenderDraws(
        *[None if t is None else t.to(dev) for t in d_cpu.render]))
    rays, target = take_ray_batch(card_store, d_card.idx)
    card_leaf = card_loss(rays, target, d_card.render)[0]
    loss_card = float(card_leaf.detach())
    loss_cpu = float(make_train_step(s_train, batch, fused_loss=cpu_loss)(
        on_cpu, cpu_store, draws=[d_cpu])["loss"])
    pairs = [(pc, ph) for gc, gh in zip(on_card.optimizer.param_groups,
                                        on_cpu.optimizer.param_groups)
             for pc, ph in zip(gc["params"], gh["params"])]
    # the card's own backward (the σ point gradients of the normals, the
    # shading's ties, every field and SG leaf) vs the CPU step's gradients
    names = {id(p): f"{m}.{k}" for m, mod in (("coarse", on_card.coarse), ("fine", on_card.fine))
             for k, p in mod.named_parameters()}
    names.update({id(p): f"sg.{k}" for k, p in on_card.sg.items()})
    card_grads = torch.autograd.grad(card_leaf, [pc for pc, _ in pairs])
    grad_ratio = {}
    for (pc, ph), g in zip(pairs, card_grads):
        err = float((g.cpu() - ph.grad).abs().max())
        grad_ratio[names[id(pc)]] = (err / max(float(ph.grad.abs().max()), 1e-30)
                                     if bool(torch.isfinite(g).all()) else float("inf"))
    worst_leaf = max(grad_ratio, key=grad_ratio.get)
    del card_leaf, card_grads
    for pc, ph in pairs:
        pc.grad = ph.grad.to(dev)
    for group in on_card.optimizer.param_groups:
        group["lr"] = on_card.schedule(on_card.step)
    on_card.optimizer.step()
    w_p = w_s = 0.0
    for pc, ph in pairs:
        scale = max(float(ph.detach().abs().max()), 1e-30)
        w_p = max(w_p, float((pc.detach().cpu() - ph.detach()).abs().max()) / scale)
        sc, sh_ = on_card.optimizer.state[pc], on_cpu.optimizer.state[ph]
        for k in ("exp_avg", "exp_avg_sq"):
            w_s = max(w_s, float((sc[k].cpu() - sh_[k]).abs().max())
                      / max(float(sh_[k].abs().max()), 1e-30))
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"phase 20 (a): ms on {card}: sg-ir step {step_ms:.3f} (host clock around "
          f"synchronize, mean of 5; launches {json.dumps(step_counts)}), device busy "
          f"{span - idle:.3f} of a {span:.3f} span, idle {idle:.3f} ({idle / span:.1%} of the "
          f"span), peak {peak_step:.2f} GiB (max_memory_allocated); one step card vs CPU on the "
          f"CPU's draws: loss {loss_card:.7f} vs {loss_cpu:.7f} (rel {loss_err:.2e}, limit "
          f"{TRAIN_LOSS_RTOL:g}); the card's own gradients vs the CPU's, worst leaf {worst_leaf} "
          f"at {grad_ratio[worst_leaf]:.2e} of its largest entry (limit {GRAD_RTOL:g}, "
          f"{len(grad_ratio)} leaves); on the CPU's gradients, worst parameter {w_p:.2e} and worst "
          f"Adam moment {w_s:.2e} of the leaf's largest entry (fields and SG leaves; limits "
          f"{OPT_PARAM_RTOL:g}, {OPT_STATE_RTOL:g})")
    run_checks("phase 20 (a) sg-ir step card vs CPU", {
        "no kernel in the timed steps": not any(step_counts.values()),
        f"loss within {TRAIN_LOSS_RTOL:g}": loss_err <= TRAIN_LOSS_RTOL,
        f"every gradient leaf (fields and SG) finite and within {GRAD_RTOL:g} of its largest "
        "entry": all(r <= GRAD_RTOL for r in grad_ratio.values()),
        "the update within its limits": w_p <= OPT_PARAM_RTOL and w_s <= OPT_STATE_RTOL,
    })
    del on_card, on_cpu, card_store, cpu_store, store

    # ---- (b) apps.eval --test-set --sg-ir on (a)'s checkpoint
    savedir = os.path.join(tmp, "eval-sgir")
    e_counts, _, e_secs = eval_cli(cfg_path, ckpt, savedir, ["--test-set", "--sg-ir"], dev)
    frames = sorted(f for f in os.listdir(savedir) if f.endswith(".png"))
    irs = sorted(os.listdir(os.path.join(savedir, "ir")))
    s_val = render_settings_from_cfg(cfg, "validation").eval_variant()
    idx = int(np.asarray(scene.i_test).ravel()[0])
    H, W = int(scene.hwf[0]), int(scene.hwf[1])
    ro, rd = get_ray_bundle_w2c(H, W, torch.as_tensor(scene.poses[idx], device=dev),
                                torch.as_tensor(scene.intrinsics[idx], device=dev))
    sgp = {k: v.to(dev) for k, v in ck[SG_KEY]["params"].items()}

    def ir_frame():
        return sg_ir.render_sg_ir_image(coarse, fine, sgp, ro, rd, near, far, s_val,
                                        distance_falloff=falloff)

    torch.cuda.reset_peak_memory_stats()
    ir = ir_frame()
    ir_ms = host_ms(torch, ir_frame, n=2)
    ir_peak = torch.cuda.max_memory_allocated() / 2**30
    png = np.asarray(Image.open(os.path.join(savedir, "ir", "0000.png")), np.int16)
    png_err = int(np.abs(png - cast_to_gray_image(ir.cpu().numpy()).astype(np.int16)).max())
    print(f"phase 20 (b): apps.eval --test-set --sg-ir, {len(frames)} frame(s) and {len(irs)} IR "
          f"PNG(s) in {e_secs:.2f} s (first call); launches {json.dumps(e_counts)}; the IR frame "
          f"({H}x{W}, 64 + 64, plain f32 with the normals' backward) {ir_ms:.1f} ms on the host "
          f"clock (mean of 2), peak {ir_peak:.2f} GiB, luminance in "
          f"[{float(ir.min()):.4f}, {float(ir.max()):.4f}]; the PNG vs a direct render: max "
          f"{png_err} levels")
    run_checks("phase 20 (b) IR evaluation", {
        "one RGB frame and one IR PNG a test view": len(frames) == len(irs) == 1,
        "2 launches of kernel 1's bf16 route a frame, nothing else":
            e_counts["fused_render_bf16"] == e_counts["fused_render"] == 2 * len(frames)
            and all(v == 0 for k, v in e_counts.items() if not k.startswith("fused_render")),
        "the IR frame finite and non-negative": bool(torch.isfinite(ir).all())
        and float(ir.min()) >= 0.0,
        "the IR PNG equals a direct render (within 1 level)": png_err <= 1,
    })
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    vrays = make_ray_batch(ro, rd, near, far)
    calibrate_on((vc, vf), vrays, s_val, torch)
    err, f_ms, b_ms, b_by = hold_frame("phase 20 (b): the sg-ir test frame", vc, vf, vrays, s_val,
                                       torch)
    print(f"phase 20 (b): ms on {card}: " + json.dumps({k: round(v, 3) for k, v in f_ms.items()}))
    entries = [render_entry("fused_render_bf16@sg-ir", counts["fused_render_bf16"]
                            + e_counts["fused_render_bf16"], err, f_ms, b_ms, b_by)]

    # ---- (c) make_parallel_train_step: one NCCL rank, then two gloo ranks on the one card
    lego_ckpt = os.path.join(shared.logdir, "checkpoints", f"checkpoint_{TRAIN_ITERS - 1:07d}.ckpt")
    t0 = time.perf_counter()
    (one,) = spawn_ranks(rank_one_nccl, 1, "cuda", (shared.cfg_path, lego_ckpt, RANK_STEPS),
                         timeout=RANK_TIMEOUT)
    one_s = time.perf_counter() - t0
    print(f"phase 20 (c): make_parallel_train_step at 1 rank over {one['backend']} vs "
          f"make_train_step, {RANK_STEPS} updates of lego-tpu (batch {one['batch']}) on the same "
          f"draws through kernel 4 bf16 ({one_s:.1f} s with the spawn): parameters equal "
          f"{one['same_params']}, Adam moments equal {one['same_state']}, metrics equal "
          f"{one['same_metrics']}; (bf16, all) launches a step {one['launches']}; ms on {card} "
          f"(host clock, mean of 5) {json.dumps({k: round(v, 3) for k, v in one['ms'].items()})}"
          f"; the field path (pallas_fused_loss: false), one update: launches "
          f"{json.dumps(one['field_launches'])}, equal to make_train_step's in every bit "
          f"{one['same_field']}")
    run_checks("phase 20 (c) one NCCL rank", {
        "NCCL": one["backend"] == "nccl",
        "parameters, Adam moments and metrics equal in every bit": one["same_params"]
        and one["same_state"] and one["same_metrics"],
        "2 launches of kernel 4's bf16 route a step, no f32": all(
            l == (2, 2) for l in one["launches"]),
        "the field path: kernels 2 and 3's bf16 routes twice each, kernel 4 never, equal in "
        "every bit": one["field_launches"] == {"kernel2_bf16": 2, "kernel2": 2, "kernel3_bf16": 2,
                                               "kernel3": 2, "kernel4": 0} and one["same_field"],
    })
    t0 = time.perf_counter()
    two = spawn_ranks(rank_two_gloo, 2, "cuda", (shared.cfg_path, lego_ckpt),
                      devices=["cuda:0", "cuda:0"], backend="gloo", timeout=RANK_TIMEOUT)
    two_s = time.perf_counter() - t0
    # the one-rank step at the global batch on the same generator, and the
    # f32 plain version of each pass on its samples
    store, s, gbatch, fresh = _rank_state(shared.cfg_path, lego_ckpt, dev, torch)
    st, loss = fresh()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = StepDraws(uniform_ray_indices(store, gbatch, gen),
                  draw_render_noise(gbatch, s, gen, dev))
    m_one = make_train_step(s, gbatch, fused_loss=loss)(st, store, draws=[d])
    rays, target = take_ray_batch(store, d.idx)
    o, dd, v = (t.contiguous() for t in rays[:3])
    target = target.contiguous()
    kw = dict(supervision="rgb", white_background=s.white_background)
    base = fresh()[0]  # the weights the one-rank step differentiated
    z_c = jittered_z_vals(rays, s, d.render)
    args_c = (base.coarse, o, dd, z_c, v, ray_dists(z_c, dd), d.render.noise_coarse, target)
    with torch.no_grad():
        _, w_c, _ = ftl.fused_pass_loss(*args_c, compute_dtype=bf16, dw_dtype=bf16, **kw)
    z_f, _ = hierarchical_z_vals(z_c, w_c, s.num_fine, det=False, u=d.render.u_fine)
    args_f = (base.fine, o, dd, z_f, v, ray_dists(z_f, dd), d.render.noise_fine, target)
    norm = 3.0 * gbatch
    got, want, want_f32 = {}, {}, {}
    for name, model, args in (("coarse", st.coarse, args_c), ("fine", st.fine, args_f)):
        plain = ftl.fused_pass_loss_reference(*args, **kw)
        for (k, p), gp in zip(model.named_parameters(), plain[3]):
            key = f"{name}.{k}"
            got[key] = two[0]["grads"][key].to(dev)
            want[key], want_f32[key] = p.grad, gp / norm
    same = all(torch.equal(a, b) for a, b in zip(two[0]["params"], two[1]["params"]))
    loss_err = abs(two[0]["metrics"]["loss"] - float(m_one["loss"])) / float(m_one["loss"])
    print(f"phase 20 (c): 2 gloo ranks on the one card ({two_s:.1f} s with the spawn), one update "
          f"at the global batch {gbatch} ({gbatch // 2} a rank): loss {two[0]['metrics']['loss']:.7f}"
          f" vs the one-rank step's {float(m_one['loss']):.7f} (rel {loss_err:.2e}); (bf16, all) "
          f"launches {[r['launches'] for r in two]}; the ranks' parameters equal {same}; a step "
          f"{[round(r['ms'], 3) for r in two]} ms a rank on {card} (host clock, mean of 5; the "
          f"two ranks share the card and the gloo reduction goes through the host)")
    hold_to_own("phase 20 (c): the 2-rank averaged gradients vs the one-rank step's at the global "
                "batch (phase 7's rule, own = |one-rank step - f32 plain|),", got, want, want_f32,
                torch)
    run_checks("phase 20 (c) two gloo ranks", {
        "2 launches of kernel 4's bf16 route a rank": all(r["launches"] == (2, 2) for r in two),
        f"loss within {TRAIN_LOSS_RTOL:g} of the one-rank step's": loss_err <= TRAIN_LOSS_RTOL,
        "the ranks' parameters equal in every bit": same,
    })
    lego_cfg, lego_c, lego_f, _ = run_models(shared.cfg_path, shared.logdir, TRAIN_ITERS, dev)
    del st, base
    k4 = hold_train_bf16("phase 20 (c): kernel 4 bf16 route on a rank's batch", 20,
                         (lego_c, lego_f), store, s, float(lego_cfg.optimizer.lr), gbatch // 2,
                         3.0 * gbatch // 2, {}, torch, dev)
    del store
    launches = sum(l[0] for l in one["launches"]) + sum(r["launches"][0] for r in two)
    entries.append(train_entry("fused_train_loss_bf16@rank-step", launches, k4))

    # ---- (d) --num-devices 2 on the one card
    try:
        train_app.main(["--config", cfg_path, "--device", "cuda", "--sg-ir", "--num-devices", "2",
                        "--max-iters", "1"])
        said = None
    except ValueError as e:
        said = str(e)
    print(f"phase 20 (d): apps.train --num-devices 2 on {torch.cuda.device_count()} card: {said!r}")
    run_checks("phase 20 (d) two devices asked of one card", {
        "make_mesh's words": said == f"requested 2 devices, have {torch.cuda.device_count()}",
    })
    return entries


def write_seeded_blender(basedir, seed, dev):
    """A blender-format scene (transforms JSONs + PNGs) of
    ``make_synthetic_scene(seed=seed)``'s views, TRAIN_VIEWS of them at
    TRAIN_HW x TRAIN_HW, rendered on ``dev``: the seed sets the cameras'
    elevations, so two seeds give two scenes of equal ray counts."""
    import numpy as np
    from PIL import Image

    from dexnerf_tpu_torch.data.synthetic import make_synthetic_scene

    images, _, poses, hwf = make_synthetic_scene(
        num_views=sum(TRAIN_VIEWS), height=TRAIN_HW, width=TRAIN_HW, seed=seed, device=dev)
    angle = float(2.0 * np.arctan(0.5 * hwf[1] / hwf[2]))
    idx = 0
    for split, n in zip(("train", "val", "test"), TRAIN_VIEWS):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        frames = []
        for k in range(n):
            rel = f"./{split}/r_{k}"
            Image.fromarray((np.clip(images[idx], 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(basedir, f"{rel}.png"))
            frames.append({"file_path": rel, "transform_matrix": poses[idx].tolist()})
            idx += 1
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)


def _multiscene_state(cfg_paths, ckpt_paths, dev):
    """Phase 21's one-process multi-scene set-up on ``dev``: the scenes'
    stacked train stores, a state of the checkpoints' weights (fresh Adam),
    the train settings and the batch."""
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.parallel import multiscene as ms
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.checkpoints import read_reference_checkpoint

    cfgs = [load_config(p) for p in cfg_paths]
    stores, params = [], []
    for cfg, ck in zip(cfgs, ckpt_paths):
        scene = ploop.load_scene(cfg)
        tr = scene.i_train
        stores.append(build_ray_store(scene.images[tr], scene.poses[tr], scene.hwf,
                                      float(cfg.dataset.near), float(cfg.dataset.far),
                                      device=dev))
        w = read_reference_checkpoint(ck)
        params.append({"coarse": w["coarse"], "fine": w["fine"]})
    coarse, fine = ploop.setup_models(cfgs[0], 0, dev)
    stacked = ms.stack_params([{n: {k: v.to(dev) for k, v in p[n].items()} for n in p}
                               for p in params])
    state = ms.init_multi_scene_state(coarse, fine, stacked, float(cfgs[0].optimizer.lr))
    return (state, ms.stack_ray_stores(stores), render_settings_from_cfg(cfgs[0], "train"),
            int(cfgs[0].nerf.train.num_random_rays))


def _stacked_grads(state):
    """The stacked gradient of every leaf, by ``coarse.<name>`` /
    ``fine.<name>``."""
    return {f"{n}.{k}": p.grad for n, sd in state.params.items() for k, p in sd.items()}


def rank_multiscene(mesh, cfg_paths, ckpt_paths, layout):
    """Phase 21 (c), one rank of ``make_multi_scene_parallel_train_step`` on
    the ``layout`` (scene rows, ranks a row) on the one card: one update of
    this rank's scenes (scene ``j`` drawn from a generator of seed SEED +
    j, this rank's slice of its batch); returns the row-averaged gradients,
    the parameters, the metrics and a step's host-clock ms (on the CPU). At
    one NCCL rank, also whether that update equals the one-process
    ``make_multi_scene_train_step``'s on the same draws in every bit."""
    import torch

    from dexnerf_tpu_torch.parallel import multiscene as ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    full, store, s, batch = _multiscene_state(cfg_paths, ckpt_paths, dev)
    smesh = ms.make_scene_data_mesh(*layout, mesh)
    state, local = ms.shard_multi_scene(full, store, smesh)
    m_local = local.num_scenes
    scenes = list(range(smesh.scene_index * m_local, (smesh.scene_index + 1) * m_local))
    step = ms.make_multi_scene_parallel_train_step(smesh, s, batch)

    def gens(seed):
        return [torch.Generator(device=dev).manual_seed(seed + j) for j in scenes]

    m = step(state, local, gens(SEED))
    torch.cuda.synchronize()
    out = {"scenes": scenes, "backend": mesh.backend, "data_index": smesh.data_index,
           "grads": {k: g.detach().cpu() for k, g in _stacked_grads(state).items()},
           "params": [p.detach().cpu() for p in state.leaves()],
           "metrics": {k: v.cpu() for k, v in m.items()}}
    if mesh.world_size == 1:
        one, _, _, _ = _multiscene_state(cfg_paths, ckpt_paths, dev)
        m1 = ms.make_multi_scene_train_step(s, batch)(one, store, gens(SEED))
        out["same"] = {
            "metrics": set(m1) == set(m) and all(torch.equal(m1[k], m[k]) for k in m),
            "gradients": all(torch.equal(a.grad, b.grad)
                             for a, b in zip(one.leaves(), state.leaves())),
            "parameters": all(torch.equal(a, b) for a, b in zip(one.leaves(), state.leaves())),
            "Adam moments": all(
                torch.equal(one.optimizer.state[a][k], state.optimizer.state[b][k])
                for a, b in zip(one.leaves(), state.leaves())
                for k in ("exp_avg", "exp_avg_sq")),
        }
        del one
    g = gens(SEED + 100)
    out["ms"] = host_ms(torch, lambda: step(state, local, g), n=3)
    return out


def _f64_grads(cfg, ckpt, store, draws, settings, dev):
    """One scene's float64 gradients of the plain render + loss (the
    checkpoint's weights, ``store``'s rows and ``draws`` cast to float64),
    by leaf ``coarse.<name>`` / ``fine.<name>``, on the CPU."""
    import torch

    from dexnerf_tpu_torch.data.pipeline import take_ray_batch
    from dexnerf_tpu_torch.render.renderer import RayBatch, RenderDraws, render_rays
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.step import nerf_loss

    w = ploop.read_reference_checkpoint(ckpt)
    models = ploop.setup_models(cfg, 0, dev)
    for m, name in zip(models, ("coarse", "fine")):
        m.load_state_dict(w[name])
        m.double()
    rays, target = take_ray_batch(store, draws.idx)
    rays = RayBatch(*[t.double() for t in rays])
    render = RenderDraws(*[None if t is None else t.double() for t in draws.render])
    loss, _ = nerf_loss(render_rays(*models, rays, settings, render), target.double())
    loss.backward()
    out = {f"{n}.{k}": p.grad.cpu() for n, m in zip(("coarse", "fine"), models)
           for k, p in m.named_parameters()}
    del models, loss
    torch.cuda.empty_cache()
    return out


def hold_f32_to_own(title, got, want, want64, torch):
    """Each f32 gradient leaf of ``got`` (the same sums as ``want`` taken
    in another order: over ranks, or batched) held relative to f32's own
    effect, own = |want - float64| (``want64``): its distance to float64 at
    most F32_OWN_REL x own + F32_OWN_ATOL x the leaf's largest entry. Prints
    each leaf's [distance to ``want``, to float64, own] and raises if one
    is outside."""
    bad, lines = [], {}
    for key in want:
        a, b, f = got[key].double(), want[key].double(), want64[key]
        if a.shape != f.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{title} {key}: shape {tuple(a.shape)} or non-finite values")
        direct, err, own = (float((x - y).abs().max()) for x, y in ((a, b), (a, f), (b, f)))
        lines[key] = [float(f"{v:.3e}") for v in (direct, err, own)]
        if not err <= F32_OWN_REL * own + F32_OWN_ATOL * float(f.abs().max()):
            bad.append(key)
    print(f"{title} [max vs the one-process step; max vs float64; own max] (limit: vs float64 "
          f"<= {F32_OWN_REL:g} own + {F32_OWN_ATOL:g} x scale): " + json.dumps(lines))
    if bad:
        raise AssertionError(f"{title} outside f32's own rounding in {bad}")


def multiscene_phase(torch, np, card, dev, tmp):
    """Phase 21, multi-scene training and the multi-host entry. (a) Two
    scenes written from ``make_synthetic_scene``'s seeds 0 and 1 (phase 6's
    views and frame size) and two configs of ``configs/lego-tpu.yml`` (the
    same models and train render, their own datasets, logdirs and seeds)
    trained together by ``apps.multiscene --max-iters MS_ITERS
    --validate-every MS_VALIDATE`` on the card at 8192 rays a scene: the
    loss falls in each scene, kernel 1's bf16 route twice a scene a
    validation, kernels 2-6 never; each scene's ``.ckpt`` through
    ``apps.eval --test-set``; the multi-scene step's host-clock ms, device
    busy and idle time, launches and peak memory beside the single-scene
    plain step's on the same config; kernel 1 on a scene's validation frame
    vs plain (phase 3's rule). (b) One multi-scene step held to
    ``make_train_step``'s plain step of each scene on the same draws and
    weights: the loss within TRAIN_LOSS_RTOL, every gradient leaf within
    GRAD_RTOL of its largest entry (phase 7's rule; batched and unbatched
    products need not agree in every bit). (c) The ``(scene, rays)`` step
    as two gloo ranks sharing the card at MS_LAYOUTS, each held to the
    one-process step on the same draws by (b)'s rule, a row's ranks equal in
    every bit; one NCCL rank equal to the one-process step in every bit.
    (d) ``multihost.initialize`` with an explicit ``tcp://`` address in a
    process of its own: one NCCL rank, one ``all_reduce`` on the card; the
    no-op outside a cluster. Returns the kernels-line entries."""
    import copy

    import yaml

    from dexnerf_tpu_torch.apps import multiscene as ms_app
    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.data.pipeline import uniform_ray_indices
    from dexnerf_tpu_torch.parallel import multihost
    from dexnerf_tpu_torch.parallel import multiscene as ms
    from dexnerf_tpu_torch.parallel.mesh import free_port, spawn_ranks
    from dexnerf_tpu_torch.render.renderer import draw_render_noise, make_ray_batch
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.step import StepDraws, init_train_state, make_train_step

    # ---- (a) apps.multiscene on two written scenes
    with open(TRAIN_CONFIG) as f:
        base = yaml.safe_load(f)
    t0 = time.perf_counter()
    cfg_paths = []
    for seed in MS_SEEDS:
        data = os.path.join(tmp, f"multiscene-{seed}")
        write_seeded_blender(data, seed, dev)
        raw = copy.deepcopy(base)
        raw["dataset"].update(basedir=data, half_res=False, cachedir="")
        raw["experiment"].update(id=f"multiscene-{seed}", logdir=os.path.join(tmp, "logs"),
                                 randomseed=SEED + seed, print_every=1)
        cfg_paths.append(os.path.join(tmp, f"multiscene-{seed}.yml"))
        with open(cfg_paths[-1], "w") as f:
            yaml.safe_dump(raw, f)
    write_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    ms_app.main(["--configs", *cfg_paths, "--device", dev.type, "--max-iters", str(MS_ITERS),
                 "--validate-every", str(MS_VALIDATE)])
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    cfgs = [load_config(p) for p in cfg_paths]
    logdirs = [os.path.join(tmp, "logs", f"multiscene-{seed}") for seed in MS_SEEDS]
    ckpts = [os.path.join(d, "checkpoints", f"checkpoint_{MS_ITERS - 1:07d}.ckpt")
             for d in logdirs]
    runs = []
    for d in logdirs:
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        runs.append({
            "losses": [r["loss"] for r in recs if "loss" in r],
            "val": [(r["step"], r["val_psnr"]) for r in recs if "val_psnr" in r],
            "pngs": sorted(os.listdir(os.path.join(d, "validation"))),
        })
    n_val = MS_ITERS // MS_VALIDATE
    print(f"phase 21 (a): apps.multiscene, {len(MS_SEEDS)} scenes of lego-tpu.yml (seeds "
          f"{list(MS_SEEDS)}, {TRAIN_HW}x{TRAIN_HW}, {TRAIN_VIEWS[0]} train views each, written in "
          f"{write_s:.2f} s), {MS_ITERS} steps at {int(cfgs[0].nerf.train.num_random_rays)} rays "
          f"a scene in {run_s:.2f} s (first call, validations included); launches "
          f"{json.dumps(counts)}; peak {peak_gb:.2f} GiB; " + "; ".join(
              f"scene {i}: loss first {r['losses'][0]:.5f} last {r['losses'][-1]:.5f}, "
              f"validation psnr {r['val']}" for i, r in enumerate(runs)))
    checks = {
        f"kernel 1's bf16 route twice a scene a validation ({2 * len(MS_SEEDS) * n_val}), "
        "kernels 2-6 never": counts["fused_render_bf16"] == counts["fused_render"]
        == 2 * len(MS_SEEDS) * n_val and all(
            v == 0 for k, v in counts.items() if not k.startswith("fused_render")),
    }
    for i, (r, ck) in enumerate(zip(runs, ckpts)):
        checks[f"scene {i}: {MS_ITERS} finite losses, falling (mean of last 3 < first 3)"] = (
            len(r["losses"]) == MS_ITERS and bool(np.isfinite(r["losses"]).all())
            and np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3]))
        checks[f"scene {i}: validations at steps {MS_VALIDATE}..{MS_ITERS}, finite, a PNG "
               "each"] = ([s for s, _ in r["val"]] == list(range(MS_VALIDATE, MS_ITERS + 1,
                                                                 MS_VALIDATE))
                          and bool(np.isfinite([p for _, p in r["val"]]).all())
                          and len(r["pngs"]) == n_val)
        checks[f"scene {i}: its .ckpt"] = os.path.exists(ck)
    run_checks("phase 21 (a) multi-scene training", checks)
    eval_counts, eval_psnr = [], []
    for i, (p, ck) in enumerate(zip(cfg_paths, ckpts)):
        e_counts, metrics, e_secs = eval_cli(p, ck, os.path.join(tmp, f"eval-multiscene-{i}"),
                                             ["--test-set"], dev)
        eval_counts.append(e_counts)
        eval_psnr.append(metrics["mean"]["psnr"])
        print(f"phase 21 (a): apps.eval --test-set on scene {i}'s .ckpt, "
              f"{len(metrics['per_image'])} frame(s) in {e_secs:.2f} s: psnr "
              f"{metrics['mean']['psnr']:.3f}; launches {json.dumps(e_counts)}")
    run_checks("phase 21 (a) each scene's checkpoint through apps.eval", {
        "2 launches of kernel 1's bf16 route a frame, nothing else, finite psnr": all(
            c["fused_render_bf16"] == c["fused_render"] == 2 and all(
                v == 0 for k, v in c.items() if not k.startswith("fused_render"))
            and np.isfinite(p) for c, p in zip(eval_counts, eval_psnr)),
    })

    # the multi-scene step and the single-scene plain step: host clock, profile, memory
    state, store, s_train, batch = _multiscene_state(cfg_paths, ckpts, dev)
    step = ms.make_multi_scene_train_step(s_train, batch)
    gens = [torch.Generator(device=dev).manual_seed(SEED + j) for j in range(len(MS_SEEDS))]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(state, store, gens)
    # torch.func.vmap warns where an op has no batching rule and loops over the scenes
    fallback = sorted({str(w.message)[:160] for w in caught if "batching rule" in str(w.message)})
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ms_ms = host_ms(torch, lambda: step(state, store, gens), n=5)
    ms_peak = torch.cuda.max_memory_allocated() / 2**30
    step_counts = read_counts()
    print(f"phase 21 (a): the multi-scene step ({len(MS_SEEDS)} scenes x {batch} rays, "
          f"{s_train.num_coarse} + {s_train.num_fine}, plain f32 under torch.func.vmap, TF32 "
          f"off):")
    ms_sum = {}
    profile_steps(torch, lambda: step(state, store, gens), {}, summary=ms_sum)
    cfg0 = cfgs[0]
    one = ms.scene_train_state(state, 0)
    single = make_train_step(s_train, batch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scene0 = ms.scene_store(store, 0)
    torch.cuda.reset_peak_memory_stats()
    one_ms = host_ms(torch, lambda: single(one, scene0, gen), n=5)
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 21 (a): the single-scene plain step (1 scene x {batch} rays), as phase 8's "
          f"plain step:")
    one_sum = {}
    profile_steps(torch, lambda: single(one, scene0, gen), {}, summary=one_sum)

    def busy(summ):
        return summ.get("span", float("nan")) - summ.get("idle", float("nan"))

    nan = float("nan")
    print(f"phase 21 (a): ms on {card} (host clock around synchronize, mean of 5; busy and idle "
          f"from the profile of 3): multi-scene step {ms_ms:.3f} "
          f"({len(MS_SEEDS) * batch / ms_ms * 1e3:.0f} rays/s), busy {busy(ms_sum):.3f}, idle "
          f"{ms_sum.get('idle', nan):.3f} of a {ms_sum.get('span', nan):.3f} span, "
          f"{ms_sum.get('launches', nan):.0f} launches a step, peak {ms_peak:.2f} GiB; "
          f"single-scene plain step {one_ms:.3f} "
          f"({batch / one_ms * 1e3:.0f} rays/s), busy {busy(one_sum):.3f}, idle "
          f"{one_sum.get('idle', nan):.3f} of {one_sum.get('span', nan):.3f}, "
          f"{one_sum.get('launches', nan):.0f} launches a step, peak {one_peak:.2f} GiB; "
          f"launch counters over the timed multi-scene steps {json.dumps(step_counts)}; vmap "
          f"fallbacks {fallback}")
    run_checks("phase 21 (a) the timed steps", {
        "no kernel in the multi-scene steps": not any(step_counts.values()),
        "every op of the step batched by vmap (no fallback loop)": not fallback,
    })
    del one, single

    # kernel 1 on scene 0's validation frame (the weights calibrated as phase 3's)
    s_val = render_settings_from_cfg(cfg0, "validation").eval_variant()
    scene = ploop.load_scene(cfg0)
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    ro, rd = get_ray_bundle_c2w(H, W, focal, torch.as_tensor(scene.poses[scene.i_val[0]],
                                                             device=dev))
    vc, vf = ms.scene_models(state, 0)
    vrays = make_ray_batch(ro, rd, float(cfg0.dataset.near), float(cfg0.dataset.far))
    calibrate_on((vc, vf), vrays, s_val, torch)
    err, f_ms, b_ms, b_by = hold_frame("phase 21 (a): scene 0's validation frame", vc, vf, vrays,
                                       s_val, torch)
    print(f"phase 21 (a): ms on {card}: " + json.dumps({k: round(v, 3) for k, v in f_ms.items()}))
    entries = [render_entry("fused_render_bf16@multiscene", counts["fused_render_bf16"]
                            + sum(c["fused_render_bf16"] for c in eval_counts), err, f_ms, b_ms,
                            b_by)]
    del vc, vf, vrays

    # ---- (b) one multi-scene step vs the single-scene plain step of each scene
    state, store, _, _ = _multiscene_state(cfg_paths, ckpts, dev)
    draws = []
    for j in range(len(MS_SEEDS)):
        g = torch.Generator(device=dev).manual_seed(SEED + 7 + j)
        draws.append(StepDraws(uniform_ray_indices(store, batch, g),
                               draw_render_noise(batch, s_train, g, dev)))
    m_multi = step(state, store, draws=[draws])
    grads = _stacked_grads(state)
    leaves, loss_err = {}, []
    for j in range(len(MS_SEEDS)):
        c, f = ploop.setup_models(cfgs[j], 0, dev)
        w = ploop.read_reference_checkpoint(ckpts[j])
        c.load_state_dict(w["coarse"])
        f.load_state_dict(w["fine"])
        st = init_train_state(c, f, float(cfgs[j].optimizer.lr))
        m_one = make_train_step(s_train, batch)(st, ms.scene_store(store, j), draws=[draws[j]])
        loss_err.append(abs(float(m_multi["loss"][j]) - float(m_one["loss"]))
                        / float(m_one["loss"]))
        want = {f"{n}.{k}": p.grad for n, model in (("coarse", c), ("fine", f))
                for k, p in model.named_parameters()}
        for k, w in want.items():
            leaves[f"scene {j} {k}"] = (float((grads[k][j] - w).abs().max()),
                                        float(w.abs().max()))
        del st, c, f
    worst = max(leaves, key=lambda k: leaves[k][0] / max(leaves[k][1], 1e-30))
    print(f"phase 21 (b): one multi-scene step vs make_train_step's plain step of each scene on "
          f"the same draws and weights: loss rel err {[float(f'{e:.2e}') for e in loss_err]} "
          f"(limit {TRAIN_LOSS_RTOL:g}); worst leaf {worst} at "
          f"{leaves[worst][0] / leaves[worst][1]:.2e} of its largest entry")
    print_leaves(leaves)
    run_checks("phase 21 (b) the multi-scene step vs the single-scene step", {
        f"losses within {TRAIN_LOSS_RTOL:g}": all(e <= TRAIN_LOSS_RTOL for e in loss_err),
        f"every gradient leaf finite and within {GRAD_RTOL:g} of its largest entry": all(
            np.isfinite(e) and e <= GRAD_RTOL * m for e, m in leaves.values()),
    })
    del state, store, grads

    # ---- (c) the (scene, rays) step: one NCCL rank, then two gloo ranks on the one card
    # the one-process step on the ranks' draws (scene j's generator of seed
    # SEED + j), and each scene's float64 gradients on the same draws
    ref, ref_store, _, _ = _multiscene_state(cfg_paths, ckpts, dev)
    ref_draws = []
    for j in range(len(MS_SEEDS)):
        g = torch.Generator(device=dev).manual_seed(SEED + j)
        ref_draws.append(StepDraws(uniform_ray_indices(ref_store, batch, g),
                                   draw_render_noise(batch, s_train, g, dev)))
    m_ref = step(ref, ref_store, draws=[ref_draws])
    ref_grads = {k: g.detach().cpu() for k, g in _stacked_grads(ref).items()}
    ref_loss = m_ref["loss"].cpu()
    ref64 = [_f64_grads(cfgs[j], ckpts[j], ms.scene_store(ref_store, j), ref_draws[j], s_train,
                        dev) for j in range(len(MS_SEEDS))]
    del ref, ref_store, ref_draws
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (nccl,) = spawn_ranks(rank_multiscene, 1, "cuda", (cfg_paths, ckpts, (1, 1)),
                          timeout=RANK_TIMEOUT)
    nccl_s = time.perf_counter() - t0
    print(f"phase 21 (c): make_multi_scene_parallel_train_step at one {nccl['backend']} rank "
          f"(1 x 1) vs make_multi_scene_train_step on the same draws ({nccl_s:.1f} s with the "
          f"spawn): equal in every bit {json.dumps(nccl['same'])}; a step {nccl['ms']:.3f} ms on "
          f"{card} (host clock, mean of 3)")
    run_checks("phase 21 (c) one NCCL rank", {
        "NCCL": nccl["backend"] == "nccl",
        "metrics, gradients, parameters and Adam moments equal in every bit": all(
            nccl["same"].values()),
    })
    for layout in MS_LAYOUTS:
        t0 = time.perf_counter()
        out = spawn_ranks(rank_multiscene, 2, "cuda", (cfg_paths, ckpts, layout),
                          devices=["cuda:0", "cuda:0"], backend="gloo", timeout=RANK_TIMEOUT)
        secs = time.perf_counter() - t0
        got, want, want64, loss_err = {}, {}, {}, []
        for i, r in enumerate(out):
            for n_local, j in enumerate(r["scenes"]):
                loss_err.append(abs(float(r["metrics"]["loss"][n_local]) - float(ref_loss[j]))
                                / float(ref_loss[j]))
                for k, g in r["grads"].items():
                    key = f"rank {i} scene {j} {k}"
                    got[key], want[key], want64[key] = g[n_local], ref_grads[k][j], ref64[j][k]
        rows = {}
        for r in out:
            rows.setdefault(tuple(r["scenes"]), []).append(r["params"])
        same = all(all(torch.equal(a, b) for a, b in zip(g[0], other))
                   for g in rows.values() for other in g[1:])
        print(f"phase 21 (c): {layout[0]} x {layout[1]} on 2 gloo ranks sharing the card "
              f"({secs:.1f} s with the spawn): scenes a rank {[r['scenes'] for r in out]}, loss "
              f"rel err vs the one-process step {[float(f'{e:.2e}') for e in loss_err]}; a row's "
              f"ranks' parameters equal {same}; a step {[round(r['ms'], 3) for r in out]} ms a "
              f"rank on {card} (host clock, mean of 3; the ranks share the card, the gloo "
              f"reduction goes through the host)")
        hold_f32_to_own(f"phase 21 (c): {layout[0]} x {layout[1]}, the ranks' averaged "
                        "gradients vs the one-process step's,", got, want, want64, torch)
        run_checks(f"phase 21 (c) {layout[0]} x {layout[1]} gloo ranks", {
            "every scene on a rank": sorted({j for r in out for j in r["scenes"]})
            == list(range(len(MS_SEEDS))),
            f"losses within {TRAIN_LOSS_RTOL:g} of the one-process step's": all(
                e <= TRAIN_LOSS_RTOL for e in loss_err),
            "a row's ranks' parameters equal in every bit": same,
        })

    # ---- (d) multihost.initialize: one NCCL process by tcp://, the no-op outside a cluster
    port = free_port()
    worker = (
        "import sys, torch\n"
        "from dexnerf_tpu_torch.parallel import multihost\n"
        "from dexnerf_tpu_torch.parallel.mesh import all_reduce_sum\n"
        "assert multihost.initialize(coordinator_address=sys.argv[1], process_id=0)\n"
        "mesh = multihost.global_mesh()\n"
        "x = all_reduce_sum(mesh, torch.arange(4.0, device=mesh.device))\n"
        "torch.cuda.synchronize()\n"
        "assert x.tolist() == [0.0, 1.0, 2.0, 3.0], x\n"
        "print('WORKER', mesh.backend, mesh.device, mesh.world_size, multihost.process_count(),\n"
        "      multihost.is_primary(), multihost.local_device_count())\n"
        "multihost.shutdown()\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in multihost._CLUSTER_ENV_VARS}
    env.update(WORLD_SIZE="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", worker, f"127.0.0.1:{port}"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=MULTIHOST_TIMEOUT)
    said = [line for line in done.stdout.splitlines() if line.startswith("WORKER")]
    saved = {k: os.environ.pop(k) for k in multihost._CLUSTER_ENV_VARS if k in os.environ}
    try:
        noop = (multihost.initialize(), multihost.initialize(num_processes=1))
    finally:
        os.environ.update(saved)
    print(f"phase 21 (d): multihost.initialize(coordinator_address=tcp 127.0.0.1:{port}, "
          f"process_id=0) in a process of its own with WORLD_SIZE=1 "
          f"({time.perf_counter() - t0:.1f} s): exit {done.returncode}, {said} (backend, device, "
          f"world size, process count, primary, local devices); outside a cluster initialize() and "
          f"initialize(num_processes=1) gave {noop}. Two hosts cannot be tried here: the card's "
          f"machine has one H100, so no NCCL group over two or more cards has run."
          + (f"\n{done.stderr[-2000:]}" if done.returncode else ""))
    run_checks("phase 21 (d) multihost", {
        "one NCCL rank on the card, the all_reduce's sum": done.returncode == 0
        and len(said) == 1 and said[0].split()[1:4] == ["nccl", "cuda:0", "1"],
        "a no-op outside a cluster and at one process": noop == (False, False),
    })
    return entries


def wide_build_report(log, kernels=WIDE_KERNELS):
    """Registers, spill bytes and stack of each of ``kernels`` from ptxas's
    report in the build log: kernel (demangled enough) -> its lines."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = next((k for k in kernels if k in line), None)
            if name and "ILi" in line:
                name += "<" + line.split("ILi")[1].split("E")[0] + ">"
        elif name and ("spill" in line or "registers" in line):
            out[name] = (out.get(name, "") + " " + line.strip().replace("ptxas info    : ", ""))
            if "registers" in line:
                name = None
    return out


def check_train_f32(label, model, args, norm, torch, own=False):
    """Kernel 4's f32 route vs its plain f32 version on one pass (phase 7's
    rule: loss to TRAIN_LOSS_RTOL, weights and rgb to RTOL / ATOL, each
    gradient leaf to GRAD_RTOL of its largest entry). With ``own`` (the wide
    route: ~10^7 ReLU decisions a pass, of which a few within rounding of 0
    go the other way in each version) a leaf past GRAD_RTOL is held by the
    own-decision rule of ``perf_tools/field_f32_rule.py``, as kernel 3's
    (``pass_own_decision_ratios``, its float64 references summed over
    chunks of rays). Returns the largest max abs error."""
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl

    model.zero_grad(set_to_none=True)
    loss, w, rgb = ftl.fused_pass_loss(*args)
    (loss / norm).backward()
    torch.cuda.synchronize()
    want = ftl.fused_pass_loss_reference(*args)
    bad, leaves = [], {}
    if abs(float(loss.detach()) - float(want[0])) > TRAIN_LOSS_RTOL * abs(float(want[0])):
        bad.append("loss")
    worst = 0.0
    for key, a, b in (("weights", w, want[1]), ("rgb", rgb, want[2])):
        worst = max(worst, float((a - b).abs().max()))
        if not bool(torch.isfinite(a).all()) or bool(((a - b).abs() > ATOL + RTOL * b.abs()).any()):
            bad.append(key)
    past = []
    for (pname, p), gw in zip(model.named_parameters(), want[3]):
        gw = gw / norm
        err, scale = float((p.grad - gw).abs().max()), float(gw.abs().max())
        worst = max(worst, err)
        leaves[pname] = (err, scale)
        if not bool(torch.isfinite(p.grad).all()):
            bad.append(pname)
        elif err > GRAD_RTOL * scale:
            past.append(pname)
    print(f"{label}: f32 route vs plain, max abs err {worst:.3e}")
    print_leaves(leaves)
    if own and past:
        from perf_tools.field_f32_rule import pass_own_decision_ratios

        ratios, flips, layers = pass_own_decision_ratios(
            model, args[1:], [p.grad for p in model.parameters()],
            [gw / norm for gw in want[3]], past, norm=norm)
        print(f"  {label}: {len(past)} leaf/leaves past {GRAD_RTOL:g}, held by the own-decision "
              f"rule ({flips} ReLU decisions otherwise than the plain version); float64 error on "
              f"own decisions over its limit: "
              + json.dumps({k: float(f"{r:.3e}") for k, r in ratios.items()}))
        bad += [f"ReLU decisions of layer {i}" for i in layers]
        bad += [k for k, r in ratios.items() if r > 1.0]
    else:
        bad += past
    if bad:
        raise AssertionError(f"{label}: f32 route and plain differ in {bad}")
    return worst


def hold_fields_bf16(label, model, pts, v, g, torch, kw=None, want32=None):
    """Kernels 2 (raw) and 3 (every gradient leaf of ``sum(g raw)``) at bf16
    vs their bf16 plain versions, relative to the dtype's own effect
    (:func:`hold_to_own`; ``want32``, the f32 plain versions' raw and
    leaves, computed when not given; ``kw`` the encodings' sampling).
    Returns (kernel 2's, kernel 3's) max abs error."""
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt

    kw = dict(log_sampling_xyz=True, log_sampling_dir=True) if kw is None else kw
    bf = dict(compute_dtype=torch.bfloat16)
    bf2 = dict(bf, dw_dtype=torch.bfloat16)
    names = [n for n, _ in model.named_parameters()]
    raw = fm.fused_field(model, pts, v, **kw, **bf)
    grads = fmt._launch_backward(model, pts, v, g, **kw, **bf2)
    torch.cuda.synchronize()
    want = {"raw": fm.fused_field_reference(model, pts, v, **kw, **bf).detach(),
            **dict(zip(names, fmt.field_grads_reference(model, pts, v, g, **kw, **bf2)))}
    if want32 is None:
        want32 = {"raw": fm.fused_field_reference(model, pts, v, **kw).detach(),
                  **dict(zip(names, fmt.field_grads_reference(model, pts, v, g, **kw)))}
    errs = hold_to_own(f"{label}: bf16 routes of kernels 2 (raw) and 3 (leaves) vs plain,",
                       {"raw": raw, **dict(zip(names, grads))}, want, want32, torch)
    return errs.pop("raw"), max(errs.values())


def pass_cotangent(model, pts, z, d, v, target, norm, white_bg, torch):
    """The cotangent of a pass's loss (``sum((rgb - target)^2) / norm``)
    with respect to raw [N, S, 4], through the plain f32 field."""
    from dexnerf_tpu_torch.core.volrend import composite, ray_dists
    from dexnerf_tpu_torch.ops import fused_mlp as fm

    with torch.enable_grad():
        raw = fm.fused_field_reference(model, pts, v).detach().requires_grad_()
        out = composite(raw, z, ray_dists(z, d), white_background=white_bg)
        loss = torch.sum((out.rgb - target) ** 2) / norm
        return torch.autograd.grad(loss, raw)[0].contiguous()


def wide_phase(torch, np, card, dev, tmp, shared=None):
    """Phase 22 (see the module's docstring): the wide bf16 route at 8x256
    through ``apps.train`` and ``apps.serve``, held to the plain versions
    at 256 and at the widths of WIDE_WIDTHS, timed beside bounds and bf16
    ``torch.matmul``. ``shared`` is phase 6's (its scene), or None to
    write a scene. Returns the kernels-line entries of the wide route."""
    import copy

    import yaml
    from PIL import Image

    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.blender import pose_spherical
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
    from dexnerf_tpu_torch.render.renderer import (
        draw_render_noise,
        jittered_z_vals,
        make_ray_batch,
        render_image,
    )
    from dexnerf_tpu_torch.train.loop import load_scene
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

    bf16 = torch.bfloat16
    if shared is None:
        data = os.path.join(tmp, "scene")
        write_blender_dataset(data, TRAIN_HW, TRAIN_HW, TRAIN_VIEWS, device=dev)
    else:
        data = shared.data
    with open(TRAIN_CONFIG) as f:
        raw = yaml.safe_load(f)
    for blk in ("coarse", "fine"):
        raw["models"][blk]["hidden_size"] = WIDE_HIDDEN
    wide_cfg = os.path.join(tmp, "lego-tpu-8x256.yml")
    with open(wide_cfg, "w") as f:
        yaml.safe_dump(raw, f)
    report = wide_build_report(_build.build_log)
    print(f"phase 22: the wide kernels as built (ptxas): {json.dumps(report)}")

    # ---- the three training paths through the entry point, at bf16
    n = WIDE_ITERS
    runs = {}
    for name, nerf in (("kernel4", {}), ("fields", {"pallas_fused_loss": False}),
                       ("resample", {"pallas_loss_resample": "pallas"})):
        runs[name] = train_cli(tmp, data, f"wide-{name}", n, torch, dev, config=wide_cfg, **nerf)
        _, _, counts, losses, val, secs, peak = runs[name]
        print(f"phase 22: 8x256 {name}, {n} steps in {secs:.2f} s, peak {peak:.2f} GiB; "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}; loss first "
              f"{losses[0]:.5f} last {losses[-1]:.5f}; validation psnr {val}")
    c4, cf, cr = (runs[k][2] for k in ("kernel4", "fields", "resample"))

    def falls(k):
        losses, val = runs[k][3], runs[k][4]
        return (len(losses) == n and bool(np.isfinite(losses).all())
                and np.mean(losses[-3:]) < np.mean(losses[:3]) and len(val) >= 1
                and bool(np.isfinite(val).all()))

    run_checks("8x256 training", {
        f"kernel 4: its wide bf16 route {2 * n} times, nothing else but kernel 1":
            c4["fused_train_loss_wide"] == 2 * n == c4["fused_train_loss_bf16"]
            == c4["fused_train_loss"] and c4["fused_mlp"] == c4["fused_mlp_train"] == 0,
        "kernel 4's run validates through kernel 1's wide route": c4["fused_render"] >= 2
        and c4["fused_render_wide"] == c4["fused_render_bf16"] == c4["fused_render"],
        f"field path: kernels 2 and 3 on their wide route {2 * n} times each, kernel 4 never":
            cf["fused_mlp_wide"] == 2 * n == cf["fused_mlp_bf16"] == cf["fused_mlp"]
            and cf["fused_mlp_train_wide"] == 2 * n == cf["fused_mlp_train"]
            and cf["fused_train_loss"] == 0 and cf["fused_render_wide"] >= 2,
        f"resample: kernel 4 wide {2 * n} times, kernel 5 {n} times":
            cr["fused_train_loss_wide"] == 2 * n and cr["resample"] == n,
        "every run's losses finite and falling, validations finite": all(map(falls, runs)),
    })

    # ---- serve the kernel-4 run's .ckpt through kernel 1's wide route
    cfg_path, logdir = runs["kernel4"][:2]
    ckpt_path = os.path.join(logdir, "checkpoints", f"checkpoint_{n - 1:07d}.ckpt")
    q = "theta=%g&phi=%g&radius=%g" % POSE
    w0 = fr.launches_wide
    c2w = pose_spherical(*POSE).tolist()
    out, info, request_ms, frames, launches, launches_b = serve_requests(
        cfg_path, ckpt_path, [("/healthz", None), ("/render?" + q, None), ("/depth?" + q, None),
                              ("/render", json.dumps({"c2w": c2w}).encode())], torch)
    served_wide = fr.launches_wide - w0
    depth = np.load(io.BytesIO(out[2]))
    print(f"phase 22: served {frames} frames of the 8x256 .ckpt at {info.get('compute_dtype')}; "
          f"kernel-1 launches {launches} (bf16 {launches_b}, wide {served_wide}); request ms "
          f"{json.dumps(request_ms)}")
    rgb = np.asarray(Image.open(io.BytesIO(out[1])))
    run_checks("8x256 serving", {
        "3 frames, 2 wide launches each": frames == 3 and launches == launches_b
        == served_wide == 6,
        "rgb png 400x400x3, POST equal to GET": rgb.shape == (HWF[0], HWF[1], 3)
        and np.array_equal(np.asarray(Image.open(io.BytesIO(out[3]))), rgb),
        "depth 400x400 finite": depth.shape == (HWF[0], HWF[1]) and bool(np.isfinite(depth).all()),
    })

    # ---- kernel 4 on one batch of the run, kernels 2-3 on its fine pass
    cfg, coarse, fine, _ = run_models(cfg_path, logdir, n, dev)
    scene = load_scene(cfg)
    s_train = render_settings_from_cfg(cfg, "train")
    batch = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    store = build_ray_store(scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf,
                            near, far, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, store.num_rays, (batch,), generator=gen, device=dev)
    rays, target = take_ray_batch(store, idx)
    draws = draw_render_noise(batch, s_train, gen, dev)
    o, d, v = (t.contiguous() for t in rays[:3])
    target = target.contiguous()
    norm = float(3 * batch)
    z_c = jittered_z_vals(rays, s_train, draws)
    per_pass, err4 = {}, 0.0
    for name, model, noise in (("coarse", coarse, draws.noise_coarse),
                               ("fine", fine, draws.noise_fine)):
        z = z_c if name == "coarse" else z_f
        args = (model, o, d, z, v, ray_dists(z, d), noise, target)
        want = ftl.fused_pass_loss_reference(*args)
        err4 = max(err4, check_train_bf16(f"8x256 {name}", model, args, norm, want, torch,
                                          phase=22))
        per_pass[name] = args
        if name == "coarse":
            z_f, _ = hierarchical_z_vals(z_c, want[1], s_train.num_fine, det=False,
                                         u=draws.u_fine)
    pts = (o[:, None] + d[:, None] * z_f[..., None]).contiguous()
    g = pass_cotangent(fine, pts, z_f, d, v, target, norm, s_train.white_background, torch)
    err2, err3 = hold_fields_bf16("phase 22: 8x256 fine pass", fine, pts, v, g, torch)

    # ---- kernel 1 on the 400x400 validation frame (σ heads calibrated, T thresholds)
    s_val = render_settings_from_cfg(cfg, "validation", dex=True).eval_variant()
    H, W, focal = int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2])
    ro, rd = get_ray_bundle_c2w(H, W, focal,
                                torch.as_tensor(scene.poses[int(scene.i_val[0])], device=dev))
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    vrays = make_ray_batch(ro, rd, near, far)
    calibrate_on((vc, vf), vrays, s_val, torch)
    err1, ms1, b1, b1_by = hold_frame(f"phase 22: 8x256 validation frame {H}x{W}", vc, vf, vrays,
                                      s_val, torch)

    # ---- the other widths on a small batch of the same rays
    k = WIDE_SMALL_RAYS
    so, sd, sv, st = o[:k], d[:k], v[:k], target[:k]
    sz = z_c[:k].contiguous()
    s_dists = ray_dists(sz, sd)
    s_pts = (so[:, None] + sd[:, None] * sz[..., None]).contiguous()
    widths = {}
    for hid in WIDE_WIDTHS:
        torch.manual_seed(SEED)
        m = FlexibleNeRFModel(num_layers=8, hidden_size=hid, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
        # kernel 1 on a copy with its σ head calibrated (as phase 3); the
        # training kernels on the seeded model (as the card tests), kernel 4
        # on the calibrated copy too
        mc = copy.deepcopy(m)
        calibrate_on((mc,), make_ray_batch(ro, rd, near, far), s_val, torch)
        before = read_counts()
        # kernel 1 on the whole batch: its maps are per ray, and phase 3's
        # 99.9th percentile is the largest value below 1000 rays
        rargs = (mc, o, d, v, z_c, ray_dists(z_c, d))
        got = fr.fused_render(*rargs, compute_dtype=bf16)
        want_b = fr.fused_render_reference(*rargs, compute_dtype=bf16)
        want_f = fr.fused_render_reference(*rargs)
        print(f"phase 22: H = {hid}, kernel 1 bf16 on {batch} rays x {z_c.shape[1]} samples "
              f"(phase 3's rule), kernels 2-4 on {k} of them:")
        e1 = compare_bf16(f"H{hid}", got, want_b, want_f, torch)
        noise = None if draws.noise_coarse is None else draws.noise_coarse[:k].contiguous()
        args = (m, so, sd, sz, sv, s_dists, noise, st)
        e4 = check_train_bf16(f"H = {hid}", m, args, float(3 * k),
                              ftl.fused_pass_loss_reference(*args), torch, phase=22)
        # and on the copy whose σ head is calibrated: its pass loss sends a
        # cotangent through every trunk layer. The p99.9 clause holds leaves
        # of 1000 entries or more: at 576 the viewdir layer's and fc_feat's
        # biases (288 and 576 entries: p99.9 is their max) lie at 0.61-0.76
        # of own (ROADMAP Queue 3, fault 9, open)
        cargs = (mc, *args[1:])
        e4 = max(e4, check_train_bf16(f"H = {hid}, σ calibrated", mc, cargs, float(3 * k),
                                      ftl.fused_pass_loss_reference(*cargs), torch, phase=22,
                                      p999_min=1000))
        # a seeded model's σ is ~0, so its pass loss sends no cotangent past
        # the heads: kernel 3 on a random one (as the card tests)
        gk = 1e-2 * torch.randn(s_pts.shape[:2] + (4,), generator=gen, device=dev)
        e2, e3 = hold_fields_bf16(f"phase 22: H = {hid}", m, s_pts, sv, gk, torch)
        f32 = {}
        if hid <= fr.NARROW_HIDDEN:  # the narrow f32 routes too (phase 23 holds the wide ones)
            f32["k1"] = compare(f"H{hid} f32", fr.fused_render(*rargs),
                                fr.fused_render_reference(*rargs), torch)
            f32["k4"] = check_train_f32(f"phase 22: H = {hid}", m, args, float(3 * k), torch)
            raw32 = fm.fused_field(m, s_pts, sv)
            raw_p = fm.fused_field_reference(m, s_pts, sv).detach()
            f32["k2"] = float((raw32 - raw_p).abs().max())
            if bool(((raw32 - raw_p).abs() > ATOL + RTOL * raw_p.abs()).any()):
                raise AssertionError(f"H = {hid}: kernel 2's f32 route and plain differ")
        after = read_counts()
        delta = {key: after[key] - before[key] for key in after if after[key] != before[key]}
        wide = fr.bf16_hidden(hid) > fr.NARROW_HIDDEN
        widths[hid] = dict(bf16=[e1, e4, e2, e3], f32=f32, launches=delta)
        print(f"phase 22: H = {hid}: max abs errs (bf16: kernels 1, 4, 2, 3) "
              f"{[float(f'{e:.3e}') for e in (e1, e4, e2, e3)]}, f32 "
              f"{json.dumps({a: float(f'{b:.3e}') for a, b in f32.items()})}; launches "
              f"{json.dumps(delta)}")
        run_checks(f"H = {hid}", {
            ("the wide route" if wide else "the narrow kernels") + " of kernels 1-4":
                all(delta.get(f"{mod}_wide", 0) == (delta.get(f"{mod}_bf16", 0) if wide else 0)
                    and delta.get(f"{mod}_bf16", 0) >= 1
                    for mod in ("fused_render", "fused_train_loss", "fused_mlp",
                                "fused_mlp_train")),
        })
    # every f32 wrapper refuses a width above MAX_HIDDEN (item 6c), launching nothing
    before = read_counts()
    refusals = {}
    too_wide = FlexibleNeRFModel(num_layers=8, hidden_size=fr.MAX_HIDDEN + 1,
                                 skip_connect_every=3, num_encoding_fn_xyz=10,
                                 num_encoding_fn_dir=4).to(dev)
    g0 = torch.zeros_like(s_pts[..., :1]).expand(*s_pts.shape[:2], 4).contiguous()
    for name, call in (
            ("kernel 1", lambda: fr.fused_render(too_wide, so, sd, sv, sz, s_dists)),
            ("kernel 2", lambda: fm.fused_field(too_wide, s_pts, sv)),
            ("kernel 3", lambda: fmt._launch_backward(too_wide, s_pts, sv, g0,
                                                      log_sampling_xyz=True,
                                                      log_sampling_dir=True)),
            ("kernel 4", lambda: ftl.fused_pass_loss(too_wide, so, sd, sz, sv, s_dists, None,
                                                     st))):
        try:
            call()
            refusals[name] = "not refused"
        except ValueError as e:
            refusals[name] = str(e)
    after = read_counts()
    print(f"phase 22: the f32 routes at {fr.MAX_HIDDEN + 1}: {json.dumps(refusals)}")
    run_checks(f"f32 at {fr.MAX_HIDDEN + 1}", {
        "kernels 1-4 refuse with item 6c's words": all("item 6c" in e for e in refusals.values()),
        "no launch": after == before,
    })

    # ---- times at 8x256: the passes, the steps, the frame; bounds; yardsticks
    ms = {}
    bf = dict(compute_dtype=bf16, dw_dtype=bf16)
    for name, args in per_pass.items():
        ms[f"{name}_kernel"] = timed_ms(lambda: ftl.fused_pass_loss(*args, **bf), torch)
        ms[f"{name}_plain"] = timed_ms(lambda: ftl.fused_pass_loss_reference(*args, **bf), torch)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    with torch.no_grad():
        ms["fwd_kernel"] = timed_ms(lambda: fm.fused_field(fine, pts, v, compute_dtype=bf16),
                                    torch)
        ms["fwd_plain"] = timed_ms(
            lambda: fm.fused_field_reference(fine, pts, v, compute_dtype=bf16), torch)
    ms["bwd_kernel"] = timed_ms(lambda: fmt._launch_backward(fine, pts, v, g, **kw, **bf), torch)
    ms["bwd_plain"] = timed_ms(lambda: fmt.field_grads_reference(fine, pts, v, g, **bf), torch)
    def dw_bf16(passes):  # the weight-gradient products as bf16 torch.matmul
        gemms = [gm for m_, k_ in passes for gm in dw_gemm_operands(m_, k_, torch, dev, bf16)]
        t_ = timed_ms(lambda: [torch.matmul(a.t(), b) for a, b in gemms], torch)
        del gemms
        return t_

    k4_passes = [(a[0], a[3].numel()) for a in per_pass.values()]
    ms["dw_torch_matmul_bf16"] = dw_bf16(k4_passes)
    pass_yardsticks(ms, "k4", k4_passes, torch, dev, bf16)
    f_passes = [(fine, pts.shape[0] * pts.shape[1])]
    field_ms = {"dw_torch_matmul_bf16": dw_bf16(f_passes)}
    pass_yardsticks(field_ms, "f", f_passes, torch, dev, bf16)
    pass_yardsticks(ms, "k1", [(vc, H * W * s_val.num_coarse),
                               (vf, H * W * (s_val.num_coarse + s_val.num_fine))], torch, dev,
                    bf16, parts=("forward",))

    def step_of(path):
        st_ = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        kw_ = {}
        if path == "kernel4":
            kw_["fused_loss"] = ftl.make_fused_train_loss(coarse, fine, s_train,
                                                          compute_dtype=bf16, dw_dtype=bf16)
        else:
            kw_["coarse_field"], kw_["fine_field"] = (
                make_fused_flexible_field_train(mm, compute_dtype=bf16, dw_dtype=bf16)
                for mm in (coarse, fine))
        step = make_train_step(s_train, batch, **kw_)
        return lambda: step(st_, store, gen)

    steps, peaks = {}, {}
    for path in ("kernel4", "fields"):
        steps[path] = step_of(path)
        torch.cuda.reset_peak_memory_stats()
        ms[f"step_{path}"] = host_ms(torch, steps[path], n=5)
        peaks[path] = torch.cuda.max_memory_allocated() / 2**30
    impl = fr.make_fused_render_rays(vc, vf, s_val, compute_dtype=bf16)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        ms["frame_host"] = host_ms(torch, lambda: render_image(vc, vf, ro, rd, near, far, s_val,
                                                               rays_impl=impl))
        peaks["frame"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 22: ms on {card} (passes and kernels 2-3: CUDA events, mean of 3; steps and "
          f"the frame: host clock around synchronize, mean of 5 / 3): "
          + json.dumps({key: round(t, 3) for key, t in ms.items()}) + "; field-pass yardsticks "
          + json.dumps({key: round(t, 3) for key, t in field_ms.items()})
          + "; rays/s per step "
          + json.dumps({p: round(batch / (ms[f"step_{p}"] / 1e3)) for p in steps})
          + f"; peak memory (GiB) {json.dumps({p: round(x, 2) for p, x in peaks.items()})}")
    print("  wide residency (CUDA occupancy API; CTAs per SM, shared bytes, ring stages, "
          "consumer warpgroups): kernel 1 coarse / fine " + json.dumps(
              [fr.wide_occupancy(vf, s) for s in (s_val.num_coarse,
                                                  s_val.num_coarse + s_val.num_fine)])
          + "; training " + json.dumps(ftl.bf16_occupancy(fine)))
    occ = ftl.bf16_occupancy(fine)["chain"]
    hp_f, nt_f = fr.bf16_hidden(fine.hidden_size), fine.num_layers - 1
    print(f"  wide chain plan: {occ[3]} consumer warpgroup(s) a CTA, {occ[2]} ring stages of "
          f"[{fr.WIDE_BLOCK}][64] weight pieces, {occ[1]} B shared; column blocks of "
          f"{fr.WIDE_BLOCK} on {hp_f}-wide products, a fresh accumulator every "
          f"{fr.WIDE_SPAN} k16 steps; ReLU masks as "
          f"{ftl.wide_mask_words(hp_f, nt_f)} mask words a thread a 64-row tile "
          f"({8 * ftl.wide_mask_words(hp_f, nt_f)} B a sample, the saved activations "
          f"{2 * (hp_f // 2 + (nt_f + 1) * hp_f)} B)")
    print_dw_plan(fine, *per_pass["fine"][3].shape, torch, dev)
    print("  8x256 kernel-4 steps:")
    prof = profile_steps(torch, steps["kernel4"], {"kernel 4 wide": WIDE4_NAMES})
    parts, sizes = [], {}
    lib4 = bf16_library(ms, "k4")
    for base, wname in WIDE_PARTS.items():
        nbytes_ = macs = 0
        for model, k_ in k4_passes:
            b_, m_ = bf16_part_bounds(model, k_)[base]
            nbytes_, macs = nbytes_ + b_, macs + m_
        dev_ms = sum(t for key, t in prof.items() if wname in key.replace(" ", ""))
        b_ms, b_by = bound(2 * macs, nbytes_, BF16_FLOPS)
        parts.append({"name": wname, "ms": dev_ms if prof else None, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib4[base]})
        sizes[wname] = f"{nbytes_ / 1e9:.4f} GB, {2 * macs / 1e12:.4f} TFLOP"
    print("  wide route's kernels, device ms per step (profile) beside their bounds and their "
          "products as bf16 torch.matmul: " + json.dumps(parts))
    print("  bytes and operations behind those bounds: " + json.dumps(sizes))
    print("  8x256 field-path steps:")
    profile_steps(torch, steps["fields"], {"kernels 2-3 wide": WIDE4_NAMES})
    flops, _, byts_b, _ = kernel4_sizes(per_pass, dev)
    b4, b4_by = bound(flops, byts_b, BF16_FLOPS)
    n_s = pts.shape[0] * pts.shape[1]
    ps, pr = mlp_macs(fine)
    packs = nbytes(*ftl._cached_bf16_weights(fine, dev)[:2])
    b2, b2_by = bound(2 * (n_s * ps + pts.shape[0] * pr), nbytes(pts, v) + packs + 16 * n_s,
                      BF16_FLOPS)
    b3, b3_by = bound(train_flops(fine, *pts.shape[:2]), nbytes(pts, v, g, *fine.parameters())
                      + packs + nbytes(ftl.pack_backward_weights_bf16(fine, dev)), BF16_FLOPS)
    print(f"  bounds (ms): kernel 4 both passes {b4:.3f} ({b4_by}; {flops / 1e12:.4f} TFLOP), "
          f"kernel 2 {b2:.3f} ({b2_by}), kernel 3 {b3:.3f} ({b3_by}), kernel 1 frame {b1:.3f} "
          f"({b1_by})")
    src_r = "dexnerf_tpu_torch/ops/csrc/fused_render_bf16.cu"
    src_t = "dexnerf_tpu_torch/ops/csrc/fused_train_loss_bf16.cu"
    return [
        {"name": "fused_render_bf16_wide@8x256", "route": "cuda", "source": src_r,
         "replaces": "dexnerf_tpu/ops/fused_render.py:115",
         "launches": c4["fused_render_wide"], "max_abs_err": err1,
         "ms": ms1["coarse_kernel"] + ms1["fine_kernel"],
         "plain_ms": ms1["coarse_plain"] + ms1["fine_plain"], "bound_ms": b1, "bound_by": b1_by,
         "library_ms": ms["k1_forward_torch_matmul_bf16"]},
        {"name": "fused_train_loss_bf16_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_train_loss.py:99",
         "launches": c4["fused_train_loss_wide"], "max_abs_err": err4,
         "ms": ms["coarse_kernel"] + ms["fine_kernel"],
         "plain_ms": ms["coarse_plain"] + ms["fine_plain"], "bound_ms": b4, "bound_by": b4_by,
         "library_ms": sum(lib4.values()), "parts": parts},
        {"name": "fused_mlp_bf16_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_mlp.py:481", "launches": cf["fused_mlp_wide"],
         "max_abs_err": err2, "ms": ms["fwd_kernel"], "plain_ms": ms["fwd_plain"],
         "bound_ms": b2, "bound_by": b2_by,
         "library_ms": field_ms["f_forward_torch_matmul_bf16"]},
        {"name": "fused_mlp_train_bf16_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_mlp_train.py:221",
         "launches": cf["fused_mlp_train_wide"], "max_abs_err": err3, "ms": ms["bwd_kernel"],
         "plain_ms": ms["bwd_plain"], "bound_ms": b3, "bound_by": b3_by,
         "library_ms": field_ms["dw_torch_matmul_bf16"] + field_ms["f_forward_torch_matmul_bf16"]
         + field_ms["f_chain_torch_matmul_bf16"]},
    ]


def hold_frame_f32(label, coarse, fine, rays, s_val, thresholds, torch):
    """Kernel 1's f32 route on one frame ``rays`` (a flat RayBatch) of
    ``coarse``/``fine`` at ``s_val``'s samples: both passes vs the f32
    plain version by phase 3's rule (RTOL / ATOL), the Dex depths at
    ``thresholds`` equal to the plain version's on >= DEX_EQUAL_SHARE of
    pairs; both passes timed (CUDA events, mean of 3) beside their plain
    versions and their split-TF32 bound. Returns (max abs error, ms, bound
    ms, bound_by)."""
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.ops import fused_render as fr

    vo, vd, vv = (t.contiguous() for t in rays[:3])
    zc = stratified_z_vals(rays.near, rays.far, s_val.num_coarse, lindisp=s_val.lindisp)
    rkw = dict(white_background=s_val.white_background)
    ms = {}
    with torch.inference_mode():
        dc = ray_dists(zc, vd)
        args_c = (coarse, vo, vd, vv, zc, dc)
        print(f"{label}: {vo.shape[0]} rays, T = {len(thresholds)}, kernel 1 f32 vs f32 plain "
              f"(rtol {RTOL:g}, atol {ATOL:g}):")
        want_c = fr.fused_render_reference(*args_c, **rkw)
        err = compare("coarse", fr.fused_render(*args_c, **rkw), want_c, torch)
        zf, _ = hierarchical_z_vals(zc, want_c.weights, s_val.num_fine, det=True)
        df = ray_dists(zf, vd)
        args_f = (fine, vo, vd, vv, zf, df)
        got_f = fr.fused_render(*args_f, thresholds=thresholds, **rkw)
        want_f = fr.fused_render_reference(*args_f, thresholds=thresholds, **rkw)
        err = max(err, compare("fine", got_f, want_f, torch))
        if thresholds:
            dex_eq = float((got_f.depth_dex == want_f.depth_dex).float().mean())
            hit = float((want_f.depth_dex != zf[None, :, 0]).float().mean())
            print(f"  dex: f32 kernel = f32 plain on {dex_eq:.6f} of {got_f.depth_dex.numel()} "
                  f"pairs (limit {DEX_EQUAL_SHARE}); past sample 0 on {hit:.3f} of them")
            if dex_eq < DEX_EQUAL_SHARE:
                raise AssertionError(f"{label}: f32 dex depths equal on only {dex_eq:.6f}")
        for name, args, th in (("coarse", args_c, ()), ("fine", args_f, thresholds)):
            ms[f"{name}_kernel"] = timed_ms(
                lambda: fr.fused_render(*args, thresholds=th, **rkw), torch)
            ms[f"{name}_plain"] = timed_ms(
                lambda: fr.fused_render_reference(*args, thresholds=th, **rkw), torch)
        r_flops = r_bytes = 0
        for m, z, dz, g in ((coarse, zc, dc, None), (fine, zf, df, got_f)):
            ps, pr = mlp_macs(m)
            r_flops += 2 * (z.numel() * ps + z.shape[0] * pr)
            # in: rays, depths, intervals, the split pack; out: rgb, disparity,
            # accumulation, depth, weights (and the fine pass's Dex depths)
            r_bytes += (nbytes(vo, vd, vv, z, dz, *fr.pack_flex_weights_tf32(m)[:2])
                        + 4 * z.numel() + 4 * 6 * z.shape[0]
                        + (nbytes(g.depth_dex) if g is not None else 0))
    b_ms, b_by = bound(3 * r_flops, r_bytes, TF32_FLOPS)
    print(f"  kernel 1 bound for the frame's two passes {b_ms:.3f} ms ({b_by}; "
          f"{r_flops / 1e12:.4f} TFLOP of the model's, three TF32 products each at "
          f"{TF32_FLOPS / 1e12:g} TFLOP/s; {r_bytes / 1e6:.2f} MB); at the f32 FMA peak "
          f"{bound(r_flops, r_bytes)[0]:.3f} ms")
    return err, ms, b_ms, b_by + (SPLIT_TF32 if b_by == "operations" else "")


def wide_f32_phase(torch, np, card, dev, tmp, shared=None):
    """Phase 23 (see the module's docstring): the wide f32 route at 8x256
    through ``apps.train`` and ``apps.serve`` at ``pallas_compute_dtype:
    float32``, held to the plain versions at 256 and at the widths of
    WIDE_F32_WIDTHS, timed beside split-TF32 bounds and f32
    ``torch.matmul``. ``shared`` is phase 6's (its scene), or None to write
    a scene. Returns the kernels-line entries of the wide f32 route."""
    import copy

    import yaml
    from PIL import Image

    from dexnerf_tpu_torch.config import render_settings_from_cfg
    from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
    from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals
    from dexnerf_tpu_torch.core.volrend import ray_dists
    from dexnerf_tpu_torch.data.blender import pose_spherical
    from dexnerf_tpu_torch.data.pipeline import build_ray_store, take_ray_batch
    from dexnerf_tpu_torch.data.synthetic import write_blender_dataset
    from dexnerf_tpu_torch.models.mlp import FlexibleNeRFModel
    from dexnerf_tpu_torch.ops import _build
    from dexnerf_tpu_torch.ops import fused_mlp as fm
    from dexnerf_tpu_torch.ops import fused_mlp_train as fmt
    from dexnerf_tpu_torch.ops import fused_render as fr
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.ops.fused_mlp_train import make_fused_flexible_field_train
    from dexnerf_tpu_torch.render.renderer import (
        draw_render_noise,
        jittered_z_vals,
        make_ray_batch,
        render_image,
    )
    from dexnerf_tpu_torch.train.loop import load_scene
    from dexnerf_tpu_torch.train.step import init_train_state, make_train_step

    if shared is None:
        data = os.path.join(tmp, "scene")
        write_blender_dataset(data, TRAIN_HW, TRAIN_HW, TRAIN_VIEWS, device=dev)
    else:
        data = shared.data
    with open(TRAIN_CONFIG) as f:
        raw = yaml.safe_load(f)
    for blk in ("coarse", "fine"):
        raw["models"][blk]["hidden_size"] = WIDE_HIDDEN
    raw["nerf"]["pallas_compute_dtype"] = "float32"
    wide_cfg = os.path.join(tmp, "lego-tpu-8x256-f32.yml")
    with open(wide_cfg, "w") as f:
        yaml.safe_dump(raw, f)
    report = wide_build_report(_build.build_log, WIDE_F32_KERNELS)
    print(f"phase 23: the wide f32 kernels as built (ptxas): {json.dumps(report)}")

    # ---- the three training paths through the entry point, at float32
    n = WIDE_ITERS
    runs = {}
    for name, nerf in (("kernel4", {}), ("fields", {"pallas_fused_loss": False}),
                       ("resample", {"pallas_loss_resample": "pallas"})):
        runs[name] = train_cli(tmp, data, f"wide-f32-{name}", n, torch, dev, config=wide_cfg,
                               **nerf)
        _, _, counts, losses, val, secs, peak = runs[name]
        print(f"phase 23: 8x256 f32 {name}, {n} steps in {secs:.2f} s, peak {peak:.2f} GiB; "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}; loss first "
              f"{losses[0]:.5f} last {losses[-1]:.5f}; validation psnr {val}")
    c4, cf, cr = (runs[k][2] for k in ("kernel4", "fields", "resample"))

    def falls(k):
        losses, val = runs[k][3], runs[k][4]
        return (len(losses) == n and bool(np.isfinite(losses).all())
                and np.mean(losses[-3:]) < np.mean(losses[:3]) and len(val) >= 1
                and bool(np.isfinite(val).all()))

    no_bf16 = all(c.get(f"{mod}_{r}", 0) == 0 for c in (c4, cf, cr) for r in ("bf16", "wide")
                  for mod in ("fused_render", "fused_train_loss", "fused_mlp", "fused_mlp_train"))
    run_checks("8x256 f32 training", {
        f"kernel 4: its wide f32 route {2 * n} times, nothing else but kernel 1":
            c4["fused_train_loss_wide_f32"] == 2 * n == c4["fused_train_loss"]
            and c4["fused_mlp"] == c4["fused_mlp_train"] == 0,
        "kernel 4's run validates through kernel 1's wide f32 route": c4["fused_render"] >= 2
        and c4["fused_render_wide_f32"] == c4["fused_render"],
        f"field path: kernels 2 and 3 on their wide f32 route {2 * n} times each, kernel 4 "
        "never": cf["fused_mlp_wide_f32"] == 2 * n == cf["fused_mlp"]
            and cf["fused_mlp_train_wide_f32"] == 2 * n == cf["fused_mlp_train"]
            and cf["fused_train_loss"] == 0 and cf["fused_render_wide_f32"] >= 2,
        f"resample: kernel 4 wide f32 {2 * n} times, kernel 5 {n} times":
            cr["fused_train_loss_wide_f32"] == 2 * n and cr["resample"] == n,
        "no bf16 launch in any run": no_bf16,
        "every run's losses finite and falling, validations finite": all(map(falls, runs)),
    })

    # ---- serve the kernel-4 run's .ckpt through kernel 1's wide f32 route
    cfg_path, logdir = runs["kernel4"][:2]
    ckpt_path = os.path.join(logdir, "checkpoints", f"checkpoint_{n - 1:07d}.ckpt")
    q = "theta=%g&phi=%g&radius=%g" % POSE
    w0 = fr.launches_wide_f32
    c2w = pose_spherical(*POSE).tolist()
    out, info, request_ms, frames, launches, launches_b = serve_requests(
        cfg_path, ckpt_path, [("/healthz", None), ("/render?" + q, None), ("/depth?" + q, None),
                              ("/render", json.dumps({"c2w": c2w}).encode())], torch)
    served_wide = fr.launches_wide_f32 - w0
    depth = np.load(io.BytesIO(out[2]))
    print(f"phase 23: served {frames} frames of the 8x256 .ckpt at {info.get('compute_dtype')}; "
          f"kernel-1 launches {launches} (bf16 {launches_b}, wide f32 {served_wide}); request ms "
          f"{json.dumps(request_ms)}")
    rgb = np.asarray(Image.open(io.BytesIO(out[1])))
    run_checks("8x256 f32 serving", {
        "3 frames at float32, 2 wide f32 launches each, no bf16 launch": frames == 3
        and launches == served_wide == 6 and launches_b == 0
        and info.get("compute_dtype") == "float32",
        "rgb png 400x400x3, POST equal to GET": rgb.shape == (HWF[0], HWF[1], 3)
        and np.array_equal(np.asarray(Image.open(io.BytesIO(out[3]))), rgb),
        "depth 400x400 finite": depth.shape == (HWF[0], HWF[1]) and bool(np.isfinite(depth).all()),
    })

    # ---- kernel 4 on one batch of the run, kernels 2-3 on its fine pass
    cfg, coarse, fine, _ = run_models(cfg_path, logdir, n, dev)
    scene = load_scene(cfg)
    s_train = render_settings_from_cfg(cfg, "train")
    batch = int(cfg.nerf.train.num_random_rays)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    store = build_ray_store(scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf,
                            near, far, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, store.num_rays, (batch,), generator=gen, device=dev)
    rays, target = take_ray_batch(store, idx)
    draws = draw_render_noise(batch, s_train, gen, dev)
    o, d, v = (t.contiguous() for t in rays[:3])
    target = target.contiguous()
    norm = float(3 * batch)
    z_c = jittered_z_vals(rays, s_train, draws)
    # the whole batch, as the steps run it (the coarse pass in 2 scratch
    # chunks, the fine in 4); the rule's float64 references chunk by chunk
    per_pass, err4 = {}, 0.0
    for name, model, noise in (("coarse", coarse, draws.noise_coarse),
                               ("fine", fine, draws.noise_fine)):
        z = z_c if name == "coarse" else z_f
        args = (model, o, d, z, v, ray_dists(z, d), noise, target)
        err4 = max(err4, check_train_f32(f"phase 23: 8x256 {name}, {batch} rays", model, args,
                                         norm, torch, own=True))
        per_pass[name] = args
        if name == "coarse":
            want = ftl.fused_pass_loss_reference(*args)
            z_f, _ = hierarchical_z_vals(z_c, want[1], s_train.num_fine, det=False,
                                         u=draws.u_fine)
    kw = dict(log_sampling_xyz=True, log_sampling_dir=True)
    pts = (o[:, None] + d[:, None] * z_f[..., None]).contiguous()
    g = pass_cotangent(fine, pts, z_f, d, v, target, norm, s_train.white_background, torch)
    errs_f, _, _ = hold_fields_f32(f"phase 23: 8x256 fine pass, {batch} rays", fine, pts, v, g,
                                   kw, torch)

    # ---- kernel 1 on the 400x400 validation frame (σ heads calibrated, T thresholds)
    s_val = render_settings_from_cfg(cfg, "validation", dex=True).eval_variant()
    H, W = int(scene.hwf[0]), int(scene.hwf[1])
    ro, rd = get_ray_bundle_c2w(H, W, float(scene.hwf[2]),
                                torch.as_tensor(scene.poses[int(scene.i_val[0])], device=dev))
    vc, vf = copy.deepcopy(coarse), copy.deepcopy(fine)
    vrays = make_ray_batch(ro, rd, near, far)
    calibrate_on((vc, vf), vrays, s_val, torch)
    # lego-tpu.yml sets no Dex thresholds: the frame takes 20 (5, 10, ..., 100)
    err1, ms1, b1, b1_by = hold_frame_f32(f"phase 23: 8x256 validation frame {H}x{W}", vc, vf,
                                          vrays, s_val, WIDE_F32_THRESHOLDS, torch)

    # ---- the other widths on a small batch of the same rays
    k = WIDE_SMALL_RAYS
    so, sd, sv, st = o[:k], d[:k], v[:k], target[:k]
    sz = z_c[:k].contiguous()
    s_dists = ray_dists(sz, sd)
    s_pts = (so[:, None] + sd[:, None] * sz[..., None]).contiguous()
    for hid in WIDE_F32_WIDTHS:
        hid = hid or fr.MAX_HIDDEN
        torch.manual_seed(SEED)
        m = FlexibleNeRFModel(num_layers=8, hidden_size=hid, skip_connect_every=3,
                              num_encoding_fn_xyz=10, num_encoding_fn_dir=4).to(dev)
        mc = copy.deepcopy(m)
        calibrate_on((mc,), make_ray_batch(ro, rd, near, far), s_val, torch)
        before = read_counts()
        rargs = (mc, o, d, v, z_c, ray_dists(z_c, d))
        print(f"phase 23: H = {hid}, kernel 1 f32 on {batch} rays x {z_c.shape[1]} samples "
              f"(phase 3's rule), kernels 2-4 on {k} of them:")
        e1 = compare(f"H{hid}", fr.fused_render(*rargs), fr.fused_render_reference(*rargs), torch)
        noise = None if draws.noise_coarse is None else draws.noise_coarse[:k].contiguous()
        args = (m, so, sd, sz, sv, s_dists, noise, st)
        e4 = check_train_f32(f"phase 23: H = {hid}", m, args, float(3 * k), torch, own=True)
        gk = 1e-2 * torch.randn(s_pts.shape[:2] + (4,), generator=gen, device=dev)
        e23, _, _ = hold_fields_f32(f"phase 23: H = {hid}", m, s_pts, sv, gk, kw, torch)
        after = read_counts()
        delta = {key: after[key] - before[key] for key in after if after[key] != before[key]}
        print(f"phase 23: H = {hid}: max abs errs (kernels 1, 4, 2, 3) "
              f"{[float(f'{e:.3e}') for e in (e1, e4, e23['fwd'], e23['bwd'])]}; launches "
              f"{json.dumps(delta)}")
        run_checks(f"H = {hid} at f32", {
            "the wide f32 route of kernels 1-4, no bf16 launch":
                all(delta.get(f"{mod}_wide_f32", 0) == delta.get(mod, 0) >= 1
                    and delta.get(f"{mod}_bf16", 0) == 0
                    for mod in ("fused_render", "fused_train_loss", "fused_mlp",
                                "fused_mlp_train")),
        })

    # ---- times at 8x256: the passes, the steps, the frame; bounds; yardsticks
    ms = {}
    for name, args in per_pass.items():
        ms[f"{name}_kernel"] = timed_ms(lambda: ftl.fused_pass_loss(*args), torch)
        ms[f"{name}_plain"] = timed_ms(lambda: ftl.fused_pass_loss_reference(*args), torch)
    with torch.no_grad():
        ms["fwd_kernel"] = timed_ms(lambda: fm.fused_field(fine, pts, v), torch)
        ms["fwd_plain"] = timed_ms(lambda: fm.fused_field_reference(fine, pts, v), torch)
    ms["bwd_kernel"] = timed_ms(lambda: fmt._launch_backward(fine, pts, v, g, **kw), torch)
    ms["bwd_plain"] = timed_ms(lambda: fmt.field_grads_reference(fine, pts, v, g), torch)

    def dw_f32(passes):  # the weight-gradient products as f32 torch.matmul (TF32 off)
        gemms = [gm for m_, k_ in passes
                 for gm in dw_gemm_operands(m_, k_, torch, dev, torch.float32)]
        t_ = timed_ms(lambda: [torch.matmul(a.t(), b) for a, b in gemms], torch)
        del gemms
        return t_

    k4_passes = [(a[0], a[3].numel()) for a in per_pass.values()]
    ms["dw_torch_matmul_f32"] = dw_f32(k4_passes)
    pass_yardsticks(ms, "k4", k4_passes, torch, dev)
    f_passes = [(fine, pts.shape[0] * pts.shape[1])]
    field_ms = {"dw_torch_matmul_f32": dw_f32(f_passes)}
    pass_yardsticks(field_ms, "f", f_passes, torch, dev)
    pass_yardsticks(ms, "k1", [(vc, H * W * s_val.num_coarse),
                               (vf, H * W * (s_val.num_coarse + s_val.num_fine))], torch, dev,
                    parts=("forward",))

    def step_of(path):
        st_ = init_train_state(coarse, fine, float(cfg.optimizer.lr))
        kw_ = {}
        if path == "kernel4":
            kw_["fused_loss"] = ftl.make_fused_train_loss(coarse, fine, s_train)
        else:
            kw_["coarse_field"], kw_["fine_field"] = (
                make_fused_flexible_field_train(mm) for mm in (coarse, fine))
        step = make_train_step(s_train, batch, **kw_)
        return lambda: step(st_, store, gen)

    steps, peaks = {}, {}
    for path in ("kernel4", "fields"):
        steps[path] = step_of(path)
        torch.cuda.reset_peak_memory_stats()
        ms[f"step_{path}"] = host_ms(torch, steps[path], n=3)
        peaks[path] = torch.cuda.max_memory_allocated() / 2**30
    impl = fr.make_fused_render_rays(vc, vf, s_val)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        ms["frame_host"] = host_ms(torch, lambda: render_image(vc, vf, ro, rd, near, far, s_val,
                                                               rays_impl=impl), n=2)
        peaks["frame"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 23: ms on {card} (passes and kernels 2-3: CUDA events, mean of 3; steps and "
          f"the frame: host clock around synchronize, mean of 3 / 2): "
          + json.dumps({key: round(t, 3) for key, t in ms.items()}) + "; field-pass yardsticks "
          + json.dumps({key: round(t, 3) for key, t in field_ms.items()})
          + "; rays/s per step "
          + json.dumps({p: round(batch / (ms[f"step_{p}"] / 1e3)) for p in steps})
          + f"; peak memory (GiB) {json.dumps({p: round(x, 2) for p, x in peaks.items()})}")
    print("  wide f32 residency (CUDA occupancy API; CTAs per SM, shared bytes, ring stages, "
          "consumer warpgroups, worker buffer floats): kernel 1 coarse / fine " + json.dumps(
              [fr.tf32_wide_occupancy(vf, s) for s in (s_val.num_coarse,
                                                       s_val.num_coarse + s_val.num_fine)])
          + "; training " + json.dumps(ftl.tf32_occupancy(fine)))
    print("  8x256 f32 kernel-4 steps:")
    prof = profile_steps(torch, steps["kernel4"], {"kernel 4 wide f32": WIDE_F32_NAMES})
    k4_sizes = [(a[0], *a[3].shape) for a in per_pass.values()]
    parts = f32_pass_parts(prof, k4_sizes, ms, "k4", wide=True)
    parts += f32_dw_share(prof, ms["dw_torch_matmul_f32"], k4_sizes)
    print("  8x256 f32 field-path steps:")
    fprof = profile_steps(torch, steps["fields"], {"kernels 2-3 wide f32": WIDE_F32_NAMES})
    for owner in (3, 2):  # the same two passes' shapes and products as kernel 4's
        f32_pass_parts(fprof, k4_sizes, ms, "k4", owner=owner, wide=True)
    flops, byts, _, _ = kernel4_sizes(per_pass, dev)
    b4, b4_by = bound(3 * flops, byts, TF32_FLOPS)
    n_s = pts.shape[0] * pts.shape[1]
    ps, pr = mlp_macs(fine)
    params = list(fine.parameters())
    b2, b2_by = bound(3 * 2 * (n_s * ps + pts.shape[0] * pr),
                      nbytes(pts, v, *params) + 16 * n_s, TF32_FLOPS)
    b3, b3_by = bound(3 * train_flops(fine, *pts.shape[:2]),
                      nbytes(pts, v, g) + 2 * nbytes(*params), TF32_FLOPS)
    print(f"  split-TF32 bounds (ms): kernel 4 both passes {b4:.3f} ({b4_by}; "
          f"{flops / 1e12:.4f} TFLOP of the model's, three TF32 products each; "
          f"{bound(flops, byts)[0]:.3f} at the f32 FMA peak), kernel 2 {b2:.3f} ({b2_by}), "
          f"kernel 3 {b3:.3f} ({b3_by}), kernel 1 frame {b1:.3f} ({b1_by})")

    def by(b_by):
        return b_by + (SPLIT_TF32 if b_by == "operations" else "")

    src_r = "dexnerf_tpu_torch/ops/csrc/fused_render.cu"
    src_t = "dexnerf_tpu_torch/ops/csrc/fused_train_loss.cu"
    return [
        {"name": "fused_render_f32_wide@8x256", "route": "cuda", "source": src_r,
         "replaces": "dexnerf_tpu/ops/fused_render.py:115",
         "launches": c4["fused_render_wide_f32"], "max_abs_err": err1,
         "ms": ms1["coarse_kernel"] + ms1["fine_kernel"],
         "plain_ms": ms1["coarse_plain"] + ms1["fine_plain"], "bound_ms": b1, "bound_by": b1_by,
         "library_ms": ms["k1_forward_torch_matmul_f32"]},
        {"name": "fused_train_loss_f32_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_train_loss.py:99",
         "launches": c4["fused_train_loss_wide_f32"], "max_abs_err": err4,
         "ms": ms["coarse_kernel"] + ms["fine_kernel"],
         "plain_ms": ms["coarse_plain"] + ms["fine_plain"], "bound_ms": b4,
         "bound_by": by(b4_by),
         "library_ms": ms["dw_torch_matmul_f32"] + ms["k4_forward_torch_matmul_f32"]
         + ms["k4_chain_torch_matmul_f32"], "parts": parts},
        {"name": "fused_mlp_f32_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_mlp.py:481", "launches": cf["fused_mlp_wide_f32"],
         "max_abs_err": errs_f["fwd"], "ms": ms["fwd_kernel"], "plain_ms": ms["fwd_plain"],
         "bound_ms": b2, "bound_by": by(b2_by),
         "library_ms": field_ms["f_forward_torch_matmul_f32"]},
        {"name": "fused_mlp_train_f32_wide@8x256", "route": "cuda", "source": src_t,
         "replaces": "dexnerf_tpu/ops/fused_mlp_train.py:221",
         "launches": cf["fused_mlp_train_wide_f32"], "max_abs_err": errs_f["bwd"],
         "ms": ms["bwd_kernel"], "plain_ms": ms["bwd_plain"], "bound_ms": b3,
         "bound_by": by(b3_by),
         "library_ms": field_ms["dw_torch_matmul_f32"] + field_ms["f_forward_torch_matmul_f32"]
         + field_ms["f_chain_torch_matmul_f32"]},
    ]


def serve_requests(config, ckpt, requests, torch, flags=(), refused=()):
    """Start ``dexnerf_tpu_torch.apps.serve`` on the card with ``config``,
    ``ckpt`` and the extra CLI ``flags``, send ``requests`` ((path, POST
    body or None) in order) over HTTP with kernel 1's launch counters set
    to 0 just before and read just after. A request to a route of
    ``refused`` must answer 400; its body is the decoded JSON error.
    Returns the response bodies, the decoded /healthz (when asked), the
    request ms (host clock), the frames served, and the launches of kernel
    1 (either dtype) and of its bf16 kernel."""
    import urllib.error

    from dexnerf_tpu_torch.apps import serve
    from dexnerf_tpu_torch.ops import fused_render as fr

    args = serve.build_parser().parse_args([
        "--config", config, "--checkpoint", ckpt, "--hwf", *map(str, HWF), "--device", "cuda",
        *flags,
    ])
    service = serve.build_service(args)
    httpd = serve.make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out, info, request_ms = [], {}, {}
    try:
        fr.launches = fr.launches_bf16 = 0
        frames0 = service.renders_served
        for path, body in requests:
            req = urllib.request.Request(base + path, data=body)
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    if r.status != 200:
                        raise AssertionError(f"{path}: HTTP {r.status}")
                    out.append(r.read())
            except urllib.error.HTTPError as e:
                if e.code != 400 or path.split("?")[0] not in refused:
                    raise
                out.append(json.loads(e.read()))
            key = ("POST " if body else "GET ") + path.split("?")[0]
            key += " threshold" * ("threshold" in path) + " png" * ("png" in path)
            request_ms[key] = round((time.perf_counter() - t0) * 1e3, 3)
            if path == "/healthz":
                info = json.loads(out[-1])
        launches, launches_bf16 = fr.launches, fr.launches_bf16
        frames = service.renders_served - frames0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return out, info, request_ms, frames, launches, launches_bf16


def _batch_tensors(batch):
    """Every tensor of a loader's batch (a dict, or a tuple that may hold a
    RayBatch)."""
    items = batch.values() if isinstance(batch, dict) else batch
    out = []
    for t in items:
        out.extend(_batch_tensors(t) if isinstance(t, (tuple, dict)) else [t])
    return out


def host_store_phase(torch, np, card, dev, tmp):
    """Phase 24, the host-streamed store (``dataset.host_store``,
    ``data/host_store.py``). (a) ``apps.train`` of ``configs/lego-tpu.yml``
    on a written lego scene of HOST_VIEWS views at HOST_HW (f32 rows past 1
    GB) with the host store on each wire for HOST_ITERS steps: kernel 4's
    bf16 route twice a step, its f32 route never, every batch a CUDA tensor,
    no resident store built, the loss falling. (b) The same indices
    (``default_rng(SEED)``, the loaders' stream) and render draws through
    three steps: ``make_train_step`` on the resident store, the rows step
    and the packed step (``make_batch_train_step``), HOST_UPDATES updates
    through kernel 4's bf16 route (the rows step's parameters and losses
    and first gradients bitwise equal to the resident step's; the packed
    step's first loss within PACKED_LOSS_RTOL of the rows step's, its later
    divergence printed: an ulp of a ray can move a bf16 rounding) and
    HOST_F32_UPDATES through its f32 route (the packed step's losses and
    first gradients within the CPU test's tolerances of the rows step's;
    the parameters' distance printed, not held: Adam's update of an entry
    whose gradient is within rounding of 0 takes either sign). (c) Host-clock ms of a kernel-4 step (mean of
    HOST_TIMED, in turns) resident, rows and packed at each of HOST_BATCHES
    rays, each loader's gather ms (host clock) and copy ms (device, CUDA
    events) per batch, each step's device idle share (``torch.profiler``)
    and the wire's bytes a ray. (d) A messytable run with the depth term on
    the packed wire, a field-path run (kernels 2-3) and an LLFF (NDC) run,
    HOST_SMALL_ITERS steps each. Kernel 4 held on a batch of the scene
    (phase 7's rule). Returns the kernels-line entries."""
    import copy

    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.data import host_store as hs
    from dexnerf_tpu_torch.data.pipeline import build_ray_store
    from dexnerf_tpu_torch.data.synthetic import (
        write_blender_dataset,
        write_llff_dataset,
        write_messytable_dataset,
    )
    from dexnerf_tpu_torch.ops import fused_train_loss as ftl
    from dexnerf_tpu_torch.render.renderer import draw_render_noise
    from dexnerf_tpu_torch.train import loop as ploop
    from dexnerf_tpu_torch.train.step import (
        StepDraws,
        init_train_state,
        make_batch_train_step,
        make_train_step,
    )

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    data = os.path.join(tmp, "lego-host")
    write_blender_dataset(data, HOST_HW, HOST_HW, HOST_VIEWS, device=dev)
    dataset_s = time.perf_counter() - t0

    # ---- (a) apps.train on each wire
    seen, builds = [], []
    spy_next, build = hs._HostLoader.__next__, ploop.build_ray_store

    def spied(self):
        batch = spy_next(self)
        seen.append(all(t.is_cuda for t in _batch_tensors(batch)))
        return batch

    hs._HostLoader.__next__ = spied
    ploop.build_ray_store = lambda *a, **k: builds.append(1) or build(*a, **k)
    runs = {}
    try:
        for wire in ("packed", "rows"):
            seen.clear()
            builds.clear()
            runs[wire] = (*train_cli(tmp, data, f"lego-host-{wire}", HOST_ITERS, torch, dev,
                                     dataset={"host_store": True, "host_wire": wire}),
                          list(seen), len(builds))
    finally:
        hs._HostLoader.__next__, ploop.build_ray_store = spy_next, build
    for wire, (cfg_path, logdir, counts, losses, val_psnr, secs, peak_gb, cuda, n_res) in \
            runs.items():
        print(f"phase 24 (a): apps.train, dataset.host_store on the {wire} wire, lego-tpu on "
              f"{HOST_VIEWS[0]} views at {HOST_HW}x{HOST_HW} (written in {dataset_s:.2f} s): "
              f"{HOST_ITERS} steps in {secs:.2f} s (the scene's load and the host store's "
              f"build included); launches {json.dumps(counts)}; peak {peak_gb:.2f} GiB; loss "
              f"first {losses[0]:.5f} last {losses[-1]:.5f}; validation psnr {val_psnr}")
        run_checks(f"phase 24 (a) host store, {wire} wire", {
            f"{HOST_ITERS} finite losses": len(losses) == HOST_ITERS
            and bool(np.isfinite(losses).all()),
            "loss falls (mean of last 5 < first 5)": np.mean(losses[-5:]) < np.mean(losses[:5]),
            f"kernel 4's bf16 route {2 * HOST_ITERS} times, its f32 route never":
                counts["fused_train_loss_bf16"] == counts["fused_train_loss"] == 2 * HOST_ITERS,
            "validations at steps 0 and last through kernel 1's bf16 route":
                len(val_psnr) == 2 and counts["fused_render_bf16"] == counts["fused_render"] == 4,
            f"{HOST_ITERS} batches taken, every tensor on the card": len(cuda) == HOST_ITERS
            and all(cuda),
            "no resident store built": n_res == 0,
        })

    # ---- (b) the same indices and render draws through three steps
    cfg = load_config(runs["packed"][0])
    scene = ploop.load_scene(cfg)
    views = (scene.images[scene.i_train], scene.poses[scene.i_train], scene.hwf)
    near, far = float(cfg.dataset.near), float(cfg.dataset.far)
    s_train = render_settings_from_cfg(cfg, "train")
    batch, lr = int(cfg.nerf.train.num_random_rays), float(cfg.optimizer.lr)
    t0 = time.perf_counter()
    resident = build_ray_store(*views, near, far, device=dev)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, _ = hs.build_host_ray_rows(*views, device=dev)
    rows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u8, tables = hs.images_to_u8(views[0]), hs.build_pose_tables(views[1], views[2])
    packed_s = time.perf_counter() - t0
    unpack = hs.make_ray_unpack(tables, near, far)
    coarse0, fine0 = ploop.setup_models(cfg, SEED, dev)

    def fresh(dtype=bf16):
        st = init_train_state(copy.deepcopy(coarse0), copy.deepcopy(fine0), lr)
        return st, ftl.make_fused_train_loss(st.coarse, st.fine, s_train, compute_dtype=dtype,
                                             dw_dtype=dtype)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    renders = [draw_render_noise(batch, s_train, gen, dev) for _ in range(HOST_UPDATES)]
    rng = np.random.default_rng(SEED)
    idxs = [rng.integers(0, rows.shape[0], batch) for _ in range(HOST_UPDATES)]

    def three_steps(dtype, updates):
        """The resident, rows and packed steps' losses, parameters after
        ``updates`` updates through kernel 4's ``dtype`` route, and first
        update's gradients."""
        losses, params, grads = {}, {}, {}

        def leaves(st, grad=False):
            return [(p.grad if grad else p).detach().clone() for m in (st.coarse, st.fine)
                    for p in m.parameters()]

        def run(name, st, updates_of):
            losses[name] = []
            for j, one in enumerate(updates_of):
                losses[name].append(float(one()["loss"]))
                if j == 0:
                    grads[name] = leaves(st, grad=True)
            params[name] = leaves(st)

        st, fused = fresh(dtype)
        step = make_train_step(s_train, batch, fused_loss=fused)
        run("resident", st, [lambda i=i, r=r: step(st, resident, draws=[StepDraws(
            torch.as_tensor(i, device=dev), r)]) for i, r in zip(idxs[:updates], renders)])
        st, fused = fresh(dtype)
        step = make_batch_train_step(s_train, fused_loss=fused)
        with hs.HostRayLoader(rows, near, far, batch, SEED, device=dev) as loader:
            run("rows", st, [lambda r=r: step(st, *next(loader), draws=r)
                             for r in renders[:updates]])
        st, fused = fresh(dtype)
        step = make_batch_train_step(s_train, fused_loss=fused, unpack=unpack)
        with hs.HostPixelLoader(u8, batch, SEED, device=dev) as loader:
            run("packed", st, [lambda r=r: step(st, next(loader), draws=r)
                               for r in renders[:updates]])
        return losses, params, grads

    def packed_vs_rows(losses, params, grads):
        """The packed step against the rows step: the largest parameter
        difference after the updates, each update's loss difference over the
        loss, and the first update's largest gradient difference over its
        largest gradient entry."""
        return (max(float((a - b).abs().max()) for a, b in zip(params["packed"], params["rows"])),
                [abs(a - b) / abs(b) for a, b in zip(losses["packed"], losses["rows"])],
                max(float((a - b).abs().max()) for a, b in zip(grads["packed"], grads["rows"]))
                / max(float(g.abs().max()) for g in grads["rows"]))

    zero_counts()
    losses, params, grads = three_steps(bf16, HOST_UPDATES)
    counts_b = read_counts()
    rows_equal = all(bool(torch.equal(a, b)) for k in (params, grads)
                     for a, b in zip(k["rows"], k["resident"]))
    packed_err, loss_rel, grad_rel = packed_vs_rows(losses, params, grads)
    losses32, params32, grads32 = three_steps(torch.float32, HOST_F32_UPDATES)
    packed_err32, loss_rel32, grad_rel32 = packed_vs_rows(losses32, params32, grads32)
    print(f"phase 24 (b): {HOST_UPDATES} updates through kernel 4's bf16 route on the same "
          f"indices and render draws (batch {batch}): losses {json.dumps(losses)}; the rows "
          f"step's parameters and gradients equal the resident step's bit for bit: "
          f"{rows_equal}; packed vs rows: the first update's loss {loss_rel[0]:.3e} of it "
          f"(limit {PACKED_LOSS_RTOL:g}), its gradients {grad_rel:.3e} of the largest "
          f"gradient, the later losses {[float(f'{v:.3e}') for v in loss_rel[1:]]}, the "
          f"parameters after {HOST_UPDATES} updates {packed_err:.3e} apart (an ulp of a ray "
          f"moves a bf16 rounding, and Adam's updates carry it); {HOST_F32_UPDATES} updates "
          f"through the f32 route: losses {json.dumps(losses32)}, packed vs rows "
          f"{[float(f'{v:.3e}') for v in loss_rel32]} of the loss (limit "
          f"{PACKED_LOSS_RTOL:g}), the first update's gradients {grad_rel32:.3e} of the "
          f"largest gradient (limit {PACKED_GRAD_RTOL:g}), the parameters {packed_err32:.3e} "
          f"apart (not held: an entry whose gradient is within rounding of 0 takes Adam's "
          f"update with either sign); launches {json.dumps(counts_b)}; builds (host clock): "
          f"resident store {res_s:.2f} s, host rows {rows_s:.2f} s ({rows.nbytes / 1e9:.3f} "
          f"GB), u8 store and tables {packed_s:.2f} s ({u8.nbytes / 1e6:.1f} MB)")
    run_checks("phase 24 (b) host-store steps vs the resident step", {
        "rows step = resident step: parameters, gradients and losses bit for bit": rows_equal
        and losses["rows"] == losses["resident"],
        "packed step's first bf16 update: loss within PACKED_LOSS_RTOL of the rows step's":
            loss_rel[0] <= PACKED_LOSS_RTOL,
        f"packed step through the f32 route, {HOST_F32_UPDATES} updates: losses within "
        "PACKED_LOSS_RTOL, the first gradients within PACKED_GRAD_RTOL of the rows step's":
            max(loss_rel32) <= PACKED_LOSS_RTOL and grad_rel32 <= PACKED_GRAD_RTOL,
        f"kernel 4's bf16 route {3 * 2 * HOST_UPDATES} times":
            counts_b["fused_train_loss_bf16"] == 3 * 2 * HOST_UPDATES,
    })
    del params, params32, grads, grads32

    # ---- (c) step times, gather and copy, idle share, wire bytes
    timing = {}
    for n in HOST_BATCHES:
        st, fused = fresh()
        steps = {"resident": make_train_step(s_train, n, fused_loss=fused),
                 "rows": make_batch_train_step(s_train, fused_loss=fused),
                 "packed": make_batch_train_step(s_train, fused_loss=fused, unpack=unpack)}
        with hs.HostRayLoader(rows, near, far, n, SEED, device=dev, timing=True) as rl, \
                hs.HostPixelLoader(u8, n, SEED, device=dev, timing=True) as pl:
            wire = {"rows": rl.bytes_per_ray, "packed": pl.bytes_per_ray}
            fns = {"resident": lambda: steps["resident"](st, resident, gen),
                   "rows": lambda: (lambda b: steps["rows"](st, b[0], b[1], gen))(next(rl)),
                   "packed": lambda: steps["packed"](st, next(pl), gen)}
            turns = {k: [] for k in fns}
            for name in ("resident", "rows", "packed", "packed", "rows", "resident"):
                turns[name].append(round(host_ms(torch, fns[name], n=HOST_TIMED), 3))
            idle = {}
            for name, fn in fns.items():
                summary = {}
                print(f"  phase 24 (c): {name} step at {n} rays:")
                profile_steps(torch, fn, {"kernel 4 bf16": KERNEL4_BF16_NAMES,
                                          "copy": ("Memcpy HtoD", "Memcpy H2D")},
                              summary=summary)
                idle[name] = (round(summary["idle"] / summary["span"], 4)
                              if summary.get("span") else None)
            loads = {"rows": rl.timings(), "packed": pl.timings()}
        timing[n] = {"step_ms": turns, "idle_share": idle, "loader": loads,
                     "wire_bytes_per_ray": wire}
        print(f"phase 24 (c): ms on {card} at {n} rays a step: kernel-4 bf16 step (host clock "
              f"around synchronize, mean of {HOST_TIMED}, in turns resident, rows, packed, "
              f"packed, rows, resident) {json.dumps(turns)}; device idle share of the step "
              f"{json.dumps(idle)}; per batch: gather ms (host clock) and copy ms (device) "
              f"{json.dumps(loads)}; wire bytes a ray {json.dumps(wire)}")
        del st, fused, steps
    run_checks("phase 24 (c) timings", {
        "every timed step finite": all(np.isfinite(v).all() for t in timing.values()
                                       for v in t["step_ms"].values()),
        "wire: 48 B a ray of rows, 7 B packed": all(
            t["wire_bytes_per_ray"] == {"rows": 48, "packed": 7} for t in timing.values()),
    })
    print("phase 24 (c): " + json.dumps({"host_store_timing": timing}))

    # ---- kernel 4 on a batch of the scene, phase 7's rule
    _, coarse, fine, _ = run_models(runs["packed"][0], runs["packed"][1], HOST_ITERS, dev)
    k4 = hold_train_bf16("phase 24: kernel 4 bf16 route on a batch of the host-store scene",
                         24, (coarse, fine), resident, s_train, lr, batch, 3.0 * batch, {},
                         torch, dev)
    del resident, rows

    # ---- (d) the depth term on messytable, the field path, NDC on LLFF
    small = {}
    mdata = os.path.join(tmp, "messytable-host")
    write_messytable_dataset(mdata, *DEX_STORED_HW, DEX_VIEWS, device=dev)
    small["messytable-depth"] = train_cli(
        tmp, mdata, "messytable-host", HOST_SMALL_ITERS, torch, dev, config=CONFIG,
        dataset={"depth_valid_max": DEX_VALID_MAX, "host_store": True},
        flags=["--ir", "--dex", "--depth-loss", str(DEX_WEIGHT)], use_pallas=True)
    small["field-path"] = train_cli(tmp, data, "lego-host-fields", HOST_SMALL_ITERS, torch, dev,
                                    dataset={"host_store": True}, pallas_fused_loss=False)
    ldata = os.path.join(tmp, "llff-host")
    write_llff_dataset(ldata, *LLFF_HW, views=LLFF_VIEWS, device=dev)
    small["llff-ndc"] = train_cli(
        tmp, ldata, "llff-host", HOST_SMALL_ITERS, torch, dev, config=LLFF_CONFIG,
        dataset={"downsample_factor": 1, "depth_valid_max": LLFF_VALID_MAX, "host_store": True},
        use_pallas=True)
    n = 2 * HOST_SMALL_ITERS
    checks = {}
    for name, (_, logdir, counts, losses, _, secs, _) in small.items():
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        depth = [r["value"] for r in recs if r["tag"] == "train/depth_loss"]
        print(f"phase 24 (d): {name} on the packed wire, {HOST_SMALL_ITERS} steps in {secs:.2f} "
              f"s; launches {json.dumps(counts)}; losses {[round(v, 5) for v in losses]}; "
              f"depth_loss {[round(v, 6) for v in depth]}")
        checks[f"{name}: {HOST_SMALL_ITERS} finite losses"] = (
            len(losses) == HOST_SMALL_ITERS and bool(np.isfinite(losses).all()))
        if name == "field-path":
            checks[f"{name}: kernels 2 and 3's bf16 routes {n} times each, kernel 4 never"] = (
                counts["fused_mlp_bf16"] == counts["fused_mlp"] == n
                and counts["fused_mlp_train_bf16"] == counts["fused_mlp_train"] == n
                and counts["fused_train_loss"] == 0)
        else:
            checks[f"{name}: kernel 4's bf16 route {n} times"] = (
                counts["fused_train_loss_bf16"] == counts["fused_train_loss"] == n)
        if name == "messytable-depth":
            checks[f"{name}: train/depth_loss every step, finite"] = (
                len(depth) == HOST_SMALL_ITERS and bool(np.isfinite(depth).all()))
    run_checks("phase 24 (d) depth, field path and NDC on the host store", checks)
    entries = [train_entry(f"fused_train_loss_bf16@lego-host-{wire}",
                           runs[wire][2]["fused_train_loss_bf16"], k4)
               for wire in ("packed", "rows")]
    print(f"phase 24: kernels-line entries {[e['name'] for e in entries]}")
    return entries


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible to PyTorch")
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
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
    print("\n".join(l for l in _build.build_log.splitlines()
                    if "Compiling entry" in l or "registers" in l or "spill" in l
                    or "wgmma" in l or "arning" in l))

    # ---- phase 3: kernels vs plain at the slice's shapes
    bf16 = torch.bfloat16
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
    bkw = dict(kw, compute_dtype=bf16)
    thresholds = tuple(settings.m_thres_cand)
    z_c = stratified_z_vals(rays.near, rays.far, settings.num_coarse)
    calibrate_on((coarse, fine), rays, settings, torch)
    with torch.inference_mode():
        dist_c = ray_dists(z_c, d)
        args_c = (coarse, o, d, v, z_c, dist_c)
        got_c = fr.fused_render(*args_c, **kw)
        want_c = fr.fused_render_reference(*args_c, **kw)
        torch.cuda.synchronize()
        print(f"phase 3: f32 kernel vs plain on {o.shape[0]} rays")
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

        # the bf16 tensor-core kernel on the same inputs
        got_cb = fr.fused_render(*args_c, **bkw)
        want_cb = fr.fused_render_reference(*args_c, **bkw)
        torch.cuda.synchronize()
        print(f"phase 3: bf16 kernel vs bf16 plain (max <= own, p99.9 <= {BF16_P999:g} x own) "
              f"and vs f32 plain (<= {BF16_REL:g} x own), + {BF16_REL_ATOL:g}; own = bf16 "
              f"plain vs f32 plain")
        err_b = compare_bf16("coarse", got_cb, want_cb, want_c, torch)
        got_fb = fr.fused_render(*args_f, thresholds=thresholds, **bkw)
        want_fb = fr.fused_render_reference(*args_f, thresholds=thresholds, **bkw)
        torch.cuda.synchronize()
        err_b = max(err_b, compare_bf16("fine", got_fb, want_fb, want_f, torch))
        dex_b = float((got_fb.depth_dex == want_fb.depth_dex).float().mean())
        dex_bf = float((want_fb.depth_dex == want_f.depth_dex).float().mean())
        print(f"  dex: bf16 kernel = bf16 plain on {dex_b:.6f} of {got_fb.depth_dex.numel()} "
              f"pairs (limit {BF16_DEX_SHARE}); bf16 plain = f32 plain on {dex_bf:.6f}")
        if dex_b < BF16_DEX_SHARE:
            raise AssertionError(f"bf16 dex depths equal on only {dex_b:.6f} of pairs")

        # ---- phase 5 (timing), on the same inputs
        ms = {}
        for tag, k in (("", kw), ("_bf16", bkw)):
            ms["coarse_kernel" + tag] = timed_ms(lambda: fr.fused_render(*args_c, **k), torch)
            ms["coarse_plain" + tag] = timed_ms(
                lambda: fr.fused_render_reference(*args_c, **k), torch)
            ms["fine_kernel" + tag] = timed_ms(
                lambda: fr.fused_render(*args_f, thresholds=thresholds, **k), torch)
            ms["fine_plain" + tag] = timed_ms(
                lambda: fr.fused_render_reference(*args_f, thresholds=thresholds, **k), torch)
        # library yardsticks: the frame's layer products (its two passes'
        # forwards) as torch.matmul in each route's dtype (f32 with TF32 off)
        for dt in (torch.float32, bf16):
            pass_yardsticks(ms, "k1", [(coarse, z_c.numel()), (fine, z_f.numel())], torch, dev,
                            dt, parts=("forward",))
        frames = {}
        for tag, dt in (("", torch.float32), ("_bf16", bf16)):
            impl = fr.make_fused_render_rays(coarse, fine, settings, compute_dtype=dt)
            plain = plain_rays(coarse, fine, settings, dt, torch)
            frames[dt] = render_image(coarse, fine, ro, rd, near, far, settings, rays_impl=impl)
            ms["frame_kernel" + tag] = timed_ms(lambda: render_image(
                coarse, fine, ro, rd, near, far, settings, rays_impl=impl), torch)
            ms["frame_plain" + tag] = timed_ms(lambda: render_image(
                coarse, fine, ro, rd, near, far, settings, rays_impl=plain), torch)
        # bound of the two passes timed above: forward multiply-adds, and
        # the inputs, weights and outputs of each pass
        flops = sum(2 * (z.numel() * mlp_macs(m)[0] + z.shape[0] * mlp_macs(m)[1])
                    for m, z in ((coarse, z_c), (fine, z_f)))
        byts = sum(
            nbytes(o, d, v, z, dz, *m.parameters(), g.rgb, g.disparity, g.accumulation,
                   g.depth, g.weights, g.depth_dex)
            for m, z, dz, g in ((coarse, z_c, dist_c, got_c), (fine, z_f, dist_f, got_f))
        )
        # each kernel reads its own packed weights (the f32 route hi + lo
        # operands, the bf16 route bf16 operands; both f32 heads)
        packs = {"": fr.pack_flex_weights_tf32, "_bf16": fr.pack_flex_weights_bf16}
        byts_k = {tag: byts - sum(nbytes(*m.parameters()) - nbytes(*pack(m)[:2])
                                  for m in (coarse, fine)) for tag, pack in packs.items()}
        # the f32 route's own bound: three TF32 products a multiply-add on the
        # tensor cores; the f32 FMA bound of the same work beside it
        fma_bound, fma_bound_by = bound(flops, byts)
        render_bound, render_bound_by = bound(3 * flops, byts_k[""], TF32_FLOPS)
        bf16_bound, bf16_bound_by = bound(flops, byts_k["_bf16"], BF16_FLOPS)
        print(f"  fused_render bounds for both passes ({flops / 1e12:.4f} TFLOP): f32 route "
              f"{render_bound:.3f} ms at the split-TF32 rate ({render_bound_by}; 3 TF32 "
              f"products a multiply-add at {TF32_FLOPS / 1e12:g} TFLOP/s, "
              f"{byts_k[''] / 1e6:.2f} MB), {fma_bound:.3f} ms at the f32 FMA peak "
              f"({fma_bound_by}; {byts / 1e6:.2f} MB); bf16 kernel at the bf16 tensor-core "
              f"peak {bf16_bound:.3f} ms ({bf16_bound_by}; {byts_k['_bf16'] / 1e6:.2f} MB)")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for tag, label, occupancy, workers, mult, peak, gots in (
                ("", "f32 kernel (split TF32)", fr.tf32_occupancy, fr.TF32_WORKERS, 3,
                 TF32_FLOPS, (got_c, got_f)),
                ("_bf16", "bf16 kernel", fr.bf16_occupancy, fr.BF16_WORKERS, 1, BF16_FLOPS,
                 (got_cb, got_fb))):
            for name, m, z, dz, g in (("coarse", coarse, z_c, dist_c, gots[0]),
                                      ("fine", fine, z_f, dist_f, gots[1])):
                S = z.shape[1]
                ctas, smem, stages = occupancy(m, S)
                plan = fr.render_plan(z.shape[0], S, sms * ctas, workers)
                fl = 2 * (z.numel() * mlp_macs(m)[0] + z.shape[0] * mlp_macs(m)[1])
                by = nbytes(o, d, v, z, dz, *packs[tag](m)[:2], g.rgb, g.disparity,
                            g.accumulation, g.depth, g.weights, g.depth_dex)
                b_ms, b_by = bound(mult * fl, by, peak)
                k_ms = ms[name + "_kernel" + tag]
                extra = f", f32 FMA bound {bound(fl, by)[0]:.3f} ms" if mult == 3 else ""
                print(f"  {label}, {name} pass (S={S}): {k_ms:.3f} ms against its bound "
                      f"{b_ms:.3f} ms ({b_by}; {fl / 1e12:.4f} TFLOP, {by / 1e6:.2f} MB; "
                      f"{fl / 1e9 / k_ms:.1f} TFLOP/s of the model's own{extra}); {ctas} "
                      f"CTA(s) per SM, {smem} B shared, {stages} weight stages; plan: "
                      f"{plan.units} units of {plan.rays_per_unit} ray(s) in "
                      f"{plan.rows_per_unit} rows, {plan.rows} rows ({plan.padded_rows} "
                      f"padded), grid {plan.grid} of {workers} workers on {sms} SMs")

    # ---- phase 4: serve through the port's entry points
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "seeded.ckpt")
        write_reference_checkpoint(ckpt, coarse.state_dict(), fine.state_dict())
        q = "theta=%g&phi=%g&radius=%g" % POSE
        c2w = pose_spherical(*POSE).tolist()
        out, info, request_ms, frames_served, launches, launches_b = serve_requests(
            CONFIG, ckpt, [
                ("/healthz", None), ("/render?" + q, None), ("/depth?" + q, None),
                ("/depth?" + q + "&threshold=50", None),
                ("/depth?" + q + "&threshold=50&format=png", None),
                ("/confidence?" + q, None),
                ("/render", json.dumps({"c2w": c2w}).encode()),
            ], torch)
        # the f32 route: the same service with nerf.pallas_compute_dtype: float32
        f32_cfg = os.path.join(tmp, "messytable-obj-f32.yml")
        raw_cfg = load_config(CONFIG)
        raw_cfg.nerf.pallas_compute_dtype = "float32"
        with open(f32_cfg, "w") as f:
            f.write(raw_cfg.dump())
        out_f, _, request_ms_f, frames_f, launches_f, launches_fb = serve_requests(
            f32_cfg, ckpt, [("/depth?" + q, None)], torch)
        # nerf.use_fused_render: false asks for the plain renderer (no kernel 1)
        unf_cfg = os.path.join(tmp, "messytable-obj-unfused.yml")
        raw_cfg = load_config(CONFIG)
        raw_cfg.nerf.use_fused_render = False
        with open(unf_cfg, "w") as f:
            f.write(raw_cfg.dump())
        out_u, _, request_ms_u, frames_u, launches_u, _ = serve_requests(
            unf_cfg, ckpt, [("/depth?" + q, None)], torch)
        # hidden size 16 at bf16 (the kernel computes zero-padded to 32):
        # configs/tiny.yml's 2x16 model, seeded
        tiny_cfg = load_config(TINY_CONFIG)
        t_coarse, t_fine = setup_models(tiny_cfg, SEED, dev)
        tiny_ckpt = os.path.join(tmp, "tiny.ckpt")
        write_reference_checkpoint(tiny_ckpt, t_coarse.state_dict(), t_fine.state_dict())
        out_t, info_t, request_ms_t, frames_t, launches_t, launches_tb = serve_requests(
            TINY_CONFIG, tiny_ckpt, [("/healthz", None), ("/depth?" + q, None)], torch)
    t_settings = render_settings_from_cfg(tiny_cfg, "validation").eval_variant()
    with torch.inference_mode():
        zt = stratified_z_vals(rays.near, rays.far, t_settings.num_coarse)
        args_t = (t_coarse, o, d, v, zt, ray_dists(zt, d))
        tkw = dict(white_background=t_settings.white_background)
        got_t = fr.fused_render(*args_t, **tkw, compute_dtype=bf16)
        want_t = fr.fused_render_reference(*args_t, **tkw, compute_dtype=bf16)
        torch.cuda.synchronize()
        print(f"phase 4: hidden size 16 (configs/tiny.yml), bf16 kernel vs plain, coarse pass "
              f"of {zt.shape[1]} samples:")
        compare_bf16("tiny coarse", got_t, want_t, fr.fused_render_reference(*args_t, **tkw),
                     torch)
    from PIL import Image

    rgb = np.asarray(Image.open(io.BytesIO(out[1])))
    depth = np.load(io.BytesIO(out[2]))
    dex = np.load(io.BytesIO(out[3]))
    dex_mm = np.asarray(Image.open(io.BytesIO(out[4])))
    conf = np.load(io.BytesIO(out[5]))
    post = np.asarray(Image.open(io.BytesIO(out[6])))
    depth_f = np.load(io.BytesIO(out_f[0]))
    depth_u = np.load(io.BytesIO(out_u[0]))
    depth_t = np.load(io.BytesIO(out_t[1]))
    frame_f32 = frames[torch.float32].fine.depth.cpu().numpy()
    unfused_close = float(np.mean(np.abs(depth_u - frame_f32) <= 1e-3 + 1e-3 * np.abs(frame_f32)))
    print(f"phase 4: served {frames_served} frames at the config's default dtype, kernel-1 "
          f"launches {launches} (bf16 kernel {launches_b}); healthz m_thres "
          f"{info['m_thres_cand'][0]}..{info['m_thres_cand'][-1]}, compute dtype "
          f"{info.get('compute_dtype')}; request ms (host clock, first requests) "
          f"{json.dumps(request_ms)}")
    print(f"  nerf.pallas_compute_dtype: float32: served {frames_f} frame, launches "
          f"{launches_f} (bf16 kernel {launches_fb}); request ms {json.dumps(request_ms_f)}")
    print(f"  nerf.use_fused_render: false: served {frames_u} frame, kernel-1 launches "
          f"{launches_u}; depth within 1e-3 (+1e-3 rel) of the f32 kernel's frame on "
          f"{unfused_close:.6f} of pixels; request ms {json.dumps(request_ms_u)}")
    print(f"  configs/tiny.yml (hidden size {t_coarse.hidden_size}): served {frames_t} frame at "
          f"{info_t.get('compute_dtype')}, kernel-1 launches {launches_t} (bf16 kernel "
          f"{launches_tb}); request ms {json.dumps(request_ms_t)}")
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
        "served depth = direct bf16 render": np.allclose(
            depth, frames[bf16].fine.depth.cpu().numpy(), rtol=RTOL, atol=ATOL),
        "2 bf16 launches per frame, no f32 launch": frames_served == 6
        and launches_b == 2 * frames_served and launches == launches_b,
        "float32 config: served depth = direct f32 render": np.allclose(
            depth_f, frames[torch.float32].fine.depth.cpu().numpy(), rtol=RTOL, atol=ATOL),
        "float32 config: 2 f32 launches, no bf16 launch": frames_f == 1
        and launches_f == 2 and launches_fb == 0,
        "use_fused_render false: no kernel-1 launch, depth finite and = f32 frame on 99.9%":
            frames_u == 1 and launches_u == 0 and bool(np.isfinite(depth_u).all())
            and unfused_close >= 0.999,
        "hidden size 16 at bf16: 2 bf16 launches, depth 400x400 finite": frames_t == 1
        and launches_tb == 2 and launches_t == 2 and depth_t.shape == (H, W)
        and bool(np.isfinite(depth_t).all()),
    }
    run_checks("serving", checks)

    print("phase 5: ms per call on " + card + " (CUDA events, mean of 3): " + json.dumps(
        {k: round(t, 3) for k, t in ms.items()}))
    for label, dt, frag in (("kernel 1 bf16", bf16, "fused_render_bf16_kernel"),
                            ("kernel 1 f32", torch.float32, "fused_render_tf32_kernel")):
        impl = fr.make_fused_render_rays(coarse, fine, settings, compute_dtype=dt)
        with torch.inference_mode():
            profile_steps(torch, lambda: render_image(
                coarse, fine, ro, rd, near, far, settings, rays_impl=impl),
                {label: (frag,)}, unit="frame")
    with tempfile.TemporaryDirectory() as tmp:
        train_kernels, shared = train_phase(torch, np, card, dev, tmp)
        field_kernels = field_phase(torch, np, card, dev, tmp, shared)
        resample_kernels = resample_phase(torch, np, card, dev, tmp, shared)
        dex_cfg, dex_logdir, dex_kernels = dex_phase(torch, np, card, dev, tmp)
        eval_kernels = eval_phase(torch, np, card, dev, tmp, dex_cfg, dex_logdir)
        llff_kernels = llff_phase(torch, np, card, dev, tmp)
        occupancy_kernels = occupancy_phase(torch, np, card, dev, tmp, shared)
        family_kernels = families_phase(torch, np, card, dev, tmp, shared)
        pose_kernels = cache_pose_phase(torch, np, card, dev, tmp, shared)
        sgir_kernels = sgir_parallel_phase(torch, np, card, dev, tmp, shared)
        multiscene_kernels = multiscene_phase(torch, np, card, dev, tmp)
        wide_kernels = wide_phase(torch, np, card, dev, tmp, shared)
        wide_f32_kernels = wide_f32_phase(torch, np, card, dev, tmp, shared)
        host_kernels = host_store_phase(torch, np, card, dev, tmp)
    render = dict(route="cuda", replaces="dexnerf_tpu/ops/fused_render.py:115")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s (host clock, "
          "the kernels' build included)")
    print(json.dumps({"kernels": [{
        "name": "fused_render",
        **render,
        "source": "dexnerf_tpu_torch/ops/csrc/fused_render.cu",
        "launches": launches_f,
        "max_abs_err": err,
        "ms": ms["coarse_kernel"] + ms["fine_kernel"],
        "plain_ms": ms["coarse_plain"] + ms["fine_plain"],
        "bound_ms": render_bound,
        "bound_by": render_bound_by + SPLIT_TF32,
        "library_ms": ms["k1_forward_torch_matmul_f32"],
    }, {
        "name": "fused_render_bf16",
        **render,
        "source": "dexnerf_tpu_torch/ops/csrc/fused_render_bf16.cu",
        "launches": launches_b,
        "max_abs_err": err_b,
        "ms": ms["coarse_kernel_bf16"] + ms["fine_kernel_bf16"],
        "plain_ms": ms["coarse_plain_bf16"] + ms["fine_plain_bf16"],
        "bound_ms": bf16_bound,
        "bound_by": bf16_bound_by,
        "library_ms": ms["k1_forward_torch_matmul_bf16"],
    }, *train_kernels, *field_kernels, *resample_kernels, *dex_kernels, *eval_kernels,
        *llff_kernels, *occupancy_kernels, *family_kernels, *pose_kernels, *sgir_kernels,
        *multiscene_kernels, *wide_kernels, *wide_f32_kernels, *host_kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
