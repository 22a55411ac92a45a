"""Dex-NeRF render/depth service over HTTP, on a CUDA card or the CPU.

Counterpart of ``dexnerf_tpu/apps/serve.py``: the trained field stays
resident on the device and every frame goes through the fused render
kernel (two launches per frame: coarse and fine pass), behind a
dependency-free stdlib HTTP server.

    python -m dexnerf_tpu_torch.apps.serve --config configs/messytable-obj.yml \\
        --checkpoint model.ckpt --hwf 400 400 555.555 --device cuda

Endpoints (all GET unless noted):

* ``/healthz`` — JSON service info: frame geometry, sample budget, dex
  threshold candidates, occupancy state, timing of the last render.
* ``/render?theta=-30&phi=-45&radius=4`` — RGB PNG from a spherical-orbit
  camera.
* ``/depth?theta=..&phi=..&radius=..[&threshold=M][&format=npy|png]`` —
  metric depth: the expected depth, or the Dex-NeRF σ>M first-crossing
  depth when ``threshold`` is given (snapped to the config's ``m_thres``
  grid). ``format=npy`` (default) returns float32 meters; ``format=png``
  the reference's millimeter PNG.
* ``/confidence?...&delta=0.05[&format=npz|png]`` — expected depth and the
  weight mass within ±delta of it (refused with ``--occupancy``: it
  rebuilds full-interval z-values).
* ``POST /render`` — body ``{"c2w": [[..4x4..]], "output": "rgb"|"depth"
  [, "threshold": M]}``; returns PNG (rgb) or npy (depth).

With ``--occupancy SIGMA`` a σ-occupancy grid is baked from the checkpoint
at startup and every request's frame is rendered on ray intervals tightened
to their occupied spans (``render/occupancy.py``).

Requests serialize on an internal lock (one device, one render at a time);
the server is threaded so /healthz stays responsive mid-render.
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from dexnerf_tpu_torch.apps.eval import add_occupancy_flags, bake_occupancy


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve NeRF renders + Dex-NeRF metric depth over HTTP"
    )
    p.add_argument("--config", type=str, required=True)
    p.add_argument(
        "--checkpoint", type=str, required=True, help="a reference .ckpt"
    )
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument(
        "--hwf", type=float, nargs=3, default=None, metavar=("H", "W", "F"),
        help="frame geometry override (else checkpoint)",
    )
    p.add_argument(
        "--samples", type=int, nargs=2, default=None,
        metavar=("COARSE", "FINE"),
        help="override the config's validation sample counts",
    )
    p.add_argument(
        "--no-warmup", action="store_true",
        help="skip the startup render (first request pays the kernel build)",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=("cuda", "cpu"),
        help="where the field lives and renders",
    )
    add_occupancy_flags(p)
    return p


class RenderService:
    """The resident models, the frame renderers and the render lock."""

    def __init__(
        self, cfg, coarse, fine, settings, H: int, W: int, focal: float,
        *, device, rays_impl, occupancy=None, occupancy_probes: int = 128,
        occupancy_subsample: int = 2,
    ):
        self.H, self.W, self.focal = int(H), int(W), float(focal)
        self.settings = settings
        self.device = torch.device(device)
        self.coarse, self.fine = coarse, fine
        self.rays_impl = rays_impl
        self.occupancy = occupancy
        self.occupancy_probes = int(occupancy_probes)
        self.occupancy_subsample = int(occupancy_subsample)
        self.near, self.far = float(cfg.dataset.near), float(cfg.dataset.far)
        self.m_thres_cand = tuple(float(m) for m in (settings.m_thres_cand or ()))
        self.lock = threading.Lock()
        self.last_render_s: Optional[float] = None
        self.renders_served = 0
        # σ-threshold depth rides the FINE pass only
        self.has_dex = bool(
            self.m_thres_cand and fine is not None and settings.num_fine > 0
        )

    def _render(self, pose: np.ndarray):
        from dexnerf_tpu_torch.core.rays import get_ray_bundle_c2w
        from dexnerf_tpu_torch.render.renderer import render_image

        c2w = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        ro, rd = get_ray_bundle_c2w(self.H, self.W, self.focal, c2w)
        return render_image(
            self.coarse, self.fine, ro, rd, self.near, self.far, self.settings,
            rays_impl=self.rays_impl, occupancy=self.occupancy,
            occupancy_probes=self.occupancy_probes, occupancy_subsample=self.occupancy_subsample,
        )

    def _timed(self, fn):
        with self.lock, torch.inference_mode():
            t0 = time.perf_counter()
            out = fn()
            self.last_render_s = time.perf_counter() - t0
            self.renders_served += 1
        return out

    def warmup(self, verbose: bool = True) -> None:
        """Render once before serving (builds the kernel on a card)."""
        t0 = time.perf_counter()
        self.render_rgb(self.pose_from_angles(-30.0, -45.0, 4.0))
        if verbose:
            print(f"warmup: first frame rendered in {time.perf_counter() - t0:.1f}s")

    @staticmethod
    def pose_from_angles(theta: float, phi: float, radius: float) -> np.ndarray:
        from dexnerf_tpu_torch.data.blender import pose_spherical

        return np.asarray(pose_spherical(theta, phi, radius), np.float32)

    def nearest_threshold(self, m: float) -> int:
        if not self.has_dex:
            if not self.m_thres_cand:
                raise ValueError(
                    "this config defines no dex threshold candidates "
                    "(nerf.validation.m_thres)"
                )
            raise ValueError(
                "σ-threshold depth needs a fine pass (reference semantics): "
                "set nerf.validation.num_fine > 0 and configure a fine model"
            )
        return int(np.argmin(np.abs(np.asarray(self.m_thres_cand) - m)))

    @staticmethod
    def _final(out):
        return out.fine if out.fine is not None else out.coarse

    def render_rgb(self, pose: np.ndarray) -> np.ndarray:
        return self._timed(lambda: self._final(self._render(pose)).rgb.cpu().numpy())

    def render_depth(self, pose: np.ndarray, threshold: Optional[float] = None) -> np.ndarray:
        idx = None if threshold is None else self.nearest_threshold(float(threshold))

        def run():
            r = self._final(self._render(pose))
            d = r.depth if idx is None else r.depth_dex[idx]
            return d.cpu().numpy()

        return self._timed(run)

    def render_depth_conf(self, pose: np.ndarray, delta: float):
        from dexnerf_tpu_torch.core.sampling import hierarchical_z_vals, stratified_z_vals
        from dexnerf_tpu_torch.core.volrend import depth_confidence

        if self.occupancy is not None:
            raise ValueError(
                "depth confidence reconstructs full-interval z-values and "
                "is unavailable with --occupancy interval tightening"
            )

        def run():
            out = self._render(pose)
            r = self._final(out)
            # renders are deterministic, so the z-values are rebuilt from
            # the coarse weights
            wc = out.coarse.weights
            nearb = torch.full(wc.shape[:-1], self.near, dtype=wc.dtype, device=wc.device)
            z_c = stratified_z_vals(
                nearb, torch.full_like(nearb, self.far), self.settings.num_coarse,
                lindisp=self.settings.lindisp,
            )
            if out.fine is not None:
                z_w, _ = hierarchical_z_vals(z_c, wc, self.settings.num_fine, det=True)
                w = out.fine.weights
            else:
                z_w, w = z_c, wc
            c = depth_confidence(w, z_w, r.depth, float(delta))
            return r.depth.cpu().numpy(), c.cpu().numpy()

        return self._timed(run)

    def info(self) -> dict:
        return {
            "status": "ok",
            "device": str(self.device),
            "height": self.H,
            "width": self.W,
            "focal": self.focal,
            "num_coarse": int(self.settings.num_coarse),
            "num_fine": int(self.settings.num_fine),
            "m_thres_cand": list(self.m_thres_cand),
            "compute_dtype": str(getattr(self.rays_impl, "compute_dtype", "")).replace(
                "torch.", ""),
            "occupancy": self.occupancy is not None,
            "depth_confidence": self.occupancy is None,
            "renders_served": self.renders_served,
            "last_render_s": self.last_render_s,
        }


def _png(height: int, width: int, color_type: int, bit_depth: int, raw_rows: bytes) -> bytes:
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw_rows)) + chunk(b"IEND", b"")
    )


def _rows(pixels: np.ndarray) -> bytes:
    """Scanlines with filter type 0 (none) prepended."""
    h = pixels.shape[0]
    flat = np.ascontiguousarray(pixels).reshape(h, -1).view(np.uint8)
    return np.concatenate([np.zeros((h, 1), np.uint8), flat], axis=1).tobytes()


def _png_bytes(rgb01: np.ndarray) -> bytes:
    """8-bit PNG of values in [0, 1]: RGB for [H, W, 3], gray for [H, W]."""
    img = np.clip(np.asarray(rgb01) * 255.0, 0, 255).astype(np.uint8)
    color_type = 2 if img.ndim == 3 else 0
    return _png(img.shape[0], img.shape[1], color_type, 8, _rows(img))


def _depth_png_bytes(depth_m: np.ndarray) -> bytes:
    """Millimeter depth PNG — the reference's depth artifact
    (``train_nerf_rgb.py:395-399``), with the pixels a mode-"I" PIL save
    gives: 16-bit gray, millimeters truncated and clipped to [0, 65535]."""
    mm = np.clip((np.asarray(depth_m) * 1000.0).astype(np.uint32), 0, 65535)
    return _png(mm.shape[0], mm.shape[1], 0, 16, _rows(mm.astype(">u2")))


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return buf.getvalue()


def make_http_server(service: RenderService, host: str, port: int):
    """Build (not start) the threaded stdlib HTTP server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    def _angles(q) -> np.ndarray:
        theta = float(q.get("theta", ["-30"])[0])
        phi = float(q.get("phi", ["-45"])[0])
        radius = float(q.get("radius", ["4"])[0])
        return service.pose_from_angles(theta, phi, radius)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._reply(code, "application/json", json.dumps(obj).encode("utf-8"))

        def do_GET(self):
            try:
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/healthz":
                    self._json(200, service.info())
                elif u.path == "/render":
                    rgb = service.render_rgb(_angles(q))
                    self._reply(200, "image/png", _png_bytes(rgb))
                elif u.path == "/depth":
                    fmt = q.get("format", ["npy"])[0]
                    if fmt not in ("npy", "png"):
                        self._json(400, {"error": f"unknown format {fmt!r}"})
                        return
                    thres = q.get("threshold")
                    d = service.render_depth(
                        _angles(q), float(thres[0]) if thres else None
                    )
                    if fmt == "png":
                        self._reply(200, "image/png", _depth_png_bytes(d))
                    else:
                        self._reply(200, "application/octet-stream", _npy_bytes(d))
                elif u.path == "/confidence":
                    fmt = q.get("format", ["npz"])[0]
                    if fmt not in ("npz", "png"):
                        self._json(400, {"error": f"unknown format {fmt!r}"})
                        return
                    delta = float(q.get("delta", ["0.05"])[0])
                    d, c = service.render_depth_conf(_angles(q), delta)
                    if fmt == "npz":
                        buf = io.BytesIO()
                        np.savez(
                            buf, depth=d.astype(np.float32),
                            confidence=c.astype(np.float32),
                        )
                        self._reply(200, "application/octet-stream", buf.getvalue())
                    else:
                        gray = (np.clip(c, 0.0, 1.0) * 255.0).astype(np.uint8)
                        self._reply(200, "image/png", _png_bytes(gray / 255.0))
                else:
                    self._json(404, {"error": f"no route {u.path}"})
            except Exception as e:  # the server keeps running; the client sees why
                self._json(400, {"error": str(e)})

        def do_POST(self):
            try:
                u = urlparse(self.path)
                if u.path != "/render":
                    self._json(404, {"error": f"no route {u.path}"})
                    return
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                c2w = np.asarray(req["c2w"], np.float32)
                if c2w.shape != (4, 4):
                    raise ValueError(f"c2w must be 4x4, got {c2w.shape}")
                output = req.get("output", "rgb")
                if output == "rgb":
                    self._reply(200, "image/png", _png_bytes(service.render_rgb(c2w)))
                elif output == "depth":
                    d = service.render_depth(c2w, req.get("threshold"))
                    self._reply(200, "application/octet-stream", _npy_bytes(d))
                else:
                    raise ValueError(f"unknown output {output!r}")
            except Exception as e:  # the server keeps running; the client sees why
                self._json(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def build_service(args) -> RenderService:
    """Load config + checkpoint and construct the RenderService (shared by
    ``main`` and the tests)."""
    import dataclasses

    from dexnerf_tpu_torch.config import load_config, render_settings_from_cfg
    from dexnerf_tpu_torch.train.loop import (
        fused_render_impl,
        load_eval_params,
        setup_models,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible to PyTorch")
    cfg = load_config(args.config)
    cfg, sds, ck_hwf, _ = load_eval_params(cfg, args.checkpoint)
    coarse, fine = setup_models(cfg, int(cfg.experiment.randomseed), device)
    coarse.load_state_dict(sds["coarse"])
    if fine is not None and "fine" in sds:
        fine.load_state_dict(sds["fine"])
    else:
        fine = None
    H = W = focal = None
    if ck_hwf is not None:
        H, W, focal = ck_hwf
    if args.hwf is not None:
        H, W, focal = int(args.hwf[0]), int(args.hwf[1]), float(args.hwf[2])
    if H is None:
        raise SystemExit(
            "frame geometry unknown: pass --hwf H W FOCAL (e.g. "
            "`--hwf 400 400 555.555`)"
        )
    has_dex = "m_thres" in cfg.nerf.validation
    s_val = render_settings_from_cfg(cfg, "validation", dex=has_dex).eval_variant()
    if args.samples is not None:
        s_val = dataclasses.replace(
            s_val, num_coarse=int(args.samples[0]), num_fine=int(args.samples[1])
        )
    rays_impl = fused_render_impl(cfg, s_val, device, coarse, fine)
    return RenderService(
        cfg, coarse, fine, s_val, H, W, focal, device=device, rays_impl=rays_impl,
        occupancy=bake_occupancy(args, coarse, fine, s_val, device),
        occupancy_probes=args.occupancy_probes, occupancy_subsample=args.occupancy_subsample,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    service = build_service(args)
    if not args.no_warmup:
        service.warmup()
    httpd = make_http_server(service, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(
        f"serving on http://{host}:{port}  "
        f"(/healthz /render /depth /confidence; {service.H}x{service.W} on "
        f"{service.device}, {service.settings.num_coarse}+"
        f"{service.settings.num_fine} samples"
        + (
            f", dex thresholds {service.m_thres_cand[0]:g}.."
            f"{service.m_thres_cand[-1]:g}"
            if service.m_thres_cand
            else ""
        )
        + ")",
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
