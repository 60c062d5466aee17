#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device  — requires CUDA; prints the card and its power limit as
               nvidia-smi reports them; turns TF32 off.
  2. build   — compiles the CUDA kernels from ngp_tpu_torch/csrc.
  3. kernel  — the blocked-grid encode kernel against its plain PyTorch
               version at the full NeRF width (16 levels × 8192 rows ×
               128 lanes, 2^20 positions plus lattice vertices, the
               corners 0 and 1, and points just outside the unit cube),
               with both timed by CUDA events.
  4. slice   — the render path a user calls: NerfNetwork from
               configs/nerf/base.json at aabb_scale 4 with seeded random
               weights, an occupancy grid from a full sweep, then three
               640×360 frames through NerfRenderer.render. The kernel's
               launch counter must rise during this run. One frame is
               rendered again with the plain encode, and a small frame is
               checked against the CPU path (the one tested against the
               JAX package).
Then one JSON line with each kernel's figures, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: there is no
fallback to the CPU or to the plain version.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
FRAME_W, FRAME_H, N_FRAMES = 640, 360, 3
KERNEL_TOL = 1e-5


def _cuda_time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # full-f32 products in the MLPs, as the JAX package's f32 accumulation
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build():
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    t0 = time.perf_counter()
    bgc.build()
    dt = time.perf_counter() - t0
    info = [ln.strip() for ln in bgc.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {bgc.library_path().name} in {dt:.2f} s; "
          + " | ".join(info))


def _edge_positions(meta, rng) -> np.ndarray:
    """Corners 0 and 1, dyadic points, positions up to 0.1 outside the
    unit cube (where the block clip engages), and positions on every
    level's lattice vertices (pos·scale + 0.5 integral)."""
    pts = [np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32),
           rng.random((4096, 3), dtype=np.float32) * 1.2 - 0.1,
           (rng.integers(0, 1025, (4096, 3)) / 1024.0).astype(np.float32)]
    for s in meta.level_scales:
        m = rng.integers(1, int(s) + 1, (4096, 3)).astype(np.float32)
        pts.append(np.clip((m - np.float32(0.5)) / np.float32(s), 0, 1))
    return np.concatenate(pts).astype(np.float32)


def phase_kernel(dev) -> dict:
    from ngp_tpu_torch.config import (autofill_hashgrid_config,
                                      load_network_config)
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (BlockedGridMeta,
                                                    encode_reference)
    enc = autofill_hashgrid_config(
        load_network_config(ROOT / "configs/nerf/base.json")["encoding"], 3,
        2048.0, aabb_scale=4)
    meta = BlockedGridMeta.from_hashgrid_config(enc)
    assert (meta.n_levels, meta.rows) == (16, 8192), meta
    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn((meta.n_levels, meta.rows, 128), generator=g,
                        device=dev) * 0.5
    rng = np.random.default_rng(SEED)
    pos_np = np.concatenate([rng.random((1 << 20, 3), dtype=np.float32),
                             _edge_positions(meta, rng)])
    pos = torch.from_numpy(pos_np).to(dev)
    with torch.no_grad():
        got = bgc.blocked_grid_encode(table, pos, meta)
        ref = encode_reference(table, pos, meta)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("kernel output is not finite")
        err = float((got - ref).abs().max())
        print(f"kernel: blocked_grid_encode_fwd {tuple(table.shape)} x "
              f"{pos.shape[0]} positions: max |kernel - plain| {err:.3e} "
              f"(tolerance {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"kernel disagrees with plain version: {err}")

        def kern():
            bgc.blocked_grid_encode(table, pos[: 1 << 20], meta)

        def plain():
            encode_reference(table, pos[: 1 << 20], meta)
        for f in (plain, kern):
            f()
        # in turns: plain, kernel, kernel, plain
        p1 = _cuda_time_ms(plain, 5)
        k1 = _cuda_time_ms(kern, 20)
        k2 = _cuda_time_ms(kern, 20)
        p2 = _cuda_time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"kernel: 2^20 positions x 16 levels: kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms")
    return {"name": "blocked_grid_encode_fwd", "route": "cuda",
            "source": "ngp_tpu_torch/csrc/blocked_grid_encode.cu",
            "replaces": "ngp_tpu/kernels/hashgrid_pallas.py:85",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def orbit_camera(angle: float, radius: float = 2.2,
                 height: float = 0.35) -> np.ndarray:
    """NGP camera→world (x right, y down, z forward) on a circle around
    the scene centre 0.5³, looking at it."""
    fwd = np.array([np.cos(angle), np.sin(angle), -height])
    fwd /= np.linalg.norm(fwd)
    eye = 0.5 - radius * fwd
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, eye],
                    axis=1).astype(np.float32)


def build_scene(dev, aabb_scale: int = 4, sweep_chunk: int = 1 << 18):
    """The full-width base.json NeRF with seeded random weights (table
    redrawn at std 0.5 so the field has structure; tcnn's ±1e-4 init gives
    a uniform fog) and its occupancy grid from one full sweep."""
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.grid import occupancy as occ
    from ngp_tpu_torch.nn.models import NerfNetwork
    from ngp_tpu_torch.rays.marching import cone_angle_for
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions

    g = torch.Generator(device=dev).manual_seed(SEED)
    model = NerfNetwork(load_network_config(ROOT / "configs/nerf/base.json"),
                        aabb_scale, generator=g, device=dev)
    with torch.no_grad():
        model.pos_encoding.table.normal_(0.0, 0.5, generator=g)
    aabb_min, aabb_size = 0.5 - aabb_scale / 2.0, float(aabb_scale)
    max_cascade = max(0, int(math.log2(aabb_scale)))

    def density_fn(x):   # chunked like the trainer's sweep
        return torch.cat([model.density(c) for c in x.split(sweep_chunk)])
    n_cells = occ.GRID_VOLUME * (max_cascade + 1)
    with torch.no_grad():
        grid = occ.update_grid(occ.init_grid(max_cascade, dev), density_fn,
                               g, max_cascade, n_uniform=n_cells,
                               n_nonuniform=1, aabb_min=aabb_min,
                               aabb_size=aabb_size)
    renderer = NerfRenderer(model, aabb_min, aabb_size,
                            cone_angle_for(aabb_scale), max_cascade,
                            RenderOptions(march_steps=1024, spp=1))
    return model, grid, renderer, n_cells


def _check_frame(img, W, H):
    if tuple(img.shape) != (H, W, 4):
        raise RuntimeError(f"frame shape {tuple(img.shape)} != {(H, W, 4)}")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("frame has non-finite values")
    a = img[..., 3]
    if not (float(a.min()) >= 0.0 and float(a.max()) <= 1.0):
        raise RuntimeError("opacity outside [0, 1]")


def phase_slice(dev) -> int:
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference

    bgc.launches = 0
    t0 = time.perf_counter()
    model, grid, renderer, n_cells = build_scene(dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    occupied = float((grid.bitfield != 0).float().mean())
    print(f"slice: grid full sweep of {n_cells} cells in {sweep_s:.3f} s "
          f"(incl. model init); mean σΔt {float(grid.mean):.4e}; "
          f"{occupied:.3f} of bitfield bytes set")
    cams = [orbit_camera(2 * math.pi * i / N_FRAMES) for i in range(N_FRAMES)]
    focal = (500.0, 500.0)
    frames = []
    torch.cuda.reset_peak_memory_stats()
    for i, cam in enumerate(cams):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render(None, grid.bitfield, cam, FRAME_W, FRAME_H,
                              focal=focal, spp=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check_frame(img, FRAME_W, FRAME_H)
        n = renderer.last_n_samples
        print(f"slice: frame {i} {FRAME_W}x{FRAME_H} in {dt * 1e3:.1f} ms; "
              f"{n} samples ({n / dt:.4e} samples/s); mean opacity "
              f"{float(img[..., 3].mean()):.4f}")
        frames.append(img)
    launches = bgc.launches
    print(f"slice: blocked_grid_encode_fwd launched {launches} times; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches <= 0:
        raise RuntimeError("the render path never launched the kernel")

    # frame 0 again with the plain encode in place of the kernel
    with mock.patch.object(bgc, "blocked_grid_encode", encode_reference):
        plain = renderer.render(None, grid.bitfield, cams[0], FRAME_W,
                                FRAME_H, focal=focal, spp=1)
    d = (plain - frames[0]).abs()
    print(f"slice: frame 0 kernel vs plain encode: mean |Δ| "
          f"{float(d.mean()):.3e}, max {float(d.max()):.3e}")
    if not float(d.mean()) <= 2e-4:
        raise RuntimeError("render with the kernel disagrees with the plain "
                           "encode")

    # a small frame against the CPU path, with the same weights and grid
    w, h, f = 64, 36, (50.0, 50.0)
    gpu = renderer.render(None, grid.bitfield, cams[1], w, h, focal=f)
    model.cpu()
    cpu = renderer.render(None, grid.bitfield.cpu(), cams[1], w, h, focal=f)
    model.to(dev)
    err = (gpu.cpu() - cpu).abs()
    within = float((err <= 2e-3).all(-1).float().mean())
    print(f"slice: {w}x{h} frame GPU vs CPU path: mean |Δ| "
          f"{float(err.mean()):.3e}, {within:.4f} of pixels within 2e-3")
    if not (float(err.mean()) <= 2e-4 and within >= 0.995):
        raise RuntimeError("GPU render disagrees with the CPU path")
    return launches


def main() -> int:
    device = phase_device()
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    phase_build()
    kernel = phase_kernel(dev)
    kernel["launches"] = phase_slice(dev)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
