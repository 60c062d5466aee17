#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--kernels]

Phases, each reported on its own line:
  1. device  — requires CUDA; prints the card and its power limit as
               nvidia-smi reports them; turns TF32 off.
  2. build   — compiles the CUDA kernels from ngp_tpu_torch/csrc and
               prints each one's registers and spills.
  3. slice   — the render path a user calls: NerfNetwork from
               configs/nerf/base.json at aabb_scale 4 with seeded random
               weights, an occupancy grid from a full sweep, then three
               640×360 frames through NerfRenderer.render (ms/frame after
               the first). K1's launch counter must rise during the
               frames. One frame is rendered again with the plain encode,
               and a small frame is checked against the CPU path (the one
               tested against the JAX package). Then frame 0 is rendered
               once more to capture the positions of its largest encode
               call (ray-major, t rising: the render path's own K1 input).
  4. kernels — K1 (encode forward), K2 (table backward), K3 (position
               backward), K4 (int8-table forward) and K5 (int8 table
               backward) against their plain PyTorch versions at the full
               NeRF width (16 levels × 8192 rows × 128 lanes; 2^20
               positions for K1 and K4, the 2^18 of a training batch for
               K2, K3 and K5, plus lattice vertices, the corners 0 and 1,
               and points just outside the unit cube), each timed against
               its plain version by CUDA events, in turns, beside its
               bound: the bytes it must move at the card's memory rate.
               K1 and K2 again on the captured ray-ordered positions
               (tiled to 2^20 for K1, the first 2^18 for K2).
  5. train   — the training path a user calls: NerfTrainer on a synthetic
               scene of analytic spheres (24 orbit views at 256×256, sRGB
               uint8), base.json at aabb_scale 4, the bench's trainer
               config (4096 rays, dynamic live-ray count, both error-map
               importance samplers) with the int8 grid sweep, for 512
               steps: warm-up full sweeps, partial sweeps after step 256,
               error-map CDF rebuilds. Prints ms/step, samples per step,
               the live ray count, peak memory and the PSNR of a training
               view before and after; the loss must stay finite, the PSNR
               rise by PSNR_RISE_DB, and K1, K2 and K4 must all launch.
               K2 on the positions and cotangent of one real step is
               held against the plain backward.
  6. pose    — camera optimisation on the same views: every view but
               view 0 gets a seeded pose error (0.5° about a random axis,
               0.005 of translation), and the trainer (optimize_extrinsics,
               optimize_exposure, optimize_focal_length, the ``full`` int8
               encode and the int8 grid sweep) trains 1024 steps. Prints,
               at the start and every 256 steps, the PSNR of view 0 and
               the mean rotation and translation error against the true
               poses (absolute and relative to view 0); then ms/step and
               the launch counts of the training; the loss must stay
               finite, K3, K4 and K5 launch, and the PSNR rise by
               POSE_PSNR_RISE_DB. K3 and K5 on one real step's inputs are
               held against their plain versions.
With ``--profile``, torch.profiler traces of one slice frame (K1's device
ms and launches in it) and of 16 steady training steps are broken down by
layer as well (the steps' table also to a file, see ``phase_profile``).
``--kernels`` runs phases 1, 2 and 4 alone, on a scene of its own, and
ends with the kernels' JSON line.
Then one JSON line with each kernel's figures (K1's and K2's ray-ordered
ones under "ray_ordered"), and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises: there is no fallback to the CPU or to the
plain version.
"""
from __future__ import annotations

import json
import math
import re
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
FOCAL = (500.0, 500.0)
KERNEL_TOL = 1e-5
# K2 against its plain version, relative to Σ|w·g| of each table entry
KERNEL_BWD_TOL = 1e-4
# K3 against its plain version, relative to Σ|term| of each component: the
# 256 terms (16 levels × 8 corners × 2 features) cancel, and the two sum
# them in other orders (the kernel with FMAs)
KERNEL_POS_TOL = 1e-5
# K5 against its plain version, relative to Σ_t scale_t·Σ|q| of each
# entry: the quanta are bit-equal (the same w·g, scale and rounding), but
# the kernel adds each scale·q by f32 atomics where the plain version sums
# q exactly within a tile
KERNEL_I8_TOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the training phase
TRAIN_VIEWS, TRAIN_RES, TRAIN_STEPS, WARMUP_STEPS = 24, 256, 512, 256
# 512-step runs on an NVIDIA H100 80GB HBM3 at 700 W rose 22.4-23.6 dB
PSNR_RISE_DB = 15.0
# the pose phase: from the trainer's first state the field is a fog for a
# few hundred steps (a 256-step run ended in it, below view 0's starting
# PSNR), so the phase trains 1024 steps and reports every 256
POSE_STEPS, POSE_REPORT_EVERY, POSE_ROT_DEG, POSE_TRANS = 1024, 256, 0.5, 0.005
# the first 1024-step run on an NVIDIA H100 80GB HBM3 at 700 W rose
# 19.13 dB; the gate keeps a 9 dB margin
POSE_PSNR_RISE_DB = 10.0
# the analytic spheres of scripts/make_synth_scene.py (center, radius,
# linear rgb, sigma), re-implemented here because that script imports jax
SPHERES = [((0.50, 0.50, 0.45), 0.16, (0.9, 0.25, 0.2), 60.0),
           ((0.34, 0.62, 0.58), 0.10, (0.2, 0.8, 0.3), 60.0),
           ((0.66, 0.38, 0.60), 0.09, (0.25, 0.35, 0.9), 60.0),
           ((0.50, 0.50, 0.22), 0.07, (0.9, 0.85, 0.3), 80.0)]


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


def kernel_registers(build_log: str) -> str:
    """Each kernel's spills and registers, from nvcc's ``-Xptxas -v``
    output (entry function, then spills, then registers)."""
    info = []
    for ln in build_log.splitlines():
        name = re.search(r"blocked_grid_encode_(?:fwd|bwd)\w*?kernel", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if "entry function" in ln and name:
            info.append(name.group(0))
        elif info and (regs or spill):
            info[-1] += (f" {regs.group(1)} registers" if regs
                         else f" {spill.group(1)} B spilled,")
    return " | ".join(info)


def phase_build():
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    t0 = time.perf_counter()
    bgc.build()
    dt = time.perf_counter() - t0
    print(f"build: {bgc.library_path().name} in {dt:.2f} s; "
          + kernel_registers(bgc.build_log))


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


def _full_width_inputs(dev, n: int):
    """The base.json blocked grid at aabb_scale 4 (16 levels × 8192 rows),
    a seeded table at std 0.5, and n random positions plus the edge
    positions."""
    from ngp_tpu_torch.config import (autofill_hashgrid_config,
                                      load_network_config)
    from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
    enc = autofill_hashgrid_config(
        load_network_config(ROOT / "configs/nerf/base.json")["encoding"], 3,
        2048.0, aabb_scale=4)
    meta = BlockedGridMeta.from_hashgrid_config(enc)
    assert (meta.n_levels, meta.rows) == (16, 8192), meta
    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn((meta.n_levels, meta.rows, 128), generator=g,
                        device=dev) * 0.5
    rng = np.random.default_rng(SEED)
    pos_np = np.concatenate([rng.random((n, 3), dtype=np.float32),
                             _edge_positions(meta, rng)])
    return meta, table, torch.from_numpy(pos_np).to(dev), rng


def _time_in_turns(kern, plain, kern_iters: int = 20, plain_iters: int = 5):
    """Warm both, then time plain, kernel, kernel, plain (CUDA events)."""
    for f in (plain, kern):
        f()
    p1 = _cuda_time_ms(plain, plain_iters)
    k1 = _cuda_time_ms(kern, kern_iters)
    k2 = _cuda_time_ms(kern, kern_iters)
    p2 = _cuda_time_ms(plain, plain_iters)
    return (k1, k2), (p1, p2)


# floating-point operations per (sample, level), counted from the kernels'
# source and rounded up: the geometry (9), the 8 corner weights (19), and
# per kernel the corner arithmetic. Every kernel is far below its byte
# bound on this count, so its bound is the bytes.
FLOPS_PER_LOOKUP = {"blocked_grid_encode_fwd": 60,
                    "blocked_grid_encode_bwd": 44,
                    "blocked_grid_encode_bwd_pos": 130,
                    "blocked_grid_encode_fwd_i8": 76,
                    "blocked_grid_encode_bwd_i8": 110}


def _touched_entries(meta, pos) -> int:
    """Table entries (level, row, lane) the positions' corners read, both
    features: what a kernel that reads the table must fetch at least."""
    from ngp_tpu_torch.kernels.blocked_grid import LANES, _corner_index
    touched = torch.zeros(meta.n_levels * meta.rows * LANES, dtype=torch.bool,
                          device=pos.device)
    for chunk in pos.split(1 << 18):
        idx, _ = _corner_index(meta, chunk)
        base = torch.arange(meta.n_levels, device=pos.device)[:, None, None] \
            * (meta.rows * LANES)
        for f in range(meta.n_features_per_level):
            touched[(idx + base + f).reshape(-1)] = True
    return int(touched.sum())


def _kernel_entry(name: str, line: int, err: float, ks, ps, n: int, meta,
                  n_bytes: float) -> dict:
    """The kernels-line entry: times, error, and the bound of the run's
    work: max(bytes / HBM rate, flops / f32 rate), in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_LOOKUP[name] * n * meta.n_levels / F32_FLOPS * 1e3
    return {"name": name, "route": "cuda",
            "source": "ngp_tpu_torch/csrc/blocked_grid_encode.cu",
            "replaces": f"ngp_tpu/kernels/hashgrid_pallas.py:{line}",
            "max_abs_err": err, "ms": sum(ks) / 2, "plain_ms": sum(ps) / 2,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": n_bytes}


def _print_times(tag: str, what: str, entry: dict, ks, ps):
    print(f"{tag}: {what}: kernel {ks[0]:.4f}/{ks[1]:.4f} ms, plain "
          f"{ps[0]:.4f}/{ps[1]:.4f} ms; bound {entry['bound_ms']:.4f} ms "
          f"({entry['bytes'] / 1e6:.1f} MB, {entry['bound_by']}): "
          f"{entry['bound_ms'] / entry['ms']:.3f} of the bound")


def check_k1(table, pos, meta, what: str) -> float:
    """K1 against its plain version on ``pos``; returns max |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference
    with torch.no_grad():
        got = bgc.launch_fwd(table, pos, meta)
        ref = encode_reference(table, pos, meta)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"K1 output is not finite ({what})")
    err = float((got - ref).abs().max())
    print(f"K1: blocked_grid_encode_fwd {tuple(table.shape)} x "
          f"{pos.shape[0]} {what} positions: max |kernel - plain| "
          f"{err:.3e} (tolerance {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise RuntimeError(f"K1 disagrees with its plain version ({what}): "
                           f"{err}")
    return err


def time_k1(table, p, meta, err: float, what: str) -> dict:
    """K1 and its plain version timed in turns on ``p``, with the bound of
    these inputs: positions in, features out, the table entries the
    corners read."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference
    with torch.no_grad():
        ks, ps = _time_in_turns(lambda: bgc.launch_fwd(table, p, meta),
                                lambda: encode_reference(table, p, meta))
    n = p.shape[0]
    entry = _kernel_entry("blocked_grid_encode_fwd", 85, err, ks, ps, n,
                          meta, 12 * n + 4 * 2 * meta.n_levels * n
                          + 4 * _touched_entries(meta, p))
    _print_times("K1", f"{n} {what} positions x {meta.n_levels} levels",
                 entry, ks, ps)
    return entry


def check_k2(pos, cot, meta, what: str) -> float:
    """K2 against its plain version. Atomics sum in no fixed order, so each
    entry is held to KERNEL_BWD_TOL relative to Σ|w·g| of that entry (the
    plain backward of |g|), and the zero patterns must be equal: the
    optimizer's zero-gradient skip keys on exact zeros. Returns max |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    with torch.no_grad():
        got = bgc.launch_bwd(pos, cot, meta)
        ref = encode_backward_reference(pos, cot, meta)
        scale = encode_backward_reference(pos, cot.abs(), meta)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"K2 output is not finite ({what})")
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / scale.clamp(min=1e-30)).max())
    zeros_equal = bool(torch.equal(got == 0, ref == 0))
    print(f"K2: blocked_grid_encode_bwd {pos.shape[0]} {what} positions -> "
          f"{tuple(got.shape)}: max |kernel - plain| {err:.3e}, max "
          f"relative to sum|w*g| {rel:.3e} (tolerance {KERNEL_BWD_TOL}); "
          f"zero patterns equal: {zeros_equal} "
          f"({float((ref == 0).float().mean()):.4f} of entries zero)")
    if not (rel <= KERNEL_BWD_TOL and zeros_equal):
        raise RuntimeError(f"K2 disagrees with its plain version ({what})")
    return err


def time_k2(p, c, meta, err: float, what: str) -> dict:
    """K2 (with the zero fill of its output) and its plain version timed in
    turns; the bound: positions and cotangent in, the whole table gradient
    out."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    with torch.no_grad():
        ks, ps = _time_in_turns(lambda: bgc.launch_bwd(p, c, meta),
                                lambda: encode_backward_reference(p, c, meta))
    n = p.shape[0]
    entry = _kernel_entry("blocked_grid_encode_bwd", 110, err, ks, ps, n,
                          meta, 12 * n + 4 * 2 * meta.n_levels * n
                          + 4 * meta.n_params)
    _print_times("K2", f"{n} {what} positions x {meta.n_levels} levels",
                 entry, ks, ps)
    return entry


def _ray_ordered(entry: dict, ray: dict) -> dict:
    """``entry`` (uniform inputs) with the ray-ordered run's figures under
    "ray_ordered" and the larger error of the two."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "max_abs_err")
    entry["ray_ordered"] = {k: ray[k] for k in keys}
    entry["max_abs_err"] = max(entry["max_abs_err"], ray["max_abs_err"])
    return entry


def phase_k1(dev, ray=None) -> dict:
    """K1 at 2^20 uniform positions (checked with the edge positions too)
    and, given ``ray`` (``ray_ordered_inputs``), at the render path's own
    2^20 positions."""
    meta, table, pos, _ = _full_width_inputs(dev, 1 << 20)
    err = check_k1(table, pos, meta, "uniform+edge")
    entry = time_k1(table, pos[: 1 << 20], meta, err, "uniform")
    if ray is None:
        return entry
    err = check_k1(table, ray["k1_pos"], meta, "ray-ordered")
    return _ray_ordered(entry, time_k1(table, ray["k1_pos"], meta, err,
                                       "ray-ordered"))


def phase_k2(dev, ray=None) -> dict:
    """K2 at the training batch: 2^18 uniform positions × 16 levels (checked
    with the edge positions too) with seeded cotangents, every fifth row
    zero (rays without samples); given ``ray``, at the first 2^18 of the
    render path's positions too."""
    meta, _, pos, _ = _full_width_inputs(dev, 1 << 18)
    cot = _cotangent(dev, meta, pos.shape[0], SEED + 1)
    err = check_k2(pos, cot, meta, "uniform+edge")
    entry = time_k2(pos[: 1 << 18], cot[: 1 << 18], meta, err, "uniform")
    if ray is None:
        return entry
    err = check_k2(ray["k2_pos"], ray["k2_cot"], meta, "ray-ordered")
    return _ray_ordered(entry, time_k2(ray["k2_pos"], ray["k2_cot"], meta,
                                       err, "ray-ordered"))


def phase_k4(dev) -> dict:
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (encode_reference_i8,
                                                    quantize_table_i8)
    meta, table, pos, _ = _full_width_inputs(dev, 1 << 20)
    with torch.no_grad():
        tq, qs = quantize_table_i8(table)
        got = bgc.blocked_grid_encode_i8fwd(table, pos, meta)
        ref = encode_reference_i8(tq, qs, pos, meta)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("K4 output is not finite")
        err = float((got - ref).abs().max())
        print(f"K4: blocked_grid_encode_fwd_i8 {tuple(tq.shape)} int8 x "
              f"{pos.shape[0]} positions: max |kernel - plain| {err:.3e} "
              f"(tolerance {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"K4 disagrees with its plain version: {err}")
        p = pos[: 1 << 20]
        ks, ps = _time_in_turns(
            lambda: bgc.launch_fwd_i8(tq, qs, p, meta),
            lambda: encode_reference_i8(tq, qs, p, meta))
        n = p.shape[0]
        # positions and level scales in, features out, one byte per entry
        entry = _kernel_entry("blocked_grid_encode_fwd_i8", 354, err, ks, ps,
                              n, meta, 12 * n + 4 * meta.n_levels
                              + 4 * 2 * meta.n_levels * n
                              + _touched_entries(meta, p))
    _print_times("K4", "2^20 positions x 16 levels", entry, ks, ps)
    return entry


def _cotangent(dev, meta, n: int, seed: int) -> torch.Tensor:
    """Seeded (n, L·2) cotangents, every fifth sample zero (rays without
    samples)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn((n, meta.n_levels * 2), generator=g, device=dev)
    cot[::5] = 0.0
    return cot


def check_pos_grad(table, pos, cot, meta, got) -> float:
    """K3's output against the plain position backward: each component
    within KERNEL_POS_TOL of its Σ|term|. Returns the largest error
    relative to Σ|term|."""
    from ngp_tpu_torch.kernels.blocked_grid import (
        encode_position_backward_reference as plain)
    with torch.no_grad():
        ref = plain(table, pos, cot, meta)
        mag = plain(table, pos, cot, meta, magnitude=True)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("K3 output is not finite")
    diff = (got - ref).abs()
    exact = mag == 0
    if bool((diff[exact] != 0).any()):
        raise RuntimeError("K3 is nonzero where every term is zero")
    return float((diff / mag.clamp(min=1e-30)).max())


def check_i8_grad(pos, cot, meta, tile: int, got):
    """K5's output against the plain int8 backward: each entry within
    KERNEL_I8_TOL of its Σ_t scale_t·Σ|q|, and exactly 0 where every q is
    0. Returns (largest error relative to that, max |Δ|, entries whose
    nonzero quanta cancel to 0 in the plain version, entries that are 0
    there)."""
    from ngp_tpu_torch.kernels.blocked_grid import (
        encode_backward_reference_i8 as plain)
    with torch.no_grad():
        ref = plain(pos, cot, meta, tile)
        mag = plain(pos, cot, meta, tile, magnitude=True)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("K5 output is not finite")
    if bool((got[mag == 0] != 0).any()):
        raise RuntimeError("K5 is nonzero where every quantum is zero")
    diff = (got - ref).abs()
    rel = float((diff / mag.clamp(min=1e-30)).max())
    cancelled = int(((ref == 0) & (mag > 0)).sum())
    return rel, float(diff.max()), cancelled, int((ref == 0).sum())


def phase_k3(dev) -> dict:
    """K3 at the training batch: 2^18 positions × 16 levels plus the edge
    positions, seeded cotangents, the f32 table at std 0.5."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (
        encode_position_backward_reference)
    meta, table, pos, _ = _full_width_inputs(dev, 1 << 18)
    cot = _cotangent(dev, meta, pos.shape[0], SEED + 3)
    with torch.no_grad():
        got = bgc.launch_bwd_pos(table, pos, cot, meta)
        torch.cuda.synchronize()
        rel = check_pos_grad(table, pos, cot, meta, got)
        err = float((got - encode_position_backward_reference(
            table, pos, cot, meta)).abs().max())
        print(f"K3: blocked_grid_encode_bwd_pos {pos.shape[0]} positions -> "
              f"{tuple(got.shape)}: max |kernel - plain| {err:.3e}, max "
              f"relative to sum|term| {rel:.3e} (tolerance {KERNEL_POS_TOL})")
        if not rel <= KERNEL_POS_TOL:
            raise RuntimeError("K3 disagrees with its plain version")
        p, c = pos[: 1 << 18], cot[: 1 << 18]
        ks, ps = _time_in_turns(
            lambda: bgc.launch_bwd_pos(table, p, c, meta),
            lambda: encode_position_backward_reference(table, p, c, meta))
        n = p.shape[0]
        # positions, cotangent and the entries the corners read in, dpos out
        entry = _kernel_entry("blocked_grid_encode_bwd_pos", 157, err, ks, ps,
                              n, meta, 12 * n + 4 * 2 * meta.n_levels * n
                              + 4 * _touched_entries(meta, p) + 12 * n)
    _print_times("K3", "2^18 positions x 16 levels", entry, ks, ps)
    return entry


def phase_k5(dev) -> dict:
    """K5 on K3's positions, with cotangents seeded apart, in tiles of 2048
    samples (the tile of a 2^18-sample stream; the last tile partial)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (
        DEFAULT_TILE, encode_backward_reference_i8)
    meta, _, pos, _ = _full_width_inputs(dev, 1 << 18)
    cot = _cotangent(dev, meta, pos.shape[0], SEED + 4)
    tile = DEFAULT_TILE
    with torch.no_grad():
        got = bgc.launch_bwd_i8(pos, cot, meta, tile)
        torch.cuda.synchronize()
        rel, err, cancelled, zeros = check_i8_grad(pos, cot, meta, tile, got)
        print(f"K5: blocked_grid_encode_bwd_i8 {pos.shape[0]} positions, tile "
              f"{tile} -> {tuple(got.shape)}: max |kernel - plain| "
              f"{err:.3e}, max relative to sum_t scale_t*sum|q| {rel:.3e} "
              f"(tolerance {KERNEL_I8_TOL}); exact zeros where every q is 0; "
              f"{zeros / got.numel():.4f} of entries zero in the plain "
              f"version, {cancelled} of them by cancelling quanta")
        if not rel <= KERNEL_I8_TOL:
            raise RuntimeError("K5 disagrees with its plain version")
        p, c = pos[: 1 << 18], cot[: 1 << 18]
        ks, ps = _time_in_turns(
            lambda: bgc.launch_bwd_i8(p, c, meta, tile),
            lambda: encode_backward_reference_i8(p, c, meta, tile),
            plain_iters=2)
    n = p.shape[0]
    # positions and cotangent in, the whole table gradient out
    entry = _kernel_entry("blocked_grid_encode_bwd_i8", 383, err, ks, ps, n,
                          meta, 12 * n + 4 * 2 * meta.n_levels * n
                          + 4 * meta.n_params)
    _print_times("K5", "2^18 positions x 16 levels", entry, ks, ps)
    return entry


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


def capture_ray_positions(renderer, bitfield, cam, width: int, height: int,
                          focal):
    """Render one frame spp 1 and return the positions of its largest
    encode call, as the encode wrapper handed them to K1 (or, for CPU
    tensors, to K1's plain version), and each sample's ray id: the stream
    ``compact_samples`` emits, ray-major with t rising along each ray."""
    import ngp_tpu_torch.render.nerf_render as nr
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    name = "launch_fwd" if bitfield.is_cuda else "encode_reference"
    encode, compact = getattr(bgc, name), nr.compact_samples
    seen, rays = [], []

    def spy_encode(table, pos, meta):
        seen.append(pos.clone())
        return encode(table, pos, meta)

    def spy_compact(*args):
        out = compact(*args)
        rays.append(out[2])
        return out
    with mock.patch.object(bgc, name, spy_encode), \
            mock.patch.object(nr, "compact_samples", spy_compact):
        renderer.render(None, bitfield, cam, width, height, focal=focal,
                        spp=1)
    if [p.shape[0] for p in seen] != [r.shape[0] for r in rays]:
        raise RuntimeError("the frame's encode calls do not match its "
                           "compacted sample streams")
    k = max(range(len(seen)), key=lambda j: seen[j].shape[0])
    return seen[k], rays[k]


def ray_ordered_inputs(dev, renderer=None, bitfield=None) -> dict:
    """K1's and K2's inputs as the render path sends them: the positions of
    the largest encode call of the slice phase's frame 0 (scene from
    ``build_scene`` unless given), tiled up to 2^20 for K1; the first 2^18
    of those for K2, with seeded cotangents, every fifth row zero."""
    if renderer is None:
        _, grid, renderer, _ = build_scene(dev)
        bitfield = grid.bitfield
    pos, rays = capture_ray_positions(renderer, bitfield, orbit_camera(0.0),
                                      FRAME_W, FRAME_H, FOCAL)
    n = pos.shape[0]
    k1_pos = pos.repeat(-(-(1 << 20) // n), 1)[: 1 << 20].contiguous()
    meta = renderer.model.pos_encoding.meta
    print(f"ray: the largest encode call of frame 0 took {n} samples on "
          f"{int(torch.unique(rays).numel())} rays (tiled to 2^20 for K1)")
    k2_pos = k1_pos[: 1 << 18]
    return {"k1_pos": k1_pos, "k2_pos": k2_pos,
            "k2_cot": _cotangent(dev, meta, k2_pos.shape[0], SEED + 1)}


def _check_frame(img, W, H):
    if tuple(img.shape) != (H, W, 4):
        raise RuntimeError(f"frame shape {tuple(img.shape)} != {(H, W, 4)}")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("frame has non-finite values")
    a = img[..., 3]
    if not (float(a.min()) >= 0.0 and float(a.max()) <= 1.0):
        raise RuntimeError("opacity outside [0, 1]")


def _reset_launches():
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    for k in bgc.launches:
        bgc.launches[k] = 0


def phase_slice(dev):
    """The render path; returns (K1's launches in its frames, the renderer,
    the bitfield)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference

    _reset_launches()
    t0 = time.perf_counter()
    model, grid, renderer, n_cells = build_scene(dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    occupied = float((grid.bitfield != 0).float().mean())
    print(f"slice: grid full sweep of {n_cells} cells in {sweep_s:.3f} s "
          f"(incl. model init); mean σΔt {float(grid.mean):.4e}; "
          f"{occupied:.3f} of bitfield bytes set")
    cams = [orbit_camera(2 * math.pi * i / N_FRAMES) for i in range(N_FRAMES)]
    frames, frame_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    for i, cam in enumerate(cams):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render(None, grid.bitfield, cam, FRAME_W, FRAME_H,
                              focal=FOCAL, spp=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check_frame(img, FRAME_W, FRAME_H)
        n = renderer.last_n_samples
        print(f"slice: frame {i} {FRAME_W}x{FRAME_H} in {dt * 1e3:.1f} ms; "
              f"{n} samples ({n / dt:.4e} samples/s); mean opacity "
              f"{float(img[..., 3].mean()):.4f}")
        frames.append(img)
        frame_ms.append(dt * 1e3)
    launches = bgc.launches["blocked_grid_encode_fwd"]
    print(f"slice: {np.mean(frame_ms[1:]):.2f} ms/frame after the first; "
          f"blocked_grid_encode_fwd launched {launches} times; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches <= 0:
        raise RuntimeError("the render path never launched the kernel")

    # frame 0 again with the plain encode in place of the kernel
    with mock.patch.object(bgc, "blocked_grid_encode", encode_reference):
        plain = renderer.render(None, grid.bitfield, cams[0], FRAME_W,
                                FRAME_H, focal=FOCAL, spp=1)
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
    return launches, renderer, grid.bitfield


def _sphere_field(pos: torch.Tensor):
    """(rgb, sigma) of the spheres at (N, 3) positions: a smooth shell and
    a constant core, colours blended by density."""
    sigma = torch.zeros(pos.shape[0], device=pos.device)
    rgb = torch.zeros((pos.shape[0], 3), device=pos.device)
    for c, r, col, sig in SPHERES:
        d = torch.linalg.vector_norm(pos - torch.tensor(c, device=pos.device),
                                     dim=-1)
        add = sig * torch.clamp((r - d) / (0.15 * r), 0.0, 1.0)
        w = add / torch.clamp(sigma + add, min=1e-9)
        rgb = rgb * (1 - w[:, None]) + torch.tensor(col, device=pos.device) \
            * w[:, None]
        sigma = sigma + add
    return rgb, sigma


def _render_spheres(o, d, n_steps: int = 384, t0: float = 0.05,
                    t1: float = 2.5):
    """Brute-force volume render of the spheres along o + t·d → (linear
    premultiplied rgb, alpha)."""
    ts = torch.linspace(t0, t1, n_steps, device=o.device)
    dt = float(ts[1] - ts[0])
    acc = torch.zeros_like(o)
    T = torch.ones(o.shape[0], device=o.device)
    for t in ts:
        rgb, sigma = _sphere_field(o + t * d)
        alpha = 1.0 - torch.exp(-sigma * dt)
        acc += (T * alpha)[:, None] * rgb
        T = T * (1.0 - alpha)
    return acc, 1.0 - T


def _orbit_xforms(n: int, radius: float = 1.05, seed: int = 0):
    """NGP camera→world matrices on a jittered orbit around 0.5³ (as
    scripts/make_synth_scene.py places them)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ang, elev = i * 2 * math.pi / n, 0.25 + 0.4 * rng.rand()
        fwd = -np.array([math.cos(ang) * math.cos(elev),
                         math.sin(ang) * math.cos(elev), math.sin(elev)])
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        out.append(np.stack([right, np.cross(fwd, right), fwd,
                             0.5 - radius * fwd], 1))
    return np.stack(out).astype(np.float32)


def build_sphere_dataset(dev, n_views: int, res: int, aabb_scale: int = 4):
    """The spheres seen from an orbit, rendered on ``dev`` along the
    trainer's own pixel-centre rays, held as sRGB uint8 RGBA (the path
    real captures take) in the port's NerfDataset."""
    from ngp_tpu_torch.common import linear_to_srgb
    from ngp_tpu_torch.data.nerf_loader import LazyImageArray, NerfDataset
    xfs = _orbit_xforms(n_views)
    fl = 1.1 * res
    px = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res
    v, u = torch.meshgrid(px, px, indexing="ij")
    d_cam = torch.stack([(u - 0.5) * res / fl, (v - 0.5) * res / fl,
                         torch.ones_like(u)], -1).reshape(-1, 3)
    u8 = np.empty((n_views, res, res, 4), np.uint8)
    for i, xf in enumerate(torch.from_numpy(xfs).to(dev)):
        d = d_cam @ xf[:, :3].T
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        rgb, a = _render_spheres(xf[:, 3].expand_as(d), d)
        c = linear_to_srgb(torch.clamp(rgb / torch.clamp(a, min=1e-6)[:, None],
                                       0.0, 1.0))
        img = torch.cat([c, a[:, None]], -1).reshape(res, res, 4)
        u8[i] = torch.round(img * 255).to(torch.uint8).cpu().numpy()
    n = n_views
    return NerfDataset(
        images=LazyImageArray(u8), xforms=xfs, xforms_end=xfs.copy(),
        focal=np.full((n, 2), fl, np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        resolution=np.full((n, 2), res, np.int32),
        lens_params=np.zeros((n, 7), np.float32), lens_is_opencv=False,
        depth_images=None, aabb_scale=aabb_scale, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(n, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32), images_u8=u8)


def make_trainer(dataset, dev, config=None, **options):
    """The bench's trainer (bench.py: 4096 rays, dynamic live-ray count,
    both error-map samplers) with the int8 grid sweep, on base.json;
    ``options`` set further NerfTrainerConfig fields."""
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.train.nerf import NerfTrainer, NerfTrainerConfig
    cfg = config or load_network_config(ROOT / "configs/nerf/base.json")
    return NerfTrainer(dataset, cfg, seed=SEED, device=dev,
                       tcfg=NerfTrainerConfig(
                           n_rays=4096, adapt_rays=False, dynamic_rays=True,
                           sample_image_proportional_to_error=True,
                           sample_focal_plane_proportional_to_error=True,
                           grid_int8=True, **options))


def view_psnr(tr, view: int = 0) -> float:
    """PSNR in sRGB of training view ``view`` rendered with the inference
    (EMA) parameters over black, as bench.py measures it."""
    from ngp_tpu_torch.common import linear_to_srgb
    from ngp_tpu_torch.data.image_io import u8_to_linear_rgba
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    ds = tr.dataset
    W, H = (int(x) for x in ds.resolution[view])
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=W, height=H, background=(0, 0, 0, 0), linear_out=True))
    img = r.render(tr.inference_params(), tr.grid.bitfield, ds.xforms[view],
                   W, H, focal=tuple(float(f) for f in ds.focal[view]))
    _check_frame(img, W, H)
    gt = torch.from_numpy(u8_to_linear_rgba(ds.images_u8[view])).to(
        img.device)
    mse = torch.mean((linear_to_srgb(torch.clamp(img[..., :3], 0, 1))
                      - linear_to_srgb(torch.clamp(gt[..., :3], 0, 1))) ** 2)
    return -10.0 * math.log10(max(float(mse), 1e-12))


def step_grad_check(tr):
    """K2 on the positions and cotangent of one real training step,
    against the plain backward on the same inputs: the step's table
    gradient, with the K2 phase's tolerance and zero-pattern check.
    Returns (max |Δ| relative to Σ|w·g|, whether the zero patterns are
    equal)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    seen = []

    def spy(pos, grad, meta):
        seen.append((pos, grad, meta))
        return launch_bwd(pos, grad, meta)
    launch_bwd = bgc.launch_bwd
    g = torch.Generator(device=tr.device).manual_seed(SEED + 2)
    draws = tr.draws(tr.tcfg.n_rays, g).head(tr._n_live)
    with mock.patch.object(bgc, "launch_bwd", spy):
        grads = tr._step_grads(draws, tr._error_state())[0]
    pos, grad, meta = seen[0]
    got = grads["pos_encoding.table"]
    with torch.no_grad():
        ref = encode_backward_reference(pos, grad, meta)
        scale = encode_backward_reference(pos, grad.abs(), meta)
    rel = float(((got - ref).abs() / scale.clamp(min=1e-30)).max())
    return rel, bool(torch.equal(got == 0, ref == 0))


def phase_train(dev, n_views: int = TRAIN_VIEWS, res: int = TRAIN_RES,
                steps: int = TRAIN_STEPS, warmup: int = WARMUP_STEPS,
                config=None):
    """Train the spheres through NerfTrainer.train; returns the launch
    counts of the run and the trainer."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    t0 = time.perf_counter()
    ds = build_sphere_dataset(dev, n_views, res)
    tr = make_trainer(ds, dev, config)
    psnr0 = view_psnr(tr)
    print(f"train: {ds.n_images} views {res}x{res} built in "
          f"{time.perf_counter() - t0:.2f} s; PSNR of view 0 before "
          f"training {psnr0:.2f} dB")
    cuda = dev.type == "cuda"    # False only in a CPU rehearsal

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    sync()
    t0 = time.perf_counter()
    loss_w = tr.train(warmup)
    sync()
    t1 = time.perf_counter()
    loss = tr.train(steps - warmup)
    sync()
    t2 = time.perf_counter()
    launches = dict(bgc.launches)
    ms_warm = (t1 - t0) * 1e3 / warmup
    ms = (t2 - t1) * 1e3 / (steps - warmup)
    n_s = tr.last_samples
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda \
        else float("nan")
    print(f"train: steps 0-{warmup - 1} (full sweeps) {ms_warm:.2f} ms/step; "
          f"steps {warmup}-{steps - 1} (partial sweeps) {ms:.2f} ms/step; "
          f"last step {n_s} samples ({n_s / (ms * 1e-3):.4e} samples/s), "
          f"{tr._n_live} live rays, {tr.last_surviving_segments} segments; "
          f"loss {loss_w:.4e} -> {loss:.4e}; peak device memory "
          f"{peak:.2f} GiB")
    print(f"train: launches in the run {launches}")
    if (tr.training_step != steps or tr.grid.ema_step
            != steps // tr.tcfg.n_steps_between_grid_updates):
        raise RuntimeError(f"trainer at step {tr.training_step}, grid "
                           f"update {tr.grid.ema_step}")
    if not (math.isfinite(loss) and math.isfinite(loss_w)):
        raise RuntimeError(f"training loss is not finite: {loss}")
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd",
                           "blocked_grid_encode_fwd_i8") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the training path never launched {missing}")
    psnr1 = view_psnr(tr)
    print(f"train: PSNR of view 0 after {steps} steps {psnr1:.2f} dB "
          f"(+{psnr1 - psnr0:.2f} dB; required +{PSNR_RISE_DB})")
    if not psnr1 - psnr0 >= PSNR_RISE_DB:
        raise RuntimeError("training did not raise the PSNR enough")
    rel, zeros_equal = step_grad_check(tr)
    print(f"train: one step's table gradient, K2 vs plain backward on its "
          f"inputs: max |Δ| relative to sum|w*g| {rel:.3e} (tolerance "
          f"{KERNEL_BWD_TOL}); zero patterns equal: {zeros_equal}")
    if not (rel <= KERNEL_BWD_TOL and zeros_equal):
        raise RuntimeError("the step's K2 gradient disagrees with the plain "
                           "backward")
    return launches, tr


def _rotation_about(axis: np.ndarray, angle: float) -> np.ndarray:
    k = axis / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def perturb_poses(xforms: np.ndarray, seed: int) -> np.ndarray:
    """Every view but view 0 rotated by POSE_ROT_DEG about a random axis
    and moved by POSE_TRANS in a random direction."""
    rng = np.random.default_rng(seed)
    out = xforms.copy()
    for i in range(1, len(out)):
        R = _rotation_about(rng.standard_normal(3), math.radians(POSE_ROT_DEG))
        t = rng.standard_normal(3)
        out[i, :, :3] = R @ xforms[i, :, :3]
        out[i, :, 3] = xforms[i, :, 3] + POSE_TRANS * t / np.linalg.norm(t)
    return out.astype(np.float32)


def _relative_to(xf0: np.ndarray, xf: np.ndarray) -> np.ndarray:
    """Camera→world ``xf`` in the frame of camera ``xf0``."""
    R0 = xf0[:, :3]
    return np.concatenate([R0.T @ xf[:, :3], (R0.T @ (xf[:, 3] - xf0[:, 3]))
                           [:, None]], 1)


def pose_errors(tr, true_xforms: np.ndarray):
    """Mean rotation error (degrees) and translation error of views 1…
    of the trainer's optimised poses against the true ones: absolute, and
    relative to view 0 (each pose in the frame of view 0's own optimised
    or true pose), which a rigid drift of all poses together does not
    change. ((rot, trans), (rot relative, trans relative))."""
    est = [tr.get_camera_extrinsics(i).astype(np.float64)
           for i in range(len(true_xforms))]
    true = true_xforms.astype(np.float64)

    def mean_errors(pairs):
        rot, trans = [], []
        for e, t in pairs:
            R = e[:, :3] @ t[:, :3].T
            # the angle from sin and cos, exact near 0 where acos is not
            sin = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                  R[1, 0] - R[0, 1]]) / 2.0
            rot.append(math.degrees(math.atan2(sin, (np.trace(R) - 1) / 2)))
            trans.append(float(np.linalg.norm(e[:, 3] - t[:, 3])))
        return float(np.mean(rot)), float(np.mean(trans))
    views = range(1, len(true))
    return (mean_errors((est[i], true[i]) for i in views),
            mean_errors((_relative_to(est[0], est[i]),
                         _relative_to(true[0], true[i])) for i in views))


def step_kernel_check(tr):
    """K3 and K5 on the inputs of one real camera-optimising step, against
    their plain versions: (K3's largest error relative to Σ|term|, K5's
    relative to Σ_t scale_t·Σ|q|)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    seen = {}

    def spy(name, fn):
        def wrapped(*args):
            seen[name] = args
            return fn(*args)
        return wrapped
    g = torch.Generator(device=tr.device).manual_seed(SEED + 5)
    draws = tr.draws(tr.tcfg.n_rays, g).head(tr._n_live)
    with mock.patch.object(bgc, "launch_bwd_pos",
                           spy("pos", bgc.launch_bwd_pos)), \
            mock.patch.object(bgc, "launch_bwd_i8",
                              spy("i8", bgc.launch_bwd_i8)):
        grads = tr._step_grads(draws, tr._error_state())[0]
    table, pos, cot, meta = seen["pos"]
    # K3 is deterministic (no atomics): rerun it on the step's inputs
    with torch.no_grad():
        rel_pos = check_pos_grad(table, pos, cot, meta,
                                 bgc.launch_bwd_pos(table, pos, cot, meta))
    pos, cot, meta, tile = seen["i8"]
    rel_i8 = check_i8_grad(pos, cot, meta, tile,
                           grads["pos_encoding.table"])[0]
    return rel_pos, rel_i8, tile, pos.shape[0]


def phase_pose(dev, ds, steps: int = POSE_STEPS, config=None):
    """Camera optimisation on ``ds`` with seeded pose errors; returns the
    launch counts of the run."""
    import dataclasses as dc

    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    true_xforms = ds.xforms
    pert = dc.replace(ds, xforms=perturb_poses(true_xforms, SEED + 6),
                      xforms_end=None)
    tr = make_trainer(pert, dev, config, optimize_extrinsics=True,
                      optimize_exposure=True, optimize_focal_length=True,
                      encode_int8="full")
    cuda = dev.type == "cuda"    # False only in a CPU rehearsal

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def report(step, psnr, loss=float("nan")):
        (rot, trans), (rrot, rtrans) = pose_errors(tr, true_xforms)
        print(f"pose: step {step}: PSNR of view 0 {psnr:.2f} dB; loss "
              f"{loss:.4e}; {tr.last_samples} samples, {tr._n_live} live "
              f"rays; mean pose error of views 1-{ds.n_images - 1} "
              f"{rot:.4f} deg, {trans:.5f}; relative to view 0 {rrot:.4f} "
              f"deg, {rtrans:.5f}")
    psnr0 = view_psnr(tr)
    report(0, psnr0)
    # the launches and time of the training alone, in segments between
    # the checkpoint reports (whose renders launch K1)
    launches = dict.fromkeys(bgc.launches, 0)
    train_s = 0.0
    for start in range(0, steps, POSE_REPORT_EVERY):
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        loss = tr.train(min(POSE_REPORT_EVERY, steps - start))
        sync()
        train_s += time.perf_counter() - t0
        for k, v in bgc.launches.items():
            launches[k] += v
        if not math.isfinite(loss):
            raise RuntimeError(f"pose training loss is not finite: {loss}")
        psnr1 = view_psnr(tr)
        report(tr.training_step, psnr1, loss)
    print(f"pose: {steps} steps (extrinsics, exposure, focal; int8 full; "
          f"int8 grid sweep) {train_s * 1e3 / steps:.2f} ms/step; focal "
          f"delta "
          f"{tr.cam_params['focal_delta'].cpu().numpy().round(6).tolist()}")
    print(f"pose: launches in the run {launches}")
    missing = [k for k in ("blocked_grid_encode_bwd_pos",
                           "blocked_grid_encode_fwd_i8",
                           "blocked_grid_encode_bwd_i8")
               if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the pose path never launched {missing}")
    print(f"pose: PSNR of view 0 {psnr0:.2f} -> {psnr1:.2f} dB "
          f"(+{psnr1 - psnr0:.2f} dB; required +{POSE_PSNR_RISE_DB})")
    if not psnr1 - psnr0 >= POSE_PSNR_RISE_DB:
        raise RuntimeError("pose training did not raise the PSNR enough")
    rel_pos, rel_i8, tile, n = step_kernel_check(tr)
    print(f"pose: one step's kernels vs plain on its inputs ({n} samples, "
          f"tile {tile}): K3 max |Δ| relative to sum|term| {rel_pos:.3e} "
          f"(tolerance {KERNEL_POS_TOL}); K5 relative to "
          f"sum_t scale_t*sum|q| {rel_i8:.3e} (tolerance {KERNEL_I8_TOL})")
    if not (rel_pos <= KERNEL_POS_TOL and rel_i8 <= KERNEL_I8_TOL):
        raise RuntimeError("the step's K3 or K5 disagrees with the plain "
                           "version")
    return launches


def _attribute_kernels(prof, span_names, main_span: str):
    """Device work of a trace by the span that launched it. Each kernel,
    copy or fill is matched through its correlation id to the runtime call
    that launched it, and counted in every ``record_function`` span on that
    thread around the call (kernels bound through ctypes belong to no torch
    op, so the op tree alone misses them). Returns (per-span ms, ms
    launched from other threads than the one running ``main_span``
    (autograd's backward), total ms, busy ms: the union of the device
    intervals)."""
    from torch.autograd import DeviceType
    ev = prof.profiler.kineto_results.events()
    work = [e for e in ev if e.device_type() == DeviceType.CUDA
            and e.name() not in span_names]
    launch = {e.correlation_id(): e for e in ev
              if e.device_type() == DeviceType.CPU
              and e.name().startswith(("cuda", "cu")) and "Launch" in e.name()
              or e.name().startswith(("cudaMemcpy", "cudaMemset"))}
    spans = [e for e in ev if e.device_type() == DeviceType.CPU
             and e.name() in span_names]
    main_tids = {e.start_thread_id() for e in spans
                 if e.name() == main_span}
    per_span, other, unmatched = {}, 0.0, 0
    for k in work:
        r = launch.get(k.correlation_id())
        ms = k.duration_ns() / 1e6
        if r is None:
            unmatched += 1
            continue
        if r.start_thread_id() not in main_tids:
            other += ms
        for sp in spans:
            if (sp.start_thread_id() == r.start_thread_id()
                    and sp.start_ns() <= r.start_ns() <= sp.end_ns()):
                per_span[sp.name()] = per_span.get(sp.name(), 0.0) + ms
    if unmatched:
        print(f"profile: {unmatched} of {len(work)} device events matched no "
              "launch")
    busy, end = 0.0, -math.inf
    for s0, s1 in sorted((k.start_ns(), k.end_ns()) for k in work):
        busy += max(0, s1 - max(s0, end))
        end = max(end, s1)
    total = sum(k.duration_ns() for k in work) / 1e6
    return per_span, other, total, busy / 1e6


def phase_profile(tr, steps: int = 16):
    """Trace ``steps`` training steps (one grid boundary) with
    torch.profiler and print the device time of the work launched inside
    each layer's span (spans nest: the step holds the others, the network
    forward holds K1, the grid sweep K4). The backward runs on autograd's
    own thread and is counted apart, K2 within it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import ngp_tpu_torch.train.nerf as tnerf
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    layers = [(tr, "_train_step", "step"),
              (tr, "_sample_pixels", "sample pixels"),
              (tr, "_build_rays", "build rays"),
              (tnerf, "march_and_compact_hier", "march"),
              (tr.model, "apply", "network fwd (K1 + MLPs)"),
              (bgc, "launch_fwd", "K1 encode fwd"),
              (bgc, "launch_bwd", "K2 encode bwd"),
              (tnerf, "apply_update", "Adam"),
              (tr, "_deposit_error", "error map"),
              (tr, "_grid_update", "grid sweep"),
              (bgc, "launch_fwd_i8", "K4 encode fwd i8")]
    patches = [mock.patch.object(o, a, span(n, getattr(o, a)))
               for o, a, n in layers]
    cuda = tr.device.type == "cuda"     # False only in a CPU rehearsal

    def sync():
        if cuda:
            torch.cuda.synchronize()
    for p in patches:
        p.start()
    try:
        tr.train(tr.tcfg.n_steps_between_grid_updates
                 - tr.training_step % tr.tcfg.n_steps_between_grid_updates)
        sync()
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            t0 = time.perf_counter()
            tr.train(steps)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    per_span, other, total, busy = _attribute_kernels(
        prof, {n for _, _, n in layers}, "step")
    rows = [(n, per_span.get(n, 0.0)) for _, _, n in layers]
    rows.insert(6, ("backward (autograd thread)", other))
    lines = [f"profile: {steps} steps traced in {wall_ms:.1f} ms "
             f"({wall_ms / steps:.2f} ms/step); device work {total:.2f} ms "
             f"({total / steps:.3f} ms/step), busy {busy:.2f} ms: idle "
             f"share {1 - busy / wall_ms:.3f}"]
    lines += [f"profile: {n:<28s} {ms:9.3f} ms device "
              f"({ms / steps:.3f} ms/step, {ms / max(total, 1e-9):.3f})"
              for n, ms in rows]
    print("\n".join(lines))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_profile.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40) + "\n")


def phase_profile_frame(renderer, bitfield):
    """Trace one slice frame with torch.profiler: the device time of the
    work launched inside each render layer's span, and K1's launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import ngp_tpu_torch.render.nerf_render as nr
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    layers = [(renderer, "render", "frame"),
              (nr, "march_rays", "march_rays"),
              (nr, "merge_excess_samples", "merge_excess_samples"),
              (nr, "compact_samples", "compact_samples"),
              (renderer.model, "forward", "network (K1 + MLPs)"),
              (bgc, "launch_fwd", "K1 encode fwd"),
              (nr, "composite_samples", "composite_samples")]
    patches = [mock.patch.object(o, a, span(n, getattr(o, a)))
               for o, a, n in layers]
    for p in patches:
        p.start()
    try:
        _reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            renderer.render(None, bitfield, orbit_camera(0.0), FRAME_W,
                            FRAME_H, focal=FOCAL, spp=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    k1_launches = bgc.launches["blocked_grid_encode_fwd"]
    per_span, _, total, busy = _attribute_kernels(
        prof, {n for _, _, n in layers}, "frame")
    lines = [f"profile: frame 0 {FRAME_W}x{FRAME_H} traced in {wall_ms:.1f} "
             f"ms; device work {total:.2f} ms, busy {busy:.2f} ms: idle "
             f"share {1 - busy / wall_ms:.3f}; K1 "
             f"{per_span.get('K1 encode fwd', 0.0):.3f} ms device in "
             f"{k1_launches} launches"]
    lines += [f"profile: frame {n:<24s} {per_span.get(n, 0.0):9.3f} ms device"
              for _, _, n in layers]
    print("\n".join(lines))


def kernel_phases(dev, ray) -> list:
    """K1–K5 against their plain versions, timed; K1 and K2 on the
    render path's ray-ordered inputs too."""
    return [phase_k1(dev, ray), phase_k2(dev, ray), phase_k3(dev),
            phase_k4(dev), phase_k5(dev)]


def main() -> int:
    args = sys.argv[1:]
    device = phase_device()
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    phase_build()
    if "--kernels" in args:
        # the kernel phases alone, on their own scene: no main path is run,
        # so no launch counts and no "ok" line
        kernels = kernel_phases(dev, ray_ordered_inputs(dev))
        print(json.dumps({"kernels": kernels}))
        return 0
    _, renderer, bitfield = phase_slice(dev)
    if "--profile" in args:
        phase_profile_frame(renderer, bitfield)
    kernels = kernel_phases(dev, ray_ordered_inputs(dev, renderer, bitfield))
    del renderer, bitfield
    launches, tr = phase_train(dev)
    if "--profile" in args:
        phase_profile(tr)
    pose_launches = phase_pose(dev, tr.dataset)
    # each kernel's launches in the run of the path it was ported for: the
    # training phase (K1, K2, K4), the pose phase (K3, K5)
    for k in kernels:
        k["launches"] = (pose_launches if k["name"] in (
            "blocked_grid_encode_bwd_pos", "blocked_grid_encode_bwd_i8")
            else launches)[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
