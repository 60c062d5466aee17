#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--kernels] [--adam] [--k2-zeros N]

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
               its plain version in turns (the kernel by CUDA-graph
               replays, the plain version by CUDA events), beside its
               bound: the bytes it must move at the card's memory rate.
               K1, K2 and K3 again on the captured ray-ordered positions
               (tiled to 2^20 for K1, the first 2^18 for K2 and K3, with
               K2's cotangent); K4 also at the 2^18 positions of one
               grid-sweep call, and the table's int8 quantisation alone.
               K3 reports its level group G and is launched twice on
               each input set: the two results must be bit-equal (it sums
               across levels in a fixed order, without atomics).
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
               held against the plain backward, and K4 on the trainer's
               own grid-sweep positions (the first 2^18-position call of
               a full sweep and of a partial one) against its plain
               version, timed beside it.
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
               held against their plain versions (K3 launched twice,
               bit-equal) and timed there beside their bounds.
  7. testbed — the user surface, under NGP_TPU_GRID_INT8=1 as bench.py
               runs: the train phase's views and 4 held-out ones written
               to build/testbed_smoke as PNGs with transforms.json files;
               ``python -m ngp_tpu_torch.run``'s main with --n_steps 0 (the
               held-out PSNR before training), then 512 steps with a
               snapshot, held-out PSNR/SSIM and 640×360 screenshots (the
               ``iteration=`` lines finite and exact, the PSNR rise at
               least PSNR_RISE_DB); the CLI's screenshot of training view 0
               from the snapshot against the runner's frame of it, bit for
               bit; a Testbed loaded from the snapshot renders every render
               mode, ACES, a crop box, a DoF frame and a motion-blurred
               camera-path frame (each gated and timed; K3 must launch in
               the NORMALS frame); the Blender plugin's flow. K1, K2, K3
               and K4 must launch in the phase.
  8. multinerf — the Blender render engine (render/multi_nerf.py) and the
               pyngp shim on the testbed phase's snapshot, a copy of it
               under a second path and a reference-layout (params_binary)
               snapshot of a seeded tcnn-layout network that the port's
               exporter writes: 640×360 requests at held-out view 0 (its
               PSNR by the runner's protocol within MULTINERF_PSNR_DB of
               the runner's), camera and scene moved by one rigid motion
               (mean |Δ| ≤ RIGID_TOL), two fields in "nearest" and "sum"
               with opacity and masks (a subtract box over the AABB leaves
               no alpha; an opacity-0 field leaves the sum frame bit for
               bit), the spherical-quadrilateral and
               quadrilateral-hexahedron cameras, spp 4 with an aperture,
               ACES with exposure in the linear colour space, a 1280×720
               request at mip 1; the shim's sync and async renders (the
               same bits), a rolling-shutter frame and a Testbed frame
               with a subtract box in render_masks (alpha cut through the
               box, unchanged elsewhere); three fields with the reference
               one (its tcnn-layout gather timed by CUDA events) and a
               64×36 frame of them against the CPU (mean |Δ| ≤
               MULTINERF_CPU_TOL). Each request's ms is printed; K1 must
               launch in the phase and K2–K5 must not.
  9. wave    — the wave (live-sample) renderers on the testbed phase's
               snapshot, held-out view 0 at 640×360 with the Testbed's
               render options: the static frame, the device-dispatch wave
               frame (the defaults) and the host-dispatch one (fused,
               "bulk"), WAVE_FRAMES each in turns, with ms/frame, samples
               and host syncs per frame (``count_syncs``: sync debug
               warnings plus the renderer's own event waits), and the wave
               frame's PSNR against the static one (printed); gates: host
               segmented at wave_cap c against the static frame at
               samples_per_chunk_factor c, the device dispatch against host
               fused (a top stream that does not bind), the wave frame
               twice bit for bit, an empty bitfield, a 64×36 frame against
               the CPU path, K1 launching in the f32 wave frames and K2–K5
               not, K4 in an ``encode_int8="fwd"`` wave frame, fewer syncs
               on the device dispatch than on the static frame; K1 on the
               wave frame's largest encode call against its plain version
               and timed beside its bound.
 10. dist    — the distributed paths (ngp_tpu_torch.dist) on the testbed
               phase's snapshot at full width: NCCL at world 1 in this
               process (a DP(1) step against the single-device step on the
               same rays; render_multichip of held-out view 0 at 640×360
               against render, mean |Δ| 0), then gloo at world 2, two
               spawned ranks on this card (NCCL refuses two ranks of one
               communicator on one device): the DP(2) step against the
               single-device step on both ranks' rays (means and shares of
               the parameter entries) and the ranks' state equal after
               DIST_STEPS steps, render_multichip against render,
               DpNerfTrainer.train(32) with the ranks' parameters and grid
               equal, the table-parallel NeRF step against the
               single-device step (tests/test_tp_nerf.py's rule),
               TpImageTrainer at full width (configs/image/base.json, a 128
               MiB shard of the 256 MiB table), the TP encode at 2^20
               positions against K1 on the whole table; ms per step and per
               frame, labelled (gloo on one card is no measure of a
               collective); K1, K2 and K4 must launch on these paths.
 11. image   — the neural image (cell smoke-image-synth): a seeded
               2048×2048 PNG (colour gradients, a fine grating, hard-edged
               discs), ``python -m ngp_tpu_torch.run --mode image``'s main
               for IMAGE_STEPS with configs/image/base.json at full width
               (16 levels × 32768 rows, 256 MiB; batch 2^18) and a
               snapshot; compute_image_mse's PSNR of a Testbed before and
               from the snapshot after (must rise by PSNR_RISE_DB), ms/step
               and peak memory; Testbed frames at 640×360 and 2048×2048,
               timed. The 2D K1 and K2 must launch in the phase; then each
               is held against its plain version (the 3D tolerances) on
               the trainer's own batch, its trained table and one real
               step's cotangent, and at 2^20 uniform positions with the
               edge positions, and timed beside its bound on both (``K1:``
               and ``K2:`` lines naming ``_2d``; the 2D K1 with its plan,
               ``fwd_plan_2d``), K1 also on the first 2^18 pixel centres
               of the 2048² frame (the render's own input); a 64×64 frame
               on the card against the CPU path.
 12. image-int8 — the image engine under NGP_TPU_ENCODE_INT8 (cell
               smoke-image-int8): on phase 11's PNG, the runner's ``--mode
               image`` for IMAGE_STEPS under "fwd" and then "full", each
               with compute_image_mse's PSNR rise (≥ PSNR_RISE_DB) and
               ms/step printed beside the f32 run's, and the Testbed
               frames; "fwd" must launch the 2D K4 and K2 and not K5,
               "full" the 2D K4 and K5 and not K2, the frames K4. The
               "full" field's gradient by uv at UV_RES² pixel centres must
               launch the 2D K3 and give the same bits twice. Then the 2D
               K3, K4 and K5 are held against their plain versions at the
               3D tolerances and timed beside their bounds on one "full"
               step's positions and cotangent and on uniform positions
               (2^20 for K4, 2^18 for K3 and K5; ``K3:``/``K4:``/``K5:``
               lines naming ``_2d``, the 2D K3 with its plan,
               ``fwd_plan_2d``), K3 also on the uv gradient's own
               positions and cotangent, K4 also on the first 2^18 pixel
               centres of the 2048² frame, and a 64×64 frame on the card
               is held against the CPU path.
 13. volume  — the neural volume (cell smoke-volume-plume): the 128³
               procedural plume written by the port's write_nvdb, the
               runner's ``--mode volume`` for VOLUME_STEPS with configs/
               volume/base.json at full width (16 levels × 8192 rows, batch
               2^18 from the Testbed) and a snapshot; the density MSE at
               2^20 uniform points of the AABB must fall to
               VOLUME_MSE_RATIO of the untrained network's; a 512×512
               VolumeRenderer frame (timed) and the same march over the
               ground-truth density: the IoU of their opacity > 0.5 masks
               ≥ VOLUME_IOU_MIN; K1 and K2 launch in the phase; a 32×32
               frame on the card against the CPU path.
 14. sdf     — the SDF engine (cell smoke-sdf-synth): a torus OBJ (radii
               0.3 and 0.1, 256 × 64 segments, 32,768 triangles), the
               runner's ``--mode sdf`` for SDF_STEPS with configs/sdf/
               base.json at full width (16 levels × 8192 rows, batch
               2^18, raystab signs; the host BVH's ms per batch printed),
               calculate_iou of a Testbed from the snapshot at 2^22
               samples (≥ IOU_MIN), 640×360 frames with central-difference
               normals and shadows and with analytic normals (K3 must
               launch in it), each frame's hit mask against the BVH's ray
               casts of its rays (≥ HIT_AGREE_MIN), K1 and K2 launching in
               the phase, and a 64×36 frame against the CPU path.
 15. mesh    — mesh export (cell smoke-mesh): the runner's --save_mesh of
               the testbed phase's snapshot at 256³, the Testbed's NeRF
               mesh with vertex colours (.ply; σ in the occupied cells,
               the field's device ms by CUDA events and the host's
               marching cubes printed) whose vertices' median distance to
               the spheres must be ≤ MESH_SPHERE_VOXELS voxel widths, the
               σ field at 64³ on the card against the CPU path (the mean
               and the share of points within FIELD_POINT_TOL; the maximum
               printed, not gated), the sdf phase's torus by marching
               tetrahedra at 256³ (mean |torus distance| ≤
               TORUS_MESH_VOXELS voxel widths, no interior edge outside
               exactly two faces) and 64 PNG slices; K1 launches in the
               phase and is held against its plain version on the field's
               own inputs.
 16. takikawa — the Takikawa octree encoding (cell smoke-takikawa-torus):
               configs/sdf/takikawa.json at full width on the torus (7
               levels, depths 4..10, level groups of width 1), 8 batches
               of 2^18 from the trainer's sampler pinned with
               override_sdf_training_data, 256 steps; the IoU at 2^22 by
               the octree rule (≥ IOU_MIN), an analytic-normals frame (K3)
               against the BVH's ray casts (≥ HIT_AGREE_MIN); K1, K2 and
               K3 at L = 7 on a step's and the frame's own inputs against
               their plain versions (K3 bit-equal over two launches).
 17. playback — frozen-model playback (cell smoke-playback-spheres):
               bake_playback() of the testbed phase's snapshot at D 256
               and D_inner 512, the held-out PSNR within PLAYBACK_PSNR_DB
               of the live renderer's, 640×360 and 1920×1080 frames
               (twice, timed), an orbit over ±x, ±y, ±z after which each
               cascade holds the two latest orientations, and the runner's
               --video_camera_path --video_playback writing 20 frames; K1
               on the bake's first batch against its plain version.
 18. captures — real captures (cell smoke-captures-spheres): the spheres
               through an F-theta lens (24 views at 256², 4 held out)
               written with 16-bit depth PNGs under integer_depth_scale,
               alpha sidecars on the even views and a dynamic mask over
               view 0's centre; the runner's main trains 512 steps with
               --depth_supervision_lambda under the int8 grid sweep (the
               held-out PSNR rise, K1, K2 and K4 launching); a Testbed from
               the snapshot: view 0's DEPTH frame against the analytic
               depth, one step in which no ray under the mask reaches the
               loss, a 1024×512 LatLong panorama and a 640×360 F-theta
               frame against the analytic spheres on their own rays, a 2×1
               stereo quilt against its panels rendered alone, an envmap
               scene (save_exr) whose clear pixels show the envmap; a
               rolling-shutter capture (motion-blurred views) trains 256
               steps; ray sidecars holding the camera's rays give its rays;
               a Testbed under NGP_TPU_ENCODE_INT8=fwd renders 640×360
               through K4 (PSNR against the f32 frame, a 64×36 frame
               against the CPU, K4 on the frame's largest encode call held
               against its plain version and timed); a tcnn-layout model
               and a blocked one train 256 steps (ms/step side by side).
Every gate of phases 9, 10 and 15–18 prints ``gate <what>: <value>
(limit ...; <share> of the limit)``.
With ``--profile``, torch.profiler traces of one slice frame (K1's device
ms and launches in it) and of 16 steady training steps are broken down by
layer as well (the steps' table also to a file, see ``phase_profile``).
``--kernels`` runs phases 1, 2 and 4 alone, on a scene of its own (K4's
sweep positions from an untrained trainer), with the 2D K1–K5 on seeded
image-width inputs, and ends with the kernels' JSON line.
``--adam`` runs phases 1, 2 and the adam phase alone and ends with its
entries' JSON line. The adam phase (also after the kernel phases with
``--kernels``, and last in a full run) checks and times the fused Adam
kernel (``csrc/fused_adam.cu``, which replaces no Pallas kernel: the JAX
package leaves Adam to XLA) against the eager update on one real step of
an ImageTrainer on an 8192² image (configs/image/base.json: the 2 GiB
table, no Ema, 2^18 positions) and of a NerfTrainer (configs/nerf/
base.json: the 64 MiB table, Ema 0.95): p, m, v and Ema bit-equal after
one step from the same state, one launch and no host sync a step, its
``adam_fused`` count, the kernel by CUDA-graph replays and the eager
update by CUDA events in turns, beside its bound: the bytes the step
needs at the card's memory rate (every gradient entry read; p, m and v
read and written where updated; the Ema's reads and writes), and a dense
pass's (7 × 4 bytes an entry, plus the Ema's).
``--k2-zeros N`` runs phases 1, 2 and the train phase, then the train
phase's one-step K2 check on the draws of N seeds, then the image
phase's K2 check on N more steps of an image trainer, and prints for
each the entries whose zero patterns differ, their largest Σ|w·g| and
the largest |value| of the side that is not 0, alone, over Σ|w·g| and
over its rounding envelope (``zero_patterns``).
Then the script's total seconds, one JSON line with each kernel's
figures and its launches in the testbed, multinerf, wave, dist (summed
over its processes), image, image-int8 (per run: "fwd", "full", "uv"),
volume, sdf, mesh, takikawa, playback and captures phases
(K1's, K2's and K3's ray-ordered ones under "ray_ordered", K3's and K5's
on one pose step under "pose_step", K4's at 2^18 uniform positions under
"uniform_2e18" and on the sweep's positions under "sweep_ordered"; the 2D
K1's and K2's, entries of their own whose main figures are on the image
path's inputs, at 2^20 uniform positions under "uniform_2e20"; the 2D
K3's, K4's and K5's likewise on the "full" image path's inputs, at
uniform positions under "uniform_2e18" or "uniform_2e20"; the 2D K1's
and K4's on a frame's pixel centres under "pixel_chunk"; entries of
their own for K1 on the mesh field and on the playback bake and for K1,
K2 and K3 at L = 7 on the Takikawa path, and for K4 on the int8 NeRF
frame's largest encode call (its launches: those of one frame) and for
K1 on the wave frame's largest encode call (its launches: those of the
wave phase's f32 wave frames), each
named with its input and carrying its kernel's ``launch_name``), and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises: there is no fallback to the CPU or to the
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
# (clamped to REL_FLOOR)
KERNEL_BWD_TOL, REL_FLOOR = 1e-4, 1e-30
# K2's zero pattern (which entries are exactly 0: the optimizer's
# zero-gradient skip keys on them) must equal the plain version's wherever
# Σ|w·g| ≥ ZERO_FLOOR, about 85 FLT_MIN, and the side that is not 0
# exceeds the entry's f32 rounding envelope n_e·2^-24·Σ|w·g| (n_e: the
# (sample, corner) terms the entry sums, ``term_counts``). Both sides add
# in f32 reductions that flush a denormal product or partial sum to 0
# (.FTZ), so an entry whose terms all lie within a few FLT_MIN of 0 can
# end at 0 in one order and not in the other; and terms that cancel can
# sum to exactly 0 in one order of the additions and to a few ulps of
# Σ|w·g| in another (a whole-script call once failed on such an entry,
# Σ|w·g| 1.36e-6). `--k2-zeros N` surveys N steps (PERF.md has the
# readings).
ZERO_FLOOR = 1e-36
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
# the testbed phase: the runner trains TESTBED_STEPS on the train phase's
# views written to disk, and its held-out PSNR on TESTBED_HELD_OUT other
# views must rise by PSNR_RISE_DB
TESTBED_STEPS, TESTBED_HELD_OUT = 512, 4
# the analytic spheres of scripts/make_synth_scene.py (center, radius,
# linear rgb, sigma), re-implemented here because that script imports jax
SPHERES = [((0.50, 0.50, 0.45), 0.16, (0.9, 0.25, 0.2), 60.0),
           ((0.34, 0.62, 0.58), 0.10, (0.2, 0.8, 0.3), 60.0),
           ((0.66, 0.38, 0.60), 0.09, (0.25, 0.35, 0.9), 60.0),
           ((0.50, 0.50, 0.22), 0.07, (0.9, 0.85, 0.3), 80.0)]
SPHERE_FOCAL = 1.1   # the sphere views' focal length, in image widths


def _cuda_time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's launch overhead (the wrappers' Python
    and ctypes, tens of µs a call) does not hide a kernel shorter than it.
    What ``fn`` allocates comes from the graph's pool."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = _cuda_time_ms(graph.replay, 1) / iters
    del graph
    return ms


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
    output (entry function, then spills, then registers): K1–K5 and the
    fused Adam."""
    info = []
    for ln in build_log.splitlines():
        name = re.search(r"blocked_grid_encode_(?:fwd|bwd)\w*?kernel"
                         r"(?:IL([ib])(\d)E)?", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if "entry function" in ln and name:
            # <D>, or <int8> / <f32> for the 2D table backward's bool
            dims = ("" if not name.group(1) else f"<{name.group(2)}>"
                    if name.group(1) == "i" else
                    "<int8>" if name.group(2) == "1" else "<f32>")
            info.append(name.group(0).split("kernel")[0] + "kernel" + dims)
        elif "entry function" in ln and "fused_adam_kernel" in ln:
            info.append("fused_adam_kernel")
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
    level's lattice vertices (pos·scale + 0.5 integral); (N, D) for the
    grid's D."""
    d = meta.n_dims
    pts = [np.zeros((1, d), np.float32), np.ones((1, d), np.float32),
           rng.random((4096, d), dtype=np.float32) * 1.2 - 0.1,
           (rng.integers(0, 1025, (4096, d)) / 1024.0).astype(np.float32)]
    for s in meta.level_scales:
        m = rng.integers(1, int(s) + 1, (4096, d)).astype(np.float32)
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
    """Warm both, then time plain, kernel, kernel, plain: the kernel by
    CUDA-graph replays (device time), the plain version by CUDA events
    around eager calls."""
    for f in (plain, kern):
        f()
    p1 = _cuda_time_ms(plain, plain_iters)
    k1 = _graph_time_ms(kern, kern_iters)
    k2 = _graph_time_ms(kern, kern_iters)
    p2 = _cuda_time_ms(plain, plain_iters)
    return (k1, k2), (p1, p2)


# floating-point operations per corner of a lookup, counted from the
# kernels' source (per 3D lookup of 8 corners, rounded up: K1 32, K2 16, K3
# 102, K4 48, K5 82)
FLOPS_PER_CORNER = {"blocked_grid_encode_fwd": 4,
                    "blocked_grid_encode_bwd": 2,
                    "blocked_grid_encode_bwd_pos": 12.75,
                    "blocked_grid_encode_fwd_i8": 6,
                    "blocked_grid_encode_bwd_i8": 10.25}


def flops_per_lookup(name: str, n_dims: int) -> float:
    """Floating-point operations per (sample, level) of kernel ``name`` (a
    launch name; ``_2d`` names count as their kernel) on a grid of
    ``n_dims``: the geometry (3 per dimension), the 2^D corner weights
    (D - 1 products each, and D complements), and the corner arithmetic
    (in 3D: 60 for K1, 44 K2, 130 K3, 76 K4, 110 K5). Every kernel is far
    below its byte bound on this count, so its bound is the bytes."""
    corners = 1 << n_dims
    per_corner = FLOPS_PER_CORNER[name.removesuffix("_2d")]
    return 3 * n_dims + corners * (n_dims - 1) + n_dims + corners * per_corner


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


def kernel_bytes(name: str, meta, p) -> int:
    """The bytes kernel ``name`` (a launch name) must move on positions
    ``p`` (N, D), each input read once and each output written once: the
    positions (4·D bytes each), the cotangent in or the features out, and
    the table entries the corners read (K1, K3, K4; one byte each for K4's
    int8 table, with its level scales) or the whole table gradient (K2,
    K5); K3 also writes dpos (4·D bytes per sample). On the neural image's
    grid (16 levels × 32768 rows, all dense) 242 MB of the 2D K2's and
    K5's 268 MB of gradient are the zeros of rows no sample can reach:
    the bound is mostly that fill."""
    name = name.removesuffix("_2d")
    n, n_levels, d = p.shape[0], meta.n_levels, meta.n_dims
    moved = 4 * d * n + 4 * 2 * n_levels * n
    if name in ("blocked_grid_encode_bwd", "blocked_grid_encode_bwd_i8"):
        return moved + 4 * meta.n_params
    if name == "blocked_grid_encode_fwd_i8":
        return moved + 4 * n_levels + _touched_entries(meta, p)
    dpos = 4 * d * n if name == "blocked_grid_encode_bwd_pos" else 0
    return moved + 4 * _touched_entries(meta, p) + dpos


def kernel_bound(name: str, n: int, meta, n_bytes: float):
    """The bound of kernel ``name``'s work on n samples that move
    ``n_bytes``: (max(bytes / HBM rate, flops / f32 rate) in ms, "bytes"
    or "operations", whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_lookup(name, meta.n_dims) * n * meta.n_levels \
        / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_entry(name: str, line: int, err: float, ks, ps, n: int, meta,
                  n_bytes: float) -> dict:
    """The kernels-line entry: times, error, and the bound of the run's
    work (``kernel_bound``)."""
    bound_ms, bound_by = kernel_bound(name, n, meta, n_bytes)
    return {"name": name, "route": "cuda",
            "source": "ngp_tpu_torch/csrc/blocked_grid_encode.cu",
            "replaces": f"ngp_tpu/kernels/hashgrid_pallas.py:{line}",
            "max_abs_err": err, "ms": sum(ks) / 2, "plain_ms": sum(ps) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by,
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
    print(f"K1: {bgc.launch_name('blocked_grid_encode_fwd', meta)} "
          f"{tuple(table.shape)} x {pos.shape[0]} {what} positions: max "
          f"|kernel - plain| {err:.3e} (tolerance {KERNEL_TOL})")
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
    name = bgc.launch_name("blocked_grid_encode_fwd", meta)
    entry = _kernel_entry(name, 85, err, ks, ps, n, meta,
                          kernel_bytes(name, meta, p))
    plan = fwd_plan_text(n, meta, entry)
    _print_times("K1", f"{n} {what} positions x {meta.n_levels} levels"
                 f"{plan}", entry, ks, ps)
    return entry


def fwd_plan_text(n: int, meta, entry: dict) -> str:
    """For a 2D grid: the 2D encode forward's plan (K1's and K4's) for n
    samples (``fwd_plan_2d``), into ``entry``; its text. "" in 3D."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    if meta.n_dims != 2:
        return ""
    plan = bgc.fwd_plan_2d(n, meta)
    entry["plan"] = {"samples": plan.samples, "threads": plan.threads,
                     "smem_bytes": plan.smem_bytes}
    return (f", tiles of {plan.samples} samples x all levels, "
            f"{plan.threads} threads")


def check_k2(pos, cot, meta, what: str) -> float:
    """K2 against its plain version. Atomics sum in no fixed order, so each
    entry is held to KERNEL_BWD_TOL relative to Σ|w·g| of that entry (the
    plain backward of |g|), and the zero patterns must be equal where an
    order of the additions cannot decide them (``zero_patterns``): the
    optimizer's zero-gradient skip keys on exact zeros. Returns max |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    with torch.no_grad():
        got = bgc.launch_bwd(pos, cot, meta)
        ref = encode_backward_reference(pos, cot, meta)
        scale = encode_backward_reference(pos, cot.abs(), meta)
        terms = term_counts(pos, cot, meta)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"K2 output is not finite ({what})")
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / scale.clamp(min=REL_FLOOR)).max())
    zeros = zero_patterns(got, ref, scale, terms)
    print(f"K2: {bgc.launch_name('blocked_grid_encode_bwd', meta)} "
          f"{pos.shape[0]} {what} positions -> "
          f"{tuple(got.shape)}: max |kernel - plain| {err:.3e}, max "
          f"relative to sum|w*g| {rel:.3e} (tolerance {KERNEL_BWD_TOL}); "
          f"{zero_pattern_text(zeros)} "
          f"({float((ref == 0).float().mean()):.4f} of entries zero)")
    if not (rel <= KERNEL_BWD_TOL and zeros["over"] == 0):
        raise RuntimeError(f"K2 disagrees with its plain version ({what})")
    return err


def term_counts(pos, cot, meta) -> torch.Tensor:
    """(L, R, 128) f32: how many (sample, corner) terms w·g_f with g_f ≠ 0
    each table entry sums, by a plain scatter of ones over the corners
    ``encode_backward_reference`` adds into."""
    from ngp_tpu_torch.kernels.blocked_grid import LANES, _corner_index
    L, F, n = meta.n_levels, meta.n_features_per_level, pos.shape[0]
    idx, _ = _corner_index(meta, pos)                      # (L, N, C)
    live = (cot.reshape(n, L, F).transpose(0, 1) != 0).float()
    counts = torch.zeros((L, meta.rows * LANES), device=pos.device)
    for f in range(F):
        counts.scatter_add_(1, (idx + f).reshape(L, -1),
                            live[:, :, f:f + 1].expand(idx.shape)
                            .reshape(L, -1))
    return counts.view(L, meta.rows, LANES)


def zero_patterns(got, ref, scale, terms) -> dict:
    """Where K2's output and the plain backward's differ in being exactly
    0: how many entries ("differ"), the largest Σ|w·g| among them
    ("max_sum_abs"); among those with Σ|w·g| ≥ ZERO_FLOOR, the largest
    share that the side which is not 0 takes of the entry's rounding
    envelope n_e·2^-24·Σ|w·g| ("max_envelope_share") and how many exceed
    it ("over"): only those fail, as no order of the f32 additions can
    sum them to 0."""
    differ = (got == 0) != (ref == 0)
    n = int(differ.sum())
    if not n:
        return {"differ": 0, "max_sum_abs": 0.0, "max_envelope_share": 0.0,
                "over": 0}
    held = differ & (scale >= ZERO_FLOOR)
    share = (got + ref)[held].abs() / (terms[held] * 2.0 ** -24
                                       * scale[held])
    return {"differ": n, "max_sum_abs": float(scale[differ].max()),
            "max_envelope_share": float(share.max()) if share.numel()
            else 0.0, "over": int((share > 1).sum())}


def zero_pattern_text(z: dict) -> str:
    return (f"zero patterns differ at {z['differ']} entries, the largest "
            f"sum|w*g| among them {z['max_sum_abs']:.3e} (held where ≥ "
            f"{ZERO_FLOOR}); the largest share of the rounding envelope "
            f"n_e*2^-24*sum|w*g| among those held "
            f"{z['max_envelope_share']:.3e} (limit 1), {z['over']} over it")


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
    name = bgc.launch_name("blocked_grid_encode_bwd", meta)
    entry = _kernel_entry(name, 110, err, ks, ps, n, meta,
                          kernel_bytes(name, meta, p))
    plan = table_bwd_plan_text(n, meta, entry)
    _print_times("K2", f"{n} {what} positions x {meta.n_levels} levels"
                 f"{plan}", entry, ks, ps)
    return entry


def table_bwd_plan_text(n: int, meta, entry: dict, tile=None) -> str:
    """For a 2D grid: the table backward's plan for n samples
    (``table_bwd_plan_2d``: which levels it sums in shared memory), into
    ``entry``; its text. "" in 3D."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    if meta.n_dims != 2:
        return ""
    plan = bgc.table_bwd_plan_2d(n, meta, tile)
    shared = [l for l, w in enumerate(plan.where) if w == bgc.SUM_LEVEL]
    entry["plan"] = {"chunk": plan.chunk, "width": plan.width,
                     "smem_bytes": plan.smem_bytes, "shared_levels": shared}
    return (f", chunk {plan.chunk}, {plan.width} levels a block, levels "
            f"{shared} in {plan.smem_bytes / 1024:.1f} KiB of shared memory, "
            f"the rest in L2")


def _figures(entry: dict) -> dict:
    """The figures of one input set of a kernel entry."""
    return {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bytes", "max_abs_err")}


def _sub_entry(entry: dict, other: dict, key: str) -> dict:
    """``entry`` (uniform inputs) with ``other``'s figures under ``key``
    (another input set) and the larger error of the two."""
    entry[key] = _figures(other)
    entry["max_abs_err"] = max(entry["max_abs_err"], other["max_abs_err"])
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
    return _sub_entry(entry, time_k1(table, ray["k1_pos"], meta, err,
                                     "ray-ordered"), "ray_ordered")


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
    return _sub_entry(entry, time_k2(ray["k2_pos"], ray["k2_cot"], meta,
                                     err, "ray-ordered"), "ray_ordered")


def check_k4(tq, qs, pos, meta, what: str) -> float:
    """K4 against its plain version on ``pos``; returns max |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference_i8
    with torch.no_grad():
        got = bgc.launch_fwd_i8(tq, qs, pos, meta)
        ref = encode_reference_i8(tq, qs, pos, meta)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"K4 output is not finite ({what})")
    err = float((got - ref).abs().max())
    print(f"K4: {bgc.launch_name('blocked_grid_encode_fwd_i8', meta)} "
          f"{tuple(tq.shape)} int8 x "
          f"{pos.shape[0]} {what} positions: max |kernel - plain| {err:.3e} "
          f"(tolerance {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise RuntimeError(f"K4 disagrees with its plain version ({what}): "
                           f"{err}")
    return err


def time_k4(tq, qs, p, meta, err: float, what: str) -> dict:
    """K4 and its plain version timed in turns on ``p``; the bound:
    positions and level scales in, features out, one byte per table entry
    the corners read."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference_i8
    with torch.no_grad():
        ks, ps = _time_in_turns(
            lambda: bgc.launch_fwd_i8(tq, qs, p, meta),
            lambda: encode_reference_i8(tq, qs, p, meta))
    n = p.shape[0]
    name = bgc.launch_name("blocked_grid_encode_fwd_i8", meta)
    entry = _kernel_entry(name, 354, err, ks, ps, n, meta,
                          kernel_bytes(name, meta, p))
    plan = fwd_plan_text(n, meta, entry)
    if not plan:
        entry["G"] = bgc.kernel_plan("blocked_grid_encode_fwd_i8", n,
                                     meta).width
        plan = f", G {entry['G']}"
    _print_times("K4", f"{n} {what} positions x {meta.n_levels} levels"
                 f"{plan}", entry, ks, ps)
    return entry


def phase_k4(dev) -> dict:
    """K4 at 2^20 uniform positions (checked with the edge positions too)
    and at the 2^18 of one grid-sweep call; the int8 quantisation of the
    table, which the sweep runs once per sweep, timed alone."""
    from ngp_tpu_torch.kernels.blocked_grid import quantize_table_i8
    meta, table, pos, _ = _full_width_inputs(dev, 1 << 20)
    with torch.no_grad():
        tq, qs = quantize_table_i8(table)
        quant = [_cuda_time_ms(lambda: quantize_table_i8(table), 10)
                 for _ in range(2)]
    print(f"K4: quantize_table_i8 of the {table.numel() * 4 / 2**20:.0f} MiB "
          f"f32 table alone: {quant[0]:.4f}/{quant[1]:.4f} ms")
    err = check_k4(tq, qs, pos, meta, "uniform+edge")
    entry = time_k4(tq, qs, pos[: 1 << 20], meta, err, "uniform")
    entry["quantize_ms"] = sum(quant) / 2
    return _sub_entry(entry, time_k4(tq, qs, pos[: 1 << 18], meta, err,
                                     "uniform"), "uniform_2e18")


def sweep_ordered_inputs(tr) -> dict:
    """The positions of the first network call (SWEEP_CHUNK = 2^18) of a
    full grid sweep and of a partial one of trainer ``tr``, as the sweep
    hands them to K4 (or, for CPU tensors, to its plain version): cascade
    0's cells in linear x-fastest order with jitter, and the first z-slabs
    of the partial sweep's phase. The trainer's grid and generator are
    left as they were."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    encode = bgc.encode_quantized
    out = {}
    for name, full in (("full", True), ("partial", False)):
        seen = []

        def spy(tq, qs, pos, meta):
            if not seen:
                seen.append(pos.clone())
            return encode(tq, qs, pos, meta)
        grid, rng = tr.grid, tr.generator.get_state()
        with mock.patch.object(bgc, "encode_quantized", spy):
            tr._grid_update(full)
        tr.grid = grid
        tr.generator.set_state(rng)
        out[name] = seen[0]
    print(f"sweep: captured the first call of a full and of a partial grid "
          f"sweep: {out['full'].shape[0]} and {out['partial'].shape[0]} "
          f"positions")
    return out


def phase_k4_sweep(dev, entry: dict, sweep: dict) -> dict:
    """K4 on the grid sweep's own positions (``sweep_ordered_inputs``),
    checked and timed, under ``entry["sweep_ordered"]``."""
    from ngp_tpu_torch.kernels.blocked_grid import quantize_table_i8
    meta, table, _, _ = _full_width_inputs(dev, 1)
    with torch.no_grad():
        tq, qs = quantize_table_i8(table)
    parts = {}
    for name, p in sweep.items():
        err = check_k4(tq, qs, p, meta, f"{name}-sweep")
        parts[name] = time_k4(tq, qs, p, meta, err, f"{name}-sweep")
    entry["sweep_ordered"] = {k: _figures(e) for k, e in parts.items()}
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [e["max_abs_err"] for e in parts.values()])
    return entry


def _cotangent(dev, meta, n: int, seed: int) -> torch.Tensor:
    """Seeded (n, L·2) cotangents, every fifth sample zero (rays without
    samples)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn((n, meta.n_levels * 2), generator=g, device=dev)
    cot[::5] = 0.0
    return cot


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


def check_k3(table, pos, cot, meta, what: str) -> float:
    """K3 against the plain position backward: each component within
    KERNEL_POS_TOL of its Σ|term|, and exactly 0 where every term is. It
    is launched twice: the two results must be bit-equal, as the kernel
    sums across lanes and level groups in an order fixed by its plan.
    Returns max |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (
        encode_position_backward_reference as plain)
    with torch.no_grad():
        got = bgc.launch_bwd_pos(table, pos, cot, meta)
        again = bgc.launch_bwd_pos(table, pos, cot, meta)
        ref = plain(table, pos, cot, meta)
        mag = plain(table, pos, cot, meta, magnitude=True)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"K3 output is not finite ({what})")
    diff = (got - ref).abs()
    if bool((diff[mag == 0] != 0).any()):
        raise RuntimeError(f"K3 is nonzero where every term is zero ({what})")
    rel, err = float((diff / mag.clamp(min=1e-30)).max()), float(diff.max())
    same = bool(torch.equal(got.view(torch.int32), again.view(torch.int32)))
    print(f"K3: {bgc.launch_name('blocked_grid_encode_bwd_pos', meta)} "
          f"{pos.shape[0]} {what} positions "
          f"-> {tuple(got.shape)}: max |kernel - plain| {err:.3e}, max "
          f"relative to sum|term| {rel:.3e} (tolerance {KERNEL_POS_TOL}); "
          f"exact zeros where every term is 0; a second launch bit-equal: "
          f"{same}")
    if not (rel <= KERNEL_POS_TOL and same):
        raise RuntimeError(f"K3 disagrees with its plain version or itself "
                           f"({what})")
    return err


def time_k3(table, p, c, meta, err: float, what: str) -> dict:
    """K3 and its plain version timed in turns on ``p``, ``c``; the
    bound: positions, cotangent and the entries the corners read in, dpos
    out."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import (
        encode_position_backward_reference)
    with torch.no_grad():
        ks, ps = _time_in_turns(
            lambda: bgc.launch_bwd_pos(table, p, c, meta),
            lambda: encode_position_backward_reference(table, p, c, meta))
    n = p.shape[0]
    name = bgc.launch_name("blocked_grid_encode_bwd_pos", meta)
    entry = _kernel_entry(name, 157, err, ks, ps, n, meta,
                          kernel_bytes(name, meta, p))
    if meta.n_dims == 2:
        plan = bgc.fwd_plan_2d(n, meta)
        entry["G"] = f"tile {plan.samples}, walk {plan.walk}"
        text = fwd_plan_text(n, meta, entry)
    else:
        entry["G"] = bgc.kernel_plan("blocked_grid_encode_bwd_pos", n,
                                     meta).width
        text = ""
    _print_times("K3", f"{n} {what} positions x {meta.n_levels} levels, G "
                 f"{entry['G']}{text}", entry, ks, ps)
    return entry


def phase_k3(dev, ray=None) -> dict:
    """K3 at the training batch: 2^18 positions × 16 levels plus the edge
    positions, seeded cotangents, the f32 table at std 0.5; given ``ray``
    (``ray_ordered_inputs``), on K2's 2^18 ray-ordered positions and
    cotangent too."""
    meta, table, pos, _ = _full_width_inputs(dev, 1 << 18)
    cot = _cotangent(dev, meta, pos.shape[0], SEED + 3)
    err = check_k3(table, pos, cot, meta, "uniform+edge")
    entry = time_k3(table, pos[: 1 << 18], cot[: 1 << 18], meta, err,
                    "uniform")
    if ray is None:
        return entry
    err = check_k3(table, ray["k2_pos"], ray["k2_cot"], meta, "ray-ordered")
    return _sub_entry(entry, time_k3(table, ray["k2_pos"], ray["k2_cot"],
                                     meta, err, "ray-ordered"), "ray_ordered")


def check_k5(pos, cot, meta, tile: int, what: str) -> float:
    """K5 against the plain int8 backward (``check_i8_grad``); returns max
    |Δ|."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    with torch.no_grad():
        got = bgc.launch_bwd_i8(pos, cot, meta, tile)
        torch.cuda.synchronize()
        rel, err, cancelled, zeros = check_i8_grad(pos, cot, meta, tile, got)
    print(f"K5: {bgc.launch_name('blocked_grid_encode_bwd_i8', meta)} "
          f"{pos.shape[0]} {what} positions, tile {tile} -> "
          f"{tuple(got.shape)}: max |kernel - plain| {err:.3e}, max "
          f"relative to sum_t scale_t*sum|q| {rel:.3e} (tolerance "
          f"{KERNEL_I8_TOL}); exact zeros where every q is 0; "
          f"{zeros / got.numel():.4f} of entries zero in the plain version, "
          f"{cancelled} of them by cancelling quanta")
    if not rel <= KERNEL_I8_TOL:
        raise RuntimeError(f"K5 disagrees with its plain version ({what})")
    return err


def phase_k5(dev) -> dict:
    """K5 on K3's positions, with cotangents seeded apart, in tiles of 2048
    samples (the tile of a 2^18-sample stream; the last tile partial)."""
    from ngp_tpu_torch.kernels.blocked_grid import DEFAULT_TILE
    meta, _, pos, _ = _full_width_inputs(dev, 1 << 18)
    cot = _cotangent(dev, meta, pos.shape[0], SEED + 4)
    tile = DEFAULT_TILE
    err = check_k5(pos, cot, meta, tile, "uniform+edge")
    return time_k5(pos[: 1 << 18], cot[: 1 << 18], meta, tile, err,
                   "uniform")


def time_k5(p, c, meta, tile: int, err: float, what: str) -> dict:
    """K5 (with the zero fills of its outputs) and its plain version
    timed in turns; the bound: positions and cotangent in, the whole table
    gradient out."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference_i8
    with torch.no_grad():
        ks, ps = _time_in_turns(
            lambda: bgc.launch_bwd_i8(p, c, meta, tile),
            lambda: encode_backward_reference_i8(p, c, meta, tile),
            plain_iters=2)
    name = bgc.launch_name("blocked_grid_encode_bwd_i8", meta)
    entry = _kernel_entry(name, 383, err, ks, ps, p.shape[0], meta,
                          kernel_bytes(name, meta, p))
    if meta.n_dims == 2:
        plan = table_bwd_plan_text(p.shape[0], meta, entry, tile)
    else:
        entry["G"] = bgc.kernel_plan("blocked_grid_encode_bwd_i8",
                                     p.shape[0], meta).width
        plan = f", G {entry['G']}"
    _print_times("K5", f"{p.shape[0]} {what} positions x {meta.n_levels} "
                 f"levels, tile {tile}{plan}", entry, ks, ps)
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
    from ngp_tpu_torch.kernels import fused_adam_cuda as fa
    for counts in (bgc.launches, fa.launches):
        for k in counts:
            counts[k] = 0


def _adam_launches(tag: str, launches: dict, steps: int, cuda: bool = True):
    """Add the fused Adam's launches since the last reset to ``launches``;
    ``steps`` training steps on the card must have launched it once each
    (on the CPU, never)."""
    from ngp_tpu_torch.kernels import fused_adam_cuda as fa
    n = launches["fused_adam"] = fa.launches["fused_adam"]
    print(f"{tag}: fused Adam launched {n} times in {steps} training steps")
    if n != (steps if cuda else 0):
        raise RuntimeError(f"{tag}: {n} fused Adam launches in {steps} "
                           f"training steps")


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
          f"{float(d.mean()):.3e} (allowed 2e-4), max {float(d.max()):.3e}")
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
          f"{float(err.mean()):.3e} (allowed 2e-4), {within:.4f} of pixels "
          f"within 2e-3 (required 0.995)")
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
                    t1: float = 2.5, with_depth: bool = False):
    """Brute-force volume render of the spheres along o + t·d (d unit) →
    (linear premultiplied rgb, alpha), and with ``with_depth`` the expected
    depth Σ w·t / alpha (0 where alpha is 0). Each ray on its own: a batch
    of many views' rays gives each the bits it gets alone, in one pass of
    the step loop (a pass costs ~10^4 launches whatever its size)."""
    ts = torch.linspace(t0, t1, n_steps, device=o.device)
    dt = float(ts[1] - ts[0])
    acc = torch.zeros_like(o)
    depth = torch.zeros(o.shape[0], device=o.device)
    T = torch.ones(o.shape[0], device=o.device)
    for t in ts:
        rgb, sigma = _sphere_field(o + t * d)
        alpha = 1.0 - torch.exp(-sigma * dt)
        acc += (T * alpha)[:, None] * rgb
        depth += T * alpha * t
        T = T * (1.0 - alpha)
    if with_depth:
        return acc, 1.0 - T, depth / torch.clamp(1.0 - T, min=1e-9)
    return acc, 1.0 - T


def _orbit_xforms(n: int, radius: float = 1.05, seed: int = 0,
                  phase: float = 0.0):
    """NGP camera→world matrices on a jittered orbit around 0.5³ (as
    scripts/make_synth_scene.py places them); ``phase`` turns the azimuths
    by that fraction of the spacing."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ang, elev = (i + phase) * 2 * math.pi / n, 0.25 + 0.4 * rng.rand()
        fwd = -np.array([math.cos(ang) * math.cos(elev),
                         math.sin(ang) * math.cos(elev), math.sin(elev)])
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        out.append(np.stack([right, np.cross(fwd, right), fwd,
                             0.5 - radius * fwd], 1))
    return np.stack(out).astype(np.float32)


def _to_u8(rgb: torch.Tensor, a: torch.Tensor, res: int) -> np.ndarray:
    """Linear premultiplied rgb (N, 3) and alpha (N,) → an sRGB uint8 RGBA
    image (res, res, 4)."""
    from ngp_tpu_torch.common import linear_to_srgb
    c = linear_to_srgb(torch.clamp(rgb / torch.clamp(a, min=1e-6)[:, None],
                                   0.0, 1.0))
    img = torch.cat([c, a[:, None]], -1).reshape(res, res, 4)
    return torch.round(img * 255).to(torch.uint8).cpu().numpy()


def sphere_views(dev, xfs: np.ndarray, res: int, xfs_end=None,
                 n_times: int = 4) -> np.ndarray:
    """The spheres seen by cameras ``xfs`` (focal SPHERE_FOCAL·res, centred
    principal point), rendered on ``dev`` along the trainer's own
    pixel-centre rays, as sRGB uint8 RGBA (the path real captures take).
    With end transforms ``xfs_end`` each view is the mean of ``n_times``
    renders at cameras slerped toward its end (a motion-blurred exposure,
    what the trainer's per-ray shutter time models)."""
    from ngp_tpu_torch.rays.camera import xform_slerp
    fl = SPHERE_FOCAL * res
    px = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res
    v, u = torch.meshgrid(px, px, indexing="ij")
    d_cam = torch.stack([(u - 0.5) * res / fl, (v - 0.5) * res / fl,
                         torch.ones_like(u)], -1).reshape(-1, 3)
    cams = []                         # (views, times, 3, 4)
    for i, xf in enumerate(torch.from_numpy(xfs).to(dev)):
        if xfs_end is None:
            cams.append(xf[None])
        else:
            xe = torch.as_tensor(xfs_end[i], device=dev)
            ts = (torch.arange(n_times, device=dev) + 0.5) / n_times
            cams.append(xform_slerp(xf, xe, ts))
    cams = torch.stack(cams)
    d = torch.einsum("pj,vtij->vtpi", d_cam, cams[..., :3])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = cams[..., 3][:, :, None].expand_as(d)
    c, al = _render_batched(o.reshape(-1, 3), d.reshape(-1, 3))
    c = c.view(*d.shape)
    al = al.view(*d.shape[:-1])
    u8 = np.empty((len(xfs), res, res, 4), np.uint8)
    for i in range(len(xfs)):
        rgb = torch.zeros_like(d_cam)
        a = torch.zeros(d_cam.shape[0], device=dev)
        for t in range(cams.shape[1]):
            rgb += c[i, t] / cams.shape[1]
            a += al[i, t] / cams.shape[1]
        u8[i] = _to_u8(rgb, a, res)
    return u8


def _render_batched(o, d, with_depth: bool = False, chunk: int = 1 << 21):
    """``_render_spheres`` over any number of rays, in chunks of ``chunk``
    rays (the same bits as one call)."""
    parts = [_render_spheres(oc, dc, with_depth=with_depth)
             for oc, dc in zip(o.split(chunk), d.split(chunk))]
    return tuple(torch.cat(p) for p in zip(*parts))


def build_sphere_dataset(dev, n_views: int, res: int, aabb_scale: int = 4,
                         xfs_end=None):
    """The spheres seen from an orbit (``sphere_views``) in the port's
    NerfDataset; with end transforms ``xfs_end`` (a rolling shutter), the
    views motion-blurred toward them."""
    from ngp_tpu_torch.data.nerf_loader import LazyImageArray, NerfDataset
    xfs = _orbit_xforms(n_views)
    fl = SPHERE_FOCAL * res
    u8 = sphere_views(dev, xfs, res, xfs_end)
    n = n_views
    return NerfDataset(
        images=LazyImageArray(u8), xforms=xfs,
        xforms_end=xfs.copy() if xfs_end is None else xfs_end,
        focal=np.full((n, 2), fl, np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        resolution=np.full((n, 2), res, np.int32),
        lens_params=np.zeros((n, 7), np.float32), lens_is_opencv=False,
        depth_images=None, aabb_scale=aabb_scale, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(n, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32), images_u8=u8)


def make_trainer(dataset, dev, config=None, grid_impl: str = "blocked",
                 mesh=None, **options):
    """The bench's trainer (bench.py: 4096 rays, dynamic live-ray count,
    both error-map samplers) with the int8 grid sweep, on base.json;
    ``options`` set further NerfTrainerConfig fields (``grid_int8`` too).
    With a ``mesh`` (``dist.mesh.make_mesh``), a ``DpNerfTrainer`` over
    it."""
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.dist.nerf_dp import DpNerfTrainer
    from ngp_tpu_torch.train.nerf import NerfTrainer, NerfTrainerConfig
    cfg = config or load_network_config(ROOT / "configs/nerf/base.json")
    cls, args = ((NerfTrainer, ()) if mesh is None
                 else (DpNerfTrainer, (mesh,)))
    return cls(dataset, cfg, *args, seed=SEED, device=dev,
               grid_impl=grid_impl, tcfg=NerfTrainerConfig(**{
                   "n_rays": 4096, "adapt_rays": False,
                   "dynamic_rays": True,
                   "sample_image_proportional_to_error": True,
                   "sample_focal_plane_proportional_to_error": True,
                   "grid_int8": True, **options}))


def view_psnr(tr, view: int = 0, spp: int = 1, motion: bool = False) -> float:
    """PSNR in sRGB of training view ``view`` rendered with the inference
    (EMA) parameters over black, as bench.py measures it; with ``motion``
    the frame is motion-blurred from the view's start to its end transform
    (``spp`` shutter times per pixel)."""
    from ngp_tpu_torch.common import linear_to_srgb
    from ngp_tpu_torch.data.image_io import u8_to_linear_rgba
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    ds = tr.dataset
    W, H = (int(x) for x in ds.resolution[view])
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=W, height=H, background=(0, 0, 0, 0), linear_out=True))
    img = r.render(tr.inference_params(), tr.grid.bitfield, ds.xforms[view],
                   W, H, focal=tuple(float(f) for f in ds.focal[view]),
                   spp=spp, camera_matrix_end=(ds.xforms_end[view] if motion
                                               else None))
    _check_frame(img, W, H)
    gt = torch.from_numpy(u8_to_linear_rgba(ds.images_u8[view])).to(
        img.device)
    mse = torch.mean((linear_to_srgb(torch.clamp(img[..., :3], 0, 1))
                      - linear_to_srgb(torch.clamp(gt[..., :3], 0, 1))) ** 2)
    return -10.0 * math.log10(max(float(mse), 1e-12))


def capture_step(tr, seed: int, *names):
    """One training step of ``tr`` (no update) on draws from ``seed``,
    with the arguments of the first call of each of the wrappers ``names``
    of blocked_grid_cuda in it. Returns (the step's gradients, {name:
    arguments})."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    seen = {}

    def spy(name, fn):
        def wrapped(*args):
            seen.setdefault(name, args)
            return fn(*args)
        return wrapped
    g = torch.Generator(device=tr.device).manual_seed(seed)
    draws = tr.draws(tr.tcfg.n_rays, g).head(tr._n_live)
    patches = [mock.patch.object(bgc, n, spy(n, getattr(bgc, n)))
               for n in names]
    for p in patches:
        p.start()
    try:
        grads = tr._step_grads(draws, tr._error_state())[0]
    finally:
        for p in patches:
            p.stop()
    return grads, seen


def step_k2(tr, seed: int):
    """K2's output in one real training step of ``tr`` (its draws from
    ``seed``), with the plain backward, the plain backward of |g| and the
    term counts on the same inputs: (got, ref, Σ|w·g|, n_e)."""
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    grads, seen = capture_step(tr, seed, "launch_bwd")
    pos, grad, meta = seen["launch_bwd"]
    with torch.no_grad():
        return (grads["pos_encoding.table"],
                encode_backward_reference(pos, grad, meta),
                encode_backward_reference(pos, grad.abs(), meta),
                term_counts(pos, grad, meta))


def step_grad_check(tr, seed: int = SEED + 2) -> dict:
    """K2 on the positions and cotangent of one real training step (its
    draws from ``seed``), against the plain backward on the same inputs:
    ``k2_zero_row``'s figures."""
    return {"seed": seed, **k2_zero_row(*step_k2(tr, seed))}


def k2_zero_row(got, ref, scale, terms) -> dict:
    """K2's output ``got`` against the plain backward ``ref``, Σ|w·g|
    ``scale`` and the term counts ``terms``: the max |Δ| relative to
    Σ|w·g| ("rel"), ``zero_patterns``' figures, the largest |value| of the
    side that is not 0 among the differing entries and the largest ratio
    of it to Σ|w·g|, and how many entries have a Σ|w·g| in (0, 1e-37),
    [1e-37, 1e-36) and [1e-36, 1e-34): how many lie near ZERO_FLOOR at
    all."""
    rel = float(((got - ref).abs() / scale.clamp(min=REL_FLOOR)).max())
    zeros = zero_patterns(got, ref, scale, terms)
    differ = (got == 0) != (ref == 0)
    value = (got + ref)[differ].abs()
    bands = [int(((scale > lo if lo == 0 else scale >= lo)
                  & (scale < hi)).sum())
             for lo, hi in ((0.0, 1e-37), (1e-37, 1e-36), (1e-36, 1e-34))]
    return {"rel": rel, **zeros,
            "max_value": float(value.max()) if zeros["differ"] else 0.0,
            "max_value_over_sum_abs": float((value / scale[differ]).max())
            if zeros["differ"] else 0.0, "entries_by_sum_abs": bands}


def k2_zero_survey(tr, n_seeds: int, tag: str = "k2-zeros"):
    """The train phase's one-step K2 check on the draws of ``n_seeds``
    seeds, one line each."""
    _print_survey(tag, [step_grad_check(tr, seed) for seed in
                        range(SEED + 2, SEED + 2 + n_seeds)])


def _print_survey(tag: str, rows: list):
    for r in rows:
        print(f"{tag}: {json.dumps(r)}")
    print(f"{tag}: {len(rows)} steps, {sum(r['differ'] for r in rows)} "
          f"entries with differing zeros; the largest sum|w*g| among them "
          f"{max(r['max_sum_abs'] for r in rows):.3e}, the largest value "
          f"{max(r['max_value'] for r in rows):.3e}, the largest value over "
          f"its sum|w*g| {max(r['max_value_over_sum_abs'] for r in rows):.3e}"
          f", the largest share of the rounding envelope among those held "
          f"{max(r['max_envelope_share'] for r in rows):.3e}, "
          f"{sum(r['over'] for r in rows)} over it")


def image_k2_zero_survey(dev, n_steps: int):
    """The image phase's K2 check on ``n_steps`` more steps of an image
    trainer the runner trained IMAGE_STEPS on the phase's PNG, one line
    each (no gate)."""
    import shutil

    from PIL import Image

    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_backward_reference
    from ngp_tpu_torch.train.image import ImageTrainer
    root = ROOT / "build" / "image_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    png = root / "image.png"
    Image.fromarray(synth_image()).save(png)
    _, tr, _, _ = _train_by_runner(
        "k2-zeros-2d", dev, "image", png, ROOT / "configs/image/base.json",
        IMAGE_STEPS, root / "image.msgpack", ImageTrainer)
    meta = tr.model.encoding.meta
    rows = []
    for i in range(n_steps):
        pos, cot = capture_image_step(tr)
        with torch.no_grad():
            rows.append({"step": i, **k2_zero_row(
                bgc.launch_bwd(pos, cot, meta),
                encode_backward_reference(pos, cot, meta),
                encode_backward_reference(pos, cot.abs(), meta),
                term_counts(pos, cot, meta))})
    _print_survey("k2-zeros-2d", rows)


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
    _adam_launches("train", launches, steps, cuda)
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
    step = step_grad_check(tr)
    print(f"train: one step's table gradient, K2 vs plain backward on its "
          f"inputs: max |Δ| relative to sum|w*g| {step['rel']:.3e} "
          f"(tolerance {KERNEL_BWD_TOL}); "
          f"{zero_pattern_text(step)}")
    if not (step["rel"] <= KERNEL_BWD_TOL and step["over"] == 0):
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


def step_kernel_check(tr) -> dict:
    """K3 and K5 on the inputs of one real camera-optimising step: K3
    checked against its plain version and itself (``check_k3``, run again
    on the step's inputs: it is deterministic), the step's own K5 table
    gradient against the plain int8 backward; then both timed there beside
    their bounds. Returns their kernels-line entries, by kernel."""
    grads, seen = capture_step(tr, SEED + 5, "launch_bwd_pos",
                               "launch_bwd_i8")
    table, pos, cot, meta = seen["launch_bwd_pos"]
    err = check_k3(table, pos, cot, meta, "pose-step")
    k3 = time_k3(table, pos, cot, meta, err, "pose-step")
    pos, cot, meta, tile = seen["launch_bwd_i8"]
    rel, err, _, _ = check_i8_grad(pos, cot, meta, tile,
                                   grads["pos_encoding.table"])
    print(f"K5: one pose step's table gradient ({pos.shape[0]} samples, "
          f"tile {tile}) vs plain on its inputs: max relative to "
          f"sum_t scale_t*sum|q| {rel:.3e} (tolerance {KERNEL_I8_TOL})")
    if not rel <= KERNEL_I8_TOL:
        raise RuntimeError("the step's K5 gradient disagrees with the plain "
                           "version")
    return {"blocked_grid_encode_bwd_pos": k3,
            "blocked_grid_encode_bwd_i8": time_k5(pos, cot, meta, tile, err,
                                                  "pose-step")}


def phase_pose(dev, ds, steps: int = POSE_STEPS, config=None):
    """Camera optimisation on ``ds`` with seeded pose errors; returns the
    launch counts of the run, and K3's and K5's kernels-line entries on one
    step's inputs (``step_kernel_check``)."""
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
    return launches, step_kernel_check(tr)


class _Tee:
    """Standard output copied into a buffer while it is printed."""

    def __init__(self):
        self.lines = []
        self._out = sys.stdout

    def write(self, text):
        self.lines.append(text)
        return self._out.write(text)

    def flush(self):
        self._out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def _run_entry(main, argv) -> str:
    """Call an entry point's ``main(argv)`` in this process (the launch
    counters see its kernels); returns what it printed. It must return 0."""
    import contextlib
    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{main.__module__}.main returned {rc}")
    return tee.text()


def _nerf_transforms(xfs: np.ndarray, res: int, files: list) -> dict:
    """A transforms.json in NeRF convention (identity world mapping) for
    the sphere views ``xfs`` stored as ``files``."""
    from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
    frames = []
    for xf, name in zip(xfs, files):
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(xf, 1.0, np.zeros(3, np.float32))
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    fl = SPHERE_FOCAL * res
    return {"aabb_scale": 4, "scale": 1.0, "offset": [0.0, 0.0, 0.0],
            "fl_x": fl, "fl_y": fl, "cx": res / 2, "cy": res / 2, "w": res,
            "h": res, "frames": frames}


def write_sphere_scene(dev, root: Path, n_train: int = TRAIN_VIEWS,
                       n_test: int = TESTBED_HELD_OUT, res: int = TRAIN_RES):
    """The sphere scene on disk as a user brings one: ``transforms.json``
    over ``train/r_*.png`` (the train phase's orbit) and
    ``transforms_test.json`` over ``test/r_*.png`` (held-out views at other
    azimuths and elevations). Returns the two JSON paths."""
    from PIL import Image
    root.mkdir(parents=True)
    paths = []
    for split, xfs in (("train", _orbit_xforms(n_train)),
                       ("test", _orbit_xforms(n_test, seed=1, phase=0.3))):
        (root / split).mkdir()
        files = [f"{split}/r_{i:03d}.png" for i in range(len(xfs))]
        for name, img in zip(files, sphere_views(dev, xfs, res)):
            Image.fromarray(img).save(root / name)
        path = root / ("transforms.json" if split == "train"
                       else "transforms_test.json")
        path.write_text(json.dumps(_nerf_transforms(xfs, res, files)))
        paths.append(path)
    return paths


def _check_iterations(out: str, n_steps: int) -> list:
    """The runner's ``iteration=<n> loss=<l>`` lines: finite losses and
    step counts that rise in equal reports to exactly ``n_steps``."""
    its = [(int(a), float(b)) for a, b in
           re.findall(r"^iteration=(\d+) loss=(\S+)", out, re.M)]
    report = max(n_steps // 20, 1)
    want = list(range(report, n_steps, report)) + [n_steps]
    if [i for i, _ in its] != want:
        raise RuntimeError(f"iteration lines {[i for i, _ in its]} != {want}")
    if not all(math.isfinite(v) for _, v in its):
        raise RuntimeError(f"non-finite loss in the iteration lines: {its}")
    return its


def _held_out_psnr(out: str) -> tuple:
    """(mean PSNR, mean SSIM) of the runner's held-out line."""
    m = re.findall(r"^PSNR=(\S+) .* SSIM=(\S+)$", out, re.M)
    if len(m) != 1:
        raise RuntimeError("the runner printed no held-out PSNR line")
    return float(m[0][0]), float(m[0][1])


def _read_png(path: Path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def _timed_frame(tb, what: str, **kw) -> np.ndarray:
    """One FRAME_W × FRAME_H Testbed.render frame, gated (finite, (H, W,
    4), opacity in [0, 1]) and timed."""
    W, H = FRAME_W, FRAME_H
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = tb.render(W, H, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _check_frame(torch.from_numpy(img), W, H)
    print(f"testbed: {what} {W}x{H} in {ms:.1f} ms; mean opacity "
          f"{float(img[..., 3].mean()):.4f}, mean rgb "
          f"{float(img[..., :3].mean()):.4f}")
    return img


def _scatter_sums(values, s_ray, s_k, n_rays: int, n_k: int):
    """``marching.ray_sums`` by scatter-add: the same sums in no fixed
    order on the card (the renderer's sums before they took a fixed
    order), to time against it."""
    out = values.new_zeros((n_rays,) + tuple(values.shape[1:]))
    return out.index_add_(0, s_ray, values)


def testbed_frames(tb, dev, root: Path) -> dict:
    """Every render mode once at 640×360 (spp 1), then ACES, a crop box, a
    DoF frame (spp 4) and a frame motion-blurred along a two-keyframe
    camera path, from training view 0 (its vertical field of view); K3
    must launch in the NORMALS frame. The SHADE frame is timed again in
    turns through Testbed.render and NerfRenderer.render (its per-ray sums
    in a fixed order and by scatter-add). Returns K3's launches in the
    NORMALS frame."""
    from types import SimpleNamespace

    from ngp_tpu_torch.common import RenderMode, TonemapCurve
    from ngp_tpu_torch.io.camera_path import CameraKeyframe, CameraPath
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc

    # the training view's field of view across the frame's height
    tb._view_focal = tb._view_focal * (FRAME_H / tb._view_res[1])
    k3 = 0
    for mode in RenderMode:
        tb.render_mode = mode
        before = bgc.launches["blocked_grid_encode_bwd_pos"]
        _timed_frame(tb, f"{mode.name} frame")
        if mode == RenderMode.NORMALS:
            k3 = bgc.launches["blocked_grid_encode_bwd_pos"] - before
            print(f"testbed: the NORMALS frame launched "
                  f"blocked_grid_encode_bwd_pos {k3} times")
            if k3 <= 0:
                raise RuntimeError("the NORMALS frame never launched K3")
    tb.render_mode = RenderMode.SHADE
    _timed_frame(tb, "SHADE frame again")
    # the same frame through Testbed.render and through the renderer
    # itself, the latter with the per-ray sums in a fixed order and by
    # scatter-add, in turns (host clock around each, with synchronizes)
    import ngp_tpu_torch.rays.marching as marching
    r = tb._nerf_renderer(FRAME_W, FRAME_H)
    focal = tuple(float(f) for f in tb._view_focal)

    def timed(way):
        sums = _scatter_sums if way == "scatter" else marching.ray_sums
        with mock.patch.object(marching, "ray_sums", sums):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if way == "testbed":
                tb.render(FRAME_W, FRAME_H)
            else:
                r.render(tb.trainer.inference_params(),
                         tb.trainer.grid.bitfield, tb.camera_matrix,
                         FRAME_W, FRAME_H, focal=focal, spp=1)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    order = ["testbed", "direct", "scatter", "scatter", "direct", "testbed"]
    ms = {}
    for way in order:
        ms.setdefault(way, []).append(timed(way))
    print("testbed: the SHADE frame in turns: " + "; ".join(
        f"{way} {a:.1f}/{b:.1f} ms" for way, (a, b) in ms.items())
        + " (Testbed.render; NerfRenderer.render; the same with "
        "scatter-add per-ray sums)")
    tb.tonemap_curve = TonemapCurve.ACES
    _timed_frame(tb, "SHADE frame, ACES tonemap")
    tb.tonemap_curve = TonemapCurve.IDENTITY
    tb.render_aabb = SimpleNamespace(min=np.array([0.0, 0.0, 0.0]),
                                     max=np.array([1.0, 1.0, 0.45]))
    _timed_frame(tb, "SHADE frame, crop box z <= 0.45")
    tb.render_aabb = None
    tb.aperture_size, tb.scale = 0.02, 1.05   # focus on the scene centre
    _timed_frame(tb, "DoF frame (aperture 0.02, spp 4)", spp=4)
    tb.aperture_size, tb.scale = 0.0, 1.0
    xf0 = np.asarray(tb.camera_matrix, np.float32)
    path = root / "camera_path.json"
    CameraPath([CameraKeyframe.from_matrix(xf0),
                CameraKeyframe.from_matrix(orbit_camera(0.25, radius=1.2))],
               duration_seconds=1.0).save(path)
    tb.load_camera_path(path)
    _timed_frame(tb, "motion-blurred camera-path frame (t 0.4-0.6, spp 4)",
                 spp=4, start_time=0.4, end_time=0.6, shutter_fraction=1.0)
    return k3


def blender_flow(dev, config_path: Path, u8: np.ndarray, xfs: np.ndarray,
                 steps: int = 8):
    """The Blender plugin's flow: an empty dataset filled by set_image and
    set_camera_extrinsics, ``frame()`` a few steps, then set_image after
    training: the trainer's pixel pool must equal the dataset's images."""
    from ngp_tpu_torch.api.testbed import Testbed
    from ngp_tpu_torch.data.image_io import u8_to_linear_rgba
    from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
    n, res = len(u8), u8.shape[1]
    tb = Testbed(device=dev)
    tb.reload_network_from_file(config_path)
    tb.create_empty_nerf_dataset(n, aabb_scale=4, width=res, height=res)
    fl = SPHERE_FOCAL * res
    for i in range(n):
        tb.set_image(i, u8_to_linear_rgba(u8[i]))
        tb.set_camera_extrinsics(i, ngp_matrix_to_nerf(
            xfs[i], 1.0, np.zeros(3, np.float32)))
    tb.set_camera_intrinsics(fl, fl)
    for _ in range(steps):
        tb.frame()
    if tb.training_step != steps or not math.isfinite(tb.loss):
        raise RuntimeError(f"Blender flow: step {tb.training_step}, loss "
                           f"{tb.loss}")
    tb.set_image(0, u8_to_linear_rgba(u8[-1]))
    ds = tb.nerf.training.dataset
    want = np.concatenate([ds.images[i][:res, :res].reshape(-1, 4)
                           for i in range(n)]).astype(np.float16)
    got = tb.trainer._pixels.cpu().numpy()
    same = got.dtype == want.dtype and np.array_equal(got, want)
    print(f"testbed: Blender flow: {n} views by set_image/"
          f"set_camera_extrinsics, {steps} frame() steps, loss "
          f"{tb.loss:.4e}; pixel pool equals the dataset after a later "
          f"set_image: {same}")
    if not same:
        raise RuntimeError("the trainer's pixel pool differs from the "
                           "dataset after set_image")


def phase_testbed(dev, steps: int = TESTBED_STEPS, config=None):
    """The user surface in NeRF mode on the card: the runner and the CLI
    (``ngp_tpu_torch.run.main``, ``ngp_tpu_torch.__main__.main``, in this
    process) on the sphere scene written to disk, every render mode and
    the other static options through a Testbed loaded from the runner's
    snapshot, and the Blender plugin's flow; all under NGP_TPU_GRID_INT8=1,
    as bench.py runs. Returns (the launch counts of the phase, K3's
    launches in its NORMALS frame, the runner's held-out PSNR of its view
    0 after training)."""
    import os
    import shutil

    import ngp_tpu_torch.__main__ as cli
    from ngp_tpu_torch import run
    from ngp_tpu_torch.api.testbed import Testbed
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    root = ROOT / "build" / "testbed_smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    train_json, test_json = write_sphere_scene(dev, root)
    print(f"testbed: scene of {TRAIN_VIEWS} + {TESTBED_HELD_OUT} held-out "
          f"{TRAIN_RES}x{TRAIN_RES} views written in "
          f"{time.perf_counter() - t0:.2f} s")
    config = str(config or ROOT / "configs/nerf/base.json")
    snap, shots = root / "snapshot.msgpack", root / "shots"
    scene = ["--scene", str(train_json), "--network", config, "--device",
             str(dev)]
    frame = ["--width", str(FRAME_W), "--height", str(FRAME_H),
             "--screenshot_spp", "1"]
    prev = os.environ.get("NGP_TPU_GRID_INT8")
    os.environ["NGP_TPU_GRID_INT8"] = "1"
    _reset_launches()
    try:
        out = _run_entry(run.main, scene + ["--n_steps", "0",
                                            "--test_transforms",
                                            str(test_json)])
        psnr0, _ = _held_out_psnr(out)
        t0 = time.perf_counter()
        out = _run_entry(run.main, scene + [
            "--n_steps", str(steps), "--save_snapshot", str(snap),
            "--test_transforms", str(test_json), "--screenshot_transforms",
            str(test_json), "--screenshot_dir", str(shots)] + frame)
        run_s = time.perf_counter() - t0
        its = _check_iterations(out, steps)
        psnr1, ssim1 = _held_out_psnr(out)
        view0_psnr = float(re.findall(r"^frame 0: psnr=(\S+)", out,
                                      re.M)[0])
        rate = float(re.findall(r"\(([\d.]+) steps/s\)", out)[-1])
        print(f"testbed: runner trained {its[-1][0]} steps at "
              f"{1e3 / rate:.2f} ms/step (warm-up included; the call "
              f"{run_s:.2f} s with eval and {TESTBED_HELD_OUT} screenshots); "
              f"held-out PSNR {psnr0:.2f} -> {psnr1:.2f} dB "
              f"(+{psnr1 - psnr0:.2f}; required +{PSNR_RISE_DB}), SSIM "
              f"{ssim1:.4f}")
        if not psnr1 - psnr0 >= PSNR_RISE_DB:
            raise RuntimeError("the runner's training did not raise the "
                               "held-out PSNR enough")
        for i in range(TESTBED_HELD_OUT):
            if _read_png(shots / f"r_{i:03d}.png").shape != (FRAME_H,
                                                            FRAME_W, 4):
                raise RuntimeError(f"screenshot r_{i:03d}.png has the wrong "
                                   "shape")
        # training view 0 from the snapshot: the runner's screenshot and
        # the CLI's must be the same bits
        _run_entry(run.main, scene + [
            "--load_snapshot", str(snap), "--screenshot_transforms",
            str(train_json), "--screenshot_frames", "0", "--screenshot_dir",
            str(root / "view0")] + frame)
        _run_entry(cli.main, scene + [
            "--load_snapshot", str(snap), "--no_train", "--screenshot",
            str(root / "cli.png"), "--width", str(FRAME_W), "--height",
            str(FRAME_H)])
        a = _read_png(root / "view0" / "r_000.png")
        b = _read_png(root / "cli.png")
        same = a.shape == b.shape and np.array_equal(a, b)
        print(f"testbed: CLI screenshot of training view 0 {b.shape} equals "
              f"the runner's frame bit for bit: {same}")
        if not same:
            raise RuntimeError("the CLI screenshot differs from the runner's "
                               "frame of the same camera")
        tb = Testbed(device=dev)
        tb.reload_network_from_file(config)
        tb.load_training_data(train_json)
        tb.load_snapshot(snap)
        k3 = testbed_frames(tb, dev, root)
        del tb
        ds_u8 = sphere_views(dev, _orbit_xforms(4), 64)
        blender_flow(dev, Path(config), ds_u8, _orbit_xforms(4))
    finally:
        if prev is None:
            os.environ.pop("NGP_TPU_GRID_INT8", None)
        else:
            os.environ["NGP_TPU_GRID_INT8"] = prev
    launches = dict(bgc.launches)
    print(f"testbed: launches in the phase {launches}")
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd",
                           "blocked_grid_encode_bwd_pos",
                           "blocked_grid_encode_fwd_i8") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the testbed phase never launched {missing}")
    return launches, k3, view0_psnr


# the multinerf phase: a rigid motion of camera and scene must leave the
# frame within RIGID_TOL (mean |Δ|); the card's frame of a request with a
# reference-snapshot descriptor within MULTINERF_CPU_TOL of the CPU's; the
# trained field's held-out PSNR within MULTINERF_PSNR_DB of the runner's;
# a subtract box in render_masks must cut the mean alpha of the pixels
# whose rays cross it by MASK_CUT (it holds most of the largest sphere)
RIGID_TOL, MULTINERF_CPU_TOL, MULTINERF_PSNR_DB = 1e-3, 1e-4, 3.0
MASK_CUT = 0.1


def _rigid(angle_deg: float, axis: int, t) -> np.ndarray:
    """4×4 rotation by ``angle_deg`` about world axis ``axis``, then a
    translation by ``t``."""
    c, s = math.cos(math.radians(angle_deg)), math.sin(math.radians(angle_deg))
    i, j = [a for a in range(3) if a != axis]
    m = np.eye(4, dtype=np.float32)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    m[:3, 3] = t
    return m


def _about_centre(scale: float, t) -> np.ndarray:
    """4×4: scale by ``scale`` about 0.5³, then translate by ``t``."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= scale
    m[:3, 3] = 0.5 * (1.0 - scale) + np.asarray(t, np.float32)
    return m


def write_reference_snapshot(snap: Path, out: Path, seed: int = SEED):
    """A reference-layout (params_binary) snapshot at ``snap``'s config and
    aabb_scale, with its density grid: a seeded tcnn-layout NerfNetwork,
    its table at std 0.5, written by the port's exporter."""
    from ngp_tpu_torch import bridge
    from ngp_tpu_torch.io.snapshot import (export_reference_snapshot,
                                           load_snapshot)
    from ngp_tpu_torch.nn.models import NerfNetwork
    doc = load_snapshot(snap)
    s = doc.pop("snapshot")
    aabb_scale = int(s["nerf"]["aabb_scale"])
    gen = torch.Generator().manual_seed(seed)
    net = NerfNetwork(doc, aabb_scale, generator=gen, grid_impl="tcnn")
    with torch.no_grad():
        net.pos_encoding.table.copy_(torch.randn(
            net.pos_encoding.table.shape, generator=gen) * 0.5)
    tree = bridge.nerf_params_to_numpy(dict(net.named_parameters()), net)
    export_reference_snapshot(out, doc, tree, aabb_scale=aabb_scale,
                              density_grid=s["density_grid"])


def _psnr_srgb(pred_srgb: np.ndarray, gt_path: Path) -> float:
    """The runner's held-out protocol: the frame over black in sRGB
    against the view, both clipped, as ``run.evaluate_test_transforms``."""
    from ngp_tpu_torch.common import linear_to_srgb_np, mse2psnr
    from ngp_tpu_torch.data.image_io import load_stbi
    gt = linear_to_srgb_np(np.clip(load_stbi(gt_path)[..., :3], 0, 1))
    return mse2psnr(float(np.mean((np.clip(pred_srgb, 0, 1) - gt) ** 2)))


def _ray_box_hits(cam: np.ndarray, focal: float, W: int, H: int, lo, hi):
    """Which pixel-centre rays of a pinhole ``cam`` (3×4 NGP, principal at
    the centre) pass through the box [lo, hi]: (H, W) bool."""
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    d = np.stack([(xs - W / 2) / focal, (ys - H / 2) / focal,
                  np.ones_like(xs)], -1) @ cam[:, :3].T
    d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = (np.asarray(lo) - cam[:, 3]) / d, (np.asarray(hi) - cam[:, 3]) / d
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    return (tf >= np.maximum(tn, 0.0))


class _DeviceTime:
    """Wraps ``module.name`` (a function whose second argument is the
    (N, 3) positions) so that each call is bracketed by CUDA events:
    ``ms()`` sums the device time of the calls, ``calls`` and ``samples``
    count them."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.events, self.samples = [], 0

    def __enter__(self):
        fn = getattr(self.module, self.name)

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.events.append((a, b))
            self.samples += args[1].shape[0]
            return out
        self._patch = mock.patch.object(self.module, self.name, timed)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    @property
    def calls(self) -> int:
        return len(self.events)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _timed_request(render, req, what: str, W: int, H: int) -> np.ndarray:
    """One request through ``render``, gated (finite, (H, W, 4), alpha in
    [0, 1]) and timed on the host clock with synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(req)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _check_frame(torch.from_numpy(img), W, H)
    print(f"multinerf: {what} {W}x{H} in {ms:.1f} ms; mean opacity "
          f"{float(img[..., 3].mean()):.4f}, mean rgb "
          f"{float(img[..., :3].mean()):.4f}")
    return img


def phase_multinerf(dev, view0_psnr: float, root: Path = None,
                    config=None, cpu_size=(64, 36)):
    """The Blender render engine on the card, on the testbed phase's
    snapshot (``root``/snapshot.msgpack), a copy of it under another path
    and a reference-layout snapshot: the trained field at held-out view 0
    (its PSNR by the runner's protocol against the runner's), a rigid
    motion of camera and scene, two fields in both composite modes with
    opacity and masks, the fork's other camera models, spp/DoF, tonemap,
    exposure, the linear colour space and a mip-1 request, the pyngp
    shim's sync, async and rolling-shutter renders and a Testbed frame
    with render_masks, and the reference descriptor against the CPU
    render of its request. K1 must launch and K2-K5 must not. Returns the
    launch counts of the phase."""
    import shutil
    import threading

    import ngp_tpu_torch.api.pyngp_shim as ngp
    from ngp_tpu_torch.common import TonemapCurve
    from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels import hashgrid as thg
    from ngp_tpu_torch.render import multi_nerf as mn

    t_phase = time.perf_counter()
    root = root or ROOT / "build" / "testbed_smoke"
    config = str(config or ROOT / "configs/nerf/base.json")
    snap, copy = root / "snapshot.msgpack", root / "snapshot_copy.msgpack"
    ref_snap = root / "reference.msgpack"
    shutil.copyfile(snap, copy)
    write_reference_snapshot(snap, ref_snap)
    test = json.loads((root / "transforms_test.json").read_text())
    frame0 = test["frames"][0]
    cam3 = nerf_matrix_to_ngp(np.asarray(frame0["transform_matrix"],
                                         np.float32), 1.0,
                              np.zeros(3, np.float32))
    cam = np.eye(4, dtype=np.float32)
    cam[:3] = cam3
    focal = float(test["fl_x"])
    W, H = FRAME_W, FRAME_H
    _reset_launches()

    # 512 lattice steps from the near plane must reach past the farthest
    # sphere (its centre distance + 0.3); else march 1024
    t_end = float(mn.step_lattice(torch.full((1,), 0.05), 1.0 / 256.0,
                                  512)[0, -1])
    need = float(np.linalg.norm(cam3[:, 3] - 0.5)) + 0.3
    steps = 512 if t_end >= need else 1024
    print(f"multinerf: 512 lattice steps reach t = {t_end:.3f}, the spheres "
          f"need {need:.3f}: march_steps {steps}")
    r = mn.MultiNerfRenderer(march_steps=steps, device=dev)
    r_sum = mn.MultiNerfRenderer(march_steps=steps, composite_mode="sum",
                                 device=dev)
    r_sum.fields = r.fields
    for what, path in (("trained", snap), ("its copy", copy),
                       ("reference", ref_snap)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        field = r._field(str(path))
        torch.cuda.synchronize()
        print(f"multinerf: {what} snapshot loaded as a field "
              f"({field.grid_impl} grid) in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    def req(nerfs, camera=None, modifiers=(), **out):
        out.setdefault("width", W)
        out.setdefault("height", H)
        out.setdefault("color_space", "srgb")
        return mn.RenderRequest(
            mn.RenderOutputProperties(**out),
            camera or mn.RenderCameraProperties(transform=cam,
                                                focal_length=focal),
            list(nerfs), list(modifiers))

    def desc(path=snap, transform=None, **kw):
        return mn.NerfDescriptor(
            snapshot_path=str(path),
            transform=(np.eye(4, dtype=np.float32) if transform is None
                       else transform), **kw)

    # 1. the trained scene at held-out view 0 (rows flipped back; the
    #    view's 256² pixels are the frame's centre at the same focal)
    with _DeviceTime(bgc, "launch_fwd") as k1:
        img = _timed_request(r.render, req([desc()]), "trained scene, "
                             "held-out view 0", W, H)
    print(f"multinerf: K1 in that request: {k1.ms():.2f} ms of device time "
          f"over {k1.calls} launches, {k1.samples} samples")
    vw, vh = int(test["w"]), int(test["h"])
    y0, x0 = (H - vh) // 2, (W - vw) // 2
    crop = img[::-1][y0:y0 + vh, x0:x0 + vw, :3]
    psnr = _psnr_srgb(crop, root / frame0["file_path"])
    print(f"multinerf: held-out view 0 PSNR {psnr:.2f} dB (the runner's "
          f"{view0_psnr:.2f} dB; Δ {psnr - view0_psnr:+.2f}, allowed "
          f"±{MULTINERF_PSNR_DB})")
    if not abs(psnr - view0_psnr) <= MULTINERF_PSNR_DB:
        raise RuntimeError("the multi-NeRF frame's PSNR is not the runner's")

    # 2. camera and descriptor moved by one rigid transform
    g = _rigid(30.0, 1, (0.3, -0.2, 0.1))
    moved = _timed_request(r.render, req(
        [desc(transform=g)], mn.RenderCameraProperties(
            transform=g @ cam, focal_length=focal)),
        "rigidly moved camera and scene", W, H)
    d = np.abs(moved - img)
    print(f"multinerf: rigid motion: mean |Δ| {d.mean():.3e}, max "
          f"{d.max():.3e} (allowed mean {RIGID_TOL})")
    if not d.mean() <= RIGID_TOL:
        raise RuntimeError("a rigid motion of camera and scene changed the "
                           "frame")

    # 3. two fields: the copy scaled 0.5 and moved along the camera's right
    place = _about_centre(0.5, cam3[:, 0] * 0.35)
    two = [desc(), desc(copy, place)]
    _timed_request(r.render, req(two), "two fields, nearest", W, H)
    _timed_request(r_sum.render, req(two), "two fields, sum", W, H)
    sphere_xf = _about_centre(1.0, cam3[:, 0] * 0.35)
    box_xf = np.eye(4, dtype=np.float32)
    box_xf[:3, 3] = (0.5, 0.5, 0.45)
    masked = [desc(opacity=0.5), desc(copy, place, masks=[mn.Mask3D(
        shape="sphere", mode="add", transform=sphere_xf, radius=0.08,
        feather=0.02)])]
    box = mn.Mask3D(shape="box", mode="subtract", transform=box_xf,
                    dims=np.full(3, 0.2, np.float32), feather=0.01)
    _timed_request(r.render, req(masked, modifiers=[box]), "two fields, "
                   "opacity 0.5, a subtract box and an add sphere", W, H)
    everything = mn.Mask3D(shape="box", mode="subtract",
                           transform=np.eye(4, dtype=np.float32),
                           dims=np.full(3, 8.0, np.float32))
    gone = _timed_request(r.render, req(two, modifiers=[everything]),
                          "two fields under a subtract box over the AABB",
                          W, H)
    print(f"multinerf: a subtract box over the AABB leaves max alpha "
          f"{float(gone[..., 3].max())} (required 0)")
    if gone[..., 3].max() != 0.0:
        raise RuntimeError("a subtract box over the whole AABB left alpha")
    alone = r_sum.render(req([desc()]))
    with_zero = _timed_request(r_sum.render, req(
        [desc(), desc(copy, place, opacity=0.0)]),
        "sum mode with an opacity-0 second field", W, H)
    same = np.array_equal(alone, with_zero)
    print(f"multinerf: an opacity-0 field leaves the sum-mode frame bit for "
          f"bit: {same}")
    if not same:
        raise RuntimeError("an opacity-0 descriptor changed the frame")

    # 4. the fork's other camera models, in the held-out camera's frame
    corners = np.array([[-0.4, -0.225, 0.0], [0.4, -0.225, 0.0],
                        [-0.4, 0.225, 0.0], [0.4, 0.225, 0.0],
                        [-0.6, -0.34, 2.0], [0.6, -0.34, 2.0],
                        [-0.6, 0.34, 2.0], [0.6, 0.34, 2.0]], np.float32)
    for what, camp in (
            ("spherical quadrilateral", mn.RenderCameraProperties(
                transform=cam, model="spherical_quadrilateral", sq_width=0.8,
                sq_height=0.45, sq_curvature=0.3)),
            ("quadrilateral hexahedron", mn.RenderCameraProperties(
                transform=cam, model="quadrilateral_hexahedron",
                qh_corners=corners))):
        f = _timed_request(r.render, req([desc()], camp), what, W, H)
        print(f"multinerf: the {what} camera's max alpha "
              f"{float(f[..., 3].max()):.4f} (required > 0.05)")
        if not f[..., 3].max() > 0.05:
            raise RuntimeError(f"the {what} camera saw nothing")

    # 5. output options
    dof = mn.RenderCameraProperties(transform=cam, focal_length=focal,
                                    aperture_size=0.02,
                                    focus_z=float(np.linalg.norm(
                                        cam3[:, 3] - 0.5)))
    _timed_request(r.render, req([desc()], dof, spp=4),
                   "spp 4, aperture 0.02", W, H)
    _timed_request(r.render, req([desc()], tonemap_curve=TonemapCurve.ACES,
                                 exposure=0.5, color_space="linear"),
                   "ACES, exposure 0.5, linear", W, H)
    _timed_request(r.render, req([desc()], width=2 * W, height=2 * H,
                                 downsample=mn.DownsampleInfo.MakeFromMip(1)),
                   f"{2 * W}x{2 * H} at mip 1 ->", W, H)

    # 6. the pyngp shim, as a Blender plugin script drives it
    tb = ngp.Testbed(ngp.TestbedMode.Nerf, device=dev)
    shim_req = req(two, modifiers=[box])
    _timed_request(tb.request_nerf_render_sync, shim_req,
                   "shim request_nerf_render_sync (its fields load)", W, H)
    sync = _timed_request(tb.request_nerf_render_sync, shim_req,
                          "shim request_nerf_render_sync", W, H)
    done, got = threading.Event(), []
    tb.request_nerf_render_async(shim_req, lambda im: (got.append(im),
                                                       done.set()))
    if not done.wait(300):
        raise RuntimeError("request_nerf_render_async never called back")
    tb._render_thread.join(60)
    same = np.array_equal(got[0], sync)
    print(f"multinerf: shim async frame equals the sync frame bit for bit: "
          f"{same}")
    if not same:
        raise RuntimeError("the async render differs from the sync render")
    ngp.free_temporary_memory()
    if tb._multi_nerf.fields:
        raise RuntimeError("free_temporary_memory kept the loaded fields")
    tb.reload_network_from_file(config)
    tb.load_training_data(root / "transforms.json")
    tb.load_snapshot(snap)
    tb.set_nerf_camera_matrix(np.asarray(frame0["transform_matrix"],
                                         np.float32)[:3])
    tb._view_focal = np.array([focal, focal], np.float32)
    tb.background_color = np.array([0, 0, 0, 1], np.float32)
    end = np.asarray(frame0["transform_matrix"], np.float32).copy()
    end[:3, 3] += 0.05
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = tb.render_with_rolling_shutter(frame0["transform_matrix"], end,
                                        [0.0, 0.0, 1.0, 0.0], W, H)
    torch.cuda.synchronize()
    _check_frame(torch.from_numpy(rs), W, H)
    print(f"multinerf: shim render_with_rolling_shutter {W}x{H} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; mean opacity "
          f"{float(rs[..., 3].mean()):.4f}")
    plain = _timed_frame(tb, "Testbed.render without render_masks")
    tb.render_masks = [mn.Mask3D(shape="box", mode="subtract",
                                 transform=box_xf,
                                 dims=np.full(3, 0.3, np.float32))]
    cut = _timed_frame(tb, "Testbed.render with a subtract box in "
                       "render_masks")
    lo, hi = box_xf[:3, 3] - 0.15, box_xf[:3, 3] + 0.15
    hit = _ray_box_hits(tb.camera_matrix, focal, W, H, lo - 0.005, hi + 0.005)
    clear = ~_ray_box_hits(tb.camera_matrix, focal, W, H, lo - 0.02,
                           hi + 0.02)
    da = plain[..., 3] - cut[..., 3]
    print(f"multinerf: render_masks box: mean alpha through it "
          f"{plain[..., 3][hit].mean():.4f} -> {cut[..., 3][hit].mean():.4f} "
          f"({int(hit.sum())} px; cut required >= {MASK_CUT}); outside max "
          f"|Δ| {np.abs(da[clear]).max():.3e} ({int(clear.sum())} px; "
          f"allowed 1e-4)")
    if not (da[hit].mean() >= MASK_CUT
            and np.abs(da[clear]).max() <= 1e-4):
        raise RuntimeError("render_masks did not cut alpha in the box alone")

    # 7. a reference snapshot as a third descriptor: the card against the
    #    CPU, and the tcnn-layout gather's device time in a full frame
    ref_place = _about_centre(0.5, -cam3[:, 0] * 0.35)
    three = two + [desc(ref_snap, ref_place)]
    with _DeviceTime(thg, "hashgrid_encode") as gather, \
            _DeviceTime(bgc, "launch_fwd") as k1:
        _timed_request(r.render, req(three), "three fields, the third a "
                       "reference snapshot", W, H)
    print(f"multinerf: in that request, the tcnn-layout gather (plain "
          f"PyTorch) {gather.ms():.2f} ms of device time over "
          f"{gather.calls} calls, {gather.samples} samples; K1 "
          f"{k1.ms():.2f} ms over {k1.calls} launches, {k1.samples} "
          f"samples")
    cw, ch = cpu_size
    small = req(three, camera=mn.RenderCameraProperties(
        transform=cam, focal_length=focal * cw / W), width=cw, height=ch)
    card = r.render(small)
    cpu = mn.MultiNerfRenderer(march_steps=steps, device="cpu").render(small)
    d = np.abs(card - cpu)
    print(f"multinerf: {cw}x{ch} three-field frame, card vs CPU: mean |Δ| "
          f"{d.mean():.3e}, max {d.max():.3e} (allowed mean "
          f"{MULTINERF_CPU_TOL})")
    if not d.mean() <= MULTINERF_CPU_TOL:
        raise RuntimeError("the card's multi-NeRF frame disagrees with the "
                           "CPU's")

    # 8. launches
    launches = dict(bgc.launches)
    print(f"multinerf: launches in the phase {launches}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if launches["blocked_grid_encode_fwd"] <= 0:
        raise RuntimeError("the multinerf phase never launched K1")
    extra = [k for k, v in launches.items()
             if k != "blocked_grid_encode_fwd" and v]
    if extra:
        raise RuntimeError(f"the multinerf phase launched {extra}")
    return launches



# the wave phase: frames rendered in turns per renderer; the wave frames
# held against the static and each other at the means and shares of the
# static render's parity test (mean |Δ| ≤ WAVE_MEAN_TOL, ≥ WAVE_SHARE of
# the pixels within WAVE_PIXEL_TOL)
WAVE_FRAMES = 3
WAVE_MEAN_TOL, WAVE_PIXEL_TOL, WAVE_SHARE = 2e-4, 2e-3, 0.995


def count_syncs(fn):
    """``fn()`` under the card's sync debug mode ("warn"): returns (its
    result, a Counter of the synchronizing CUDA operations it made by the
    source line that called them: each ``nonzero``, ``.item()``, copy to
    or from the host that waits, and synchronize). An event's or stream's
    own wait is not among them: the renderer counts those it makes
    (``last_event_waits``)."""
    import collections
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))


def _gate_frames(tag: str, what: str, got: torch.Tensor, ref: torch.Tensor):
    """Two gates on a frame against another: the mean |Δ| and the share
    of pixels within WAVE_PIXEL_TOL on every channel."""
    err = (got - ref).abs()
    within = float((err <= WAVE_PIXEL_TOL).all(-1).float().mean())
    _gate_max(tag, f"{what}: mean |Δ|", float(err.mean()), WAVE_MEAN_TOL)
    _gate_min(tag, f"{what}: share of pixels within {WAVE_PIXEL_TOL}",
              within, WAVE_SHARE)


def _gate_zero(tag: str, what: str, value: int):
    """A gate on a count that must be 0 (its share: the count itself)."""
    _gate(tag, what, value, "== 0", value == 0, float(value), fmt="d")


def _gate_some(tag: str, what: str, value: int):
    """A gate on a count that must be at least 1 (its share: 1 / count)."""
    _gate(tag, what, value, ">= 1", value >= 1, 1.0 / max(value, 1),
          fmt="d")


def _launches_in(fn):
    """(``fn()``, the kernel launches it made)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    before = dict(bgc.launches)
    out = fn()
    return out, {k: v - before[k] for k, v in bgc.launches.items()}


def phase_wave(dev, root: Path = None, config=None, cpu_size=(64, 36),
               frames: int = WAVE_FRAMES, profile: bool = False):
    """The wave (live-sample) renderers on the testbed phase's snapshot
    (``root``/snapshot.msgpack), at held-out view 0 and 640×360 with the
    Testbed's own render options: the static frame, the device-dispatch
    wave frame (the defaults) and the host-dispatch one (fused, "bulk")
    ``frames`` times each in turns (ms/frame after the first, samples,
    host syncs per frame by ``count_syncs`` plus the renderer's own event
    waits), the PSNR of the wave frame against the static one; then the
    gates: host segmented at wave_cap c against the static frame at
    samples_per_chunk_factor c, the device dispatch against host fused
    with a top stream that does not bind, the default wave frame twice
    bit for bit, an empty bitfield (nothing composited, the background
    everywhere), a small frame on the card against the CPU path, the
    launches (K1 in the f32 wave frames and K2-K5 not, K4 in a wave frame
    under encode_int8="fwd"), fewer syncs on the device dispatch than on
    the static frame; and K1 on the wave frame's largest encode call
    against its plain version, timed beside its bound. Returns (the
    phase's launch counts, that K1 entry with its launches in the phase's
    f32 wave frames). ``profile`` traces one frame of each renderer by
    layer (``trace_frame``)."""
    import dataclasses

    import ngp_tpu_torch.render.nerf_render as nr

    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.nerf_render import NerfRenderer

    t_phase = time.perf_counter()
    root = root or ROOT / "build" / "testbed_smoke"
    config = Path(config or ROOT / "configs/nerf/base.json")
    tb = _nerf_testbed(dev, root, config, root / "snapshot.msgpack")
    test = json.loads((root / "transforms_test.json").read_text())
    tb.set_nerf_camera_matrix(np.asarray(
        test["frames"][0]["transform_matrix"], np.float32)[:3])
    focal = float(test["fl_x"])
    tb._view_focal = np.array([focal, focal], np.float32)
    W, H = FRAME_W, FRAME_H
    tr = tb.trainer
    params, bitfield = tr.inference_params(), tr.grid.bitfield
    cam = np.asarray(tb.camera_matrix, np.float32)
    static = tb._nerf_renderer(W, H)
    _reset_launches()

    def renderer(encode_int8=None, **kw):
        extra = {} if encode_int8 is None else {"encode_int8": encode_int8}
        return NerfRenderer.for_trainer(
            tr, dataclasses.replace(static.opts, **kw), **extra)

    def frame(r, bits=None, size=(W, H), f=focal):
        return r.render(params, bitfield if bits is None else bits, cam,
                        *size, focal=(f, f), spp=1)

    opts = static.opts
    print(f"wave: {tr.model.pos_encoding.meta.n_levels} levels, "
          f"march_steps {opts.march_steps}, chunk {opts.chunk}, wave_cap "
          f"{opts.wave_cap} x march_segments {opts.march_segments}, "
          f"dispatch_chunks {opts.dispatch_chunks}, wave2_top_bucket "
          f"{opts.wave2_top_bucket}")
    paths = {"static": static, "wave device": renderer(wave=True),
             "wave host fused bulk": renderer(wave=True,
                                              wave_dispatch="host")}
    ms = {k: [] for k in paths}
    imgs = {k: [] for k in paths}
    k1_wave = 0
    for _ in range(frames):
        for what, r in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, n = _launches_in(lambda: frame(r))
            torch.cuda.synchronize()
            ms[what].append((time.perf_counter() - t0) * 1e3)
            _check_frame(img, W, H)
            imgs[what].append(img)
            if what != "static":
                k1_wave += n["blocked_grid_encode_fwd"]
                _gate_zero("wave", f"{what}: launches of K2-K5 in an f32 "
                           "frame", sum(v for k, v in n.items()
                                        if k != "blocked_grid_encode_fwd"))

    def event_wait():
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    _, event_warns = count_syncs(event_wait)
    syncs = {}
    for what, r in paths.items():
        _, sites = count_syncs(lambda: frame(r))
        torch.cuda.synchronize()
        n = sum(sites.values())
        syncs[what] = n + r.last_event_waits
        samples = f"{r.last_n_samples} samples evaluated"
        if r._wave_supported():
            samples += f", {r.last_wave_samples} composited"
        print(f"wave: {what}: {np.mean(ms[what][1:]):.1f} ms/frame after "
              f"the first ({', '.join(f'{t:.1f}' for t in ms[what])}); "
              f"{samples}; {syncs[what]} host syncs per frame ({n} "
              f"sync-debug warnings + {r.last_event_waits} event waits); "
              f"warnings by line: " + ", ".join(
                  f"{k} x{v}" for k, v in sites.most_common()))
    print(f"wave: syncs counted by torch.cuda.set_sync_debug_mode('warn') "
          f"warnings, plus the renderer's own event waits "
          f"(last_event_waits); an event wait alone gave "
          f"{sum(event_warns.values())} warnings")
    if profile:
        device, host = paths["wave device"], paths["wave host fused bulk"]
        net = [(tr.model, "forward", "network (K1 + MLPs)"),
               (nr, "stream_slots", "stream_slots")]
        for what, r, layers in (
                ("static", static, static_layers(static, nr)),
                ("wave device", device, [
                    (nr, "coarse_segments", "coarse_segments"),
                    (device, "_wave2_stream", "segment stream + fit"),
                    (device, "_wave2_composite", "stream, network, "
                     "composite")] + net),
                ("wave host fused bulk", host, [
                    (host, "_wave_start", "march + count"),
                    (host, "_wave_finish", "read count + body"),
                    (nr, "composite_samples", "composite_samples")] + net)):
            print(trace_frame(what, lambda: frame(r), layers, top_n=10))
    mse = float(((imgs["wave device"][0][..., :3].clamp(0, 1)
                  - imgs["static"][0][..., :3].clamp(0, 1)) ** 2).mean())
    print(f"wave: PSNR of the default wave frame against the static frame "
          f"{-10 * math.log10(max(mse, 1e-20)):.2f} dB (not gated: the "
          f"whole-ray cap and the top-stream decimation may change it)")
    _gate_some("wave", f"K1 launches in the {2 * frames} f32 wave frames",
               k1_wave)

    # the gates
    c = opts.samples_per_chunk_factor
    seg = frame(renderer(wave=True, wave_dispatch="host", wave_fused=False,
                         wave_cap=c))
    _gate_frames("wave", f"host segmented at wave_cap {c} vs static at "
                 f"samples_per_chunk_factor {c}", seg, imgs["static"][0])
    cap = min(opts.wave_cap * opts.march_segments, opts.march_steps)
    dev_free = frame(renderer(wave=True,
                              wave2_top_bucket=opts.chunk * cap))
    _gate_frames("wave", f"device (top stream {opts.chunk} x {cap}) vs "
                 "host fused", dev_free, imgs["wave host fused bulk"][0])
    n_diff = int((imgs["wave device"][-2] != imgs["wave device"][-1]).sum())
    _gate_zero("wave", "default wave frame rendered twice: values that "
               "differ", n_diff)
    empty = torch.zeros_like(bitfield)
    bg = torch.tensor(opts.background[:3], device=dev)
    for dispatch in ("device", "host"):
        r = renderer(wave=True, wave_dispatch=dispatch, linear_out=False)
        img = frame(r, empty)
        _gate_zero("wave", f"{dispatch} dispatch, empty bitfield: samples "
                   "composited", r.last_wave_samples)
        off = int(((img[..., :3] != bg).any(-1) | (img[..., 3] != 0)).sum())
        _gate_zero("wave", f"{dispatch} dispatch, empty bitfield: pixels "
                   "that are not the background", off)
    cw, ch = cpu_size
    small = frame(paths["wave device"], size=cpu_size, f=focal * cw / W)
    model_cpu, params_cpu = _cpu_copy(tr.model, params)
    cpu = NerfRenderer(model_cpu, tr.aabb_min, tr.aabb_size, tr.cone_angle,
                       tr.max_cascade, paths["wave device"].opts).render(
        params_cpu, bitfield.cpu(), cam, cw, ch,
        focal=(focal * cw / W, focal * cw / W), spp=1)
    _gate_frames("wave", f"{cw}x{ch} wave frame, card vs CPU", small.cpu(),
                 cpu)
    i8, n = _launches_in(lambda: frame(renderer(wave=True,
                                                encode_int8="fwd")))
    _check_frame(i8, W, H)
    k4 = n["blocked_grid_encode_fwd_i8"]
    print(f"wave: a wave frame under encode_int8='fwd': launches {n}")
    _gate_some("wave", "K4 launches in a wave frame under encode_int8="
               "'fwd'", k4)
    _gate_max("wave", "host syncs per frame, device dispatch vs static",
              syncs["wave device"], syncs["static"] - 1)

    # K1 on the wave frame's largest encode call; the segments the coarse
    # mask keeps, and those of them that hold a live sample
    seen, segs = [], [0, 0, 0]
    launch, coarse, stream = (bgc.launch_fwd, nr.coarse_segments,
                              nr.march_segment_stream)

    def spy(table, pos, meta):
        seen.append(pos.clone())
        return launch(table, pos, meta)

    def spy_coarse(*args, **kw):
        out = coarse(*args, **kw)
        segs[0] += out[2].numel()
        segs[1] += int(out[2].sum())
        return out

    def spy_stream(*args, **kw):
        out = stream(*args, **kw)
        segs[2] += int(out[6].any(1).sum())
        return out
    with mock.patch.object(bgc, "launch_fwd", spy), \
            mock.patch.object(nr, "coarse_segments", spy_coarse), \
            mock.patch.object(nr, "march_segment_stream", spy_stream):
        frame(paths["wave device"])
    # the phase's counts come from its frames alone: the check and the
    # timing of K1 below launch it too
    launches = dict(bgc.launches)
    print(f"wave: segments of the default wave frame: {segs[0]} on the "
          f"rays, {segs[1]} kept by the coarse mask, {segs[2]} of them "
          f"holding a live sample")
    pos = max(seen, key=lambda p: p.shape[0])
    print(f"wave: the default wave frame's largest encode call took "
          f"{pos.shape[0]} of its {sum(p.shape[0] for p in seen)} samples "
          f"over {len(seen)} calls")
    table, meta = params["pos_encoding.table"], tr.model.pos_encoding.meta
    err = check_k1(table, pos, meta, "wave frame")
    entry = time_k1(table, pos, meta, err, "wave frame")
    entry["launch_name"] = entry["name"]
    entry["name"] = f"{entry['name']} (wave frame)"
    entry["launches"] = k1_wave
    print(f"wave: launches in the phase {launches}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, entry


# the dist phase: the distributed paths on the one card, NCCL at world 1 in
# this process and gloo at world 2 (two spawned ranks on cuda:0: NCCL
# refuses two ranks of one communicator on one device). A data-parallel
# step is held against the single-device step on the same rays by means and
# shares of the parameter entries (K2 adds in f32 atomics, so not even the
# single-device step repeats bit for bit on the card; an entry whose
# gradient nearly cancels may take Adam's first ±lr the other way): mean
# |Δ| ≤ DIST_MEAN_TOL·lr, ≥ DIST_SHARE of the entries within
# DIST_ENTRY_TOL·lr. The table-parallel NeRF step takes
# tests/test_tp_nerf.py's rule: fewer than TP_OFF_SHARE of the table
# entries off by more than TP_OFF, none by more than 2.5·lr, the MLPs to
# rtol TP_MLP_RTOL.
DIST_MEAN_TOL, DIST_ENTRY_TOL, DIST_SHARE = 0.05, 1e-3, 0.99
TP_OFF, TP_OFF_SHARE, TP_MLP_RTOL = 5e-5, 1e-3, 2e-4
# rays a rank: few enough that no rank's step drops rays at its segment
# capacity (a comparison with the single-device step on all ranks' rays
# holds only then; the bench's 4096 overflow it on the trained spheres)
DIST_RAYS, DIST_STEPS, DIST_TRAIN_STEPS, DIST_IMAGE_STEPS = 512, 8, 32, 4
DIST_TP_POSITIONS = 1 << 20


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: ranks compare state by it."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _dist_scene(dev, root: Path, config: Path):
    """(Testbed from the testbed phase's snapshot, the held-out view 0's
    NGP camera, its focal length)."""
    tb = _nerf_testbed(dev, root, config, root / "snapshot.msgpack")
    test = json.loads((root / "transforms_test.json").read_text())
    tb.set_nerf_camera_matrix(np.asarray(
        test["frames"][0]["transform_matrix"], np.float32)[:3])
    return tb, np.asarray(tb.camera_matrix, np.float32), float(test["fl_x"])


def _dist_trainer(tb, dev, root: Path, mesh=None):
    """make_trainer's trainer (a DpNerfTrainer over ``mesh`` when given)
    on the testbed phase's scene, from its snapshot."""
    tr = make_trainer(tb.trainer.dataset, dev, config=tb.network_config,
                      mesh=mesh)
    tr.load_snapshot_state(root / "snapshot.msgpack")
    return tr


def _gate_steps(tag: str, what: str, got, ref, lr: float):
    """A step's parameters and loss against another step's on the same
    rays: the loss to rtol 1e-4, the sample counts equal, mean |Δ| and the
    share of entries within DIST_ENTRY_TOL·lr over all parameters."""
    (gp, gs), (rp, rs) = got, ref
    _gate_max(tag, f"{what}: |Δ loss| / loss",
              abs(float(gs.loss) - float(rs.loss)) / abs(float(rs.loss)),
              1e-4)
    _gate_zero(tag, f"{what}: samples that differ",
               abs(int(gs.total) - int(rs.total)))
    diff = torch.cat([(gp[k] - rp[k]).abs().flatten() for k in rp])
    equal = all(torch.equal(gp[k], rp[k]) for k in rp)
    print(f"{tag}: {what}: parameters bit-equal: {equal}; "
          f"{int((diff > 0).sum())} of {diff.numel()} entries differ, "
          f"max |Δ| {float(diff.max()) / lr:.3g} lr")
    _gate_max(tag, f"{what}: mean |Δ| / lr", float(diff.mean()) / lr,
              DIST_MEAN_TOL)
    _gate_min(tag, f"{what}: share of entries within {DIST_ENTRY_TOL} lr",
              float((diff <= DIST_ENTRY_TOL * lr).float().mean()),
              DIST_SHARE)


def _params_of(tr) -> dict:
    return {k: v.detach().clone() for k, v in tr.params.items()}


def _dp_step_pair(tb, dev, root: Path, mesh, tag: str,
                  n_rays: int = DIST_RAYS) -> tuple:
    """One data-parallel step of a trainer from the snapshot on this rank's
    ``n_rays`` rays, held against the single-device step on every rank's
    rays at n_data times the capacity; then DIST_STEPS - 1 more steps.
    Returns (the trainer, its launches in the steps, ms per step)."""
    from ngp_tpu_torch.dist.nerf_dp import make_dp_train_step, rank_generator
    from ngp_tpu_torch.train.nerf import StepDraws
    a = _dist_trainer(tb, dev, root)
    S = a.tcfg.target_batch_size
    draws = [a.draws(n_rays, rank_generator(a.seed, d, dev))
             for d in range(mesh.n_data)]
    step = make_dp_train_step(a, mesh, n_rays, S)
    err = a._error_state()
    st, n = _launches_in(lambda: step(err))
    # the comparison needs every rank's rays kept whole: the ranks'
    # segments within half their capacities, so none reaches its own
    _gate_max(tag, f"DP({mesh.n_data}) step: surviving segments of the "
              f"ranks over their capacity", st.seg_total
              / (a._seg_capacity * mesh.n_data), 0.5)
    got = (_params_of(a), st)
    b = _dist_trainer(tb, dev, root)
    cat = StepDraws(*(None if x[0] is None else torch.cat(x)
                      for x in zip(*draws)))
    ref = b._train_step(cat, b._error_state(), capacity=S * mesh.n_data)
    _gate_steps(tag, f"DP({mesh.n_data}) step vs the single-device step "
                f"on {mesh.n_data} x {n_rays} rays", got,
                (_params_of(b), ref), a.opt_cfg.learning_rate)
    del b
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS - 1):
        _, m = _launches_in(lambda: step(a._error_state()))
        n = {k: n[k] + m[k] for k in n}
    _sync(dev)
    return a, n, (time.perf_counter() - t0) * 1e3 / (DIST_STEPS - 1)


def _multichip_frame(tb, mesh, cam, focal: float, tag: str, limit: float,
                     size=(FRAME_W, FRAME_H)) -> tuple:
    """``render_multichip`` of the held-out view at ``size`` over ``mesh``
    against ``render`` of it: mean |Δ| ≤ ``limit``. Returns (its
    launches, ms)."""
    W, H = size
    r = tb._nerf_renderer(W, H)
    tr = tb.trainer
    params, bits = tr.inference_params(), tr.grid.bitfield
    f = (focal * W / FRAME_W,) * 2
    _sync(bits.device)
    t0 = time.perf_counter()
    multi, n = _launches_in(lambda: r.render_multichip(
        mesh, params, bits, cam, W, H, focal=f, spp=1))
    _sync(bits.device)
    ms = (time.perf_counter() - t0) * 1e3
    _check_frame(multi, W, H)
    ref = r.render(params, bits, cam, W, H, focal=f, spp=1)
    err = float((multi - ref).abs().mean())
    _gate(tag, f"render_multichip over {mesh.n_data} data rank(s) vs "
          f"render, {W}x{H}: mean |Δ|", err,
          f"<= {limit}", err <= limit, err / limit if limit else err)
    return n, ms


def _dist_rank(rank: int, world: int, device: str, root: str, config: str,
               image_config: str, sizes: dict) -> dict:
    """What each rank of the gloo world runs on ``device`` (the card's
    cuda:0); returns its figures, its launches on the distributed paths and
    digests of its state."""
    from ngp_tpu_torch.common import srgb_to_linear
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.dist.mesh import (make_mesh, make_tp_blocked_encode,
                                         table_sharding)
    from ngp_tpu_torch.dist.nerf_dp import rank_generator
    from ngp_tpu_torch.dist.tp_image import TpImageTrainer
    from ngp_tpu_torch.dist.tp_nerf import make_tp_nerf_train_step
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import encode_reference
    # whole lines, so the ranks' lines do not break into each other
    sys.stdout.reconfigure(line_buffering=True)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"dist rank {rank}"
    root, config = Path(root), Path(config)
    dp = make_mesh(n_data=world)
    tp = make_mesh(n_data=1, n_model=world)
    tb, cam, focal = _dist_scene(dev, root, config)
    out = {}
    # DP(2): one step against the single-device step, then 7 more
    a, n, out["dp_ms"] = _dp_step_pair(tb, dev, root, dp, tag, sizes["rays"])
    out["dp_digest"] = _digest(list(a.params.values())
                               + list(a.opt_state.mu.values())
                               + [a.error_map, a.sharpness_grid])
    del a
    # frame-sharded rendering
    m, out["frame_ms"] = _multichip_frame(tb, dp, cam, focal, tag, 1e-6,
                                          sizes["frame"])
    n = {k: n[k] + m[k] for k in n}
    # DpNerfTrainer: the whole loop (partial sweeps through K4)
    dt = _dist_trainer(tb, dev, root, mesh=dp)
    _sync(dev)
    t0 = time.perf_counter()
    loss, m = _launches_in(lambda: dt.train(sizes["train_steps"]))
    _sync(dev)
    out["train_ms"] = (time.perf_counter() - t0) * 1e3 / sizes["train_steps"]
    n = {k: n[k] + m[k] for k in n}
    if not math.isfinite(loss):
        raise RuntimeError(f"{tag}: DpNerfTrainer loss {loss}")
    out["train_loss"] = loss
    out["train_digest"] = _digest(list(dt.params.values())
                                  + [dt.grid.density, dt.grid.bitfield])
    del dt
    # TP NeRF step (model 2; the encode is plain PyTorch) against the
    # single-device step on the same rays
    c = _dist_trainer(tb, dev, root)
    lr = c.opt_cfg.learning_rate
    draws = c.draws(sizes["rays"], rank_generator(c.seed, 0, dev))
    S = c.tcfg.target_batch_size
    st = make_tp_nerf_train_step(c, tp, sizes["rays"], S)(c._error_state(),
                                                          draws)
    d = _dist_trainer(tb, dev, root)
    sr = d._train_step(draws, d._error_state(), capacity=S)
    rows = table_sharding(tp, c.model.pos_encoding.meta.rows)
    cp, one = _params_of(c), _params_of(d)
    diff = (cp["pos_encoding.table"]
            - one["pos_encoding.table"][:, rows]).abs()
    _gate_max(tag, "TP step vs the single-device step: |Δ loss| / loss",
              abs(float(st.loss) - float(sr.loss)) / abs(float(sr.loss)),
              1e-4)
    _gate_max(tag, f"TP step: share of the shard's table entries off by "
              f"more than {TP_OFF}", float((diff > TP_OFF).float().mean()),
              TP_OFF_SHARE)
    _gate_max(tag, "TP step: max table |Δ| / lr", float(diff.max()) / lr,
              2.5)
    mlp = max(float(((cp[k] - one[k]).abs()
                     / (one[k].abs() * TP_MLP_RTOL + 2e-5)).max())
              for k in one if k != "pos_encoding.table")
    _gate_max(tag, f"TP step: MLP |Δ| over rtol {TP_MLP_RTOL} (atol 2e-5)",
              mlp, 1.0)
    out["tp_shard"] = tuple(cp["pos_encoding.table"].shape)
    del c, d, cp, one
    # TpImageTrainer at full width (configs/image/base.json)
    u8 = synth_image(sizes["image_res"])
    img = srgb_to_linear(torch.from_numpy(u8).float() / 255.0).numpy()
    ti = TpImageTrainer(img, load_network_config(image_config), tp,
                        seed=SEED, device=dev)
    losses, t0 = [], time.perf_counter()
    for _ in range(DIST_IMAGE_STEPS):
        losses.append(float(ti.step()))     # float() waits for the step
    out["image_ms"] = (time.perf_counter() - t0) * 1e3 / DIST_IMAGE_STEPS
    meta2 = ti.meta
    full = meta2.n_levels * meta2.rows * 128 * 4
    out["image"] = {"losses": losses, "shard_bytes": ti.table_shard_bytes(),
                    "table_bytes": full}
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"{tag}: TpImageTrainer losses {losses}")
    _gate_zero(tag, "TpImageTrainer: shard bytes x world - table bytes",
               ti.table_shard_bytes() * world - full)
    del ti
    # the launches of the paths above, before the checks below launch K1
    out["launches"] = n
    # the TP encode at DIST_TP_POSITIONS positions against K1 on the whole
    # table (a comparison launch, not counted)
    tr = tb.trainer
    meta = tr.model.pos_encoding.meta
    table = tr.params["pos_encoding.table"].detach()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    pos = torch.rand((sizes["tp_positions"], 3), generator=g, device=dev)
    with torch.no_grad():
        feats = make_tp_blocked_encode(meta, tp)(
            table[:, table_sharding(tp, meta.rows)].contiguous(), pos)
        ref = (bgc.launch_fwd(table, pos, meta) if dev.type == "cuda"
               else encode_reference(table, pos, meta))
    err = float((feats - ref).abs().max())
    _gate_max(tag, f"TP encode (model {world}) vs K1 on the whole table at "
              f"{pos.shape[0]} positions: max |Δ|", err, KERNEL_TOL)
    return out


def phase_dist(dev, root: Path = None, config=None, image_config=None,
               sizes: dict = None):
    """The distributed paths (``ngp_tpu_torch.dist``) on the card: NCCL at
    world 1 in this process (one DP(1) step against the single-device
    step; ``render_multichip`` of the held-out view at FRAME_W × FRAME_H
    against ``render``: mean |Δ| 0), then gloo at world 2, two spawned
    ranks on this card (``_dist_rank``: the DP(2) step against the
    single-device step on both ranks' rays, the ranks' state equal after
    DIST_STEPS steps; ``render_multichip``; ``DpNerfTrainer.train``; the
    TP NeRF step against the single-device step; ``TpImageTrainer`` at full
    width; the TP encode against K1). Gloo on one card moves its sums
    through the host: its ms are no measure of a collective. Returns the
    phase's K1, K2 and K4 launches on those paths, summed over the
    processes; each must be at least 1."""
    import torch.distributed as dist

    from ngp_tpu_torch.dist.mesh import backend_for, make_mesh, run_ranks
    t_phase = time.perf_counter()
    # the phase's sizes (a CPU rehearsal passes smaller ones)
    sizes = {"frame": (FRAME_W, FRAME_H), "rays": DIST_RAYS,
             "tp_positions": DIST_TP_POSITIONS, "image_res": IMAGE_RES,
             "train_steps": DIST_TRAIN_STEPS, **(sizes or {})}
    root = root or ROOT / "build" / "testbed_smoke"
    config = Path(config or ROOT / "configs/nerf/base.json")
    image_config = Path(image_config or ROOT / "configs/image/base.json")
    stores = ROOT / "build" / "dist_smoke"
    stores.mkdir(parents=True, exist_ok=True)
    for p in stores.iterdir():
        p.unlink()
    backend = backend_for(dev, 1)
    print(f"dist: world 1 in this process, backend {backend}")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"file://{stores}/world1",
                            world_size=1, rank=0, **kw)
    try:
        mesh = make_mesh(n_data=1)
        tb, cam, focal = _dist_scene(dev, root, config)
        a, n, ms = _dp_step_pair(tb, dev, root, mesh, "dist", sizes["rays"])
        del a
        print(f"dist: {backend} world 1: {ms:.1f} ms per DP(1) step")
        m, frame_ms = _multichip_frame(tb, mesh, cam, focal, "dist", 0.0,
                                       sizes["frame"])
        print(f"dist: {backend} world 1: render_multichip {frame_ms:.1f} ms "
              "per frame")
        launches = {k: n[k] + m[k] for k in n}
        del tb
    finally:
        dist.destroy_process_group()
    world = 2
    backend = backend_for(dev, world)
    print(f"dist: world {world}, {world} spawned ranks on {dev}, backend "
          f"{backend}")
    t0 = time.perf_counter()
    ranks = run_ranks(_dist_rank, world, backend, stores / "world2",
                      args=(str(dev if dev.type == "cpu" else "cuda:0"),
                            str(root), str(config), str(image_config),
                            sizes))
    print(f"dist: the world of {world} ran in {time.perf_counter() - t0:.1f} "
          "s, its spawn included")
    for r in ranks:
        launches = {k: launches[k] + r["launches"][k] for k in launches}
    r0 = ranks[0]
    print(f"dist: {backend} world {world} on one card (its sums go through "
          f"the host: no measure of a collective): {r0['dp_ms']:.1f} ms per "
          f"DP({world}) step, {r0['frame_ms']:.1f} ms per render_multichip "
          f"frame, {r0['train_ms']:.1f} ms per DpNerfTrainer step (loss "
          f"{r0['train_loss']:.4g}), {r0['image_ms']:.1f} ms per "
          f"TpImageTrainer step at full width (losses "
          + ", ".join(f"{x:.4g}" for x in r0["image"]["losses"])
          + f"; table shard {r0['image']['shard_bytes'] / 2**20:.0f} of "
          f"{r0['image']['table_bytes'] / 2**20:.0f} MiB), TP NeRF table "
          f"shard {r0['tp_shard']}")
    for what in ("dp_digest", "train_digest"):
        digests = [r[what] for r in ranks]
        _gate_zero("dist", f"ranks whose {what.split('_')[0]} state differs "
                   f"from rank 0's ({digests[0]})",
                   sum(d != digests[0] for d in digests))
    for k in ("blocked_grid_encode_fwd", "blocked_grid_encode_bwd",
              "blocked_grid_encode_fwd_i8"):
        _gate_some("dist", f"{k} launches on the distributed paths",
                   launches[k])
    print(f"dist: launches on the distributed paths, all processes "
          f"{launches}; the phase {time.perf_counter() - t_phase:.1f} s")
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
    forward holds K1, the grid sweep K4 and the table's int8 quantisation).
    The backward runs on autograd's own thread and is counted apart, K2
    within it."""
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
              (bgc, "launch_fwd_i8", "K4 encode fwd i8"),
              # the sweep's own call and the int8 training encode's
              (tnerf, "quantize_table_i8", "int8 quantisation"),
              (bgc, "quantize_table_i8", "int8 quantisation")]
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
    rows = [(n, per_span.get(n, 0.0))
            for n in dict.fromkeys(n for _, _, n in layers)]
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


def trace_frame(what: str, render, layers, top_n: int = 0) -> str:
    """Trace ``render()`` (one frame) with torch.profiler: the wall ms, the
    device work and busy time, the idle share, and the device time of the
    work launched inside each layer's span (``layers``: (object,
    attribute, span name); a kernel counts in every span around its
    launch), K1's among them, and the ``top_n`` operations by their own
    device time. Returns the ``profile:`` lines."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    layers = [(bgc, "launch_fwd", "K1 encode fwd")] + list(layers)
    patches = [mock.patch.object(o, a, span(n, getattr(o, a)))
               for o, a, n in layers]
    for p in patches:
        p.start()
    try:
        before = bgc.launches["blocked_grid_encode_fwd"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("frame"):
                render()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()
    k1 = bgc.launches["blocked_grid_encode_fwd"] - before
    names = {n for _, _, n in layers} | {"frame"}
    per_span, _, total, busy = _attribute_kernels(prof, names, "frame")
    lines = [f"profile: {what} {FRAME_W}x{FRAME_H} traced in {wall_ms:.1f} "
             f"ms; device work {total:.2f} ms, busy {busy:.2f} ms: idle "
             f"share {1 - busy / wall_ms:.3f}; K1 "
             f"{per_span.get('K1 encode fwd', 0.0):.3f} ms device in {k1} "
             f"launches"]
    lines += [f"profile: {what}: {n:<28s} {per_span.get(n, 0.0):9.3f} ms "
              "device" for _, _, n in layers[1:]]
    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0 and e.key not in names),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top_n]
    lines += [f"profile: {what}: top {e.key[:60]:<60s} "
              f"{e.self_device_time_total / 1e3:9.3f} ms device in "
              f"{e.count} calls" for e in top]
    return "\n".join(lines)


def phase_profile_frame(renderer, bitfield):
    """Trace one slice frame (``trace_frame``) by render layer."""
    import ngp_tpu_torch.render.nerf_render as nr
    print(trace_frame("frame 0", lambda: renderer.render(
        None, bitfield, orbit_camera(0.0), FRAME_W, FRAME_H, focal=FOCAL,
        spp=1), static_layers(renderer, nr)))


def static_layers(renderer, nr):
    """The static render path's layers, for ``trace_frame``."""
    return [(nr, "march_rays", "march_rays"),
            (nr, "merge_excess_samples", "merge_excess_samples"),
            (nr, "compact_samples", "compact_samples"),
            (renderer.model, "forward", "network (K1 + MLPs)"),
            (nr, "composite_samples", "composite_samples")]


# the image phase: a seeded IMAGE_RES² image fitted by the runner for
# IMAGE_STEPS (configs/image/base.json at full width: 16 levels × 32768
# rows at desired resolution IMAGE_RES / 2, batch 2^18); compute_image_mse's
# PSNR must rise by PSNR_RISE_DB
IMAGE_RES, IMAGE_STEPS, IMAGE_DISCS = 2048, 256, 48
IMAGE_FRAMES = ((FRAME_W, FRAME_H), (IMAGE_RES, IMAGE_RES))
# the sdf phase: a torus (major radius, minor radius, segments around and
# across: 32,768 triangles) fitted by the runner for SDF_STEPS
# (configs/sdf/base.json at full width, batch 2^18, raystab signs); the IoU
# of IOU_SAMPLES uniform samples must reach IOU_MIN, and the frames' hit
# masks agree with the BVH's ray casts on HIT_AGREE_MIN of pixels
TORUS = (0.3, 0.1, 256, 64)
SDF_STEPS, IOU_SAMPLES, IOU_MIN, HIT_AGREE_MIN = 256, 1 << 22, 0.9, 0.95
# a small frame of each engine on the card against the CPU path: the
# slice phase's tolerances (mean |Δ|, and 2e-3 on 99.5 % of pixels) for
# the image; for the SDF frame the hit masks (99 % equal: a ray whose
# march ends next to the threshold may stop one step apart) and mean |Δ|
ENGINE_CPU_TOL, SDF_CPU_TOL = 2e-4, 1e-3
# the image-int8 phase: the uv gradient at UV_RES² pixel centres
UV_RES = 512
# the volume phase: a VOLUME_RES³ procedural plume fitted by the runner for
# VOLUME_STEPS (configs/volume/base.json at full width: 16 levels × 8192
# rows; batch 2^18); the density MSE at VOLUME_MSE_SAMPLES uniform points
# must fall to VOLUME_MSE_RATIO of the untrained network's, and a
# VOLUME_FRAME² frame's opacity > 0.5 mask reach an IoU of VOLUME_IOU_MIN
# with the same march over the ground truth
VOLUME_RES, VOLUME_STEPS, VOLUME_MSE_SAMPLES = 128, 1024, 1 << 20
VOLUME_MSE_RATIO, VOLUME_IOU_MIN, VOLUME_FRAME = 0.5, 0.7, 512


def synth_image(res: int = IMAGE_RES, seed: int = SEED) -> np.ndarray:
    """A (res, res, 3) uint8 sRGB test image from ``seed``: smooth colour
    gradients, a fine sinusoidal grating (12-pixel period) in one
    quadrant, and IMAGE_DISCS hard-edged discs of random colours."""
    rng = np.random.default_rng(seed)
    y, x = (np.mgrid[0:res, 0:res].astype(np.float32) + 0.5) / res
    img = np.stack([0.2 + 0.6 * x, 0.2 + 0.6 * y, 0.8 - 0.6 * x * y], -1)
    theta = rng.uniform(0.0, np.pi)
    grating = 0.5 + 0.45 * np.sin(2 * np.pi * res / 12.0 * (
        x * np.cos(theta) + y * np.sin(theta)))
    quad = (x > 0.5) & (y < 0.5)
    img[quad] = grating[quad][:, None]
    for _ in range(IMAGE_DISCS):
        cx, cy = rng.random(2)
        r = rng.uniform(0.01, 0.08)
        col = rng.random(3).astype(np.float32)
        lo = (np.clip([cy - r, cx - r], 0, 1) * res).astype(int)
        hi = (np.clip([cy + r, cx + r], 0, 1) * res).astype(int) + 1
        win = (slice(lo[0], hi[0]), slice(lo[1], hi[1]))
        inside = (x[win] - cx) ** 2 + (y[win] - cy) ** 2 < r * r
        img[win][inside] = col
    return np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def write_torus_obj(path: Path, major: float, minor: float, nu: int,
                    nv: int) -> Path:
    """A closed torus about z as an OBJ: nu × nv quads, two triangles
    each."""
    u = np.arange(nu) * 2 * np.pi / nu
    v = np.arange(nv) * 2 * np.pi / nv
    U, V = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(V)
    verts = np.stack([ring * np.cos(U), ring * np.sin(U), minor * np.sin(V)],
                     -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)]) + 1
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}" for x, y, z in verts]
    lines += [f"f {p} {q} {r}" for p, q, r in faces]
    path.write_text("\n".join(lines) + "\n")
    return path


class _Instances:
    """The instances of ``cls`` made inside the ``with`` block (the
    trainers an entry point builds), in order."""

    def __init__(self, cls):
        self.cls, self.made = cls, []

    def __enter__(self):
        init = self.cls.__init__

        def recording(obj, *args, **kwargs):
            init(obj, *args, **kwargs)
            self.made.append(obj)
        self._patch = mock.patch.object(self.cls, "__init__", recording)
        self._patch.start()
        return self.made

    def __exit__(self, *exc):
        self._patch.stop()


def _engine_testbed(dev, mode: str, config: Path, scene: Path,
                    snapshot: Path = None):
    from ngp_tpu_torch.api.testbed import Testbed
    tb = Testbed(mode, device=dev)
    tb.reload_network_from_file(config)
    tb.load_training_data(scene)
    if snapshot is not None:
        tb.load_snapshot(snapshot)
    return tb


def _timed_render(tag: str, render, what: str, W: int, H: int):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _check_frame(torch.from_numpy(img), W, H)
    print(f"{tag}: {what} {W}x{H} in {ms:.1f} ms; mean rgb "
          f"{float(img[..., :3].mean()):.4f}, mean alpha "
          f"{float(img[..., 3].mean()):.4f}")
    return img


def _train_by_runner(tag: str, dev, mode: str, scene: Path, config: Path,
                     steps: int, snap: Path, trainer_cls):
    """``python -m ngp_tpu_torch.run --mode <mode>`` for ``steps`` steps
    with a snapshot, in this process; returns (its output, the trainer it
    built, ms/step with warm-up, peak device GiB)."""
    from ngp_tpu_torch import run
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Instances(trainer_cls) as made:
        out = _run_entry(run.main, [
            "--mode", mode, "--scene", str(scene), "--network", str(config),
            "--n_steps", str(steps), "--save_snapshot", str(snap),
            "--device", str(dev)])
    torch.cuda.synchronize()
    _check_iterations(out, steps)
    rate = float(re.findall(r"\(([\d.]+) steps/s\)", out)[-1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag}: runner trained {steps} steps at {1e3 / rate:.2f} ms/step "
          f"(warm-up included; the call {time.perf_counter() - t0:.2f} s); "
          f"peak device memory {peak:.2f} GiB")
    return out, made[0], 1e3 / rate, peak


def capture_image_step(tr):
    """One more training step of the image trainer ``tr`` on its next
    stratified batch, with the positions its encoding got and the
    cotangent that came back to the encoding's output: K1's and K2's
    inputs in that step."""
    seen = {}

    def hook(module, args, out):
        seen["pos"] = args[0].detach()
        out.register_hook(lambda g: seen.setdefault("cot",
                                                    g.detach().contiguous()))
    handle = tr.model.encoding.register_forward_hook(hook)
    try:
        tr.step()
    finally:
        handle.remove()
    torch.cuda.synchronize()
    return seen["pos"], seen["cot"]


def _image_kernel_inputs(dev, tr=None, seed: int = SEED + 3):
    """The 2D kernels' inputs on the image path. With the image trainer
    ``tr``: its trained table, the positions and cotangent of one more real
    step (a 2^18 stratified batch) in its int8 mode. Without one:
    configs/image/base.json's grid at IMAGE_RES, a seeded table at std
    0.5, a seeded stratified batch and cotangent. Returns (meta, table,
    positions, cotangent, what), and 2^20 uniform positions followed by
    the edge positions."""
    from ngp_tpu_torch.config import (autofill_hashgrid_config,
                                      load_network_config)
    from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
    from ngp_tpu_torch.rays.sampling import sample_positions
    g = torch.Generator(device=dev).manual_seed(seed)
    if tr is None:
        enc = autofill_hashgrid_config(
            load_network_config(ROOT / "configs/image/base.json")["encoding"],
            2, IMAGE_RES / 2.0)
        meta = BlockedGridMeta.from_hashgrid_config(enc)
        table = torch.randn((meta.n_levels, meta.rows, 128), generator=g,
                            device=dev) * 0.5
        pos = sample_positions("stratified", g, 1 << 18, 0, device=dev)
        cot = _cotangent(dev, meta, pos.shape[0], seed + 1)
        what = "seeded image-batch"
    else:
        meta = tr.model.encoding.meta
        pos, cot = capture_image_step(tr)
        table = tr.params["encoding.table"].detach()
        what = "image-step"
    print(f"2D kernels: table {tuple(table.shape)} "
          f"({table.numel() * 4 / 2 ** 20:.0f} MiB), "
          f"{sum(meta.level_is_dense)} of {meta.n_levels} levels dense; "
          f"{what} inputs")
    rng = np.random.default_rng(seed + 2)
    uni = torch.from_numpy(np.concatenate([
        rng.random((1 << 20, 2), dtype=np.float32),
        _edge_positions(meta, rng)])).to(dev)
    return meta, table, pos, cot, what, uni


def pixel_chunk(dev) -> torch.Tensor:
    """The first network call's positions of a Testbed frame of the image
    at IMAGE_RES²: a 2^18 chunk (EVAL_CHUNK) of its row-major pixel
    centres, the 2D encode forward's input on the render path."""
    from ngp_tpu_torch.train.image import EVAL_CHUNK, pixel_centres
    return pixel_centres(IMAGE_RES, IMAGE_RES, dev)[:EVAL_CHUNK]


def phase_k12_2d(dev, tr=None) -> list:
    """The 2D K1 and K2 against their plain versions, with the 3D
    tolerances, each timed beside its bound on the image path's own inputs
    (``_image_kernel_inputs``) and at 2^20 uniform positions (with the
    edge positions in the checks); K1 also on a chunk of a frame's pixel
    centres (``pixel_chunk``), under "pixel_chunk"."""
    meta, table, pos, cot, what, uni = _image_kernel_inputs(dev, tr)
    n_u = 1 << 20
    err = check_k1(table, pos, meta, what)
    k1 = time_k1(table, pos, meta, err, what)
    err = check_k1(table, uni, meta, "uniform+edge")
    _sub_entry(k1, time_k1(table, uni[:n_u], meta, err, "uniform"),
               "uniform_2e20")
    pix = pixel_chunk(dev)
    err = check_k1(table, pix, meta, "pixel-chunk")
    _sub_entry(k1, time_k1(table, pix, meta, err, "pixel-chunk"),
               "pixel_chunk")
    err = check_k2(pos, cot, meta, what)
    k2 = time_k2(pos, cot, meta, err, what)
    cot_u = _cotangent(dev, meta, uni.shape[0], SEED + 6)
    err = check_k2(uni, cot_u, meta, "uniform+edge")
    _sub_entry(k2, time_k2(uni[:n_u], cot_u[:n_u], meta, err, "uniform"),
               "uniform_2e20")
    return [k1, k2]


def phase_k345_2d(dev, tr=None, uv=None) -> list:
    """The 2D K3, K4 and K5 against their plain versions at their 3D
    counterparts' tolerances (K3 within KERNEL_POS_TOL of Σ|term| and
    bit-equal over two launches, K4 within KERNEL_TOL, K5 within
    KERNEL_I8_TOL of Σ_t scale_t·Σ|q| with equal zero patterns), each
    timed beside its bound on the image path's own inputs
    (``_image_kernel_inputs``; with ``tr`` an image trainer in the
    ``full`` int8 mode, one real step's) and on uniform positions: 2^20
    for K4, 2^18 for K3 and K5, the edge positions in the checks; K3 also
    on the uv gradient's own inputs (``uv``: the table, positions and
    cotangent its encoding got, ``uv_gradient_inputs``; without them the
    UV_RES² pixel centres and a seeded cotangent), under "uv_gradient"; K4
    also on a chunk of a frame's pixel centres (``pixel_chunk``, under
    "pixel_chunk"). K4 reads the table quantised as the int8 modes
    quantise it, K5 takes the step's tile (``eff_tile``)."""
    from ngp_tpu_torch.kernels.blocked_grid import eff_tile, quantize_table_i8
    from ngp_tpu_torch.train.image import pixel_centres
    meta, table, pos, cot, what, uni = _image_kernel_inputs(dev, tr,
                                                            SEED + 7)
    n3 = 1 << 18
    uni3 = torch.cat([uni[:n3], uni[1 << 20:]])
    cot_u = _cotangent(dev, meta, uni3.shape[0], SEED + 10)
    err = check_k3(table, pos, cot, meta, what)
    k3 = time_k3(table, pos, cot, meta, err, what)
    if uv is None:
        uv_pos = pixel_centres(UV_RES, UV_RES, dev)
        uv = (table, uv_pos,
              _cotangent(dev, meta, uv_pos.shape[0], SEED + 12))
    err = check_k3(*uv, meta, "uv-gradient")
    _sub_entry(k3, time_k3(*uv, meta, err, "uv-gradient"), "uv_gradient")
    err = check_k3(table, uni3, cot_u, meta, "uniform+edge")
    _sub_entry(k3, time_k3(table, uni3[:n3], cot_u[:n3], meta, err,
                           "uniform"), "uniform_2e18")
    with torch.no_grad():
        tq, qs = quantize_table_i8(table)
        # what the int8 modes add to every image step and network call
        quant = [_cuda_time_ms(lambda: quantize_table_i8(table), 10)
                 for _ in range(2)]
    print(f"K4: quantize_table_i8 of the {table.numel() * 4 / 2**20:.0f} MiB "
          f"f32 2D table alone: {quant[0]:.4f}/{quant[1]:.4f} ms")
    err = check_k4(tq, qs, pos, meta, what)
    k4 = time_k4(tq, qs, pos, meta, err, what)
    k4["quantize_ms"] = sum(quant) / 2
    err = check_k4(tq, qs, uni, meta, "uniform+edge")
    _sub_entry(k4, time_k4(tq, qs, uni[: 1 << 20], meta, err, "uniform"),
               "uniform_2e20")
    pix = pixel_chunk(dev)
    err = check_k4(tq, qs, pix, meta, "pixel-chunk")
    _sub_entry(k4, time_k4(tq, qs, pix, meta, err, "pixel-chunk"),
               "pixel_chunk")
    tile = eff_tile(pos.shape[0])
    err = check_k5(pos, cot, meta, tile, what)
    k5 = time_k5(pos, cot, meta, tile, err, what)
    err = check_k5(uni3, cot_u, meta, tile, "uniform+edge")
    _sub_entry(k5, time_k5(uni3[:n3], cot_u[:n3], meta, tile, err,
                           "uniform"), "uniform_2e18")
    return [k3, k4, k5]


def _cpu_copy(model, params: dict):
    """A CPU copy of ``model`` and of its parameters ``params``."""
    import copy
    return (copy.deepcopy(model).cpu(),
            {k: v.detach().cpu() for k, v in params.items()})


def phase_image(dev, steps: int = IMAGE_STEPS, res: int = IMAGE_RES,
                config=None, frames=IMAGE_FRAMES, cpu_size: int = 64):
    """The neural image on the card: the runner's ``--mode image`` on a
    seeded res² PNG, compute_image_mse's PSNR before and after (must rise
    by PSNR_RISE_DB), Testbed frames from the snapshot, the 2D K1 and K2
    launching in the phase, then held against their plain versions and
    timed (``phase_k12_2d``), and a cpu_size² frame against the CPU path.
    Returns (the phase's launch counts, the 2D kernels' entries, the run's
    ms/step and PSNR before and after, for the int8 phase to compare)."""
    import shutil

    from PIL import Image

    from ngp_tpu_torch.common import mse2psnr
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.train.image import ImageTrainer, pixel_centres
    root = ROOT / "build" / "image_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    png, snap = root / "image.png", root / "image.msgpack"
    Image.fromarray(synth_image(res)).save(png)
    config = Path(config or ROOT / "configs/image/base.json")
    print(f"image: {res}x{res} seeded image written in "
          f"{time.perf_counter() - t_phase:.2f} s")
    _reset_launches()
    tb = _engine_testbed(dev, "image", config, png)
    meta = tb.trainer.model.encoding.meta
    psnr0 = mse2psnr(tb.compute_image_mse())
    del tb
    _, tr, ms_step, _ = _train_by_runner("image", dev, "image", png, config,
                                         steps, snap, ImageTrainer)
    tb = _engine_testbed(dev, "image", config, png, snap)
    psnr1 = mse2psnr(tb.compute_image_mse())
    print(f"image: table {(meta.n_levels, meta.rows, 128)}, batch "
          f"{tr.batch_size}; compute_image_mse PSNR {psnr0:.2f} -> "
          f"{psnr1:.2f} dB (+{psnr1 - psnr0:.2f}; required "
          f"+{PSNR_RISE_DB})")
    if not psnr1 - psnr0 >= PSNR_RISE_DB:
        raise RuntimeError("the image fit did not raise the PSNR enough")
    for w, h in frames:
        _timed_render("image", lambda: tb.render(w, h), "Testbed frame", w, h)
    launches = dict(bgc.launches)
    _adam_launches("image", launches, steps)
    print(f"image: launches in the phase {launches}")
    missing = [k for k in ("blocked_grid_encode_fwd_2d",
                           "blocked_grid_encode_bwd_2d") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the image phase never launched {missing}")
    del tb
    entries = phase_k12_2d(dev, tr)
    # a small frame against the CPU path, with the same parameters
    pos = pixel_centres(cpu_size, cpu_size, dev)
    model, params = _cpu_copy(tr.model, tr.inference_params())
    with torch.no_grad():
        cpu = torch.func.functional_call(model, params, (pos.cpu(),))
    _cpu_frame_check("image", tr._predict(pos), cpu,
                     f"{cpu_size}x{cpu_size} frame")
    print(f"image: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, entries, {"ms_step": ms_step, "psnr": (psnr0, psnr1)}


def _check_int8_launches(mode: str, launches: dict, frames_k4: int):
    """The 2D kernels an image run in int8 mode ``mode`` must and must not
    launch: K4 in both (and in the Testbed frames); K2 under "fwd" and not
    K5; K5 under "full" and not K2."""
    k2, k4, k5 = (launches[f"blocked_grid_encode_{k}_2d"]
                  for k in ("bwd", "fwd_i8", "bwd_i8"))
    want = {"fwd": k4 > 0 and k2 > 0 and k5 == 0,
            "full": k4 > 0 and k5 > 0 and k2 == 0}[mode]
    if not (want and frames_k4 > 0 and launches[
            "blocked_grid_encode_fwd_2d"] == 0):
        raise RuntimeError(f"the image run under NGP_TPU_ENCODE_INT8={mode} "
                           f"launched {launches} (K4 in its frames: "
                           f"{frames_k4})")


def uv_gradient_inputs(tr, res: int = UV_RES):
    """The gradient of the trained image field ``tr`` by uv at the res²
    pixel centres (``torch.autograd.grad`` through the network's inference
    parameters in the trainer's int8 mode), and the table, positions and
    cotangent its encoding got: the 2D K3's inputs on this path."""
    from torch.func import functional_call

    from ngp_tpu_torch.train.image import pixel_centres
    params = {k: v.detach() for k, v in tr.inference_params().items()}
    seen = {}

    def hook(module, args, out):
        seen["pos"] = args[0].detach()
        out.register_hook(lambda g: seen.setdefault("cot",
                                                    g.detach().contiguous()))
    uv = pixel_centres(res, res, tr.device).requires_grad_(True)
    handle = tr.model.encoding.register_forward_hook(hook)
    try:
        out = functional_call(tr.model, params, (uv,),
                              {"int8": tr.encode_int8})
        (g,) = torch.autograd.grad(out.to(torch.float32).sum(), uv)
    finally:
        handle.remove()
    return g, (params["encoding.table"], seen["pos"], seen["cot"])


def uv_gradient_check(tr, res: int = UV_RES):
    """The uv gradient of ``tr`` (``uv_gradient_inputs``) taken twice: it
    must launch the 2D K3 and give the same bits when taken again. Returns
    the launch counts of the two gradients, and K3's inputs in the first
    (table, positions, cotangent; checked and timed by
    ``phase_k345_2d``)."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    _reset_launches()
    runs = [uv_gradient_inputs(tr, res) for _ in range(2)]
    grads = [g for g, _ in runs]
    torch.cuda.synchronize()
    launches = dict(bgc.launches)
    same = bool(torch.equal(grads[0].view(torch.int32),
                            grads[1].view(torch.int32)))
    print(f"image-int8: uv gradient of the trained field at {res}x{res} "
          f"pixel centres (mode {tr.encode_int8!r}): finite "
          f"{bool(torch.isfinite(grads[0]).all())}, mean |d/duv| "
          f"{float(grads[0].abs().mean()):.4e}; the same bits taken again: "
          f"{same}; launches {launches}")
    if not (same and bool(torch.isfinite(grads[0]).all())
            and launches["blocked_grid_encode_bwd_pos_2d"] >= 2):
        raise RuntimeError("the uv gradient did not run K3 in 2D, or "
                           "differs between two launches")
    return launches, runs[0][1]


def _cpu_frame_check(tag: str, gpu: torch.Tensor, cpu: torch.Tensor,
                     what: str):
    """A small frame on the card against the CPU path, with the slice
    phase's tolerances (ENGINE_CPU_TOL on the mean |Δ|, 2e-3 on 99.5 % of
    pixels)."""
    err = (gpu.cpu() - cpu).abs()
    within = float((err <= 2e-3).all(-1).float().mean())
    print(f"{tag}: {what} GPU vs CPU path: mean |Δ| {float(err.mean()):.3e} "
          f"(allowed {ENGINE_CPU_TOL}), {within:.4f} of pixels within 2e-3 "
          f"(required 0.995)")
    if not (float(err.mean()) <= ENGINE_CPU_TOL and within >= 0.995):
        raise RuntimeError(f"the {tag} frame on the card disagrees with the "
                           "CPU path")


def phase_image_int8(dev, f32: dict, steps: int = IMAGE_STEPS,
                     res: int = IMAGE_RES, config=None, frames=IMAGE_FRAMES,
                     cpu_size: int = 64, uv_res: int = UV_RES):
    """The image engine under NGP_TPU_ENCODE_INT8 (cell smoke-image-int8):
    on the image phase's PNG, for each of "fwd" and "full", the runner's
    ``--mode image`` for ``steps`` with a snapshot, compute_image_mse's
    PSNR of a Testbed before and from the snapshot after (must rise by
    PSNR_RISE_DB), ms/step and PSNR beside the f32 run's (``f32``, from
    ``phase_image``), Testbed frames, and the mode's launch gates
    (``_check_int8_launches``); then, on the "full" trainer, the uv
    gradient (``uv_gradient_check``), the 2D K3, K4 and K5 checked and
    timed (``phase_k345_2d``) and a cpu_size² frame against the CPU path.
    Returns (launch counts by run: "fwd", "full", "uv"; the 2D K3, K4, K5
    entries)."""
    import os

    from ngp_tpu_torch.common import mse2psnr
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.train.image import ImageTrainer, pixel_centres
    root = ROOT / "build" / "image_smoke"
    t_phase = time.perf_counter()
    png = root / "image.png"
    config = Path(config or ROOT / "configs/image/base.json")
    runs = {}
    for mode in ("fwd", "full"):
        snap = root / f"image_{mode}.msgpack"
        with mock.patch.dict(os.environ, {"NGP_TPU_ENCODE_INT8": mode}):
            _reset_launches()
            tb = _engine_testbed(dev, "image", config, png)
            psnr0 = mse2psnr(tb.compute_image_mse())
            del tb
            _, tr, ms_step, _ = _train_by_runner(
                f"image-int8 {mode}", dev, "image", png, config, steps, snap,
                ImageTrainer)
            tb = _engine_testbed(dev, "image", config, png, snap)
            psnr1 = mse2psnr(tb.compute_image_mse())
            if tb.trainer.encode_int8 != mode or tr.encode_int8 != mode:
                raise RuntimeError(f"the Testbed did not take "
                                   f"NGP_TPU_ENCODE_INT8={mode}")
            k4 = bgc.launches["blocked_grid_encode_fwd_i8_2d"]
            for w, h in frames:
                _timed_render(f"image-int8 {mode}", lambda: tb.render(w, h),
                              "Testbed frame", w, h)
            k4 = bgc.launches["blocked_grid_encode_fwd_i8_2d"] - k4
            del tb
        runs[mode] = dict(bgc.launches)
        print(f"image-int8 {mode}: compute_image_mse PSNR {psnr0:.2f} -> "
              f"{psnr1:.2f} dB (+{psnr1 - psnr0:.2f}; required "
              f"+{PSNR_RISE_DB}); f32 run {f32['psnr'][0]:.2f} -> "
              f"{f32['psnr'][1]:.2f} dB; {ms_step:.2f} ms/step (f32 run "
              f"{f32['ms_step']:.2f}); launches {runs[mode]}")
        if not psnr1 - psnr0 >= PSNR_RISE_DB:
            raise RuntimeError(f"the image fit under {mode} did not raise "
                               "the PSNR enough")
        _check_int8_launches(mode, runs[mode], k4)
    runs["uv"], uv = uv_gradient_check(tr, uv_res)
    entries = phase_k345_2d(dev, tr, uv)
    pos = pixel_centres(cpu_size, cpu_size, dev)
    model, params = _cpu_copy(tr.model, tr.inference_params())
    with torch.no_grad():
        cpu = torch.func.functional_call(model, params, (pos.cpu(),),
                                         {"int8": tr.encode_int8})
    _cpu_frame_check("image-int8", tr._predict(pos), cpu,
                     f"{cpu_size}x{cpu_size} frame ({tr.encode_int8!r})")
    print(f"image-int8: phase {time.perf_counter() - t_phase:.1f} s")
    return runs, entries


class _GroundTruthField(torch.nn.Module):
    """The ground-truth density of a volume trainer's grid as a field
    (r, g, b, density) with no emission: what VolumeRenderer marches for
    the reference frame."""

    def __init__(self, trainer):
        super().__init__()
        self.trainer = trainer

    def forward(self, x, int8: str = "", tile=None):
        d = self.trainer.gt_density(x)
        return torch.cat([torch.zeros_like(x), d[:, None]], -1)


def _density_mse(tr, pts: torch.Tensor, gt: torch.Tensor) -> float:
    return float(((tr.predict(pts)[:, 3] - gt) ** 2).mean())


def phase_volume(dev, steps: int = VOLUME_STEPS, res: int = VOLUME_RES,
                 config=None, frame: int = VOLUME_FRAME,
                 mse_samples: int = VOLUME_MSE_SAMPLES, cpu_size: int = 32):
    """The neural volume (cell smoke-volume-plume): the procedural plume
    (res³) written by the port's write_nvdb, the runner's ``--mode
    volume`` for ``steps`` with configs/volume/base.json at full width and
    the Testbed's batch (2^18) and a snapshot; the density MSE against the
    ground truth at ``mse_samples`` uniform points of the AABB, of the
    untrained network and of a Testbed from the snapshot (must fall to
    VOLUME_MSE_RATIO or less); a frame² VolumeRenderer frame, timed
    (finite, opacity in [0, 1]), and the same march over the ground-truth
    density: the IoU of their opacity > 0.5 masks must reach
    VOLUME_IOU_MIN; K1 and K2 launching in the phase; a cpu_size² frame
    against the CPU path. Returns the phase's launch counts."""
    import copy
    import shutil

    from ngp_tpu_torch.data.nanovdb import make_procedural_plume
    from ngp_tpu_torch.data.nanovdb_write import write_nvdb
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.volume_render import (VolumeRenderer,
                                                    VolumeRenderOptions)
    from ngp_tpu_torch.train.volume import VolumeTrainer
    root = ROOT / "build" / "volume_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    nvdb, snap = root / "plume.nvdb", root / "volume.msgpack"
    write_nvdb(make_procedural_plume(res, seed=SEED), nvdb)
    config = Path(config or ROOT / "configs/volume/base.json")
    print(f"volume: {res}^3 plume written as {nvdb.stat().st_size} bytes of "
          f".nvdb in {time.perf_counter() - t_phase:.2f} s")
    _reset_launches()
    tb = _engine_testbed(dev, "volume", config, nvdb)
    tr0 = tb.trainer
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    pts = tr0.aabb_min + torch.rand((mse_samples, 3), generator=g,
                                    device=dev) * (tr0.aabb_max - tr0.aabb_min)
    gt = tr0.gt_density(pts)
    mse0 = _density_mse(tr0, pts, gt)
    meta = tr0.model.encoding.meta
    del tb, tr0
    _, tr, ms_step, _ = _train_by_runner("volume", dev, "volume", nvdb,
                                         config, steps, snap, VolumeTrainer)
    tb = _engine_testbed(dev, "volume", config, nvdb, snap)
    mse1 = _density_mse(tb.trainer, pts, gt)
    print(f"volume: grid {tr.grid.dense.shape}, majorant "
          f"{tr.grid.global_majorant:.4f}; table "
          f"{(meta.n_levels, meta.rows, 128)}, batch {tr.batch_size} "
          f"({tr.batch_size // tr.N_EVENTS} walks x {tr.N_EVENTS} events); "
          f"last loss {tr.last_loss:.5f}; density MSE at {mse_samples} "
          f"uniform points {mse0:.5f} -> {mse1:.5f} (ratio "
          f"{mse1 / mse0:.4f}; required <= {VOLUME_MSE_RATIO}; mean gt^2 "
          f"{float((gt ** 2).mean()):.5f})")
    if not mse1 <= VOLUME_MSE_RATIO * mse0:
        raise RuntimeError("the volume fit did not lower the density MSE "
                           "enough")
    opts = VolumeRenderOptions(width=frame, height=frame, focal=float(frame))
    cam = orbit_camera(0.8, radius=1.8, height=0.3)
    img = _timed_render("volume", lambda: VolumeRenderer(
        tb.trainer, opts).render(cam), "VolumeRenderer frame", frame, frame)
    gt_tr = copy.copy(tb.trainer)
    gt_tr.model = _GroundTruthField(tb.trainer)
    gt_tr.inference_params = dict
    ref = _timed_render("volume", lambda: VolumeRenderer(gt_tr, opts).render(
        cam), "ground-truth march", frame, frame)
    a, b = img[..., 3] > 0.5, ref[..., 3] > 0.5
    iou = float((a & b).sum()) / max(float((a | b).sum()), 1.0)
    print(f"volume: opacity > 0.5 on {a.mean():.4f} of the network's "
          f"pixels and {b.mean():.4f} of the ground truth's; IoU {iou:.4f} "
          f"(required {VOLUME_IOU_MIN})")
    if not (iou >= VOLUME_IOU_MIN and b.mean() > 0.01):
        raise RuntimeError("the volume frame's opacity disagrees with the "
                           "ground truth's")
    launches = dict(bgc.launches)
    print(f"volume: launches in the phase {launches}")
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the volume phase never launched {missing}")
    cpu_tr = VolumeTrainer(tb.trainer.grid, tb.network_config, device="cpu")
    with torch.no_grad():
        for src, dst in ((tb.trainer.params, cpu_tr.params),
                         (tb.trainer.opt_state.ema_params,
                          cpu_tr.opt_state.ema_params)):
            for k, v in src.items():
                dst[k].copy_(v.cpu())
    small = VolumeRenderOptions(width=cpu_size, height=cpu_size,
                                focal=float(cpu_size))
    _cpu_frame_check(
        "volume", torch.from_numpy(VolumeRenderer(tb.trainer, small).render(
            cam)), torch.from_numpy(VolumeRenderer(cpu_tr, small).render(cam)),
        f"{cpu_size}x{cpu_size} frame")
    print(f"volume: {ms_step:.2f} ms/step; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_sdf(dev, steps: int = SDF_STEPS, config=None, torus=TORUS,
              frame=(FRAME_W, FRAME_H), iou_samples: int = IOU_SAMPLES,
              cpu_size=(64, 36)):
    """The SDF engine on the card: the runner's ``--mode sdf`` on a torus
    OBJ (the host BVH's seconds per batch printed), calculate_iou of a
    Testbed from the snapshot at ``iou_samples`` (≥ IOU_MIN), a frame with
    central-difference normals and shadows and one with analytic normals
    (K3 must launch in it), each frame's hit mask against the BVH's ray
    casts of the same rays (≥ HIT_AGREE_MIN), K1 and K2 launching in the
    phase, and a cpu_size frame against the CPU path. Returns (the
    phase's launch counts, K3's launches in the analytic frame)."""
    import shutil

    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.sdf_render import (SdfRenderer,
                                                 SdfRenderOptions)
    from ngp_tpu_torch.train.sdf import SdfTrainer
    root = ROOT / "build" / "sdf_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    obj, snap = root / "torus.obj", root / "sdf.msgpack"
    write_torus_obj(obj, *torus)
    config = Path(config or ROOT / "configs/sdf/base.json")
    _reset_launches()
    _, tr, _, _ = _train_by_runner("sdf", dev, "sdf", obj, config, steps,
                                   snap, SdfTrainer)
    host = np.asarray(tr.batch_seconds) * 1e3
    meta = tr.model.encoding.meta
    print(f"sdf: {len(tr.faces)} triangles; table "
          f"{(meta.n_levels, meta.rows, 128)}, batch {tr.batch_size}; host "
          f"BVH batch {host.mean():.1f} ms mean ({host.min():.1f}-"
          f"{host.max():.1f}) over {host.size} batches; last loss "
          f"{tr.last_loss:.5f}")
    tb = _engine_testbed(dev, "sdf", config, obj, snap)
    t0 = time.perf_counter()
    iou = tb.calculate_iou(iou_samples)
    print(f"sdf: calculate_iou over {iou_samples} samples {iou:.4f} in "
          f"{time.perf_counter() - t0:.2f} s (required {IOU_MIN})")
    if not iou >= IOU_MIN:
        raise RuntimeError("the SDF fit's IoU is too low")
    W, H = frame
    cam = orbit_camera(0.6, radius=1.3, height=0.9)
    tb.set_camera_matrix(cam)
    shaded = _timed_render("sdf", lambda: tb.render(W, H),
                           "central-difference normals, shadows", W, H)
    k3 = bgc.launches["blocked_grid_encode_bwd_pos"]
    tb.sdf.analytic_normals = True
    analytic = _timed_render("sdf", lambda: tb.render(W, H),
                             "analytic normals, shadows", W, H)
    k3 = bgc.launches["blocked_grid_encode_bwd_pos"] - k3
    launches = dict(bgc.launches)
    print(f"sdf: launches in the phase {launches}; K3 in the analytic "
          f"frame {k3}")
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd") if launches[k] <= 0]
    if missing or k3 <= 0:
        raise RuntimeError(f"the sdf phase never launched {missing or 'K3'}")
    o, d = SdfRenderer(tb.trainer.model, SdfRenderOptions(
        focal=float(H))).camera_rays(cam, W, H)
    bvh_hit = (tb.trainer.bvh.raytrace(o, d)[1] >= 0).reshape(H, W)
    for what, img in (("central-difference", shaded),
                      ("analytic", analytic)):
        agree = float(((img[..., 3] > 0) == bvh_hit).mean())
        print(f"sdf: {what} frame's hit mask vs the BVH's ray casts: "
              f"{agree:.4f} of pixels agree ({float(bvh_hit.mean()):.4f} "
              f"hit; required {HIT_AGREE_MIN})")
        if not agree >= HIT_AGREE_MIN:
            raise RuntimeError("the SDF frame's hits disagree with the mesh")
    opts = SdfRenderOptions(width=cpu_size[0], height=cpu_size[1],
                            focal=float(cpu_size[1]))
    gpu = SdfRenderer(tb.trainer.model, opts).render(
        tb.trainer.inference_params(), cam)
    model, params = _cpu_copy(tb.trainer.model, tb.trainer.inference_params())
    cpu = SdfRenderer(model, opts).render(params, cam)
    same = float(((gpu[..., 3] > 0) == (cpu[..., 3] > 0)).mean())
    err = float(np.abs(gpu - cpu).mean())
    print(f"sdf: {cpu_size[0]}x{cpu_size[1]} frame GPU vs CPU path: mean "
          f"|Δ| {err:.3e} (allowed {SDF_CPU_TOL}), hit masks {same:.4f} "
          f"equal (required 0.99)")
    if not (err <= SDF_CPU_TOL and same >= 0.99):
        raise RuntimeError("the SDF frame on the card disagrees with the CPU "
                           "path")
    print(f"sdf: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, k3


# the mesh phase (cell smoke-mesh): the testbed phase's trained spheres
# meshed at MESH_RES³ by the runner's --save_mesh and by the Testbed (with
# vertex colours, as .ply), the median distance of the Testbed mesh's
# vertices to the spheres' surfaces at most MESH_SPHERE_VOXELS voxel
# widths; the sdf phase's torus meshed by marching tetrahedra at MESH_RES³,
# its vertices' mean |torus distance| at most TORUS_MESH_VOXELS voxel
# widths and every edge in exactly two faces; MESH_SLICES PNG slices
MESH_RES, MESH_SLICES, MESH_CPU_RES = 256, 64, 64
MESH_SPHERE_VOXELS, TORUS_MESH_VOXELS = 3.0, 1.0
# The card's σ field against the CPU path's, both from the snapshot's
# weights: the MLP rounds each layer's input to bf16 and the two devices
# sum a layer's f32 products in other orders, so a hidden value within an
# f32 ulp of a bf16 rounding boundary rounds one bf16 ulp (2^-8 relative)
# apart on the two. One such flip moves the raw density by about that
# relative amount of one layer's term, so σ = exp(raw) by up to ~2^-8
# relative at that point and nowhere else; which points flip depends on
# the trained field, a different one each run. The gate therefore holds
# the mean (ENGINE_CPU_TOL, relative to max(σ, 1)) and the share of points
# within FIELD_POINT_TOL (≥ FIELD_POINT_SHARE), and prints the maximum
# without gating on it.
FIELD_POINT_TOL, FIELD_POINT_SHARE = 2e-3, 0.995
# the takikawa phase (cell smoke-takikawa-torus): configs/sdf/takikawa.json
# at full width on the sdf phase's torus, TAK_BATCHES batches of 2^18 from
# the trainer's own sampler pinned with override_sdf_training_data, then
# TAK_STEPS steps; IoU at IOU_SAMPLES ≥ IOU_MIN (octree rule), an
# analytic-normals frame's hit mask ≥ HIT_AGREE_MIN against the BVH
TAK_BATCHES, TAK_STEPS = 8, 256
# the playback phase (cell smoke-playback-spheres): the testbed phase's
# snapshot baked at PLAYBACK_D (PLAYBACK_D_INNER for cascade 0); the
# held-out PSNR of playback frames within PLAYBACK_PSNR_DB of the live
# renderer's; an orbit over the three axes leaves the renderer holding the
# two latest orientations of each cascade; the runner's --video_playback
# writes VIDEO_FPS · VIDEO_SECONDS frames
PLAYBACK_D, PLAYBACK_D_INNER, PLAYBACK_PSNR_DB = 256, 512, 3.0
VIDEO_FPS, VIDEO_SECONDS = 10, 2
PLAYBACK_FRAMES = ((FRAME_W, FRAME_H), (1920, 1080))


def _gate(tag: str, what: str, value, limit, ok: bool, share: float,
          fmt: str = ".4g"):
    """Print a gate's value beside its limit and the share of the limit it
    used (for a minimum, the shortfall's share of the allowed
    shortfall); raise unless ``ok``."""
    print(f"{tag}: gate {what}: {value:{fmt}} (limit {limit}; "
          f"{share:.3f} of the limit)")
    if not ok:
        raise RuntimeError(f"{tag}: {what} {value} is outside its limit "
                           f"{limit}")


def _gate_max(tag, what, value, limit):
    _gate(tag, what, value, f"<= {limit}", value <= limit, value / limit)


def _gate_min(tag, what, value, limit, top: float = 1.0):
    """A gate ``value >= limit`` on a quantity whose best is ``top``."""
    _gate(tag, what, value, f">= {limit}", value >= limit,
          (top - value) / (top - limit))


def _sphere_distance(v: np.ndarray) -> np.ndarray:
    """|distance| of world positions (V, 3) to the nearest sphere surface
    of SPHERES."""
    d = [np.abs(np.linalg.norm(v - np.asarray(c), axis=-1) - r)
         for c, r, _, _ in SPHERES]
    return np.min(np.stack(d), 0)


def _torus_distance(v: np.ndarray, major: float, minor: float):
    """|distance| of positions (V, 3) in the OBJ's own units to the torus
    about z (write_torus_obj)."""
    ring = np.hypot(v[:, 0], v[:, 1]) - major
    return np.abs(np.hypot(ring, v[:, 2]) - minor)


def _edges_not_in_two_faces(verts: np.ndarray, faces: np.ndarray):
    """(interior, boundary): the mesh's edges that lie in other than two
    faces, split by whether both ends lie on the lattice's outer faces
    (vertex coordinates 0 or 1), where a surface leaving the lattice is
    open by construction."""
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]]), 1)
    edges, counts = np.unique(e, axis=0, return_counts=True)
    bad = edges[counts != 2]
    on_side = ((verts <= 1e-6) | (verts >= 1 - 1e-6)).any(-1)
    side = on_side[bad[:, 0]] & on_side[bad[:, 1]]
    return int((~side).sum()), int(side.sum())


def _nerf_testbed(dev, root: Path, config: Path, snap: Path):
    """A Testbed on the testbed phase's sphere scene from its snapshot."""
    from ngp_tpu_torch.api.testbed import Testbed
    tb = Testbed(device=dev)
    tb.reload_network_from_file(config)
    tb.load_training_data(root / "transforms.json")
    tb.load_snapshot(snap)
    return tb


def phase_mesh(dev, res: int = MESH_RES, config=None, sdf_config=None,
               torus=TORUS, cpu_res: int = MESH_CPU_RES,
               slices: int = MESH_SLICES):
    """Mesh export on the card (cell smoke-mesh), after the testbed and
    sdf phases: the runner's --save_mesh of the spheres' snapshot, the
    Testbed's NeRF mesh with vertex colours (.ply) and its field's device
    and host times, the σ field on the card against the CPU path at
    cpu_res³, the SDF's marching-tetrahedra mesh of the torus, the PNG
    slices. Returns (the phase's launch counts, K1's entry on the field's
    own inputs)."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.mesh_export import grid_positions
    t_phase = time.perf_counter()
    nerf_root = ROOT / "build" / "testbed_smoke"
    sdf_root = ROOT / "build" / "sdf_smoke"
    root = ROOT / "build" / "mesh_smoke"
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = Path(config or ROOT / "configs/nerf/base.json")
    snap = nerf_root / "snapshot.msgpack"
    _reset_launches()
    t0 = time.perf_counter()
    out = _run_entry(run.main, [
        "--scene", str(nerf_root / "transforms.json"), "--network",
        str(config), "--load_snapshot", str(snap), "--device", str(dev),
        "--save_mesh", str(root / "spheres.obj"), "--marching_cubes_res",
        str(res)])
    line = re.findall(r"^saved mesh .*$", out, re.M)
    print(f"mesh: runner --save_mesh spheres.obj at {res}^3 in "
          f"{time.perf_counter() - t0:.2f} s: {line[0] if line else out}")
    if not line or not (root / "spheres.obj").exists():
        raise RuntimeError("the runner wrote no mesh")
    tb = _nerf_testbed(dev, nerf_root, config, snap)
    tr = tb.trainer
    # the field alone: σ in the occupied cells on the res³ voxel centres,
    # device time by CUDA events; then marching cubes on the host
    pts = grid_positions(res, float(tr.aabb_min), float(tr.aabb_size), dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    sigma = torch.cat([tr.sigma_at(c, occupied_only=True)
                       for c in pts.split(1 << 18)])
    end.record()
    torch.cuda.synchronize()
    field_ms = start.elapsed_time(end)
    from ngp_tpu_torch.render.mesh_export import marching_cubes
    t0 = time.perf_counter()
    field = sigma.cpu().numpy().reshape(res, res, res)
    v, f = marching_cubes(-field, -2.5)
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"mesh: σ in the occupied cells on {res}^3 voxel centres, "
          f"{len(pts.split(1 << 18))} chunks of 2^18: {field_ms:.1f} ms on "
          f"the "
          f"device (CUDA events); copy and marching cubes {host_ms:.1f} ms "
          f"on the host: {len(v)} vertices, {len(f)} faces")
    t0 = time.perf_counter()
    m = tb.compute_marching_cubes_mesh(res)
    tb.compute_and_save_marching_cubes_mesh(root / "spheres.ply", res)
    print(f"mesh: Testbed mesh with vertex colours at {res}^3 (computed, "
          f"then saved as .ply) in {time.perf_counter() - t0:.2f} s: "
          f"{len(m['V'])} vertices, {len(m['F'])} faces, mean colour "
          f"{m['C'].mean(0).round(4).tolist()}")
    if len(m["V"]) == 0:
        raise RuntimeError("the NeRF mesh is empty")
    voxel = float(tr.aabb_size) / res
    dist = _sphere_distance(m["V"]) / voxel
    print(f"mesh: NeRF mesh vertices' |sphere distance| median "
          f"{np.median(dist):.3f}, mean {dist.mean():.3f}, max "
          f"{dist.max():.3f} voxel widths ({voxel:.5f})")
    _gate_max("mesh", "NeRF mesh median |sphere distance| (voxel widths)",
              float(np.median(dist)), MESH_SPHERE_VOXELS)
    # the SDF: marching tetrahedra of the sdf phase's torus snapshot
    tb_sdf = _engine_testbed(
        dev, "sdf", Path(sdf_config or ROOT / "configs/sdf/base.json"),
        sdf_root / "torus.obj", sdf_root / "sdf.msgpack")
    t0 = time.perf_counter()
    ms = tb_sdf.compute_marching_cubes_mesh(res)
    st = tb_sdf.trainer
    q = ms["V"] * st.mesh_scale + st.mesh_offset
    tdist = _torus_distance(q, torus[0], torus[1]) / (st.mesh_scale / res)
    bad, side = _edges_not_in_two_faces(ms["V"], ms["F"])
    print(f"mesh: SDF marching tetrahedra at {res}^3 in "
          f"{time.perf_counter() - t0:.2f} s: {len(ms['V'])} vertices, "
          f"{len(ms['F'])} faces; |torus distance| mean {tdist.mean():.3f}, "
          f"max {tdist.max():.3f} voxel widths; edges in other than two "
          f"faces on the lattice's sides {side}")
    _gate_max("mesh", "SDF mesh mean |torus distance| (voxel widths)",
              float(tdist.mean()), TORUS_MESH_VOXELS)
    _gate("mesh", "SDF mesh interior edges not in exactly two faces", bad,
          "== 0",
          bad == 0, 0.0 if bad == 0 else float("inf"), "d")
    tb.compute_and_save_png_slices(str(root / "slices"), slices)
    n_png = len(list(root.glob("slices_*.png")))
    _gate("mesh", "PNG density slices written", n_png, f"== {slices}",
          n_png == slices, 0.0 if n_png == slices else float("inf"), "d")
    launches = dict(bgc.launches)
    print(f"mesh: launches in the phase {launches}")
    if launches["blocked_grid_encode_fwd"] <= 0:
        raise RuntimeError("the mesh phase never launched K1")
    # the σ field on the card against the CPU path, the same weights
    model, params = _cpu_copy(tr.model, tr.inference_params())
    from torch.func import functional_call
    small = grid_positions(cpu_res, float(tr.aabb_min), float(tr.aabb_size),
                           dev)
    gpu = torch.cat([tr.sigma_at(c) for c in small.split(1 << 18)]).cpu()
    with torch.no_grad():
        raw = functional_call(model, params, (
            (small.cpu() - tr.aabb_min) / tr.aabb_size,))[..., 0]
    cpu = torch.exp(torch.clamp(raw, -15.0, 15.0))
    rel = (gpu - cpu).abs() / torch.clamp(cpu.abs(), min=1.0)
    within = float((rel <= FIELD_POINT_TOL).float().mean())
    print(f"mesh: {cpu_res}^3 σ field GPU vs CPU path: |Δ| relative to "
          f"max(σ, 1) mean {float(rel.mean()):.3e}, max {float(rel.max()):.3e}"
          f" (not gated), {within:.6f} of points within {FIELD_POINT_TOL}")
    _gate_max("mesh", "σ field GPU vs CPU mean relative |Δ|",
              float(rel.mean()), ENGINE_CPU_TOL)
    _gate_min("mesh", f"σ field share of points within {FIELD_POINT_TOL}",
              within, FIELD_POINT_SHARE)
    # K1 on the field's own inputs: the lattice's middle chunk of 2^18
    # (x at the AABB's centre), warped, with the snapshot's table
    mid = (pts.shape[0] >> 19) << 18
    warped = ((pts[mid:mid + (1 << 18)] - tr.aabb_min)
              / tr.aabb_size).contiguous()
    table = tr.inference_params()["pos_encoding.table"].detach()
    meta = tr.model.pos_encoding.meta
    err = check_k1(table, warped, meta, "mesh-field")
    entry = time_k1(table, warped, meta, err, "mesh-field")
    print(f"mesh: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, entry


def capture_sdf_step(tr, pos, dist):
    """One training step of the SDF trainer ``tr`` (no update) on the
    batch (pos, dist), with the arguments of its K2 call: K2's positions,
    the cotangent that came back to the encoding and the grid."""
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    seen = []
    launch_bwd = bgc.launch_bwd

    def spy(*args):
        seen.append(args)
        return launch_bwd(*args)
    with mock.patch.object(bgc, "launch_bwd", spy):
        tr._step_grads(pos, dist)
    if len(seen) != 1:
        raise RuntimeError(f"an SDF step made {len(seen)} K2 calls, not 1")
    return seen[0]


def phase_takikawa(dev, config=None, steps: int = TAK_STEPS,
                   n_batches: int = TAK_BATCHES, frame=(FRAME_W, FRAME_H),
                   iou_samples: int = IOU_SAMPLES):
    """The Takikawa octree encoding on the card (cell
    smoke-takikawa-torus), on the sdf phase's torus: a Testbed with
    configs/sdf/takikawa.json at full width (octree depths 4..10: 7 levels,
    level groups of width 1), n_batches batches drawn by the trainer's own
    sampler and pinned with override_sdf_training_data, ``steps`` steps,
    the IoU by the octree rule, an analytic-normals frame (K3) against the
    BVH's ray casts. Returns (the phase's launch counts, the K1/K2/K3
    kernel entries at L = 7 on the path's own inputs)."""
    from ngp_tpu_torch.api.testbed import Testbed
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.sdf_render import (SdfRenderer,
                                                 SdfRenderOptions)
    t_phase = time.perf_counter()
    obj = ROOT / "build" / "sdf_smoke" / "torus.obj"
    config = Path(config or ROOT / "configs/sdf/takikawa.json")
    _reset_launches()
    t0 = time.perf_counter()
    tb = Testbed("sdf", device=dev)
    tb.reload_network_from_file(config)
    tb.load_training_data(obj)
    tr = tb.trainer
    enc = tr.tak_encoding
    meta = enc.grid_meta
    width = bgc.kernel_plan("blocked_grid_encode_fwd", 1 << 18, meta).width
    print(f"takikawa: trainer built in {time.perf_counter() - t0:.2f} s: "
          f"octree depths {enc.meta.start_depth}..{enc.meta.max_depth}, "
          f"table {(meta.n_levels, meta.rows, 128)}, level groups of "
          f"{width} (K1), {len(tr._octree_leaves)} octree leaves at depth "
          f"{tr.octree_depth}, perturbation scale {tr.perturb_sigma:.5f}")
    t0 = time.perf_counter()
    batches = [tr.generate_training_batch() for _ in range(n_batches)]
    print(f"takikawa: {n_batches} batches of {tr.batch_size} drawn with the "
          f"trainer's sampler; host BVH {time.perf_counter() - t0:.2f} s")
    tb.override_sdf_training_data(np.concatenate([b[0] for b in batches]),
                                  np.concatenate([b[1] for b in batches]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tb.train(steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"takikawa: {steps} steps on the pinned batches at {ms:.2f} "
          f"ms/step; loss {loss:.5f}")
    if not math.isfinite(loss):
        raise RuntimeError("the Takikawa training loss is not finite")
    t0 = time.perf_counter()
    iou = tb.calculate_iou(iou_samples)
    print(f"takikawa: calculate_iou over {iou_samples} samples (outside the "
          f"octree counts as agreeing) {iou:.4f} in "
          f"{time.perf_counter() - t0:.2f} s")
    _gate_min("takikawa", "IoU", iou, IOU_MIN)
    W, H = frame
    cam = orbit_camera(0.6, radius=1.3, height=0.9)
    tb.set_camera_matrix(cam)
    tb.sdf.analytic_normals = True
    captured = []
    launch_bwd_pos = bgc.launch_bwd_pos

    def recording(table, pos, grad, meta_):
        # the frame's largest K3 call (a chunk without hits makes none)
        if pos.shape[0] > (captured[0][1].shape[0] if captured else 0):
            captured[:] = [(table.clone(), pos.clone(), grad.clone())]
        return launch_bwd_pos(table, pos, grad, meta_)
    k3 = bgc.launches["blocked_grid_encode_bwd_pos"]
    with mock.patch.object(bgc, "launch_bwd_pos", recording):
        img = _timed_render("takikawa", lambda: tb.render(W, H),
                            "analytic normals, shadows", W, H)
    k3 = bgc.launches["blocked_grid_encode_bwd_pos"] - k3
    launches = dict(bgc.launches)
    print(f"takikawa: launches in the phase {launches}; K3 in the analytic "
          f"frame {k3}")
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd") if launches[k] <= 0]
    if missing or k3 <= 0 or not captured:
        raise RuntimeError(f"the takikawa phase never launched "
                           f"{missing or 'K3'}")
    o, d = SdfRenderer(tr.model, SdfRenderOptions(
        focal=float(H))).camera_rays(cam, W, H)
    bvh_hit = (tr.bvh.raytrace(o, d)[1] >= 0).reshape(H, W)
    agree = float(((img[..., 3] > 0) == bvh_hit).mean())
    print(f"takikawa: analytic frame's hit mask vs the BVH's ray casts: "
          f"{agree:.4f} of pixels agree ({float(bvh_hit.mean()):.4f} hit)")
    _gate_min("takikawa", "analytic frame's hit agreement with the BVH",
              agree, HIT_AGREE_MIN)
    # K1, K2 and K3 at L = 7 on the path's own inputs: a pinned batch with
    # the trained table and that step's cotangent; the frame's K3 call
    pos = torch.as_tensor(batches[0][0], device=dev).contiguous()
    dist = torch.as_tensor(batches[0][1], device=dev)
    table = enc.table.detach().contiguous()
    err = check_k1(table, pos, meta, "takikawa-step")
    entries = [time_k1(table, pos, meta, err, "takikawa-step")]
    p2, cot, meta2 = capture_sdf_step(tr, pos, dist)
    err = check_k2(p2, cot, meta2, "takikawa-step")
    entries.append(time_k2(p2, cot, meta2, err, "takikawa-step"))
    t3, p3, g3 = captured[0]
    err = check_k3(t3, p3, g3, meta, "takikawa-frame")
    entries.append(time_k3(t3, p3, g3, meta, err, "takikawa-frame"))
    print(f"takikawa: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, entries


def _orientation_orbit(tb, size=(320, 180)):
    """Frames looking along ±x, ±y, ±z in turn; after each, every
    cascade's held orientations must be the latest two seen. Returns the
    counts held after each frame."""
    W, H = size
    seen, counts, latest = [], [], True
    for axis in range(3):
        for sign in (1.0, -1.0):
            fwd = np.full(3, 0.1)
            fwd[axis] = sign
            fwd /= np.linalg.norm(fwd)
            up = np.array([0.0, 0.0, 1.0]) if axis != 2 else \
                np.array([0.0, 1.0, 0.0])
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            tb.camera_matrix = np.stack(
                [right, np.cross(fwd, right), fwd, 0.5 - 1.3 * fwd],
                1).astype(np.float32)
            tb.render_playback(W, H)
            r = next(r for k, r in tb._playback_renderers.items()
                     if k[:2] == (W, H))
            seen.append((axis, bool(sign < 0)))
            held = [r.orientations(c) for c in range(len(r.cache.vols))]
            counts.append(max(len(h) for h in held))
            latest &= all(h == seen[-2:] for h in held)
    return counts, latest


def phase_playback(dev, config=None, frames=PLAYBACK_FRAMES,
                   D=PLAYBACK_D, D_inner=PLAYBACK_D_INNER,
                   video=(VIDEO_FPS, VIDEO_SECONDS)):
    """Frozen-model playback on the card (cell smoke-playback-spheres),
    from the testbed phase's snapshot: bake_playback() at D and D_inner
    (K1 on the occupied voxels), the held-out PSNR of playback frames
    against the live renderer's by the runner's protocol, frames at each
    of ``frames`` (twice, timed), the orientations held over an orbit, and
    the runner's --video_playback. Returns (the phase's launch counts,
    K1's entry on the bake's first batch)."""
    from ngp_tpu_torch import run
    from ngp_tpu_torch.common import linear_to_srgb_np, mse2psnr
    from ngp_tpu_torch.data.image_io import load_stbi
    from ngp_tpu_torch.grid.occupancy import GRID_VOLUME
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.render.playback import (_cascade_lattice,
                                               occupied_voxels)
    t_phase = time.perf_counter()
    nerf_root = ROOT / "build" / "testbed_smoke"
    root = ROOT / "build" / "playback_smoke"
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = Path(config or ROOT / "configs/nerf/base.json")
    snap = nerf_root / "snapshot.msgpack"
    tb = _nerf_testbed(dev, nerf_root, config, snap)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.bake_playback(D, D_inner, path=str(root / "playback.npz"))
    torch.cuda.synchronize()
    cache = tb._playback_cache
    occupied = [round(float((v[..., -1] > 0).float().mean()), 4)
                for v in cache.vols]
    print(f"playback: bake_playback() (sides "
          f"{[int(v.shape[0]) for v in cache.vols]}) in "
          f"{time.perf_counter() - t0:.2f} s with the file; "
          f"{bgc.launches['blocked_grid_encode_fwd']} K1 launches; occupied "
          f"voxels per cascade {occupied}")
    # the held-out views by the runner's protocol: black background, pixel
    # centres, linear render → sRGB against the PNG
    tb.background_color = np.array([0, 0, 0, 1], np.float32)
    tb.snap_to_pixel_centers = True
    test = json.loads((nerf_root / "transforms_test.json").read_text())
    psnr = {"playback": [], "live": []}
    for frame in test["frames"]:
        gt = load_stbi(nerf_root / frame["file_path"])
        H, W = gt.shape[:2]
        tb._view_focal = np.array([test["fl_x"], test["fl_y"]], np.float32)
        tb.set_nerf_camera_matrix(
            np.asarray(frame["transform_matrix"], np.float32)[:3])
        for way, render in (("playback", tb.render_playback),
                            ("live", tb.render)):
            img = render(W, H)
            pred = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
            want = linear_to_srgb_np(np.clip(gt[..., :3], 0, 1))
            psnr[way].append(mse2psnr(float(np.mean((pred - want) ** 2))))
    pb, live = float(np.mean(psnr["playback"])), float(np.mean(psnr["live"]))
    print(f"playback: held-out PSNR over {len(test['frames'])} views: "
          f"playback {pb:.2f} dB, live renderer {live:.2f} dB")
    # signed: below 0 where playback beats the live renderer
    _gate_max("playback", "held-out PSNR below the live renderer's (dB)",
              live - pb, PLAYBACK_PSNR_DB)
    tb._view_focal = np.array(FOCAL, np.float32)
    tb.camera_matrix = orbit_camera(0.5)
    for W, H in frames:
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = tb.render_playback(W, H)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            _check_frame(torch.from_numpy(img), W, H)
        print(f"playback: {W}x{H} frame {times[0]:.1f} ms, then "
              f"{times[1]:.1f} ms; mean alpha {float(img[..., 3].mean()):.4f}")
    counts, latest = _orientation_orbit(tb)
    print(f"playback: an orbit along ±x, ±y, ±z: orientations held per "
          f"cascade after each frame {counts}")
    _gate("playback", "orbit leaves each cascade holding the latest two "
          "orientations", latest, "== True", latest, 0.0 if latest else
          float("inf"), "")
    fps, seconds = video
    t0 = time.perf_counter()
    out = _run_entry(run.main, [
        "--scene", str(nerf_root / "transforms.json"), "--network",
        str(config), "--load_snapshot", str(snap), "--device", str(dev),
        "--video_camera_path", str(nerf_root / "camera_path.json"),
        "--video_fps", str(fps), "--video_n_seconds", str(seconds),
        "--video_playback", "--video_output", str(root / "video.mp4"),
        "--width", str(FRAME_W), "--height", str(FRAME_H)])
    n_jpg = len(list((root / "tmp_video_frames").glob("*.jpg")))
    print(f"playback: runner --video_playback, {seconds} s at {fps} fps, in "
          f"{time.perf_counter() - t0:.2f} s: {n_jpg} frames written"
          + (f"; {out.strip().splitlines()[-1]}" if out.strip() else ""))
    _gate("playback", "video frames written", n_jpg, f"== {fps * seconds}",
          n_jpg == fps * seconds, 0.0 if n_jpg == fps * seconds
          else float("inf"), "d")
    launches = dict(bgc.launches)
    print(f"playback: launches in the phase {launches}")
    if launches["blocked_grid_encode_fwd"] <= 0:
        raise RuntimeError("the playback phase never launched K1")
    # K1 on the bake's first batch: cascade 0's first 2^17 occupied voxels
    tr = tb.trainer
    Dc = int(cache.vols[0].shape[0])
    idx = torch.as_tensor(occupied_voxels(
        tr.grid.bitfield[:GRID_VOLUME // 8].cpu().numpy(), Dc)[:1 << 17],
        device=dev)
    ax = torch.as_tensor(_cascade_lattice(Dc, 1.0), device=dev)
    pos = torch.stack([ax[idx % Dc], ax[(idx // Dc) % Dc],
                       ax[idx // (Dc * Dc)]], -1)
    pos = ((pos - tr.aabb_min) / tr.aabb_size).contiguous()
    table = tr.inference_params()["pos_encoding.table"].detach().contiguous()
    meta = tr.model.pos_encoding.meta
    err = check_k1(table, pos, meta, "playback-bake")
    entry = time_k1(table, pos, meta, err, "playback-bake")
    print(f"playback: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, entry


# the captures phase (cell smoke-captures-spheres): the spheres captured
# through an F-theta lens, CAPTURE_VIEWS training views at CAPTURE_RES²
# (the native frame) and CAPTURE_HELD_OUT held out, with depth PNGs under
# integer_depth_scale DEPTH_SCALE, alpha sidecars on the even views and a
# dynamic mask over MASK_BOX (a fraction of the frame, rows and columns) of
# view 0; the runner trains CAPTURE_STEPS with depth supervision of weight
# CAPTURE_DEPTH_LAMBDA under the int8 grid sweep
CAPTURE_VIEWS, CAPTURE_HELD_OUT, CAPTURE_RES = 24, 4, 256
CAPTURE_STEPS, CAPTURE_DEPTH_LAMBDA = 512, 0.1
# θ(r) = p0 + p1·r + … + p4·r⁴ of the radius r in native pixels of a
# CAPTURE_RES² frame: ~49° at its corners (ftheta_params scales it to
# other native sizes, keeping the field of view)
FTHETA_P = (0.0, 1.0 / 220.0, 0.0, 5e-9, 0.0)
DEPTH_SCALE = 1e-4
MASK_BOX = (0.25, 0.75)
# the renderer's new options on the snapshot: a LatLong panorama at PANO
# and an F-theta frame at FRAME_W × FRAME_H against the analytic spheres
# on the same rays (PSNR ≥ LENS_PSNR_DB); each panel of a 2×1 stereo quilt
# (IPD QUILT_IPD) against its frame rendered alone (mean |Δ| ≤ QUILT_TOL);
# the pixels an envmap scene leaves transparent against the envmap's
# sample (mean |Δ| ≤ ENVMAP_TOL)
PANO = (1024, 512)
LENS_PSNR_DB, QUILT_IPD, QUILT_TOL, ENVMAP_TOL = 20.0, 0.064, 1e-4, 1e-3
# DEPTH frame of view 0 against the analytic depth over the pixels that hit
# a sphere, mean |Δ| in scene units: a CPU rehearsal of this phase at full
# width (base.json; 8 views at 64², 150 runner steps) read
# CAPTURE_DEPTH_CPU; the limit is about twice it
CAPTURE_DEPTH_CPU = 0.0221
DEPTH_TOL = 0.045
# rolling shutter: each view's end camera turned RS_ROT_DEG about the
# vertical through the centre and moved RS_TRANS; views motion-blurred over
# 4 shutter times; RS_STEPS steps at CAPTURE_SMALL_RES, rendered at RS_SPP
# shutter times per pixel. A tcnn-layout model and a blocked one train
# TCNN_STEPS on the spheres at CAPTURE_SMALL_RES. Sidecar rays equal the
# camera's to RAYS_REL_TOL of the largest component.
CAPTURE_SMALL_RES, RS_STEPS, TCNN_STEPS = 128, 256, 256
RS_ROT_DEG, RS_TRANS, RS_SPP = 1.0, 0.01, 4
RS_PSNR_RISE_DB, TCNN_PSNR_RISE_DB, RAYS_REL_TOL = 5.0, 5.0, 1e-6
# the int8 renderer's frame against the f32 frame, PSNR in sRGB: the same
# CPU rehearsal read CAPTURE_INT8_CPU dB after 150 steps; a table trained
# longer spreads its values further from their level's maximum, which sets
# the quantisation step, so the limit is set far below that reading
CAPTURE_INT8_CPU = 80.2
INT8_FRAME_PSNR_DB = 30.0


def _gate_at_least(tag: str, what: str, value: float, limit: float):
    """A gate ``value >= limit`` on a quantity with no best value (a PSNR
    or its rise); the share is limit / value."""
    _gate(tag, what, value, f">= {limit}", value >= limit,
          limit / value if value > 0 else float("inf"))


def _srgb_psnr(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """PSNR in sRGB of two linear rgb tensors, each clamped to [0, 1]."""
    from ngp_tpu_torch.common import linear_to_srgb, mse2psnr
    a = linear_to_srgb(torch.clamp(pred.reshape(-1, 3), 0.0, 1.0))
    b = linear_to_srgb(torch.clamp(gt.reshape(-1, 3), 0.0, 1.0))
    return mse2psnr(float(torch.mean((a - b) ** 2)))


def ftheta_params(res: int) -> tuple:
    """FTHETA_P for a native frame of res² pixels: the same θ at the same
    fraction of the frame."""
    k = CAPTURE_RES / res
    return tuple(p * k ** i for i, p in enumerate(FTHETA_P))


def _pixel_rays(dev, xf: np.ndarray, res: int, lens_mode: str,
                lens7: tuple, focal: float = 1.0):
    """World rays (o, unnormalised d) of a res² view's pixel centres by the
    trainer's ``pixel_to_ray_train`` (centred principal point)."""
    from ngp_tpu_torch.rays.camera import pixel_to_ray_train
    size = torch.tensor([float(res), float(res)], device=dev)
    y, x = torch.meshgrid(torch.arange(res, device=dev, dtype=torch.float32),
                          torch.arange(res, device=dev, dtype=torch.float32),
                          indexing="ij")
    xy = (torch.stack([x, y], -1).reshape(-1, 2) + 0.5) / size
    n = xy.shape[0]

    def rows(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(
            n, *np.shape(v))
    return pixel_to_ray_train(xy, rows(xf), rows([focal, focal]),
                              rows([0.5, 0.5]), size.expand(n, 2),
                              rows(lens7), False, lens_mode=lens_mode)


def write_ftheta_capture(dev, root: Path, n_train: int, n_test: int,
                         res: int):
    """The spheres through the F-theta lens on disk as a capture brings
    them: ``transforms.json`` over ``train/r_*.png`` with ``ftheta_p*`` and
    the native ``w``/``h``, a 16-bit depth PNG per view (the expected depth
    along each pixel's ray, 0 where it misses the spheres) under
    ``integer_depth_scale``, an alpha sidecar on each even view, a dynamic
    mask over MASK_BOX of view 0; ``transforms_test.json`` over held-out
    views. Returns (the two JSON paths, view 0's analytic depth and alpha,
    flat)."""
    from PIL import Image

    from ngp_tpu_torch.common import linear_to_srgb
    lens7 = ftheta_params(res) + (float(res), float(res))
    root.mkdir(parents=True)
    paths, view0 = [], None
    for split, xfs in (("train", _orbit_xforms(n_train)),
                       ("test", _orbit_xforms(n_test, seed=1, phase=0.3))):
        (root / split).mkdir()
        files = [f"{split}/r_{i:03d}.png" for i in range(len(xfs))]
        cfg = _nerf_transforms(xfs, res, files)
        cfg.update({f"ftheta_p{k}": v
                    for k, v in enumerate(ftheta_params(res))})
        cfg["integer_depth_scale"] = DEPTH_SCALE
        rays = [_pixel_rays(dev, xf, res, "ftheta", lens7) for xf in xfs]
        d = torch.cat([d for _, d in rays])
        views = zip(*(p.split(res * res) for p in _render_batched(
            torch.cat([o for o, _ in rays]),
            d / torch.linalg.vector_norm(d, dim=-1, keepdim=True),
            with_depth=True)))
        for i, (name, (rgb, a, depth)) in enumerate(zip(files, views)):
            Image.fromarray(_to_u8(rgb, a, res)).save(root / name)
            if split == "test":
                continue
            depth = torch.where(a > 0.5, depth, 0.0)
            stem = root / name[:-4]
            Image.fromarray(np.round(depth.reshape(res, res).cpu().numpy()
                                     / DEPTH_SCALE).astype(np.uint16)).save(
                f"{stem}.depth.png")
            cfg["frames"][i]["depth_path"] = f"{name[:-4]}.depth.png"
            if i % 2 == 0:
                # a grey whose sRGB decoding (load_stbi) is the alpha
                grey = torch.round(linear_to_srgb(a) * 255).to(torch.uint8)
                Image.fromarray(grey.reshape(res, res).cpu().numpy(),
                                "L").save(f"{stem}.alpha.png")
            if i == 0:
                view0 = {"depth": depth, "alpha": a}
        path = root / ("transforms.json" if split == "train"
                       else "transforms_test.json")
        path.write_text(json.dumps(cfg))
        paths.append(path)
    lo, hi = (int(f * res) for f in MASK_BOX)
    mask = np.zeros((res, res), np.uint8)
    mask[lo:hi, lo:hi] = 255
    Image.fromarray(mask, "L").save(root / "train" / "dynamic_mask_r_000.png")
    return paths[0], paths[1], view0


def _timed(tag: str, what: str, render, W: int, H: int):
    """``render()`` → an (H, W, 4) frame (tensor or numpy), gated (finite,
    opacity in [0, 1]) and timed; returns it as a tensor."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    img = torch.as_tensor(img)
    _check_frame(img, W, H)
    print(f"{tag}: {what} {W}x{H} in {ms:.1f} ms; mean opacity "
          f"{float(img[..., 3].mean()):.4f}")
    return img


def capture_frames(dev, tb, root: Path, test_xf: np.ndarray, frame,
                   pano) -> None:
    """The renderer's new options on the F-theta snapshot (Testbed ``tb``):
    a LatLong panorama and an F-theta frame of a held-out view against
    the analytic spheres on the same rays; a 2×1 stereo quilt, each panel
    against its frame rendered alone; an envmap scene, its transparent
    pixels against the envmap's sample."""
    from ngp_tpu_torch.api.testbed import Testbed
    from ngp_tpu_torch.common import srgb_to_linear
    from ngp_tpu_torch.data.image_io import save_exr
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    tr = tb.trainer
    params, bitfield = tr.inference_params(), tr.grid.bitfield
    W, H = frame
    eye = _orbit_xforms(1, seed=2, phase=0.5)[0]
    # the capture's lens over a W × H frame: the native frame's pixel scale,
    # cropped to the frame's aspect
    native = float(tr.dataset.resolution[0][0])
    lens = tuple(float(x) for x in tr.dataset.lens_params[0][:5]) + (
        native, native * H / W)
    for what, (w, h), cam, kw in (
            ("LatLong panorama", pano, eye, dict(lens_mode="latlong")),
            ("F-theta frame of held-out view 0", frame, test_xf,
             dict(lens_mode="ftheta", lens_params=lens))):
        r = NerfRenderer.for_trainer(tr, RenderOptions(
            width=w, height=h, background=(0, 0, 0, 0), linear_out=True,
            march_steps=tr.tcfg.march_steps, **kw))
        img = _timed("captures", what, lambda: r.render(
            params, bitfield, cam, w, h, focal=FOCAL), w, h)
        o, d, _, _ = r._gen_rays(0, w * h, w, h, *FOCAL,
                                 torch.as_tensor(cam, device=dev))
        gt, _ = _render_spheres(o, d)
        _gate_at_least("captures", f"{what} PSNR against the analytic "
                       "spheres (dB)", _srgb_psnr(img[..., :3], gt),
                       LENS_PSNR_DB)
    # the stereo quilt: panel k is the frame alone with head shift ±IPD/2
    tb.camera_matrix = test_xf
    tb.quilting_dims = (2, 1)
    tb.parallax_shift = np.array([QUILT_IPD, 0.0, 0.5], np.float32)
    quilt = _timed("captures", "2x1 stereo quilt", lambda: tb.render(W, H),
                   W, H)
    tb.quilting_dims = (1, 1)
    for k, sign in enumerate((1.0, -1.0)):
        tb.parallax_shift = np.array([sign * QUILT_IPD / 2, 0.0, 0.5],
                                     np.float32)
        alone = _timed("captures", f"quilt panel {k} alone",
                       lambda: tb.render(W // 2, H), W // 2, H)
        panel = quilt[:, k * (W // 2):(k + 1) * (W // 2)]
        _gate_max("captures", f"quilt panel {k} mean |Δ| to its frame alone",
                  float((panel - alone).abs().mean()), QUILT_TOL)
    tb.parallax_shift = np.zeros(3, np.float32)
    # the envmap scene: the capture with an envmap written by save_exr
    hh = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    ww = np.linspace(0.0, 1.0, 128, dtype=np.float32)[None, :]
    env = np.stack(np.broadcast_arrays(
        ww, hh, 0.5 + 0.5 * np.sin(ww * 16 * np.pi) * hh), -1)
    save_exr(root / "env.exr", env.astype(np.float32))
    cfg = json.loads((root / "transforms.json").read_text())
    (root / "transforms_env.json").write_text(json.dumps(
        {**cfg, "envmap": "env.exr"}))
    tbe = Testbed(device=dev)
    tbe.reload_network_from_json(tb.network_config)
    tbe.load_training_data(root / "transforms_env.json")
    tbe.load_snapshot(root / "snapshot.msgpack")
    tbe.camera_matrix = test_xf
    img = _timed("captures", "envmap scene", lambda: tbe.render(W, H), W, H)
    r = tbe._nerf_renderer(W, H)
    _, d, _, _ = r._gen_rays(0, W * H, W, H, *FOCAL,
                             torch.as_tensor(test_xf, device=dev))
    e = r.envmap_sampler(d)
    bg = torch.as_tensor(tbe.background_color, device=dev)
    want = srgb_to_linear(torch.clamp(e[:, :3] + bg[:3] * (1 - e[:, 3:]),
                                      min=0.0)).reshape(H, W, 3).cpu()
    clear = img[..., 3] < 1e-4
    print(f"captures: envmap scene: {int(clear.sum())} of {W * H} pixels "
          "with opacity < 1e-4")
    if int(clear.sum()) < W * H // 10:
        raise RuntimeError("the envmap scene left too few clear pixels")
    _gate_max("captures", "envmap scene's clear pixels, mean |Δ| to the "
              "envmap", float((img[..., :3][clear] - want[clear]).abs()
                              .mean()), ENVMAP_TOL)


def write_ray_capture(dev, root: Path, n_views: int, res: int) -> Path:
    """The perspective sphere views with ``rays_<name>.dat`` sidecars that
    hold exactly the camera's own pixel-centre rays (in NeRF space: the
    loader's nerf→ngp axis cycle inverted). Returns transforms.json."""
    from PIL import Image
    root.mkdir(parents=True)
    xfs = _orbit_xforms(n_views)
    files = [f"r_{i:03d}.png" for i in range(n_views)]
    for name, xf, img in zip(files, xfs, sphere_views(dev, xfs, res)):
        Image.fromarray(img).save(root / name)
        o, d = _pixel_rays(dev, xf, res, "perspective", (0.0,) * 7,
                           SPHERE_FOCAL * res)
        rays = torch.cat([o[:, [2, 0, 1]], d[:, [2, 0, 1]]], -1)
        rays.cpu().numpy().astype(np.float32).tofile(
            root / f"rays_{name[:-4]}.dat")
    path = root / "transforms.json"
    path.write_text(json.dumps(_nerf_transforms(xfs, res, files)))
    return path


def phase_captures(dev, config=None, res: int = CAPTURE_RES,
                   n_views: int = CAPTURE_VIEWS, steps: int = CAPTURE_STEPS,
                   small_res: int = CAPTURE_SMALL_RES,
                   rs_steps: int = RS_STEPS, tcnn_steps: int = TCNN_STEPS,
                   frame=(FRAME_W, FRAME_H), pano=PANO,
                   cpu_size=(64, 36)):
    """Real captures (cell smoke-captures-spheres): an F-theta capture
    with every sidecar trained through the runner with depth supervision
    and the int8 grid sweep; the renderer's lenses, quilt and envmap on its
    snapshot; a rolling-shutter capture and a ray-sidecar capture; the
    renderer under NGP_TPU_ENCODE_INT8=fwd (K4 on the render path); a
    tcnn-layout model. Returns (the launch counts of the runner's training,
    K4's entry on the int8 frame's largest encode call, with its launches
    in that frame)."""
    import dataclasses
    import os
    import shutil

    from ngp_tpu_torch import run
    from ngp_tpu_torch.common import RenderMode
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
    from ngp_tpu_torch.kernels.blocked_grid import quantize_table_i8
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    t_phase = time.perf_counter()
    root = ROOT / "build" / "captures_smoke"
    shutil.rmtree(root, ignore_errors=True)
    config = Path(config or ROOT / "configs/nerf/base.json")
    net_cfg = load_network_config(config)
    t0 = time.perf_counter()
    train_json, test_json, view0 = write_ftheta_capture(
        dev, root, n_views, CAPTURE_HELD_OUT, res)
    print(f"captures: F-theta capture of {n_views} + {CAPTURE_HELD_OUT} "
          f"held-out {res}x{res} views with depth, alpha and mask sidecars "
          f"written in {time.perf_counter() - t0:.2f} s")
    snap = root / "snapshot.msgpack"
    scene = ["--scene", str(train_json), "--network", str(config),
             "--device", str(dev)]
    with mock.patch.dict(os.environ, {"NGP_TPU_GRID_INT8": "1"}):
        out = _run_entry(run.main, scene + ["--n_steps", "0",
                                            "--test_transforms",
                                            str(test_json)])
        psnr0, _ = _held_out_psnr(out)
        _reset_launches()
        t0 = time.perf_counter()
        out = _run_entry(run.main, scene + [
            "--n_steps", str(steps), "--depth_supervision_lambda",
            str(CAPTURE_DEPTH_LAMBDA), "--save_snapshot", str(snap),
            "--test_transforms", str(test_json)])
        launches = dict(bgc.launches)
    its = _check_iterations(out, steps)
    psnr1, ssim1 = _held_out_psnr(out)
    rate = float(re.findall(r"\(([\d.]+) steps/s\)", out)[-1])
    print(f"captures: runner trained {its[-1][0]} steps at "
          f"{1e3 / rate:.2f} ms/step (the call {time.perf_counter() - t0:.2f}"
          f" s with eval); held-out PSNR {psnr0:.2f} -> {psnr1:.2f} dB, "
          f"SSIM {ssim1:.4f}; launches {launches}")
    _gate_at_least("captures", "held-out PSNR rise (dB)", psnr1 - psnr0,
               PSNR_RISE_DB)
    missing = [k for k in ("blocked_grid_encode_fwd",
                           "blocked_grid_encode_bwd",
                           "blocked_grid_encode_fwd_i8") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"the F-theta training never launched {missing}")

    tb = _nerf_testbed(dev, root, config, snap)
    tr = tb.trainer
    ds = tr.dataset
    # the DEPTH frame of view 0 against the analytic depth
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        width=res, height=res, render_mode=RenderMode.DEPTH,
        linear_out=False, lens_mode="ftheta",
        lens_params=tuple(float(x) for x in ds.lens_params[0]),
        principal=tuple(float(x) for x in ds.principal[0]),
        march_steps=tr.tcfg.march_steps, snap_to_pixel_centers=True))
    img = _timed("captures", "DEPTH frame of view 0", lambda: r.render(
        tr.inference_params(), tr.grid.bitfield, ds.xforms[0], res, res,
        focal=tuple(float(f) for f in ds.focal[0])), res, res)
    hit = view0["alpha"] > 0.5
    err = float((img[..., 0].reshape(-1).to(dev)[hit]
                 - view0["depth"][hit]).abs().mean())
    print(f"captures: {int(hit.sum())} pixels of view 0 hit a sphere")
    _gate_max("captures", "DEPTH frame mean |Δ| to the analytic depth over "
              "the hit pixels (units)", err, DEPTH_TOL)
    # one step's draws: no ray under view 0's dynamic mask reaches the loss
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dep = tr._step_grads(tr.draws(tr.tcfg.n_rays, g), tr._error_state())[3]
    img_i, xy, has = dep[0], dep[1], dep[-1]
    pix = (xy * res).to(torch.int64)
    lo, hi = (int(f * res) for f in MASK_BOX)
    masked = (img_i == 0) & (pix >= lo).all(-1) & (pix < hi).all(-1)
    n_masked, n_in_loss = int(masked.sum()), int((masked & has).sum())
    print(f"captures: one step of {xy.shape[0]} rays: {n_masked} under view "
          f"0's dynamic mask, {n_in_loss} of them in the loss")
    if n_masked == 0:
        raise RuntimeError("no ray of the step fell under the dynamic mask")
    _gate("captures", "rays under the dynamic mask in the loss", n_in_loss,
          "== 0", n_in_loss == 0, 0.0 if n_in_loss == 0 else float("inf"),
          "d")

    test_xf = _orbit_xforms(CAPTURE_HELD_OUT, seed=1, phase=0.3)[0]
    capture_frames(dev, tb, root, test_xf, frame, pano)

    # rolling shutter: end cameras turned and moved, views motion-blurred
    R = _rotation_about(np.array([0.0, 0.0, 1.0]), math.radians(RS_ROT_DEG))
    xfs = _orbit_xforms(n_views)
    xe = xfs.copy()
    xe[:, :, :3] = R @ xfs[:, :, :3]
    xe[:, :, 3] = (xfs[:, :, 3] - 0.5) @ R.T + 0.5 + [RS_TRANS, 0.0, 0.0]
    ds_rs = build_sphere_dataset(dev, n_views, small_res,
                                 xfs_end=xe.astype(np.float32))
    tr_rs = make_trainer(ds_rs, dev, net_cfg)
    p0 = view_psnr(tr_rs, 0, RS_SPP, motion=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tr_rs.train(rs_steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / rs_steps
    p1 = view_psnr(tr_rs, 0, RS_SPP, motion=True)
    print(f"captures: rolling shutter ({RS_ROT_DEG}° and {RS_TRANS} between "
          f"start and end) {rs_steps} steps at {ms:.2f} ms/step, loss "
          f"{loss:.4e}; motion-blurred view 0 PSNR {p0:.2f} -> {p1:.2f} dB")
    if not math.isfinite(loss):
        raise RuntimeError(f"the rolling-shutter loss is not finite: {loss}")
    _gate_at_least("captures", "rolling-shutter PSNR rise (dB)", p1 - p0,
               RS_PSNR_RISE_DB)
    del tr_rs, ds_rs

    # ray sidecars holding the camera's own rays: the same rays
    ray_json = write_ray_capture(dev, root / "rays", 4, small_res // 2)
    ds_r = load_nerf(ray_json)
    trs = [make_trainer(d, dev, net_cfg, snap_to_pixel_centers=True)
           for d in (ds_r, dataclasses.replace(ds_r, rays=None))]
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    draws = trs[0].draws(trs[0].tcfg.n_rays, g)
    img_i, xy, _, _ = trs[0]._sample_pixels(trs[0]._error_state(),
                                            draws.u_img, draws.u_xy)
    (o_s, d_s, _), (o_c, d_c, _) = (t._build_rays(img_i, xy) for t in trs)
    rel = max(float((o_s - o_c).abs().max() / o_c.abs().max()),
              float((d_s - d_c).abs().max() / d_c.abs().max()))
    loss = trs[0].train(16)
    print(f"captures: ray sidecars on {xy.shape[0]} rays of one step's "
          f"draws; 16 steps on them: loss {loss:.4e}, "
          f"{trs[0].last_samples} samples in the last")
    if not (math.isfinite(loss) and trs[0].last_samples > 0):
        raise RuntimeError("the ray-sidecar steps trained nothing")
    _gate_max("captures", "sidecar rays against the camera's, max |Δ| "
              "relative", rel, RAYS_REL_TOL)
    del trs

    # the int8 renderer: K4 on the render path
    with mock.patch.dict(os.environ, {"NGP_TPU_ENCODE_INT8": "fwd"}):
        tb8 = _nerf_testbed(dev, root, config, snap)
    W, H = frame
    for t in (tb, tb8):
        t.camera_matrix = test_xf
    calls, encode = [], bgc.encode_quantized

    def spy(tq, qs, pos, meta):
        """Keeps the largest int8 encode call of the frame."""
        if not calls or pos.shape[0] > calls[0][2].shape[0]:
            calls[:] = [(tq, qs, pos.clone(), meta)]
        return encode(tq, qs, pos, meta)
    _reset_launches()
    with mock.patch.object(bgc, "encode_quantized", spy):
        img8 = _timed("captures", "NGP_TPU_ENCODE_INT8=fwd frame",
                      lambda: tb8.render(W, H), W, H)
    frame_launches = dict(bgc.launches)
    f32 = _timed("captures", "f32 frame", lambda: tb.render(W, H), W, H)
    print(f"captures: launches in the int8 frame {frame_launches}")
    if frame_launches["blocked_grid_encode_fwd_i8"] <= 0:
        raise RuntimeError("the int8 frame never launched K4")
    _gate_at_least("captures", "int8 frame PSNR against the f32 frame (dB)",
                   _srgb_psnr(img8[..., :3], f32[..., :3]),
                   INT8_FRAME_PSNR_DB)
    cw, ch = cpu_size
    r8 = tb8._nerf_renderer(cw, ch)
    tr8 = tb8.trainer
    p8 = tr8.inference_params()
    gpu = r8.render(p8, tr8.grid.bitfield, test_xf, cw, ch, focal=FOCAL)
    tr8.model.cpu()
    try:
        cpu = r8.render({k: v.cpu() for k, v in p8.items()},
                        tr8.grid.bitfield.cpu(), test_xf, cw, ch, focal=FOCAL)
    finally:
        tr8.model.to(dev)
    _cpu_frame_check("captures", gpu, cpu, f"int8 {cw}x{ch} frame")
    tq, qs, pos, meta = calls[0]
    with torch.no_grad():
        ref_q = quantize_table_i8(p8["pos_encoding.table"])
    if not (torch.equal(ref_q[0], tq) and torch.equal(ref_q[1], qs)):
        raise RuntimeError("the int8 frame's table is not the EMA table's "
                           "quantisation")
    err = check_k4(tq, qs, pos, meta, "nerf-render-int8")
    k4 = time_k4(tq, qs, pos, meta, err, "nerf-render-int8")
    k4["frame_launches"] = frame_launches["blocked_grid_encode_fwd_i8"]
    del tb8, tr8

    # a tcnn-layout model beside the blocked grid
    ds_t = build_sphere_dataset(dev, n_views, small_res)
    for impl in ("blocked", "tcnn"):
        t = make_trainer(ds_t, dev, net_cfg, grid_impl=impl, grid_int8=False)
        p0 = view_psnr(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = t.train(tcnn_steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / tcnn_steps
        p1 = view_psnr(t)
        print(f"captures: grid_impl={impl} {tcnn_steps} steps at {ms:.2f} "
              f"ms/step, loss {loss:.4e}; view 0 PSNR {p0:.2f} -> {p1:.2f} "
              "dB")
        if impl == "tcnn":
            if not math.isfinite(loss):
                raise RuntimeError("the tcnn-layout loss is not finite")
            _gate_at_least("captures", "tcnn-layout PSNR rise (dB)", p1 - p0,
                       TCNN_PSNR_RISE_DB)
        del t
    print(f"captures: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, k4


# the adam phase: the image-train-8k cell's image (a 2 GiB table) and the
# steps each trainer takes before its gradient is captured
ADAM_IMAGE_RES, ADAM_WARM_STEPS = 8192, 4


def adam_bytes(params, grads, state, cfg, matrix_names) -> tuple:
    """(the bytes one fused Adam step needs at these inputs, a dense
    pass's): every gradient entry read; p, m and v read and written at each
    entry the step updates (every entry of a matrix, those with g ≠ 0
    elsewhere); with an Ema, e read and written and p read where not
    updated; with no Ema, nothing where the Ema is the parameters, else e
    written and p read where not updated. A dense pass: 7 × 4 bytes an
    entry and the same Ema."""
    need = dense = 0
    for name, p in params.items():
        n = p.numel()
        if (matrix_names is None or name in matrix_names
                or not cfg.skip_zero_grad):
            upd = n
        else:
            upd = int((grads[name] != 0).sum())
        same = state.ema_params[name].data_ptr() == p.data_ptr()
        ema, ema_dense = ((2 * n, 2 * n) if cfg.ema_decay > 0.0
                          else (0, 0) if same else (n, n))
        if ema:
            ema += n - upd
        need += 4 * (n + 6 * upd + ema)
        dense += 4 * (7 * n + ema_dense)
    return need, dense


def _capture_update(tr, module):
    """Run one more training step of ``tr`` under a profiler and return
    what its ``apply_update`` (looked up in ``module``) was given, before
    the update: parameters, gradients, state, config and matrix names, as
    copies; and the step's fused Adam launches and ``adam_fused`` count."""
    from ngp_tpu_torch.kernels import fused_adam_cuda as fa
    from ngp_tpu_torch.utils import profiling
    seen = {}
    real = module.apply_update

    def spy(params, grads, state, cfg, matrix_names=None):
        seen["args"] = (
            {k: p.detach().clone() for k, p in params.items()},
            {k: g.clone() for k, g in grads.items()},
            state, cfg, matrix_names)
        seen["state"] = _copy_state(state, params, seen["args"][0])
        return real(params, grads, state, cfg, matrix_names)
    _reset_launches()
    with mock.patch.object(module, "apply_update", spy), \
            torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
        tr.train(1)
    # read once the profiler has stopped: that ends the window, so the
    # next one counts afresh
    counted = profiling.counters().get("adam_fused", 0)
    torch.cuda.synchronize()
    params, grads, _, cfg, names = seen["args"]
    step = {"launches": fa.launches["fused_adam"], "adam_fused": counted}
    return params, grads, seen["state"], cfg, names, step


def _copy_state(state, params: dict, new_params: dict):
    """A copy of the Adam ``state`` of ``params`` for ``new_params``: an
    Ema entry that is its parameter stays the (new) parameter."""
    return state._replace(
        mu={k: t.clone() for k, t in state.mu.items()},
        nu={k: t.clone() for k, t in state.nu.items()},
        ema_params={k: new_params[k] if e is params[k] else e.clone()
                    for k, e in state.ema_params.items()})


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_time_adam(what: str, params, grads, state, cfg, matrix_names,
                    step: dict) -> dict:
    """The fused Adam step on these inputs against the eager update: the
    training step they came from (``step``, from ``_capture_update``) must
    have launched it once and counted every entry under ``adam_fused``;
    then p, m, v and Ema bit-equal after one step from copies of the same
    state, again one launch and no host sync; then both timed in turns,
    beside the bound (``adam_bytes``)."""
    from ngp_tpu_torch.kernels import fused_adam_cuda as fa
    from ngp_tpu_torch.opt import optimizers as topt
    from ngp_tpu_torch.utils import profiling

    def copies():
        p = {k: t.clone() for k, t in params.items()}
        return p, _copy_state(state, params, p)
    kp, ks = copies()
    pp, ps = copies()
    torch.cuda.synchronize()
    before = fa.launches["fused_adam"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            ks2 = topt.apply_update(kp, grads, ks, cfg, matrix_names)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counted = profiling.counters().get("adam_fused", 0)
    side = fa.launches["fused_adam"] - before
    ps2 = topt.apply_update_plain(pp, grads, ps, cfg, matrix_names)
    torch.cuda.synchronize()
    equal = {f: all(_bits_equal(a[k], b[k]) for k in params)
             for f, a, b in (("p", kp, pp), ("m", ks2.mu, ps2.mu),
                             ("v", ks2.nu, ps2.nu),
                             ("e", ks2.ema_params, ps2.ema_params))}
    n = sum(p.numel() for p in params.values())
    need, dense = adam_bytes(params, grads, state, cfg, matrix_names)
    skipped = [k for k in params if cfg.skip_zero_grad and not (
        matrix_names is None or k in matrix_names)]
    touched = sum(int((grads[k] != 0).sum()) for k in skipped)
    vecs = sum(int((grads[k].view(-1, 4) != 0).any(1).sum())
               if grads[k].numel() % 4 == 0 else grads[k].numel()
               for k in skipped)
    in_skipped = sum(params[k].numel() for k in skipped)
    (k1, k2), (p1, p2) = _time_in_turns(
        lambda: topt.apply_update(kp, grads, ks, cfg, matrix_names),
        lambda: topt.apply_update_plain(pp, grads, ps, cfg, matrix_names),
        kern_iters=20, plain_iters=3)
    bound = need / HBM_BYTES_PER_S * 1e3
    print(f"adam: {what}: {n} entries in {len(params)} tensors; of the "
          f"{in_skipped} with the zero-gradient skip {touched} touched "
          f"({100.0 * touched / max(in_skipped, 1):.2f} %; "
          f"{100.0 * 4 * vecs / max(in_skipped, 1):.2f} % in touched "
          f"float4s); kernel {k1:.4f} / {k2:.4f} ms (CUDA-graph replays), "
          f"eager {p1:.4f} / {p2:.4f} ms (events); bound {bound:.4f} ms "
          f"({need / 1e6:.1f} MB at 3.35 TB/s), share "
          f"{100.0 * bound / min(k1, k2):.1f} %; dense pass "
          f"{dense / HBM_BYTES_PER_S * 1e3:.4f} ms ({dense / 1e6:.1f} MB); "
          f"bit-equal {equal}; in the training step {step['launches']} "
          f"launches, adam_fused {step['adam_fused']}; in the step alone "
          f"{side} launches, adam_fused {counted}, no sync")
    if not all(equal.values()):
        raise AssertionError(f"adam: {what}: the kernel's step differs from "
                             f"the eager update's: {equal}")
    if (step["launches"], step["adam_fused"], side, counted) != (1, n, 1, n):
        raise AssertionError(f"adam: {what}: {step['launches']} launches and "
                             f"adam_fused {step['adam_fused']} in a training "
                             f"step of {n} entries ({side} and {counted} in "
                             f"the step alone)")
    return {"name": f"fused_adam ({what})", "launch_name": "fused_adam",
            "card_ms": [k1, k2], "plain_ms": [p1, p2], "bound_ms": bound,
            "bytes": need, "dense_bound_ms": dense / HBM_BYTES_PER_S * 1e3,
            "entries": n, "touched": touched, "launches": step["launches"],
            "adam_fused": step["adam_fused"],
            "bit_equal": all(equal.values())}


def phase_adam(dev, image_res: int = ADAM_IMAGE_RES,
               nerf_views: int = 8, nerf_res: int = 64) -> list:
    """The fused Adam kernel on one real step of each trainer that the
    benchmark's training cells run: the image (configs/image/base.json on
    an image_res² seeded image, batch 2^18: its 2 GiB table at 8192²) and
    the NeRF (configs/nerf/base.json on nerf_views sphere views: the 64
    MiB table, Ema 0.95); each ``check_time_adam``."""
    import ngp_tpu_torch.train.image as timage
    import ngp_tpu_torch.train.nerf as tnerf
    from ngp_tpu_torch.config import load_network_config
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    img = torch.rand((image_res, image_res, 3), generator=g,
                     device=dev).cpu().numpy()
    tr = timage.ImageTrainer(
        img, load_network_config(ROOT / "configs/image/base.json"),
        seed=SEED, batch_size=1 << 18, device=dev)
    del img
    tr.train(ADAM_WARM_STEPS)
    entries = [check_time_adam(f"image step ({image_res}², 2^18 positions)",
                               *_capture_update(tr, timage))]
    del tr
    torch.cuda.empty_cache()
    tr = make_trainer(build_sphere_dataset(dev, nerf_views, nerf_res), dev)
    tr.train(ADAM_WARM_STEPS)
    entries.append(check_time_adam("NeRF step", *_capture_update(tr, tnerf)))
    print(f"adam: phase {time.perf_counter() - t0:.1f} s")
    return entries


def kernel_phases(dev, ray) -> list:
    """K1–K5 against their plain versions, timed; K1, K2 and K3 on the
    render path's ray-ordered inputs too."""
    return [phase_k1(dev, ray), phase_k2(dev, ray), phase_k3(dev, ray),
            phase_k4(dev), phase_k5(dev)]


def _named(kernels: list, name: str) -> dict:
    return next(k for k in kernels if k["name"] == name)


def main() -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:]
    device = phase_device()
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    phase_build()
    if "--kernels" in args:
        # the kernel phases alone, on their own scene and an untrained
        # trainer's sweep: no main path is run, so no launch counts and no
        # "ok" line
        kernels = kernel_phases(dev, ray_ordered_inputs(dev))
        tr = make_trainer(build_sphere_dataset(dev, 2, 32), dev)
        phase_k4_sweep(dev, _named(kernels, "blocked_grid_encode_fwd_i8"),
                       sweep_ordered_inputs(tr))
        kernels += phase_k12_2d(dev) + phase_k345_2d(dev) + phase_adam(dev)
        print(json.dumps({"kernels": kernels}))
        return 0
    if "--adam" in args:
        print(json.dumps({"kernels": phase_adam(dev)}))
        return 0
    if "--k2-zeros" in args:
        # the train phase, then its one-step K2 check on the draws of
        # more seeds: no main path is run past it, so no "ok" line
        n = int(args[args.index("--k2-zeros") + 1])
        _, tr = phase_train(dev)
        k2_zero_survey(tr, n)
        del tr
        image_k2_zero_survey(dev, n)
        return 0
    _, renderer, bitfield = phase_slice(dev)
    if "--profile" in args:
        phase_profile_frame(renderer, bitfield)
    kernels = kernel_phases(dev, ray_ordered_inputs(dev, renderer, bitfield))
    del renderer, bitfield
    launches, tr = phase_train(dev)
    phase_k4_sweep(dev, _named(kernels, "blocked_grid_encode_fwd_i8"),
                   sweep_ordered_inputs(tr))
    if "--profile" in args:
        phase_profile(tr)
    pose_launches, pose_step = phase_pose(dev, tr.dataset)
    del tr
    testbed_launches, normals_k3, view0_psnr = phase_testbed(dev)
    multinerf_launches = phase_multinerf(dev, view0_psnr)
    wave_launches, wave_k1 = phase_wave(dev, profile="--profile" in args)
    dist_launches = phase_dist(dev)
    image_launches, kernels_2d, image_f32 = phase_image(dev)
    int8_runs, kernels_int8 = phase_image_int8(dev, image_f32)
    volume_launches = phase_volume(dev)
    sdf_launches, analytic_k3 = phase_sdf(dev)
    t_new = time.perf_counter()
    mesh_launches, mesh_k1 = phase_mesh(dev)
    tak_launches, tak_kernels = phase_takikawa(dev)
    playback_launches, bake_k1 = phase_playback(dev)
    print(f"mesh, takikawa, playback: {time.perf_counter() - t_new:.1f} s")
    captures_launches, render_k4 = phase_captures(dev)
    # each kernel's launches in the run of the path it was ported for: the
    # training phase (K1, K2, K4), the pose phase (K3, K5), whose kernels
    # were also timed on one step's inputs, the image phase (2D K1, K2),
    # the image-int8 phase (2D K3, K4, K5; per run too), the volume phase;
    # and in the testbed phase (K3: its NORMALS frame's under
    # "testbed_normals_launches"), the multinerf phase (K1 alone), the
    # image phase and the sdf phase (K1, K2; K3: its analytic-normals
    # frame's under "sdf_analytic_launches")
    for k in kernels:
        k["launches"] = (pose_launches if k["name"] in pose_step
                         else launches)[k["name"]]
        if k["name"] in pose_step:
            _sub_entry(k, pose_step[k["name"]], "pose_step")
    for k in kernels_2d:
        k["launches"] = image_launches[k["name"]]
    # the 2D K3, K4 and K5 run on the image path under the int8 modes and
    # in its uv gradient: their launches there, in all
    for k in kernels_int8:
        k["launches"] = sum(r[k["name"]] for r in int8_runs.values())
    kernels += kernels_2d + kernels_int8
    for k in kernels:
        k["testbed_launches"] = testbed_launches[k["name"]]
        k["multinerf_launches"] = multinerf_launches[k["name"]]
        k["image_launches"] = image_launches[k["name"]]
        for run, counts in int8_runs.items():
            k[f"image_int8_{run}_launches"] = counts[k["name"]]
        k["volume_launches"] = volume_launches[k["name"]]
        k["sdf_launches"] = sdf_launches[k["name"]]
    k3 = _named(kernels, "blocked_grid_encode_bwd_pos")
    k3["testbed_normals_launches"] = normals_k3
    k3["sdf_analytic_launches"] = analytic_k3
    # this slice's inputs, entries of their own: K1 on the mesh field and
    # the playback bake, K1, K2 and K3 at L = 7 on the Takikawa path; each
    # with its launches in its own phase
    slice_entries = [(mesh_k1, "mesh field", mesh_launches)] + [
        (e, "takikawa L=7", tak_launches) for e in tak_kernels] + [
        (bake_k1, "playback bake", playback_launches)]
    for e, what, counts in slice_entries:
        e["launch_name"] = e["name"]
        e["name"] = f"{e['name']} ({what})"
        e["launches"] = counts[e["launch_name"]]
    # K4 on the NeRF renderer's path under NGP_TPU_ENCODE_INT8: its
    # launches in one int8 frame
    render_k4["launch_name"] = render_k4["name"]
    render_k4["name"] = f"{render_k4['name']} (nerf render int8)"
    render_k4["launches"] = render_k4.pop("frame_launches")
    # K1 on the wave renderer's path: its launches in the wave phase's f32
    # wave frames
    kernels += [e for e, _, _ in slice_entries] + [render_k4, wave_k1]
    for k in kernels:
        name = k.get("launch_name", k["name"])
        k["wave_launches"] = wave_launches[name]
        k["dist_launches"] = dist_launches[name]
        k["mesh_launches"] = mesh_launches[name]
        k["takikawa_launches"] = tak_launches[name]
        k["playback_launches"] = playback_launches[name]
        k["captures_launches"] = captures_launches[name]
    # the fused Adam: "launches" is its launches in the training step its
    # inputs came from; here its launches in the train and image phases'
    # runs too (each phase fails unless once a step)
    adam = phase_adam(dev)
    for k in adam:
        k["train_launches"], k["train_steps"] = (launches["fused_adam"],
                                                 TRAIN_STEPS)
        k["image_launches"], k["image_steps"] = (image_launches["fused_adam"],
                                                 IMAGE_STEPS)
    kernels += adam
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
