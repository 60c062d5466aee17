"""Train / evaluate / render runner in NeRF, SDF, image and volume mode
(port of ``scripts/run.py``, the reference's scripts/run.py workflow):

    python -m ngp_tpu_torch.run --scene data/nerf/fox --n_steps 2000 \\
        --save_snapshot out.msgpack --test_transforms transforms_test.json \\
        --screenshot_transforms transforms_test.json --width 640 --height 360
    python -m ngp_tpu_torch.run --mode sdf --scene mesh.obj --n_steps 512 \\
        --save_snapshot sdf.msgpack
    NGP_TPU_ENCODE_INT8=full python -m ngp_tpu_torch.run --scene cloud.nvdb \\
        --n_steps 1024 --save_snapshot volume.msgpack

Mode inference (or ``--mode``), config resolution, training with
``iteration=`` prints, snapshot save/load, held-out PSNR/SSIM (black
background, snap to pixel centres, linear render → sRGB compared to the
target; ref run.py:216-303), screenshots at the cameras of
``--screenshot_transforms``, a mesh of the NeRF's density or the SDF
(``--save_mesh x.obj|x.ply`` at ``--marching_cubes_res``) and a
camera-path video (``--video_camera_path``; ``--video_playback`` renders
it from the baked playback cache; the frames are encoded by ffmpeg where
it is installed). It runs on the card unless ``--device cpu`` asks for the
CPU. ``--depth_supervision_lambda`` sets the NeRF trainer's depth
supervision, which the JAX runner reaches only through the Testbed's
attributes. ``--trace_dir DIR`` traces the whole run with
``torch.profiler`` and writes one Chrome trace, ``DIR/trace.json``, that
holds the program's named spans and the card's kernels on one clock.

Intended divergences: ``--n_steps`` is exact (the JAX package's NeRF
trainer runs on to a 16-step boundary); the NeRF mesh is cut from σ in
the occupied cells only (``Testbed.compute_marching_cubes_mesh``); the
video's frames are RGB JPEGs in ``tmp_video_frames`` beside
``--video_output`` (the JAX runner writes RGBA, which JPEG cannot hold,
into the working directory).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ngp_tpu_torch.run",
                                description=__doc__)
    p.add_argument("--scene", "--training_data", default="",
                   help="scene dir / transforms.json")
    p.add_argument("--mode", default="",
                   help="nerf|sdf|image|volume (inferred from the scene if "
                        "empty)")
    p.add_argument("--network", default="", help="network config json")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--n_steps", type=int, default=-1)
    p.add_argument("--test_transforms", default="",
                   help="transforms.json with held-out views for PSNR/SSIM")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_frames", nargs="*")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--save_mesh", default="")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--video_camera_path", default="")
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_n_seconds", type=int, default=1)
    p.add_argument("--video_spp", type=int, default=8)
    p.add_argument("--video_output", default="video.mp4")
    p.add_argument("--video_playback", action="store_true",
                   help="render the camera path from the baked playback "
                        "cache instead of the live network")
    p.add_argument("--nerf_compatibility", action="store_true",
                   help="upstream instant-ngp semantics: sRGB colors, cone "
                        "angle 0, world scale 0.33/offset .5 (ref: "
                        "run.py:155-176 + upstream loader defaults)")
    p.add_argument("--world_scale", type=float, default=None)
    p.add_argument("--world_offset", type=float, nargs=3, default=None)
    p.add_argument("--train", action="store_true")
    p.add_argument("--depth_supervision_lambda", type=float, default=None,
                   help="weight of the depth loss of a capture with depth "
                   "maps (testbed.nerf.training.depth_supervision_lambda)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--trace_dir", default="",
                   help="write a Chrome trace of the run (the program's "
                        "spans and the card's kernels) to DIR/trace.json")
    return p.parse_args(argv)


def write_image(path, img):
    """Write a linear (H, W, C) float frame: EXR, the fp16 .bin format, or
    an LDR file in sRGB."""
    from ngp_tpu_torch.data.image_io import (save_binary_image, save_exr,
                                             save_stbi)
    path = str(path)
    if path.endswith(".bin"):
        save_binary_image(path, img)
    elif path.endswith(".exr"):
        save_exr(path, img)
    else:
        save_stbi(path, img, from_linear=True)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Grayscale SSIM with an 11×11 Gaussian window (σ 1.5, standard
    constants) on luminance."""
    from scipy.ndimage import gaussian_filter

    def luminance(x):
        return (0.212671 * x[..., 0] + 0.715160 * x[..., 1]
                + 0.072169 * x[..., 2])
    x = luminance(np.asarray(a, np.float64))
    y = luminance(np.asarray(b, np.float64))
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu_x = gaussian_filter(x, 1.5)
    mu_y = gaussian_filter(y, 1.5)
    sxx = gaussian_filter(x * x, 1.5) - mu_x ** 2
    syy = gaussian_filter(y * y, 1.5) - mu_y ** 2
    sxy = gaussian_filter(x * y, 1.5) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + C1) * (2 * sxy + C2)) / \
        ((mu_x ** 2 + mu_y ** 2 + C1) * (sxx + syy + C2))
    return float(np.mean(s))


def main(argv=None) -> int:
    args = parse_args(argv)
    from ngp_tpu_torch.utils.profiling import device_trace
    with (device_trace(args.trace_dir) if args.trace_dir
          else contextlib.nullcontext()):
        return _run(args)


def _run(args) -> int:
    from ngp_tpu_torch.api.testbed import Testbed, mode_from_scene
    from ngp_tpu_torch.common import ColorSpace, TestbedMode

    mode = TestbedMode(args.mode) if args.mode else \
        (mode_from_scene(args.scene) or TestbedMode.NERF)
    testbed = Testbed(mode, device=args.device)
    if os.environ.get("NGP_TPU_TESTBED_BATCH"):
        testbed.training_batch_size = int(os.environ["NGP_TPU_TESTBED_BATCH"])

    if args.network:
        testbed.reload_network_from_file(args.network)
    if args.depth_supervision_lambda is not None:
        testbed.nerf.training.depth_supervision_lambda = \
            args.depth_supervision_lambda
    if args.world_scale is not None or args.nerf_compatibility:
        testbed.nerf.training.world_scale = (
            args.world_scale if args.world_scale is not None else 0.33)
        testbed.nerf.training.world_offset = (
            args.world_offset if args.world_offset is not None
            else [0.5, 0.5, 0.5])
    if args.scene:
        testbed.load_training_data(args.scene)
    if args.load_snapshot:
        testbed.load_snapshot(args.load_snapshot)

    if args.nerf_compatibility:
        # ref: run.py:155-176 — sRGB color space + cone angle 0
        testbed.color_space = ColorSpace.SRGB
        testbed.nerf.cone_angle_constant = 0.0
        if testbed.trainer is not None:
            testbed.trainer.cone_angle = 0.0

    n_steps = args.n_steps
    if n_steps < 0 and (not args.load_snapshot or args.train):
        n_steps = 35000  # ref default

    if n_steps > 0 and testbed.trainer is not None:
        print(f"Training for {n_steps} steps")
        t0 = time.time()
        report = max(n_steps // 20, 1)
        while testbed.training_step < n_steps:
            k = min(report, n_steps - testbed.training_step)
            loss = testbed.train(k)
            print(f"iteration={testbed.training_step} loss={loss:.6f} "
                  f"({testbed.training_step / (time.time() - t0):.1f} "
                  "steps/s)")

    if args.save_snapshot:
        testbed.save_snapshot(args.save_snapshot)
        print("saved snapshot to", args.save_snapshot)

    if args.save_mesh and mode in (TestbedMode.NERF, TestbedMode.SDF):
        save_mesh(testbed, args.save_mesh, args.marching_cubes_res)

    if args.test_transforms:
        evaluate_test_transforms(testbed, args)

    if args.screenshot_transforms:
        render_screenshots(testbed, args)

    if args.video_camera_path:
        render_video(testbed, args)
    return 0


def save_mesh(testbed, path: str, res: int):
    """The testbed's mesh at res³ (``compute_marching_cubes_mesh``) as a
    PLY without colours or an OBJ with normals."""
    from ngp_tpu_torch.render.mesh_export import save_obj, save_ply
    m = testbed.compute_marching_cubes_mesh(res)
    v, f = m["V"], m["F"]
    if path.endswith(".ply"):
        save_ply(path, v, f)
    else:
        save_obj(path, v, f, m["N"])
    print(f"saved mesh ({len(v)} verts, {len(f)} faces) to", path)


def evaluate_test_transforms(testbed, args):
    """Held-out PSNR/SSIM (protocol of ref run.py:216-303: black background,
    snap to pixel centres, linear render → sRGB blend vs target). Returns
    (mean PSNR, mean SSIM), or None when no view has an image."""
    from ngp_tpu_torch.common import linear_to_srgb_np, mse2psnr
    from ngp_tpu_torch.data.image_io import load_stbi

    with open(args.test_transforms) as f:
        test = json.load(f)
    base = Path(args.test_transforms).parent
    testbed.background_color = np.array([0, 0, 0, 1], np.float32)
    testbed.snap_to_pixel_centers = True
    # render with the dataset's lens + principal like training rays
    # (ref: render_with_lens_distortion on for dataset views,
    # src/testbed.cu:278)
    testbed.nerf.render_with_lens_distortion = True
    # the protocol's spp 8 with snap-to-pixel-centres traces the same
    # centre ray 8 times, so spp 1 computes the same image
    spp = 1
    psnrs, ssims = [], []
    for i, frame in enumerate(test.get("frames", [])):
        ip = base / frame["file_path"]
        if not ip.exists():
            for ext in (".png", ".jpg", ".jpeg"):
                if ip.with_suffix(ext).exists():
                    ip = ip.with_suffix(ext)
                    break
        if not ip.exists():
            continue
        ref = load_stbi(ip)                                   # linear premult
        H, W = ref.shape[:2]
        # focal for this view (fl_x or camera_angle_x; per-frame overrides
        # win, like the loader)
        src = {**test, **frame}
        if "fl_x" in src:
            fx = float(src["fl_x"])
            fy = float(src.get("fl_y", fx))
        elif "camera_angle_x" in src:
            fx = fy = 0.5 * W / np.tan(0.5 * float(src["camera_angle_x"]))
        else:
            fx = fy = float(H)
        testbed._view_focal = np.array([fx, fy], np.float32)
        testbed.set_nerf_camera_matrix(
            np.asarray(frame["transform_matrix"], np.float32)[:3])
        img = testbed.render(W, H, spp=spp, linear=True)
        # sRGB-blend compat: A-over-black in linear, compare in sRGB
        pred = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
        gt = linear_to_srgb_np(np.clip(ref[..., :3], 0, 1))
        psnrs.append(mse2psnr(float(np.mean((pred - gt) ** 2))))
        ssims.append(ssim(pred, gt))
        print(f"frame {i}: psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.3f}")
    if not psnrs:
        return None
    print(f"PSNR={np.mean(psnrs):.3f} (min={np.min(psnrs):.2f} "
          f"max={np.max(psnrs):.2f}) SSIM={np.mean(ssims):.4f}")
    return float(np.mean(psnrs)), float(np.mean(ssims))


def render_screenshots(testbed, args):
    """Each (or each chosen) frame of ``--screenshot_transforms`` rendered
    at its camera and written as ``<screenshot_dir>/<stem>.png``."""
    with open(args.screenshot_transforms) as f:
        ref = json.load(f)
    outdir = Path(args.screenshot_dir or "screenshots")
    outdir.mkdir(parents=True, exist_ok=True)
    frames = ref.get("frames", [])
    if args.screenshot_frames:
        frames = [frames[int(i)] for i in args.screenshot_frames]
    W = args.width or int(ref.get("w", 1920))
    H = args.height or int(ref.get("h", 1080))
    for frame in frames:
        testbed.set_nerf_camera_matrix(
            np.asarray(frame["transform_matrix"], np.float32)[:3])
        img = testbed.render(W, H, spp=args.screenshot_spp, linear=True)
        name = Path(frame.get("file_path", "frame")).stem + ".png"
        write_image(outdir / name, img)
        print("wrote", outdir / name)


def render_video(testbed, args):
    """``--video_n_seconds`` · ``--video_fps`` frames along the camera
    path (live at ``--video_spp`` with a half-open shutter, or from the
    playback cache), written as JPEGs and encoded to ``--video_output`` by
    ffmpeg where it is installed."""
    testbed.load_camera_path(args.video_camera_path)
    n_frames = args.video_n_seconds * args.video_fps
    W = args.width or 1920
    H = args.height or 1080
    tmp = Path(args.video_output).parent / "tmp_video_frames"
    tmp.mkdir(parents=True, exist_ok=True)
    if args.video_playback:
        testbed.bake_playback()
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        if args.video_playback:
            img = testbed.render_playback(W, H, start_time=t)
        else:
            img = testbed.render(W, H, spp=args.video_spp, linear=True,
                                 start_time=t, end_time=t,
                                 fps=args.video_fps, shutter_fraction=0.5)
        write_image(tmp / f"{i:04d}.jpg", img[..., :3])
        print(f"video frame {i + 1}/{n_frames}")
    if shutil.which("ffmpeg"):
        subprocess.run(["ffmpeg", "-y", "-framerate", str(args.video_fps),
                        "-i", str(tmp / "%04d.jpg"), "-c:v", "libx264",
                        "-pix_fmt", "yuv420p", args.video_output], check=False)
        print("wrote", args.video_output)
    else:
        print("ffmpeg not found; frames left in", tmp)


if __name__ == "__main__":
    sys.exit(main())
