"""Testbed façade in NeRF, SDF, image and volume mode (port of
``ngp_tpu/api/testbed.py``; the pyngp surface, ref:
src/python_api.cu:306-888 and src/testbed.cu).

The same public attributes and per-mode namespaces (``testbed.nerf``,
``testbed.nerf.training``, ``testbed.sdf``, ``testbed.image``) as the JAX
package's Testbed; mode dispatch by file extension, the training loop,
offline rendering with the render options of the static renderer,
snapshots through the trainer, cameras, camera paths and the dataset
mutation of the Blender plugin. The GUI is absent (headless): its knobs
are stored and inert.

It runs on the card unless the caller asks for another device
(``Testbed(mode, device="cpu")``); without CUDA it raises rather than
carry on on the CPU. ``NGP_TPU_ENCODE_INT8`` selects every
trainer's int8 encode mode (``"full"``, or ``"fwd"`` for any other
non-empty value), as the JAX package's encodings read it; ``render`` in
volume mode raises ValueError, as the JAX testbed's does.

Intended divergences: ``train(n)`` runs exactly n steps; the JAX NeRF
trainer runs on to the next 16-step boundary (its image and SDF trainers
run n, as here). ``testbed.image.random_mode`` and
``testbed.sdf.mesh_sdf_mode`` take effect at every ``train`` call; the JAX
testbed reads neither (mesh_sdf_mode only when it builds the trainer).
The NeRF mesh and its PNG slices take σ only in cells the occupancy grid
holds, as the reference's get_density_on_grid does; the JAX testbed
meshes σ everywhere, floaters in unseen space included. ``bake_playback``
bakes each voxel's colour toward its nearest training camera; the JAX
testbed bakes toward the cameras' mean position, which an orbit capture
puts inside the scene, so the network is asked for colours along
directions it never saw (PERF.md has the held-out PSNR of both).
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ngp_tpu_torch.common import (BoundingBox, ColorSpace, EmaMeter,
                                  RenderMode, TestbedMode, TonemapCurve,
                                  linear_to_srgb_np, resolve_device)
from ngp_tpu_torch.config import default_config_path, load_network_config

# the reference's ELossType in enum order (common.h; pyngp LossType), by
# which the namespace's integer loss types name a loss
LOSS_TYPE_NAMES = ("L2", "L1", "Mape", "Smape", "Huber", "LogL1",
                   "RelativeL2")


def loss_type_name(loss_type) -> str:
    """A loss type as the trainers name it: a name, or an index of the
    reference's ELossType (``LOSS_TYPE_NAMES``)."""
    return loss_type if isinstance(loss_type, str) else \
        LOSS_TYPE_NAMES[int(loss_type)]


def _resample(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-index resample of (H, W, C) to (height, width, C)."""
    if img.shape[0] == height and img.shape[1] == width:
        return img.copy()
    yi = (np.arange(height) * img.shape[0] // height)
    xi = (np.arange(width) * img.shape[1] // width)
    return img[yi][:, xi].copy()


def mode_from_scene(path) -> Optional[TestbedMode]:
    """Infer the testbed mode from a path (ref: main.cu:142-150 +
    Testbed::handle_file, src/testbed.cu:163-194)."""
    p = Path(path)
    if p.is_dir() or p.suffix == ".json":
        return TestbedMode.NERF
    if p.suffix.lower() in (".obj", ".stl"):
        return TestbedMode.SDF
    if p.suffix.lower() == ".nvdb":
        return TestbedMode.VOLUME
    if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".exr", ".bin", ".bmp",
                            ".tga"):
        return TestbedMode.IMAGE
    return None  # a snapshot (.msgpack): the mode comes from the payload


def _require(tb, mode: TestbedMode, what: str):
    """Raise unless ``tb`` is in ``mode`` with a trainer built."""
    if tb.mode != mode or tb.trainer is None:
        raise ValueError(f"{what} needs a trained {mode.value} testbed, not "
                         f"{tb.mode.value} mode"
                         + ("" if tb.trainer else " without a trainer"))


def encode_int8_from_env() -> str:
    """The int8 encode mode ``NGP_TPU_ENCODE_INT8`` asks for, as the JAX
    package's blocked grid reads it (``ngp_tpu/nn/encodings.py:197-205``):
    ``"full"``, ``"fwd"`` for any other non-empty value, else ``""``."""
    mode = os.environ.get("NGP_TPU_ENCODE_INT8", "")
    return "full" if mode == "full" else "fwd" if mode else ""


class _AliasNS(SimpleNamespace):
    """Namespace with reference-parity attribute aliases: the pybind
    surface binds several legacy names onto one member (e.g.
    render_with_camera_distortion → render_with_lens_distortion,
    python_api.cu:749-757)."""

    _aliases: dict = {}

    def __getattr__(self, name):
        real = type(self)._aliases.get(name)
        if real is not None:
            return getattr(self, real)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        object.__setattr__(self, type(self)._aliases.get(name, name), value)


class _NerfNS(_AliasNS):
    _aliases = {
        "render_with_camera_distortion": "render_with_lens_distortion",
        "render_distortion": "render_lens",
        "rendering_min_transmittance": "render_min_transmittance",
    }


class _NerfTrainingNS(SimpleNamespace):
    """testbed.nerf.training: knobs + the dataset-mutation methods the
    reference binds here (python_api.cu:804-853), delegated to the owning
    Testbed."""

    def __init__(self, owner, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "_owner", owner)

    @property
    def transforms(self):
        ds = self.dataset
        return ds.xforms if ds is not None else None

    def set_camera_intrinsics(self, frame_idx: int, fx: float = 0.0,
                              fy: float = 0.0, cx: float = -0.5,
                              cy: float = -0.5, k1: float = 0.0,
                              k2: float = 0.0, p1: float = 0.0,
                              p2: float = 0.0):
        self._owner.set_camera_intrinsics(fx, fy, cx, cy, k1, k2, p1, p2,
                                          image_idx=frame_idx)

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True):
        self._owner.set_camera_extrinsics(frame_idx, camera_to_world,
                                          convert_to_ngp)

    def get_camera_extrinsics(self, frame_idx: int):
        return self._owner.get_camera_extrinsics(frame_idx)

    def set_image(self, frame_idx: int, img, depth_img=None,
                  depth_scale: float = 1.0):
        self._owner.set_image(frame_idx, img, depth_img, depth_scale)


class Testbed:
    """Drop-in orchestrator: Testbed(mode) → load_training_data →
    frame()."""

    def __init__(self, mode: TestbedMode | str = TestbedMode.NERF,
                 device="cuda"):
        if isinstance(mode, str):
            mode = TestbedMode(mode.lower())
        self.device = resolve_device(device)
        self.mode = mode
        self.network_config: dict = {}
        self.network_config_path: Optional[Path] = None
        self.trainer = None
        self.data_path: Optional[Path] = None

        # public knobs mirroring pyngp def_readwrite properties
        self.shall_train = True
        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.exposure = 0.0
        self.fov_axis = 1
        self.zoom = 1.0
        self.screen_center = np.array([0.5, 0.5], np.float32)
        self.color_space = ColorSpace.LINEAR
        self.tonemap_curve = TonemapCurve.IDENTITY
        self.render_mode = RenderMode.SHADE
        # ref: m_aperture_size / m_slice_plane_z / m_visualized_layer /
        # m_render_aabb / m_render_masks / m_scale (testbed.h)
        self.aperture_size = 0.0
        self.slice_plane_z = 0.0
        self.visualized_layer = 0
        self.render_aabb = None        # BoundingBox-like or None = training
        self.render_masks = []         # list of multi_nerf.Mask3D
        self.scale = 1.0
        self.dynamic_res = True
        self.dynamic_res_target_fps = 15.0
        self.fixed_res_factor = 1.0
        self.render_groundtruth = False
        self.groundtruth_render_mode = 0
        self.ground_truth_alpha = 1.0   # ref: m_ground_truth_alpha
        self.snap_to_pixel_centers = False
        self.render_near_distance = 0.0
        self.camera_matrix = np.eye(4, dtype=np.float32)[:3]
        self.camera_path = None
        self.training_batch_size = 1 << 18
        self.camera_smoothing = False
        self.autofocus = False
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)

        # remaining pyngp readwrite surface (ref: python_api.cu:650-732);
        # GUI-bound knobs are stored but headless-inert, DLSS pinned off
        self.autofocus_target = np.zeros(3, np.float32)
        self.floor_enable = False
        self.visualize_unit_cube = False
        self.parallax_shift = np.zeros(3, np.float32)   # ref: testbed.h:892
        # the views of a VR / lenticular quilt (ref: apply_quilting's
        # quilting_dims); (2, 1) is stereo VR. Not a JAX testbed attribute:
        # the JAX testbed renders neither it nor the parallax shift
        self.quilting_dims = (1, 1)
        self.max_level_rand_training = False
        self.visualized_dimension = -1
        self.shall_train_encoding = True
        self.shall_train_network = True
        self.render_camera_model = 0                    # Perspective
        self.camera_spherical_quadrilateral = None
        self.camera_quadrilateral_hexahedron = None
        self.loop_animation = False
        self.display_gui = False
        self.dlss = False
        self.dlss_sharpening = 0.0
        self.keyboard_event_callback = None
        self.render_aabb_to_local = np.eye(3, dtype=np.float32)
        self.aabb = BoundingBox()              # refreshed from the trainer
        self.raw_aabb = BoundingBox()
        self.bounding_radius = 1.0
        # ref: m_relative_focal_length (resolution-relative; fov/fov_xy
        # convert, testbed.cu:2153-2167)
        self.relative_focal_length = np.ones(2, np.float32)
        self._training_view = 0

        # per-mode namespaces; attribute/alias sets mirror the reference
        # pybind surface (python_api.cu:744-888)
        self.nerf = _NerfNS(
            training=_NerfTrainingNS(
                self,
                random_bg_color=True, linear_colors=False,
                # indices of the reference's ELossType (LOSS_TYPE_NAMES);
                # depth_loss_type L1 as in the reference (testbed.h:654;
                # the JAX testbed's 0, L2, is never read)
                loss_type=2, depth_loss_type=1,
                snap_to_pixel_centers=False, optimize_extrinsics=False,
                optimize_exposure=False, optimize_extra_dims=False,
                optimize_distortion=False, optimize_focal_length=False,
                n_steps_between_cam_updates=16, near_distance=0.2,
                density_grid_decay=0.95, depth_supervision_lambda=0.0,
                sample_image_proportional_to_error=False,
                sample_focal_plane_proportional_to_error=False,
                include_sharpness_in_error=False,
                extrinsic_l2_reg=1e-4, extrinsic_learning_rate=1e-3,
                intrinsic_l2_reg=1e-4, exposure_l2_reg=0.0,
                render_error_overlay=False,
                error_overlay_brightness=0.125,
                n_images_for_training=0, dataset=None,
                world_scale=None, world_offset=None),
            rgb_activation=3, density_activation=2,  # Sigmoid / Exponent
            sharpen=0.0, visualize_cameras=False,
            render_with_lens_distortion=False,
            render_lens=None,
            render_min_transmittance=1e-4,
            glow_mode=0, glow_y_cutoff=0.0,
            cone_angle_constant=1.0 / 256.0)
        self.sdf = SimpleNamespace(
            training=SimpleNamespace(generate_sdf_data_online=True,
                                     surface_offset_scale=1.0),
            mesh_sdf_mode=1, mesh_scale=1.0, analytic_normals=False,
            shadow_sharpness=2048.0, fd_normals_epsilon=1e-3,
            use_triangle_octree=False, brick_level=10, brick_res=0,
            zero_offset=0.0, distance_scale=1.0,
            calculate_iou_online=False, groundtruth_mode=0,
            brdf=SimpleNamespace(metallic=0.0, subsurface=0.0, specular=1.0,
                                 roughness=0.5, sheen=0.0, clearcoat=0.0,
                                 clearcoat_gloss=0.0,
                                 basecolor=np.array([0.8, 0.8, 0.8]),
                                 ambientcolor=np.zeros(3)))
        self.image = SimpleNamespace(
            training=SimpleNamespace(snap_to_pixel_centers=True,
                                     linear_colors=False),
            random_mode="stratified", pos=np.array([0.5, 0.5]))

        self._frame_ms = EmaMeter(0.5)
        self._loss_graph = []          # ref: 256-point loss graph
        self._loss_ema = EmaMeter(1.0)
        self._renderer_cache = {}

    # -- data + network --------------------------------------------------

    @property
    def training_step(self) -> int:
        return self.trainer.training_step if self.trainer else 0

    def load_training_data(self, path):
        """Dispatch by extension (ref: Testbed::load_training_data
        src/testbed.cu:97 + handle_file :163-194)."""
        inferred = mode_from_scene(path)
        if inferred is not None:
            self.mode = inferred
        self.data_path = Path(path)
        if not self.network_config:
            self.reload_network_from_file(default_config_path(self.mode.value))
        else:
            self._build_trainer()

    def reload_network_from_file(self, path):
        self.network_config_path = Path(path)
        self.reload_network_from_json(load_network_config(path))

    def reload_network_from_json(self, config: dict):
        self.network_config = config
        if self.data_path is not None:
            self._build_trainer()

    def _build_trainer(self):
        self._renderer_cache = {}
        int8 = encode_int8_from_env()
        if self.mode == TestbedMode.IMAGE:
            from ngp_tpu_torch.data.image_io import read_image
            from ngp_tpu_torch.train.image import ImageTrainer
            self.trainer = ImageTrainer(read_image(self.data_path),
                                        self.network_config,
                                        batch_size=self.training_batch_size,
                                        device=self.device, encode_int8=int8)
            return
        if self.mode == TestbedMode.SDF:
            from ngp_tpu_torch.train.sdf import SdfTrainer
            self.trainer = SdfTrainer(self.data_path, self.network_config,
                                      batch_size=self.training_batch_size,
                                      sign_mode=int(self.sdf.mesh_sdf_mode),
                                      device=self.device, encode_int8=int8)
            self.sdf.mesh_scale = self.trainer.mesh_scale
            return
        if self.mode == TestbedMode.VOLUME:
            from ngp_tpu_torch.train.volume import VolumeTrainer
            self.trainer = VolumeTrainer(self.data_path, self.network_config,
                                         batch_size=self.training_batch_size,
                                         device=self.device,
                                         encode_int8=int8)
            return
        from ngp_tpu_torch.data.nerf_loader import load_nerf
        from ngp_tpu_torch.train.nerf import NerfTrainer, NerfTrainerConfig
        t = self.nerf.training
        if self.data_path is None and t.dataset is not None:
            # in-memory dataset (create_empty_nerf_dataset + set_image —
            # the Blender plugin flow, ref: python_api.cu:545)
            ds = t.dataset
        else:
            ds = load_nerf(self.data_path, scale=t.world_scale,
                           offset=t.world_offset)
        tcfg = NerfTrainerConfig(
            target_batch_size=self.training_batch_size,
            random_bg_color=t.random_bg_color,
            train_in_linear_colors=t.linear_colors,
            near_distance=t.near_distance,
            density_grid_decay=t.density_grid_decay,
            n_steps_between_grid_updates=16,
            snap_to_pixel_centers=t.snap_to_pixel_centers,
            depth_supervision_lambda=t.depth_supervision_lambda,
            depth_loss_type=loss_type_name(t.depth_loss_type),
            optimize_extrinsics=t.optimize_extrinsics,
            optimize_exposure=t.optimize_exposure,
            optimize_focal_length=t.optimize_focal_length,
            optimize_extra_dims=t.optimize_extra_dims,
            optimize_distortion=t.optimize_distortion,
            sample_image_proportional_to_error=(
                t.sample_image_proportional_to_error),
            sample_focal_plane_proportional_to_error=(
                t.sample_focal_plane_proportional_to_error),
            # the grid sweep through the int8-table encode (K4), as the JAX
            # trainer reads NGP_TPU_GRID_INT8, and the training encode's
            # int8 mode, as its encoding reads NGP_TPU_ENCODE_INT8
            grid_int8=bool(os.environ.get("NGP_TPU_GRID_INT8")),
            encode_int8=int8)
        # the JAX testbed's CPU-scale escape hatches
        if os.environ.get("NGP_TPU_BATCH"):
            tcfg.target_batch_size = int(os.environ["NGP_TPU_BATCH"])
        if os.environ.get("NGP_TPU_MARCH_STEPS"):
            tcfg.march_steps = int(os.environ["NGP_TPU_MARCH_STEPS"])
        self.trainer = NerfTrainer(ds, self.network_config, tcfg=tcfg,
                                   device=self.device)
        t.dataset = ds
        t.n_images_for_training = ds.n_images
        if ds.render_aabb is not None:
            # dataset-provided crop box (ref: nerf_loader.cu:455-458 →
            # m_render_aabb)
            self.render_aabb = SimpleNamespace(min=ds.render_aabb[0],
                                               max=ds.render_aabb[1])
        self.set_camera_to_training_view(0)
        tr = self.trainer
        mn = np.asarray(tr.aabb_min, np.float32) * np.ones(3, np.float32)
        mx = mn + np.asarray(tr.aabb_size, np.float32)
        self.aabb = BoundingBox(mn, mx)
        self.raw_aabb = BoundingBox(mn, mx)
        self.bounding_radius = float(np.linalg.norm(self.aabb.diag()) / 2.0)

    # -- training loop ----------------------------------------------------

    def frame(self) -> bool:
        """One iteration of the train loop (ref: Testbed::frame,
        src/testbed.cu:2044; headless → no render unless asked)."""
        t0 = time.time()
        can_lazy_build = (self.network_config
                          and self.nerf.training.dataset is not None)
        if self.shall_train and (self.trainer is not None or can_lazy_build):
            self.train(1)
        self._frame_ms.update((time.time() - t0) * 1e3)
        return True

    def train(self, n_steps: int = 1) -> float:
        """Train exactly ``n_steps`` steps; returns the trainer's loss."""
        if self.trainer is None and self.network_config and \
                self.nerf.training.dataset is not None:
            self._build_trainer()
        if self.mode == TestbedMode.IMAGE:
            self.trainer.random_mode = self.image.random_mode
        elif self.mode == TestbedMode.SDF:
            self.trainer.sign_mode = int(self.sdf.mesh_sdf_mode)
        loss = self.trainer.train(n_steps)
        self._loss_ema.update(loss)
        self._loss_graph.append(loss)
        if len(self._loss_graph) > 256:
            self._loss_graph = self._loss_graph[-256:]
        return loss

    @property
    def loss_graph(self):
        return list(self._loss_graph)

    @property
    def loss(self) -> float:
        return getattr(self.trainer, "last_loss", 0.0)

    # -- cameras ------------------------------------------------------------

    def _dataset_mapping(self):
        """(scale, offset) of the dataset's world mapping, identity when
        there is no dataset."""
        ds = self.nerf.training.dataset
        if ds is None:
            return 1.0, np.zeros(3, np.float32)
        return ds.scale, np.asarray(ds.offset)

    def set_nerf_camera_matrix(self, m: np.ndarray):
        """Accepts a NeRF-convention 3x4 (ref: pyngp
        set_nerf_camera_matrix)."""
        from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp
        self.camera_matrix = nerf_matrix_to_ngp(
            np.asarray(m, np.float32), *self._dataset_mapping())

    def set_camera_matrix(self, m: np.ndarray):
        self.camera_matrix = np.asarray(m, np.float32)[:3, :4]

    def set_camera_to_training_view(self, i: int):
        ds = self.nerf.training.dataset
        if ds is not None:
            i = int(i) % ds.n_images
            self._training_view = i
            self.camera_matrix = ds.xforms[i]
            self._view_focal = ds.focal[i]
            self._view_res = ds.resolution[i]
            self.relative_focal_length = (
                np.asarray(ds.focal[i], np.float32) /
                float(ds.resolution[i][self.fov_axis]))

    def first_training_view(self):
        self.set_camera_to_training_view(0)

    def last_training_view(self):
        ds = self.nerf.training.dataset
        if ds is not None:
            self.set_camera_to_training_view(ds.n_images - 1)

    def previous_training_view(self):
        self.set_camera_to_training_view(self._training_view - 1)

    def next_training_view(self):
        self.set_camera_to_training_view(self._training_view + 1)

    # -- camera helpers (ref: testbed.cu:215-247, 2153-2167) --------------

    @property
    def dof(self):
        return self.aperture_size

    @dof.setter
    def dof(self, v):
        self.aperture_size = float(v)

    @property
    def fov(self) -> float:
        return float(np.degrees(2.0 * np.arctan(
            0.5 / self.relative_focal_length[self.fov_axis])))

    @fov.setter
    def fov(self, val: float):
        self.relative_focal_length = np.full(
            2, 0.5 / np.tan(np.radians(val) / 2.0), np.float32)

    @property
    def fov_xy(self):
        return np.degrees(2.0 * np.arctan(0.5 / self.relative_focal_length))

    @fov_xy.setter
    def fov_xy(self, val):
        v = np.radians(np.asarray(val, np.float32))
        self.relative_focal_length = (0.5 / np.tan(v / 2.0)).astype(
            np.float32)

    def view_pos(self):
        return np.asarray(self.camera_matrix, np.float32)[:3, 3].copy()

    @property
    def view_dir(self):
        return np.asarray(self.camera_matrix, np.float32)[:3, 2].copy()

    @view_dir.setter
    def view_dir(self, d):
        old = self.look_at
        d = np.asarray(d, np.float32)
        d = d / max(float(np.linalg.norm(d)), 1e-12)
        right = np.cross(d, self.up_dir)
        right = right / max(float(np.linalg.norm(right)), 1e-12)
        down = np.cross(d, right)
        down = down / max(float(np.linalg.norm(down)), 1e-12)
        m = np.array(self.camera_matrix, np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2] = right, down, d
        self.camera_matrix = m
        self.look_at = old

    @property
    def look_at(self):
        return self.view_pos() + self.view_dir * self.scale

    @look_at.setter
    def look_at(self, pos):
        m = np.array(self.camera_matrix, np.float32)
        m[:3, 3] += np.asarray(pos, np.float32) - self.look_at
        self.camera_matrix = m

    # -- crop box (ref: testbed.cu:395-449) --------------------------------

    def _crop_aabb(self) -> BoundingBox:
        if self.render_aabb is None:
            return BoundingBox(self.aabb.min, self.aabb.max)
        return BoundingBox(self.render_aabb.min, self.render_aabb.max)

    def crop_box(self, nerf_space: bool = True) -> np.ndarray:
        box = self._crop_aabb()
        to_local = np.asarray(self.render_aabb_to_local, np.float32)
        cen = to_local.T @ box.center()
        radius = box.diag() * 0.5
        rv = np.empty((3, 4), np.float32)
        rv[:, 0] = to_local[0] * radius[0]
        rv[:, 1] = to_local[1] * radius[1]
        rv[:, 2] = to_local[2] * radius[2]
        rv[:, 3] = cen
        if nerf_space:
            from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
            rv = ngp_matrix_to_nerf(rv, *self._dataset_mapping(),
                                    scale_columns=True)
        return rv

    def set_crop_box(self, matrix, nerf_space: bool = True):
        m = np.asarray(matrix, np.float32)[:3, :4]
        if nerf_space:
            from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp
            m = nerf_matrix_to_ngp(m, *self._dataset_mapping(),
                                   scale_columns=True)
        radius = np.linalg.norm(m[:, :3], axis=0)
        to_local = (m[:, :3] / np.maximum(radius, 1e-12)).T
        cen = to_local @ m[:, 3]
        self.render_aabb_to_local = to_local
        self.render_aabb = SimpleNamespace(min=cen - radius,
                                           max=cen + radius)

    def crop_box_corners(self, nerf_space: bool = True):
        m = self.crop_box(nerf_space)
        return [m[:, :3] @ np.array([(i >> k & 1) * 2 - 1.0
                                     for k in range(3)], np.float32)
                + m[:, 3] for i in range(8)]

    # -- frozen-model playback ------------------------------------------

    def bake_playback(self, D: int = 256, D_inner: int = 512,
                      path: str = ""):
        """Distill the trained NeRF into the dense playback cache
        (render/playback.py) for camera-path frames without the live
        network (ref: docs/index.html:317); saved to ``path`` if given.
        Each voxel's colour is baked toward its nearest training camera
        (``ref_eye="nearest"``)."""
        from ngp_tpu_torch.render.playback import (bake_playback_cache,
                                                   save_playback_cache)
        _require(self, TestbedMode.NERF, "bake_playback")
        self._playback_cache = bake_playback_cache(
            self.trainer, D=D, D_inner=D_inner, ref_eye="nearest")
        self._playback_renderers = {}
        if path:
            save_playback_cache(path, self._playback_cache)

    def load_playback(self, path: str):
        """A playback cache saved by either package, onto this testbed's
        device."""
        from ngp_tpu_torch.render.playback import load_playback_cache
        self._playback_cache = load_playback_cache(path, self.device)
        self._playback_renderers = {}

    def render_playback(self, width: int, height: int,
                        start_time: float = -1.0) -> np.ndarray:
        """Camera-path frame from the playback cache (pinhole + OpenCV
        lens; DoF and rolling-shutter frames need ``render``), baked first
        if there is none."""
        from ngp_tpu_torch.render.playback import (PlaybackOptions,
                                                   PlaybackRenderer)
        if getattr(self, "_playback_cache", None) is None:
            self.bake_playback()
        if start_time >= 0.0 and self.camera_path is not None:
            kf = self.camera_path.eval(start_time)
            self.camera_matrix = kf.to_matrix()
        ds = self.nerf.training.dataset
        lens = (0.0, 0.0, 0.0, 0.0)
        lmode = "perspective"
        principal = (0.5, 0.5)
        if ds is not None:
            if self.nerf.render_with_lens_distortion and ds.lens_is_opencv:
                lens = tuple(float(x) for x in ds.lens_params[0][:4])
                lmode = "opencv"
            if getattr(ds, "principal", None) is not None:
                principal = tuple(float(x) for x in ds.principal[0])
        key = (width, height, lens, lmode, principal,
               tuple(self.background_color))
        r = self._playback_renderers.get(key)
        if r is None:
            r = PlaybackRenderer(self._playback_cache, PlaybackOptions(
                width=width, height=height, principal=principal,
                lens_params=lens, lens_mode=lmode,
                background=tuple(float(c) for c in self.background_color),
                linear_out=True))
            self._playback_renderers[key] = r
        focal = getattr(self, "_view_focal", np.array([height, height]))
        return r.render(self.camera_matrix, width, height,
                        focal=(float(focal[0]), float(focal[1])))

    # -- rendering ----------------------------------------------------------

    def render(self, width: int, height: int, spp: int = 1,
               linear: bool = True, start_time: float = -1.0,
               end_time: float = -1.0, fps: float = 30.0,
               shutter_fraction: float = 1.0) -> np.ndarray:
        """Offline frame render → (H, W, 4) float32 numpy, matching
        render_to_cpu (ref: src/python_api.cu:132-189) incl. camera-path
        animation via start/end time + log-space motion-blur endpoints."""
        if start_time >= 0.0 and self.camera_path is not None:
            kf = self.camera_path.eval(start_time)
            self.camera_matrix = kf.to_matrix()
        if self.mode == TestbedMode.IMAGE:
            img = self.trainer.render(width, height, linear=linear)
            return np.concatenate([img, np.ones_like(img[..., :1])], -1)
        if self.mode == TestbedMode.SDF:
            return self._sdf_frame(width, height)
        if self.mode == TestbedMode.VOLUME:
            # the JAX testbed renders no volume frame either; the engine's
            # frames come from render/volume_render.VolumeRenderer
            raise ValueError(f"render unsupported for mode {self.mode}")
        if self.render_groundtruth:
            return self._groundtruth_frame(width, height, spp, linear)
        p = self.trainer.inference_params()
        bitfield = self.trainer.grid.bitfield
        focal = getattr(self, "_view_focal", np.array([height, height]))
        focal = (float(focal[0]), float(focal[1]))
        renderer = self._nerf_renderer(width, height)
        start_cam = np.asarray(self.camera_matrix, np.float32)
        # camera-path motion blur: per-spp log-space interpolation of the
        # frame's start/end cameras (ref: render_to_cpu,
        # src/python_api.cu:162-178)
        animated = (start_time >= 0.0 and self.camera_path is not None
                    and end_time >= 0.0 and (end_time != start_time
                                             or shutter_fraction > 0.0))
        if animated and shutter_fraction > 0.0:
            from ngp_tpu_torch.io.camera_path import log_space_lerp
            end_cam = self.camera_path.eval(end_time).to_matrix()
            n = max(spp, 1)
            acc = None
            for i in range(n):
                cam_s = log_space_lerp(start_cam, end_cam,
                                       i / n * shutter_fraction)
                cam_e = log_space_lerp(start_cam, end_cam,
                                       (i + 1) / n * shutter_fraction)
                f = renderer.render(p, bitfield, cam_s, width, height,
                                    focal=focal, spp=1, seed=i,
                                    camera_matrix_end=cam_e,
                                    rolling_shutter=(0.0, 0.0, 0.0, 1.0))
                acc = f if acc is None else acc + f
            img = acc / n
            self.camera_matrix = end_cam
        else:
            img = renderer.render(p, bitfield, start_cam, width, height,
                                  focal=focal, spp=spp)
        img = img.cpu().numpy()
        if not linear:
            rgb = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
            img = np.concatenate([rgb, img[..., 3:]], -1).astype(np.float32)
        return img

    def _sdf_frame(self, width: int, height: int) -> np.ndarray:
        """The SDF renderer's frame at the camera (focal = height, as the
        JAX testbed renders), with the namespace's normals mode and
        distance scale."""
        from ngp_tpu_torch.render.sdf_render import (SdfRenderer,
                                                     SdfRenderOptions)
        opts = SdfRenderOptions(
            width=width, height=height, focal=height * 1.0,
            analytic_normals=bool(self.sdf.analytic_normals),
            distance_scale=float(self.sdf.distance_scale),
            encode_int8=self.trainer.encode_int8)
        return SdfRenderer(self.trainer.model, opts).render(
            self.trainer.inference_params(), self.camera_matrix, width,
            height)

    def _groundtruth_frame(self, width, height, spp, linear):
        """GT overlay (ref: overlay_image/overlay_depth,
        src/testbed.cu:2856-2885): the training image of the nearest view
        (with exposure), alpha-blended over the render."""
        ds = self.nerf.training.dataset
        d = np.linalg.norm(ds.xforms[:, :, 3] - self.camera_matrix[:, 3][None],
                           axis=1)
        view = int(np.argmin(d))
        if int(self.groundtruth_render_mode) == 1 and \
                ds.depth_images is not None:       # Depth GT
            dep = ds.depth_images[view].astype(np.float32)
            dep = _resample(dep[..., None], height, width)
            img = np.concatenate([np.repeat(dep, 3, -1),
                                  np.ones_like(dep)], -1)
        else:
            img = _resample(np.asarray(ds.images[view], np.float32),
                            height, width)
            img[..., :3] *= 2.0 ** self.exposure
        a = float(self.ground_truth_alpha)
        if a < 1.0:
            under = self.render_groundtruth_off_frame(width, height, spp,
                                                      linear)
            img = a * img + (1.0 - a) * under
        if self.nerf.training.render_error_overlay:
            img[..., :3] = self._error_overlay(view, height, width)
        return img

    def render_groundtruth_off_frame(self, width, height, spp, linear):
        """The plain render, used as the blend base for ground_truth_alpha
        < 1 (ref: overlay alpha blending)."""
        prev = self.render_groundtruth
        self.render_groundtruth = False
        try:
            return self.render(width, height, spp=spp, linear=linear)
        finally:
            self.render_groundtruth = prev

    def _error_overlay(self, view: int, height: int, width: int):
        """False-color overlay of the accumulated error map
        (ref: overlay_false_color, src/testbed.cu:2888-2907)."""
        err = self.trainer.error_map[view].cpu().numpy().astype(np.float32)
        avg = max(float(np.maximum(err, 0).mean()), 1e-12)
        bright = float(self.nerf.training.error_overlay_brightness)
        v = np.clip(err / avg * bright, 0.0, 1.0)
        v = _resample(v[..., None], height, width)[..., 0]
        # blue → green → red heat ramp
        return np.stack([np.clip(2 * v - 1, 0, 1), 1.0 - np.abs(2 * v - 1),
                         np.clip(1 - 2 * v, 0, 1)], -1)

    def _nerf_renderer(self, width: int, height: int):
        """Renderer cache keyed by the option set. A renderer holds the
        trainer's model, whose parameters ``load_snapshot`` and ``params``
        overwrite in place, and gets the parameters and the bitfield at
        every call, so a cached renderer stays valid until the trainer is
        rebuilt (which empties the cache)."""
        from ngp_tpu_torch.render.multi_nerf import masks_key
        from ngp_tpu_torch.render.nerf_render import (NerfRenderer,
                                                      RenderOptions)
        ds = self.nerf.training.dataset
        lmode = getattr(ds, "lens_mode", "perspective") \
            if ds is not None else "perspective"
        if lmode in ("ftheta", "latlong"):
            # non-perspective models always render with their lens
            lens = tuple(float(x) for x in ds.lens_params[0])
        elif ds is not None and self.nerf.render_with_lens_distortion \
                and ds.lens_is_opencv:
            lens = tuple(float(x) for x in ds.lens_params[0][:4])
            lmode = "opencv"
        else:
            lens = (0.0, 0.0, 0.0, 0.0)
            lmode = "perspective"
        ra_min = ra_max = None
        if self.render_aabb is not None:
            ra_min = tuple(float(x) for x in self.render_aabb.min)
            ra_max = tuple(float(x) for x in self.render_aabb.max)
        # dataset principal point (ref: m_screen_center from
        # dataset.principal_point, src/testbed_nerf.cu:2698)
        principal = (0.5, 0.5)
        if ds is not None and getattr(ds, "principal", None) is not None:
            principal = tuple(float(x) for x in ds.principal[0])
        opts = RenderOptions(
            width=width, height=height,
            # march what training marched: a renderer marching further
            # than the trainer integrates σ in never-supervised range
            march_steps=int(self.trainer.tcfg.march_steps),
            fov_axis_focal=getattr(self, "_view_focal", [height, height])[0],
            principal=principal,
            background=tuple(float(c) for c in self.background_color),
            linear_out=True, lens_params=lens,
            min_transmittance=self.nerf.render_min_transmittance,
            render_mode=self.render_mode,
            snap_to_pixel_centers=bool(self.snap_to_pixel_centers),
            exposure=float(self.exposure),
            tonemap_curve=self.tonemap_curve,
            aperture_size=float(self.aperture_size),
            # ref: render_nerf passes m_slice_plane_z + m_scale as focus_z
            focus_z=float(self.slice_plane_z) + float(self.scale),
            render_aabb_min=ra_min, render_aabb_max=ra_max,
            slice_plane_z=float(self.slice_plane_z),
            visualized_level=int(self.visualized_layer),
            glow_mode=int(self.nerf.glow_mode),
            glow_y_cutoff=float(self.nerf.glow_y_cutoff),
            lens_mode=lmode,
            parallax_shift=tuple(float(x) for x in self.parallax_shift),
            quilting_dims=tuple(int(q) for q in self.quilting_dims))
        key = (opts.render_mode, opts.snap_to_pixel_centers, opts.exposure,
               opts.tonemap_curve, opts.background, opts.lens_params,
               opts.min_transmittance, ra_min, ra_max, opts.aperture_size,
               opts.focus_z, opts.slice_plane_z, opts.visualized_level,
               opts.glow_mode, opts.glow_y_cutoff, opts.lens_mode,
               opts.principal, opts.march_steps, opts.parallax_shift,
               opts.quilting_dims,
               # intended divergence: the JAX testbed's key leaves the
               # masks out, so a render after a change to render_masks
               # reuses the renderer built with the old ones
               masks_key(list(self.render_masks or [])))
        if key not in self._renderer_cache:
            env = None
            if ds is not None and ds.envmap is not None:
                # the dataset's envmap as the background (ref: envmap read
                # in composite, envmap.cuh:30-105)
                from ngp_tpu_torch.nn.trainable_buffer import Envmap
                env_t = torch.as_tensor(ds.envmap, dtype=torch.float32,
                                        device=self.trainer.device)
                sampler = Envmap(*ds.envmap.shape[:2])

                def env(d):
                    return sampler.sample(env_t, d)
            dist = None
            if "distortion" in self.trainer.cam_params:
                tr = self.trainer

                def dist(uv):
                    return tr.distortion.sample(tr.cam_params["distortion"],
                                                uv)
            self._renderer_cache[key] = NerfRenderer.for_trainer(
                self.trainer, opts, masks=list(self.render_masks or []),
                envmap_sampler=env, distortion_sampler=dist)
        return self._renderer_cache[key]

    def render_dynamic(self, width: int, height: int) -> np.ndarray:
        """Dynamic-resolution render: scale resolution to hit
        dynamic_res_target_fps (ref: dynamic-res logic src/testbed.cu:
        1706-1732), then upsample to the requested size."""
        factor = self.fixed_res_factor if not self.dynamic_res else \
            getattr(self, "_dyn_factor", 1.0)
        w = max(int(width * factor) // 16 * 16, 32)
        h = max(int(height * factor) // 16 * 16, 32)
        t0 = time.time()
        img = self.render(w, h, spp=1)
        dt = time.time() - t0
        if self.dynamic_res and dt > 0:
            adj = np.sqrt((1.0 / dt) / self.dynamic_res_target_fps)
            self._dyn_factor = float(np.clip(factor * adj, 1 / 16, 1.0))
        yi = (np.arange(height) * h // height)
        xi = (np.arange(width) * w // width)
        return img[yi][:, xi]

    def screenshot(self, path, width: int = 1920, height: int = 1080,
                   spp: int = 1):
        from ngp_tpu_torch.data.image_io import save_stbi
        img = self.render(width, height, spp=spp, linear=True)
        save_stbi(path, img, from_linear=True)

    # -- eval ----------------------------------------------------------------

    def compute_image_mse(self, quantize_to_byte: bool = False) -> float:
        _require(self, TestbedMode.IMAGE, "compute_image_mse")
        return self.trainer.compute_mse(quantize_to_byte)

    def calculate_iou(self, n_samples: int = 128 * 1024 * 1024,
                      scale_existing_results_factor: float = 0.0,
                      blocks: int = 1, mode=None) -> float:
        """Sign-agreement IoU at the reference's sample count (ref:
        src/testbed_sdf.cu:1269; the trainer evaluates in blocks)."""
        _require(self, TestbedMode.SDF, "calculate_iou")
        return self.trainer.calculate_iou(n_samples=int(n_samples))

    def gather_histograms(self):
        """Per-hash-level parameter statistics (mean/|mean|/std/min/max) —
        the headless counterpart of the GUI's encoding histograms (ref:
        Testbed::gather_histograms, src/testbed.cu:2962-3006). A list of
        dicts, one per grid level."""
        if self.trainer is None:
            return []
        name = next((k for k in ("pos_encoding.table", "encoding.table")
                     if k in self.trainer.params), None)
        if name is None:    # an encoding without a table
            return []
        arr = self.trainer.params[name].detach().cpu().numpy()

        def stats(x):
            x = x.astype(np.float64).ravel()
            return {"mean": float(x.mean()),
                    "abs_mean": float(np.abs(x).mean()),
                    "std": float(x.std()), "min": float(x.min()),
                    "max": float(x.max()), "n": int(x.size)}
        if arr.ndim != 3:   # a flat tcnn-layout table
            return [{"level": 0, **stats(arr)}]
        return [{"level": lv, **stats(arr[lv])} for lv in range(arr.shape[0])]

    # -- snapshot / camera path ----------------------------------------------

    def save_snapshot(self, path, include_optimizer_state: bool = False):
        self.trainer.save_snapshot(
            path, self.network_config,
            include_optimizer_state=include_optimizer_state)

    def load_snapshot(self, path):
        """Load a snapshot of either package; the trainer is built first
        when a scene is loaded and none exists yet. Parameters are
        overwritten in place."""
        from ngp_tpu_torch.io.snapshot import load_snapshot
        doc = load_snapshot(path)
        self.network_config = {k: v for k, v in doc.items()
                               if k != "snapshot"}
        if self.trainer is None and self.data_path is not None:
            self._build_trainer()
        if self.trainer is None:
            return
        self.trainer.load_snapshot_state(path)

    def load_camera_path(self, path):
        from ngp_tpu_torch.io.camera_path import CameraPath
        self.camera_path = CameraPath.load(path)

    # -- per-image camera + dataset mutation (pyngp parity) -----------------

    def set_camera_intrinsics(self, fx: float, fy: float = 0.0,
                              cx: float = -1.0, cy: float = -1.0,
                              k1: float = 0.0, k2: float = 0.0,
                              p1: float = 0.0, p2: float = 0.0,
                              image_idx: int = -1):
        """ref: pyngp Nerf.Training.set_camera_intrinsics."""
        ds = self.nerf.training.dataset
        sel = slice(None) if image_idx < 0 else slice(image_idx, image_idx + 1)
        ds.focal[sel] = [fx, fy or fx]
        if cx >= 0:
            res = ds.resolution[sel].astype(np.float32)
            ds.principal[sel] = np.stack([cx / res[:, 0], cy / res[:, 1]], -1)
        ds.lens_params[sel, :4] = [k1, k2, p1, p2]
        if self.trainer is not None:
            self.trainer.refresh_cameras()

    def set_camera_extrinsics(self, image_idx: int, matrix: np.ndarray,
                              convert_to_ngp: bool = True):
        """ref: pyngp Nerf.Training.set_camera_extrinsics, which sets the
        frame's start and end transforms. Intended divergence: the JAX
        testbed sets the start only, so a dataset from
        ``create_empty_nerf_dataset`` (end = identity) trains with a rolling
        shutter towards the identity there."""
        from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp
        ds = self.nerf.training.dataset
        m = np.asarray(matrix, np.float32)[:3, :4]
        if convert_to_ngp:
            m = nerf_matrix_to_ngp(m, ds.scale, ds.offset)
        ds.xforms[image_idx] = m
        if ds.xforms_end is not None:
            ds.xforms_end[image_idx] = m
        if self.trainer is not None:
            self.trainer.refresh_cameras()

    def get_camera_extrinsics(self, image_idx: int,
                              convert_from_ngp: bool = True) -> np.ndarray:
        from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
        ds = self.nerf.training.dataset
        if self.trainer is not None:
            m = self.trainer.get_camera_extrinsics(image_idx)
        else:
            m = ds.xforms[image_idx]
        return ngp_matrix_to_nerf(m, ds.scale, ds.offset) \
            if convert_from_ngp else m

    def set_image(self, image_idx: int, image: np.ndarray,
                  depth: np.ndarray = None, depth_scale: float = 1.0):
        """Replace a training image in place (ref: pyngp set_image), and
        its depth map when ``depth`` is given (stored as depth ·
        ``depth_scale``, the reference's set_training_image); the trainer's
        pools are uploaded again. The JAX testbed ignores ``depth``."""
        ds = self.nerf.training.dataset
        if depth is not None:
            if ds.depth_images is None:
                ds.depth_images = np.zeros(np.asarray(ds.images).shape[:3],
                                           np.float32)
            d = np.asarray(depth, np.float32)
            d = d.reshape(d.shape[:2])
            ds.depth_images[image_idx, : d.shape[0], : d.shape[1]] = \
                d * np.float32(depth_scale)
        if not isinstance(ds.images, np.ndarray):
            ds.images = np.asarray(ds.images)   # materialize a lazy view
        ds.images[image_idx, : image.shape[0], : image.shape[1]] = image
        # a float edit no longer round-trips to the uint8 copy
        ds.images_u8 = None
        if self.trainer is not None:
            self.trainer.refresh_images()

    def create_empty_nerf_dataset(self, n_images: int, aabb_scale: int = 1,
                                  is_hdr: bool = False, width: int = 64,
                                  height: int = 64):
        """ref: pyngp create_empty_nerf_dataset — a dataset to be filled
        with set_image/set_camera_* before training."""
        from ngp_tpu_torch.data.nerf_loader import NerfDataset
        eye = np.tile(np.eye(4, dtype=np.float32)[:3][None], (n_images, 1, 1))
        ds = NerfDataset(
            images=np.zeros((n_images, height, width, 4), np.float32),
            xforms=eye.copy(), xforms_end=eye.copy(),
            focal=np.full((n_images, 2), float(height), np.float32),
            principal=np.full((n_images, 2), 0.5, np.float32),
            resolution=np.tile(np.asarray([[width, height]], np.int32),
                               (n_images, 1)),
            lens_params=np.zeros((n_images, 4), np.float32),
            lens_is_opencv=False, depth_images=None,
            aabb_scale=aabb_scale, scale=1.0,
            offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
            sharpness=np.ones(n_images, np.float32), paths=[],
            up=np.asarray([0, 0, 1.0], np.float32))
        self.mode = TestbedMode.NERF
        self.nerf.training.dataset = ds
        return ds

    # -- mesh / slice exports ------------------------------------------------

    def _mesh_field(self, res: int) -> np.ndarray:
        """The field a mesh is cut from, (res, res, res) on the host: the
        SDF's distance on the unit cube's voxel centres, or the NeRF's σ
        on the AABB's where the occupancy grid holds the cell (see
        ``NerfTrainer.sigma_at``)."""
        from ngp_tpu_torch.render.mesh_export import density_field_on_grid
        tr = self.trainer
        if self.mode == TestbedMode.SDF:
            return density_field_on_grid(tr.distance, res, device=tr.device)
        return density_field_on_grid(
            lambda p: tr.sigma_at(p, occupied_only=True), res,
            float(tr.aabb_min), float(tr.aabb_size), device=tr.device)

    def compute_marching_cubes_mesh(self, resolution=(256, 256, 256),
                                    thresh: float = 2.5):
        """ref: pyngp compute_marching_cubes_mesh → {"V", "N", "C", "F"}:
        marching tetrahedra at distance 0 in SDF mode; in NeRF mode
        marching cubes at σ ``thresh``, smoothed once, coloured by the
        radiance field."""
        from ngp_tpu_torch.render.mesh_export import (marching_cubes,
                                                      marching_tetrahedra,
                                                      smooth_mesh,
                                                      vertex_colors,
                                                      vertex_normals)
        if self.mode not in (TestbedMode.NERF, TestbedMode.SDF) \
                or self.trainer is None:
            raise ValueError("a mesh needs a trained NeRF or SDF testbed")
        tr = self.trainer
        res = resolution[0] if hasattr(resolution, "__len__") else resolution
        field = self._mesh_field(res)
        if self.mode == TestbedMode.SDF:
            v, f = marching_tetrahedra(field, 0.0)
        else:
            v, f = marching_cubes(-field, -thresh)
            v = v * float(tr.aabb_size) + float(tr.aabb_min)
            if len(v):
                v = smooth_mesh(v, f, 1)
        n = vertex_normals(v, f) if len(v) else np.zeros((0, 3), np.float32)
        if self.mode == TestbedMode.NERF and len(v):
            c = vertex_colors(tr.model, tr.inference_params(), v,
                              float(tr.aabb_min), float(tr.aabb_size))
        else:
            c = np.abs(n)
        return {"V": v, "N": n, "C": c, "F": f}

    def get_rgba_on_grid(self, resolution: int = 128,
                         ray_dir=(0.0, 0.0, 1.0), depth: float = 0.01,
                         density_as_alpha: bool = False) -> np.ndarray:
        """NeRF RGBA on a voxel grid (ref: Testbed::get_rgba_on_grid,
        src/testbed_nerf.cu:3532)."""
        from ngp_tpu_torch.render.mesh_export import rgba_on_grid
        _require(self, TestbedMode.NERF, "get_rgba_on_grid")
        tr = self.trainer
        return rgba_on_grid(tr.model, tr.inference_params(), resolution,
                            float(tr.aabb_min), float(tr.aabb_size), ray_dir,
                            depth, density_as_alpha)

    def compute_and_save_marching_cubes_mesh(self, filename,
                                             resolution=(256, 256, 256),
                                             thresh: float = 2.5,
                                             unwrap_it: bool = False):
        """ref: compute_and_save_marching_cubes_mesh + save_mesh
        (src/marching_cubes.cu:823-944): a ``.ply`` with vertex colours,
        else an OBJ with normals, or with ``unwrap_it`` the quad-atlas UV
        unwrap and its debug .tga texture."""
        from ngp_tpu_torch.render.mesh_export import (save_obj,
                                                      save_obj_unwrapped,
                                                      save_ply)
        m = self.compute_marching_cubes_mesh(resolution, thresh)
        if str(filename).endswith(".ply"):
            save_ply(filename, m["V"], m["F"], m["C"])
        elif unwrap_it:
            save_obj_unwrapped(filename, m["V"], m["F"], m.get("C"),
                               m["N"])
        else:
            save_obj(filename, m["V"], m["F"], m["N"])

    def compute_and_save_png_slices(self, filename_prefix, resolution=256,
                                    thresh: float = 2.5):
        """ref: pyngp compute_and_save_png_slices: the mesh's field as
        ``<prefix>_<z:04d>.png`` slices."""
        from ngp_tpu_torch.render.mesh_export import save_density_slices
        _require(self, TestbedMode.NERF, "compute_and_save_png_slices")
        save_density_slices(filename_prefix, self._mesh_field(resolution))

    def override_sdf_training_data(self, points: np.ndarray,
                                   distances: np.ndarray):
        """ref: pyngp override_sdf_training_data — each batch is drawn from
        the given points and distances (with the trainer's rng) instead of
        the mesh."""
        _require(self, TestbedMode.SDF, "override_sdf_training_data")
        pts = np.asarray(points, np.float32)
        dst = np.asarray(distances, np.float32)
        tr = self.trainer

        def gen():
            idx = tr.rng.integers(0, len(pts), tr.batch_size)
            return pts[idx], dst[idx]
        tr.generate_training_batch = gen

    # -- parameters ----------------------------------------------------------

    def n_params(self) -> int:
        return sum(int(p.numel()) for p in self.trainer.params.values())

    def n_encoding_params(self) -> int:
        """ref: Testbed::n_encoding_params — grid/encoding table size."""
        return sum(int(p.numel()) for k, p in self.trainer.params.items()
                   if k.startswith(("pos_encoding.", "dir_encoding.",
                                    "encoding.")))

    @property
    def params(self) -> np.ndarray:
        """Flat float32 vector of all trainable parameters (ref pyngp
        "params" property), in the JAX package's leaf order (its parameter
        dict's sorted keys), so a vector moves between the packages."""
        from ngp_tpu_torch import bridge
        if self.trainer is None:
            return np.zeros(0, np.float32)
        return bridge.nerf_params_to_flat(self.trainer.params,
                                          self.trainer.model)

    @params.setter
    def params(self, flat):
        from ngp_tpu_torch import bridge
        new = bridge.nerf_params_from_flat(flat, self.trainer.model)
        with torch.no_grad():
            for k, v in new.items():
                self.trainer.params[k].copy_(v)

    def reset(self, reset_density_grid: bool = True):
        """ref: pyngp reset → Testbed::reset_network."""
        self.reload_network_from_json(self.network_config)

    def clear_training_data(self):
        self.nerf.training.dataset = None
        self.trainer = None
        self._renderer_cache = {}

    def reset_accumulation(self):
        pass  # progressive accumulation is per-render here

    def want_repl(self) -> bool:
        return False

    # -- GUI surface (headless; ref: python_api.cu:550-562) ----------------

    def init_window(self, width: int, height: int, hidden: bool = False,
                    second_window: bool = False):
        raise RuntimeError("ngp_tpu_torch is headless: no GLFW/ImGui window. "
                           "Use render()/screenshot() instead.")

    def destroy_window(self):
        pass

    def is_key_pressed(self, key) -> bool:
        return False

    def is_key_down(self, key) -> bool:
        return False

    def is_alt_down(self) -> bool:
        return False

    def is_ctrl_down(self) -> bool:
        return False

    def is_shift_down(self) -> bool:
        return False

    def is_super_down(self) -> bool:
        return False
