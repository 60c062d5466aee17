"""NeRF training (port of ``ngp_tpu/train/nerf.py``; ref:
src/testbed_nerf.cu:1085-1600, 2896-3385).

A step samples pixels (uniformly, or from error-map CDFs), builds their
rays, marches the closed-form cone lattice through the occupancy grid in
two levels (``march_and_compact_hier``), runs the network on the compacted
samples, composites them with per-ray lattice transmittance, and takes the
loss in sRGB with the density regularisers. Autograd gives the gradients
(the table's through K2 on the card, or K5 under ``encode_int8="full"``),
Adam updates the parameters in place, and the per-ray loss is deposited
into the error map. Every 16 steps the occupancy grid is swept: every cell
below step 256, an interleaved partial sweep after, through the int8-table
encode (K4, on the table quantised once per sweep) when ``grid_int8`` or
``encode_int8`` is set.

A capture's rays go through any of the four lenses (perspective, OpenCV,
F-theta, LatLong) or come from its per-pixel ray sidecar; with distinct
start and end transforms (rolling shutter) each ray's camera is slerped
between them at a time drawn per ray. Depth supervision adds the loss of
each ray's expected depth Σ w·t against the capture's depth map, where it
has one. ``grid_impl="tcnn"`` trains the tcnn-layout grid (a plain
PyTorch gather; the int8 modes are refused for it). Under
``NGP_TPU_CHECK_NUMERICS=1`` a non-finite loss raises FloatingPointError
at the next stats fetch, naming the non-finite parameters.

With any of the ``optimize_*`` flags or ``train_envmap``, the camera
parameters (per-image pose deltas, exposure, the focal delta, per-image
extra dims, the envmap, the distortion grid) join the loss: the march takes
detached rays, the loss takes rays built with gradient, so pose, focal and
distortion gradients flow through the sample positions (K3 on the card).
They are trained by their own Adam without bias correction.

With a data-parallel group (``data_group``, ``dist/nerf_dp.py``) a step
draws this rank's rays and sums the normaliser, the gradients, the loss,
the counters and the error-map deposits over the group, at the JAX step's
``axis_name`` points.

None of the JAX package's compile machinery comes across: ``train(n)`` is
a plain Python loop over single steps, every random draw comes from a
``torch.Generator`` on the trainer's device, and the ray batch and
sample stream are sized by what the step produces.

Intended divergences from the JAX package:
- ``train(n)`` runs exactly n steps; the JAX package runs on to the next
  16-step boundary for n ≥ 16 (a compile artefact).
- ``dynamic_rays`` slices the first ``n_live`` of the ``n_rays`` rays
  drawn, where the JAX package masks the rest: masked rays emit no
  samples, have a zero ray mask, deposit nothing and are not counted, so
  the two agree.
- The table gradient (K2 on the card) sums in f32; the Pallas kernel
  rounds its row gradients to bf16. The position gradient (K3) reads the
  f32 table; the Pallas kernel rounds it to bf16.
- ``extra_dims`` start from a ``torch.Generator`` draw (seed + 1), not
  from the JAX key: the two give other numbers from one seed.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ngp_tpu_torch.common import (LOSS_SCALE, NERF_MIN_OPTICAL_THICKNESS,
                                  linear_to_srgb, loss_type_from_str,
                                  srgb_to_linear)
from ngp_tpu_torch.dist.mesh import all_reduce_, all_reduce_flat_
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.kernels.blocked_grid import eff_tile, quantize_table_i8
from ngp_tpu_torch.kernels.blocked_grid_cuda import INT8_MODES
from ngp_tpu_torch.nn.models import NerfNetwork
from ngp_tpu_torch.nn.trainable_buffer import DistortionGrid, Envmap
from ngp_tpu_torch.opt.losses import loss_fn
from ngp_tpu_torch.opt.optimizers import (AdamConfig, apply_update,
                                          inference_params, init_state)
from ngp_tpu_torch.rays.camera import pixel_to_ray_train, xform_slerp
from ngp_tpu_torch.rays.marching import (cone_angle_for, exclusive_depth,
                                         march_and_compact,
                                         march_and_compact_hier, ray_sums)
from ngp_tpu_torch.utils.debug import find_nonfinite
from ngp_tpu_torch.utils.profiling import count, span, spanned

SHARPNESS_RES = 64  # per-image sharpness-map resolution
SWEEP_CHUNK = 1 << 18  # density evaluations per network call in a sweep


def _sharpness_maps(dataset) -> np.ndarray:
    """(I, S, S) local sharpness per image: mean squared 4-neighbour
    Laplacian of luminance over tiles, on the sRGB bytes where the dataset
    has them (ref: compute_sharpness usage)."""
    S = SHARPNESS_RES
    u8 = getattr(dataset, "images_u8", None)
    out = np.zeros((dataset.n_images, S, S), np.float32)
    for i in range(dataset.n_images):
        w, h = (int(x) for x in dataset.resolution[i])
        if u8 is not None:
            lum = u8[i, :h, :w, :3].astype(np.float32).mean(-1) / 255.0
        else:
            lum = dataset.images[i][:h, :w, :3].mean(-1)
        lap = np.abs(4 * lum[1:-1, 1:-1] - lum[:-2, 1:-1] - lum[2:, 1:-1]
                     - lum[1:-1, :-2] - lum[1:-1, 2:])
        ys = np.minimum((np.arange(h - 2, dtype=np.int64) * S)
                        // max(h - 2, 1), S - 1)
        xs = np.minimum((np.arange(w - 2, dtype=np.int64) * S)
                        // max(w - 2, 1), S - 1)
        idx = (ys[:, None] * S + xs[None, :]).ravel()
        acc = np.bincount(idx, weights=(lap ** 2).ravel(), minlength=S * S)
        cnt = np.bincount(idx, minlength=S * S)
        out[i] = (acc / np.maximum(cnt, 1.0)).reshape(S, S)
    return out


@dataclasses.dataclass
class NerfTrainerConfig:
    """The JAX package's trainer options, with its defaults. ``grid_int8``
    takes the place of its ``NGP_TPU_GRID_INT8`` environment switch and
    ``encode_int8`` (``""``, ``"fwd"`` or ``"full"``) that of
    ``NGP_TPU_ENCODE_INT8``."""
    n_rays: int = 4096               # adapted between steps (power of 2)
    adapt_rays: bool = True          # False pins n_rays
    dynamic_rays: bool = False       # adapt the live ray count instead
    target_batch_size: int = 1 << 18
    adapt_capacity: bool = False     # shrink the sample cap after step 512
    march_steps: int = 1024          # lattice length K
    random_bg_color: bool = True
    train_in_linear_colors: bool = False
    color_space_linear: bool = True
    near_distance: float = 0.2       # ref: testbed.h:675
    density_grid_decay: float = 0.95
    n_steps_between_grid_updates: int = 16
    snap_to_pixel_centers: bool = False
    hierarchical_march: bool = True
    optimize_extrinsics: bool = False
    optimize_exposure: bool = False
    optimize_focal_length: bool = False
    optimize_extra_dims: bool = False
    extrinsic_learning_rate: float = 1e-4
    exposure_learning_rate: float = 1e-3
    focal_learning_rate: float = 1e-5
    extrinsic_l2_reg: float = 1e-4
    exposure_l2_reg: float = 0.0
    sample_image_proportional_to_error: bool = False
    sample_focal_plane_proportional_to_error: bool = False
    depth_supervision_lambda: float = 0.0
    depth_loss_type: str = "L1"
    train_envmap: bool = False
    optimize_distortion: bool = False
    error_map_res: int = 32
    n_steps_between_error_map_updates: int = 128
    grid_int8: bool = False          # grid sweeps through the int8 encode
    encode_int8: str = ""            # int8 mode of the training encode


class StepDraws(NamedTuple):
    """The random numbers of one step, all in [0, 1). ``time`` is drawn
    only for a rolling-shutter capture (the JAX step's ``k_time``)."""
    u_img: torch.Tensor     # (R,) image choice
    u_xy: torch.Tensor      # (R, 2) pixel position
    u_march: torch.Tensor   # (R,) start of each ray within its first step
    bg: torch.Tensor        # (R, 3) random background colour
    time: Optional[torch.Tensor] = None   # (R,) shutter time

    def head(self, n: int) -> "StepDraws":
        return StepDraws(*(None if t is None else t[:n] for t in self))


class StepStats(NamedTuple):
    loss: torch.Tensor           # RGB loss / 3 (0-d, on the device)
    total: int                   # samples before the cap
    seg_total: int               # surviving segments before the cap
    n_rays_with_samples: torch.Tensor


def _check_options(tc: NerfTrainerConfig, grid_impl: str):
    if tc.encode_int8 not in INT8_MODES:
        raise ValueError(f"encode_int8 must be one of {INT8_MODES}, got "
                         f"{tc.encode_int8!r}")
    if grid_impl == "tcnn" and (tc.encode_int8 or tc.grid_int8):
        raise ValueError("the int8 encode modes and the int8 grid sweep "
                         "exist for the blocked grid only, not for "
                         "grid_impl='tcnn'")


def check_numerics() -> bool:
    """The opt-in numerics guard ``NGP_TPU_CHECK_NUMERICS=1``, read at each
    stats fetch (the JAX package's ``_check_numerics``)."""
    return os.environ.get("NGP_TPU_CHECK_NUMERICS", "0") == "1"


@spanned("ngp.adam")
def camera_adam(cam: dict, grads: dict, m: dict, v: dict, lrs: dict,
                enabled: dict):
    """One step of the camera Adam (ref: AdamOptimizer /
    RotationAdamOptimizer, adam_optimizer.h:22,93; the JAX package's
    ``_train_step_impl`` :682-706): β 0.9/0.99, ε 1e-8, no bias
    correction, the loss scale divided out. Every key's moments move; only
    enabled keys' parameters do. In place."""
    with torch.no_grad():
        for k in cam:
            g = grads[k] / LOSS_SCALE
            m[k].mul_(0.9).add_(0.1 * g)
            v[k].mul_(0.99).add_(0.01 * g * g)
            if enabled[k]:
                cam[k].sub_(lrs[k] * m[k] / (torch.sqrt(v[k]) + 1e-8))


class NerfTrainer:
    """Model, optimizer, occupancy grid, error map and camera parameters
    for one NeRF scene, on one device (the card unless the caller asks for
    another). ``grid_impl`` (``"blocked"`` or ``"tcnn"``) is the JAX
    package's ``NGP_TPU_GRID_IMPL``, as an argument."""

    def __init__(self, dataset, config: dict, seed: int = 1337,
                 tcfg: Optional[NerfTrainerConfig] = None, device="cuda",
                 grid_impl: str = "blocked"):
        self.dataset = dataset
        self.tcfg = dataclasses.replace(tcfg or NerfTrainerConfig())
        tc = self.tcfg
        _check_options(tc, grid_impl)
        self.device = dev = torch.device(device)
        aabb_scale = int(dataset.aabb_scale)
        self.aabb_scale = aabb_scale
        # f32 values, and their f32 sum, as the JAX package computes them
        self.aabb_min = float(np.float32(0.5 - aabb_scale / 2.0))
        self.aabb_size = float(np.float32(aabb_scale))
        self.max_cascade = max(0, int(math.log2(aabb_scale)))
        self.cone_angle = cone_angle_for(aabb_scale)
        if self.cone_angle == 0.0 and tc.march_steps < 1024:
            warnings.warn(f"march_steps={tc.march_steps} covers only part "
                          "of the unit box with cone_angle 0; rays will "
                          "terminate early")

        self.seed = seed
        # the model's initialisation and the grid sweeps draw from
        # ``generator``, the steps' rays from ``draw_generator``: the same
        # stream on one device; under data parallelism (dist/nerf_dp.py)
        # the first is shared by every rank, so the grid stays replicated,
        # and the second is the rank's own
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.draw_generator = self.generator
        # the data-parallel group whose ranks' steps are summed (None: this
        # trainer alone)
        self.data_group = None
        E = int(getattr(dataset, "n_extra_learnable_dims", 0))
        self.model = NerfNetwork(config, aabb_scale, generator=self.generator,
                                 device=dev, n_extra_dims=E,
                                 grid_impl=grid_impl)
        self.rgb_loss = loss_fn(loss_type_from_str(
            config.get("loss", {}).get("otype", "L2")))
        self.depth_loss = loss_fn(loss_type_from_str(tc.depth_loss_type))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_state(self.params)
        self.matrix_names = self.model.matrix_param_names()

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        self._resolution = t(dataset.resolution)            # (I, 2) W, H
        self.refresh_cameras()
        self.grid = occ.init_grid(self.max_cascade, dev)
        if getattr(dataset, "lens_mode", "perspective") not in ("ftheta",
                                                                "latlong"):
            # cull the cells no camera sees (fisheye and equirect cameras
            # see almost everywhere: the reference skips the culling for
            # them, ref: mark_untrained_density_grid, testbed_nerf.cu:391)
            self.grid = self.grid._replace(density=occ.mark_untrained(
                self.max_cascade, self._xforms, self._focal,
                self._resolution))

        res = np.asarray(dataset.resolution, np.int64)
        offs = np.concatenate([[0], np.cumsum(res[:, 0] * res[:, 1])])
        self._img_offset = t(offs[:-1], torch.int64)
        self.refresh_images()
        # the per-pixel ray sidecars, pooled like the pixels
        self._rays = (None if getattr(dataset, "rays", None) is None
                      else self._pool(dataset.rays, 6, np.float32))

        I, em = dataset.n_images, tc.error_map_res
        self.error_map = torch.zeros((I, em, em), device=dev)
        # sharpness grid (ref: testbed_nerf.cu:1476-1481 deposit, :557
        # decay): per cell, the sharpest local sharpness of any image that
        # deposited there; only importance sampling reads it
        self._use_sharpness = (
            (tc.sample_image_proportional_to_error
             or tc.sample_focal_plane_proportional_to_error)
            and dataset.images is not None)
        if self._use_sharpness:
            self._sharpness_maps = t(_sharpness_maps(dataset))
            self.sharpness_grid = torch.zeros(
                occ.GRID_VOLUME * (self.max_cascade + 1), device=dev)
        else:
            self.sharpness_grid = torch.zeros(1, device=dev)

        # camera parameters (ngp_tpu/train/nerf.py:261-288): per-image pose
        # deltas (axis-angle, translation), exposure, the focal delta,
        # per-image extra dims; the envmap and the distortion grid when
        # trained. Their Adam moments start at zero.
        g_extra = torch.Generator(device=dev).manual_seed(seed + 1)
        self.cam_params = {
            "rot": torch.zeros((I, 3), device=dev),
            "trans": torch.zeros((I, 3), device=dev),
            "exposure": torch.zeros((I, 3), device=dev),
            "focal_delta": torch.zeros(2, device=dev),
            "extra_dims": 1e-4 * torch.randn((I, max(E, 1)),
                                             generator=g_extra, device=dev)}
        self.envmap = Envmap()
        self.distortion = DistortionGrid(tuple(
            config.get("distortion_map", {}).get("resolution", [32, 32])))
        if tc.train_envmap:
            self.cam_params["envmap"] = self.envmap.init_params(dev)
        if tc.optimize_distortion:
            self.cam_params["distortion"] = self.distortion.init_params(dev)
        self.cam_m = {k: torch.zeros_like(v) for k, v in self.cam_params.items()}
        self.cam_v = {k: torch.zeros_like(v) for k, v in self.cam_params.items()}

        self.training_step = 0
        self.last_loss = 0.0
        self.last_surviving_segments = 0
        self.last_samples = 0            # samples of the last step fetched
        self._capacity = tc.target_batch_size
        self._n_live = tc.n_rays
        self._seg_capacity = 0
        self._warned_segcap = False
        self._rays_floor = 256
        # the error-map CDF rebuild interval grows ×1.5 after each rebuild
        # (ref: testbed_nerf.cu:3022)
        self._error_map_interval = float(tc.n_steps_between_error_map_updates)
        self._steps_since_error_map_update = 0

    def _pool(self, src, ch: int, dtype) -> torch.Tensor:
        """(P, ch) device pool of per-image arrays ``src`` (I, H, W, ch),
        each image at its own resolution, concatenated in image order."""
        res = np.asarray(self.dataset.resolution, np.int64)
        offs = np.concatenate([[0], np.cumsum(res[:, 0] * res[:, 1])])
        pool = np.empty((int(offs[-1]), ch), dtype)
        for i, (w, h) in enumerate(res):
            pool[offs[i]:offs[i + 1]] = np.asarray(src[i])[:h, :w].reshape(
                -1, ch)
        return torch.from_numpy(pool).to(self.device)

    def refresh_images(self):
        """Rebuild the device pixel pool from ``dataset.images`` (the JAX
        trainer's ``refresh_images``; pyngp ``set_image`` re-uploads the
        GPU copy): one flat pool with per-image offsets, no padding to the
        largest image. sRGB uint8 where the dataset has ``images_u8``,
        converted per sampled texel, else linear f16 (a float edit of the
        images drops the uint8 copy). The depth maps, where the dataset
        has them, are pooled the same way (f32)."""
        ds = self.dataset
        u8 = getattr(ds, "images_u8", None)
        self._pixels = (self._pool(u8, 4, np.uint8) if u8 is not None
                        else self._pool(ds.images, 4, np.float16))
        depths = getattr(ds, "depth_images", None)
        self._depths = (None if depths is None else
                        self._pool(np.asarray(depths)[..., None], 1,
                                   np.float32)[:, 0])

    def refresh_cameras(self):
        """Copy the dataset's poses and intrinsics (``xforms``,
        ``xforms_end``, ``focal``, ``principal``, ``lens_params``) to the
        device again, after pyngp's ``set_camera_extrinsics``/
        ``set_camera_intrinsics`` edited them in place (the JAX testbed
        replaces the trainer's ``data`` entries). The end transforms are
        kept only where they differ from the start ones: a rolling
        shutter."""
        ds = self.dataset

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device)
        self._xforms = t(ds.xforms)
        xe = getattr(ds, "xforms_end", None)
        self._xforms_end = (t(xe) if xe is not None
                            and not np.allclose(ds.xforms, xe) else None)
        self._focal = t(ds.focal)
        self._principal = t(ds.principal)
        self._lens_params = t(ds.lens_params)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    @spanned("ngp.sample")
    def draws(self, n_rays: int,
              generator: Optional[torch.Generator] = None) -> StepDraws:
        """One step's draws from ``generator`` (``draw_generator`` by
        default); the shutter times only for a rolling-shutter capture."""
        g = generator or self.draw_generator

        def u(*shape):
            return torch.rand(shape, generator=g, device=self.device)
        return StepDraws(u(n_rays), u(n_rays, 2), u(n_rays), u(n_rays, 3),
                         u(n_rays) if self._xforms_end is not None else None)

    @spanned("ngp.sample")
    def _error_state(self) -> dict:
        """Normalised CDFs of the error map, with the MIN_PMF = 0.1 floor
        (ref: construct_cdf_1d/2d)."""
        em = self.error_map + 0.1 * torch.mean(self.error_map) + 1e-8
        row_sums = em.sum(-1)                                   # (I, H)
        cdf_x = torch.cumsum(em, -1) / row_sums[..., None]
        cdf_y = torch.cumsum(row_sums, -1) / row_sums.sum(-1)[..., None]
        img_w = em.sum((1, 2))
        return {"cdf_x": cdf_x, "cdf_y": cdf_y,
                "cdf_img": torch.cumsum(img_w, 0) / img_w.sum()}

    def _sample_pixels(self, error_state: dict, u_img: torch.Tensor,
                       u_xy: torch.Tensor):
        """Image and pixel per ray from the uniforms: uniform, or a 50/50
        mixture of uniform and error-CDF draws (ref: image_idx +
        nerf_random_image_pos_training). Returns (img, xy, texsamp, pdf);
        pdf is the branch's sampling density, which the deposited loss
        (not the gradient) is divided by."""
        tc = self.tcfg
        I = self.dataset.n_images
        n = u_img.shape[0]
        dev = self.device
        img_uni = torch.clamp((u_img * I).to(torch.int64), 0, I - 1)
        pdf = torch.ones(n, device=dev)
        if tc.sample_image_proportional_to_error:
            # uniform and CDF picks interleaved by parity, so a prefix of
            # the rays (the live rays of dynamic_rays) keeps both halves
            cdf_img = error_state["cdf_img"]
            uni = torch.arange(n, device=dev) % 2 == 0
            img_cdf = torch.clamp(torch.searchsorted(cdf_img, u_img), 0,
                                  I - 1)
            prev = torch.where(img_cdf > 0,
                               cdf_img[torch.clamp(img_cdf - 1, min=0)], 0.0)
            pdf = torch.where(uni, 1.0, (cdf_img[img_cdf] - prev) * I)
            img = torch.where(uni, img_uni, img_cdf)
        else:
            img = img_uni
        if tc.sample_focal_plane_proportional_to_error:
            em = tc.error_map_res
            ux, uy = u_xy[:, 0], u_xy[:, 1]
            uni = ux < 0.5                  # ref: sample_cdf_2d :994-999
            ux_cdf = torch.clamp((ux - 0.5) / 0.5, 0.0, 1.0)

            def pick(cdf, u):
                """Cell, its pmf, and the position within it, from one
                draw (ref: the stratified residual, :1008)."""
                k = torch.clamp(torch.searchsorted(
                    cdf, u[:, None].contiguous())[:, 0], 0, em - 1)
                prev = torch.where(k > 0, torch.gather(
                    cdf, 1, torch.clamp(k - 1, min=0)[:, None])[:, 0], 0.0)
                pmf = torch.gather(cdf, 1, k[:, None])[:, 0] - prev
                j = torch.clamp((u - prev) / torch.clamp(pmf, min=1e-12),
                                0.0, 1.0)
                return k, pmf, j
            row, pmf_y, jy = pick(error_state["cdf_y"][img], uy)
            col, pmf_x, jx = pick(error_state["cdf_x"][img, row], ux_cdf)
            xy_cdf = torch.stack([(col + jx) / em, (row + jy) / em], -1)
            xy_uni = torch.stack([ux / 0.5, uy], -1)
            xy = torch.where(uni[:, None], xy_uni, xy_cdf)
            pdf = pdf * torch.where(uni, 1.0, pmf_x * pmf_y * em * em)
        else:
            xy = u_xy
        if tc.snap_to_pixel_centers:
            res = self._resolution[img]
            xy = (torch.floor(xy * res) + 0.5) / res
        raw = self._pixels[self._pixel_index(img, xy)]
        if raw.dtype == torch.uint8:
            # sRGB uint8 → linear premultiplied
            c = raw.to(torch.float32) * (1.0 / 255.0)
            texsamp = torch.cat([srgb_to_linear(c[:, :3]) * c[:, 3:4],
                                 c[:, 3:4]], -1)
        else:
            texsamp = raw.to(torch.float32)
        return img, xy, texsamp, pdf

    def _pixel_index(self, img: torch.Tensor, xy: torch.Tensor):
        """Index into the flat pools of each ray's pixel (image ``img``,
        position ``xy`` in [0, 1]²)."""
        res = self._resolution[img]
        pix = torch.minimum(torch.clamp((xy * res).to(torch.int64), min=0),
                            res.to(torch.int64) - 1)
        return (self._img_offset[img] + pix[:, 1] * res[:, 0].to(torch.int64)
                + pix[:, 0])

    @staticmethod
    def _rodrigues(rot: torch.Tensor) -> torch.Tensor:
        """Axis-angle (N, 3) → rotation matrices (N, 3, 3), with a smoothed
        norm: d‖r‖/dr is NaN at r = 0, where the deltas start."""
        theta = torch.sqrt(torch.sum(rot * rot, -1, keepdim=True) + 1e-24)
        k = rot / theta
        z = torch.zeros_like(k[..., 0])
        K = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                         torch.stack([k[..., 2], z, -k[..., 0]], -1),
                         torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
        st = torch.sin(theta)[..., None]
        ct = torch.cos(theta)[..., None]
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        return eye + st * K + (1 - ct) * (K @ K)

    def _build_rays(self, img: torch.Tensor, xy: torch.Tensor,
                    cam: Optional[dict] = None,
                    time: Optional[torch.Tensor] = None):
        """World rays (o, unit d, |d_raw|) of the sampled pixels, with the
        pose, focal and distortion deltas of ``cam`` (default: the
        trainer's camera parameters) where their flags are on
        (ngp_tpu/train/nerf.py:428-471). With ``time`` and a rolling
        shutter, each ray's camera is slerped toward its end transform;
        a capture with ray sidecars takes each pixel's stored ray in place
        of the camera's. |d_raw| turns a depth map's z into distance along
        the unit ray."""
        tc = self.tcfg
        cam = self.cam_params if cam is None else cam
        xf = self._xforms[img]
        if self._xforms_end is not None and time is not None:
            xf = xform_slerp(xf, self._xforms_end[img], time)
        if tc.optimize_extrinsics:
            R = self._rodrigues(cam["rot"][img])
            xf = torch.cat([R @ xf[:, :, :3],
                            (xf[:, :, 3] + cam["trans"][img])[:, :, None]], -1)
        focal = self._focal[img]
        if tc.optimize_focal_length:
            focal = focal * (1.0 + cam["focal_delta"])[None]
        if self._rays is not None:
            rr = self._rays[self._pixel_index(img, xy)]
            o, d_raw = rr[:, :3], rr[:, 3:]
        else:
            o, d_raw = pixel_to_ray_train(
                xy, xf, focal, self._principal[img],
                self._resolution[img], self._lens_params[img],
                self.dataset.lens_is_opencv,
                lens_mode=getattr(self.dataset, "lens_mode", None))
        if tc.optimize_distortion:
            # the learned offset of the camera-space xy direction, rotated
            # into the world (the JAX package's approximation of the
            # reference's pre-rotation add, :1188-1190)
            off2 = self.distortion.sample(cam["distortion"], xy)
            off3 = torch.cat([off2, torch.zeros_like(off2[:, :1])], -1)
            d_raw = d_raw + torch.einsum("nij,nj->ni", xf[:, :, :3], off3)
        d_norm = torch.clamp(torch.linalg.vector_norm(d_raw, dim=-1,
                                                      keepdim=True), min=1e-9)
        return o, d_raw / d_norm, d_norm[:, 0]

    @spanned("ngp.march")
    def _march(self, o, d, jitter, n_rays: int, capacity: int, ray_mask):
        """(s_t, s_dt, s_ray, counts, total, seg_total, s_k) of the rays;
        ``counts`` are the kept samples per ray. Counts the samples the
        march emitted (``total``, already on the host)."""
        tc = self.tcfg
        if tc.hierarchical_march:
            self._seg_capacity = capacity // 8 * 4
            out = march_and_compact_hier(
                self.grid.bitfield, self.grid.coarse, o, d, jitter, n_rays,
                tc.march_steps, self.cone_angle, self.max_cascade,
                self.aabb_min, self.aabb_size, capacity, ray_mask=ray_mask)
        else:
            self._seg_capacity = 0
            out = march_and_compact(
                self.grid.bitfield, o, d, jitter, n_rays, tc.march_steps,
                self.cone_angle, self.max_cascade, self.aabb_min,
                self.aabb_size, capacity, ray_mask=ray_mask)
        count("samples", out[4])
        return out

    # ------------------------------------------------------------------
    # one training step
    # ------------------------------------------------------------------

    @spanned("ngp.step")
    def _train_step(self, draws: StepDraws, error_state: dict,
                    capacity: Optional[int] = None,
                    group=None) -> StepStats:
        """One step on the rays of ``draws`` (all of them: the caller
        slices to the live rays); updates parameters, optimizer state,
        camera parameters, error map and sharpness grid in place. With a
        data-parallel ``group``, ``draws`` are this rank's rays and the
        step is that of the group's rays together (``_step_grads``)."""
        grads, cam_grads, stats, deposit = self._step_grads(
            draws, error_state, capacity, group)
        self.opt_state = apply_update(self.params, grads, self.opt_state,
                                      self.opt_cfg, self.matrix_names)
        if cam_grads is not None:
            camera_adam(self.cam_params, cam_grads, self.cam_m, self.cam_v,
                        *self._camera_schedule())
        with torch.no_grad():
            self._deposit_error(*deposit, group=group)
        return stats

    def _camera_schedule(self):
        """(learning rate, enabled) of each camera parameter
        (ngp_tpu/train/nerf.py:685-697)."""
        tc = self.tcfg
        lrs = {"rot": tc.extrinsic_learning_rate,
               "trans": tc.extrinsic_learning_rate,
               "exposure": tc.exposure_learning_rate,
               "focal_delta": tc.focal_learning_rate,
               "extra_dims": 1e-3, "envmap": 1e-2, "distortion": 1e-4}
        enabled = {"rot": tc.optimize_extrinsics,
                   "trans": tc.optimize_extrinsics,
                   "exposure": tc.optimize_exposure,
                   "focal_delta": tc.optimize_focal_length,
                   "extra_dims": tc.optimize_extra_dims,
                   "envmap": tc.train_envmap,
                   "distortion": tc.optimize_distortion}
        return lrs, enabled

    def _step_grads(self, draws: StepDraws, error_state: dict,
                    capacity: Optional[int] = None, group=None):
        """The forward and backward of one step, changing no parameter,
        optimizer or error-map state: (gradients by parameter name, camera
        gradients by key or None, stats, the error-map deposit's
        arguments).

        With a data-parallel ``group`` the step sums over its ranks where
        the JAX step's ``axis_name`` does (ngp_tpu/train/nerf.py:563-567,
        :674-678, :753-756): the count of rays with samples before the
        backward, so every rank's loss has the global normaliser; the
        gradients, camera gradients and the RGB loss after it; the sample,
        segment and ray counts of the stats. The camera L2 term is added on
        every rank before the sum, as in the JAX step, so N ranks count it
        N times."""
        tc = self.tcfg
        S = capacity or tc.target_batch_size
        n = draws.u_img.shape[0]
        # whether the camera parameters join the loss
        train_cam = (tc.optimize_extrinsics or tc.optimize_exposure
                     or tc.optimize_focal_length or tc.optimize_extra_dims
                     or tc.train_envmap or tc.optimize_distortion)
        with span("ngp.sample"):
            img, xy, texsamp, samp_pdf = self._sample_pixels(
                error_state, draws.u_img, draws.u_xy)
            cam = ({k: v.detach().requires_grad_() for k, v in
                    self.cam_params.items()} if train_cam else self.cam_params)
            o, d, d_norm = self._build_rays(img, xy, cam, draws.time)
            # each ray's depth target in distance along the unit ray; ≤ 0
            # where the capture has no depth (ref: target_depth, :1450)
            depth_tgt = None
            if tc.depth_supervision_lambda > 0.0 and self._depths is not None:
                depth_tgt = d_norm.detach() \
                    * self._depths[self._pixel_index(img, xy)]
            # masked-away pixels (negative red sentinel) never train
            ray_ok = texsamp[:, 0] >= 0.0
        # the march's sample times stay fixed (piecewise-constant sampling);
        # the loss takes the rays with their camera gradient
        s_t, s_dt, s_ray, counts, total, seg_total, s_k = self._march(
            o.detach(), d.detach(), draws.u_march, n, S, ray_ok)

        with span("ngp.network"):
            pos_w = (o[s_ray] + s_t[:, None] * d[s_ray] - self.aabb_min) \
                / self.aabb_size
            extra = (cam["extra_dims"][img][s_ray]
                     if self.model.n_extra_dims > 0 else None)
            # the int8 backward's tiles are those of the JAX step's stream of
            # capacity S, not of the live samples
            rgb_raw, dens_raw = self.model.apply(
                pos_w, d[s_ray] * 0.5 + 0.5, extra=extra, int8=tc.encode_int8,
                tile=eff_tile(S))
            rgb = torch.sigmoid(rgb_raw.to(torch.float32))
            sigma = torch.exp(torch.clamp(dens_raw.to(torch.float32), -15.0,
                                          15.0))
        with span("ngp.loss"):
            bg = draws.bg if tc.random_bg_color else torch.ones_like(draws.bg)
            bg_linear = srgb_to_linear(bg)
            has_samples = counts > 0
            # the global normaliser, summed before the backward
            n_eff = torch.clamp(all_reduce_(has_samples.sum(), group), min=1)
            reg_on = (self.grid.mean < NERF_MIN_OPTICAL_THICKNESS).to(
                torch.float32)
            # target (ref: :1388-1427), with the per-image exposure scale 2^e
            # and the envmap over the background, in sRGB unless training in
            # linear
            if tc.train_envmap:
                env = self.envmap.sample(cam["envmap"], d)
                bg_lin = env[:, :3] + bg_linear * (1.0 - env[:, 3:4])
            else:
                bg_lin = bg_linear
            rgb_in = texsamp[:, :3]
            if tc.optimize_exposure:
                rgb_in = torch.exp2(cam["exposure"][img]) * rgb_in
            rgbtarget = rgb_in + (1.0 - texsamp[:, 3:4]) * bg_lin
            if tc.train_in_linear_colors:
                bg_out = bg_linear  # the JAX package's choice, envmap or not
            else:
                rgbtarget = linear_to_srgb(rgbtarget)
                bg_out = linear_to_srgb(bg_lin)

            sdt = sigma * s_dt
            # per-ray transmittance from a lattice cumsum; one global stream
            # cumsum loses f32 precision once σ sharpens (see
            # exclusive_depth)
            excl = exclusive_depth(sdt, s_ray, s_k, n, tc.march_steps)
            w = torch.exp(-torch.clamp(excl, 0.0, 88.0)) \
                * (1.0 - torch.exp(-sdt))
            zeros = torch.zeros(n, device=self.device)
            rgb_ray = torch.zeros((n, 3), device=self.device).index_add(
                0, s_ray, w[:, None] * rgb)
            T_end = torch.exp(-zeros.index_add(0, s_ray,
                                               torch.clamp(sdt, max=88.0)))
            rgb_ray = rgb_ray + T_end[:, None] * bg_out
            per_c = self.rgb_loss(rgbtarget, rgb_ray)               # (R, 3)
            ray_mask = has_samples.to(torch.float32)
            loss_rgb = torch.sum(per_c * ray_mask[:, None]) / n_eff
            # the expected depth Σ w·t of each ray, summed in a fixed order:
            # the depth loss's input and the sharpness deposit's hit point
            depth_ray = ray_sums(w * s_t, s_ray, s_k, n, tc.march_steps)
            if depth_tgt is not None:
                # the depth term joins the RGB loss (and its reported
                # value), where the target is > 0 (ref: lg_depth,
                # :1451-1452)
                dloss = self.depth_loss(depth_tgt[:, None],
                                        depth_ray[:, None])[:, 0]
                dmask = ray_mask * (depth_tgt > 0.0).to(torch.float32)
                loss_rgb = loss_rgb + tc.depth_supervision_lambda * torch.sum(
                    dloss * dmask) / n_eff
            # density regularisers (ref: :1495-1547), added to dL/draw
            # without the loss scale
            near_pen = torch.where(
                (dens_raw > -10.0) & (s_t < tc.near_distance),
                1e-4 * dens_raw, 0.0).sum()
            l1_pen = reg_on * (-1e-4 * torch.clamp(dens_raw, max=0.0)).sum()
            reg = (near_pen + l1_pen) / LOSS_SCALE
            if tc.optimize_extrinsics:
                reg = reg + tc.extrinsic_l2_reg * (
                    torch.sum(cam["rot"] ** 2) + torch.sum(cam["trans"] ** 2))
            scaled_loss = (loss_rgb + reg) * LOSS_SCALE
            with torch.no_grad():
                per_ray_loss = per_c.mean(-1) * ray_mask
        names = list(self.params)
        cam_keys = list(cam) if train_cam else []
        with span("ngp.backward"):
            g = torch.autograd.grad(
                scaled_loss, [self.params[k] for k in names]
                + [cam[k] for k in cam_keys], allow_unused=True)
        grads = dict(zip(names, g[:len(names)]))
        cam_grads = None
        if train_cam:
            # keys the loss does not reach get zeros, as under jax.grad
            cam_grads = {k: torch.zeros_like(cam[k]) if gk is None else gk
                         for k, gk in zip(cam_keys, g[len(names):])}
        loss_rgb = loss_rgb.detach()
        n_with = has_samples.sum()
        if group is not None:
            counts_t = torch.stack([n_with, torch.full_like(n_with, total),
                                    torch.full_like(n_with, seg_total)])
            all_reduce_flat_([*grads.values(),
                              *(cam_grads or {}).values(),
                              loss_rgb[None]], group)
            all_reduce_(counts_t, group)
            n_with = counts_t[0]
            total, seg_total = (int(c) for c in counts_t[1:].tolist())
        stats = StepStats(loss_rgb / 3.0, total, seg_total, n_with)
        return grads, cam_grads, stats, (img, xy, o.detach(), d.detach(),
                                         per_ray_loss, samp_pdf,
                                         depth_ray.detach(), T_end.detach(),
                                         has_samples)

    @spanned("ngp.error_map")
    def _deposit_error(self, img, xy, o, d, per_ray_loss, samp_pdf,
                       depth_ray, T_end, has_samples, group=None):
        """Bilinear deposit of the per-ray loss into the error map, divided
        by the sampling pdf so oversampled cells do not count twice (ref:
        :1448, :1465-1491), and scaled down for views blurrier than the
        sharpest one seen at the ray's hit cell (ref: :1476-1481). The
        deposits are summed into a map of their own that is then added to
        the error map, as the JAX step does; with a data-parallel
        ``group`` that map is summed over it, and the sharpness grid taken
        as its maximum over it (ngp_tpu/train/nerf.py:731-732,
        :747-748)."""
        em = self.tcfg.error_map_res
        dep = per_ray_loss / torch.clamp(samp_pdf, min=1e-12)
        if self._use_sharpness:
            opac = 1.0 - T_end
            hit = o + (depth_ray / torch.clamp(opac, min=1e-6))[:, None] * d
            inb = torch.all((hit >= self.aabb_min)
                            & (hit <= self.aabb_min + self.aabb_size),
                            -1) & has_samples
            sp = torch.clamp((xy * SHARPNESS_RES).to(torch.int64), 0,
                             SHARPNESS_RES - 1)
            sharp = self._sharpness_maps[img, sp[:, 1], sp[:, 0]] + 1e-6
            mip = occ.mip_from_pos(hit, self.max_cascade)
            cell = occ.cell_idx_at(hit, mip) + mip * occ.GRID_VOLUME
            old = self.sharpness_grid[cell]
            self.sharpness_grid.scatter_reduce_(
                0, cell, torch.where(inb, sharp, 0.0), "amax")
            all_reduce_(self.sharpness_grid, group, dist.ReduceOp.MAX)
            dep = dep * torch.where(
                inb, torch.clamp(sharp / torch.maximum(sharp, old),
                                 min=0.01), 1.0)
        posf = torch.clamp(xy * em - 0.5, 0.0, em - 1.0 - 1e-4)
        p0 = torch.clamp(posf.to(torch.int64), max=em - 2)
        wxy = posf - p0
        dep_map = torch.zeros_like(self.error_map)
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((wxy[:, 0] if dx else 1 - wxy[:, 0])
                       * (wxy[:, 1] if dy else 1 - wxy[:, 1]))
                dep_map.index_put_((img, p0[:, 1] + dy, p0[:, 0] + dx),
                                   dep * wgt, accumulate=True)
        self.error_map += all_reduce_(dep_map, group)

    # ------------------------------------------------------------------
    # occupancy-grid maintenance
    # ------------------------------------------------------------------

    @torch.no_grad()
    @spanned("ngp.sweep")
    def _grid_update(self, full_sweep: bool, jitter=None):
        """Sweep the occupancy grid with the training parameters, in
        network calls of SWEEP_CHUNK positions."""
        tc = self.tcfg
        # the int8 forward (K4) when either switch is on, as the JAX
        # package's sweep reads NGP_TPU_ENCODE_INT8 too. The table does not
        # change inside a sweep, so it is quantised once for all chunks
        # (the JAX package quantises it in every chunk's call, to the same
        # bits).
        quantized = (quantize_table_i8(self.model.pos_encoding.table)
                     if tc.grid_int8 or tc.encode_int8 else None)

        def density_fn(warped):
            return torch.cat([self.model.density(c, quantized=quantized)
                              for c in warped.split(SWEEP_CHUNK)])
        if full_sweep:
            n_u, n_n = occ.GRID_VOLUME * (self.max_cascade + 1), 1
        else:
            n_u = n_n = occ.GRID_VOLUME // 4
        self.grid = occ.update_grid(
            self.grid, density_fn, self.generator, self.max_cascade,
            decay=tc.density_grid_decay, n_uniform=n_u, n_nonuniform=n_n,
            aabb_min=self.aabb_min, aabb_size=self.aabb_size, jitter=jitter)

    # ------------------------------------------------------------------
    # ray budget
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _march_probe(self, n_rays: int):
        """(surviving segments, samples) the current grid gives n_rays
        rays, from a fixed seed (no network)."""
        g = torch.Generator(device=self.device).manual_seed(0x5E6)
        dr = self.draws(n_rays, g)
        with span("ngp.sample"):
            img, xy, texsamp, _ = self._sample_pixels(self._error_state(),
                                                      dr.u_img, dr.u_xy)
            o, d, _ = self._build_rays(img, xy)
        with span("ngp.march"):
            out = march_and_compact_hier(
                self.grid.bitfield, self.grid.coarse, o, d, dr.u_march,
                n_rays, self.tcfg.march_steps, self.cone_angle,
                self.max_cascade, self.aabb_min, self.aabb_size,
                self.tcfg.target_batch_size, ray_mask=texsamp[:, 0] >= 0.0)
        return out[5], out[4]

    @spanned("ngp.stats")
    def _probe_ray_budget(self):
        """Size the ray count to the segment and sample budgets before the
        first step, so no step trains at a truncating ray count (the
        reference adapts rays_per_batch from measured counts,
        ref: src/testbed_nerf.cu:2890-2891)."""
        tc = self.tcfg
        if not ((tc.adapt_rays or tc.dynamic_rays) and tc.hierarchical_march):
            return
        S = tc.target_batch_size
        seg_cap = S // 8 * 4
        if tc.dynamic_rays:
            segs, total = self._march_probe(tc.n_rays)
            factor = max(segs / (0.9 * seg_cap), total / (0.9 * S), 1.0)
            self._n_live = int(np.clip(tc.n_rays / factor, 128, tc.n_rays))
            return
        for _ in range(6):
            n_rays = tc.n_rays
            segs, total = self._march_probe(n_rays)
            if (segs <= 0.9 * seg_cap and total <= 0.9 * S) or n_rays <= 32:
                break
            factor = max(segs / (0.9 * seg_cap), total / (0.9 * S),
                         2.0 ** 0.5)
            new = max(32, 1 << int(math.floor(math.log2(n_rays / factor))))
            if new == n_rays:
                break
            tc.n_rays = new
        self._rays_floor = min(256, tc.n_rays)

    def _fetch_stats(self, loss: float, measured: int, segs: int,
                     n_rays: int) -> float:
        """Adapt the ray count (live count under dynamic_rays) from the last
        step's counts (ref: NerfCounters::update_after_training)."""
        tc = self.tcfg
        if check_numerics() and not math.isfinite(loss):
            # NGP_TPU_CHECK_NUMERICS=1: a divergence named at the next
            # stats fetch (the JAX trainer's guard, :904-911)
            bad = find_nonfinite(self.params, "params")
            bad += find_nonfinite(self.cam_params, "cam_params")
            raise FloatingPointError(
                f"non-finite loss {loss} at step {self.training_step}; "
                f"non-finite state leaves: {bad or 'none (loss only)'}")
        self.last_loss = loss
        cap = self._seg_capacity
        if cap and segs > cap and not self._warned_segcap:
            warnings.warn(
                f"hierarchical march: {segs} surviving segments exceed the "
                f"{cap} segment capacity — tail rays are dropped this step "
                "(raise target_batch_size or lower n_rays)")
            self._warned_segcap = True
        self.last_surviving_segments = segs
        self.last_samples = measured
        if measured > 0 and tc.dynamic_rays:
            live = max(self._n_live, 1)
            ideal = live * tc.target_batch_size / measured
            if cap and segs > 0:
                ideal = min(ideal, live * 0.9 * cap / segs)
            ideal = min(ideal, live * 2)
            self._n_live = int(np.clip(round(ideal), 128, tc.n_rays))
        elif measured > 0 and tc.adapt_rays:
            ideal = n_rays * tc.target_batch_size / measured
            if cap and segs > 0:
                ideal = min(ideal, n_rays * 0.9 * cap / segs)
            ideal = min(ideal, n_rays * 2)
            new_rays = 1 << int(round(math.log2(max(ideal,
                                                    self._rays_floor))))
            # lattice cap: n_rays · march_steps ≤ 2^24
            lattice_cap = max((1 << 24) // tc.march_steps, 256)
            tc.n_rays = int(min(new_rays, 1 << 18, lattice_cap))
        if measured > 0 and tc.adapt_capacity and self.training_step >= 512:
            need = max(measured * 1.25, segs * 2.25, float(1 << 15))
            self._capacity = int(min(1 << math.ceil(math.log2(need)),
                                     tc.target_batch_size))
        return loss

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def train(self, n_steps: int) -> float:
        """Train exactly ``n_steps`` more steps; returns the mean loss of
        the steps since the last 16-step boundary.

        At each boundary (every ``n_steps_between_grid_updates`` steps) the
        ray count adapts from the last step's counts and the grid is swept:
        fully below step 256 (the ray budget is probed after the first
        sweep), partially after (with the sharpness grid's decay). The
        error-map CDFs are rebuilt at a boundary, or at the start of a
        call, once the rebuild interval has passed."""
        tc = self.tcfg
        cadence = tc.n_steps_between_grid_updates
        importance = (tc.sample_image_proportional_to_error
                      or tc.sample_focal_plane_proportional_to_error)
        loss = self.last_loss
        err_state = self._error_state()
        pending = None      # [loss sum, steps, last total, last segs, n_rays]
        for i in range(n_steps):
            at_boundary = self.training_step % cadence == 0
            if at_boundary and pending is not None:
                with span("ngp.stats"):
                    loss = self._fetch_stats(float(pending[0]) / pending[1],
                                             *pending[2:])
                pending = None
            if (at_boundary or i == 0) and importance and \
                    self._steps_since_error_map_update >= \
                    int(self._error_map_interval):
                err_state = self._error_state()
                self._steps_since_error_map_update = 0
                self._error_map_interval *= 1.5
            warmup = self.training_step < 256
            if at_boundary:
                self._grid_update(full_sweep=warmup)
                if warmup and self.training_step == 0:
                    self._probe_ray_budget()
                if not warmup and self._use_sharpness:
                    self.sharpness_grid *= tc.density_grid_decay
            n_rays = tc.n_rays
            draws = self.draws(n_rays)
            if tc.dynamic_rays:
                draws = draws.head(self._n_live)
            cap = self._capacity if tc.adapt_capacity and not warmup \
                else tc.target_batch_size
            stats = self._train_step(draws, err_state, capacity=cap,
                                     group=self.data_group)
            if pending is None:
                pending = [stats.loss, 0, 0, 0, n_rays]
            else:
                with span("ngp.stats"):
                    pending[0] = pending[0] + stats.loss
            pending[1:4] = [pending[1] + 1, stats.total, stats.seg_total]
            self.training_step += 1
            self._steps_since_error_map_update += 1
        if pending is not None:
            with span("ngp.stats"):
                loss = self._fetch_stats(float(pending[0]) / pending[1],
                                         *pending[2:])
        return loss

    def inference_params(self) -> dict:
        return inference_params(self.params, self.opt_state, self.opt_cfg)

    def get_camera_extrinsics(self, img: int) -> np.ndarray:
        """The optimised camera→world (3, 4) of image ``img`` (ref:
        export_camera_extrinsics, src/testbed_nerf.cu:2557)."""
        with torch.no_grad():
            xf = self._xforms[img]
            R = self._rodrigues(self.cam_params["rot"][img][None])[0]
            out = torch.cat([R @ xf[:, :3],
                             (xf[:, 3] + self.cam_params["trans"][img])[:, None]],
                            -1)
        return out.cpu().numpy()

    @torch.no_grad()
    def sigma_at(self, pos: torch.Tensor,
                 occupied_only: bool = False) -> torch.Tensor:
        """σ at (N, 3) world positions (unwarped) on the trainer's device,
        with the inference (EMA) parameters. ``occupied_only`` sets σ to
        0 where the occupancy bitfield (at the position's own cascade)
        marks the cell empty, as the reference masks the mesh's field by
        its density grid (get_density_on_grid → grid_samples_half_to_float,
        src/testbed_nerf.cu): what the renderer skips is not meshed."""
        warped = (pos - self.aabb_min) / self.aabb_size
        sigma = torch.exp(torch.clamp(functional_call(
            self.model, self.inference_params(), (warped,))[..., 0],
            -15.0, 15.0))
        if occupied_only:
            sigma = torch.where(occ.occupied_at(
                self.grid.bitfield, pos,
                occ.mip_from_pos(pos, self.max_cascade)), sigma, 0.0)
        return sigma

    def density_at(self, pos: np.ndarray) -> np.ndarray:
        """σ at world positions (unwarped), with the inference (EMA)
        parameters."""
        return self.sigma_at(torch.as_tensor(
            np.asarray(pos, np.float32), device=self.device)).cpu().numpy()

    # snapshot I/O ------------------------------------------------------

    def save_snapshot(self, path, network_config: dict,
                      include_optimizer_state: bool = False):
        """Write a snapshot the JAX package's ``NerfTrainer`` loads (ref:
        Testbed::save_snapshot, src/testbed.cu:3008-3042). A blocked grid's
        resolved layout is stamped into the config; ``include_optimizer_state``
        stores the Adam step and moments too."""
        from ngp_tpu_torch import bridge
        from ngp_tpu_torch.io.snapshot import save_snapshot
        enc = self.model.pos_encoding
        if hasattr(enc, "resolved_config"):     # the blocked grid's layout
            network_config = {**network_config, "encoding": {
                **network_config["encoding"], **enc.resolved_config()}}
        adam = bridge.adam_state_to_numpy(self.opt_state, self.model)
        extra = None
        if include_optimizer_state:
            extra = {"ngp_tpu_optimizer": {k: adam[k]
                                           for k in ("step", "mu", "nu")}}
        save_snapshot(
            path, network_config,
            params=bridge.nerf_params_to_numpy(self.params, self.model),
            ema_params=adam["ema_params"],
            density_grid=self.grid.density.cpu().numpy(),
            max_cascade=self.max_cascade, training_step=self.training_step,
            aabb_scale=self.aabb_scale, aabb_min=[self.aabb_min] * 3,
            aabb_max=[float(np.float32(self.aabb_min)
                            + np.float32(self.aabb_size))] * 3,
            rays_per_batch=self.tcfg.n_rays, extra=extra)

    def load_snapshot_state(self, path) -> dict:
        """Restore parameters, EMA, grid (and the Adam step and moments
        when stored) from a snapshot of either package."""
        from ngp_tpu_torch import bridge
        from ngp_tpu_torch.io.snapshot import _unpack_tree, load_snapshot
        doc = load_snapshot(path)
        snap = doc["snapshot"]

        def restore(dst: dict, tree):
            with torch.no_grad():
                for k, v in bridge.nerf_params_from_numpy(
                        tree, self.model).items():
                    dst[k].copy_(v)
        restore(self.params, snap["ngp_tpu_params"])
        restore(self.opt_state.ema_params, snap["ngp_tpu_ema_params"])
        if "ngp_tpu_optimizer" in snap:
            opt = _unpack_tree(snap["ngp_tpu_optimizer"])
            restore(self.opt_state.mu, opt["mu"])
            restore(self.opt_state.nu, opt["nu"])
            self.opt_state = self.opt_state._replace(step=int(opt["step"]))
        if "density_grid" in snap:
            n = self.grid.density.numel()
            self.grid = occ.rebuild_bitfield(self.grid._replace(
                density=torch.as_tensor(snap["density_grid"][:n],
                                        dtype=torch.float32,
                                        device=self.device)))
        self.training_step = int(snap.get("training_step", 0))
        return doc
