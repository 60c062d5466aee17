"""Neural-volume engine: fit (RGB, density) to a reference density volume
(port of ``ngp_tpu/train/volume.py``; ref: src/testbed_volume.cu).

Training targets come from Woodcock (delta) tracking of random rays
through the ground-truth grid towards a procedural sky and sun; the
network (an ``EncodedNetwork`` 3 → 4 on a 3D blocked grid: K1 and K2 on
the card, K4 and K5 under ``encode_int8``) learns emission (RGB) and
density at positions.

The walk is vectorised over all rays at once: ``N_EVENTS`` tensor steps,
each one majorant-distance event for every ray, with per-ray alive masks
(the JAX package's ``lax.scan``; the reference runs a per-thread event
loop, ref :88-157). Its random numbers are drawn apart, by
``woodcock_draws`` from the trainer's ``torch.Generator``, and handed to
``woodcock_targets``: the JAX package draws them from ``jax.random`` key
splits, which a test can feed to the walk instead.

Intended divergences from the JAX package: the weights and the walk's
draws come from one ``torch.Generator`` seeded with ``seed`` (the JAX
trainer initialises from ``PRNGKey(seed)`` and walks from
``PRNGKey(7)``); ``train(n)`` runs exactly n steps, as the JAX volume
trainer does. The walk's directions are unit vectors, ray by ray, as the
reference normalises them: the JAX walk divides the start direction, the
scatter draw and the new direction by ``jnp.linalg.norm(x, -1,
keepdims=True)`` (ngp_tpu/train/volume.py:107,132,135), where -1 is the
``ord`` argument, a matrix norm of the whole batch, so its rays take steps
hundreds of times too short and its samples stay next to the AABB's faces.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.common import LOSS_SCALE, resolve_device
from ngp_tpu_torch.config import autofill_hashgrid_config
from ngp_tpu_torch.data.nanovdb import (VolumeGrid, load_volume_grid,
                                        make_procedural_plume)
from ngp_tpu_torch.io.snapshot import (load_encoded_snapshot_state,
                                      save_encoded_snapshot)
from ngp_tpu_torch.kernels.blocked_grid_cuda import check_int8_mode
from ngp_tpu_torch.nn.models import EncodedNetwork
from ngp_tpu_torch.opt.losses import create_loss
from ngp_tpu_torch.opt.optimizers import (AdamConfig, apply_update,
                                          inference_params, init_state)
from ngp_tpu_torch.rays.camera import ray_aabb_intersect

# positions per network call when evaluating
EVAL_CHUNK = 1 << 18


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def sky_color(dir: torch.Tensor, sun_dir, sky_col=(0.35, 0.45, 0.7)):
    """Procedural sky and sun along unit directions (N, 3) (the shape of
    the reference's proc_envmap); (N, 3)."""
    dev = dir.device
    sun = torch.as_tensor(np.asarray(sun_dir, np.float32), device=dev)
    sun = sun / torch.linalg.norm(sun)
    d = torch.sum(dir * sun[None], -1)
    sky = torch.tensor(sky_col, dtype=torch.float32, device=dev)[None] * (
        0.6 + 0.4 * torch.clamp(dir[:, 2:3], 0, 1))
    sunlight = torch.clamp(d, 0, 1)[:, None] ** 64 * 4.0
    return sky + sunlight * torch.tensor([1.0, 0.9, 0.7], device=dev)[None]


def woodcock_draws(generator: torch.Generator, n: int, n_events: int,
                   device) -> dict:
    """The random numbers of one walk of n rays over n_events events, in
    the JAX package's order of use: start points ``p0`` (n, 3) normal,
    aim points ``tgt`` (n, 3) uniform; per event the free-flight draw
    ``u_step`` (E, n), the collision draw ``u_event`` (E, n), the density
    lookup's jitter ``u_jitter`` (E, n, 3), all uniform, and the scatter
    direction ``n_dir`` (E, n, 3) normal."""
    def uni(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=device)
    return {"p0": nrm(n, 3), "tgt": uni(n, 3),
            "u_step": uni(n_events, n), "u_event": uni(n_events, n),
            "u_jitter": uni(n_events, n, 3), "n_dir": nrm(n_events, n, 3)}


class VolumeTrainer:
    """Ground-truth grid, model and optimizer state of a neural-volume
    fit, on one device (the card unless the caller asks for another).
    ``source`` is a ``VolumeGrid``, a path (``.nvdb`` or ``.npy``) or a
    dense (X, Y, Z) array; ``encode_int8`` is the encode's int8 mode
    (``""``, ``"fwd"`` or ``"full"``)."""

    N_EVENTS = 16   # walk length (ref caps at 128 iters / 6 stored verts)

    def __init__(self, source, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 17, albedo: float = 0.95,
                 scattering: float = 0.0, distance_scale: float = 100.0,
                 device="cuda", encode_int8: str = ""):
        self.encode_int8 = check_int8_mode(encode_int8)
        self.device = dev = resolve_device(device)
        if isinstance(source, VolumeGrid):
            self.grid = source
        elif isinstance(source, (str, os.PathLike)):
            self.grid = load_volume_grid(source)
        else:
            self.grid = VolumeGrid(np.asarray(source))
        self.albedo = albedo
        self.scattering = scattering
        self.distance_scale = distance_scale
        enc_cfg = config["encoding"]
        if "grid" in enc_cfg.get("otype", "").lower():
            enc_cfg = autofill_hashgrid_config(
                enc_cfg, 3, desired_resolution=self.grid.world2index_scale)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # 4 outputs: RGB + density; output_activation per config (ReLU)
        self.model = EncodedNetwork(3, 4, enc_cfg, config["network"],
                                    generator=self.generator, device=dev)
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_state(self.params, self.opt_cfg)
        self.matrix_names = self.model.matrix_param_names()
        self.batch_size = batch_size
        self.training_step = 0
        self.last_loss = 0.0
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)
        g = self.grid

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.dense = vec(g.dense)
        self.aabb_min, self.aabb_max = vec(g.aabb_min), vec(g.aabb_max)
        self._w2i_offset = vec(g.world2index_offset)
        self._index_min = vec(g.index_bbox_min)
        self._shape_max = torch.tensor(g.dense.shape, device=dev) - 1

    # -- ground truth ------------------------------------------------------

    def gt_density(self, pos: torch.Tensor,
                   jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The ground-truth density at world positions (N, 3): the voxel
        at pos·scale + offset (+ ``jitter`` in [0, 1)³, the walk's
        stochastic lookup, as the reference's), clipped to the grid."""
        idx = pos * self.grid.world2index_scale + self._w2i_offset
        if jitter is not None:
            idx = idx + jitter
        i = torch.minimum(torch.clamp((idx - self._index_min).to(
            torch.int32), min=0), self._shape_max).long()
        return self.dense[i[:, 0], i[:, 1], i[:, 2]]

    # -- training ----------------------------------------------------------

    def woodcock_targets(self, draws: dict):
        """Multi-event Woodcock (delta-tracking) walk (ref:
        volume_generate_training_data_kernel, src/testbed_volume.cu:88-157)
        on ``draws`` (``woodcock_draws``): every majorant event records a
        (position, ground-truth density) vertex; at real collisions the
        walk scatters (dir ← normalize(dir·scattering + random)) with
        probability albedo or absorbs (throughput 0); every vertex of a
        walk gets the same colour target, the sky along the walk's final
        direction times its throughput. Returns (positions (E·n, 3),
        targets (E·n, 4), record mask (E·n,)), event-major."""
        g = self.grid
        lo, hi = self.aabb_min, self.aabb_max
        p0 = draws["p0"]
        n = p0.shape[0]
        p0 = p0 / torch.linalg.norm(p0, dim=-1, keepdim=True) * 2.0 + 0.5
        tgt = draws["tgt"] * (hi - lo) + lo
        d0 = _normalize(tgt - p0)
        tmin, tmax = ray_aabb_intersect(p0, d0, lo, hi)
        pos = p0 + (torch.clamp(tmin, min=0.0) + 1e-6)[:, None] * d0
        majorant = max(g.global_majorant, 1e-9)
        scale = self.distance_scale / majorant
        dir, alive = d0, tmax > tmin
        through = torch.ones(n, device=p0.device)
        out_pos, out_dens, out_rec = [], [], []
        for e in range(draws["u_step"].shape[0]):
            step = -torch.log(torch.clamp(draws["u_step"][e], min=1e-9)) \
                / scale
            pos = pos + step[:, None] * dir
            inside = torch.all((pos >= lo) & (pos <= hi), -1)
            alive = alive & inside                     # escape ends walk
            dens = self.gt_density(pos, draws["u_jitter"][e])
            record = alive                             # every event trains
            ext = dens / majorant
            z = draws["u_event"][e]
            scatter = z < ext * self.albedo
            absorb = (~scatter) & (z < ext)
            new_dir = _normalize(dir * self.scattering
                                 + _normalize(draws["n_dir"][e]))
            dir = torch.where((scatter & alive)[:, None], new_dir, dir)
            through = torch.where(absorb & alive, 0.0, through)
            alive = alive & ~absorb
            out_pos.append(pos)
            out_dens.append(dens)
            out_rec.append(record)
        # walk colour target: the sky along the final direction ×
        # throughput (ref: proc_envmap(dir, ...) * throughput, :147)
        col = sky_color(dir, self.sun_dir) * through[:, None]
        E = len(out_pos)
        target = torch.cat([col[None].expand(E, n, 3),
                            torch.stack(out_dens)[..., None]], -1)
        return (torch.stack(out_pos).reshape(E * n, 3),
                target.reshape(E * n, 4), torch.stack(out_rec).reshape(-1))

    def step(self, draws: Optional[dict] = None) -> torch.Tensor:
        """One step on a walk of batch_size / N_EVENTS rays (``draws``, or
        the next ones from the trainer's generator): forward, the loss
        over the recorded vertices × LOSS_SCALE, backward, Adam + EMA in
        place. Returns the loss (0-d, unscaled) without a host sync."""
        if draws is None:
            draws = woodcock_draws(self.generator,
                                   self.batch_size // self.N_EVENTS,
                                   self.N_EVENTS, self.device)
        pos, target, valid = self.woodcock_targets(draws)
        pred = self.model(pos, int8=self.encode_int8).to(torch.float32)
        per = self.loss(target, pred) * valid[:, None]
        scaled = torch.sum(per) / torch.clamp(valid.sum(), min=1) \
            * LOSS_SCALE
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(
            scaled, [self.params[k] for k in names])))
        self.opt_state = apply_update(self.params, grads, self.opt_state,
                                      self.opt_cfg, self.matrix_names)
        self.training_step += 1
        return scaled.detach() / LOSS_SCALE

    def train(self, n_steps: int) -> float:
        """Train exactly ``n_steps`` steps; returns the last step's loss."""
        loss = None
        for _ in range(n_steps):
            loss = self.step()
        if loss is not None:
            self.last_loss = float(loss)
        return self.last_loss

    # -- inference ---------------------------------------------------------

    def inference_params(self) -> dict:
        return inference_params(self.params, self.opt_state, self.opt_cfg)

    @torch.inference_mode()
    def predict(self, pos: torch.Tensor, params: Optional[dict] = None
                ) -> torch.Tensor:
        """The network's (r, g, b, density) at (N, 3) positions on the
        device, with ``params`` (the inference parameters by default), in
        the trainer's int8 mode, in chunks of EVAL_CHUNK; (N, 4) f32."""
        p = self.inference_params() if params is None else params
        mode = {"int8": self.encode_int8}
        return torch.cat([functional_call(self.model, p, (c,), mode).to(
            torch.float32) for c in pos.split(EVAL_CHUNK)])

    def rgba_at(self, pos: np.ndarray) -> np.ndarray:
        """``predict`` at (N, 3) positions, as numpy."""
        return self.predict(torch.as_tensor(
            np.asarray(pos, np.float32), device=self.device)).cpu().numpy()

    # snapshot I/O ------------------------------------------------------

    def save_snapshot(self, path, network_config: dict,
                      include_optimizer_state: bool = False):
        """Parameters, EMA and step, as the JAX testbed saves a generic
        trainer (``include_optimizer_state`` is accepted and ignored)."""
        save_encoded_snapshot(path, network_config, self)

    def load_snapshot_state(self, path) -> dict:
        """Restore parameters, EMA and step from a snapshot of either
        package."""
        return load_encoded_snapshot_state(path, self)


def default_plume_trainer(config: dict, **kw) -> VolumeTrainer:
    """A trainer on the procedural plume (``make_procedural_plume``)."""
    return VolumeTrainer(VolumeGrid(make_procedural_plume()), config, **kw)
