"""SDF engine: fit the signed distance of a mesh (port of
``ngp_tpu/train/sdf.py``; ref: src/testbed_sdf.cu).

The ground truth comes from the host BVH (``data/mesh.py``): training-data
generation, not the hot loop. A batch mixes the reference's sample kinds
(generate_training_samples_sdf, src/testbed_sdf.cu:1092-1180): 4/8 exact
surface points (distance 0), 3/8 surface points moved by a logistic
perturbation, 1/8 uniform in the unit cube, shuffled. The draws come from
``np.random.default_rng(seed)`` in the JAX package's order, and the BVH is
the same C++, so for one seed the batches are the JAX package's bit for
bit. The step runs the ``EncodedNetwork`` on a 3D blocked grid (K1 forward,
K2 table backward on the card) and updates the parameters in place with
Adam and the EMA. ``encode_int8`` (the JAX package's
``NGP_TPU_ENCODE_INT8``) runs the encode on the int8-quantised table in
training and inference: ``"fwd"`` K4 with K2, ``"full"`` K4 with K5.

An ``otype: Takikawa`` encoding (``nn/takikawa.py``) is built here from
2^18 surface samples of the mesh, as the JAX trainer builds it; the model
is then an ``EncodedNetwork`` over it (parameters ``encoding.table`` and
``net.weights.<i>``, the JAX tree's ``encoding`` and ``net``), and the
1/8 uniform samples are drawn inside the surface leaves of an octree of
depth ``octree_depth`` (ref: uniform_octree_sample_kernel,
src/testbed_sdf.cu:1118-1143), with the perturbation clamped to the leaf
size. ``calculate_iou`` then counts a sample outside the octree as agreeing
(ref: compare_signs_kernel, src/testbed_sdf.cu:464-466). Intended
divergence: the weights are initialised from a ``torch.Generator``, not
from a ``jax.random`` key.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.common import LOSS_SCALE, resolve_device
from ngp_tpu_torch.config import autofill_hashgrid_config
from ngp_tpu_torch.data.mesh import TriangleBvh, load_mesh
from ngp_tpu_torch.io.snapshot import (load_encoded_snapshot_state,
                                      save_encoded_snapshot)
from ngp_tpu_torch.kernels.blocked_grid_cuda import check_int8_mode
from ngp_tpu_torch.nn.models import EncodedNetwork
from ngp_tpu_torch.nn.takikawa import TakikawaEncoding, TakikawaMeta
from ngp_tpu_torch.opt.losses import create_loss
from ngp_tpu_torch.opt.optimizers import (AdamConfig, apply_update,
                                          inference_params, init_state)

# positions per network call when evaluating distances
EVAL_CHUNK = 1 << 18


class SdfTrainer:
    """Mesh, BVH, model and optimizer state of an SDF fit, on one device
    (the card unless the caller asks for another); ``encode_int8`` is the
    encode's int8 mode (``""``, ``"fwd"`` or ``"full"``)."""

    def __init__(self, mesh_path, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 18,
                 sign_mode: int = TriangleBvh.MODE_RAYSTAB, device="cuda",
                 encode_int8: str = "",
                 use_octree_uniform: Optional[bool] = None,
                 octree_depth: int = 7):
        self.encode_int8 = check_int8_mode(encode_int8)
        self.device = dev = resolve_device(device)
        self.vertices, self.faces, self.mesh_scale, self.mesh_offset = \
            load_mesh(mesh_path)
        self.bvh = TriangleBvh(self.vertices, self.faces)
        self.sign_mode = sign_mode
        enc_cfg = config["encoding"]
        takikawa = enc_cfg.get("otype", "").lower() == "takikawa"
        if "grid" in enc_cfg.get("otype", "").lower():
            enc_cfg = autofill_hashgrid_config(enc_cfg, n_pos_dims=3,
                                               desired_resolution=2048.0)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.tak_encoding = None
        if takikawa:
            # the octree encoding over the mesh's surface (ref:
            # takikawa_encoding.cuh; src/testbed.cu:2401-2420)
            surf = self.bvh.sample_surface(1 << 18,
                                           np.random.default_rng(seed))
            self.tak_encoding = TakikawaEncoding(
                TakikawaMeta.from_config(enc_cfg), surf, self.generator, dev)
        self.model = EncodedNetwork(3, 1, enc_cfg, config["network"],
                                    generator=self.generator, device=dev,
                                    encoding=self.tak_encoding)
        self.loss = create_loss(config.get("loss", {"otype": "MAPE"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_state(self.params, self.opt_cfg)
        self.matrix_names = self.model.matrix_param_names()
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.training_step = 0
        self.last_loss = 0.0
        # perturbation scale relative to the unit cube (ref: :1120-1132)
        self.perturb_sigma = 1.0 / 1024.0 * 4.0
        # octree-uniform sampling: the surface leaves at octree_depth are
        # the voxels of 2^19 surface samples dilated by one voxel (a cover
        # of the leaves the triangles cross), kept in the JAX trainer's
        # set insertion order so that the batches are its bits
        self.use_octree_uniform = bool(takikawa if use_octree_uniform is None
                                       else use_octree_uniform)
        self.octree_depth = int(octree_depth)
        if self.use_octree_uniform:
            res = 1 << self.octree_depth
            surf = self.bvh.sample_surface(1 << 19, self.rng)
            vox = np.clip((surf * res).astype(np.int64), 0, res - 1)
            occ_set = set()
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        v = np.clip(vox + [dx, dy, dz], 0, res - 1)
                        occ_set.update(np.unique(
                            (v[:, 2] * res + v[:, 1]) * res + v[:, 0]))
            flat = np.fromiter(occ_set, np.int64)
            self._octree_leaves = np.stack(
                [flat % res, (flat // res) % res, flat // (res * res)],
                -1).astype(np.float32)
            # ref clamps the perturbation to the leaf size (:1131)
            self.perturb_sigma = min(self.perturb_sigma,
                                     2.0 ** (1 - self.octree_depth))
        # host seconds of each batch generate_training_batch made, newest
        # last (the BVH's queries dominate)
        self.batch_seconds: list = []

    # -- data generation (host, BVH) ------------------------------------

    def generate_training_batch(self):
        """(positions (B, 3), distances (B,)) numpy, the reference's
        mixture; surface points get distance 0 without a BVH query."""
        t0 = time.perf_counter()
        B = self.batch_size
        n_surf = B // 2
        n_pert = B * 3 // 8
        n_unif = B - n_surf - n_pert
        surf = self.bvh.sample_surface(n_surf, self.rng)
        d_surf = np.zeros(n_surf, np.float32)
        base = self.bvh.sample_surface(n_pert, self.rng)
        pert = base + self.rng.logistic(
            0.0, self.perturb_sigma, (n_pert, 3)).astype(np.float32)
        pert = np.clip(pert, 0.0, 1.0)
        if self.use_octree_uniform:
            res = 1 << self.octree_depth
            idx = self.rng.integers(0, len(self._octree_leaves), n_unif)
            unif = ((self._octree_leaves[idx] +
                     self.rng.random((n_unif, 3), np.float32)) /
                    res).astype(np.float32)
        else:
            unif = self.rng.random((n_unif, 3), np.float32)
        queries = np.concatenate([pert, unif], 0)
        d_q = self.bvh.signed_distance(queries, mode=self.sign_mode)
        pos = np.concatenate([surf, queries], 0)
        dist = np.concatenate([d_surf, d_q], 0)
        perm = self.rng.permutation(B)   # ref: train_sdf's shuffle
        self.batch_seconds.append(time.perf_counter() - t0)
        return pos[perm], dist[perm]

    # -- training --------------------------------------------------------

    def _step_grads(self, pos, dist) -> tuple:
        """A step's forward and backward on a batch (numpy or tensors),
        without the update: (the loss × LOSS_SCALE, {name: gradient})."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        target = torch.as_tensor(dist, dtype=torch.float32,
                                 device=self.device)
        pred = self.model(pos, int8=self.encode_int8)[:, 0].to(torch.float32)
        scaled = torch.mean(self.loss(target, pred)) * LOSS_SCALE
        names = list(self.params)
        return scaled, dict(zip(names, torch.autograd.grad(
            scaled, [self.params[k] for k in names])))

    def step(self, pos, dist) -> torch.Tensor:
        """One step on a batch (numpy or tensors): forward, loss ×
        LOSS_SCALE, backward, Adam + EMA in place. Returns the loss (0-d,
        unscaled) without a host sync."""
        scaled, grads = self._step_grads(pos, dist)
        self.opt_state = apply_update(self.params, grads, self.opt_state,
                                      self.opt_cfg, self.matrix_names)
        self.training_step += 1
        return scaled.detach() / LOSS_SCALE

    def train(self, n_steps: int) -> float:
        """Train exactly ``n_steps`` steps, pipelined as the JAX package
        does: the next batch's BVH queries run on a host thread while the
        device runs the current step, so a call draws n + 1 batches (the
        last one unused). Returns the last step's loss."""
        loss = None
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.generate_training_batch)
            for _ in range(n_steps):
                pos, dist = fut.result()
                fut = pool.submit(self.generate_training_batch)
                loss = self.step(pos, dist)
            fut.result()
        if loss is not None:
            self.last_loss = float(loss)
        return self.last_loss

    # -- inference / eval -------------------------------------------------

    def inference_params(self) -> dict:
        return inference_params(self.params, self.opt_state, self.opt_cfg)

    @torch.inference_mode()
    def distance(self, pos: torch.Tensor) -> torch.Tensor:
        """The network's distance (inference parameters, the trainer's
        int8 mode) at (n, 3) positions on the trainer's device."""
        return functional_call(self.model, self.inference_params(), (pos,),
                               {"int8": self.encode_int8})[:, 0].to(
                                   torch.float32)

    def distance_at(self, pos: np.ndarray,
                    chunk: int = EVAL_CHUNK) -> np.ndarray:
        """``distance`` at (N, 3) positions, in chunks, as numpy."""
        pos = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
        return torch.cat([self.distance(c) for c in pos.split(chunk)]
                         ).cpu().numpy()

    def calculate_iou(self, n_samples: int = 1 << 21, seed: int = 0,
                      block: int = 1 << 22) -> float:
        """IoU of the inside sets (distance ≤ 0) of the network and of the
        BVH's ground truth over uniform samples of the unit cube (ref:
        Testbed::calculate_iou, src/testbed_sdf.cu:1269), in blocks."""
        rng = np.random.default_rng(seed)
        inter = union = 0
        remaining = int(n_samples)
        while remaining > 0:
            n = min(block, remaining)
            pts = rng.random((n, 3), np.float32)
            gt = self.bvh.signed_distance(pts, mode=self.sign_mode) <= 0
            pred = self.distance_at(pts) <= 0
            if self.tak_encoding is not None:
                # outside the octree the network has no features: the
                # reference counts such samples as agreeing
                inside = self.tak_encoding.contains(torch.as_tensor(
                    pts, device=self.device)).cpu().numpy()
                pred = np.where(inside, pred, gt)
            inter += int(np.logical_and(gt, pred).sum())
            union += int(np.logical_or(gt, pred).sum())
            remaining -= n
        return float(inter) / max(float(union), 1.0)

    # snapshot I/O ------------------------------------------------------

    def save_snapshot(self, path, network_config: dict,
                      include_optimizer_state: bool = False):
        """Parameters, EMA and step, as the JAX testbed saves a generic
        trainer: it stores no optimizer state, so neither does this
        (``include_optimizer_state`` is accepted and ignored)."""
        save_encoded_snapshot(path, network_config, self)

    def load_snapshot_state(self, path) -> dict:
        """Restore parameters, EMA and step from a snapshot of either
        package."""
        return load_encoded_snapshot_state(path, self)
