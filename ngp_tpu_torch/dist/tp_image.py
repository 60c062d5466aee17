"""Table-parallel image training (port of ``ngp_tpu/dist/tp_image.py``):
the gigapixel regime, where the hash table outgrows one device.

The 2D blocked grid's (L, R, 128) table is row-sharded over the mesh's
``model`` axis (``dist.mesh.make_tp_blocked_encode``); the MLP is small
and replicated; the batch splits over ``data``. Every data rank draws the
global stratified batch from the same generator and keeps its slice, so
the ranks' slices together are the single-device batch. The loss is
normalised by the global batch and the gradients are summed over
``data``; each rank's table gradient is that of its own rows.

As in the port's ``ImageTrainer``, the batch and the initial weights come
from a ``torch.Generator`` (drawn in ``ImageTrainer``'s order: the whole
table, then the MLP), not from a ``jax.random`` key.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ngp_tpu_torch.common import LOSS_SCALE, mse2psnr, resolve_device
from ngp_tpu_torch.config import autofill_hashgrid_config
from ngp_tpu_torch.dist.mesh import (Mesh, all_reduce_flat_,
                                     batch_sharding, make_tp_blocked_encode,
                                     table_sharding)
from ngp_tpu_torch.nn.models import EncodedNetwork
from ngp_tpu_torch.opt.losses import create_loss
from ngp_tpu_torch.opt.optimizers import (AdamConfig, apply_update,
                                          inference_params, init_state)
from ngp_tpu_torch.rays.sampling import sample_positions
from ngp_tpu_torch.train.image import EVAL_CHUNK, _eval_image


class TpImageTrainer:
    """An image fit with the encoding's table row-sharded over
    ``mesh.model`` and the batch over ``mesh.data``. ``params`` holds
    ``table`` (the rank's (L, R/M, 128) shard) and ``net.weights.<i>``
    (replicated). Every rank of the mesh calls ``step``, ``train``,
    ``eval_positions`` and ``psnr`` together."""

    def __init__(self, image: np.ndarray, config: dict, mesh: Mesh,
                 seed: int = 1337, batch_size: int = 1 << 16,
                 device="cuda"):
        self.mesh = mesh
        self.device = dev = resolve_device(device)
        self.image = torch.as_tensor(np.ascontiguousarray(image[..., :3]),
                                     dtype=torch.float32, device=dev)
        self.resolution = (image.shape[1], image.shape[0])
        enc_cfg = autofill_hashgrid_config(
            dict(config["encoding"]), n_pos_dims=2,
            desired_resolution=max(self.resolution) / 2.0)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # the whole network, as ImageTrainer draws it; the rank keeps its
        # rows of the table
        model = EncodedNetwork(2, 3, enc_cfg, config["network"],
                               generator=self.generator, device=dev)
        self.meta = model.encoding.meta
        self.encode = make_tp_blocked_encode(self.meta, mesh)
        self.mlp = model.net
        self.params = {"table": torch.nn.Parameter(
            model.encoding.table.detach()[
                :, table_sharding(mesh, self.meta.rows)].clone())}
        self.params.update({f"net.{k}": v
                            for k, v in self.mlp.named_parameters()})
        self.matrix_names = {k for k in self.params if k.startswith("net.")}
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.state = init_state(self.params, self.opt_cfg)
        self.batch_size = batch_size
        self.training_step = 0
        self.linear_colors = False

    def _apply(self, params: dict, pos: torch.Tensor) -> torch.Tensor:
        feat = self.encode(params["table"], pos)
        return torch.func.functional_call(
            self.mlp, {k[4:]: v for k, v in params.items()
                       if k.startswith("net.")}, (feat,))

    def step(self, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on the global batch ``pos`` (B, 2) (the next stratified
        batch when None), of which this rank takes its ``data`` slice;
        returns the global loss (0-d, unscaled)."""
        if pos is None:
            pos = sample_positions("stratified", self.generator,
                                   self.batch_size, self.training_step,
                                   device=self.device)
        n_global = pos.shape[0]
        pos = pos[batch_sharding(self.mesh, n_global)]
        targets, pos = _eval_image(self.image, pos, False,
                                   self.linear_colors)
        pred = self._apply(self.params, pos).to(torch.float32)
        per = self.loss(targets, pred)
        scaled = torch.sum(per) / (n_global * per.shape[-1]) * LOSS_SCALE
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(
            scaled, [self.params[k] for k in names])))
        loss = scaled.detach()[None] / LOSS_SCALE
        all_reduce_flat_([*grads.values(), loss], self.mesh.data_group)
        self.state = apply_update(self.params, grads, self.state,
                                  self.opt_cfg, self.matrix_names)
        self.training_step += 1
        return loss[0]

    def train(self, n_steps: int) -> float:
        """Train exactly ``n_steps`` steps; returns the last step's loss."""
        loss = torch.zeros(())
        for _ in range(n_steps):
            loss = self.step()
        return float(loss)

    @torch.no_grad()
    def eval_positions(self, pos: np.ndarray) -> np.ndarray:
        """The network (inference parameters) at (N, 2) positions, the same
        on every rank of a model row; (N, 3) numpy."""
        p = inference_params(self.params, self.state, self.opt_cfg)
        x = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
        return torch.cat([self._apply(p, c).to(torch.float32)
                          for c in x.split(EVAL_CHUNK)]).cpu().numpy()

    def psnr(self, n: int = 1 << 16, seed: int = 0) -> float:
        """PSNR over ``n`` random pixel centres (the whole image is host-loop
        territory for gigapixel inputs)."""
        rng = np.random.default_rng(seed)
        pos = torch.from_numpy(rng.random((n, 2), np.float32)).to(
            self.device)
        targets, spos = _eval_image(self.image, pos, True,
                                    self.linear_colors)
        preds = self.eval_positions(spos.cpu().numpy())
        return mse2psnr(float(np.mean((preds - targets.cpu().numpy()) ** 2)))

    def table_shard_bytes(self) -> int:
        """Bytes of this rank's table shard: the table's share per rank."""
        t = self.params["table"]
        return t.numel() * t.element_size()

