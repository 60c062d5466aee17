"""Neural-image engine: fit RGB(uv) with a 2D hash encoding and an MLP
(port of ``ngp_tpu/train/image.py``; ref: src/testbed_image.cu).

A step draws a batch of positions (``rays/sampling.py``), looks the image
up at them (bilinear or snapped to pixel centres, in linear or sRGB
colours), runs the ``EncodedNetwork`` on a 2D blocked grid (K1 on the
card), takes the loss times ``LOSS_SCALE``, backpropagates (the table's
gradient through K2 on the card) and updates the parameters in place with
Adam and the EMA. ``encode_int8`` (the JAX package's
``NGP_TPU_ENCODE_INT8``) runs the encode on the int8-quantised table in
training and inference alike: ``"fwd"`` the 2D K4 forward with the K2
backward, ``"full"`` K4 with the int8 table backward (K5); the table is
quantised at every call, as in the JAX package. The positions of a step
do not require a gradient; a caller's gradient by uv
(``torch.autograd.grad`` of the network at positions that require one)
runs the 2D position backward (K3) in every mode.

Intended divergences from the JAX package: the stratified and uniform
position draws come from a ``torch.Generator`` on the trainer's device
(Halton and Sobol are deterministic and equal the JAX package's); the
weights are initialised from that generator, not from a ``jax.random``
key. ``train(n)`` runs exactly n steps, as the JAX image trainer does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.common import (LOSS_SCALE, linear_to_srgb, mse2psnr,
                                  resolve_device, srgb_to_linear)
from ngp_tpu_torch.config import autofill_hashgrid_config
from ngp_tpu_torch.io.snapshot import (load_encoded_snapshot_state,
                                      save_encoded_snapshot)
from ngp_tpu_torch.kernels.blocked_grid_cuda import check_int8_mode
from ngp_tpu_torch.nn.models import EncodedNetwork
from ngp_tpu_torch.opt.losses import create_loss
from ngp_tpu_torch.opt.optimizers import (AdamConfig, apply_update,
                                          inference_params, init_state)
from ngp_tpu_torch.rays.sampling import sample_positions
from ngp_tpu_torch.utils.profiling import count, span, spanned

# positions per network call when rendering or evaluating
EVAL_CHUNK = 1 << 18


def _eval_image(image: torch.Tensor, pos: torch.Tensor, snap: bool,
                linear_colors: bool):
    """Bilinear (or snapped) lookup of ``image`` (H, W, C), linear f32, at
    ``pos`` (N, 2) in [0, 1]² (ref: eval_image_kernel_and_snap,
    src/testbed_image.cu:173-219). Returns (targets (N, 3), the positions,
    snapped to pixel centres under ``snap``); targets are sRGB unless
    ``linear_colors``."""
    H, W = image.shape[:2]
    res = torch.tensor([W, H], dtype=torch.float32, device=pos.device)
    hi = torch.tensor([W - 1, H - 1], device=pos.device)

    def read(ix, iy):
        v = image[iy, ix, :3]
        return v if linear_colors else linear_to_srgb(v)

    if snap:
        pos_int = torch.floor(pos * res).to(torch.int32)
        snapped = (pos_int.to(torch.float32) + 0.5) / res
        pos_int = torch.minimum(torch.clamp(pos_int, min=0), hi)
        return read(pos_int[:, 0].long(), pos_int[:, 1].long()), snapped
    p = torch.minimum(torch.clamp(pos * res - 0.5, min=0.0),
                      res - (1.0 + 1e-4))
    p0 = p.to(torch.int32)
    w = p - p0.to(torch.float32)
    i0 = torch.minimum(torch.clamp(p0, min=0), hi - 1).long()
    x0, y0 = i0[:, 0], i0[:, 1]
    wx, wy = w[:, 0:1], w[:, 1:2]
    val = ((1 - wx) * (1 - wy) * read(x0, y0) +
           wx * (1 - wy) * read(x0 + 1, y0) +
           (1 - wx) * wy * read(x0, y0 + 1) +
           wx * wy * read(x0 + 1, y0 + 1))
    return val, pos


def pixel_centres(width: int, height: int, device=None) -> torch.Tensor:
    """(H·W, 2) positions of the pixel centres, row-major."""
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    y = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    return torch.stack(torch.meshgrid(x, y, indexing="xy"), -1).reshape(-1, 2)


class ImageTrainer:
    """Model and optimizer state of a neural-image fit, on one device (the
    card unless the caller asks for another). ``image`` is (H, W, C)
    linear float; its first 3 channels are fitted. ``encode_int8`` is the
    encode's int8 mode (``""``, ``"fwd"`` or ``"full"``)."""

    def __init__(self, image: np.ndarray, config: dict, seed: int = 1337,
                 batch_size: int = 1 << 18, device="cuda",
                 encode_int8: str = ""):
        self.encode_int8 = check_int8_mode(encode_int8)
        self.device = dev = resolve_device(device)
        self.image = torch.as_tensor(np.ascontiguousarray(image[..., :3]),
                                     dtype=torch.float32, device=dev)
        self.resolution = (image.shape[1], image.shape[0])   # (W, H)
        enc_cfg = config["encoding"]
        if "grid" in enc_cfg.get("otype", "").lower():
            enc_cfg = autofill_hashgrid_config(
                enc_cfg, n_pos_dims=2,
                desired_resolution=max(self.resolution) / 2.0)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.model = EncodedNetwork(2, 3, enc_cfg, config["network"],
                                    generator=self.generator, device=dev)
        self.loss = create_loss(config.get("loss", {"otype": "L2"}))
        self.opt_cfg = AdamConfig.from_config(config.get("optimizer", {}),
                                              loss_scale=LOSS_SCALE)
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_state(self.params)
        self.matrix_names = self.model.matrix_param_names()
        self.batch_size = batch_size
        self.random_mode = "stratified"
        self.linear_colors = False
        self.snap_to_pixel_centers = False
        self.training_step = 0
        self.last_loss = 0.0

    # -- training ----------------------------------------------------------

    def sample_batch(self) -> torch.Tensor:
        """The positions of the next step (``random_mode``)."""
        return sample_positions(self.random_mode, self.generator,
                                self.batch_size, self.training_step,
                                device=self.device)

    @spanned("ngp.step")
    def step(self, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on ``pos`` (N, 2) (the next sampled batch when None):
        targets, forward, loss × LOSS_SCALE, backward, Adam + EMA in place.
        Returns the loss (0-d, unscaled) without a host sync."""
        with span("ngp.sample"):
            if pos is None:
                pos = self.sample_batch()
            targets, pos = _eval_image(self.image, pos,
                                       self.snap_to_pixel_centers,
                                       self.linear_colors)
        count("samples", pos.shape[0])
        pred = self.model(pos, int8=self.encode_int8)
        with span("ngp.loss"):
            scaled = torch.mean(self.loss(targets, pred.to(torch.float32))) \
                * LOSS_SCALE
            loss = scaled.detach() / LOSS_SCALE
        names = list(self.params)
        with span("ngp.backward"):
            grads = dict(zip(names, torch.autograd.grad(
                scaled, [self.params[k] for k in names])))
        self.opt_state = apply_update(self.params, grads, self.opt_state,
                                      self.opt_cfg, self.matrix_names)
        self.training_step += 1
        return loss

    def train(self, n_steps: int) -> float:
        """Train exactly ``n_steps`` steps; returns the last step's loss."""
        loss = None
        for _ in range(n_steps):
            loss = self.step()
        if loss is not None:
            with span("ngp.stats"):
                self.last_loss = float(loss)
        return self.last_loss

    # -- inference ---------------------------------------------------------

    def inference_params(self) -> dict:
        return inference_params(self.params, self.opt_state, self.opt_cfg)

    @torch.inference_mode()
    def _predict(self, pos: torch.Tensor) -> torch.Tensor:
        """The network (inference parameters) at ``pos`` on the device,
        in chunks of EVAL_CHUNK, in the trainer's int8 mode; (N, 3) f32."""
        p = self.inference_params()
        mode = {"int8": self.encode_int8}
        count("samples", pos.shape[0])
        with span("ngp.network"):
            return torch.cat([functional_call(self.model, p, (c,), mode).to(
                torch.float32) for c in pos.split(EVAL_CHUNK)])

    def eval_positions(self, pos: np.ndarray) -> np.ndarray:
        """The network's output at (N, 2) positions, as numpy."""
        out = self._predict(torch.as_tensor(np.asarray(pos, np.float32),
                                            device=self.device))
        with span("ngp.to_host"):
            return out.cpu().numpy()

    @spanned("ngp.frame")
    def render(self, width: Optional[int] = None,
               height: Optional[int] = None,
               linear: bool = True) -> np.ndarray:
        """The fitted image at (width, height), sampled at pixel centres,
        (H, W, 3) numpy; the network's sRGB output converted to linear
        when ``linear`` (ref: shade_kernel_image)."""
        W = width or self.resolution[0]
        H = height or self.resolution[1]
        with span("ngp.sample"):
            pos = pixel_centres(W, H, self.device)
        img = self._predict(pos).reshape(H, W, 3)
        if linear and not self.linear_colors:
            with span("ngp.composite"):
                img = srgb_to_linear(img)
        with span("ngp.to_host"):
            return img.cpu().numpy()

    @torch.inference_mode()
    def compute_mse(self, quantize_to_byte: bool = False) -> float:
        """MSE over all pixels against the snapped targets (ref:
        Testbed::compute_image_mse, src/testbed_image.cu:461-524), summed
        in f64."""
        W, H = self.resolution
        targets, _ = _eval_image(self.image, pixel_centres(W, H, self.device),
                                 True, self.linear_colors)
        preds = self._predict(pixel_centres(W, H, self.device))
        if quantize_to_byte:
            preds = torch.floor(torch.clamp(preds, 0, 1) * 255.0 + 0.5) / 255.0
        return float(((preds - targets).to(torch.float64) ** 2).mean())

    def psnr(self, quantize_to_byte: bool = False) -> float:
        return mse2psnr(self.compute_mse(quantize_to_byte))

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
