"""Image training: ``ImageTrainer.train`` in calls of ``call_steps`` steps on
the seeded test image, from step 0 of a trainer made from the seed.

Set-up makes the image and the trainer, loads the benchmark's weights and
runs the first call; the window goes on with the same trainer. Of the
first call's steps, the first ``follow_steps`` are recorded (each step's
positions and loss, the Adam moments after the first step and the
parameters after the last), and after the window the plain reference
follows them from the same weights. After the window: PSNR of
``ImageTrainer.compute_mse`` over every pixel.
"""
from __future__ import annotations

import math

import torch

from portbench.entries.base import BaseEntry, mlp_macs, step_metrics
from portbench.lib import compare, scenes, weights
from portbench.reference import image as ref


def linear_image(p: dict, device) -> torch.Tensor:
    """The test image as the trainer takes it: linear f32 (H, W, 3)."""
    return scenes.srgb_to_linear(
        scenes.synth_image(p, device).to(torch.float32) / 255.0)


class Entry(BaseEntry):
    unit = "step"
    passes = 3

    def __init__(self, *a):
        super().__init__(*a)
        res = int(self.data["resolution"])
        self.meta = ref.grid_meta(self.config, res, res)
        self.metas = {2: self.meta}
        self.shapes = weights.image_shapes(self.config, self.meta)
        self.macs_per_sample = mlp_macs(self.shapes)
        self.steps = int(self.traffic.get("call_steps", 1))
        self.draw_kw = self.traffic.get("weights", {})

    def _weights(self):
        return weights.draw(self.shapes, self.seed, self.device,
                            **self.draw_kw)

    def make_trainer(self):
        from ngp_tpu_torch.train.image import ImageTrainer
        image = linear_image(self.data, self.device).cpu().numpy()
        batch = int(self.traffic.get("batch_size", 1 << 18))
        tr = ImageTrainer(image, self.network_config, seed=self.seed,
                          batch_size=batch, device=self.device)
        tr.random_mode = self.traffic.get("random_mode", "stratified")
        weights.load_into([tr.params, tr.opt_state.ema_params],
                          self._weights())
        return tr

    def setup(self):
        self.tr = self.make_trainer()
        self.prog = self._first_call()

    def _first_call(self) -> dict:
        tr, n = self.tr, int(self.traffic["follow_steps"])
        rec = {"pos": [], "loss": []}
        b1 = ref.plain.adam_config(self.config["optimizer"])["b1"]
        sample, step = tr.sample_batch, tr.step

        def recording_sample():
            pos = sample()
            if len(rec["pos"]) < n:
                rec["pos"].append(pos.clone())
            return pos

        def recording_step(pos=None):
            k = len(rec["loss"])
            loss = step(pos)
            if k < n:
                rec["loss"].append(loss.detach().clone())
            if k == 0:
                rec["grad"] = {name: torch.linalg.vector_norm(m) / (1 - b1)
                               for name, m in tr.opt_state.mu.items()}
            if k == n - 1:
                w0 = self._weights()
                rec["change"] = {name: torch.linalg.vector_norm(
                    tr.params[name].detach() - w0[name]) for name in w0}
            return loss
        tr.sample_batch, tr.step = recording_sample, recording_step
        try:
            tr.train(self.steps)
        finally:
            del tr.sample_batch, tr.step
        self.positions = rec["pos"]
        return {"loss": [float(x) for x in rec["loss"]],
                "grad": {k: float(v) for k, v in rec["grad"].items()},
                "change": {k: float(v) for k, v in rec["change"].items()}}

    def call(self) -> int:
        self.tr.train(self.steps)
        return self.steps

    def window_metrics(self, units, window_s, per_call_ms) -> dict:
        self.note(f"trainer at step {self.tr.training_step}, last loss "
                  f"{self.tr.last_loss!r}")
        return step_metrics(units, window_s)

    def after_window(self) -> dict:
        return {"psnr_db": -10.0 * math.log10(max(self.tr.compute_mse(),
                                                  1e-12))}

    def release(self):
        del self.tr

    def follow(self, prec: str = "f32") -> dict:
        return ref.follow(self._weights(), self.config,
                          linear_image(self.data, self.device),
                          self.positions, prec)

    def check(self) -> list:
        self.ref = self.follow()
        return compare.training(self.prog, self.ref, self.limits)

    def control(self) -> list:
        low = self.follow("bf16")
        self.detail = {
            "program": compare.leaf_detail(self.prog, self.ref),
            "control": compare.leaf_detail(low, self.ref),
            "numbers": {"program": compare.training_numbers(self.prog,
                                                            self.ref),
                        "control": compare.training_numbers(low, self.ref)}}
        return compare.training(low, self.ref, self.limits)
