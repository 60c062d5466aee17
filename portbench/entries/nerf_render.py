"""NeRF frames: ``NerfRenderer.render`` of pinhole frames along an orbit of
the sphere scene, one frame a call, in the render options of the cell.

The render state is the benchmark's, not a trained one: the occupancy
bitfield is the spheres' analytic occupancy, packed into the bitfield's
layout, and the weights come from the seed with the table and the density
MLP drawn positive, so that density is high wherever the march samples
and rays end within a few samples of their first occupied cell. Set-up
renders the warm-up frames; the window renders the orbit's cameras in
turn from a phase drawn from the seed. After the window a seeded sample
of the window's frames is compared with the plain reference's frames of
the same cameras.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.entries.base import BaseEntry, Sample, frame_metrics, mlp_macs
from portbench.lib import compare, scenes, weights
from portbench.reference import nerf as ref


def orbit_cameras(p: dict, t: dict) -> np.ndarray:
    """The frames' cameras: ``orbit_frames`` positions on a circle at
    height ``orbit_height`` (of the radius) around the cube's centre."""
    n, z, r = int(t["orbit_frames"]), float(t["orbit_height"]), \
        float(p["camera_radius"])
    az = np.arange(n) * 2 * np.pi / n
    eyes = np.stack([np.sqrt(1 - z * z) * np.cos(az),
                     np.sqrt(1 - z * z) * np.sin(az),
                     np.full(n, z)], -1) * r + 0.5
    return np.stack([scenes.look_at(e) for e in eyes]).astype(np.float32)


class Entry(BaseEntry):
    unit = "frame"

    def __init__(self, *a):
        super().__init__(*a)
        self.meta = ref.grid_meta(self.config)
        self.metas = {3: self.meta}
        self.shapes = weights.nerf_shapes(self.config, self.meta)
        self.macs_per_sample = mlp_macs(self.shapes)
        t = self.traffic
        self.W, self.H = (int(x) for x in t["frame"])
        self.focal = 0.5 * self.W / np.tan(0.5 * float(
            self.data["camera_angle_x"]))
        self.cams = orbit_cameras(self.data, t)
        self.k = int(np.random.default_rng(self.seed).integers(len(self.cams)))
        self.kept = Sample(self.seed + 1, int(t["compare_frames"]),
                           int(t["compare_among"]))
        self.samples = []

    def _weights(self):
        w = self.traffic["weights"]
        return weights.draw(self.shapes, self.seed, self.device,
                            table=tuple(w["table"]),
                            density=tuple(w["density"]),
                            mlp_scale=float(w["mlp_scale"]))

    def setup(self):
        from ngp_tpu_torch.nn.models import NerfNetwork
        from ngp_tpu_torch.render.nerf_render import (NerfRenderer,
                                                      RenderOptions)
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        model = NerfNetwork(self.network_config, 1, generator=g,
                            device=self.device)
        self.params = self._weights()
        weights.load_into([dict(model.named_parameters())], self.params)
        self.occ = scenes.sphere_occupancy(self.data, self.device)
        self.bitfield = scenes.pack_bitfield(self.occ)
        opts = RenderOptions(**self.traffic["options"])
        self.renderer = NerfRenderer(model, 0.0, 1.0, 0.0, 0, opts)
        for _ in range(int(self.traffic["warmup_frames"])):
            self._frame(self.k)

    def _frame(self, k: int) -> torch.Tensor:
        r = self.renderer
        img = r.render(self.params, self.bitfield,
                       self.cams[k % len(self.cams)], self.W, self.H,
                       focal=(self.focal, self.focal), spp=1)
        self.event_waits += r.last_event_waits
        self.samples.append(r.last_n_samples)
        return img

    def call(self) -> int:
        self.kept.offer((self.k, self._frame(self.k)))
        self.k += 1
        return 1

    def window_metrics(self, units, window_s, per_call_ms) -> dict:
        s = self.samples[-units:]
        self.note(f"samples evaluated a frame: mean {np.mean(s):.1f}, min "
                  f"{min(s)}, max {max(s)}")
        return frame_metrics(units, window_s, per_call_ms)

    def release(self):
        del self.renderer

    def reference_frames(self, prec: str = "f32") -> list:
        """The reference's frame of each kept frame's camera."""
        # the fused wave renderer's whole-ray cap
        o = self.traffic["options"]
        steps = int(o.get("march_steps", 1024))
        cap = min(int(o.get("wave_cap", 64)) * int(o.get("march_segments", 4)),
                  steps)
        return [ref.frame(self.params, self.config, self.occ,
                          torch.from_numpy(self.cams[k % len(self.cams)]).to(
                              self.device),
                          self.W, self.H, self.focal, cap, steps, prec)
                for k, _ in self.kept.kept]

    def check(self) -> list:
        self.ref = self.reference_frames()
        return compare.frames([(got, want) for (_, got), want
                               in zip(self.kept.kept, self.ref)], self.limits)

    def control(self) -> list:
        return compare.frames(list(zip(self.reference_frames("bf16"),
                                       self.ref)), self.limits)
