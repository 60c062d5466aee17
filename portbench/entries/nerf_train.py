"""NeRF training: ``NerfTrainer.train`` in calls of ``call_steps`` steps on
the seeded sphere views, from step 0 of a trainer made from the seed.

Set-up makes the views and the trainer, loads the benchmark's weights and
runs the first call; the window goes on with the same trainer. Of the
first call's steps, the first ``follow_steps`` are recorded (the random
draws each step took and the positions of the first sweep, the occupancy
grid the steps marched through, each step's loss, the Adam moments after
the first step, and the parameters and their moving average after the
last), and after the window the plain reference sweeps the grid itself
at those positions and follows the steps from the same weights on its
own grid. The program's grid is compared with the reference's apart
(``grid_off``, the share of cells that differ). After the window: PSNR
of the held-out views rendered by the static renderer with the inference
(EMA) parameters.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.entries.base import BaseEntry, mlp_macs, step_metrics
from portbench.lib import compare, scenes, weights
from portbench.reference import nerf as ref


def nerf_dataset(p: dict, xfs: np.ndarray, u8: np.ndarray):
    """The port's dataset of square views ``u8`` seen by cameras ``xfs``
    (an aabb_scale-1 scene, pinhole cameras, centred principal point)."""
    from ngp_tpu_torch.data.nerf_loader import LazyImageArray, NerfDataset
    n, res, fl = len(xfs), int(p["resolution"]), scenes.focal_px(p)
    return NerfDataset(
        images=LazyImageArray(u8), xforms=xfs, xforms_end=xfs.copy(),
        focal=np.full((n, 2), fl, np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        resolution=np.full((n, 2), res, np.int32),
        lens_params=np.zeros((n, 7), np.float32), lens_is_opencv=False,
        depth_images=None, aabb_scale=1, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(n, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32), images_u8=u8)


def psnr(pred: torch.Tensor, gt_u8: torch.Tensor) -> float:
    """PSNR in sRGB of a linear frame over black against a view."""
    gt = scenes.u8_to_linear(gt_u8)[..., :3]
    mse = torch.mean((scenes.linear_to_srgb(torch.clamp(pred[..., :3], 0, 1))
                      - scenes.linear_to_srgb(torch.clamp(gt, 0, 1))) ** 2)
    return -10.0 * math.log10(max(float(mse), 1e-12))


class Entry(BaseEntry):
    unit = "step"
    passes = 3

    def __init__(self, *a):
        super().__init__(*a)
        self.meta = ref.grid_meta(self.config)
        self.metas = {3: self.meta}
        self.shapes = weights.nerf_shapes(self.config, self.meta)
        self.macs_per_sample = mlp_macs(self.shapes)
        self.steps = int(self.traffic["call_steps"])
        self.rays = []          # the ray count after each window call

    def setup(self):
        from ngp_tpu_torch.train.nerf import NerfTrainer, NerfTrainerConfig
        p = self.data
        self.xfs, self.held = scenes.orbit(p)
        u8 = scenes.views(p, self.xfs, self.device).cpu().numpy()
        self.tcfg = NerfTrainerConfig(**self.traffic.get("trainer", {}))
        tr = NerfTrainer(nerf_dataset(p, self.xfs, u8), self.network_config,
                         seed=self.seed, tcfg=self.tcfg, device=self.device)
        weights.load_into([tr.params, tr.opt_state.ema_params],
                          weights.draw(self.shapes, self.seed, self.device))
        self.tr = tr
        self.prog = self._first_call()

    def _first_call(self) -> dict:
        """Run the first call, recording what the reference follows."""
        import ngp_tpu_torch.grid.occupancy as occ
        tr, n = self.tr, int(self.traffic["follow_steps"])
        rec = {"draws": [], "loss": []}
        b1 = ref.plain.adam_config(self.config["optimizer"])["b1"]
        step, sweep = tr._train_step, occ.update_grid

        def recording_step(draws, err, capacity=None, group=None):
            k = len(rec["draws"])
            if k == 0:
                rec["occ"] = scenes.unpack_bitfield(tr.grid.bitfield)
            if k < n:
                rec["draws"].append({
                    "u_img": draws.u_img.clone(), "u_xy": draws.u_xy.clone(),
                    "u_march": draws.u_march.clone(), "bg": draws.bg.clone()})
            stats = step(draws, err, capacity, group)
            if k < n:
                rec["loss"].append(stats.loss.detach().clone())
            if k == 0:
                rec["grad"] = {name: torch.linalg.vector_norm(m) / (1 - b1)
                               for name, m in tr.opt_state.mu.items()}
            if k == n - 1:
                w0 = weights.draw(self.shapes, self.seed, self.device)
                rec["change"] = {name: torch.linalg.vector_norm(
                    tr.params[name].detach() - w0[name]) for name in w0}
                rec["ema_change"] = {name: torch.linalg.vector_norm(
                    tr.opt_state.ema_params[name] - w0[name])
                    for name in w0}
            return stats

        def recording_sweep(grid, density_fn, *a, **kw):
            if "sweep" in rec:
                return sweep(grid, density_fn, *a, **kw)
            seen = []

            def fn(pos):
                seen.append(pos.detach().clone())
                return density_fn(pos)
            out = sweep(grid, fn, *a, **kw)
            rec["sweep"] = torch.cat(seen)
            return out
        tr._train_step = recording_step
        occ.update_grid = recording_sweep
        try:
            tr.train(self.steps)
        finally:
            del tr._train_step
            occ.update_grid = sweep
        self.sweep_positions = rec.pop("sweep")
        self.draws = rec.pop("draws")
        self.occ = rec.pop("occ")
        self.note(f"first call: rays {tr.tcfg.n_rays}, samples "
                  f"{tr.last_samples}, surviving segments "
                  f"{tr.last_surviving_segments}")
        return {"loss": [float(x) for x in rec["loss"]],
                "grad": {k: float(v) for k, v in rec["grad"].items()},
                "change": {k: float(v) for k, v in rec["change"].items()},
                "ema_change": {k: float(v)
                               for k, v in rec["ema_change"].items()}}

    def call(self) -> int:
        self.tr.train(self.steps)
        self.rays.append(self.tr.tcfg.n_rays)
        return self.steps

    def window_metrics(self, units, window_s, per_call_ms) -> dict:
        counts = {r: self.rays.count(r) for r in sorted(set(self.rays))}
        self.note(f"trainer at step {self.tr.training_step}: calls by ray "
                  f"count {counts}; last samples {self.tr.last_samples}")
        return step_metrics(units, window_s)

    @torch.no_grad()
    def after_window(self) -> dict:
        from ngp_tpu_torch.render.nerf_render import (NerfRenderer,
                                                      RenderOptions)
        p, tr = self.data, self.tr
        res, fl = int(p["resolution"]), scenes.focal_px(p)
        r = NerfRenderer.for_trainer(tr, RenderOptions(
            width=res, height=res, background=(0, 0, 0, 0), linear_out=True))
        gts = scenes.views(p, self.held, self.device)
        vals = [psnr(r.render(tr.inference_params(), tr.grid.bitfield, xf,
                              res, res, focal=(fl, fl), spp=1), gt)
                for xf, gt in zip(self.held, gts)]
        self.note("held-out PSNR by view: "
                  + ", ".join(f"{v:.4f}" for v in vals))
        return {"psnr_db": sum(vals) / len(vals)}

    def release(self):
        del self.tr

    def reference_inputs(self) -> dict:
        p, dev = self.data, self.device
        n = len(self.xfs)
        res, fl = int(p["resolution"]), scenes.focal_px(p)
        return {"u8": scenes.views(p, self.xfs, dev),
                "xforms": torch.from_numpy(self.xfs).to(dev),
                "focal": torch.tensor(fl, dtype=torch.float32, device=dev),
                "focal_xy": torch.full((n, 2), fl, device=dev),
                "res_xy": torch.full((n, 2), float(res), device=dev)}

    def follow(self, data: dict, grid: tuple, prec: str = "f32") -> dict:
        """The reference's steps on ``grid`` (occupancy, mean density)."""
        return ref.follow(weights.draw(self.shapes, self.seed, self.device),
                          self.config, data, *grid, self.draws,
                          self.tcfg.march_steps, self.tcfg.target_batch_size,
                          prec)

    def sweep(self, data: dict, prec: str = "f32") -> tuple:
        """The reference's first sweep at the recorded positions:
        (occupancy, mean density)."""
        return ref.first_sweep(
            weights.draw(self.shapes, self.seed, self.device), self.meta,
            self.sweep_positions, ref.seen_cells(
                data["xforms"], data["focal_xy"], data["res_xy"]), prec)

    def check(self) -> list:
        # each sweep position lies in its own cell, to rounding
        x = self.sweep_positions * ref.GRID
        i = torch.arange(x.shape[0], device=x.device)
        lo = torch.stack([i % ref.GRID, (i // ref.GRID) % ref.GRID,
                          i // ref.GRID ** 2], -1).to(x.dtype)
        outside = int(((x < lo - 1e-3) | (x > lo + 1 + 1e-3)).any(-1).sum())
        self.data_ref = self.reference_inputs()
        grid = self.sweep(self.data_ref)
        self.ref_occ = grid[0]
        self.ref = self.follow(self.data_ref, grid)
        limits = dict(self.limits)
        off = float((self.occ != self.ref_occ).float().mean())
        return ([("sweep_cells", outside, 0),
                 ("grid_off", off, limits.pop("grid_off"))]
                + compare.training(self.prog, self.ref, limits))

    def control(self) -> list:
        grid = self.sweep(self.data_ref, "bf16")
        low = self.follow(self.data_ref, grid, "bf16")
        grid_low = float((grid[0] != self.ref_occ).float().mean())
        self.detail = {
            "program": compare.leaf_detail(self.prog, self.ref),
            "control": compare.leaf_detail(low, self.ref),
            "numbers": {"program": compare.training_numbers(self.prog,
                                                            self.ref),
                        "control": compare.training_numbers(low, self.ref)}}
        limits = dict(self.limits)
        return [("grid_off", grid_low, limits.pop("grid_off"))] \
            + compare.training(low, self.ref, limits)
