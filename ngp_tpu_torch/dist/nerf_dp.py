"""Data-parallel NeRF training (port of ``ngp_tpu/dist/nerf_dp.py``).

Each rank draws its own rays, marches and compacts them into its own
sample stream and runs the trainer's step (``NerfTrainer._train_step``)
with the mesh's ``data`` group: the normaliser, the gradients, the loss,
the counters and the error-map deposit are summed over the group and the
sharpness grid is taken as its maximum (``NerfTrainer._step_grads``), so
every rank applies the same Adam update and holds the same parameters.

The JAX step folds the rank's index into its key for the rays and keeps
the key before the fold for the grid sweep. Here a rank's rays come from a
generator of its own (``rank_generator``) and the sweeps from the
trainer's generator, which every rank seeds alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from ngp_tpu_torch.dist.mesh import Mesh
from ngp_tpu_torch.train.nerf import NerfTrainer, StepDraws, StepStats

# mixes the data index into a rank's seed (a 64-bit odd constant)
_RANK_MIX = 0x9E3779B97F4A7C15


def rank_generator(seed: int, data_index: int, device) -> torch.Generator:
    """The ray-draw stream of data rank ``data_index`` of a trainer seeded
    ``seed``: distinct for each data index, the same on the ranks of one
    model row (they share their rays)."""
    mixed = (seed + (data_index + 1) * _RANK_MIX) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def null_error_state() -> dict:
    """The error state of a trainer without importance sampling."""
    return {"cdf_x": None, "cdf_y": None, "cdf_img": None}


def make_dp_train_step(trainer: NerfTrainer, mesh: Mesh,
                       n_rays_per_device: int = 1024,
                       samples_per_device: int = 1 << 14):
    """step(error_state, draws=None) → StepStats: one data-parallel step of
    ``trainer`` in place, on ``n_rays_per_device`` rays of this rank
    (drawn from its ``rank_generator`` when ``draws`` is None) into a
    stream of ``samples_per_device``; the stats are the group's totals.
    Pass the trainer's ``_error_state()`` (or ``null_error_state()``
    without importance sampling) so the sampling follows training."""
    gen = rank_generator(trainer.seed, mesh.data_index, trainer.device)

    def step(error_state: dict, draws: Optional[StepDraws] = None
             ) -> StepStats:
        if draws is None:
            draws = trainer.draws(n_rays_per_device, gen)
        return trainer._train_step(draws, error_state,
                                   capacity=samples_per_device,
                                   group=mesh.data_group)
    return step


class DpNerfTrainer(NerfTrainer):
    """The whole NeRF training loop under data parallelism: warm-up full
    sweeps, partial sweeps, error-map rebuilds, sharpness decay and the
    ray-count adaptation of ``NerfTrainer.train``, with every step summed
    over the mesh's ``data`` group. ``tcfg.n_rays`` and
    ``tcfg.target_batch_size`` are per-rank budgets: the global batch is
    n_data times larger. The grid sweeps draw from the generator every
    rank seeds alike, so the grid stays the same on every rank; DP(1) is
    the single-device trainer on another ray stream."""

    def __init__(self, dataset, config: dict, mesh: Mesh, **kw):
        super().__init__(dataset, config, **kw)
        self.mesh = mesh
        self.n_devices = mesh.n_data
        self.data_group = mesh.data_group
        self.draw_generator = rank_generator(self.seed, mesh.data_index,
                                             self.device)

    def _fetch_stats(self, loss: float, measured: int, segs: int,
                     n_rays: int) -> float:
        # the counters are the group's totals; the adaptation law reasons
        # about the per-rank budgets
        nd = self.n_devices
        return super()._fetch_stats(loss, measured // nd, segs // nd, n_rays)
