"""Multi-scene batch training over the ranks of a world (port of
``ngp_tpu/dist/multi_scene.py``): one NeRF per group of ranks, the groups
embarrassingly parallel.

Every rank runs the orchestrator. The ranks are block-partitioned over
the jobs, as the JAX package partitions its devices; a rank drives only
its own group's jobs, and a group of more than one rank runs the
data-parallel step (``nerf_dp.make_dp_train_step``) over a process group
of its own. In one process (no process group, or a world of one) every
job is that rank's, and the jobs train in turn, a slice of steps each:
the sequential round-robin that JAX's single device gives.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch.distributed as dist

from ngp_tpu_torch.dist.mesh import Mesh, make_mesh
from ngp_tpu_torch.dist.nerf_dp import make_dp_train_step, null_error_state


@dataclasses.dataclass
class SceneJob:
    name: str
    scene_path: str
    config: dict
    n_steps: int = 2000
    snapshot_out: Optional[str] = None
    ranks: Optional[list] = None           # the rank group assigned
    dataset: Optional[object] = None       # a loaded NerfDataset
    trainer_config: Optional[object] = None  # a NerfTrainerConfig


class _DpGroupRunner:
    """Drives one trainer with the in-group data-parallel step: the grid
    swept at the trainer's cadence (fully below step 256), one step per
    call of the DP step, the loss read once per slice."""

    def __init__(self, trainer, mesh: Mesh):
        tc = trainer.tcfg
        n = mesh.n_data
        self.tr = trainer
        self.mesh = mesh
        self.dp_step = make_dp_train_step(
            trainer, mesh, n_rays_per_device=max(tc.n_rays // n, 128),
            samples_per_device=max(tc.target_batch_size // n, 1024))

    @property
    def training_step(self) -> int:
        return self.tr.training_step

    def train(self, k: int) -> float:
        tr = self.tr
        tc = tr.tcfg
        use_err = (tc.sample_image_proportional_to_error
                   or tc.sample_focal_plane_proportional_to_error)
        loss = None
        for _ in range(k):
            if tr.training_step % tc.n_steps_between_grid_updates == 0:
                tr._grid_update(full_sweep=tr.training_step < 256)
            err_state = tr._error_state() if use_err else null_error_state()
            loss = self.dp_step(err_state).loss
            tr.training_step += 1
        tr.last_loss = float(loss) if loss is not None else 0.0
        return tr.last_loss

    def save_snapshot(self, path, config):
        self.tr.save_snapshot(path, config)


class MultiSceneOrchestrator:
    """Trains scene jobs round-robin over groups of ranks. Every rank
    of the world constructs it with the same jobs (the groups of more than
    one rank are process groups, made on every rank in job order); ``run``
    trains this rank's jobs on ``device``."""

    def __init__(self, jobs: List[SceneJob], steps_per_slice: int = 32,
                 device="cuda"):
        self.jobs = list(jobs)
        self.steps_per_slice = steps_per_slice
        self.device = device
        self.trainers: Dict[str, object] = {}
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        # block-partition the ranks over the jobs (one group per scene)
        per = max(world // max(len(self.jobs), 1), 1)
        for i, job in enumerate(self.jobs):
            job.ranks = [r for r in range(i * per, (i + 1) * per)
                         if r < world] or [i % world]
        self.meshes: Dict[str, Mesh] = {
            job.name: make_mesh(n_data=len(job.ranks), ranks=job.ranks)
            for job in self.jobs if len(job.ranks) > 1}

    def _trainer(self, job: SceneJob):
        if job.name not in self.trainers:
            from ngp_tpu_torch.train.nerf import NerfTrainer
            ds = job.dataset
            if ds is None:
                from ngp_tpu_torch.data.nerf_loader import load_nerf
                ds = load_nerf(job.scene_path)
            tr = NerfTrainer(ds, job.config, tcfg=job.trainer_config,
                             device=self.device)
            if len(job.ranks) > 1:
                tr = _DpGroupRunner(tr, self.meshes[job.name])
            self.trainers[job.name] = tr
        return self.trainers[job.name]

    def run(self, progress: Optional[Callable] = None) -> dict:
        """Drive this rank's jobs to completion, a slice of
        ``steps_per_slice`` steps of each in turn; returns the trainers by
        job name."""
        active = {j.name: j for j in self.jobs if self.rank in j.ranks}
        while active:
            done = []
            for name, job in active.items():
                tr = self._trainer(job)
                k = min(self.steps_per_slice, job.n_steps - tr.training_step)
                loss = tr.train(k)
                if progress:
                    progress(name, tr.training_step, loss)
                if tr.training_step >= job.n_steps:
                    if job.snapshot_out:
                        tr.save_snapshot(job.snapshot_out, job.config)
                    done.append(name)
            for name in done:
                del active[name]
        return self.trainers
