"""The rank side of the distributed tests (``tests/test_torch_dist_*.py``).

Each ``*_world`` function is what every rank of one gloo world runs
(``ngp_tpu_torch.dist.mesh.run_ranks``): it takes numpy inputs that the
test made with the JAX package, runs the port's distributed paths on the
CPU and returns numpy results, which the test holds against the JAX
package. This module imports no JAX: the spawned ranks import it, not the
test modules."""
import numpy as np
import torch


def one_thread():
    """One intra-op thread per rank: the tensors are small, and the ranks
    share the cores with the other test workers."""
    torch.set_num_threads(1)


def numpy_of(d: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


# ---------------------------------------------------------------------------
# NeRF
# ---------------------------------------------------------------------------

def nerf_dataset(fields: dict):
    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    return NerfDataset(**fields)


def nerf_trainer(setup: dict, **tcfg):
    """A CPU port trainer of the test's scene: the JAX trainer's dataset,
    network config and parameters (``tree``), and its occupancy grid."""
    from ngp_tpu_torch import bridge
    from ngp_tpu_torch.opt.optimizers import init_state
    from ngp_tpu_torch.train.nerf import NerfTrainer, NerfTrainerConfig
    tr = NerfTrainer(nerf_dataset(setup["fields"]), setup["cfg"],
                     tcfg=NerfTrainerConfig(**{**setup["tcfg"], **tcfg}),
                     device="cpu")
    with torch.no_grad():
        for k, v in bridge.nerf_params_from_numpy(setup["tree"],
                                                  tr.model).items():
            tr.params[k].copy_(v)
    tr.opt_state = init_state(tr.params, tr.opt_cfg)
    tr.grid = bridge.grid_from_numpy(**setup["grid"])
    return tr


def error_state(setup: dict) -> dict:
    """The JAX trainer's error-map CDFs, as tensors."""
    return {k: torch.from_numpy(v) for k, v in setup["err"].items()}


def step_draws(arrays):
    from ngp_tpu_torch.train.nerf import StepDraws
    return StepDraws(*(torch.from_numpy(np.array(a)) for a in arrays))


def trainer_state(tr) -> dict:
    """A trainer's parameters, Adam state, error map and sharpness grid,
    as numpy."""
    s = tr.opt_state
    return {"params": numpy_of(tr.params), "mu": numpy_of(s.mu),
            "nu": numpy_of(s.nu), "ema": numpy_of(s.ema_params),
            "step": s.step, "error_map": tr.error_map.numpy().copy(),
            "sharpness": tr.sharpness_grid.numpy().copy(),
            "cam_m": numpy_of(tr.cam_m)}


def stats_of(stats) -> dict:
    return {"loss": float(stats.loss), "total": int(stats.total),
            "seg_total": int(stats.seg_total),
            "n_rays_with_samples": int(stats.n_rays_with_samples)}


def dp_world(rank: int, world: int, setup: dict, draws: list,
             capacity: int) -> dict:
    """One DP(2) step on rank r's draws ``draws[r]``, and the
    single-device step on them; on rank 0 a DP(1) step and the
    single-device step on ``draws[0]``; the camera L2 term of
    a DP(2) step and of a single-device step on an empty grid; 32 steps of
    ``DpNerfTrainer``."""
    one_thread()
    from ngp_tpu_torch.dist.mesh import make_mesh
    from ngp_tpu_torch.dist.nerf_dp import DpNerfTrainer, make_dp_train_step
    from ngp_tpu_torch.train.nerf import NerfTrainerConfig
    mesh2 = make_mesh(n_data=2)
    mesh1 = make_mesh(n_data=1, ranks=[0])
    err = error_state(setup)
    out = {"coords": (mesh2.data_index, mesh2.model_index),
           "mesh1": mesh1 is not None}

    tr = nerf_trainer(setup)
    st = make_dp_train_step(tr, mesh2, 128, capacity)(
        err, step_draws(draws[rank]))
    out["dp2"] = {**stats_of(st), **trainer_state(tr)}
    out["own"] = stats_of(nerf_trainer(setup)._train_step(
        step_draws(draws[rank]), err, capacity=capacity))

    if mesh1 is not None:
        a, b = nerf_trainer(setup), nerf_trainer(setup)
        sa = make_dp_train_step(a, mesh1, 128, capacity)(
            err, step_draws(draws[0]))
        sb = b._train_step(step_draws(draws[0]), err, capacity=capacity)
        out["dp1"] = {**stats_of(sa), **trainer_state(a)}
        out["single"] = {**stats_of(sb), **trainer_state(b)}

    # the camera L2 term alone: an empty grid gives no samples, so the
    # pose gradient is 2·extrinsic_l2_reg·(rot, trans) on each rank
    rot = np.full((len(setup["fields"]["xforms"]), 3), 0.01, np.float32)
    for what, run in (("cam_dp2", lambda t: make_dp_train_step(
            t, mesh2, 128, capacity)(err, step_draws(draws[rank]))),
                      ("cam_single", lambda t: t._train_step(
                          step_draws(draws[rank]), err, capacity=capacity))):
        t = nerf_trainer(setup, optimize_extrinsics=True)
        t.grid = t.grid._replace(bitfield=torch.zeros_like(t.grid.bitfield),
                                 coarse=torch.zeros_like(t.grid.coarse))
        with torch.no_grad():
            t.cam_params["rot"].copy_(torch.from_numpy(rot))
            t.cam_params["trans"].copy_(torch.from_numpy(rot))
        st = run(t)
        out[what] = {**stats_of(st), "cam_m": numpy_of(t.cam_m)}

    dtr = DpNerfTrainer(nerf_dataset(setup["fields"]), setup["cfg"], mesh2,
                        tcfg=NerfTrainerConfig(**setup["tcfg"]),
                        device="cpu")
    loss = dtr.train(32)
    out["trainer"] = {"loss": loss, "step": dtr.training_step,
                      "n_rays": dtr.tcfg.n_rays,
                      "params": numpy_of(dtr.params),
                      "density": dtr.grid.density.numpy().copy(),
                      "bitfield": dtr.grid.bitfield.numpy().copy(),
                      "error_map": dtr.error_map.numpy().copy()}
    return out


def tp_nerf_world(rank: int, world: int, setup: dict, draws,
                  capacity: int) -> dict:
    """One table-parallel step (model 2, one data row: every rank takes
    ``draws``) and, on every rank, the single-device step on the same
    draws."""
    one_thread()
    from ngp_tpu_torch.dist.mesh import make_mesh
    from ngp_tpu_torch.dist.tp_nerf import make_tp_nerf_train_step
    mesh = make_mesh(n_data=1, n_model=2)
    err = error_state(setup)
    tr = nerf_trainer(setup)
    st = make_tp_nerf_train_step(tr, mesh, 128, capacity)(
        err, step_draws(draws))
    ref = nerf_trainer(setup)
    sr = ref._train_step(step_draws(draws), err, capacity=capacity)
    return {"coords": (mesh.data_index, mesh.model_index),
            "table_rows": tuple(tr.params["pos_encoding.table"].shape),
            "tp": {**stats_of(st), **trainer_state(tr)},
            "single": {**stats_of(sr), **trainer_state(ref)}}


# ---------------------------------------------------------------------------
# the table-parallel encode and image trainer
# ---------------------------------------------------------------------------

def encode_world(rank: int, world: int, meta_kw: dict, tables: list, pos,
                 cot, image, image_cfg: dict, image_pos: list) -> dict:
    """The 2 × 2 grid's layout; the TP encode of each data shard of ``pos``
    on the rank's rows of each of ``tables``, and its table gradient for
    the cotangent ``cot``; ``TpImageTrainer`` on model 2 (ranks 0 and 1)
    and on data 2 × model 2, a step on each batch of ``image_pos``."""
    one_thread()
    from ngp_tpu_torch.dist.mesh import (batch_sharding, make_mesh,
                                         make_tp_blocked_encode,
                                         table_sharding)
    from ngp_tpu_torch.dist.tp_image import TpImageTrainer
    from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
    mesh = make_mesh(n_data=2, n_model=2)
    pair = make_mesh(n_data=1, n_model=2, ranks=[0, 1])
    alone = make_mesh(n_data=1, ranks=[3])
    meta = BlockedGridMeta(**meta_kw)
    rows = table_sharding(mesh, meta.rows)
    sl = batch_sharding(mesh, pos.shape[0])
    encode = make_tp_blocked_encode(meta, mesh)
    feats = []
    for table in tables:
        t = torch.from_numpy(table)[:, rows].clone().requires_grad_()
        feats.append(encode(t, torch.from_numpy(pos[sl])))
    grad, = torch.autograd.grad(
        torch.sum(feats[-1] * torch.from_numpy(cot[sl])), t)
    out = {"coords": (mesh.data_index, mesh.model_index),
           "pair": pair is not None, "alone": alone is not None,
           "rows": (rows.start, rows.stop), "batch": (sl.start, sl.stop),
           "feats": [f.detach().numpy() for f in feats],
           "grad": grad.numpy()}

    def fit(m):
        tr = TpImageTrainer(image, image_cfg, m, batch_size=len(image_pos[0]),
                            device="cpu")
        losses = [float(tr.step(torch.from_numpy(p))) for p in image_pos]
        return {"losses": losses, "params": numpy_of(tr.params),
                "shard_bytes": tr.table_shard_bytes(),
                "eval": tr.eval_positions(image_pos[0][:64])}
    if pair is not None:
        out["image_model2"] = fit(pair)
    out["image_2x2"] = fit(mesh)
    return out


# ---------------------------------------------------------------------------
# rendering and the multi-scene orchestrator
# ---------------------------------------------------------------------------

def render_world(rank: int, world: int, setup: dict, opts: dict,
                 cases: list, jobs: dict) -> dict:
    """``render_multichip`` over the world's 2 data ranks for each case
    (width, height, spp, snap); the multi-scene orchestrator for each
    entry of ``jobs`` (a list of scene names)."""
    one_thread()
    import dataclasses
    from ngp_tpu_torch.dist.mesh import make_mesh
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    mesh = make_mesh(n_data=2)
    tr = nerf_trainer(setup)
    base = RenderOptions(**opts)
    frames = []
    for w, h, spp, snap in cases:
        r = NerfRenderer.for_trainer(tr, dataclasses.replace(
            base, snap_to_pixel_centers=snap))
        frames.append(r.render_multichip(
            mesh, dict(tr.params), tr.grid.bitfield, setup["camera"], w, h,
            focal=setup["focal"], spp=spp).numpy())
    out = {"coords": (mesh.data_index, mesh.model_index), "frames": frames}
    for what, names in jobs.items():
        orch = run_scenes(setup, names)
        out[what] = {name: {"type": type(t).__name__,
                            "step": t.training_step,
                            "loss": getattr(t, "tr", t).last_loss,
                            "params": numpy_of(getattr(t, "tr", t).params)}
                     for name, t in orch.trainers.items()}
    return out


def run_scenes(setup: dict, names: list, steps: int = 6, per_slice: int = 3,
               progress=None):
    """A ``MultiSceneOrchestrator`` of one job per name on the test's
    scene, run to ``steps`` steps in slices of ``per_slice``."""
    from ngp_tpu_torch.dist.multi_scene import (MultiSceneOrchestrator,
                                                SceneJob)
    from ngp_tpu_torch.train.nerf import NerfTrainerConfig
    jobs = [SceneJob(name=n, scene_path="", config=setup["cfg"],
                     n_steps=steps,
                     dataset=nerf_dataset(setup["fields"]),
                     trainer_config=NerfTrainerConfig(**setup["tcfg"]))
            for n in names]
    orch = MultiSceneOrchestrator(jobs, steps_per_slice=per_slice,
                                  device="cpu")
    orch.run(progress=progress)
    return orch
