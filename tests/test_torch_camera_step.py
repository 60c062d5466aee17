"""One camera-optimising training step of the port against one
``_train_step_impl`` of the JAX ``NerfTrainer``, on the harness of
tests/test_torch_train_step.py: the same parameters, camera parameters,
occupancy grid, error map, sharpness grid, CDFs and random draws. Two
configurations: pose, exposure and focal length (the rays, and so the
sample positions, depend on the camera: the position gradient, K3's plain
version on the CPU); and two extra learnable dims, the distortion grid and
the envmap."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.grid.occupancy as jocc
import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.nn.mlp as tmlp
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu_torch import bridge
from ngp_tpu_torch.common import LOSS_SCALE
from ngp_tpu_torch.opt.optimizers import init_state
from test_torch_train_step import (N_LIVE, N_RAYS, TRAIN_KW,
                                   _draws_of_jax_key, sphere_scene)

CONFIGS = {
    "pose-exposure-focal": (dict(optimize_extrinsics=True,
                                 optimize_exposure=True,
                                 optimize_focal_length=True), 0),
    "extra-distortion-envmap": (dict(optimize_extra_dims=True,
                                     optimize_distortion=True,
                                     train_envmap=True), 2),
}


def analytic_grid(jtr):
    """An occupancy grid with the sphere's neighbourhood occupied, through
    the JAX package's own bitfield and coarse-mask rebuild (no network
    sweep)."""
    pos = np.asarray(jocc.cell_center_positions(jtr.max_cascade))
    dens = np.where(np.linalg.norm(pos - 0.5, axis=-1) < 0.3, 5.0,
                    0.0).astype(np.float32)
    return jocc.rebuild_bitfield(jtr.grid._replace(density=jnp.asarray(dens)),
                                 jtr.max_cascade)


def seeded_camera(cam: dict, seed: int) -> dict:
    """Camera parameters away from their zero start, so every term of
    the camera loss has a gradient."""
    rng = np.random.default_rng(seed)
    std = {"rot": 0.01, "trans": 0.01, "exposure": 0.2, "focal_delta": 0.01,
           "extra_dims": 0.1, "distortion": 1e-3}
    out = {}
    for k, v in cam.items():
        shape = np.shape(v)
        if k == "envmap":
            out[k] = rng.random(shape).astype(np.float32) * \
                np.array([0.5, 0.5, 0.5, 1.0], np.float32)
        else:
            out[k] = (rng.standard_normal(shape) * std[k]).astype(np.float32)
    return out


def make_pair(tcfg_kw: dict, n_extra: int = 0, seed: int = 0,
              port_kw: dict = None, zero_rot: bool = False):
    """The JAX and the port trainer in the same state, with seeded camera
    parameters (the rotation deltas at 0 with ``zero_rot``); ``port_kw``
    are options only the port's config has."""
    ds, cfg = sphere_scene()
    ds = dataclasses.replace(ds, n_extra_learnable_dims=n_extra)
    kw = {**TRAIN_KW, **tcfg_kw}
    jtr = jnerf.NerfTrainer(ds, cfg, tcfg=jnerf.NerfTrainerConfig(**kw))
    ttr = tnerf.NerfTrainer(ds, cfg, device="cpu",
                            tcfg=tnerf.NerfTrainerConfig(**kw,
                                                         **(port_kw or {})))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jtr.params)
    tree["pos_encoding"] = (rng.standard_normal(tree["pos_encoding"].shape)
                            * 0.5).astype(np.float32)
    jtr.params = jax.tree.map(jnp.asarray, tree)
    jtr.opt_state = jnerf.init_state(jtr.params, jtr.opt_cfg)
    with torch.no_grad():
        for k, v in bridge.nerf_params_from_numpy(tree, ttr.model).items():
            ttr.params[k].copy_(v)
    ttr.opt_state = init_state(ttr.params, ttr.opt_cfg)
    jtr.grid = analytic_grid(jtr)
    ttr.grid = bridge.grid_from_numpy(**jax.tree.map(np.asarray,
                                                     jtr.grid._asdict()))
    em = (rng.random(jtr.error_map.shape) ** 4).astype(np.float32)
    jtr.error_map = jnp.asarray(em)
    ttr.error_map = torch.from_numpy(em.copy())
    cam = seeded_camera(jtr.cam_params, seed + 1)
    if zero_rot:
        cam["rot"] = np.zeros_like(cam["rot"])
    zeros = {k: np.zeros_like(v) for k, v in cam.items()}
    jtr.cam_params = {k: jnp.asarray(v) for k, v in cam.items()}
    jtr.cam_m = {k: jnp.asarray(v) for k, v in zeros.items()}
    jtr.cam_v = {k: jnp.asarray(v) for k, v in zeros.items()}
    bridge.camera_state_from_numpy(ttr, cam, zeros, zeros)
    return jtr, ttr


def run_step(jtr, ttr, key):
    """One step of each; returns the JAX step's outputs, the port's stats,
    and the gradients each passed to its optimizers (the JAX camera
    gradient read back from its first Adam moment, which starts at 0)."""
    caught = {}

    def spy(name, fn):
        def wrapped(params, grads, *args):
            caught[name] = grads
            return fn(params, grads, *args)
        return wrapped
    j_err = jtr._error_state()
    t_err = {k: torch.from_numpy(np.array(v)) for k, v in j_err.items()}
    saved = (jnerf.apply_update, tnerf.apply_update, tnerf.camera_adam)
    jnerf.apply_update = spy("jax", jnerf.apply_update)
    tnerf.apply_update = spy("port", tnerf.apply_update)
    tnerf.camera_adam = spy("port_cam", tnerf.camera_adam)
    try:
        j_out = jtr._train_step_impl(
            jtr.params, jtr.opt_state, jtr.cam_params, jtr.cam_m, jtr.cam_v,
            jtr.error_map, jtr.sharpness_grid, j_err, jtr.grid.bitfield,
            jtr.grid.coarse, jtr.grid.mean, key, jtr.data, n_rays=N_RAYS,
            n_live=jnp.int32(N_LIVE))
        t_stats = ttr._train_step(_draws_of_jax_key(key, N_RAYS).head(N_LIVE),
                                  t_err)
    finally:
        jnerf.apply_update, tnerf.apply_update, tnerf.camera_adam = saved
    j_cam_grads = {k: np.asarray(v) / 0.1 for k, v in j_out[3].items()}
    return j_out, t_stats, caught, j_cam_grads


def assert_network_grads_match(caught, ttr):
    """Per leaf ‖Δ‖/‖g‖ ≤ 1e-2 (bf16 rounding points in the MLPs)."""
    ref = bridge.nerf_params_from_numpy(
        jax.tree.map(np.asarray, caught["jax"]), ttr.model)
    got = caught["port"]
    assert set(got) == set(ref)
    for k in ref:
        norm = float(torch.linalg.vector_norm(ref[k]))
        rel = float(torch.linalg.vector_norm(got[k] - ref[k])) / norm
        print(f"grad {k}: |g| {norm:.3e}, relative difference {rel:.2e}")
        assert norm > 0 and rel <= 1e-2, k


@pytest.fixture(scope="module", params=list(CONFIGS))
def camera_step(request):
    flags, n_extra = CONFIGS[request.param]
    jtr, ttr = make_pair(flags, n_extra)
    cam0 = {k: v.clone() for k, v in ttr.cam_params.items()}
    out = run_step(jtr, ttr, jax.random.PRNGKey(11))
    return dict(name=request.param, jtr=jtr, ttr=ttr, cam0=cam0, out=out)


def test_camera_step_loss_and_network_grads_match_jax(camera_step):
    j_out, t_stats, caught, _ = camera_step["out"]
    j_stats = j_out[7]
    print(f"{camera_step['name']}: loss jax {float(j_stats.loss):.6e} port "
          f"{float(t_stats.loss):.6e}; samples {t_stats.total}")
    assert t_stats.total > 1000
    assert t_stats.total == int(j_stats.measured_samples_uncompacted)
    np.testing.assert_allclose(float(t_stats.loss), float(j_stats.loss),
                               rtol=1e-4)
    assert_network_grads_match(caught, camera_step["ttr"])


@pytest.fixture(scope="module", params=list(CONFIGS))
def camera_grads(request):
    """One step of each package with the MLPs computing in f32 in both and
    the rotation deltas at 0, where R = I exactly, so both build the same
    rays bit for bit: (config name, run_step's outputs)."""
    flags, n_extra = CONFIGS[request.param]
    jtr, ttr = make_pair(flags, n_extra, zero_rot=True)
    for net in ("density_net", "rgb_net"):
        setattr(jtr.model, net, dataclasses.replace(
            getattr(jtr.model, net), compute_dtype=jnp.float32))
    saved = tmlp._bf16
    tmlp._bf16 = lambda x: x
    try:
        out = run_step(jtr, ttr, jax.random.PRNGKey(11))
    finally:
        tmlp._bf16 = saved
    return request.param, out


def test_camera_step_camera_grads_match_jax(camera_grads):
    """Per camera key ‖Δ‖/‖g‖ ≤ 1e-2; keys the loss does not reach get
    zeros in both. Pose, focal and distortion gradients sum per-sample
    position gradients that cancel about ten to one within an image, so
    they amplify any difference of the samples. Two are removed here, and
    neither is the camera path's: the bf16 rounding points of the MLPs,
    where an ulp of input flips a rounding (the bf16 step's camera
    gradients differ by 1-2e-2), and ray directions an ulp apart at a
    nonzero rotation (XLA's CPU dot chains FMAs, torch's matmul does not),
    which move a rare sample across a cell face, where the position
    gradient jumps. The bf16 step's loss and network gradients are held in
    test_camera_step_loss_and_network_grads_match_jax."""
    name, (_, _, caught, j_grads) = camera_grads
    got = {k: v.numpy() / LOSS_SCALE for k, v in caught["port_cam"].items()}
    assert set(got) == set(j_grads)
    reached = ({"rot", "trans", "exposure", "focal_delta"}
               if not CONFIGS[name][1]
               else {"extra_dims", "distortion", "envmap"})
    for k, ref in j_grads.items():
        norm = float(np.linalg.norm(ref))
        rel = float(np.linalg.norm(got[k] - ref)) / max(norm, 1e-30)
        print(f"camera grad {k}: |g| {norm:.3e}, relative difference "
              f"{rel:.2e}")
        if k in reached:
            assert norm > 0 and rel <= 1e-2, k
        else:
            assert norm == 0 and not got[k].any(), k


def test_camera_step_camera_grads_are_the_encode_autograd(camera_step):
    """The port's camera gradients, with the position gradient from the
    plain K3, equal those with autograd through the plain encode
    (``encode_reference``), to 1e-5 relative per key: within one
    framework nothing but the position path differs."""
    import ngp_tpu_torch.kernels.blocked_grid as tbg
    import ngp_tpu_torch.kernels.blocked_grid_cuda as bgc
    jtr, ttr = make_pair(*CONFIGS[camera_step["name"]])
    draws = _draws_of_jax_key(jax.random.PRNGKey(11), N_RAYS).head(N_LIVE)
    err = {k: torch.from_numpy(np.array(v))
           for k, v in jtr._error_state().items()}
    via_k3 = ttr._step_grads(draws, err)[1]
    orig = bgc.encode_mode
    bgc.encode_mode = lambda table, pos, meta, *_: tbg.encode_reference(
        table, pos, meta)
    try:
        via_autograd = ttr._step_grads(draws, err)[1]
    finally:
        bgc.encode_mode = orig
    for k, ref in via_autograd.items():
        norm = float(torch.linalg.vector_norm(ref))
        diff = float(torch.linalg.vector_norm(via_k3[k] - ref))
        assert diff <= 1e-5 * norm, (k, diff, norm)


def test_camera_adam_on_the_jax_gradient_matches_jax(camera_step):
    """The port's camera Adam on the JAX step's camera gradient gives the
    JAX step's camera parameters and moments to 1e-4: no bias
    correction, per-key learning rates, and only enabled keys move."""
    j_out, _, _, j_grads = camera_step["out"]
    ttr, cam0 = camera_step["ttr"], camera_step["cam0"]
    cam = {k: v.clone() for k, v in cam0.items()}
    m = {k: torch.zeros_like(v) for k, v in cam.items()}
    v = {k: torch.zeros_like(t) for k, t in cam.items()}
    tnerf.camera_adam(cam, {k: torch.from_numpy(g * LOSS_SCALE)
                            for k, g in j_grads.items()}, m, v,
                      *ttr._camera_schedule())
    moved = set()
    for got, want in [(cam, j_out[2]), (m, j_out[3]), (v, j_out[4])]:
        for k in want:
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max() + 1e-30,
                                       err_msg=k)
    for k in cam:
        if not torch.equal(cam[k], cam0[k]):
            moved.add(k)
    _, enabled = ttr._camera_schedule()
    assert moved == {k for k in cam if enabled[k]}
