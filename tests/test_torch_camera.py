"""Parity of the camera-optimisation parts of the port with the JAX
package: the Rodrigues rotation, bilinear sampling, the envmap and the
distortion grid, the optimised extrinsics, the network's extra dims, the
camera state through ``bridge.py``; one training step under
``encode_int8="full"`` against the JAX step through the Pallas int8 encode
in interpret mode; and the trainer's default device."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.nn.trainable_buffer as jtb
import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.nn.trainable_buffer as ttb
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu_torch import bridge
from test_torch_camera_step import (assert_network_grads_match, make_pair,
                                    run_step)
from test_torch_train_step import sphere_scene


def _rots(seed=0):
    rng = np.random.default_rng(seed)
    rot = (rng.standard_normal((64, 3)) * np.logspace(-6, 0.5, 64)[:, None]
           ).astype(np.float32)
    rot[0] = 0.0                  # the deltas' start: the smoothed norm
    return rot


def test_rodrigues_matches_jax():
    rot = _rots()
    got = tnerf.NerfTrainer._rodrigues(torch.from_numpy(rot)).numpy()
    ref = np.asarray(jnerf.NerfTrainer._rodrigues(jnp.asarray(rot)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))
    # and its gradient at zero, where the plain norm's is NaN
    g = torch.zeros(3, requires_grad=True)
    R = tnerf.NerfTrainer._rodrigues(g[None])[0]
    (R * torch.arange(9.0).view(3, 3)).sum().backward()
    j = jax.grad(lambda r: jnp.sum(jnerf.NerfTrainer._rodrigues(r[None])[0]
                                   * jnp.arange(9.0).reshape(3, 3)))(
        jnp.zeros(3))
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(j), rtol=1e-6)
    assert np.isfinite(g.grad.numpy()).all()


@pytest.mark.parametrize("wrap_x", [False, True])
def test_bilinear_sample_matches_jax(wrap_x):
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((7, 11, 3)).astype(np.float32)
    uv = (rng.random((500, 2)) * 1.4 - 0.2).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [0.5, 0.5], [1 / 22, 1 / 14]]
    got = ttb.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(uv),
                              wrap_x=wrap_x).numpy()
    ref = np.asarray(jtb.bilinear_sample(jnp.asarray(grid), jnp.asarray(uv),
                                         wrap_x=wrap_x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_envmap_and_distortion_grid_match_jax():
    """Samples, and the gradients into the buffers (the deposits the
    reference writes with atomics). The two frameworks' arcsin and atan2
    differ in the last bit, which moves an envmap coordinate by ~1e-7 of
    512 texels: 5e-5 on a map of unit-scale random texels."""
    rng = np.random.default_rng(2)
    env_p = rng.random((256, 512, 4)).astype(np.float32)
    d = rng.standard_normal((400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = rng.standard_normal((400, 4)).astype(np.float32)
    te, je = ttb.Envmap(), jtb.Envmap()
    assert tuple(te.init_params().shape) == je.init_params(None).shape
    t_env = torch.from_numpy(env_p).requires_grad_()
    got = te.sample(t_env, torch.from_numpy(d))
    (got * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(je.sample(jnp.asarray(env_p), jnp.asarray(d)))
    j_grad = np.asarray(jax.grad(lambda p: jnp.sum(
        je.sample(p, jnp.asarray(d)) * w))(jnp.asarray(env_p)))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(t_env.grad.numpy(), j_grad, rtol=0,
                               atol=5e-5 * np.abs(w).max())
    np.testing.assert_allclose(te.dir_to_uv(torch.from_numpy(d)).numpy(),
                               np.asarray(je.dir_to_uv(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)

    td, jd = ttb.DistortionGrid((32, 24)), jtb.DistortionGrid((32, 24))
    assert tuple(td.init_params().shape) == jd.init_params(None).shape
    dist = (rng.standard_normal((32, 24, 2)) * 1e-2).astype(np.float32)
    xy = rng.random((300, 2)).astype(np.float32)
    np.testing.assert_allclose(
        td.sample(torch.from_numpy(dist), torch.from_numpy(xy)).numpy(),
        np.asarray(jd.sample(jnp.asarray(dist), jnp.asarray(xy))),
        rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def trainer_pair():
    """A JAX and a port trainer on the sphere scene with two extra dims
    and every camera flag on, no step taken."""
    flags = dict(optimize_extrinsics=True, optimize_exposure=True,
                 optimize_focal_length=True, optimize_extra_dims=True,
                 optimize_distortion=True, train_envmap=True)
    return make_pair(flags, n_extra=2, seed=5)


def test_camera_state_and_extrinsics_match_jax(trainer_pair):
    """The camera keys and shapes of both trainers, the state through the
    bridge both ways, and the optimised camera→world of every image."""
    jtr, ttr = trainer_pair
    cam, m, v = bridge.camera_state_to_numpy(ttr)
    assert set(cam) == set(jtr.cam_params) == {
        "rot", "trans", "exposure", "focal_delta", "extra_dims", "envmap",
        "distortion"}
    for k in cam:
        np.testing.assert_array_equal(cam[k], np.asarray(jtr.cam_params[k]))
        assert not m[k].any() and not v[k].any()
    for i in range(ttr.dataset.n_images):
        np.testing.assert_allclose(ttr.get_camera_extrinsics(i),
                                   jtr.get_camera_extrinsics(i), rtol=1e-6,
                                   atol=1e-6)
    assert not np.allclose(ttr.get_camera_extrinsics(1), ttr.dataset.xforms[1])
    with pytest.raises(ValueError, match="camera keys"):
        bridge.camera_state_from_numpy(ttr, {"rot": cam["rot"]}, m, v)


def test_network_extra_dims_match_jax(trainer_pair):
    """The network with E = 2: the dir encoding runs over 3 + E dims and
    the RGB MLP takes them in."""
    jtr, ttr = trainer_pair
    rng = np.random.default_rng(6)
    pos = rng.random((300, 3)).astype(np.float32)
    dirs = rng.random((300, 3)).astype(np.float32)
    extra = rng.standard_normal((300, 2)).astype(np.float32)
    j_rgb, j_dens = jtr.model.apply(jtr.params, pos, dirs, extra=extra)
    with torch.no_grad():
        t_rgb, t_dens = ttr.model.apply(*map(torch.from_numpy,
                                             (pos, dirs)),
                                        extra=torch.from_numpy(extra))
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(j_dens), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=1e-3,
                               atol=1e-3)
    assert ttr.model.dir_encoding.n_output_dims == 16 + 2
    with pytest.raises(ValueError, match="extra dims"):
        ttr.model.apply(torch.from_numpy(pos), torch.from_numpy(dirs))


def test_int8_full_step_matches_jax(monkeypatch):
    """One step under ``encode_int8="full"`` (the int8 forward, and the
    int8 table backward in tiles of eff_tile(capacity)) against the JAX
    step with its encode patched to ``blocked_grid_encode_int8`` in
    interpret mode (the pattern of tests/test_pallas_interpret.py): loss
    to 1e-4 and the gradients to 1e-2 relative per leaf, as the f32
    step's."""
    from jax.experimental.pallas import tpu as pltpu

    import ngp_tpu.nn.encodings as E
    from ngp_tpu.kernels.hashgrid_pallas import blocked_grid_encode_int8

    jtr, ttr = make_pair({}, seed=7, port_kw=dict(encode_int8="full"))

    def patched(self, params, x, max_level=None, **_):
        return blocked_grid_encode_int8(params, x, self.meta)

    monkeypatch.setattr(E.BlockedGridEncoding, "apply", patched)
    with pltpu.force_tpu_interpret_mode():
        j_out, t_stats, caught, _ = run_step(jtr, ttr,
                                             jax.random.PRNGKey(13))
    j_stats = j_out[7]
    print(f"int8 full: loss jax {float(j_stats.loss):.6e} port "
          f"{float(t_stats.loss):.6e}; samples {t_stats.total}")
    assert t_stats.total > 1000
    assert t_stats.total == int(j_stats.measured_samples_uncompacted)
    np.testing.assert_allclose(float(t_stats.loss), float(j_stats.loss),
                               rtol=1e-4)
    assert_network_grads_match(caught, ttr)
    assert "port_cam" not in caught      # no camera flag: no camera Adam


def test_trainer_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    built with no device, the trainer is on CUDA, or, where there is no
    card, fails instead of training on the CPU."""
    assert inspect.signature(tnerf.NerfTrainer).parameters[
        "device"].default == "cuda"
    ds, cfg = sphere_scene(n_images=2)
    if torch.cuda.is_available():
        assert tnerf.NerfTrainer(ds, cfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tnerf.NerfTrainer(ds, cfg)


def test_unported_options_still_raise():
    """Depth supervision and rolling shutter are ported: a trainer takes
    them (tests/test_torch_captures.py steps them against JAX). What still
    raises: an unknown int8 mode, and the int8 modes or the int8 grid sweep
    on the tcnn-layout grid."""
    ds, cfg = sphere_scene(n_images=2)
    tr = tnerf.NerfTrainer(ds, cfg, device="cpu", tcfg=tnerf.NerfTrainerConfig(
        depth_supervision_lambda=0.1))
    assert tr._xforms_end is None and tr.draws(4).time is None
    xe = ds.xforms.copy()
    xe[:, 0, 3] += 0.1
    tr = tnerf.NerfTrainer(dataclasses.replace(ds, xforms_end=xe), cfg,
                           device="cpu")
    assert tr._xforms_end is not None and tr.draws(4).time.shape == (4,)
    with pytest.raises(ValueError, match="encode_int8"):
        tnerf.NerfTrainer(ds, cfg, device="cpu",
                          tcfg=tnerf.NerfTrainerConfig(encode_int8="yes"))
    for kw in (dict(encode_int8="fwd"), dict(grid_int8=True)):
        with pytest.raises(ValueError, match="blocked grid only"):
            tnerf.NerfTrainer(ds, cfg, device="cpu", grid_impl="tcnn",
                              tcfg=tnerf.NerfTrainerConfig(**kw))


def test_every_camera_flag_trains_under_full_int8():
    """All camera flags and ``encode_int8="full"`` together train through
    ``train(n)`` (a full sweep, then steps): the loss stays finite and
    every enabled camera key moves from its start."""
    ds, cfg = sphere_scene(n_images=4)
    ds = dataclasses.replace(ds, n_extra_learnable_dims=2)
    tr = tnerf.NerfTrainer(ds, cfg, device="cpu", tcfg=tnerf.NerfTrainerConfig(
        n_rays=256, adapt_rays=False, optimize_extrinsics=True,
        optimize_exposure=True, optimize_focal_length=True,
        optimize_extra_dims=True, optimize_distortion=True,
        train_envmap=True, encode_int8="full"))
    start = {k: v.clone() for k, v in tr.cam_params.items()}
    loss = tr.train(3)
    assert np.isfinite(loss) and tr.training_step == 3
    for k, v in tr.cam_params.items():
        assert torch.isfinite(v).all(), k
        assert not torch.equal(v, start[k]), k
