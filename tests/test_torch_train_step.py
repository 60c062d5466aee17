"""One training step of the port against one ``_train_step_impl`` of the
JAX ``NerfTrainer``: the same parameters (through ``bridge.py``), the same
occupancy grid, error map, sharpness grid and error-map CDFs, and the
random draws the JAX step makes from its key, handed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu_torch import bridge
from ngp_tpu_torch.opt.optimizers import AdamState, init_state
from ngp_tpu_torch.opt.optimizers import apply_update as t_apply_update
from synthetic import make_orbit_dataset
from test_nerf_e2e import render_gt_sphere

N_RAYS, N_LIVE, RES, FOCAL = 256, 200, 32, 32.0


def sphere_scene(n_images=8, aabb_scale=2):
    """An orbit of analytic renders of an opaque sphere (the scene of
    tests/test_nerf_e2e.py) and the small network config of the port's
    tests: 4 levels, log2_hashmap_size 12."""
    from ngp_tpu.config import load_network_config
    ds = make_orbit_dataset(n_images=n_images, res=RES, radius=1.4,
                            focal=FOCAL, aabb_scale=aabb_scale)
    ds.images = np.stack([
        render_gt_sphere(RES, ds.xforms[i], FOCAL, np.array([0.5] * 3), 0.22,
                         np.array([0.8, 0.3, 0.2], np.float32),
                         bg=np.zeros(3)) for i in range(n_images)])
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    return ds, cfg


TRAIN_KW = dict(n_rays=N_RAYS, adapt_rays=False, dynamic_rays=True,
                target_batch_size=1 << 16,
                sample_image_proportional_to_error=True,
                sample_focal_plane_proportional_to_error=True)


def _draws_of_jax_key(key, n_rays):
    """The uniforms ``_train_step_impl`` draws from its key
    (``nerf.py:512`` and, inside ``_sample_pixels``, ``:340``)."""
    k_ray, k_march, k_bg, _k_time, _ = jax.random.split(key, 5)
    k_img, k_xy, _ = jax.random.split(k_ray, 3)
    u = [jax.random.uniform(k_img, (n_rays,)),
         jax.random.uniform(k_xy, (n_rays, 2)),
         jax.random.uniform(k_march, (n_rays,)),
         jax.random.uniform(k_bg, (n_rays, 3))]
    return tnerf.StepDraws(*(torch.from_numpy(np.array(a)) for a in u))


@pytest.fixture(scope="module")
def step_pair():
    """Both trainers in the same state, and the results of one step on
    each; the step's gradients are caught on their way into
    ``apply_update``."""
    ds, cfg = sphere_scene()
    jtr = jnerf.NerfTrainer(ds, cfg, tcfg=jnerf.NerfTrainerConfig(**TRAIN_KW))
    ttr = tnerf.NerfTrainer(ds, cfg, tcfg=tnerf.NerfTrainerConfig(**TRAIN_KW),
                            device="cpu")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.array, jtr.params)
    # a table with structure, so the field has both empty and dense space
    tree["pos_encoding"] = (rng.standard_normal(tree["pos_encoding"].shape)
                            * 0.5).astype(np.float32)
    jtr.params = jax.tree.map(jnp.asarray, tree)
    jtr.opt_state = jnerf.init_state(jtr.params, jtr.opt_cfg)
    with torch.no_grad():
        for k, v in bridge.nerf_params_from_numpy(tree, ttr.model).items():
            ttr.params[k].copy_(v)
    ttr.opt_state = init_state(ttr.params)
    jtr.grid = jtr._grid_update(jtr.params, jtr.grid, jax.random.PRNGKey(3),
                                full_sweep=True)
    jg = jax.tree.map(np.asarray, jtr.grid._asdict())
    ttr.grid = bridge.grid_from_numpy(**jg)
    em = (rng.random(jtr.error_map.shape) ** 4).astype(np.float32)
    # half the cells empty, so deposits of flat (sharpness 1e-6) views
    # land as well as those of the sphere's edges
    sharp = np.where(rng.random(jtr.sharpness_grid.shape) < 0.5, 0.0,
                     rng.random(jtr.sharpness_grid.shape) * 1e-5
                     ).astype(np.float32)
    jtr.error_map = jnp.asarray(em)
    ttr.error_map = torch.from_numpy(em.copy())
    jtr.sharpness_grid = jnp.asarray(sharp)
    ttr.sharpness_grid = torch.from_numpy(sharp.copy())
    j_err = jtr._error_state()
    t_err = {k: torch.from_numpy(np.array(v)) for k, v in j_err.items()}
    p0 = {k: v.detach().clone() for k, v in ttr.params.items()}
    s0 = ttr.opt_state

    caught = {}

    def spy(store, fn):
        def wrapped(params, grads, *args):
            store["grads"] = grads
            return fn(params, grads, *args)
        return wrapped

    key = jax.random.PRNGKey(7)
    j_apply, t_apply = jnerf.apply_update, tnerf.apply_update
    jnerf.apply_update = spy(caught.setdefault("jax", {}), j_apply)
    tnerf.apply_update = spy(caught.setdefault("port", {}), t_apply)
    try:
        # dynamic_rays: JAX masks all but the first N_LIVE of its static
        # batch; the port slices them
        j_out = jtr._train_step_impl(
            jtr.params, jtr.opt_state, jtr.cam_params, jtr.cam_m, jtr.cam_v,
            jtr.error_map, jtr.sharpness_grid, j_err, jtr.grid.bitfield,
            jtr.grid.coarse, jtr.grid.mean, key, jtr.data, n_rays=N_RAYS,
            n_live=jnp.int32(N_LIVE))
        t_stats = ttr._train_step(_draws_of_jax_key(key, N_RAYS).head(N_LIVE),
                                  t_err)
    finally:
        jnerf.apply_update, tnerf.apply_update = j_apply, t_apply
    return dict(jtr=jtr, ttr=ttr, j_out=j_out, t_stats=t_stats, p0=p0, s0=s0,
                caught=caught, em=em, sharp=sharp)


def test_step_loss_and_counts_match_jax(step_pair):
    j_stats = step_pair["j_out"][7]
    t_stats = step_pair["t_stats"]
    print(f"loss jax {float(j_stats.loss):.6e} port {float(t_stats.loss):.6e};"
          f" samples {int(j_stats.measured_samples_uncompacted)} / "
          f"{t_stats.total}; segments {int(j_stats.surviving_segments)} / "
          f"{t_stats.seg_total}")
    assert t_stats.total > 1000
    assert t_stats.total == int(j_stats.measured_samples_uncompacted)
    assert t_stats.seg_total == int(j_stats.surviving_segments)
    assert int(t_stats.n_rays_with_samples) == int(j_stats.n_rays_with_samples)
    np.testing.assert_allclose(float(t_stats.loss), float(j_stats.loss),
                               rtol=1e-4)


def test_step_gradients_match_jax(step_pair):
    """Per leaf ‖Δ‖/‖g‖ ≤ 1e-2: bf16 rounding points in the MLPs may flip
    by one ulp between the frameworks."""
    ttr = step_pair["ttr"]
    ref = bridge.nerf_params_from_numpy(
        jax.tree.map(np.asarray, step_pair["caught"]["jax"]["grads"]),
        ttr.model)
    got = step_pair["caught"]["port"]["grads"]
    assert set(got) == set(ref)
    for k in ref:
        norm = float(torch.linalg.vector_norm(ref[k]))
        rel = float(torch.linalg.vector_norm(got[k] - ref[k])) / norm
        print(f"grad {k}: |g| {norm:.3e}, relative difference {rel:.2e}")
        assert norm > 0 and rel <= 1e-2, k
    # the zero pattern of the table gradient (the zero-gradient skip)
    tbl = "pos_encoding.table"
    assert torch.equal(got[tbl] == 0, ref[tbl] == 0)


def test_step_update_with_the_same_gradient_matches_jax(step_pair):
    """Adam on the JAX step's own gradient gives the JAX step's parameters
    and moments, to rtol 1e-6. A table entry that an update of ±lr moves
    to near 0 loses its relative precision to cancellation, so the
    absolute floor is 1e-6 of the learning rate."""
    ttr, j_out = step_pair["ttr"], step_pair["j_out"]
    jgrads = bridge.nerf_params_from_numpy(
        jax.tree.map(np.asarray, step_pair["caught"]["jax"]["grads"]),
        ttr.model)
    params = {k: v.clone() for k, v in step_pair["p0"].items()}
    s0 = step_pair["s0"]
    state = AdamState(0, *({k: torch.zeros_like(v) for k, v in params.items()}
                           for _ in range(2)),
                      {k: v.clone() for k, v in params.items()})
    assert s0.step == 0
    state = t_apply_update(params, jgrads, state, ttr.opt_cfg,
                           ttr.matrix_names)
    j_params, j_state = j_out[0], j_out[1]
    ref = bridge.adam_state_from_numpy(
        j_state.step, *(jax.tree.map(np.asarray, t) for t in (
            j_state.mu, j_state.nu, j_state.ema_params)), ttr.model)
    ref_p = bridge.nerf_params_from_numpy(jax.tree.map(np.asarray, j_params),
                                          ttr.model)
    assert state.step == ref.step == 1
    for got, want in [(params, ref_p), (state.mu, ref.mu), (state.nu, ref.nu),
                      (state.ema_params, ref.ema_params)]:
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-6,
                                       atol=1e-6 * ttr.opt_cfg.learning_rate)


def test_step_error_map_and_sharpness_match_jax(step_pair):
    """The deposits of the sliced port step equal those of the JAX step
    with masked rays: slicing to the live rays equals masking."""
    ttr, j_out = step_pair["ttr"], step_pair["j_out"]
    em, sharp = step_pair["em"], step_pair["sharp"]
    j_dep = np.asarray(j_out[5]) - em
    t_dep = ttr.error_map.numpy() - em
    assert (j_dep != 0).sum() > 100
    np.testing.assert_allclose(t_dep, j_dep, rtol=1e-4,
                               atol=1e-4 * np.abs(j_dep).max())
    j_sharp = np.asarray(j_out[6])
    assert (j_sharp != sharp).sum() > 10
    np.testing.assert_array_equal(ttr.sharpness_grid.numpy() != sharp,
                                  j_sharp != sharp)
    np.testing.assert_allclose(ttr.sharpness_grid.numpy(), j_sharp,
                               rtol=1e-4)
