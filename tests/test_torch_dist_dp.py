"""Data-parallel NeRF training of the port (``ngp_tpu_torch.dist.nerf_dp``)
in a gloo world of two CPU ranks, against the JAX package's
``make_dp_train_step`` on a 2-device mesh: the same parameters, occupancy
grid and per-rank draws (rank r's from ``fold_in(key, r)``, as the JAX
step folds its key). One world runs every scenario
(``torch_dist_ranks.dp_world``). About 35 s alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from synthetic import make_orbit_dataset
from test_torch_train_step import _draws_of_jax_key
from torch_dist_ranks import dp_world
from ngp_tpu_torch.dist.mesh import run_ranks

N_RAYS, CAPACITY, KEY = 128, 1 << 14, 7
# both error-map samplers on: the JAX step then draws its images and pixels
# as uniforms, as the port does (without them it draws randint images)
TCFG = dict(n_rays=N_RAYS, target_batch_size=CAPACITY, march_steps=64,
            sample_image_proportional_to_error=True,
            sample_focal_plane_proportional_to_error=True)


def nerf_setup():
    """The JAX trainer of the JAX dist tests (``make_orbit_dataset(res=16)``,
    4 levels, log2_hashmap_size 12) with a live grid, and the numpy setup
    the ranks rebuild it from."""
    from ngp_tpu.config import load_network_config
    from ngp_tpu.train.nerf import NerfTrainer, NerfTrainerConfig
    ds = make_orbit_dataset(res=16)
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(**TCFG))
    tr.grid = tr.grid._replace(bitfield=jnp.full_like(tr.grid.bitfield, 255),
                               coarse=jnp.ones_like(tr.grid.coarse))
    setup = {"fields": {f.name: getattr(ds, f.name)
                        for f in dataclasses.fields(ds)},
             "cfg": cfg, "tcfg": TCFG,
             "tree": jax.tree.map(np.array, tr.params),
             "grid": jax.tree.map(np.asarray, tr.grid._asdict()),
             "err": jax.tree.map(np.asarray, tr._error_state())}
    return tr, setup


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from ngp_tpu.dist.mesh import make_mesh
    from ngp_tpu.dist.nerf_dp import make_dp_train_step
    tr, setup = nerf_setup()
    key = jax.random.PRNGKey(KEY)
    draws = [[a.numpy() for a in _draws_of_jax_key(
        jax.random.fold_in(key, r), N_RAYS) if a is not None]
             for r in range(2)]
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    step = make_dp_train_step(tr, mesh, n_rays_per_device=N_RAYS,
                              samples_per_device=CAPACITY)
    with mesh:
        j = step(tr.params, tr.opt_state, tr.cam_params, tr.cam_m, tr.cam_v,
                 tr.error_map, tr.sharpness_grid, tr._error_state(),
                 tr.grid.bitfield, tr.grid.coarse, tr.grid.mean, key, tr.data)
    ranks = run_ranks(dp_world, 2, "gloo",
                      tmp_path_factory.mktemp("dp") / "store",
                      args=(setup, draws, CAPACITY))
    return {"jax": jax.tree.map(np.asarray, j), "ranks": ranks,
            "tree": setup["tree"], "lr": tr.opt_cfg.learning_rate}


def _jax_tree_by_name(tree, names):
    """A JAX NerfNetwork tree as {port parameter name: array}."""
    flat = {"pos_encoding.table": tree["pos_encoding"]}
    for net in ("density_net", "rgb_net"):
        flat.update({f"{net}.weights.{i}": w
                     for i, w in enumerate(tree[net])})
    assert set(flat) == set(names)
    return flat


def test_world_layout(dp):
    assert [r["coords"] for r in dp["ranks"]] == [(0, 0), (1, 0)]
    assert [r["mesh1"] for r in dp["ranks"]] == [True, False]


def test_dp2_loss_and_counts_match_jax(dp):
    j_loss = float(dp["jax"][7])
    for r in dp["ranks"]:
        got = r["dp2"]
        print(f"loss jax {j_loss:.6e} port {got['loss']:.6e}; samples "
              f"{got['total']}, rays with samples "
              f"{got['n_rays_with_samples']}")
        np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-4)
        assert got["total"] > 2 * N_RAYS
        assert got["n_rays_with_samples"] == 2 * N_RAYS


def test_dp2_counts_are_the_ranks_sums(dp):
    """The stats of a DP(2) step are the sums of the ranks' own steps: the
    samples, the rays with samples and the surviving segments (the JAX
    step reports one device's segment count, unsummed)."""
    own = [r["own"] for r in dp["ranks"]]
    for r in dp["ranks"]:
        for k in ("total", "seg_total", "n_rays_with_samples"):
            assert r["dp2"][k] == sum(o[k] for o in own), k
    assert own[0]["seg_total"] > 0


def test_dp2_gradients_match_jax(dp):
    """The first Adam moment is 0.1·(g/LOSS_SCALE + l2·p): the summed
    gradient of each leaf within 1e-2 of the JAX step's (the relative
    rule of test_torch_train_step)."""
    got = dp["ranks"][0]["dp2"]["mu"]
    ref = _jax_tree_by_name(dp["jax"][1].mu, got)
    for k in ref:
        norm = float(np.linalg.norm(ref[k]))
        rel = float(np.linalg.norm(got[k] - ref[k])) / norm
        print(f"mu {k}: |mu| {norm:.3e}, relative difference {rel:.2e}")
        assert norm > 0 and rel <= 1e-2, k


def test_dp2_parameters_match_jax(dp):
    """Parameters after the step to test_torch_train_step's rule (rtol
    1e-6, atol 1e-6·lr), on all but the entries whose near-zero gradient
    has another sign in the other framework (Adam's first step moves every
    entry by about ±lr): at most 0.5 %, as tests/test_dp.py allows."""
    got = dp["ranks"][0]["dp2"]["params"]
    ref = _jax_tree_by_name(dp["jax"][0], got)
    for k in ref:
        close = np.isclose(got[k], ref[k], rtol=1e-6, atol=1e-6 * dp["lr"])
        print(f"{k}: {close.mean():.5f} of entries within rtol 1e-6")
        assert close.mean() >= 0.995, k


def test_dp2_ranks_hold_the_same_state(dp):
    a, b = (r["dp2"] for r in dp["ranks"])
    for field in ("params", "mu", "nu", "ema"):
        for k in a[field]:
            np.testing.assert_array_equal(a[field][k], b[field][k])
    np.testing.assert_array_equal(a["error_map"], b["error_map"])
    assert a["loss"] == b["loss"]


def test_dp2_error_map_and_sharpness_match_jax(dp):
    """The deposits summed over the ranks, and the sharpness grid as their
    maximum, as the JAX step's psum and pmax give them."""
    got = dp["ranks"][0]["dp2"]
    ref = dp["jax"][5]
    assert (ref != 0).sum() > 100
    np.testing.assert_allclose(got["error_map"], ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    j_sharp = dp["jax"][6]
    assert (j_sharp != 0).sum() > 10
    np.testing.assert_array_equal(got["sharpness"] != 0, j_sharp != 0)
    np.testing.assert_allclose(got["sharpness"], j_sharp, rtol=1e-4)


def test_dp1_is_bit_equal_to_the_single_device_step(dp):
    r0 = dp["ranks"][0]
    a, b = r0["dp1"], r0["single"]
    for k in ("loss", "total", "seg_total", "n_rays_with_samples", "step"):
        assert a[k] == b[k], k
    for field in ("params", "mu", "nu", "ema"):
        for k in a[field]:
            np.testing.assert_array_equal(a[field][k], b[field][k])
    np.testing.assert_array_equal(a["error_map"], b["error_map"])
    np.testing.assert_array_equal(a["sharpness"], b["sharpness"])


def test_camera_l2_counts_once_per_rank(dp):
    """A fault of the JAX step the port keeps: extrinsic_l2_reg is added
    on every rank before the gradient sum, so DP(N) counts it N times. On
    an empty grid the pose gradient is that term alone: DP(2)'s first
    camera moment is twice the single-device one."""
    for r in dp["ranks"]:
        dp2, one = r["cam_dp2"]["cam_m"], r["cam_single"]["cam_m"]
        assert r["cam_dp2"]["total"] == 0
        for k in ("rot", "trans"):
            assert np.abs(one[k]).min() > 0
            np.testing.assert_allclose(dp2[k], 2.0 * one[k], rtol=1e-6)


def test_dp_trainer_trains_and_ranks_agree(dp):
    """``DpNerfTrainer.train(32)``: exactly 32 steps, a finite loss, and
    every rank's parameters, occupancy grid and error map bit-identical
    (the sweeps draw from the generator every rank seeds alike)."""
    a, b = (r["trainer"] for r in dp["ranks"])
    assert a["step"] == b["step"] == 32
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert a["n_rays"] == b["n_rays"]
    start = _jax_tree_by_name(dp["tree"], a["params"])
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert not np.array_equal(a["params"][k], start[k])
    for k in ("density", "bitfield", "error_map"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["bitfield"].any()


def test_dp_trainer_missing_attribute_raises_attribute_error():
    """Not the JAX wrapper's ``__getattr__`` recursion
    (ngp_tpu/dist/nerf_dp.py:140): a missing attribute of a partly built
    trainer raises AttributeError."""
    from ngp_tpu_torch.dist.nerf_dp import DpNerfTrainer
    tr = DpNerfTrainer.__new__(DpNerfTrainer)
    with pytest.raises(AttributeError):
        tr.params
    with pytest.raises(AttributeError):
        tr.no_such_attribute
