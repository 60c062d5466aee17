"""Table-parallel NeRF training of the port (``ngp_tpu_torch.dist.tp_nerf``)
in a gloo world of two CPU ranks (data 1 × model 2), against the JAX
package's ``make_tp_nerf_train_step`` on a 1 × 2 mesh and against the
single-device step, on the draws the JAX step makes from
``fold_in(key, 0)``. About 20 s alone."""
import functools

import jax
import numpy as np
import pytest

from test_torch_dist_dp import (CAPACITY, KEY, N_RAYS, _jax_tree_by_name,
                                nerf_setup)
from test_torch_train_step import _draws_of_jax_key
from torch_dist_ranks import tp_nerf_world
from ngp_tpu_torch.dist.mesh import run_ranks

M = 2


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    from ngp_tpu.dist.mesh import make_mesh
    from ngp_tpu.dist.tp_nerf import make_tp_nerf_train_step
    tr, setup = nerf_setup()
    key = jax.random.PRNGKey(KEY)
    k0 = jax.random.fold_in(key, 0)
    err = tr._error_state()
    args = (tr.cam_params, tr.cam_m, tr.cam_v, tr.error_map,
            tr.sharpness_grid, err, tr.grid.bitfield, tr.grid.coarse,
            tr.grid.mean)
    single = jax.jit(functools.partial(tr._train_step_impl, n_rays=N_RAYS,
                                       capacity=CAPACITY))
    p1, s1, *_ = single(tr.params, tr.opt_state, *args, k0, tr.data)
    tr_tp, _ = nerf_setup()
    mesh = make_mesh(n_data=1, n_model=M, devices=jax.devices()[:M])
    step = make_tp_nerf_train_step(tr_tp, mesh, n_rays_per_device=N_RAYS,
                                   samples_per_device=CAPACITY)
    with mesh:
        p_tp, s_tp, loss_tp = step(tr.params, tr.opt_state, *args, key,
                                   tr.data)
    draws = [a.numpy() for a in _draws_of_jax_key(k0, N_RAYS)
             if a is not None]
    ranks = run_ranks(tp_nerf_world, M, "gloo",
                      tmp_path_factory.mktemp("tp_nerf") / "store",
                      args=(setup, draws, CAPACITY))
    return {"single": jax.tree.map(np.asarray, (p1, s1.mu)),
            "tp": jax.tree.map(np.asarray, (p_tp, s_tp.mu)),
            "loss": float(loss_tp), "ranks": ranks,
            "lr": tr.opt_cfg.learning_rate}


def _joined(ranks, what, field):
    """The ranks' state ``field`` of run ``what`` with the table shards
    joined in model order."""
    from ngp_tpu_torch import bridge
    own = [r[what][field] for r in ranks]
    out = dict(own[0])
    out["pos_encoding.table"] = bridge.join_rows(
        [o["pos_encoding.table"] for o in own])
    return out


def test_world_layout_and_shards(tp):
    ranks = tp["ranks"]
    assert [r["coords"] for r in ranks] == [(0, m) for m in range(M)]
    full = ranks[0]["single"]["params"]["pos_encoding.table"].shape
    for r in ranks:
        assert r["table_rows"] == (full[0], full[1] // M, full[2])


def _tp_rule(got: dict, ref: dict, lr: float):
    """tests/test_tp_nerf.py's rule for a TP step against another step:
    fewer than 0.1 % of the table entries off by more than 5e-5 (entries
    whose gradient contributions nearly cancel may take Adam's ±lr the
    other way), none by more than 2.5·lr; the MLPs to rtol 2e-4."""
    diff = np.abs(got["pos_encoding.table"] - ref["pos_encoding.table"])
    print(f"table: {(diff > 5e-5).mean():.2e} of entries off by > 5e-5, "
          f"max {diff.max():.3e}")
    assert float((diff > 5e-5).mean()) < 1e-3
    assert float(diff.max()) <= 2.5 * lr
    for k in got:
        if k != "pos_encoding.table":
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5)


def test_tp_step_matches_jax_tp_step(tp):
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["tp"]["loss"], tp["loss"], rtol=1e-4)
    got = _joined(tp["ranks"], "tp", "params")
    _tp_rule(got, _jax_tree_by_name(tp["tp"][0], got), tp["lr"])


def test_tp_step_matches_single_device_step(tp):
    r0 = tp["ranks"][0]
    np.testing.assert_allclose(r0["tp"]["loss"], r0["single"]["loss"],
                               rtol=1e-4)
    _tp_rule(_joined(tp["ranks"], "tp", "params"), r0["single"]["params"],
             tp["lr"])


def test_tp_ranks_share_the_replicated_state(tp):
    a, b = (r["tp"] for r in tp["ranks"])
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        if k != "pos_encoding.table":
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    np.testing.assert_array_equal(a["error_map"], b["error_map"])


def test_table_gradient_is_the_single_device_one_not_m_times(tp):
    """The first Adam moment of the table is 0.1·g/LOSS_SCALE. The JAX TP
    step's gradient is taken inside shard_map through psum(out, "model"),
    whose transpose sums again: its table moment is M times the
    single-device step's. The port's sum over ``model`` has the identity
    as its backward: its shards' moments are the single-device moment's
    rows."""
    j_single = tp["single"][1]["pos_encoding"]
    j_tp = tp["tp"][1]["pos_encoding"]
    live = np.abs(j_single) > 1e-3 * np.abs(j_single).max()
    assert live.sum() > 100
    ratio = j_tp[live] / j_single[live]
    print(f"JAX TP / single-device table moment: median "
          f"{np.median(ratio):.4f}, range {ratio.min():.4f}.."
          f"{ratio.max():.4f}")
    assert abs(np.median(ratio) - M) < 1e-2
    got = _joined(tp["ranks"], "tp", "mu")["pos_encoding.table"]
    ref = tp["ranks"][0]["single"]["mu"]["pos_encoding.table"]
    port_ratio = got[live] / ref[live]
    print(f"port TP / single-device table moment: median "
          f"{np.median(port_ratio):.4f}")
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
