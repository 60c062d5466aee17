"""The rank grid, the table-parallel encode and ``TpImageTrainer`` of the
port (``ngp_tpu_torch.dist``) in a gloo world of four CPU ranks (data 2 ×
model 2), against the JAX package's ``make_tp_blocked_encode`` on a 2 × 2
mesh, the port's plain encode and the single-device ``ImageTrainer``; and
the parts that need no world (``shard_params``, the bridge's shards).
About 10 s alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_ranks import encode_world
from ngp_tpu_torch import bridge
from ngp_tpu_torch.dist.mesh import (Mesh, replicated, run_ranks,
                                     shard_params, table_sharding)
from ngp_tpu_torch.kernels.blocked_grid import (BlockedGridMeta,
                                                encode_backward_reference,
                                                encode_reference)

META = dict(n_dims=3, n_levels=4, base_resolution=16, per_level_scale=1.5,
            log2_rows=8)
N_POS, IMAGE_RES, IMAGE_BATCH, IMAGE_STEPS = 256, 64, 1024, 3


def image_config():
    from ngp_tpu_torch.config import load_network_config
    cfg = load_network_config("configs/image/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    cfg["network"]["n_neurons"] = 16
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ngp_tpu.kernels.blocked_grid import BlockedGridMeta as JMeta
    # the JAX package's initial table (its own test of this encode), and a
    # table of unit values, whose features cancel in places
    table = np.array(JMeta(**META).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    unit = rng.standard_normal(table.shape).astype(np.float32)
    pos = np.array(jax.random.uniform(jax.random.PRNGKey(1), (N_POS, 3)))
    cot = rng.standard_normal((N_POS, 2 * META["n_levels"])).astype(
        np.float32)
    yy, xx = np.mgrid[0:IMAGE_RES, 0:IMAGE_RES] / IMAGE_RES
    image = np.stack([np.sin(7 * xx) * 0.5 + 0.5, yy, xx * yy,
                      np.ones_like(xx)], -1).astype(np.float32)
    image_pos = [rng.random((IMAGE_BATCH, 2), np.float32)
                 for _ in range(IMAGE_STEPS)]
    ranks = run_ranks(encode_world, 4, "gloo",
                      tmp_path_factory.mktemp("encode") / "store",
                      args=(META, [table, unit], pos, cot, image,
                            image_config(), image_pos))
    return {"ranks": ranks, "table": table, "unit": unit, "pos": pos,
            "cot": cot,
            "image": image, "image_pos": image_pos}


def test_grid_is_row_major(world):
    """Rank d·M + m sits at (d, m), as JAX lays out reshape(n_data,
    n_model); a rank outside a sub-grid's ranks gets None."""
    for rank, r in enumerate(world["ranks"]):
        assert r["coords"] == (rank // 2, rank % 2)
        assert r["pair"] == (rank in (0, 1))
        assert r["alone"] == (rank == 3)
        rows = BlockedGridMeta(**META).rows // 2
        assert r["rows"] == (r["coords"][1] * rows, (r["coords"][1] + 1)
                             * rows)
        assert r["batch"] == (r["coords"][0] * N_POS // 2,
                              (r["coords"][0] + 1) * N_POS // 2)


def test_tp_encode_matches_jax_and_the_plain_encode(world):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ngp_tpu.dist.mesh import make_mesh, make_tp_blocked_encode
    from ngp_tpu.kernels.blocked_grid import BlockedGridMeta as JMeta
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    enc = make_tp_blocked_encode(JMeta(**META), mesh, data_sharded=True)
    tbl = jax.device_put(jnp.asarray(world["table"]),
                         NamedSharding(mesh, P(None, "model")))
    pos = jax.device_put(jnp.asarray(world["pos"]),
                         NamedSharding(mesh, P("data")))
    with mesh:
        ref_jax = np.asarray(jax.jit(enc)(tbl, pos))
    refs = [encode_reference(torch.from_numpy(world[t]),
                             torch.from_numpy(world["pos"]),
                             BlockedGridMeta(**META)).numpy()
            for t in ("table", "unit")]
    for r in world["ranks"]:
        sl = slice(*r["batch"])
        np.testing.assert_allclose(r["feats"][0], ref_jax[sl], rtol=1e-5,
                                   atol=1e-6)
        # every lookup lies in one row, so one rank sums its corners as
        # the plain encode does and the others add zeros: the same bits
        for got, ref in zip(r["feats"], refs):
            np.testing.assert_array_equal(got, ref[sl])


def test_tp_encode_shard_gradients_are_the_single_device_rows(world):
    """Each rank's table gradient is the rows it holds of the
    single-device gradient of its data shard: the sum over ``model`` has
    the identity as its backward, so no shard's gradient is scaled by M."""
    meta = BlockedGridMeta(**META)
    for r in world["ranks"]:
        sl = slice(*r["batch"])
        full = encode_backward_reference(
            torch.from_numpy(world["pos"][sl]),
            torch.from_numpy(world["cot"][sl]), meta).numpy()
        ref = full[:, slice(*r["rows"])]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(r["grad"], ref, rtol=1e-4, atol=1e-6)


def _single_image_trainer(world):
    from ngp_tpu_torch.train.image import ImageTrainer
    tr = ImageTrainer(world["image"], image_config(),
                      batch_size=IMAGE_BATCH, device="cpu")
    losses = [float(tr.step(torch.from_numpy(p)))
              for p in world["image_pos"]]
    params = {"table": tr.params["encoding.table"].detach().numpy(),
              **{k: v.detach().numpy() for k, v in tr.params.items()
                 if k.startswith("net.")}}
    return losses, params, tr


def _joined_image_params(fits):
    out = dict(fits[0]["params"])
    out["table"] = bridge.join_rows([f["params"]["table"] for f in fits])
    return out


def test_tp_image_trainer_model2_matches_image_trainer(world):
    """``TpImageTrainer`` on model 2 (one data shard): the steps of the
    single-device ``ImageTrainer`` on the same positions, after Adam."""
    losses, ref, tr = _single_image_trainer(world)
    fits = [r["image_model2"] for r in world["ranks"][:2]]
    lr = tr.opt_cfg.learning_rate
    for f in fits:
        np.testing.assert_allclose(f["losses"], losses, rtol=1e-6)
    got = _joined_image_params(fits)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6 * lr)
    full = tr.params["encoding.table"]
    for f in fits:
        assert f["shard_bytes"] * 2 == full.numel() * full.element_size()
    np.testing.assert_allclose(fits[0]["eval"], fits[1]["eval"], rtol=0)
    np.testing.assert_allclose(
        fits[0]["eval"], tr.eval_positions(world["image_pos"][0][:64]),
        rtol=1e-6, atol=1e-7)


def test_tp_image_trainer_2x2_matches_image_trainer(world):
    """Data 2 × model 2: each data rank takes its half of the batch, the
    loss is normalised by the whole batch and the gradients summed over
    ``data``. The MLP's gradient sums in another order than on one device,
    and Adam's later steps divide by its history, so an MLP entry may move
    a fraction of lr otherwise; none moves the other way."""
    losses, ref, tr = _single_image_trainer(world)
    lr = tr.opt_cfg.learning_rate
    fits = [r["image_2x2"] for r in world["ranks"]]
    for f in fits:
        np.testing.assert_allclose(f["losses"], losses, rtol=1e-5)
    for d in range(2):
        got = _joined_image_params(fits[2 * d:2 * d + 2])
        for k in ref:
            diff = np.abs(got[k] - ref[k])
            print(f"{k}: max |diff| {diff.max() / lr:.3e} lr")
            if k == "table":
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           atol=1e-5 * lr)
            else:
                # no entry moved the other way (that would be ~2·lr)
                assert diff.max() <= 0.1 * lr, k
    a, b = fits[0]["params"], fits[2]["params"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_shard_params_keeps_the_jax_rule():
    """Only 1-D parameters of at least 2^20 elements shard over ``model``:
    a blocked (L, R, 128) table never does."""
    mesh = Mesh(ranks=(0, 1), n_data=1, n_model=2, data_index=0,
                model_index=1, data_group=None, model_group=None)
    params = {"table": torch.zeros((16, 8192, 128)),
              "flat": torch.arange(1 << 20, dtype=torch.float32),
              "small": torch.zeros(1000)}
    out = shard_params(params, mesh, shard_tables=True)
    assert out["table"] is params["table"]
    assert out["small"] is params["small"]
    torch.testing.assert_close(out["flat"], params["flat"][1 << 19:])
    assert all(out_t is params[k] for k, out_t in
               shard_params(params, mesh).items())
    assert replicated(mesh, 7) == slice(0, 7)
    assert table_sharding(mesh, 8192) == slice(4096, 8192)
    with pytest.raises(ValueError):
        table_sharding(mesh, 7)


def test_bridge_shards_and_joins_trees_and_adam_state():
    rng = np.random.default_rng(0)
    table = rng.random((4, 64, 128), np.float32)
    tree = {"table": table, "net": (rng.random((8, 16), np.float32),)}
    shards = [bridge.shard_tree(tree, "table", m, 4) for m in range(4)]
    assert shards[1]["table"].shape == (4, 16, 128)
    np.testing.assert_array_equal(shards[1]["table"], table[:, 16:32])
    assert shards[3]["net"] is tree["net"]
    np.testing.assert_array_equal(
        bridge.join_trees(shards, "table")["table"], table)
    nerf = {"pos_encoding": table, "density_net": (table[0, :8],)}
    adam = {"step": np.int32(3), "mu": nerf,
            "nu": {**nerf, "pos_encoding": table * 2},
            "ema_params": nerf}
    parts = [bridge.shard_adam(adam, "pos_encoding", m, 2) for m in range(2)]
    np.testing.assert_array_equal(parts[1]["nu"]["pos_encoding"],
                                  table[:, 32:] * 2)
    back = bridge.join_adam(parts, "pos_encoding")
    assert back["step"] == 3
    for f in ("mu", "nu", "ema_params"):
        np.testing.assert_array_equal(back[f]["pos_encoding"],
                                      adam[f]["pos_encoding"])
    with pytest.raises(ValueError):
        bridge.shard_rows(table, 0, 3)
