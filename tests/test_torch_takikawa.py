"""Parity of the port's Takikawa octree encoding and its SDF trainer with
the JAX package's: the per-level bitsets, the encoding and its gradients
(the JAX side through its plain ``encode_reference``, as it runs on the
CPU), the octree-uniform training batches (bit for bit for one seed), one
step from the same weights, the IoU under the octree rule, and the
parameters carried both ways by ``bridge``; and the intended divergence
of the port's renderer, which traces a Takikawa model through its octree.
A 2048-triangle torus and
configs/sdf/takikawa.json cut to octree depths 3..6 keep it fast."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.config import load_network_config as j_load
from ngp_tpu.nn import takikawa as jtak
from ngp_tpu.render.sdf_render import SdfRenderer as JRenderer
from ngp_tpu.render.sdf_render import SdfRenderOptions as JOptions
from ngp_tpu.train import sdf as jsdf
from ngp_tpu_torch import bridge
from ngp_tpu_torch.nn import takikawa as ttak
from ngp_tpu_torch.render.sdf_render import SdfRenderer as TRenderer
from ngp_tpu_torch.render.sdf_render import SdfRenderOptions as TOptions
from ngp_tpu_torch.train import sdf as tsdf
from test_torch_sdf import private_jax_bvh, write_torus_obj

BATCH = 1 << 12
# the bf16 re-rounding between MLP layers (test_torch_encoded_network)
TOL, MOSTLY = 1e-5, 0.999


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread(tmp_path_factory):
    private_jax_bvh(tmp_path_factory.mktemp("jax_bvh"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    return write_torus_obj(tmp_path_factory.mktemp("tak") / "torus.obj")


def tak_config():
    """configs/sdf/takikawa.json at octree depths 3..6 (4 levels) and a
    16-wide MLP."""
    cfg = j_load("configs/sdf/takikawa.json")
    cfg["encoding"].update(n_levels=6, starting_level=3)
    cfg["network"].update(n_neurons=16)
    return cfg


def test_bitsets_match_jax():
    pts = np.random.default_rng(0).random((4096, 3), dtype=np.float32)
    pts[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1],
               [0.999, 0.001, 0.5], [0.25, 0.75, 1], [0, 1, 0], [1, 0, 0]]
    got = ttak.build_surface_occupancy(pts, 6, 3)
    ref = jtak.build_surface_occupancy(pts, 6, 3)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    meta = ttak.TakikawaMeta(start_depth=3, max_depth=6)
    enc = ttak.TakikawaEncoding(meta, pts[:64], device="cpu")
    jenc = jtak.TakikawaEncoding(jtak.TakikawaMeta(start_depth=3,
                                                   max_depth=6), pts[:64])
    for level, bits in enumerate(jenc.occupancy):
        np.testing.assert_array_equal(
            getattr(enc, f"occupancy_{level}").numpy(), np.asarray(bits))
    q = np.random.default_rng(1).random((2048, 3), dtype=np.float32)
    inside = enc.contains(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(inside, np.asarray(jenc.contains(q)))
    assert 0.0 < inside.mean() < 1.0


@pytest.fixture(scope="module")
def encodings():
    """The two encodings over the same surface samples, with the same
    seeded table (std 0.1)."""
    surf = np.random.default_rng(2).random((512, 3), dtype=np.float32) \
        * 0.5 + 0.25
    meta = dict(start_depth=3, max_depth=6)
    enc = ttak.TakikawaEncoding(ttak.TakikawaMeta(**meta), surf,
                                device="cpu")
    jenc = jtak.TakikawaEncoding(jtak.TakikawaMeta(**meta), surf)
    table = (np.random.default_rng(3).standard_normal(
        tuple(enc.table.shape)) * 0.1).astype(np.float32)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    assert enc.grid_meta.n_levels == 4 and enc.n_output_dims == 8
    return enc, jenc, table


def test_encoding_and_gradients_match_jax(encodings):
    """Features to rtol 1e-6; the table and position gradients of a
    seeded weighting of the features to 1e-5 of jax.grad's."""
    enc, jenc, table = encodings
    rng = np.random.default_rng(4)
    pos = rng.random((3000, 3), dtype=np.float32)
    w = rng.standard_normal((3000, 8)).astype(np.float32)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = enc(p)
    ref = np.asarray(jenc.apply(jnp.asarray(table), jnp.asarray(pos)))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-7)
    assert (np.abs(ref) > 0).mean() > 0.2 and (ref == 0).mean() > 0.05
    g_table, g_pos = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                         [enc.table, p])
    j_table, j_pos = jax.grad(
        lambda t, x: jnp.sum(jenc.apply(t, x) * w), argnums=(0, 1))(
            jnp.asarray(table), jnp.asarray(pos))
    np.testing.assert_allclose(g_table.numpy(), np.asarray(j_table),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_pos.numpy(), np.asarray(j_pos), rtol=1e-5,
                               atol=1e-5)


def test_training_batches_match_jax_bit_for_bit(torus):
    jtr = jsdf.SdfTrainer(torus, tak_config(), seed=7, batch_size=BATCH)
    ttr = tsdf.SdfTrainer(torus, tak_config(), seed=7, batch_size=BATCH,
                          device="cpu")
    assert ttr.use_octree_uniform and jtr.use_octree_uniform
    np.testing.assert_array_equal(ttr._octree_leaves, jtr._octree_leaves)
    assert ttr.perturb_sigma == jtr.perturb_sigma
    for _ in range(2):
        (tp, td), (jp, jd) = (ttr.generate_training_batch(),
                              jtr.generate_training_batch())
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(td, jd)


@pytest.fixture(scope="module")
def pair(torus):
    """JAX and port trainers on the torus, the port's parameters (a
    seeded table at std 0.1) carried into the JAX one."""
    jtr = jsdf.SdfTrainer(torus, tak_config(), batch_size=BATCH)
    ttr = tsdf.SdfTrainer(torus, tak_config(), batch_size=BATCH,
                          device="cpu")
    tree = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    tree["encoding"] = (np.random.default_rng(1).standard_normal(
        tree["encoding"].shape) * 0.1).astype(np.float32)
    with torch.no_grad():
        for k, val in bridge.encoded_params_from_numpy(tree,
                                                       ttr.model).items():
            ttr.params[k].copy_(val)
            ttr.opt_state.ema_params[k].copy_(val)
    jtr.params = jax.tree.map(jnp.array, tree)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array, tree))
    return jtr, ttr, tree


def test_parameters_cross_both_ways(pair):
    """bridge's tree of the port's Takikawa model has the JAX model's
    structure and leaves, and carries back unchanged; the L2 mask covers
    the MLP's matrices only, as JAX's matrix_mask does."""
    jtr, ttr, tree = pair
    j_tree = jax.tree.map(np.asarray, jtr.params)
    assert jax.tree.structure(tree) == jax.tree.structure(j_tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(j_tree)):
        np.testing.assert_array_equal(a, b)
    back = bridge.encoded_params_from_numpy(j_tree, ttr.model)
    assert set(back) == set(ttr.params) == {"encoding.table"} | {
        f"net.weights.{i}" for i in range(len(ttr.model.net.weights))}
    mask = jtr.model.matrix_mask(jtr.params)
    assert ttr.matrix_names == {
        f"net.weights.{i}" for i, m in enumerate(mask["net"]) if m}
    assert mask["encoding"] is False


def test_step_distances_and_iou_match_jax(pair):
    jtr, ttr, _ = pair
    pts = np.random.default_rng(5).random((4096, 3), dtype=np.float32)
    got, ref = ttr.distance_at(pts), jtr.distance_at(pts)
    err = np.abs(got - ref)
    assert (err <= TOL + TOL * np.abs(ref)).mean() >= MOSTLY
    # the octree rule: both count samples outside the octree as agreeing
    np.testing.assert_allclose(ttr.calculate_iou(1 << 14),
                               jtr.calculate_iou(1 << 14), atol=2e-3)
    pos, dist = ttr.generate_training_batch()
    t_loss = float(ttr.step(pos, dist))
    jtr.params, jtr.state, j_loss = jtr._train_step(
        jtr.params, jtr.state, jnp.asarray(pos), jnp.asarray(dist))
    # MAPE near the surface samples moves by a bf16 ulp's re-rounding
    # (test_torch_sdf)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=2e-3)
    lr = ttr.opt_cfg.learning_rate
    t_now = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    for g, r in zip(jax.tree.leaves(t_now),
                    jax.tree.leaves(jax.tree.map(np.asarray, jtr.params))):
        e = np.abs(g - r)
        assert (e <= 1e-6).mean() >= MOSTLY
        assert e.max() <= 2 * lr + 1e-6


CAMERA = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.6]],
                  np.float32)


def test_frames_trace_through_the_octree(torus):
    """The intended divergence: the port's SdfRenderer traces a Takikawa
    model through its octree (steps by the empty cells' widths outside
    it, no hit there), so a short fit's 48×32 frame finds the BVH's hits
    (≥ 95 % of pixels agree); the JAX renderer, given the same
    parameters, stops its rays where they leave the octree, where the
    network reads 0."""
    cfg = tak_config()
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-2
    ttr = tsdf.SdfTrainer(torus, cfg, batch_size=1 << 12, device="cpu")
    ttr.train(80)
    opts = dict(width=48, height=32, focal=32.0, chunk=2048)
    r = TRenderer(ttr.model, TOptions(**opts))
    got = r.render(ttr.inference_params(), CAMERA)
    o, d = r.camera_rays(CAMERA, 48, 32)
    bvh = (ttr.bvh.raytrace(o, d)[1] >= 0).reshape(32, 48)
    assert 0.1 < bvh.mean() < 0.9
    assert ((got[..., 3] > 0) == bvh).mean() >= 0.95
    jtr = jsdf.SdfTrainer(torus, cfg, batch_size=BATCH)
    tree = bridge.encoded_params_to_numpy(ttr.inference_params(), ttr.model)
    ref = JRenderer(jtr.model, JOptions(**opts)).render(
        jax.tree.map(jnp.array, tree), CAMERA)
    assert ((ref[..., 3] > 0) == bvh).mean() < 0.9
