"""Parity of the port's SDF engine with the JAX package's: mesh loading,
every host-BVH query (the port's own build of its copy of bvh.cpp), the
training batches (bit for bit for one seed), a step, the distances, the
IoU and SdfRenderer frames in both normal modes. A 2048-triangle torus, a
small config (4 levels, 16-wide MLP) and batches of 2^12 keep it fast on
the CPU."""
import shutil
import struct
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.config import load_network_config as j_load
from ngp_tpu.data import mesh as jmesh
from ngp_tpu.render.sdf_render import SdfRenderer as JRenderer
from ngp_tpu.render.sdf_render import SdfRenderOptions as JOptions
from ngp_tpu.train import sdf as jsdf
from ngp_tpu_torch import bridge
from ngp_tpu_torch.data import mesh as tmesh
from ngp_tpu_torch.render.sdf_render import SdfRenderer as TRenderer
from ngp_tpu_torch.render.sdf_render import SdfRenderOptions as TOptions
from ngp_tpu_torch.train import sdf as tsdf

BATCH = 1 << 12
# the bf16 re-rounding between MLP layers (test_torch_encoded_network)
TOL, MOSTLY, BF16_TOL = 1e-5, 0.999, 2e-2


def private_jax_bvh(root: Path):
    """Give this process the JAX package's BVH built from its own source
    with its own flags, but under ``root``: the JAX loader builds it at
    first use straight into the checkout's csrc/libngpbvh.so
    (ngp_tpu/data/mesh.py:25-50), where test workers building it at once
    could load a half-written file. The loader keeps the library it loaded
    (its ``_LIB``) for the rest of the process."""
    if jmesh._LIB is not None:
        return
    (root / "csrc").mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(jmesh.__file__).resolve().parents[2] / "csrc" /
                "bvh.cpp", root / "csrc")
    with mock.patch.object(jmesh, "__file__",
                           str(root / "ngp_tpu" / "data" / "mesh.py")):
        jmesh._lib()


@pytest.fixture(scope="module", autouse=True)
def _jax_bvh(tmp_path_factory):
    private_jax_bvh(tmp_path_factory.mktemp("jax_bvh"))


def write_torus_obj(path, R=0.3, r=0.1, nu=64, nv=16):
    """A closed torus about z: nu × nv quads, each as two triangles."""
    u = np.arange(nu) * 2 * np.pi / nu
    v = np.arange(nv) * 2 * np.pi / nv
    U, V = np.meshgrid(u, v, indexing="ij")
    ring = R + r * np.cos(V)
    verts = np.stack([ring * np.cos(U), ring * np.sin(U), r * np.sin(V)],
                     -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = (i + 1) % nu * nv + j
    c = (i + 1) % nu * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    with open(path, "w") as f:
        f.writelines(f"v {x:.7f} {y:.7f} {z:.7f}\n" for x, y, z in verts)
        f.writelines(f"f {p + 1} {q + 1} {s + 1}\n" for p, q, s in faces)
    return path


def write_cube(tmp_path):
    """A unit cube scaled and moved off the origin, as an OBJ of quads
    (with a negative index) and as a binary STL of its 12 triangles."""
    corners = np.array([[(i >> k) & 1 for k in range(3)] for i in range(8)],
                       np.float32) * [2.0, 1.0, 0.5] + [3.0, -1.0, 0.25]
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
             (0, 4, 6, 2), (1, 3, 7, 5)]
    obj = tmp_path / "cube.obj"
    with open(obj, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in corners)
        for q in quads[:-1]:
            f.write("f " + " ".join(f"{k + 1}/1/1" for k in q) + "\n")
        f.write("f " + " ".join(str(k - 8) for k in quads[-1]) + "\n")
    tris = [(q[0], q[1], q[2]) for q in quads] + \
        [(q[0], q[2], q[3]) for q in quads]
    stl = tmp_path / "cube.stl"
    with open(stl, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0))
            for k in t:
                f.write(struct.pack("<3f", *corners[k]))
            f.write(b"\0\0")
    return obj, stl


def small_config():
    cfg = j_load("configs/sdf/base.json")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"].update(n_neurons=16)
    return cfg


def fit_config():
    """4 levels that fit a torus in 150 steps on the CPU: coarse enough to
    be mostly dense in 1024 rows, at a raised learning rate (the small
    config's fine levels hash into 64 rows and never fit it)."""
    cfg = small_config()
    cfg["encoding"].update(log2_hashmap_size=16, base_resolution=16,
                           per_level_scale=1.5)
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-2
    return cfg


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    return write_torus_obj(tmp_path_factory.mktemp("sdf") / "torus.obj")


def test_load_mesh_matches_jax(tmp_path, torus):
    obj, stl = write_cube(tmp_path)
    for path in (obj, stl, torus):
        got, ref = tmesh.load_mesh(path), jmesh.load_mesh(path)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        v = got[0]
        assert v.min() >= 0.0 and v.max() <= 1.0
    assert len(tmesh.load_mesh(obj)[1]) == len(tmesh.load_mesh(stl)[1]) == 12
    with pytest.raises(ValueError):
        tmesh.load_mesh(tmp_path / "mesh.ply")


def test_bvh_queries_match_jax(torus):
    v, f, _, _ = tmesh.load_mesh(torus)
    tb, jb = tmesh.TriangleBvh(v, f), jmesh.TriangleBvh(v, f)
    rng = np.random.default_rng(0)
    pts = rng.random((4096, 3), dtype=np.float32)
    for mode in (tb.MODE_WATERTIGHT, tb.MODE_RAYSTAB, tb.MODE_PATHESCAPE):
        np.testing.assert_array_equal(tb.signed_distance(pts, mode),
                                      jb.signed_distance(pts, mode))
    for a, b in zip(tb.closest_points(pts), jb.closest_points(pts)):
        np.testing.assert_array_equal(a, b)
    o = np.tile(np.float32([[0.5, 0.5, -1.0]]), (1024, 1))
    d = rng.standard_normal((1024, 3)).astype(np.float32) * 0.2 + [0, 0, 1]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got, ref = tb.raytrace(o, d), jb.raytrace(o, d)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert 0.05 < (got[1] >= 0).mean() < 0.95
    np.testing.assert_array_equal(
        tb.sample_surface(2048, np.random.default_rng(3)),
        jb.sample_surface(2048, np.random.default_rng(3)))


@pytest.fixture(scope="module")
def pair(torus):
    """The JAX and the port's SdfTrainer on the torus, same seed, and the
    port's parameters carried into the JAX trainer (params and EMA)."""
    cfg = small_config()
    jtr = jsdf.SdfTrainer(torus, cfg, batch_size=BATCH)
    ttr = tsdf.SdfTrainer(torus, cfg, batch_size=BATCH, device="cpu")
    tree = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    tree["encoding"] = (np.random.default_rng(1).standard_normal(
        tree["encoding"].shape) * 0.1).astype(np.float32)
    with torch.no_grad():
        for k, val in bridge.encoded_params_from_numpy(tree,
                                                       ttr.model).items():
            ttr.params[k].copy_(val)
            ttr.opt_state.ema_params[k].copy_(val)
    # copies: the JAX step donates its parameter and state buffers
    jtr.params = jax.tree.map(jnp.array, tree)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array, tree))
    return cfg, jtr, ttr


def test_training_batches_match_jax_bit_for_bit(torus):
    cfg = small_config()
    jtr = jsdf.SdfTrainer(torus, cfg, seed=7, batch_size=BATCH)
    ttr = tsdf.SdfTrainer(torus, cfg, seed=7, batch_size=BATCH,
                          device="cpu")
    for _ in range(2):
        (tp, td), (jp, jd) = (ttr.generate_training_batch(),
                              jtr.generate_training_batch())
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(td, jd)
    assert tp.shape == (BATCH, 3) and (td == 0).mean() == 0.5
    assert len(ttr.batch_seconds) == 2


def test_pipelined_train_draws_as_jax(torus):
    """``train(n)`` runs exactly n steps and, like the JAX trainer, draws
    n + 1 batches (the next one is drawn while a step runs), so both rngs
    end in the same state."""
    cfg = small_config()
    jtr = jsdf.SdfTrainer(torus, cfg, seed=3, batch_size=BATCH)
    ttr = tsdf.SdfTrainer(torus, cfg, seed=3, batch_size=BATCH,
                          device="cpu")
    assert np.isfinite(ttr.train(2)) and np.isfinite(jtr.train(2))
    assert ttr.training_step == jtr.training_step == 2
    assert len(ttr.batch_seconds) == 3
    assert ttr.rng.bit_generator.state == jtr.rng.bit_generator.state


def test_step_distances_and_iou_match_jax(pair):
    cfg, jtr, ttr = pair
    pts = np.random.default_rng(5).random((4096, 3), dtype=np.float32)
    got, ref = ttr.distance_at(pts), jtr.distance_at(pts)
    err = np.abs(got - ref)
    assert (err <= TOL + TOL * np.abs(ref)).mean() >= MOSTLY
    assert err.max() <= BF16_TOL
    np.testing.assert_allclose(ttr.calculate_iou(1 << 14),
                               jtr.calculate_iou(1 << 14), atol=2e-3)
    # one step on the same batch
    pos, dist = ttr.generate_training_batch()
    t_loss = float(ttr.step(pos, dist))
    jtr.params, jtr.state, j_loss = jtr._train_step(
        jtr.params, jtr.state, jnp.asarray(pos), jnp.asarray(dist))
    # MAPE divides by |pred| + 0.01: a prediction next to 0 (the surface
    # samples) that a bf16 re-rounding moves by a bf16 ulp moves its term
    # by up to ~1, and the mean of 2^12 terms by ~1e-3 relative
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=2e-3)
    lr = ttr.opt_cfg.learning_rate
    t_now = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    t_ema = bridge.encoded_params_to_numpy(ttr.opt_state.ema_params,
                                           ttr.model)
    for got_tree, ref_tree in ((t_now, jtr.params),
                               (t_ema, jtr.state.ema_params)):
        for g, r in zip(jax.tree.leaves(got_tree),
                        jax.tree.leaves(jax.tree.map(np.asarray, ref_tree))):
            err = np.abs(g - r)
            # Adam's first step is ~lr·sign(g): see test_torch_image
            assert (err <= 1e-6).mean() >= MOSTLY
            assert err.max() <= 2 * lr + 1e-6


@pytest.fixture(scope="module")
def fitted(torus):
    """A port trainer fitted briefly (so the network is an SDF of the
    torus, not noise), its parameters carried into a JAX EncodedNetwork
    for the renders."""
    cfg = fit_config()
    ttr = tsdf.SdfTrainer(torus, cfg, batch_size=BATCH, device="cpu")
    ttr.train(150)
    assert ttr.calculate_iou(1 << 14) > 0.9
    jtr = jsdf.SdfTrainer(torus, cfg, batch_size=BATCH)
    tree = bridge.encoded_params_to_numpy(ttr.inference_params(), ttr.model)
    return ttr, jtr, tree


CAMERA = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.6]],
                  np.float32)


@pytest.mark.parametrize("analytic", [False, True])
def test_renderer_frames_match_jax(fitted, analytic):
    """32 × 24 frames of the same parameters: mean |Δ| ≤ 1e-3 and hit
    masks ≥ 99 % equal (a ray whose march ends next to the hit threshold
    may stop one step apart in the two)."""
    ttr, jtr, tree = fitted
    kw = dict(width=32, height=24, focal=24.0, analytic_normals=analytic,
              chunk=1024)
    got = TRenderer(ttr.model, TOptions(**kw)).render(
        ttr.inference_params(), CAMERA)
    ref = JRenderer(jtr.model, JOptions(**kw)).render(
        jax.tree.map(jnp.array, tree), CAMERA)
    assert got.shape == ref.shape == (24, 32, 4)
    hit = got[..., 3] > 0
    assert 0.1 < hit.mean() < 0.9
    assert (hit == (ref[..., 3] > 0)).mean() >= 0.99
    assert float(np.abs(got - ref).mean()) <= 1e-3


def test_analytic_normals_face_out_of_the_mesh(fitted):
    """The analytic normals (autograd through the encode, K3 on the card)
    at the traced hits point along the torus's outward normal there, and
    leave no gradient on the parameters."""
    ttr, _, _ = fitted
    r = TRenderer(ttr.model, TOptions(focal=24.0, analytic_normals=True))
    params = ttr.inference_params()
    o, d = (torch.from_numpy(a) for a in r.camera_rays(CAMERA, 32, 24))
    with torch.inference_mode():
        t, hit = r._trace(params, o, d)
        p = (o + t[:, None] * d)[hit]
    g = r._normals(params, p.clone())
    n = torch.nn.functional.normalize(g, dim=-1).numpy()
    # the torus's own outward normal, in the mesh's coordinates (the same
    # direction in the unit cube: the normalisation is a uniform scale)
    q = p.numpy() * ttr.mesh_scale + ttr.mesh_offset
    ring = q.copy()
    ring[:, 2] = 0.0
    ring *= 0.3 / np.linalg.norm(ring, axis=-1, keepdims=True)
    out = q - ring
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    assert hit.float().mean() > 0.1
    # most agree closely; hits at the silhouette and where the short fit
    # is rough do not
    cos = np.sum(n * out, -1)
    assert float(np.median(cos)) > 0.9 and float(np.mean(cos)) > 0.5
    assert all(v.grad is None for v in ttr.params.values())
