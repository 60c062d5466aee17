"""The tcnn-layout hash grid and the reference-snapshot codec of the port
against the JAX package's (``ngp_tpu/kernels/hashgrid.py``,
``ngp_tpu/io/snapshot.py``), on the same seeded inputs.

Tolerances: layouts and imported parameters exact; the encode 1e-6 (the
same f32 gather and lerp; the corner sum may associate differently); its
gradients 1e-5 relative to the largest entry; a network's output 1e-5
(bf16-rounded MLP operands, f32 products). Intended divergence: the port
reads ``params_type`` (fp16 or f32; anything else raises); the JAX
package decodes every buffer as fp16."""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.io import snapshot as jsnap
from ngp_tpu.kernels import hashgrid as jhg
from ngp_tpu.nn import encodings as jenc
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu_torch import bridge
from ngp_tpu_torch.io import snapshot as tsnap
from ngp_tpu_torch.kernels import hashgrid as thg
from ngp_tpu_torch.nn import encodings as tenc
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork

ENCODINGS = {
    # 3D: dense coarse levels and hashed fine ones
    "3d-hashed": dict(n_pos_dims=3, n_levels=6, log2_hashmap_size=12,
                      base_resolution=4, per_level_scale=2.0),
    # b = 1.5: level 3's scale is an exact integer only in f32 (ABI rule 6)
    "3d-b1.5": dict(n_pos_dims=3, n_levels=8, log2_hashmap_size=14,
                    base_resolution=16, per_level_scale=1.5),
    "3d-smoothstep": dict(n_pos_dims=3, n_levels=5, log2_hashmap_size=11,
                          base_resolution=3, per_level_scale=1.7,
                          interpolation="Smoothstep"),
    "2d": dict(n_pos_dims=2, n_levels=5, log2_hashmap_size=10,
               base_resolution=8, per_level_scale=1.8),
    "3d-dense": dict(n_pos_dims=3, n_levels=3, log2_hashmap_size=40,
                     base_resolution=4, per_level_scale=1.5),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metas(name):
    return (thg.HashGridMeta.from_config(ENCODINGS[name]),
            jhg.HashGridMeta.from_config(ENCODINGS[name]))


def _base_config():
    return load_network_config("configs/nerf/base.json")


@pytest.mark.parametrize("name", list(ENCODINGS))
def test_layout_matches_jax(name):
    tm, jm = _metas(name)
    for f in ("level_scales", "level_resolutions", "level_params",
              "level_is_dense", "level_offsets", "n_params", "n_output_dims"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert any(tm.level_is_dense)
    assert all(tm.level_is_dense) == (name == "3d-dense")


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_base_config_layout_matches_jax(aabb_scale):
    enc = autofill_hashgrid_config(_base_config()["encoding"], 3, 2048.0,
                                   aabb_scale=aabb_scale)
    tm = thg.HashGridMeta.from_config(enc)
    jm = jhg.HashGridMeta.from_config(enc)
    assert (tm.level_params, tm.level_offsets, tm.level_scales) == \
        (jm.level_params, jm.level_offsets, jm.level_scales)
    assert tm.n_params == jm.n_params


def _inputs(meta, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(meta.n_params * meta.n_features_per_level
                                ).astype(np.float32)
    pos = rng.random((n, meta.n_dims), dtype=np.float32)
    # lattice vertices of the finest level and the cube's corners
    pos[:8] = np.round(pos[:8] * meta.level_scales[-1]) \
        / np.float32(meta.level_scales[-1])
    pos[8], pos[9] = 0.0, 1.0
    return table, pos


@pytest.mark.parametrize("name", list(ENCODINGS))
def test_encode_matches_jax(name):
    tm, jm = _metas(name)
    table, pos = _inputs(tm)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table),
                                         jnp.asarray(pos), jm))
    got = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(pos),
                              tm).numpy()
    assert got.shape == ref.shape == (len(pos), tm.n_output_dims)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["3d-hashed", "3d-smoothstep"])
def test_encode_gradients_match_jax(name):
    """Autograd's table and position gradients against the JAX
    custom_vjp's scatter-add and closed-form position gradient."""
    tm, jm = _metas(name)
    table, pos = _inputs(tm, n=500, seed=1)
    pos[:10] = np.clip(pos[:10], 0.01, 0.99)    # no clamped corners
    g = np.random.default_rng(2).standard_normal(
        (len(pos), tm.n_output_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, p: jhg.hashgrid_encode(t, p, jm),
                     jnp.asarray(table), jnp.asarray(pos))
    j_dt, j_dp = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    t = torch.from_numpy(table).requires_grad_()
    p = torch.from_numpy(pos).requires_grad_()
    thg.hashgrid_encode(t, p, tm).backward(torch.from_numpy(g))
    for got, ref in ((t.grad.numpy(), j_dt), (p.grad.numpy(), j_dp)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_max_level_matches_jax():
    tm, jm = _metas("3d-hashed")
    table, pos = _inputs(tm, n=200)
    ml = np.random.default_rng(3).random(len(pos), dtype=np.float32)
    for level in (0.5, ml):
        ref = np.asarray(jhg.hashgrid_encode_with_max_level(
            jnp.asarray(table), jnp.asarray(pos), jm, jnp.asarray(level)))
        got = thg.hashgrid_encode_with_max_level(
            torch.from_numpy(table), torch.from_numpy(pos), tm,
            torch.as_tensor(level)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("otype", ["HashGrid", "DenseGrid"])
def test_create_encoding_tcnn_matches_jax(otype, monkeypatch):
    cfg = dict(otype=otype, n_levels=3, log2_hashmap_size=12,
               base_resolution=4, per_level_scale=1.5)
    monkeypatch.setenv("NGP_TPU_GRID_IMPL", "tcnn")
    j = jenc.create_encoding(3, cfg)
    t = tenc.create_encoding(3, cfg, grid_impl="tcnn")
    assert isinstance(t, tenc.GridEncoding)
    assert t.meta.level_params == j.meta.level_params
    table, pos = _inputs(t.meta, n=300)
    with torch.no_grad():
        t.table.copy_(torch.from_numpy(table))
    ref = np.asarray(j.apply(jnp.asarray(table), jnp.asarray(pos)))
    np.testing.assert_allclose(t(torch.from_numpy(pos)).detach().numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    # the blocked grid stays the default for a HashGrid
    assert isinstance(tenc.create_encoding(3, cfg), (
        tenc.GridEncoding if otype == "DenseGrid"
        else tenc.BlockedGridEncoding))
    with pytest.raises(ValueError, match="grid_impl"):
        tenc.create_encoding(3, cfg, grid_impl="pallas")


def _tcnn_pair(monkeypatch, aabb_scale=1, n_levels=4):
    """A tcnn-layout JAX NerfNetwork (NGP_TPU_GRID_IMPL=tcnn) with seeded
    parameters and a unit-variance table, and the port's counterpart."""
    cfg = _base_config()
    cfg["encoding"]["n_levels"] = n_levels
    cfg["encoding"]["log2_hashmap_size"] = 12
    jcfg = dict(cfg)
    jcfg["encoding"] = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                                aabb_scale=aabb_scale)
    monkeypatch.setenv("NGP_TPU_GRID_IMPL", "tcnn")
    jm = JNerfNetwork(jcfg)
    monkeypatch.delenv("NGP_TPU_GRID_IMPL")
    tree = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    tree["pos_encoding"] = np.random.default_rng(0).standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    tm = TNerfNetwork(cfg, aabb_scale=aabb_scale, grid_impl="tcnn")
    return cfg, jm, tree, tm


def test_tcnn_network_shapes_bridge_and_output_match_jax(monkeypatch):
    cfg, jm, tree, tm = _tcnn_pair(monkeypatch)
    own = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert own["pos_encoding.table"] == tree["pos_encoding"].shape
    assert [own[f"density_net.weights.{i}"] for i in range(2)] == \
        [w.shape for w in tree["density_net"]]
    params = bridge.nerf_params_from_numpy(tree, tm)
    back = bridge.nerf_params_to_numpy(params, tm)
    assert back["dir_encoding"] == tree["dir_encoding"]
    for k in ("density_net", "rgb_net"):
        for a, b in zip(back[k], tree[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["pos_encoding"], tree["pos_encoding"])
    rng = np.random.default_rng(4)
    pos = rng.random((400, 3), dtype=np.float32)
    dirs = rng.random((400, 3), dtype=np.float32)
    j_rgb, j_d = jm.apply(tree, jnp.asarray(pos), jnp.asarray(dirs))
    with torch.no_grad():
        t_rgb, t_d = torch.func.functional_call(
            tm, params, (torch.from_numpy(pos), torch.from_numpy(dirs)))
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-5)


def _assert_trees_equal(a, b):
    np.testing.assert_array_equal(a["pos_encoding"], b["pos_encoding"])
    for k in ("density_net", "rgb_net"):
        assert len(a[k]) == len(b[k])
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)
    assert a["dir_encoding"] == b["dir_encoding"]


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_reference_snapshot_import_matches_jax(tmp_path, monkeypatch,
                                               aabb_scale):
    """The JAX exporter's snapshot read by both importers: the same
    parameters, exactly; then the port's export read by the JAX
    importer, and by the port's own."""
    cfg, _, tree, _ = _tcnn_pair(monkeypatch, aabb_scale)
    dens = np.random.default_rng(5).random(128 ** 3).astype(np.float32)
    path = tmp_path / "ref.msgpack"
    jsnap.export_reference_snapshot(path, cfg, tree, aabb_scale=aabb_scale,
                                    density_grid=dens)
    j_cfg, j_tree, _ = jsnap.import_reference_snapshot(path)
    t_cfg, t_tree, snap = tsnap.import_reference_snapshot(path)
    assert t_cfg == j_cfg and snap["params_type"] == "__half"
    _assert_trees_equal(t_tree, jax.tree.map(np.asarray, j_tree))
    path2 = tmp_path / "port.msgpack"
    tsnap.export_reference_snapshot(path2, t_cfg, t_tree,
                                    aabb_scale=aabb_scale,
                                    density_grid=dens)
    assert path2.read_bytes() == path.read_bytes()
    _assert_trees_equal(tsnap.import_reference_snapshot(path2)[1], t_tree)
    _assert_trees_equal(jax.tree.map(np.asarray,
                                     jsnap.import_reference_snapshot(path2)[1]),
                        t_tree)


def _retyped(path, tmp_path, ptype, dtype):
    """The snapshot at ``path`` with its buffer re-encoded as ``dtype``
    under ``params_type`` ``ptype`` (None: no key)."""
    doc = msgpack.unpackb(path.read_bytes(), raw=False, strict_map_key=False)
    snap = doc["snapshot"]
    flat = np.frombuffer(snap["params_binary"], np.float16)
    snap["params_binary"] = flat.astype(dtype).tobytes()
    snap.pop("params_type")
    if ptype is not None:
        snap["params_type"] = ptype
    out = tmp_path / f"{ptype}.msgpack"
    out.write_bytes(msgpack.packb(doc, use_bin_type=True))
    return out


def test_params_type_is_read(tmp_path, monkeypatch):
    """Intended divergence: an f32 ("float") buffer loads to the same
    parameters as its fp16 original, and no type means fp16; an unknown
    type raises, naming it."""
    cfg, _, tree, _ = _tcnn_pair(monkeypatch)
    path = tmp_path / "ref.msgpack"
    tsnap.export_reference_snapshot(path, cfg, tree)
    want = tsnap.import_reference_snapshot(path)[1]
    for ptype, dtype in (("float", np.float32), (None, np.float16)):
        got = tsnap.import_reference_snapshot(
            _retyped(path, tmp_path, ptype, dtype))[1]
        _assert_trees_equal(got, want)
    with pytest.raises(ValueError, match="bfloat"):
        tsnap.import_reference_snapshot(
            _retyped(path, tmp_path, "bfloat", np.float16))
    # a buffer too short for the network is refused
    doc = msgpack.unpackb(path.read_bytes(), raw=False, strict_map_key=False)
    doc["snapshot"]["params_binary"] = doc["snapshot"]["params_binary"][:64]
    short = tmp_path / "short.msgpack"
    short.write_bytes(msgpack.packb(doc, use_bin_type=True))
    with pytest.raises(ValueError, match="needs"):
        tsnap.import_reference_snapshot(short)
