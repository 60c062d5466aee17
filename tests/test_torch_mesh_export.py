"""Parity of the port's mesh export with the JAX package's: marching cubes,
marching tetrahedra (welded as the JAX package welds where the two
differ), smoothing and normals bit for bit; the OBJ, PLY and
unwrapped-OBJ writers byte for byte; the density field, the RGBA grid and
the vertex colours from the same weights (rtol 1e-5 on 99.9 % of values:
the MLPs round each layer's input to bf16 in both, in other summation
orders); then the Testbed's four mesh methods at 32³ in NeRF and SDF mode
and the runner's --save_mesh, on the CPU."""
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.render import mesh_export as jme
from ngp_tpu_torch import bridge, run
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.common import TestbedMode
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.render import mesh_export as tme
from test_torch_sdf import private_jax_bvh, write_torus_obj
from test_torch_testbed import _port
from test_torch_testbed import scene  # noqa: F401  (a fixture)
from test_torch_testbed_modes import sdf_config

# the bf16 re-rounding between MLP layers (test_torch_encoded_network)
TOL, MOSTLY, BF16_TOL = 1e-5, 0.999, 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread(tmp_path_factory):
    private_jax_bvh(tmp_path_factory.mktemp("jax_bvh"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mostly_close(got, ref):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= TOL + TOL * np.abs(ref)).mean() >= MOSTLY, err.max()
    assert (err / np.maximum(np.abs(ref), 1.0)).max() <= BF16_TOL


def _jax_weld(v, f, spacing):
    """A mesh welded as the JAX package's marching tetrahedra welds its
    corners: by position rounded to 1e-4 of a voxel, the faces that
    collapse dropped. Returns (the first vertex of each rounded position,
    faces)."""
    key = np.round(v / (spacing * 1e-4)).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True,
                            return_inverse=True)
    f = inv.reshape(-1)[f]
    good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return v[idx], f[good].astype(np.int32)


def _edges_not_in_two_faces(v, f) -> int:
    """The mesh's edges in other than two faces, but for those with both
    ends on the unit lattice's sides, where a surface leaving it is open."""
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                1)
    edges, counts = np.unique(e, axis=0, return_counts=True)
    bad = edges[counts != 2]
    on_side = ((v <= 1e-6) | (v >= 1 - 1e-6)).any(-1)
    return int((~(on_side[bad[:, 0]] & on_side[bad[:, 1]])).sum())


def _assert_tetrahedra_match_jax(v, f, jv, jf, spacing):
    """The port's tetrahedra mesh, welded by lattice edge, against the JAX
    package's: welded again as JAX welds, its faces are JAX's and its
    vertices within the weld's 1e-4 of a voxel of JAX's (a merged pair
    keeps the first cut point in another order)."""
    wv, wf = _jax_weld(v, f, spacing)
    np.testing.assert_array_equal(wf, jf)
    np.testing.assert_allclose(wv, jv, rtol=0, atol=spacing * 1e-4)


def _field(shape=(20, 22, 24), seed=0) -> np.ndarray:
    """Two overlapping balls' signed distance plus seeded noise."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                             indexing="ij"), -1)
    d = np.minimum(np.linalg.norm(g - [0.4, 0.5, 0.5], axis=-1) - 0.25,
                   np.linalg.norm(g - [0.65, 0.5, 0.55], axis=-1) - 0.2)
    return (d + rng.normal(0, 0.01, shape)).astype(np.float32)


@pytest.mark.parametrize("extract", ["marching_cubes", "marching_tetrahedra"])
def test_extraction_smoothing_and_normals_match_jax(extract):
    field = _field()
    v, f = getattr(tme, extract)(field, 0.0, origin=(0.1, 0.2, 0.3))
    jv, jf = getattr(jme, extract)(field, 0.0, origin=(0.1, 0.2, 0.3))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert len(f) > 500
    np.testing.assert_array_equal(tme.smooth_mesh(v, f, 2, 0.4),
                                  jme.smooth_mesh(jv, jf, 2, 0.4))
    np.testing.assert_array_equal(tme.vertex_normals(v, f),
                                  jme.vertex_normals(jv, jf))
    # a mesh-optimisation step on an analytic density and its gradient
    def dens(x):
        r = np.linalg.norm(x - 0.5, axis=-1, keepdims=True)
        return (np.exp(-r[:, 0]) * 4).astype(np.float32), \
            (-(x - 0.5) / np.maximum(r, 1e-9)).astype(np.float32)
    np.testing.assert_array_equal(tme.mesh_optimization_step(dens, v, f),
                                  jme.mesh_optimization_step(dens, v, f))


def test_marching_tetrahedra_welds_by_lattice_edge():
    """Nodes whose values lie within a hair of the threshold put cut
    points of several lattice edges within the JAX weld's 1e-4 of a voxel
    of one another: JAX merges them and the faces it drops leave edges in
    one face or three. The port welds by lattice edge: its mesh is closed,
    and welded again as JAX welds it is JAX's mesh."""
    rng = np.random.default_rng(5)
    res = 24
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"),
                 -1)
    d = np.linalg.norm(g - 0.5, axis=-1) - 0.3
    pick = (np.abs(d) < 0.05) & (rng.random(d.shape) < 0.3)
    d[pick] = rng.choice([-1, 1], pick.sum()) * 10 ** rng.uniform(
        -9, -4, pick.sum())
    field = d.astype(np.float32)
    v, f = tme.marching_tetrahedra(field, 0.0)
    jv, jf = jme.marching_tetrahedra(field, 0.0)
    assert len(v) > len(jv) and _edges_not_in_two_faces(jv, jf) > 0
    assert _edges_not_in_two_faces(v, f) == 0
    _assert_tetrahedra_match_jax(v, f, jv, jf, 1.0 / (res - 1))


def test_writers_match_jax_bytes(tmp_path):
    v, f = tme.marching_cubes(_field(seed=1), 0.0)
    n = tme.vertex_normals(v, f)
    c = np.random.default_rng(2).random((len(v), 3)).astype(np.float32)
    for name, write in (
            ("plain.obj", lambda m, p: m.save_obj(p, v, f)),
            ("normals.obj", lambda m, p: m.save_obj(p, v, f, n)),
            ("plain.ply", lambda m, p: m.save_ply(p, v, f)),
            ("colours.ply", lambda m, p: m.save_ply(p, v, f, c)),
            ("unwrapped.obj", lambda m, p: m.save_obj_unwrapped(p, v, f, c,
                                                                n))):
        (tmp_path / "t").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        write(tme, tmp_path / "t" / name)
        write(jme, tmp_path / "j" / name)
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert (tmp_path / "t" / "unwrapped.obj.tga").read_bytes() == \
        (tmp_path / "j" / "unwrapped.obj.tga").read_bytes()


@pytest.fixture(scope="module")
def nets():
    """JAX and port NeRF networks (aabb_scale 2) with the same seeded
    parameters: a unit-variance table and a boosted density output."""
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    for k in ("network", "rgb_network"):
        cfg[k]["n_neurons"] = 16
    jm = JNerfNetwork(dict(cfg, encoding=autofill_hashgrid_config(
        cfg["encoding"], 3, 2048.0, aabb_scale=2)))
    tree = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    tree["pos_encoding"] = np.random.default_rng(0).standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 4.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    tm = TNerfNetwork(cfg, aabb_scale=2, device="cpu")
    return jm, tree, tm, bridge.nerf_params_from_numpy(tree, tm)


def test_device_fields_match_jax(nets):
    """σ on a 16³ lattice of the AABB [-0.5, 1.5]³, the RGBA grid in
    both alpha modes, and vertex colours."""
    jm, tree, tm, params = nets
    amin, asize = -0.5, 2.0
    got = tme.density_field_on_grid(
        lambda p: _sigma(tm, params, (p - amin) / asize), 16, amin, asize)
    ref = jme.density_field_on_grid(
        lambda p: jm.density(tree, (p - amin) / asize), 16, amin, asize)
    assert got.shape == ref.shape == (16, 16, 16)
    _mostly_close(got, ref)
    assert (ref > 2.5).mean() > 0.05 and (ref < 2.5).mean() > 0.05
    for alpha in (False, True):
        got = tme.rgba_on_grid(tm, params, 12, ray_dir=(0.3, -0.2, 1.0),
                               density_as_alpha=alpha)
        ref = jme.rgba_on_grid(jm, tree, 12, ray_dir=(0.3, -0.2, 1.0),
                               density_as_alpha=alpha)
        assert got.shape == ref.shape == (12, 12, 12, 4)
        _mostly_close(got, ref)
    verts = np.random.default_rng(3).random((500, 3)).astype(np.float32) \
        * asize + amin
    got = tme.vertex_colors(tm, params, verts, amin, asize)
    ref = jme.vertex_colors(jm, tree, verts, amin, asize)
    assert got.shape == (500, 3)
    _mostly_close(got, ref)


def _sigma(tm, params, pos01):
    raw = functional_call(tm, params, (pos01,))[..., 0]
    return torch.exp(torch.clamp(raw, -15.0, 15.0))


@pytest.fixture(scope="module")
def nerf_testbed(scene):  # noqa: F811
    """The port's NeRF Testbed on test_torch_testbed's scene, trained 32
    CPU steps."""
    tb = _port(scene)
    tb.train(32)
    return tb


def test_nerf_testbed_mesh_methods(nerf_testbed, tmp_path):
    """The four methods on a 32-step fit, at 32³; the σ threshold is the
    median of the occupied cells' σ (a 32-step fit has no σ of 2.5)."""
    tb = nerf_testbed
    field = tb._mesh_field(32)
    thresh = float(np.median(field[field > 0]))
    m = tb.compute_marching_cubes_mesh(32, thresh)
    assert set(m) == {"V", "N", "C", "F"} and m["V"].shape[1] == 3
    assert len(m["F"]) > 0 and m["C"].shape == m["V"].shape
    assert m["C"].min() >= 0.0 and m["C"].max() <= 1.0
    # unit normals, but 0 at a vertex whose faces all have zero area
    norm = np.linalg.norm(m["N"], axis=-1)
    assert bool((np.isclose(norm, 1.0, atol=1e-5) | (norm == 0)).all())
    tb.compute_and_save_marching_cubes_mesh(tmp_path / "m.ply", 32, thresh)
    tb.compute_and_save_marching_cubes_mesh(str(tmp_path / "m.obj"), 32,
                                            thresh)
    tb.compute_and_save_marching_cubes_mesh(str(tmp_path / "u.obj"), 32,
                                            thresh, unwrap_it=True)
    ply = (tmp_path / "m.ply").read_bytes()
    assert f"element vertex {len(m['V'])}".encode() in ply
    assert b"property uchar red" in ply
    assert (tmp_path / "u.obj.tga").exists()
    assert (tmp_path / "m.obj").read_text().count("\nf ") == len(m["F"])
    tb.compute_and_save_png_slices(str(tmp_path / "s"), 32)
    assert len(list(tmp_path.glob("s_*.png"))) == 32
    rgba = tb.get_rgba_on_grid(16)
    assert rgba.shape == (16, 16, 16, 4) and np.isfinite(rgba).all()


def test_nerf_mesh_takes_sigma_in_occupied_cells_only(nerf_testbed):
    """The intended divergence: the mesh's field is σ where the occupancy
    bitfield holds the cell and 0 elsewhere (the reference's
    get_density_on_grid); JAX's ``density_at`` meshes σ everywhere, which
    ``density_at`` here still gives."""
    tr = nerf_testbed.trainer
    pts = tme.grid_positions(24, float(tr.aabb_min), float(tr.aabb_size))
    field = nerf_testbed._mesh_field(24).reshape(-1)
    everywhere = tr.density_at(pts.numpy())
    held = occ.occupied_at(tr.grid.bitfield, pts,
                           occ.mip_from_pos(pts, tr.max_cascade)).numpy()
    assert 0.0 < held.mean() < 1.0
    np.testing.assert_array_equal(field, np.where(held, everywhere, 0.0))


@pytest.fixture(scope="module")
def sdf_testbed(tmp_path_factory):
    """The port's SDF Testbed on a torus, trained 20 CPU steps, and its
    snapshot."""
    root = tmp_path_factory.mktemp("sdf_mesh")
    (root / "sdf.json").write_text(json.dumps(sdf_config()))
    obj = write_torus_obj(root / "torus.obj")
    tb = Testbed(TestbedMode.SDF, device="cpu")
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_file(root / "sdf.json")
    tb.load_training_data(obj)
    tb.train(20)
    tb.save_snapshot(str(root / "sdf.msgpack"))
    return tb, root


def test_sdf_testbed_mesh_methods(sdf_testbed, tmp_path):
    """SDF mode: marching tetrahedra at distance 0 of ``distance_at`` on
    the unit cube's voxel centres (the JAX testbed's mesh of the same
    field), coloured by |normal|."""
    tb, _ = sdf_testbed
    m = tb.compute_marching_cubes_mesh(32)
    lin = (np.arange(32, dtype=np.float32) + 0.5) / 32
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                   -1).reshape(-1, 3)
    v, f = jme.marching_tetrahedra(
        tb.trainer.distance_at(pts).reshape(32, 32, 32), 0.0)
    _assert_tetrahedra_match_jax(m["V"], m["F"], v, f, 1.0 / 31)
    # every edge inside the lattice lies in two faces
    assert _edges_not_in_two_faces(m["V"], m["F"]) == 0
    np.testing.assert_array_equal(m["C"], np.abs(m["N"]))
    tb.compute_and_save_marching_cubes_mesh(str(tmp_path / "t.obj"), 32)
    assert (tmp_path / "t.obj").read_text().count("\nf ") == len(f)


def test_runner_saves_a_mesh(sdf_testbed, tmp_path, capsys):
    """``--save_mesh`` from an SDF snapshot: the Testbed's mesh, as a PLY
    without colours and an OBJ with normals."""
    tb, root = sdf_testbed
    argv = ["--mode", "sdf", "--scene", str(root / "torus.obj"),
            "--network", str(root / "sdf.json"), "--load_snapshot",
            str(root / "sdf.msgpack"), "--device", "cpu",
            "--marching_cubes_res", "32"]
    m = tb.compute_marching_cubes_mesh(32)
    for name in ("r.ply", "r.obj"):
        assert run.main(argv + ["--save_mesh", str(tmp_path / name)]) == 0
        out = capsys.readouterr().out
        assert re.search(rf"^saved mesh \({len(m['V'])} verts, "
                         rf"{len(m['F'])} faces\) to ", out, re.M)
    (tmp_path / "j").mkdir()
    jme.save_ply(tmp_path / "j" / "r.ply", m["V"], m["F"])
    jme.save_obj(tmp_path / "j" / "r.obj", m["V"], m["F"], m["N"])
    for name in ("r.ply", "r.obj"):
        assert Path(tmp_path / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("extract", ["cubes", "tetrahedra"])
def test_mesh_vertices_sit_on_the_unit_lattice_not_the_sample_points(
        extract):
    """A fault of the JAX package that the port keeps for bit parity: the
    field is sampled at voxel centres (i + 0.5) / res, but the extraction
    puts lattice node i at i / (res − 1), so a mesh is stretched by
    res / (res − 1) about the cube's centre, up to half a voxel at the
    sides. The plane x = c of a field sampled as the Testbed samples it
    comes out at x = (c·res − 0.5) / (res − 1) in both packages (to 1e-6);
    the ideal mesh would sit at c."""
    res, c = 16, 0.2
    field = tme.density_field_on_grid(lambda p: p[:, 0] - c, res)
    fn = {"cubes": "marching_cubes", "tetrahedra": "marching_tetrahedra"}
    v, f = getattr(tme, fn[extract])(field, 0.0)
    jv, jf = getattr(jme, fn[extract])(field, 0.0)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    stretched = (c * res - 0.5) / (res - 1)
    np.testing.assert_allclose(v[:, 0], stretched, atol=1e-6)
    assert abs(stretched - c) > 0.25 / res
