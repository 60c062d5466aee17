"""The multi-NeRF render engine of the port against the JAX package's
(``ngp_tpu/render/multi_nerf.py``): masks, camera models, fields and
whole ``RenderRequest`` frames, on one tiny scene (4 levels,
log2_hashmap_size 12, aabb_scale 1, a unit-variance table and a boosted
density output, an analytic occupancy grid) saved once by the JAX
package's ``save_snapshot``. Every JAX frame is rendered in one module
fixture (three compiled chunk functions).

Tolerances: masks and rays 1e-6; a field's network output 1e-5 for all
but 0.5 % of the values (where the two frameworks' f32 sums differ in the
last bit next to a bf16 rounding boundary of the MLP's activations, one
activation moves by a bf16 ulp; all within 5e-2, as in
``test_torch_nerf_network``); frames mean |Δ| ≤ 2e-4 (the render bound of
the slice tests), the max printed. Intended divergence: the
port's composite is sRGB, the network's colour space, so its
``color_space="srgb"`` frame is held against the JAX ``"linear"`` frame
(which returns the composite unchanged)."""
import os

import jax
import numpy as np
import pytest
import torch

from ngp_tpu.common import TonemapCurve as JTonemapCurve
from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.io.snapshot import save_snapshot
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.render import multi_nerf as jmn
from ngp_tpu_torch.common import TonemapCurve, srgb_to_linear
from ngp_tpu_torch.io import snapshot as tsnap
from ngp_tpu_torch.nn.encodings import BlockedGridEncoding, GridEncoding
from ngp_tpu_torch.render import multi_nerf as tmn

W, H, FOCAL = 32, 24, 28.0
FORK_W, FORK_H = 24, 16
FORK_CAMERAS = ("spherical_quadrilateral", "quadrilateral_hexahedron")
RENDER_TOL = 2e-4
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(angle=0.5, radius=1.0, target=(0.55, 0.5, 0.5)):
    """4×4 NGP camera→world (x right, y down, z forward) at ``target``."""
    fwd = np.array([np.cos(angle), np.sin(angle), 0.25])
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    m = np.eye(4, dtype=np.float32)
    m[:3] = np.stack([right, np.cross(fwd, right), fwd,
                      np.asarray(target) - radius * fwd], axis=1)
    return m


def _placement():
    """The second proxy: the field scaled 0.5, turned 30° about z and moved
    so that its ball overlaps the front of the first's (seen from
    ``_camera()``)."""
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = 0.5 * np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[:3, 3] = (0.2, 0.05, 0.2)
    return m


def _masks(mod):
    """A descriptor-level add sphere and a request-level subtract box, in
    package ``mod``."""
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = (0.45, 0.5, 0.5)
    sphere = mod.Mask3D(shape="sphere", mode="add", transform=xf, radius=0.4,
                        feather=0.05)
    box_xf = np.eye(4, dtype=np.float32)
    box_xf[:3, 3] = (0.5, 0.3, 0.6)
    box = mod.Mask3D(shape="box", mode="subtract", transform=box_xf,
                     dims=np.array([0.3, 0.4, 0.5], np.float32), feather=0.02,
                     opacity=0.8)
    return [sphere], [box]


def _requests(mod, path, linear_name):
    """Name → RenderRequest in package ``mod``; ``linear_name`` is the
    colour space that returns the composite (JAX "linear", port "srgb")."""
    def out(**kw):
        return mod.RenderOutputProperties(width=W, height=H,
                                          color_space=linear_name,
                                          background_color=(0.1, 0.2, 0.3,
                                                            0.0), **kw)
    cam = mod.RenderCameraProperties(transform=_camera(), focal_length=FOCAL)
    one = [mod.NerfDescriptor(snapshot_path=path)]
    sphere, box = _masks(mod)
    two = [mod.NerfDescriptor(snapshot_path=path, masks=sphere, opacity=0.7),
           mod.NerfDescriptor(snapshot_path=path, transform=_placement())]
    dof = mod.RenderCameraProperties(transform=_camera(), focal_length=FOCAL,
                                     aperture_size=0.03, focus_z=0.9)
    curve = (JTonemapCurve if mod is jmn else TonemapCurve).ACES
    # the fork's two other camera models, at a smaller frame
    fork = {kind: mod.RenderRequest(
        mod.RenderOutputProperties(width=FORK_W, height=FORK_H,
                                   color_space=linear_name,
                                   background_color=(0.1, 0.2, 0.3, 0.0)),
        mod.RenderCameraProperties(transform=_camera(),
                                   **_camera_kinds()[kind]), one)
        for kind in FORK_CAMERAS}
    return {**fork,
        "one": mod.RenderRequest(out(), cam, one),
        "spp2-dof": mod.RenderRequest(out(spp=2), dof, one),
        "aces-exposure": mod.RenderRequest(
            out(tonemap_curve=curve, exposure=0.5), cam, one),
        "two": mod.RenderRequest(out(), cam, two, modifiers=box),
    }


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The snapshot on disk and every JAX frame."""
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    jcfg = dict(cfg)
    jcfg["encoding"] = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                                aabb_scale=1)
    jm = JNerfNetwork(jcfg)
    tree = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree["pos_encoding"] = rng.standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 8.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    # occupied: a ball of radius 0.4 about the centre
    g = (np.arange(128) + 0.5) / 128
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    dens = np.where((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.16,
                    1.0, 0.0).astype(np.float32).reshape(-1)
    path = str(tmp_path_factory.mktemp("multi_nerf") / "scene.msgpack")
    save_snapshot(path, cfg, tree, tree, density_grid=dens, max_cascade=0,
                  aabb_scale=1, aabb_min=np.zeros(3), aabb_max=np.ones(3))
    near = jmn.MultiNerfRenderer(chunk=512)
    summ = jmn.MultiNerfRenderer(chunk=512, composite_mode="sum")
    summ.fields = near.fields
    reqs = _requests(jmn, path, "linear")
    ref = {name: near.render(req) for name, req in reqs.items()}
    ref["two-sum"] = summ.render(reqs["two"])
    return dict(cfg=cfg, tree=tree, path=path, ref=ref, jfield=near._field(
        path))


def _network_close(got, ref):
    """1e-5 for ≥ 99.5 % of the outputs, 5e-2 for all (module docstring)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert (err <= 1e-5).mean() >= 0.995, err.max()
    assert err.max() <= 5e-2


def _renderer(**kw):
    return tmn.MultiNerfRenderer(chunk=512, device="cpu", **kw)


def _assert_close(got, ref, tol=RENDER_TOL):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    print(f"mean |Δ| {err.mean():.3e}, max {err.max():.3e}; mean alpha "
          f"{ref[..., 3].mean():.3f}")
    assert err.mean() <= tol


# --------------------------------------------------------------------------
# masks and rays
# --------------------------------------------------------------------------

def _mask_pairs():
    xf = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    xf[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    xf[:3, :3] *= 1.3
    xf[:3, 3] = (0.5, 0.45, 0.55)
    out = []
    for shape in tmn.MASK_SHAPES:
        for mode in ("add", "subtract"):
            kw = dict(shape=shape, mode=mode, transform=xf,
                      dims=np.array([0.4, 0.3, 0.6], np.float32), radius=0.3,
                      height=0.5, feather=0.07, opacity=0.9)
            out.append((jmn.Mask3D(**kw), tmn.Mask3D(**kw)))
    return out


def _points(n=2000, seed=0):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32) \
        * 1.4 - 0.2


def test_mask_samples_match_jax():
    p = _points()
    for jm, tm in _mask_pairs():
        ref = np.asarray(jm.sample(p))
        got = tm.sample(torch.from_numpy(p)).numpy()
        assert (ref != 0).any(), (tm.shape, tm.mode)
        np.testing.assert_allclose(got, ref, atol=TOL,
                                   err_msg=f"{tm.shape} {tm.mode}")


def test_apply_masks_matches_jax():
    p = _points(seed=1)
    pairs = _mask_pairs()
    lists = [[], pairs[0:3], pairs[3:8], [pairs[1], pairs[4], pairs[6]],
             [(jmn.Mask3D.All("subtract"), tmn.Mask3D.All("subtract"))]]
    for lst in lists:
        ref = np.asarray(jmn.apply_masks([a for a, _ in lst], p))
        got = tmn.apply_masks([b for _, b in lst], torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    # the complement "All" in subtract mode masks everything out
    assert tmn.apply_masks([tmn.Mask3D.All("subtract")],
                           torch.from_numpy(p)).max() == 0.0
    with pytest.raises(ValueError, match="mask shape"):
        tmn.Mask3D(shape="cone").sample(torch.from_numpy(p))


def _camera_kinds():
    corners = np.array([[-0.3, -0.2, 0.0], [0.3, -0.2, 0.0],
                        [-0.3, 0.2, 0.0], [0.3, 0.2, 0.0],
                        [-0.5, -0.4, 1.0], [0.5, -0.4, 1.0],
                        [-0.5, 0.4, 1.0], [0.5, 0.4, 1.0]], np.float32)
    return {
        "perspective": dict(focal_length=FOCAL),
        "spherical_quadrilateral": dict(model="spherical_quadrilateral",
                                        sq_width=1.2, sq_height=0.8,
                                        sq_curvature=0.6),
        "quadrilateral_hexahedron": dict(model="quadrilateral_hexahedron",
                                         qh_corners=corners),
        "perspective-dof": dict(focal_length=FOCAL, aperture_size=0.05,
                                focus_z=1.3),
    }


@pytest.mark.parametrize("kind", list(_camera_kinds()))
def test_generate_global_rays_matches_jax(kind):
    kw = _camera_kinds()[kind]
    xf = _camera(1.1)
    seeded = kind.endswith("dof")
    j_o, j_d = jmn.generate_global_rays(
        jmn.RenderCameraProperties(transform=xf, **kw), W, H,
        np.random.default_rng(3) if seeded else None)
    t_o, t_d = tmn.generate_global_rays(
        tmn.RenderCameraProperties(transform=xf, **kw), W, H,
        np.random.default_rng(3) if seeded else None)
    for got, ref in ((t_o, j_o), (t_d, j_d)):
        assert got.dtype == torch.float32 and got.shape == (W * H, 3)
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    with pytest.raises(ValueError, match="camera model"):
        tmn.generate_global_rays(tmn.RenderCameraProperties(model="fisheye"),
                                 W, H)


# --------------------------------------------------------------------------
# fields
# --------------------------------------------------------------------------

def test_field_matches_jax(scene):
    f = tmn.NeuralRadianceField(scene["path"], device="cpu")
    jf = scene["jfield"]
    np.testing.assert_array_equal(f.bitfield.numpy(), np.asarray(jf.bitfield))
    assert (f.aabb_min, f.aabb_size, f.cone_angle, f.max_cascade) == (
        float(jf.aabb_min), float(jf.aabb_size), jf.cone_angle,
        jf.max_cascade)
    assert isinstance(f.model.pos_encoding, BlockedGridEncoding)
    rng = np.random.default_rng(6)
    pos, dirs = (rng.random((300, 3), dtype=np.float32) for _ in range(2))
    j_rgb, j_d = jf.model.apply(jf.params, pos, dirs)
    t_rgb, t_d = f.model(torch.from_numpy(pos), torch.from_numpy(dirs))
    _network_close(t_rgb.numpy(), j_rgb)
    _network_close(t_d.numpy(), j_d)


def _reference_snapshot(scene, tmp_path):
    """A reference (params_binary) snapshot of a seeded tcnn-layout network
    at the scene's config, with the scene's density grid."""
    from ngp_tpu_torch import bridge
    from ngp_tpu_torch.nn.models import NerfNetwork
    gen = torch.Generator().manual_seed(7)
    net = NerfNetwork(scene["cfg"], 1, generator=gen, grid_impl="tcnn")
    tree = bridge.nerf_params_to_numpy(dict(net.named_parameters()), net)
    tree["pos_encoding"] = np.random.default_rng(8).standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    dens = tsnap.load_snapshot(scene["path"])["snapshot"]["density_grid"]
    path = tmp_path / "reference.msgpack"
    tsnap.export_reference_snapshot(path, scene["cfg"], tree, aabb_scale=1,
                                    density_grid=dens)
    return str(path)


def test_reference_field_matches_jax(scene, tmp_path, monkeypatch):
    """A reference snapshot's field: the tcnn-layout network chosen by an
    argument. Intended divergence: the port neither sets nor reads
    NGP_TPU_GRID_IMPL (the JAX loader sets it for a while)."""
    path = _reference_snapshot(scene, tmp_path)
    monkeypatch.setenv("NGP_TPU_GRID_IMPL", "unread")
    f = tmn.NeuralRadianceField(path, device="cpu")
    assert os.environ["NGP_TPU_GRID_IMPL"] == "unread"
    assert isinstance(f.model.pos_encoding, GridEncoding)
    assert isinstance(tmn.NeuralRadianceField(
        scene["path"], device="cpu").model.pos_encoding, BlockedGridEncoding)
    monkeypatch.delenv("NGP_TPU_GRID_IMPL")
    jf = jmn.NeuralRadianceField(path)
    np.testing.assert_array_equal(f.bitfield.numpy(), np.asarray(jf.bitfield))
    rng = np.random.default_rng(9)
    pos, dirs = (rng.random((300, 3), dtype=np.float32) for _ in range(2))
    j_rgb, j_d = jf.model.apply(jf.params, pos, dirs)
    t_rgb, t_d = f.model(torch.from_numpy(pos), torch.from_numpy(dirs))
    _network_close(t_rgb.numpy(), j_rgb)
    _network_close(t_d.numpy(), j_d)
    # it renders as a descriptor beside a blocked-grid one
    req = _requests(tmn, scene["path"], "srgb")["one"]
    req.nerfs.append(tmn.NerfDescriptor(snapshot_path=path,
                                        transform=_placement()))
    img = _renderer().render(req)
    assert np.isfinite(img).all() and img.shape == (H, W, 4)


def test_snapshot_row_geometry_takes_precedence(scene, tmp_path):
    """A snapshot's log2_rows wins over the one its hash size implies."""
    from ngp_tpu_torch import bridge
    from ngp_tpu_torch.nn.models import NerfNetwork
    cfg = dict(scene["cfg"])
    cfg["encoding"] = dict(cfg["encoding"], log2_rows=7)
    net = NerfNetwork(cfg, 1)
    assert net.pos_encoding.meta.log2_rows == 7
    tree = bridge.nerf_params_to_numpy(dict(net.named_parameters()), net)
    path = tmp_path / "rows7.msgpack"
    dens = tsnap.load_snapshot(scene["path"])["snapshot"]["density_grid"]
    tsnap.save_snapshot(path, cfg, tree, tree, density_grid=dens)
    f = tmn.NeuralRadianceField(path, device="cpu")
    assert f.model.pos_encoding.meta.log2_rows == 7
    assert NerfNetwork(scene["cfg"], 1).pos_encoding.meta.log2_rows == 6


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["one", "spp2-dof", "aces-exposure", "two"])
def test_frame_matches_jax(scene, name):
    got = _renderer().render(_requests(tmn, scene["path"], "srgb")[name])
    ref = scene["ref"][name]
    assert 0.05 < ref[..., 3].mean() < 0.95
    _assert_close(got, ref)


@pytest.mark.parametrize("kind", FORK_CAMERAS)
def test_fork_camera_frame_matches_jax(scene, kind):
    """The frames of the fork's spherical-quadrilateral and
    quadrilateral-hexahedron cameras, as the rays of both are held in
    ``test_generate_global_rays_matches_jax``."""
    got = _renderer().render(_requests(tmn, scene["path"], "srgb")[kind])
    ref = scene["ref"][kind]
    assert ref.shape == (FORK_H, FORK_W, 4) and ref[..., 3].max() > 0.05
    _assert_close(got, ref)


def test_sum_mode_frame_matches_jax(scene):
    got = _renderer(composite_mode="sum").render(
        _requests(tmn, scene["path"], "srgb")["two"])
    ref = scene["ref"]["two-sum"]
    assert np.abs(ref - scene["ref"]["two"]).max() > 1e-3
    _assert_close(got, ref)


def test_color_space_divergence(scene):
    """"linear" is srgb_to_linear of the "srgb" frame; the JAX package's
    "srgb" applies linear_to_srgb to the composite instead."""
    reqs = _requests(tmn, scene["path"], "srgb")
    r = _renderer()
    srgb = r.render(reqs["one"])
    reqs["one"].output.color_space = "linear"
    lin = r.render(reqs["one"])
    want = srgb_to_linear(torch.from_numpy(srgb[..., :3])).numpy()
    np.testing.assert_allclose(lin[..., :3], want, atol=TOL)
    np.testing.assert_array_equal(lin[..., 3], srgb[..., 3])
    assert np.abs(lin[..., :3] - scene["ref"]["one"][..., :3]).max() > 1e-2
    reqs["one"].output.color_space = "rec709"
    with pytest.raises(ValueError, match="color_space"):
        r.render(reqs["one"])


def test_frames_are_deterministic_and_chunk_free(scene):
    req = _requests(tmn, scene["path"], "srgb")["two"]
    a = _renderer().render(req)
    b = _renderer().render(req)
    c = tmn.MultiNerfRenderer(chunk=100, device="cpu").render(req)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_mask_and_opacity_gates(scene):
    """A subtract box over the whole AABB leaves nothing; an opacity-0
    descriptor in "sum" mode is the frame without it, bit for bit."""
    reqs = _requests(tmn, scene["path"], "srgb")
    r = _renderer(composite_mode="sum")
    req = reqs["one"]
    req.modifiers = [tmn.Mask3D(shape="box", mode="subtract",
                                transform=np.eye(4, dtype=np.float32),
                                dims=np.full(3, 4.0, np.float32))]
    assert r.render(req)[..., 3].max() == 0.0
    req.modifiers = []
    alone = r.render(req)
    req.nerfs.append(tmn.NerfDescriptor(snapshot_path=scene["path"],
                                        transform=_placement(), opacity=0.0))
    np.testing.assert_array_equal(r.render(req), alone)


def test_downsample_and_flip(scene):
    req = _requests(tmn, scene["path"], "srgb")["one"]
    r = _renderer()
    full = r.render(req)
    req.output.flip_y = False
    np.testing.assert_array_equal(r.render(req), full[::-1])
    req.output.downsample = tmn.DownsampleInfo.MakeFromMip(1)
    assert r.render(req).shape == (H // 2, W // 2, 4)


def test_entry_points_default_to_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmn.MultiNerfRenderer()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmn.NeuralRadianceField(scene["path"])
