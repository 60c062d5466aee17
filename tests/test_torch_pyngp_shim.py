"""The port's pyngp shim (``ngp_tpu_torch.api.pyngp_shim``) against the JAX
package's: its names, the Blender render entry points, and the static
renderer's Mask3D masks through ``Testbed.render_masks`` against the JAX
testbed on one scene (PNG views with a transforms.json, a tiny network:
4 levels, 16-wide MLPs) and one snapshot the JAX package wrote (a
unit-variance table, a boosted density output, an analytic occupancy
grid).

Tolerance: a testbed frame mean |Δ| ≤ 2e-4 (the render bound of the
slice tests). Intended divergence: the port's testbed keys its renderer
cache by the masks as well; the JAX testbed reuses the renderer built
with the old masks after ``render_masks`` changes."""
import json
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from synthetic import make_orbit_dataset

import ngp_tpu_torch.api.pyngp_shim as ngp
from ngp_tpu.api.testbed import Testbed as JTestbed
from ngp_tpu.config import autofill_hashgrid_config
from ngp_tpu.data.nerf_loader import ngp_matrix_to_nerf
from ngp_tpu.io.snapshot import save_snapshot
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.render import multi_nerf as jmn

RES, N_VIEWS, FOCAL = 16, 4, 18.0
FW, FH = 16, 12
RENDER_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the names tests/test_pyngp_surface.py requires of the JAX shim
MODULE_NAMES = [
    "TestbedMode", "RenderMode", "RandomMode", "LossType", "ColorSpace",
    "TonemapCurve", "LensMode", "CameraModel", "MaskMode", "MaskShape",
    "GroundTruthRenderMode", "SDFGroundTruthMode", "NerfActivation",
    "MeshSdfMode", "BoundingBox", "Mask3D", "RenderRequest",
    "RenderOutputProperties", "RenderCameraProperties", "NerfDescriptor",
    "DownsampleInfo", "Testbed", "free_temporary_memory"]
TESTBED_METHODS = [
    "load_training_data", "reload_network_from_file",
    "reload_network_from_json", "frame", "train", "render",
    "request_nerf_render_sync", "request_nerf_render_async",
    "render_with_rolling_shutter", "save_snapshot", "load_snapshot",
    "load_camera_path", "screenshot", "compute_image_mse", "calculate_iou",
    "n_params", "reset_accumulation", "want_repl", "set_nerf_camera_matrix",
    "set_camera_to_training_view", "first_training_view",
    "set_camera_intrinsics", "set_camera_extrinsics",
    "get_camera_extrinsics", "set_image", "create_empty_nerf_dataset",
    "compute_marching_cubes_mesh", "compute_and_save_marching_cubes_mesh",
    "compute_and_save_png_slices", "override_sdf_training_data"]
TESTBED_PROPS = [
    "shall_train", "background_color", "exposure", "fov_axis", "zoom",
    "screen_center", "render_mode", "dynamic_res", "dynamic_res_target_fps",
    "fixed_res_factor", "render_groundtruth", "groundtruth_render_mode",
    "snap_to_pixel_centers", "render_near_distance", "camera_matrix",
    "training_batch_size", "camera_smoothing", "autofocus", "sun_dir",
    "up_dir", "training_step", "loss"]


def _config():
    with open("configs/nerf/base.json") as f:
        cfg = json.load(f)
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = 16
    cfg["rgb_network"]["n_neurons"] = 16
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene on disk, its network config and the JAX snapshot."""
    root = tmp_path_factory.mktemp("shim")
    ds = make_orbit_dataset(n_images=N_VIEWS, res=RES, focal=FOCAL)
    rng = np.random.default_rng(0)
    frames = []
    for i, xf in enumerate(ds.xforms):
        name = f"r_{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (RES, RES, 4), np.uint8)).save(
            root / name)
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(xf, 1.0, np.zeros(3, np.float32))
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    (root / "transforms.json").write_text(json.dumps({
        "aabb_scale": 1, "fl_x": FOCAL, "fl_y": FOCAL, "cx": 8.0, "cy": 8.0,
        "w": RES, "h": RES, "frames": frames}))
    cfg = _config()
    (root / "net.json").write_text(json.dumps(cfg))
    jcfg = dict(cfg)
    jcfg["encoding"] = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                                aabb_scale=1)
    tree = jax.tree.map(np.array, JNerfNetwork(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tree["pos_encoding"] = rng.standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 8.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    g = (np.arange(128) + 0.5) / 128
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    dens = np.where((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.12,
                    1.0, 0.0).astype(np.float32).reshape(-1)
    snap = root / "scene.msgpack"
    save_snapshot(snap, cfg, tree, tree, density_grid=dens, max_cascade=0,
                  aabb_scale=1, aabb_min=np.zeros(3), aabb_max=np.ones(3))
    return root


def _box(mod, **kw):
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = (0.45, 0.5, 0.55)
    return mod.Mask3D(shape="box", mode="subtract", transform=xf,
                      dims=np.array([0.4, 0.5, 0.6], np.float32),
                      feather=0.03, **kw)


def _loaded(tb, scene):
    tb.reload_network_from_file(scene / "net.json")
    tb.load_training_data(scene / "transforms.json")
    tb.load_snapshot(scene / "scene.msgpack")
    tb.set_camera_to_training_view(1)
    tb.background_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
    return tb


@pytest.fixture(scope="module")
def pair(scene):
    """The port's shim testbed and the JAX testbed, both from the
    snapshot, each with a subtract box in render_masks; and the JAX
    frame of that view."""
    tb = _loaded(ngp.Testbed(ngp.TestbedMode.Nerf, device="cpu"), scene)
    jtb = _loaded(JTestbed("nerf"), scene)
    jtb.render_masks = [_box(jmn)]
    return tb, np.asarray(jtb.render(FW, FH))


def test_module_and_testbed_names_match_the_jax_surface(pair):
    tb, _ = pair
    for name in MODULE_NAMES:
        assert hasattr(ngp, name), name
    for m in TESTBED_METHODS:
        assert callable(getattr(tb, m, None)), m
    for p in TESTBED_PROPS:
        assert hasattr(tb, p), p
    bb = ngp.BoundingBox((0, 0, 0), (2, 2, 2))
    assert bb.get_vertices().shape == (8, 3)
    assert [m.name for m in ngp.CameraModel] == [
        "Perspective", "QuadrilateralHexahedron", "SphericalQuadrilateral"]
    assert isinstance(tb, ngp.Testbed) and tb.device == torch.device("cpu")


def test_render_masks_frame_matches_jax(pair):
    tb, ref = pair
    tb.render_masks = [_box(ngp)]
    got = tb.render(FW, FH)
    assert got.shape == ref.shape == (FH, FW, 4)
    err = np.abs(got - ref)
    print(f"frame: mean |Δ| {err.mean():.3e}, max {err.max():.3e}; mean "
          f"opacity {ref[..., 3].mean():.3f}")
    assert err.mean() <= RENDER_TOL
    tb.render_masks = []


def test_render_masks_are_part_of_the_renderer_cache_key(pair):
    """Intended divergence: a render after a change to render_masks uses
    the new masks; the box takes opacity only where it is."""
    tb, _ = pair
    tb.render_masks = []
    plain = tb.render(FW, FH)
    tb.render_masks = [_box(ngp)]
    boxed = tb.render(FW, FH)
    tb.render_masks = [_box(ngp, opacity=0.5)]
    half = tb.render(FW, FH)
    tb.render_masks = []
    np.testing.assert_array_equal(tb.render(FW, FH), plain)
    a0, a1, a2 = plain[..., 3], boxed[..., 3], half[..., 3]
    assert (a1 <= a0 + 1e-6).all() and a1.sum() < a0.sum() - 1.0
    assert a1.sum() < a2.sum() < a0.sum()
    assert len(tb._renderer_cache) == 3


def _request(scene, **kw):
    """A request a Blender plugin might send: the snapshot seen from 1.0
    away (the default 512 lattice steps reach 0.87 into an aabb_scale-1
    scene), with the subtract box as a request-level modifier."""
    fwd = np.array([0.8, 0.5, 0.3]) / np.linalg.norm([0.8, 0.5, 0.3])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    xf = np.eye(4, dtype=np.float32)
    xf[:3] = np.stack([right, np.cross(fwd, right), fwd, 0.5 - fwd], 1)
    return ngp.RenderRequest(
        output=ngp.RenderOutputProperties(width=FW, height=FH, **kw),
        camera=ngp.RenderCameraProperties(transform=xf, focal_length=FOCAL),
        nerfs=[ngp.NerfDescriptor(snapshot_path=str(scene / "scene.msgpack"))],
        modifiers=[_box(ngp)])


def test_async_render_equals_sync(pair, scene):
    tb, _ = pair
    req = _request(scene, color_space="srgb")
    sync = tb.request_nerf_render_sync(req)
    assert sync.shape == (FH, FW, 4) and sync[..., 3].max() > 0.1
    done, out = threading.Event(), []

    def callback(img):
        out.append(img)
        done.set()
    tb.request_nerf_render_async(req, callback)
    assert done.wait(120)
    tb._render_thread.join(60)
    assert not tb._render_thread.is_alive() and not tb.m_currently_rendering
    np.testing.assert_array_equal(out[0], sync)


def test_concurrent_async_renders_are_serialised(pair, scene):
    """Renders from several threads on one testbed share its renderer under
    its lock: each gives the frame of its request alone."""
    tb, _ = pair
    reqs = [_request(scene, color_space=cs, exposure=e)
            for cs in ("srgb", "linear") for e in (0.0, 0.5)]
    want = [tb.request_nerf_render_sync(r) for r in reqs]
    got = [None] * len(reqs)

    def work(i):
        got[i] = tb.request_nerf_render_sync(reqs[i])
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_free_temporary_memory_drops_loaded_fields(pair, scene):
    tb, _ = pair
    tb.request_nerf_render_sync(_request(scene))
    assert tb._multi_nerf.fields
    ngp.free_temporary_memory()
    assert not tb._multi_nerf.fields
    assert tb.request_nerf_render_sync(_request(scene)).shape == (FH, FW, 4)


def test_render_with_rolling_shutter(pair):
    """A still camera gives the testbed's frame; a moving one with a
    rolling shutter along the rows gives another finite frame."""
    tb, _ = pair
    from ngp_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
    tb.render_masks = []
    ds = tb.nerf.training.dataset
    start, end = (ngp_matrix_to_nerf(m, ds.scale, ds.offset)
                  for m in (tb.camera_matrix, ds.xforms[2]))
    still = tb.render_with_rolling_shutter(start, start, [0, 0, 0, 1], FW,
                                           FH)
    err = np.abs(still - tb.render(FW, FH))
    assert err.mean() <= RENDER_TOL, err.max()
    moving = tb.render_with_rolling_shutter(start, end, [0.0, 0.0, 1.0, 0.0],
                                            FW, FH, linear=False)
    assert np.isfinite(moving).all() and moving.shape == (FH, FW, 4)
    assert np.abs(moving[..., 3] - still[..., 3]).max() > 1e-3


def test_shim_testbed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ngp.Testbed(ngp.TestbedMode.Nerf)
