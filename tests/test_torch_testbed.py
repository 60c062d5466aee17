"""The port's user surface in NeRF mode against the JAX package's: the
``Testbed`` of both on one scene written to disk (PNG views with a
transforms.json, from ``synthetic.make_orbit_dataset``), on the CPU at a
tiny size (4 levels, 16-wide MLPs, 16×16 views, frames of 12×10 to 16×12);
then the port's CLI and runner with ``--device cpu``.

Tolerances: dataset arrays, cameras and crop boxes 1e-6; parameters and
pixel pools exact; a frame rendered by both from one snapshot mean |Δ| ≤
2e-4 (the render tolerance of the slice tests). Intended divergence:
``train(n)`` and the CLI's and runner's ``--n_steps`` are exact; the JAX
trainer runs on to the next 16-step boundary."""
import json
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from synthetic import make_orbit_dataset

from ngp_tpu.api.testbed import Testbed as JTestbed
from ngp_tpu.data.nerf_loader import ngp_matrix_to_nerf
from ngp_tpu.io.snapshot import load_snapshot as j_load_snapshot
from ngp_tpu_torch import bridge
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.common import TestbedMode

RES, N_VIEWS, FOCAL = 16, 4, 18.0
TOL = 1e-6


def _views(n, res, seed=0):
    """sRGB uint8 RGBA views with structure: per-view colour ramps and a
    disc of partial alpha."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res] / (res - 1.0)
    out = np.empty((n, res, res, 4), np.uint8)
    for i in range(n):
        c = rng.random(3)
        rgb = np.stack([c[0] * x, c[1] * y, c[2] * (1 - x * y)], -1)
        disc = ((x - 0.5) ** 2 + (y - 0.5) ** 2) < 0.12
        a = np.where(disc, 1.0, 0.6)
        out[i] = np.round(np.concatenate([rgb, a[..., None]], -1) * 255)
    return out


def _config():
    with open("configs/nerf/base.json") as f:
        cfg = json.load(f)
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = 16
    cfg["rgb_network"]["n_neurons"] = 16
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene and a tiny network config on disk."""
    root = tmp_path_factory.mktemp("scene")
    ds = make_orbit_dataset(n_images=N_VIEWS, res=RES, focal=FOCAL)
    frames = []
    for i, (xf, img) in enumerate(zip(ds.xforms, _views(N_VIEWS, RES))):
        name = f"r_{i:03d}.png"
        Image.fromarray(img).save(root / name)
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(xf, 1.0, np.zeros(3, np.float32))
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    (root / "transforms.json").write_text(json.dumps({
        "aabb_scale": 1, "fl_x": FOCAL, "fl_y": FOCAL, "cx": 7.5, "cy": 8.5,
        "w": RES, "h": RES, "frames": frames}))
    (root / "net.json").write_text(json.dumps(_config()))
    return root


def _port(scene):
    tb = Testbed(TestbedMode.NERF, device="cpu")
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_file(scene / "net.json")
    tb.load_training_data(scene / "transforms.json")
    return tb


def _jax(scene):
    tb = JTestbed(TestbedMode.NERF.value)
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_file(scene / "net.json")
    tb.load_training_data(scene / "transforms.json")
    return tb


@pytest.fixture(scope="module")
def pair(scene):
    """A port testbed trained 16 CPU steps and a JAX testbed, untrained,
    on the same scene."""
    tb = _port(scene)
    tb.train(16)
    return tb, _jax(scene)


def test_loaded_dataset_matches_jax(pair):
    tb, jtb = pair
    ds, jds = tb.nerf.training.dataset, jtb.nerf.training.dataset
    for f in ("xforms", "xforms_end", "focal", "principal", "resolution",
              "lens_params", "images_u8", "sharpness", "up", "offset"):
        np.testing.assert_allclose(getattr(ds, f), getattr(jds, f), atol=TOL,
                                   err_msg=f)
    np.testing.assert_allclose(np.asarray(ds.images), np.asarray(jds.images),
                               atol=TOL)
    assert (ds.aabb_scale, ds.scale, ds.lens_mode, ds.n_images) == \
        (jds.aabb_scale, jds.scale, jds.lens_mode, jds.n_images)
    assert tb.nerf.training.n_images_for_training == N_VIEWS
    for box in ("aabb", "raw_aabb"):
        np.testing.assert_allclose(getattr(tb, box).min,
                                   getattr(jtb, box).min, atol=TOL)
        np.testing.assert_allclose(getattr(tb, box).max,
                                   getattr(jtb, box).max, atol=TOL)
    assert tb.bounding_radius == pytest.approx(jtb.bounding_radius, abs=TOL)


def test_namespaces_match_jax(pair):
    tb, jtb = pair
    for path in ("nerf", "nerf.training", "sdf", "sdf.training", "sdf.brdf",
                 "image", "image.training"):
        ours, theirs = tb, jtb
        for part in path.split("."):
            ours, theirs = getattr(ours, part), getattr(theirs, part)
        assert set(vars(ours)) == set(vars(theirs)), path
    assert tb.nerf.render_with_camera_distortion is False
    tb.nerf.rendering_min_transmittance = 2e-4
    assert tb.nerf.render_min_transmittance == 2e-4
    tb.nerf.render_min_transmittance = 1e-4
    # the Testbed's own attributes and methods: the JAX set plus the device
    # and the quilt's views (the JAX testbed renders no quilt)
    assert set(vars(tb)) - {"device", "quilting_dims"} == set(vars(jtb)) - {
        "_playback_cache", "_playback_renderers"}
    public = {n for n in dir(JTestbed) if not n.startswith("_")}
    assert public <= set(dir(Testbed))


def test_cameras_match_jax(pair):
    tb, jtb = pair
    for move in ("first_training_view", "next_training_view",
                 "next_training_view", "previous_training_view",
                 "last_training_view"):
        getattr(tb, move)()
        getattr(jtb, move)()
        np.testing.assert_allclose(tb.camera_matrix, jtb.camera_matrix,
                                   atol=TOL)
        np.testing.assert_allclose(tb._view_focal, jtb._view_focal, atol=TOL)
        np.testing.assert_allclose(tb.relative_focal_length,
                                   jtb.relative_focal_length, atol=TOL)
    for t in (tb, jtb):
        t.fov = 47.0
    assert tb.fov == pytest.approx(jtb.fov, abs=TOL)
    np.testing.assert_allclose(tb.fov_xy, jtb.fov_xy, atol=1e-5)
    for t in (tb, jtb):
        t.fov_xy = [41.0, 52.0]
        t.scale = 1.3
        t.look_at = np.array([0.45, 0.5, 0.55], np.float32)
        t.view_dir = [0.2, -0.9, 0.3]
        t.dof = 0.1
    np.testing.assert_allclose(tb.fov_xy, jtb.fov_xy, atol=1e-5)
    np.testing.assert_allclose(tb.look_at, jtb.look_at, atol=TOL)
    np.testing.assert_allclose(tb.view_dir, jtb.view_dir, atol=TOL)
    np.testing.assert_allclose(tb.camera_matrix, jtb.camera_matrix, atol=TOL)
    assert tb.aperture_size == jtb.aperture_size == 0.1
    m = np.asarray(jtb.nerf.training.dataset.xforms[2])
    nerf_m = ngp_matrix_to_nerf(m, 1.0, np.zeros(3, np.float32))
    tb.set_nerf_camera_matrix(nerf_m)
    np.testing.assert_allclose(tb.camera_matrix, m, atol=TOL)
    for t in (tb, jtb):
        t.first_training_view()
        t.scale, t.dof = 1.0, 0.0


@pytest.mark.parametrize("nerf_space", [False, True])
def test_crop_box_round_trips_match_jax(pair, nerf_space):
    tb, jtb = pair
    for t in (tb, jtb):
        t.render_aabb = None
        t.render_aabb_to_local = np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tb.crop_box(nerf_space),
                               jtb.crop_box(nerf_space), atol=TOL)
    m = tb.crop_box(nerf_space)
    m[:, :3] *= 0.5
    m[:, 3] += 0.05
    for t in (tb, jtb):
        t.set_crop_box(m, nerf_space)
    np.testing.assert_allclose(tb.crop_box(nerf_space), m, atol=TOL)
    np.testing.assert_allclose(tb.crop_box(nerf_space),
                               jtb.crop_box(nerf_space), atol=TOL)
    np.testing.assert_allclose(np.stack(tb.crop_box_corners(nerf_space)),
                               np.stack(jtb.crop_box_corners(nerf_space)),
                               atol=TOL)
    for t in (tb, jtb):
        t.render_aabb = None
        t.render_aabb_to_local = np.eye(3, dtype=np.float32)


def test_params_vector_and_histograms_match_jax(scene):
    """The JAX testbed's flat vector carried into the port: the same
    parameters, sizes and per-level statistics."""
    tb, jtb = _port(scene), _jax(scene)
    assert tb.n_params() == jtb.n_params()
    assert tb.n_encoding_params() == jtb.n_encoding_params()
    assert tb.params.size == jtb.params.size
    tb.params = jtb.params
    np.testing.assert_array_equal(tb.params, jtb.params)
    want = bridge.nerf_params_from_numpy(
        jax.tree.map(np.asarray, jtb.trainer.params), tb.trainer.model)
    for k, v in want.items():
        assert torch.equal(tb.trainer.params[k], v), k
    got, ref = tb.gather_histograms(), jtb.gather_histograms()
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12), k
    with pytest.raises(ValueError):
        tb.params = jtb.params[:-1]


def test_jax_snapshot_loads_into_the_port(scene, tmp_path):
    jtb = _jax(scene)
    path = tmp_path / "jax.msgpack"
    jtb.save_snapshot(path)
    tb = _port(scene)
    tb.load_snapshot(path)
    for tree, own in ((jtb.trainer.params, tb.trainer.params),
                      (jtb.trainer.opt_state.ema_params,
                       tb.trainer.opt_state.ema_params)):
        want = bridge.nerf_params_from_numpy(jax.tree.map(np.asarray, tree),
                                             tb.trainer.model)
        for k, v in want.items():
            assert torch.equal(own[k], v), k
    np.testing.assert_array_equal(tb.params, jtb.params)


def test_port_snapshot_renders_the_same_frame_in_jax(pair, tmp_path):
    """16 CPU steps of the port, saved; both testbeds load the snapshot
    and render one view."""
    tb, jtb = pair
    path = tmp_path / "port.msgpack"
    tb.save_snapshot(path)
    tb.load_snapshot(path)          # the fp16 density grid, as JAX reads it
    jtb.load_snapshot(path)
    np.testing.assert_array_equal(tb.params, jtb.params)
    assert jtb.training_step == tb.training_step == 16
    for t in (tb, jtb):
        t.set_camera_to_training_view(1)
        t.background_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
    got, ref = tb.render(16, 12), jtb.render(16, 12)
    assert got.shape == ref.shape == (12, 16, 4) and got.dtype == np.float32
    err = np.abs(got - np.asarray(ref))
    print(f"frame: mean |Δ| {err.mean():.3e}, max {err.max():.3e}; mean "
          f"opacity {ref[..., 3].mean():.3f}")
    assert err.mean() <= 2e-4
    for t in (tb, jtb):
        t.background_color = np.ones(4, np.float32)


def test_set_image_pixel_pool_matches_jax(pair):
    tb, jtb = pair
    img = np.random.default_rng(3).random((RES, RES - 4, 4)).astype(
        np.float32)
    for t in (tb, jtb):
        t.set_image(2, img)
    assert tb.nerf.training.dataset.images_u8 is None
    got = tb.trainer._pixels.numpy()
    ref = np.asarray(jtb.trainer.data["pixels"])
    assert got.dtype == ref.dtype == np.float16
    np.testing.assert_array_equal(got, ref)
    # and the edited pool trains
    step = tb.training_step
    assert np.isfinite(tb.train(2)) and tb.training_step == step + 2


def test_train_runs_exactly_n_steps(pair):
    """Intended divergence: 17 steps are 17, where the JAX trainer runs on
    to the 16-step boundary (32)."""
    tb, _ = pair
    step = tb.training_step
    tb.train(17)
    assert tb.training_step == step + 17


def test_blender_plugin_flow(scene):
    """The plugin's flow (tests/test_pyngp_surface.py's): a dataset built
    in memory by set_image and set_camera_*, trained by frame(); its
    dataset state as the JAX testbed's."""
    cfg = _config()
    img = np.zeros((RES, RES, 4), np.float32)
    img[4:12, 4:12] = (0.8, 0.2, 0.1, 1.0)
    xf = np.eye(4, dtype=np.float32)[:3]
    xf[2, 3] = -2.0
    both = []
    for t in (Testbed(device="cpu"), JTestbed()):
        t.reload_network_from_json(cfg)
        t.create_empty_nerf_dataset(n_images=2, aabb_scale=1)
        for i in range(2):
            t.set_image(i, img)
            t.set_camera_extrinsics(i, xf, convert_to_ngp=False)
        t.set_camera_intrinsics(30.0, 30.0)
        t.nerf.training.n_images_for_training = 2
        both.append(t)
    tb, jtb = both
    ds, jds = tb.nerf.training.dataset, jtb.nerf.training.dataset
    for f in ("images", "xforms", "focal", "principal", "resolution",
              "lens_params"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f), f)
    # the port sets the end transforms too (the JAX testbed leaves them at
    # the identity, a rolling shutter towards it)
    np.testing.assert_array_equal(ds.xforms_end, ds.xforms)
    tb.training_batch_size = 1 << 10
    tb.shall_train = True
    tb.frame()
    assert tb.training_step == 1
    np.testing.assert_allclose(tb.get_camera_extrinsics(0, False), xf,
                               atol=TOL)
    v = tb.params
    assert v.size == tb.n_params() and tb.n_encoding_params() > 0
    tb.params = v * 0.5
    np.testing.assert_allclose(tb.params, v * 0.5, atol=TOL)
    tb.set_image(1, img[::-1].copy())
    want = np.concatenate([im.reshape(-1, 4) for im in ds.images])
    np.testing.assert_array_equal(tb.trainer._pixels.numpy(),
                                  want.astype(np.float16))


def test_unported_modes_and_methods_raise(scene, tmp_path):
    # every engine is ported (the image and SDF modes in
    # test_torch_testbed_modes.py, the volume mode in test_torch_volume.py),
    # mesh export and playback too (test_torch_mesh_export.py,
    # test_torch_playback.py): without a trained field they raise
    tb = Testbed(device="cpu")
    for call in (lambda: tb.bake_playback(),
                 lambda: tb.render_playback(8, 8),
                 lambda: tb.compute_marching_cubes_mesh(),
                 lambda: tb.compute_and_save_marching_cubes_mesh("m.obj"),
                 lambda: tb.compute_and_save_png_slices("s"),
                 lambda: tb.get_rgba_on_grid()):
        with pytest.raises(ValueError, match="trained"):
            call()
    with pytest.raises(FileNotFoundError):
        tb.load_playback(str(tmp_path / "absent.npz"))
    # the other engines' metrics and data need their mode
    for call in (lambda: tb.calculate_iou(), lambda: tb.compute_image_mse(),
                 lambda: tb.override_sdf_training_data(None, None)):
        with pytest.raises(ValueError, match="needs a trained"):
            call()
    with pytest.raises(RuntimeError):
        tb.init_window(8, 8)
    # render_masks (test_torch_pyngp_shim) and the envmap are ported: an
    # opaque envmap is the background behind every ray
    tb = _port(scene)
    tb.background_color = np.zeros(4, np.float32)
    plain = tb.render(8, 8)
    tb.nerf.training.dataset.envmap = np.ones((4, 8, 4), np.float32)
    tb._renderer_cache = {}
    img = tb.render(8, 8)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img[..., :3] - plain[..., :3],
                               (1.0 - plain[..., 3:]) * np.ones(3), atol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available")
def test_entry_points_default_to_the_card(scene):
    from ngp_tpu_torch import __main__ as cli
    from ngp_tpu_torch import run
    with pytest.raises(RuntimeError, match="CUDA"):
        Testbed()
    for main in (cli.main, run.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--scene", str(scene / "transforms.json"), "--n_steps",
                  "1"])


def _iterations(out: str):
    return [(int(a), float(b)) for a, b in
            re.findall(r"^iteration=(\d+) loss=(\S+)", out, re.M)]


def test_cli_and_runner_on_the_cpu(scene, tmp_path, capsys, monkeypatch):
    """``python -m ngp_tpu_torch`` and ``python -m ngp_tpu_torch.run`` with
    --device cpu: the iteration lines, exact step counts, a snapshot the
    JAX package reads, held-out PSNR/SSIM and screenshots."""
    from ngp_tpu_torch import __main__ as cli
    from ngp_tpu_torch import run
    common = ["--scene", str(scene / "transforms.json"), "--network",
              str(scene / "net.json"), "--device", "cpu"]
    snap, shot = tmp_path / "cli.msgpack", tmp_path / "cli.png"
    assert cli.main(common + ["--n_steps", "7", "--batch_size", "4096",
                              "--save_snapshot", str(snap), "--screenshot",
                              str(shot), "--width", "16", "--height",
                              "12"]) == 0
    its = _iterations(capsys.readouterr().out)
    assert [i for i, _ in its] == list(range(1, 8))
    assert all(np.isfinite(v) for _, v in its)
    assert np.asarray(Image.open(shot)).shape == (12, 16, 4)
    doc = j_load_snapshot(snap)
    assert doc["snapshot"]["training_step"] == 7
    assert doc["encoding"]["n_levels"] == 4
    table = doc["snapshot"]["ngp_tpu_params"]["pos_encoding"]
    assert table.ndim == 3 and table.shape[0] == 4

    shots = tmp_path / "shots"
    monkeypatch.setenv("NGP_TPU_TESTBED_BATCH", "4096")
    assert run.main(common + [
        "--n_steps", "18", "--save_snapshot", str(tmp_path / "run.msgpack"),
        "--test_transforms", str(scene / "transforms.json"),
        "--screenshot_transforms", str(scene / "transforms.json"),
        "--screenshot_frames", "0", "2", "--screenshot_dir", str(shots),
        "--screenshot_spp", "2", "--width", "16", "--height", "12"]) == 0
    out = capsys.readouterr().out
    its = _iterations(out)
    assert [i for i, _ in its] == list(range(1, 19))
    assert j_load_snapshot(tmp_path / "run.msgpack")["snapshot"][
        "training_step"] == 18
    assert len(re.findall(r"^frame \d: psnr=\S+ ssim=\S+$", out, re.M)) == \
        N_VIEWS
    assert re.search(r"^PSNR=\S+ \(min=\S+ max=\S+\) SSIM=\S+$", out, re.M)
    for name in ("r_000.png", "r_002.png"):
        assert np.asarray(Image.open(shots / name)).shape == (12, 16, 4)
    # a mesh of the runner's snapshot (the mesh itself:
    # test_torch_mesh_export.py)
    assert run.main(common + [
        "--load_snapshot", str(tmp_path / "run.msgpack"), "--save_mesh",
        str(tmp_path / "m.obj"), "--marching_cubes_res", "16"]) == 0
    assert re.search(r"^saved mesh \(\d+ verts, \d+ faces\) to ",
                     capsys.readouterr().out, re.M)
    assert (tmp_path / "m.obj").exists()
