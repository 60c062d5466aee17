"""The port's NeRF renderer and Testbed on real-capture options against the
JAX package's, on the CPU at 24×24: frames through the F-theta lens over
an environment map, the LatLong lens, stereo and lenticular quilting with
the parallax head shift, and the int8 encode (the JAX encoding routed
through the Pallas ``blocked_grid_encode_i8fwd`` in interpret mode, as a
TPU runs it under ``NGP_TPU_ENCODE_INT8``); then a Testbed on an F-theta
capture with an envmap, the depth maps of ``set_image``, the depth loss,
the quilt and the int8 mode passed through.

Scene: the tiny network of ``test_torch_render`` (4 levels,
log2_hashmap_size 12, aabb_scale 1, a unit-variance table, a boosted
density output) over an analytic occupancy ball. Tolerances: a frame's
mean |Δ| ≤ 2e-4 and 99.5 % of pixels within 2e-3 (the render slice's)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import ngp_tpu.grid.occupancy as jocc
import ngp_tpu_torch.kernels.blocked_grid_cuda as bgc
import ngp_tpu_torch.render.nerf_render as tnr
from ngp_tpu.api.testbed import Testbed as JTestbed
from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.data.nerf_loader import ngp_matrix_to_nerf
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.nn.trainable_buffer import Envmap as JEnvmap
from ngp_tpu.render.nerf_render import NerfRenderer as JRenderer
from ngp_tpu.render.nerf_render import RenderOptions as JOptions
from ngp_tpu_torch import bridge
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.data.image_io import save_exr
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.nn.trainable_buffer import Envmap as TEnvmap
from ngp_tpu_torch.opt.optimizers import init_state
from test_torch_blocked_grid import pallas_calls_in_turn
from test_torch_int8_modes import route_int8
from test_torch_render import _orbit_camera

RES = 24
FTHETA = (0.0, 0.045, 2e-4, -4e-6, 0.0, float(RES), float(RES))
OPTS = dict(width=RES, height=RES, fov_axis_focal=26.0, chunk=192,
            march_steps=1024, background=(0.1, 0.2, 0.3, 0.0),
            linear_out=True, principal=(0.48, 0.53))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    return cfg


def _structured(tree, seed=0):
    """The JAX pytree with a unit-variance table and an 8× density output:
    a field with empty and dense space."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    tree["pos_encoding"] = rng.standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 8.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    return tree


def _ball_density(max_cascade: int) -> np.ndarray:
    pos = np.asarray(jocc.cell_center_positions(max_cascade))
    return np.where(np.linalg.norm(pos - 0.5, axis=-1) < 0.3, 5.0,
                    0.0).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    cfg = _config()
    jcfg = dict(cfg)
    jcfg["encoding"] = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                                aabb_scale=1)
    jm = JNerfNetwork(jcfg)
    tree = _structured(jm.init_params(jax.random.PRNGKey(0)))
    dens = _ball_density(0)
    j_bf = jocc.rebuild_bitfield(jocc.init_grid(0)._replace(
        density=jnp.asarray(dens)), 0).bitfield
    tm = TNerfNetwork(cfg, aabb_scale=1)
    params = bridge.nerf_params_from_numpy(tree, tm)
    t_bf = tocc.rebuild_bitfield(tocc.init_grid(0)._replace(
        density=torch.from_numpy(dens))).bitfield
    np.testing.assert_array_equal(t_bf.numpy(), np.asarray(j_bf))
    env = np.random.default_rng(1).random((8, 16, 4)).astype(np.float32)
    return dict(jm=jm, tree=tree, j_bf=j_bf, tm=tm, params=params, t_bf=t_bf,
                env=env)


def _assert_frame_close(got, ref, shape=(RES, RES, 4)):
    assert got.shape == ref.shape == shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    within = (err <= 2e-3).all(-1).mean()
    print(f"frame: mean |Δ| {err.mean():.3e}, max {err.max():.3e}, "
          f"{within:.4f} of pixels within 2e-3; mean opacity "
          f"{ref[..., 3].mean():.3f}")
    assert err.mean() <= 2e-4
    assert within >= 0.995


# name → (render options, camera, envmap behind the rays)
FRAMES = {
    "ftheta-envmap": (dict(lens_mode="ftheta", lens_params=FTHETA),
                      _orbit_camera(0.4), True),
    "latlong": (dict(lens_mode="latlong"), _orbit_camera(1.0, radius=0.5),
                False),
    "quilt-stereo": (dict(quilting_dims=(2, 1),
                          parallax_shift=(0.08, 0.0, 0.6)),
                     _orbit_camera(2.0), False),
    "quilt-fan": (dict(quilting_dims=(2, 2), parallax_shift=(0.0, 0.0, 1.5)),
                  _orbit_camera(2.5, radius=1.2), False),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_lens_and_quilt_frames_match_jax(scene, name):
    kw, cam, with_env = FRAMES[name]
    env = scene["env"]
    j_env = t_env = None
    if with_env:
        je, te = JEnvmap(*env.shape[:2]), TEnvmap(*env.shape[:2])
        j_arr, t_arr = jnp.asarray(env), torch.from_numpy(env)

        def j_env(d):
            return je.sample(j_arr, d)

        def t_env(d):
            return te.sample(t_arr, d)
    ref = JRenderer(scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
                    JOptions(**OPTS, **kw), envmap_sampler=j_env).render(
        scene["tree"], scene["j_bf"], cam, RES, RES, focal=(26.0, 26.0))
    r = tnr.NerfRenderer(scene["tm"], 0.0, 1.0, 0.0, 0,
                         tnr.RenderOptions(**OPTS, **kw),
                         envmap_sampler=t_env)
    got = r.render(scene["params"], scene["t_bf"], cam, RES, RES,
                   focal=(26.0, 26.0)).numpy()
    assert r.last_n_samples > 0 and 0.02 < ref[..., 3].mean() < 0.98
    _assert_frame_close(got, np.asarray(ref))
    # the option takes effect: the pinhole frame over the plain
    # background is another picture
    plain = tnr.NerfRenderer(scene["tm"], 0.0, 1.0, 0.0, 0,
                             tnr.RenderOptions(**OPTS)).render(
        scene["params"], scene["t_bf"], cam, RES, RES,
        focal=(26.0, 26.0)).numpy()
    assert np.abs(plain - got).mean() > 1e-2


def test_int8_frame_matches_jax_through_the_pallas_int8_encode(
        scene, monkeypatch):
    """The int8 frame: the port quantises the table once and encodes every
    chunk through the int8 table (K4's plain version here); the JAX
    encoding is routed through ``blocked_grid_encode_i8fwd``."""
    cam = _orbit_camera(0.9)
    assert route_int8(monkeypatch, scene["jm"].pos_encoding, "fwd") == 1
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(JRenderer(
            scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
            JOptions(**OPTS)).render(scene["tree"], scene["j_bf"], cam, RES,
                                     RES, focal=(26.0, 26.0)))
    calls = {"quantize": 0, "encode": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(tnr, "quantize_table_i8",
                        counting("quantize", tnr.quantize_table_i8))
    monkeypatch.setattr(bgc, "encode_quantized",
                        counting("encode", bgc.encode_quantized))
    r = tnr.NerfRenderer(scene["tm"], 0.0, 1.0, 0.0, 0,
                         tnr.RenderOptions(**OPTS), encode_int8="fwd")
    got = r.render(scene["params"], scene["t_bf"], cam, RES, RES,
                   focal=(26.0, 26.0)).numpy()
    n_chunks = -(-RES * RES // OPTS["chunk"])
    assert calls == {"quantize": 1, "encode": n_chunks * 4}, calls
    _assert_frame_close(got, ref)
    f32 = tnr.NerfRenderer(scene["tm"], 0.0, 1.0, 0.0, 0,
                           tnr.RenderOptions(**OPTS)).render(
        scene["params"], scene["t_bf"], cam, RES, RES,
        focal=(26.0, 26.0)).numpy()
    assert np.abs(f32 - got).max() > 1e-4


# --------------------------------------------------------------------------
# the Testbed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """An F-theta capture on disk: 3 orbit views (PNG), their native
    intrinsics and an EXR envmap written by the port; and a tiny config."""
    root = tmp_path_factory.mktemp("ftheta")
    rng = np.random.default_rng(2)
    frames = []
    for i in range(3):
        xf = _orbit_camera(0.5 + 2.1 * i)
        img = (rng.random((16, 16, 4)) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(root / f"r_{i}.png")
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(xf, 1.0, np.zeros(3, np.float32))
        frames.append({"file_path": f"r_{i}.png",
                       "transform_matrix": m.tolist()})
    save_exr(root / "env.exr", rng.random((8, 16, 3)).astype(np.float32))
    (root / "transforms.json").write_text(json.dumps({
        "aabb_scale": 1, "fl_x": 16.0, "w": 16, "h": 16, "envmap": "env.exr",
        **{f"ftheta_p{k}": v for k, v in enumerate(FTHETA[:5])},
        "frames": frames}))
    (root / "net.json").write_text(json.dumps(_config()))
    return root


def _testbeds(capture):
    """A JAX and a port Testbed on the capture, with the same structured
    parameters and the ball as occupancy grid."""
    out = []
    for t in (JTestbed("nerf"), Testbed(device="cpu")):
        t.training_batch_size = 1 << 12
        t.reload_network_from_file(capture / "net.json")
        t.load_training_data(capture / "transforms.json")
        out.append(t)
    jtb, tb = out
    jtr, ttr = jtb.trainer, tb.trainer
    tree = _structured(jtr.params, seed=3)
    jtr.params = jax.tree.map(jnp.asarray, tree)
    jtr.opt_state = jtr.opt_state._replace(
        ema_params=jax.tree.map(jnp.asarray, tree))
    with torch.no_grad():
        for k, v in bridge.nerf_params_from_numpy(tree, ttr.model).items():
            ttr.params[k].copy_(v)
    ttr.opt_state = init_state(ttr.params, ttr.opt_cfg)
    dens = _ball_density(jtr.max_cascade)
    jtr.grid = jocc.rebuild_bitfield(jtr.grid._replace(
        density=jnp.asarray(dens)), jtr.max_cascade)
    ttr.grid = tocc.rebuild_bitfield(ttr.grid._replace(
        density=torch.from_numpy(dens)))
    return jtb, tb


def test_testbed_ftheta_capture_with_envmap_matches_jax(capture):
    jtb, tb = _testbeds(capture)
    ds = tb.nerf.training.dataset
    assert ds.lens_mode == "ftheta" and ds.envmap.shape == (8, 16, 4)
    for t in (jtb, tb):
        t.set_camera_to_training_view(1)
        t.background_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
    got, ref = tb.render(16, 16), np.asarray(jtb.render(16, 16))
    _assert_frame_close(got, ref, (16, 16, 4))
    # the envmap is the background: without it the frame changes
    tb.nerf.training.dataset.envmap = None
    tb._renderer_cache = {}
    assert np.abs(tb.render(16, 16) - got).mean() > 1e-2


def test_testbed_passes_depth_quilt_and_int8_through(capture, monkeypatch):
    """Port-only surface (the JAX testbed reads none of these):
    ``set_image(depth=, depth_scale=)`` writes the depth map and uploads
    it to the trainer's pool; the depth loss type and λ reach the trainer;
    the quilt and the parallax shift reach the renderer and its cache key;
    NGP_TPU_ENCODE_INT8 reaches the renderer."""
    _, tb = _testbeds(capture)
    depth = np.random.default_rng(4).random((16, 16)).astype(np.float32)
    tb.set_image(1, np.asarray(tb.nerf.training.dataset.images[1]),
                 depth=depth, depth_scale=2.0)
    ds = tb.nerf.training.dataset
    np.testing.assert_array_equal(ds.depth_images[1], depth * 2.0)
    assert not ds.depth_images[0].any()
    np.testing.assert_array_equal(
        tb.trainer._depths[256:512].numpy(), (depth * 2.0).reshape(-1))
    tb.set_camera_to_training_view(0)
    flat = tb.render(16, 16)
    tb.quilting_dims = (2, 1)
    tb.parallax_shift = np.array([0.1, 0.0, 0.5], np.float32)
    quilt = tb.render(16, 16)
    opts = tb._nerf_renderer(16, 16).opts
    assert opts.quilting_dims == (2, 1)
    assert opts.parallax_shift == pytest.approx((0.1, 0.0, 0.5))
    assert len(tb._renderer_cache) == 2
    assert np.isfinite(quilt).all() and np.abs(quilt - flat).mean() > 1e-3
    tb.nerf.training.depth_supervision_lambda = 0.3
    tb.nerf.training.depth_loss_type = 0              # LossType.L2
    monkeypatch.setenv("NGP_TPU_ENCODE_INT8", "fwd")
    tb.reload_network_from_file(capture / "net.json")
    tc = tb.trainer.tcfg
    assert (tc.depth_supervision_lambda, tc.depth_loss_type,
            tc.encode_int8) == (0.3, "L2", "fwd")
    assert tb._nerf_renderer(16, 16).encode_int8 == "fwd"
