"""Parity of the port's frozen-model playback with the JAX package's: the
bake (within one bf16 ulp, at a D where both give a voxel the same
occupancy cell), the cache files both ways, and frames at D = 32 and
40×40 with one and with two nested cascades from the same cache (mean
|Δ| ≤ 1e-4, 99.9 % of values within 1e-3, all within a bf16 ulp); then the two intended divergences, each beside
what the JAX package does: a renderer keeps at most two orientations per
cascade, and the bake takes each voxel's centre cell (and the renderer
refuses a side that is not a multiple of zb). The network is a tiny NeRF
(4 levels, 16-wide MLPs) with a unit-variance table and a seeded sparse
occupancy bitfield."""
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.render import playback as jpb
from ngp_tpu_torch import bridge, run
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.common import GRID_VOLUME
from ngp_tpu_torch.io.camera_path import CameraKeyframe, CameraPath
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.render import playback as tpb
from test_torch_testbed import _port
from test_torch_testbed import scene  # noqa: F401  (a fixture)

AABB_SCALE = 2
FOCAL = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(fwd, eye=None):
    """NGP camera→world looking along ``fwd`` at 0.5³ from distance 1.4."""
    fwd = np.asarray(fwd, np.float64)
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.9 else \
        np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    eye = 0.5 - 1.4 * fwd if eye is None else eye
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """The JAX and port networks with the same seeded parameters."""
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    for k in ("network", "rgb_network"):
        cfg[k]["n_neurons"] = 16
    jcfg = dict(cfg, encoding=autofill_hashgrid_config(
        cfg["encoding"], 3, 2048.0, aabb_scale=AABB_SCALE))
    jm = JNerfNetwork(jcfg)
    tree = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    tree["pos_encoding"] = np.random.default_rng(0).standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 8.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    tm = TNerfNetwork(cfg, aabb_scale=AABB_SCALE, device="cpu")
    return jm, tree, tm, bridge.nerf_params_from_numpy(tree, tm)


def _bitfield(n_casc: int, p: float = 0.02, seed: int = 1) -> np.ndarray:
    bits = np.random.default_rng(seed).random((n_casc * GRID_VOLUME,)) < p
    return np.packbits(bits.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)


def _trainers(nets, bitfield, max_cascade):
    """Stand-ins for the two trainers: what a bake reads."""
    jm, tree, tm, params = nets
    common = dict(max_cascade=max_cascade,
                  aabb_min=np.float32(0.5 - AABB_SCALE / 2),
                  aabb_size=np.float32(AABB_SCALE),
                  dataset=SimpleNamespace(xforms=np.stack(
                      [_camera([1, 0.3, 0.2]), _camera([-0.2, 1, 0.1])])))
    jtr = SimpleNamespace(model=jm, grid=SimpleNamespace(
        bitfield=jnp.asarray(bitfield)), **common)
    ttr = SimpleNamespace(model=tm, grid=SimpleNamespace(
        bitfield=torch.from_numpy(bitfield)), **common)
    return jtr, ttr


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (2^(e - 7) for x in [2^e, 2^(e + 1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("max_cascade", [0, 1])
def test_bake_matches_jax(nets, max_cascade):
    """D = 128 (a multiple of 128: the voxel's corner and centre share a
    cell): the same voxels baked, each value within one bf16 ulp."""
    jm, tree, tm, params = nets
    jtr, ttr = _trainers(nets, _bitfield(max_cascade + 1), max_cascade)
    ref = jpb.bake_playback_cache(jtr, D=128, params=tree, batch=1 << 14)
    got = tpb.bake_playback_cache(ttr, D=128, params=params, batch=1 << 14)
    assert got.sides == ref.sides and len(got.vols) == max_cascade + 1
    for g, r in zip(got.vols, ref.vols):
        g = g.float().numpy()
        r = np.asarray(r, np.float32)
        assert g.shape == r.shape == (128, 128, 128, 4)
        np.testing.assert_array_equal(g == 0, r == 0)
        assert (g[..., 3] > 0).mean() > 0.01
        assert bool((np.abs(g - r) <= _bf16_ulp(r)).all())


@pytest.fixture(scope="module")
def caches(nets, tmp_path_factory):
    """JAX caches at D = 32 (one cascade, and two nested) saved to files,
    read by the port; 30 % of the cells occupied with one cascade, 6 %
    with two (the frames stay between empty and opaque)."""
    jm, tree, _, _ = nets
    out = {}
    for mc in (0, 1):
        jtr, _ = _trainers(nets, _bitfield(mc + 1, 0.3 / (1 + 4 * mc), 2),
                           mc)
        cache = jpb.bake_playback_cache(jtr, D=32, params=tree)
        path = str(tmp_path_factory.mktemp("pb") / f"cache{mc}.npz")
        jpb.save_playback_cache(path, cache)
        out[mc] = (cache, path)
    return out


def test_cache_files_cross_packages(caches, tmp_path):
    jcache, path = caches[1]
    got = tpb.load_playback_cache(path, "cpu")
    assert got.sides == jcache.sides and got.sh_degree == 0
    for g, r in zip(got.vols, jcache.vols):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r, np.float32))
    back = str(tmp_path / "port.npz")
    tpb.save_playback_cache(back, got)
    again = jpb.load_playback_cache(back)
    for g, r in zip(again.vols, jcache.vols):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(r, np.float32))
    z, zj = np.load(back), np.load(path)
    assert sorted(z.files) == sorted(zj.files)


CAMERAS = {"+x": [1, 0.2, 0.1], "-y": [0.15, -1, 0.2], "+z": [0.1, 0.2, 1],
           "oblique": [0.6, 0.5, -0.6]}


@pytest.mark.parametrize("max_cascade", [0, 1], ids=["single", "nested"])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_frames_match_jax(caches, max_cascade, cam):
    jcache, path = caches[max_cascade]
    opts = dict(width=40, height=40, background=(0.1, 0.2, 0.3, 0.0))
    xf = _camera(CAMERAS[cam])
    ref = jpb.PlaybackRenderer(jcache, jpb.PlaybackOptions(**opts)).render(
        xf, 40, 40, focal=FOCAL)
    got = tpb.PlaybackRenderer(tpb.load_playback_cache(path, "cpu"),
                               tpb.PlaybackOptions(**opts)).render(
        xf, 40, 40, focal=FOCAL)
    assert got.shape == ref.shape == (40, 40, 4)
    # the slices' first interpolation product rounds to bf16, and the two
    # packages sum it in other orders: a few of its entries round one bf16
    # ulp apart, which moves a pixel by up to ~2^-8. So: the mean, the
    # share of values within 1e-3, and one bf16 ulp as the bound
    err = np.abs(got - ref)
    assert float(err.mean()) <= 1e-4
    assert float((err <= 1e-3).mean()) >= 0.999
    assert float(err.max()) <= 2.0 ** -8
    assert 0.05 < float(ref[..., 3].mean()) < 0.95


def test_orbit_keeps_two_orientations_per_cascade(caches):
    """An orbit along ±x, ±y and ±z: the port's renderer holds at most
    two orientations of each cascade (the latest two); the JAX renderer
    keeps all six."""
    jcache, path = caches[1]
    opts = dict(width=24, height=24)
    r = tpb.PlaybackRenderer(tpb.load_playback_cache(path, "cpu"),
                             tpb.PlaybackOptions(**opts))
    jr = jpb.PlaybackRenderer(jcache, jpb.PlaybackOptions(**opts))
    seen = []
    for fwd in ([1, .1, .1], [-1, .1, .1], [.1, 1, .1], [.1, -1, .1],
                [.1, .1, 1], [.1, .1, -1]):
        xf = _camera(fwd)
        r.render(xf, 24, 24, focal=24.0)
        jr.render(xf, 24, 24, focal=24.0)
        seen.append((int(np.argmax(np.abs(fwd))), fwd[int(np.argmax(
            np.abs(fwd)))] < 0))
        for ci in range(2):
            assert r.orientations(ci) == seen[-2:]
    assert len([k for k in jr._vol_cache if k[0] == 0]) == 6


def test_bake_takes_each_voxels_centre_cell(nets):
    """Only cell (1, 1, 1) of cascade 0 occupied, at D = 192 (voxels 2/3
    of a cell wide): the port bakes the voxels whose centre lies in that
    cell, 1 and 2 on each axis; the JAX bake those whose lower corner
    does, 2 alone (voxel 1 spans cells 0.67-1.33)."""
    bitfield = np.zeros(GRID_VOLUME // 8, np.uint8)
    bitfield[0] = 1 << 7             # cell (1, 1, 1): byte 0, bit 1|2|4
    jtr, ttr = _trainers(nets, bitfield, 0)
    got = tpb.bake_playback_cache(ttr, D=192, params=nets[3])
    ref = jpb.bake_playback_cache(jtr, D=192, params=nets[1])
    occ_got = np.argwhere(got.vols[0][..., 3].float().numpy() > 0)
    occ_ref = np.argwhere(np.asarray(ref.vols[0][..., 3], np.float32) > 0)
    np.testing.assert_array_equal(occ_ref, [[2, 2, 2]])
    np.testing.assert_array_equal(
        occ_got, np.argwhere(np.ones((2, 2, 2), bool)) + 1)
    np.testing.assert_array_equal(tpb.voxel_cells(192)[:4], [0, 1, 1, 2])
    # at the default sides, multiples of 128, the two rules agree
    for D in (128, 256, 512):
        np.testing.assert_array_equal(
            tpb.voxel_cells(D), (np.arange(D) * 128) // D)


def test_renderer_refuses_a_side_not_a_multiple_of_zb(caches):
    """A cascade of side 36 with zb = 8: the port refuses it when the
    renderer is built; the JAX renderer fails inside its first frame."""
    jcache, _ = caches[0]
    vol = torch.zeros((36, 36, 36, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of zb"):
        tpb.PlaybackRenderer(tpb.PlaybackCache((vol,), (1.0,)),
                             tpb.PlaybackOptions(width=16, height=16))
    jr = jpb.PlaybackRenderer(
        jpb.PlaybackCache((jnp.zeros((36, 36, 36, 4), jnp.bfloat16),),
                          (1.0,)), jpb.PlaybackOptions(width=16, height=16))
    with pytest.raises(TypeError):
        jr.render(_camera([0.1, 0.2, 1]), 16, 16, focal=16.0)


@pytest.fixture(scope="module")
def nerf_testbed(scene, tmp_path_factory):  # noqa: F811
    """The port's NeRF Testbed on test_torch_testbed's scene, trained 16
    CPU steps, its snapshot and a two-keyframe camera path."""
    root = tmp_path_factory.mktemp("pb_testbed")
    tb = _port(scene)
    tb.train(16)
    tb.save_snapshot(str(root / "snap.msgpack"))
    CameraPath([CameraKeyframe.from_matrix(_camera([1, 0.2, 0.1])),
                CameraKeyframe.from_matrix(_camera([0.8, 0.5, 0.1]))],
               ).save(root / "path.json")
    return tb, root, scene


def test_testbed_bakes_loads_and_renders_playback(nerf_testbed):
    """The Testbed's bake, saved, loaded and rendered along a camera
    path. The intended divergence: it bakes toward each voxel's nearest
    training camera, where the JAX testbed's bake_playback takes the
    module's default, the cameras' mean position."""
    tb, root, _ = nerf_testbed
    tb.bake_playback(D=32, D_inner=32, path=str(root / "pb.npz"))
    baked = tb._playback_cache
    nearest = tpb.bake_playback_cache(tb.trainer, D=32, D_inner=32,
                                      ref_eye="nearest")
    mean_eye = tpb.bake_playback_cache(tb.trainer, D=32, D_inner=32)
    for v, w, m in zip(baked.vols, nearest.vols, mean_eye.vols):
        assert torch.equal(v, w) and not torch.equal(v, m)
    tb.load_camera_path(root / "path.json")
    a = tb.render_playback(24, 16, start_time=0.5)
    tb.load_playback(str(root / "pb.npz"))
    for v, w in zip(tb._playback_cache.vols, baked.vols):
        assert torch.equal(v, w)
    b = tb.render_playback(24, 16, start_time=0.5)
    assert a.shape == (16, 24, 4) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert 0.0 < float(a[..., 3].mean()) < 1.0


def test_runner_renders_a_playback_video(nerf_testbed, tmp_path, capsys):
    """``--video_camera_path`` with ``--video_playback``: 2 s at 2 fps
    from the baked cache (baked at D 32 here, the runner's default 256/512
    being a card's job), 4 RGB JPEGs beside the output."""
    from PIL import Image
    _, root, scene = nerf_testbed
    bake = Testbed.bake_playback
    with mock.patch.object(Testbed, "bake_playback",
                           lambda self: bake(self, D=32, D_inner=32)):
        assert run.main([
            "--scene", str(scene / "transforms.json"), "--network",
            str(scene / "net.json"), "--load_snapshot",
            str(root / "snap.msgpack"), "--device", "cpu",
            "--video_camera_path", str(root / "path.json"), "--video_fps",
            "2", "--video_n_seconds", "2", "--video_playback",
            "--video_output", str(tmp_path / "v.mp4"), "--width", "24",
            "--height", "16"]) == 0
    out = capsys.readouterr().out
    assert "video frame 4/4" in out
    frames = sorted((tmp_path / "tmp_video_frames").glob("*.jpg"))
    assert [f.name for f in frames] == [f"{i:04d}.jpg" for i in range(4)]
    assert np.asarray(Image.open(frames[0])).shape == (16, 24, 3)
