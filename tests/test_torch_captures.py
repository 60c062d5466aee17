"""Real-capture features of the port against the JAX package, on the CPU at
a small size: the NeRF loader on a scene written with every sidecar and
flag (alpha, dynamic mask, per-pixel rays, depth maps under
``integer_depth_scale``, an envmap, white/black transparency, the F-theta
and LatLong lenses), the lens functions, the VR helpers (quilting,
reprojection, motion vectors), one training step each with depth
supervision, ray sidecars, a rolling shutter (the JAX step's ``k_time``
draws fed in) and an F-theta capture, and the numerics guard.

Tolerances: loader arrays equal; lens and ray functions rtol 1e-6 (atol
1e-6 where a direction component is near 0); a training step as
``test_torch_train_step`` holds one: loss rtol 1e-4, counts equal, each
gradient leaf within 1e-2 of its norm (bf16 rounding points of the MLPs),
the table gradient's zero pattern equal."""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ngp_tpu.data.nerf_loader as jload
import ngp_tpu.rays.camera as jcam
import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.data.nerf_loader as tload
import ngp_tpu_torch.grid.occupancy as tocc
import ngp_tpu_torch.rays.camera as tcam
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu.utils import debug as jdebug
from ngp_tpu_torch import bridge
from ngp_tpu_torch.data.image_io import save_exr
from ngp_tpu_torch.opt.optimizers import init_state
from ngp_tpu_torch.utils import debug as tdebug
from test_torch_camera_step import analytic_grid
from test_torch_loader import FIELDS
from test_torch_train_step import (FOCAL, N_LIVE, N_RAYS, RES, TRAIN_KW,
                                   sphere_scene)

W, H = 24, 16
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------

def write_capture(root, flag: str, lens: str, envmap_ext: str):
    """A 4-view PNG capture with every sidecar: depth maps (16-bit PNGs)
    on views 0 and 3, an alpha sidecar on view 0, a dynamic mask on view
    1, a ray sidecar on view 2, an end transform on view 1; the global
    ``flag`` (white/black transparency), the ``lens`` keys and an envmap.
    Each view has pure white and pure black pixels. Returns the
    transforms.json path."""
    rng = np.random.default_rng(0)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    frames = []
    for i in range(4):
        img = (rng.random((H, W, 4)) * 255).round().astype(np.uint8)
        img[..., 3] = np.where(rng.random((H, W)) < 0.2, 0, 255)
        img[2:5, 3:7, :3] = 255
        img[9:12, 10:15, :3] = 0
        Image.fromarray(img, "RGBA").save(img_dir / f"{i:03d}.png")
        a = 2 * np.pi * i / 4
        m = np.eye(4)
        m[:3, 3] = [2 * np.cos(a), 2 * np.sin(a), 0.5]
        fr = {"file_path": f"images/{i:03d}.png",
              "transform_matrix": m.tolist()}
        if i in (0, 3):
            depth = (rng.random((H, W)) * 4000).astype(np.uint16)
            Image.fromarray(depth).save(img_dir / f"{i:03d}.depth.png")
            fr["depth_path"] = f"images/{i:03d}.depth.png"
        if i == 1:
            m_end = m.copy()
            m_end[:3, 3] += 0.05
            fr["transform_matrix_end"] = m_end.tolist()
        frames.append(fr)
    Image.fromarray((rng.random((H, W)) * 255).astype(np.uint8), "L").save(
        img_dir / "000.alpha.png")
    mask = np.zeros((H, W), np.uint8)
    mask[4:10, 6:18] = 255
    Image.fromarray(mask, "L").save(img_dir / "dynamic_mask_001.png")
    rng.standard_normal((H, W, 6)).astype(np.float32).tofile(
        img_dir / "rays_002.dat")
    env = rng.random((8, 16, 3)).astype(np.float32) * 2
    if envmap_ext == ".exr":
        save_exr(root / "env.exr", env)
    else:
        rgba = np.concatenate([env / 2, env[..., :1] / 2], -1)
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
            root / "env.png")
    cfg = {"fl_x": 20.0, "fl_y": 21.0, "cx": 12.5, "cy": 7.5, "w": W, "h": H,
           "aabb_scale": 4, "scale": 0.5, "offset": [0.5, 0.4, 0.6],
           "integer_depth_scale": 1.0 / 1000, flag: True,
           "envmap": "env" + envmap_ext, "frames": frames}
    if lens == "ftheta":
        cfg.update({f"ftheta_p{k}": v for k, v in
                    enumerate((0.0, 0.04, 1e-4, -2e-6, 1e-8))},
                   w=W, h=H)
    else:
        cfg["latlong"] = True
    path = root / "transforms.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.mark.parametrize("flag,lens,env", [
    ("white_transparent", "ftheta", ".exr"),
    ("black_transparent", "latlong", ".png")])
def test_loader_sidecars_match_jax(tmp_path, flag, lens, env):
    path = write_capture(tmp_path, flag, lens, env)
    t = tload.load_nerf(path)
    j = jload.load_nerf(path)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert t.lens_mode == lens
    for f in ("images", "depth_images", "rays", "envmap"):
        got, want = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the transforms of pixels, flags and sidecars drop the uint8 copy
    assert t.images_u8 is None and j.images_u8 is None
    imgs = np.asarray(t.images)
    assert (imgs[1, ..., 0] < 0).any()                # the dynamic mask
    assert (t.depth_images[0] > 0).mean() > 0.9 and not t.depth_images[1].any()
    assert t.rays[2].any() and not t.rays[0].any()
    assert t.envmap.shape[-1] == 4
    if env == ".exr":                     # an RGB envmap gets alpha 1
        assert (t.envmap[..., 3] == 1).all()
    # the flag keys out pixels of its colour that were opaque
    cfg = json.loads(path.read_text())
    del cfg[flag]
    path.write_text(json.dumps(cfg))
    plain = np.asarray(tload.load_nerf(path).images)
    keyed = plain[..., 3] != imgs[..., 3]
    assert keyed[3].any() and (imgs[keyed][:, 3] == 0).all()


def test_loader_downscales_sidecars_where_jax_raises(tmp_path):
    """Intended divergence: under a downscale the port takes every
    downscale-th pixel of the alpha and dynamic-mask sidecars, as of the
    image, the rays and the depth; the JAX loader multiplies the
    downscaled image by the full-size sidecar and raises."""
    path = write_capture(tmp_path, "white_transparent", "ftheta", ".exr")
    full = tload.load_nerf(path)
    half = tload.load_nerf(path, downscale=2)
    for f in ("images", "depth_images", "rays"):
        np.testing.assert_array_equal(np.asarray(getattr(half, f)),
                                      np.asarray(getattr(full, f))
                                      [:, ::2, ::2], err_msg=f)
    with pytest.raises(ValueError, match="broadcast"):
        jload.load_nerf(path, downscale=2)


# --------------------------------------------------------------------------
# lenses and the VR helpers
# --------------------------------------------------------------------------

FTHETA = (0.0, 0.04, 1e-4, -2e-6, 1e-8, 64.0, 48.0)


def test_latlong_and_f_theta_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.random((500, 2), dtype=np.float32)
    np.testing.assert_allclose(tcam.latlong_to_dir(_t(xy)).numpy(),
                               np.asarray(jcam.latlong_to_dir(xy)),
                               rtol=TOL, atol=TOL)
    rel = (rng.random((500, 2), dtype=np.float32) - 0.5) * 1.2
    rel[0] = 0.0                         # r = 0: the default direction
    params = np.tile(np.float32(FTHETA), (500, 1))
    params[1, 1] = 3.0                   # θ past π/2: the default too
    default = np.float32([0.0, 0.0, 1.0])
    got = tcam.f_theta_undistort(_t(rel), _t(params), _t(default)).numpy()
    want = np.asarray(jcam.f_theta_undistort(rel, params, default))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[:2], [default, default])


@pytest.mark.parametrize("mode", list(tcam.LENS_MODES))
def test_pixel_to_ray_train_matches_jax_in_every_lens_mode(mode):
    rng = np.random.default_rng(1)
    n = 400
    xy = rng.random((n, 2), dtype=np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    xf = np.concatenate([q, rng.standard_normal((n, 3, 1))], -1).astype(
        np.float32)
    focal = (rng.random((n, 2)) * 40 + 20).astype(np.float32)
    principal = (rng.random((n, 2)) * 0.2 + 0.4).astype(np.float32)
    res = np.float32(rng.integers(16, 64, (n, 2)))
    lp = np.tile(np.float32(FTHETA if mode == "ftheta" else
                            (-0.08, 0.03, 1e-3, -2e-3, 0, 0, 0)), (n, 1))
    args = (xy, xf, focal, principal, res, lp)
    j_o, j_d = jcam.pixel_to_ray_train(*args, mode == "opencv",
                                       lens_mode=mode)
    t_o, t_d = tcam.pixel_to_ray_train(*map(_t, args), mode == "opencv",
                                       lens_mode=mode)
    np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dims", [(2, 1), (3, 2)])
def test_apply_quilting_matches_jax(dims):
    rng = np.random.default_rng(2)
    Wf, Hf = 96, 40
    x = np.floor(rng.random(300) * Wf).astype(np.float32)
    y = np.floor(rng.random(300) * Hf).astype(np.float32)
    ps = (0.064, 0.01, 0.8)
    got = tcam.apply_quilting(_t(x), _t(y), (Wf, Hf), ps, dims)
    want = jcam.apply_quilting(x, y, (Wf, Hf), ps, dims)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    assert len(np.unique(got[2][:, 0].numpy())) == dims[0] * dims[1]


@pytest.mark.parametrize("opencv", [False, True], ids=["pinhole", "opencv"])
def test_pos_to_pixel_and_motion_vectors_match_jax(opencv):
    rng = np.random.default_rng(3)
    res, focal, center = (64, 48), (50.0, 52.0), (0.45, 0.55)
    xf = np.eye(4, dtype=np.float32)[:3]
    xf[:, 3] = (0.1, -0.2, -2.0)
    prev = xf.copy()
    c, s = math.cos(0.05), math.sin(0.05)
    prev[:, :3] = np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    prev[:, 3] += (0.03, 0.01, 0.0)
    lens = (-0.08, 0.03, 1e-3, -2e-3) if opencv else None
    ps = (0.02, -0.01, 0.5)
    pos = (rng.random((200, 3)) - 0.5).astype(np.float32)
    got = tcam.pos_to_pixel(_t(pos), res, focal, _t(xf), center, ps, lens,
                            opencv).numpy()
    want = np.asarray(jcam.pos_to_pixel(pos, res, focal, xf, center, ps,
                                        lens, opencv))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    pix = (rng.random((200, 2)) * res).astype(np.float32)
    depth = (rng.random(200) * 2 + 1).astype(np.float32)
    got = tcam.motion_vector_3d(_t(pix), res, focal, _t(xf), _t(prev),
                                center, _t(depth), ps, lens, opencv).numpy()
    want = np.asarray(jcam.motion_vector_3d(pix, res, focal, xf, prev,
                                            center, depth, ps, lens,
                                            opencv))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert np.abs(want).mean() > 0.5


# --------------------------------------------------------------------------
# one training step each
# --------------------------------------------------------------------------

def _sphere_depth(ds) -> np.ndarray:
    """The z-depth (distance along the camera's forward axis) of the
    scene's sphere (centre 0.5³, radius 0.22) at each pixel centre; 0
    where the pixel misses it."""
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    d = np.stack([((xs + 0.5) / RES - 0.5) * RES / FOCAL,
                  ((ys + 0.5) / RES - 0.5) * RES / FOCAL,
                  np.ones((RES, RES))], -1)
    out = np.zeros((ds.n_images, RES, RES), np.float32)
    for i, xf in enumerate(ds.xforms):
        dw = d @ xf[:, :3].T
        n = np.linalg.norm(dw, axis=-1)
        oc = xf[:, 3] - 0.5
        b = (dw / n[..., None] * oc).sum(-1)
        disc = b * b - ((oc * oc).sum() - 0.22 ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        out[i] = np.where(disc > 0, t / n, 0.0)
    return out


def _capture(name: str):
    """The sphere scene of test_torch_train_step as a capture with the
    feature ``name``, and the trainer options it needs."""
    ds, cfg = sphere_scene()
    rng = np.random.default_rng(4)
    if name == "depth":
        return dataclasses.replace(ds, depth_images=_sphere_depth(ds)), cfg, \
            dict(depth_supervision_lambda=0.5)
    if name == "ray-sidecars":
        # the camera's own rays, moved: origins by ~1e-2, directions
        # turned by ~2e-2 and scaled, so they differ from the camera path
        ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
        d = np.stack([((xs + 0.5) / RES - 0.5) * RES / FOCAL,
                      ((ys + 0.5) / RES - 0.5) * RES / FOCAL,
                      np.ones((RES, RES))], -1)
        rays = np.zeros((ds.n_images, RES, RES, 6), np.float32)
        for i, xf in enumerate(ds.xforms):
            rays[i, ..., :3] = xf[:, 3] + 0.01 * rng.standard_normal(
                (RES, RES, 3))
            rays[i, ..., 3:] = (d @ xf[:, :3].T + 0.02 * rng.standard_normal(
                (RES, RES, 3))) * rng.uniform(0.5, 2.0, (RES, RES, 1))
        return dataclasses.replace(ds, rays=rays), cfg, {}
    if name == "rolling-shutter":
        xe = ds.xforms.copy()
        c, s = math.cos(0.06), math.sin(0.06)
        rot = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        xe[:, :, :3] = rot @ xe[:, :, :3]
        xe[:, :, 3] = (xe[:, :, 3] - 0.5) @ rot.T + 0.5 + 0.02
        return dataclasses.replace(ds, xforms_end=xe), cfg, {}
    assert name == "ftheta"
    lp = np.tile(np.float32([0.0, 1.0 / FOCAL, 1e-4, -1e-6, 0.0, RES, RES]),
                 (ds.n_images, 1))
    return dataclasses.replace(ds, lens_params=lp, lens_mode="ftheta"), \
        cfg, {}


def _draws(key, rolling: bool):
    """The uniforms ``_train_step_impl`` draws from its key (``nerf.py:512``
    and, in ``_sample_pixels``, ``:340``), the shutter time ``k_time``
    (``:516-518``) of a rolling-shutter capture included."""
    k_ray, k_march, k_bg, k_time, _ = jax.random.split(key, 5)
    k_img, k_xy, _ = jax.random.split(k_ray, 3)
    u = [jax.random.uniform(k_img, (N_RAYS,)),
         jax.random.uniform(k_xy, (N_RAYS, 2)),
         jax.random.uniform(k_march, (N_RAYS,)),
         jax.random.uniform(k_bg, (N_RAYS, 3)),
         jax.random.uniform(k_time, (N_RAYS,)) if rolling else None]
    return tnerf.StepDraws(*(None if a is None else _t(np.array(a))
                             for a in u)).head(N_LIVE)


@pytest.fixture(scope="module", params=["depth", "ray-sidecars",
                                        "rolling-shutter", "ftheta"])
def capture_step(request):
    """Both trainers in the same state on the capture, and one step of
    each (the gradients caught on their way into ``apply_update``)."""
    ds, cfg, kw = _capture(request.param)
    kw = {**TRAIN_KW, **kw}
    jtr = jnerf.NerfTrainer(ds, cfg, tcfg=jnerf.NerfTrainerConfig(**kw))
    ttr = tnerf.NerfTrainer(ds, cfg, device="cpu",
                            tcfg=tnerf.NerfTrainerConfig(**kw))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.array, jtr.params)
    tree["pos_encoding"] = (rng.standard_normal(tree["pos_encoding"].shape)
                            * 0.5).astype(np.float32)
    jtr.params = jax.tree.map(jnp.asarray, tree)
    jtr.opt_state = jnerf.init_state(jtr.params, jtr.opt_cfg)
    with torch.no_grad():
        for k, v in bridge.nerf_params_from_numpy(tree, ttr.model).items():
            ttr.params[k].copy_(v)
    ttr.opt_state = init_state(ttr.params, ttr.opt_cfg)
    jtr.grid = analytic_grid(jtr)
    ttr.grid = bridge.grid_from_numpy(**jax.tree.map(np.asarray,
                                                     jtr.grid._asdict()))
    em = (rng.random(jtr.error_map.shape) ** 4).astype(np.float32)
    jtr.error_map = jnp.asarray(em)
    ttr.error_map = torch.from_numpy(em.copy())
    j_err = jtr._error_state()
    t_err = {k: _t(np.array(v)) for k, v in j_err.items()}
    key = jax.random.PRNGKey(7)
    draws = _draws(key, request.param == "rolling-shutter")
    # the port's loss of the same step without the feature's term, where
    # it has one (before the step changes the parameters)
    t_plain = None
    if request.param == "depth":
        ttr.tcfg.depth_supervision_lambda = 0.0
        t_plain = float(ttr._step_grads(draws, t_err)[2].loss)
        ttr.tcfg.depth_supervision_lambda = kw["depth_supervision_lambda"]
    caught = {}

    def spy(name, fn):
        def wrapped(params, grads, *args):
            caught[name] = grads
            return fn(params, grads, *args)
        return wrapped
    # the JAX step runs eagerly, as test_torch_train_step's does: compiled
    # whole, XLA fuses its arithmetic, and its samples and gradients move
    # away from the eager step's (and the port's) by more than the
    # tolerances
    saved = (jnerf.apply_update, tnerf.apply_update)
    jnerf.apply_update = spy("jax", saved[0])
    tnerf.apply_update = spy("port", saved[1])
    try:
        j_out = jtr._train_step_impl(
            jtr.params, jtr.opt_state, jtr.cam_params, jtr.cam_m, jtr.cam_v,
            jtr.error_map, jtr.sharpness_grid, j_err, jtr.grid.bitfield,
            jtr.grid.coarse, jtr.grid.mean, key, jtr.data, n_rays=N_RAYS,
            n_live=jnp.int32(N_LIVE))
        t_stats = ttr._train_step(draws, t_err)
    finally:
        jnerf.apply_update, tnerf.apply_update = saved
    return dict(name=request.param, ds=ds, ttr=ttr, draws=draws,
                j_stats=j_out[7], t_stats=t_stats, caught=caught,
                t_plain=t_plain)


def test_capture_step_loss_counts_and_grads_match_jax(capture_step):
    c = capture_step
    j_stats, t_stats = c["j_stats"], c["t_stats"]
    print(f"{c['name']}: loss jax {float(j_stats.loss):.6e} port "
          f"{float(t_stats.loss):.6e}; samples {t_stats.total}")
    assert t_stats.total > 1000
    assert t_stats.total == int(j_stats.measured_samples_uncompacted)
    assert t_stats.seg_total == int(j_stats.surviving_segments)
    assert int(t_stats.n_rays_with_samples) == int(
        j_stats.n_rays_with_samples)
    np.testing.assert_allclose(float(t_stats.loss), float(j_stats.loss),
                               rtol=1e-4)
    ttr = c["ttr"]
    ref = bridge.nerf_params_from_numpy(
        jax.tree.map(np.asarray, c["caught"]["jax"]), ttr.model)
    got = c["caught"]["port"]
    for k in ref:
        norm = float(torch.linalg.vector_norm(ref[k]))
        rel = float(torch.linalg.vector_norm(got[k] - ref[k])) / norm
        print(f"grad {k}: |g| {norm:.3e}, relative difference {rel:.2e}")
        assert norm > 0 and rel <= 1e-2, k
    tbl = "pos_encoding.table"
    assert torch.equal(got[tbl] == 0, ref[tbl] == 0)


def test_capture_step_takes_its_feature(capture_step):
    """Each capture's feature reaches the step: the depth term adds to the
    loss; the sidecar rays, the shutter's slerp and the F-theta lens give
    rays other than the pinhole camera's at the start transform."""
    c = capture_step
    ttr, draws = c["ttr"], c["draws"]
    if c["name"] == "depth":
        assert float(c["t_stats"].loss) > c["t_plain"] * 1.01
        return
    img, xy, _, _ = ttr._sample_pixels(ttr._error_state(), draws.u_img,
                                       draws.u_xy)
    o, d, _ = ttr._build_rays(img, xy, time=draws.time)
    pin_o, pin_d = tcam.pixel_to_ray_train(
        xy, ttr._xforms[img], ttr._focal[img], ttr._principal[img],
        ttr._resolution[img], ttr._lens_params[img], False,
        lens_mode="perspective")
    pin_d = pin_d / torch.linalg.vector_norm(pin_d, dim=-1, keepdim=True)
    moved = torch.linalg.vector_norm(d - pin_d, dim=-1) \
        + torch.linalg.vector_norm(o - pin_o, dim=-1)
    assert float(moved.mean()) > 1e-3
    if c["name"] == "ray-sidecars":
        rr = ttr._rays[ttr._pixel_index(img, xy)]
        torch.testing.assert_close(o, rr[:, :3])
        torch.testing.assert_close(
            d, rr[:, 3:] / torch.linalg.vector_norm(rr[:, 3:], dim=-1,
                                                    keepdim=True))


@pytest.mark.parametrize("lens", ["ftheta", "latlong", "perspective"])
def test_fisheye_and_equirect_skip_the_frustum_culling(lens):
    """A trainer's first occupancy grid: fisheye and equirect cameras see
    almost everywhere, so no cell is marked untrained (the reference skips
    ``mark_untrained_density_grid`` for them); a pinhole capture culls the
    cells no camera sees. The same grid as the JAX trainer's."""
    ds, cfg = sphere_scene(n_images=2)
    if lens != "perspective":
        ds = dataclasses.replace(ds, lens_mode=lens, lens_params=np.tile(
            np.float32(FTHETA), (2, 1)))
    got = tnerf.NerfTrainer(ds, cfg, device="cpu").grid.density.numpy()
    want = np.asarray(jnerf.NerfTrainer(ds, cfg).grid.density)
    np.testing.assert_array_equal(got, want)
    assert ((got < 0).any()) == (lens == "perspective")


# --------------------------------------------------------------------------
# the numerics guard
# --------------------------------------------------------------------------

def test_find_nonfinite_names_paths_as_jax():
    ok = np.ones(3, np.float32)
    tree = {"a": (ok, np.float32([1.0, np.nan])), "b": {"c": np.float32(
        [np.inf]), "d": ok}, "e": np.int32([1])}
    want = jdebug.find_nonfinite(jax.tree.map(jnp.asarray, tree), "p")
    got = tdebug.find_nonfinite(jax.tree.map(_t, tree), "p")
    assert got == want == ["p['a'][1]", "p['b']['c']"]
    with pytest.raises(FloatingPointError, match="'a'"):
        tdebug.assert_finite(jax.tree.map(_t, tree), "tree")


def test_numerics_guard_raises_with_the_parameter_name(monkeypatch):
    """Under NGP_TPU_CHECK_NUMERICS=1 a NaN density weight makes the loss
    non-finite, and the stats fetch raises FloatingPointError naming the
    parameter; without the guard the step returns its NaN loss."""
    ds, cfg = sphere_scene(n_images=2)
    tr = tnerf.NerfTrainer(ds, cfg, device="cpu", tcfg=tnerf.NerfTrainerConfig(
        n_rays=128, adapt_rays=False))
    pos = tocc.cell_center_positions(tr.max_cascade)
    tr.grid = tocc.rebuild_bitfield(tr.grid._replace(density=torch.where(
        torch.linalg.vector_norm(pos - 0.5, dim=-1) < 0.3, 5.0, 0.0)))
    with torch.no_grad():
        tr.params["density_net.weights.0"][0, 0] = float("nan")
    tr.training_step = 1            # no grid sweep before the step
    monkeypatch.delenv("NGP_TPU_CHECK_NUMERICS", raising=False)
    assert math.isnan(tr.train(1))
    monkeypatch.setenv("NGP_TPU_CHECK_NUMERICS", "1")
    with pytest.raises(FloatingPointError,
                       match=r"params\['density_net\.weights\.0'\]"):
        tr.train(1)
