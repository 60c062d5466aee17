"""Every static render option of the port's ``NerfRenderer`` against the JAX
package's on the same parameters and a full occupancy bitfield: each
render mode (POSITIONS with and without ``show_accel``), glow, the tonemap
curves, exposure, the crop box and the distortion sampler. Frames agree
to a mean |Δ| of 2e-4 (the render tolerance of the slice tests), times
the frame's mean magnitude where a visualisation exceeds 1. NORMALS
needs no looser bound: its density gradient (K3's work on the card) goes
through the same f32 table in both packages.

JAX's random draws cannot be fed to the port's render, so depth of field
and motion blur are held at the ray generation: the port's ``_gen_rays``
takes the draws that ``jax.random.split(key, 3)`` gives inside JAX's
(1e-6). An aperture of 0 and an end camera equal to the start give the
static frame exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.common import RenderMode as JRenderMode
from ngp_tpu.common import TonemapCurve as JTonemapCurve
from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.nn.trainable_buffer import DistortionGrid as JDistortionGrid
from ngp_tpu.render.nerf_render import NerfRenderer as JRenderer
from ngp_tpu.render.nerf_render import RenderOptions as JOptions
from ngp_tpu_torch import bridge
from ngp_tpu_torch.common import RenderMode, TonemapCurve
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.nn.trainable_buffer import DistortionGrid
from ngp_tpu_torch.render.nerf_render import NerfRenderer as TRenderer
from ngp_tpu_torch.render.nerf_render import RayDraws
from ngp_tpu_torch.render.nerf_render import RenderOptions as TOptions

W, H, FOCAL = 10, 8, 9.0
OPTS = dict(width=W, height=H, fov_axis_focal=FOCAL, chunk=256,
            march_steps=512, background=(0.1, 0.2, 0.3, 0.0),
            linear_out=True)
RENDER_TOL = 2e-4
N_BYTES = 8 * 128 ** 3 // 8          # NERF_CASCADES · 128³ / 8


def _camera(angle, radius=1.3):
    """NGP camera→world (x right, y down, z forward) looking at 0.5³."""
    fwd = np.array([np.cos(angle), np.sin(angle), 0.3])
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, 0.5 - radius * fwd],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Tiny network (4 levels, log2_hashmap_size 12, aabb_scale 1) with a
    unit-variance table and a boosted density output, in both packages."""
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
    w[:, 0] *= 4.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    tm = TNerfNetwork(cfg, aabb_scale=1)
    dist = (0.02 * rng.standard_normal((32, 32, 2))).astype(np.float32)
    return dict(jm=jm, tree=tree, tm=tm,
                params=bridge.nerf_params_from_numpy(tree, tm), dist=dist,
                cam=_camera(0.6))


def _pair(scene, **kw):
    """The JAX and the port's frame of ``scene`` with options ``kw``."""
    jdist = tdist = None
    if kw.pop("distortion", False):
        jg, tg = JDistortionGrid((32, 32)), DistortionGrid((32, 32))
        jd, td = jnp.asarray(scene["dist"]), torch.from_numpy(scene["dist"])

        def jdist(uv):
            return jg.sample(jd, uv)

        def tdist(uv):
            return tg.sample(td, uv)
    j_kw = dict(kw)
    if "render_mode" in kw:
        j_kw["render_mode"] = JRenderMode[kw["render_mode"].name]
    if "tonemap_curve" in kw:
        j_kw["tonemap_curve"] = JTonemapCurve(kw["tonemap_curve"].value)
    jr = JRenderer(scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
                   JOptions(**{**OPTS, **j_kw}), distortion_sampler=jdist)
    ref = jr.render(scene["tree"], jnp.full((N_BYTES,), 255, jnp.uint8),
                    scene["cam"], W, H, focal=(FOCAL, FOCAL), spp=1)
    tr = TRenderer(scene["tm"], 0.0, 1.0, 0.0, 0, TOptions(**{**OPTS, **kw}),
                   distortion_sampler=tdist)
    got = tr.render(scene["params"], torch.full((N_BYTES,), 255,
                                                dtype=torch.uint8),
                    scene["cam"], W, H, focal=(FOCAL, FOCAL), spp=1)
    return np.asarray(ref), got.numpy()


def _assert_close(got, ref, tol=RENDER_TOL):
    """Mean |Δ| ≤ tol on frames in [0, 1]; relative to the frame's mean
    magnitude where a visualisation mode exceeds 1 (ENCODING_VIS shows
    16·|feature| through the sRGB → linear power, DEPTH and COST their
    raw values)."""
    assert got.shape == ref.shape == (H, W, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    scale = max(1.0, float(np.abs(ref).mean()))
    print(f"mean |Δ| {err.mean():.3e}, max {err.max():.3e}, frame scale "
          f"{scale:.3e}")
    assert err.mean() <= tol * scale


MODES = [dict(render_mode=m) for m in RenderMode
         if m != RenderMode.SHADE] + [
    dict(render_mode=RenderMode.POSITIONS, show_accel=0),
    dict(render_mode=RenderMode.DISTORTION, distortion=True),
    dict(render_mode=RenderMode.SLICE, slice_plane_z=0.1),
    # in the network's space: 16·|feature| runs to ~50, where the sRGB →
    # linear power magnifies the compositing's rounding 2.4 times over
    dict(render_mode=RenderMode.ENCODING_VIS, visualized_level=2,
         linear_out=False),
    dict(glow_mode=1 | 2 | 4 | 8, glow_y_cutoff=0.6),
    dict(glow_mode=16 | 4),
    dict(render_aabb_min=(0.2, 0.1, 0.3), render_aabb_max=(0.8, 0.7, 0.6)),
]


def _mode_id(kw):
    return "-".join(f"{k}={getattr(v, 'name', v)}" for k, v in kw.items())


@pytest.mark.parametrize("kw", MODES, ids=[_mode_id(k) for k in MODES])
def test_render_option_matches_jax(scene, kw):
    got, ref = _pair(scene, **kw)[::-1]
    _assert_close(got, ref)


def test_shade_with_every_tonemap_curve_and_exposure_matches_jax(scene):
    """One renderer per package; the curve and the exposure apply after
    the chunks, so each is switched on the same renderer."""
    jr = JRenderer(scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
                   JOptions(**OPTS))
    tr = TRenderer(scene["tm"], 0.0, 1.0, 0.0, 0, TOptions(**OPTS))
    jbits = jnp.full((N_BYTES,), 255, jnp.uint8)
    tbits = torch.full((N_BYTES,), 255, dtype=torch.uint8)
    for curve in TonemapCurve:
        for exposure in (0.0, 1.5):
            jr.opts.tonemap_curve = JTonemapCurve(curve.value)
            jr.opts.exposure = tr.opts.exposure = exposure
            tr.opts.tonemap_curve = curve
            ref = jr.render(scene["tree"], jbits, scene["cam"], W, H,
                            focal=(FOCAL, FOCAL), spp=1)
            got = tr.render(scene["params"], tbits, scene["cam"], W, H,
                            focal=(FOCAL, FOCAL), spp=1).numpy()
            _assert_close(got, np.asarray(ref))


@pytest.mark.parametrize("aperture,motion,rshutter", [
    (0.05, False, (0.0, 0.0, 0.0, 1.0)),
    (0.0, True, (0.0, 0.0, 0.0, 1.0)),
    (0.03, True, (0.1, 0.3, 0.2, 0.4)),
], ids=["dof", "motion", "dof-rolling-shutter"])
def test_ray_generation_with_jax_draws(aperture, motion, rshutter):
    """The port's rays from the draws JAX's ``_gen_rays`` makes inside:
    jitter, shutter time and lens sample from ``split(key, 3)``."""
    n = W * H
    start, end = _camera(0.4), _camera(0.9, radius=1.6)
    opts = dict(principal=(0.47, 0.53), aperture_size=aperture,
                focus_z=1.2)
    key = jax.random.PRNGKey(7)
    jr = JRenderer(None, np.float32(0.0), np.float32(1.0), 0.0, 0,
                   JOptions(**opts))
    j_o, j_d, j_u, j_v = jr._gen_rays(
        key, 0, n, W, H, jnp.float32(FOCAL), jnp.float32(FOCAL),
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(rshutter), True,
        motion)
    kj, kt, ka = jax.random.split(key, 3)
    draws = RayDraws(
        torch.from_numpy(np.array(jax.random.uniform(kj, (n, 2)))),
        torch.from_numpy(np.array(jax.random.uniform(kt, (n,))))
        if motion else None,
        torch.from_numpy(np.array(jax.random.uniform(ka, (n, 2))))
        if aperture > 0 else None)
    tr = TRenderer(None, 0.0, 1.0, 0.0, 0, TOptions(**opts))
    t_o, t_d, t_u, t_v = tr._gen_rays(0, n, W, H, FOCAL, FOCAL,
                                      torch.from_numpy(start), draws,
                                      torch.from_numpy(end), rshutter)
    np.testing.assert_allclose(t_u.numpy(), np.asarray(j_u), atol=1e-6)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), atol=1e-6)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), atol=1e-6)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-6)


def test_zero_aperture_and_still_camera_give_the_static_frame(scene):
    tbits = torch.full((N_BYTES,), 255, dtype=torch.uint8)
    cam = scene["cam"]

    def frame(end=None, **kw):
        r = TRenderer(scene["tm"], 0.0, 1.0, 0.0, 0,
                      TOptions(**{**OPTS, **kw}))
        return r.render(scene["params"], tbits, cam, W, H,
                        focal=(FOCAL, FOCAL), spp=2, seed=3,
                        camera_matrix_end=end)
    static = frame()
    assert torch.equal(frame(end=cam.copy()), static)
    assert torch.equal(frame(aperture_size=0.0, focus_z=2.0), static)
    # and a real aperture or camera motion does change it
    assert not torch.equal(frame(aperture_size=0.05), static)
    assert not torch.equal(frame(end=_camera(0.8)), static)


def test_dof_and_motion_blur_frames_are_finite(scene):
    tbits = torch.full((N_BYTES,), 255, dtype=torch.uint8)
    opts = dataclasses.replace(TOptions(**OPTS), aperture_size=0.04,
                               focus_z=1.3)
    img = TRenderer(scene["tm"], 0.0, 1.0, 0.0, 0, opts).render(
        scene["params"], tbits, scene["cam"], W, H, focal=(FOCAL, FOCAL),
        spp=3, camera_matrix_end=_camera(0.75),
        rolling_shutter=(0.0, 0.2, 0.0, 0.8))
    assert img.shape == (H, W, 4) and torch.isfinite(img).all()
    assert float(img[..., 3].min()) >= 0.0 and float(img[..., 3].max()) <= 1.0


def test_ray_sums_match_a_scatter_add():
    """The renderer's per-ray sums (a lattice written once per sample, then
    reduced per ray: the same bits on every run, on the card too) against
    ``index_add_``."""
    from ngp_tpu_torch.rays.marching import ray_sums
    rng = np.random.default_rng(8)
    emit = torch.from_numpy(rng.random((37, 64)) < 0.3)
    s_ray, s_k = emit.nonzero(as_tuple=True)
    vals = torch.from_numpy(rng.standard_normal((s_ray.numel(), 3)).astype(
        np.float32))
    want = torch.zeros((37, 3)).index_add_(0, s_ray, vals)
    torch.testing.assert_close(ray_sums(vals, s_ray, s_k, 37, 64), want,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ray_sums(vals[:, 0], s_ray, s_k, 37, 64),
                               want[:, 0], atol=1e-6, rtol=1e-6)
