"""The whole render slice against the JAX package: the same parameters
and the same occupancy density go through ``NerfRenderer.render`` in both
packages, once handed over directly and once through a snapshot written
by the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.grid import occupancy as jocc
from ngp_tpu.io.snapshot import load_snapshot as j_load_snapshot
from ngp_tpu.io.snapshot import save_snapshot
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.render.nerf_render import NerfRenderer as JRenderer
from ngp_tpu.render.nerf_render import RenderOptions as JOptions
from ngp_tpu_torch import bridge
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.io.snapshot import load_snapshot
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.render.nerf_render import NerfRenderer as TRenderer
from ngp_tpu_torch.render.nerf_render import RenderOptions as TOptions

RES, FOCAL = 32, 32.0
OPTS = dict(width=RES, height=RES, fov_axis_focal=FOCAL, chunk=256,
            march_steps=1024, background=(0.1, 0.2, 0.3, 0.0),
            linear_out=True)


def _orbit_camera(angle, radius=1.4):
    """NGP camera→world (x right, y down, z forward) looking at 0.5³."""
    fwd = np.array([np.cos(angle), np.sin(angle), 0.25])
    fwd /= np.linalg.norm(fwd)
    eye = 0.5 - radius * fwd
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Tiny scene (4 levels, log2_hashmap_size 12, aabb_scale 1): JAX params
    with a unit-variance table and a boosted density output, so the grid
    holds both empty and dense space; its density from the JAX full sweep;
    and the JAX render of it."""
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

    @jax.jit
    def sweep(params, key):
        def density_fn(x):   # 2^18-sample chunks, like the trainer
            n, c = x.shape[0], 1 << 18
            xs = jnp.pad(x, ((0, (-n) % c), (0, 0))).reshape(-1, c, 3)
            return jax.lax.map(lambda b: jm.density(params, b),
                               xs).reshape(-1)[:n]
        return jocc.update_grid(jocc.init_grid(0), density_fn, key, 0,
                                n_uniform=jocc.GRID_VOLUME, n_nonuniform=1)
    grid = sweep(tree, jax.random.PRNGKey(1))
    # threshold = NERF_MIN_OPTICAL_THICKNESS, not a mean summed in a
    # framework-specific order: the bitfields can then agree exactly
    assert float(grid.mean) > 0.01
    renderer = JRenderer(jm, np.float32(0.0), np.float32(1.0), 0.0, 0,
                         JOptions(**OPTS))
    cam = _orbit_camera(0.4)
    img = renderer.render(tree, grid.bitfield, cam, RES, RES,
                          focal=(FOCAL, FOCAL), spp=1)
    return dict(cfg=cfg, tree=tree, density=np.asarray(grid.density),
                bitfield=np.asarray(grid.bitfield), renderer=renderer,
                cam=cam, img=img)


def _assert_render_close(got, ref):
    """Per-pixel statistics: bf16 re-rounding in the MLPs and ulp
    differences of exp/log1p in the march move a few samples slightly."""
    assert got.shape == ref.shape == (RES, RES, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    within = (err <= 2e-3).all(-1).mean()
    print(f"render: mean |Δ| {err.mean():.3e}, max {err.max():.3e}, "
          f"{within:.4f} of pixels within 2e-3")
    assert err.mean() <= 2e-4
    assert within >= 0.995


def _port_render(cfg, tree, density, cam):
    model = TNerfNetwork(cfg, aabb_scale=1)
    params = bridge.nerf_params_from_numpy(tree, model)
    grid = tocc.rebuild_bitfield(tocc.init_grid(0)._replace(
        density=torch.from_numpy(np.array(density, np.float32))))
    r = TRenderer(model, 0.0, 1.0, 0.0, 0, TOptions(**OPTS))
    img = r.render(params, grid.bitfield, cam, RES, RES,
                   focal=(FOCAL, FOCAL), spp=1)
    assert r.last_n_samples > 0
    return grid.bitfield.numpy(), img.numpy()


def test_render_matches_jax(scene):
    bf, img = _port_render(scene["cfg"], scene["tree"], scene["density"],
                           scene["cam"])
    np.testing.assert_array_equal(bf, scene["bitfield"])
    ref = scene["img"]
    assert 0.05 < ref[..., 3].mean() < 0.95   # both empty and opaque rays
    _assert_render_close(img, ref)


def test_render_from_jax_snapshot_matches_jax(scene, tmp_path):
    path = tmp_path / "scene.msgpack"
    save_snapshot(path, scene["cfg"], scene["tree"], scene["tree"],
                  density_grid=scene["density"], max_cascade=0, aabb_scale=1,
                  aabb_min=np.zeros(3), aabb_max=np.ones(3))
    doc = load_snapshot(path)
    snap = doc.pop("snapshot")
    assert snap["nerf"]["aabb_scale"] == 1 and snap["max_cascade"] == 0
    cam = _orbit_camera(2.0)
    bf, img = _port_render(doc, snap["ngp_tpu_ema_params"],
                           snap["density_grid"], cam)
    # the JAX side renders what its own loader reads (fp16 density grid)
    j_dens = j_load_snapshot(path)["snapshot"]["density_grid"]
    j_bf = jocc.rebuild_bitfield(jocc.init_grid(0)._replace(
        density=jnp.asarray(j_dens)), 0).bitfield
    np.testing.assert_array_equal(bf, np.asarray(j_bf))
    ref = scene["renderer"].render(scene["tree"], j_bf, cam, RES, RES,
                                   focal=(FOCAL, FOCAL), spp=1)
    _assert_render_close(img, ref)


def test_unported_render_options_raise(scene):
    """Every render option is ported: the lenses, quilting, parallax and
    the envmap (tests/test_torch_render_lenses.py) and the wave renderers
    (tests/test_torch_wave_render.py); an unknown lens mode or int8 mode is
    refused."""
    model = TNerfNetwork(scene["cfg"], aabb_scale=1)
    for ok in (dict(lens_mode="ftheta"), dict(lens_mode="latlong"),
               dict(quilting_dims=(2, 1)),
               dict(parallax_shift=(0.05, 0.0, 0.0))):
        TRenderer(model, 0.0, 1.0, 0.0, 0, TOptions(**OPTS, **ok),
                  envmap_sampler=lambda d: d)
    with pytest.raises(ValueError, match="lens mode"):
        TRenderer(model, 0.0, 1.0, 0.0, 0, TOptions(**OPTS,
                                                    lens_mode="fisheye"))
    with pytest.raises(ValueError, match="int8"):
        TRenderer(model, 0.0, 1.0, 0.0, 0, TOptions(**OPTS),
                  encode_int8="half")


@pytest.mark.parametrize("lens", [(0.0, 0.0, 0.0, 0.0),
                                  (-0.08, 0.03, 1e-3, -2e-3)],
                         ids=["perspective", "opencv"])
def test_ray_generation_matches_jax(lens):
    W, H, fx, fy = 40, 24, 35.0, 33.0
    opts = dict(principal=(0.47, 0.53), lens_params=lens)
    cam = _orbit_camera(1.1)
    jr = JRenderer(None, np.float32(0.0), np.float32(1.0), 0.0, 0,
                   JOptions(**opts))
    j_o, j_d, _, _ = jr._gen_rays(
        jax.random.PRNGKey(0), 0, W * H, W, H, jnp.float32(fx),
        jnp.float32(fy), jnp.asarray(cam), jnp.asarray(cam),
        jnp.asarray((0.0, 0.0, 0.0, 1.0)), False, False)
    tr = TRenderer(None, 0.0, 1.0, 0.0, 0, TOptions(**opts))
    t_o, t_d, _, _ = tr._gen_rays(0, W * H, W, H, fx, fy,
                                  torch.from_numpy(cam))
    np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
    # the 3-term camera rotation and the norm may round differently
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-6,
                               atol=1e-7)
