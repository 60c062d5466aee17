"""Parity of the training slice's components with the JAX package, on
shared seeded inputs: training rays, the camera-visibility grid init, the
coarse mask, the partial grid sweep, the two-level training march with its
capacity semantics, pixel sampling from error-map CDFs, the sharpness maps
and the error-map CDFs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu.grid import occupancy as jocc
from ngp_tpu.rays import camera as jcam
from ngp_tpu.rays import marching as jmarch
from ngp_tpu_torch import bridge
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.rays import camera as tcam
from ngp_tpu_torch.rays import marching as tmarch
from test_torch_train_step import sphere_scene

GV = tocc.GRID_VOLUME


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lens", [None, (-0.08, 0.03, 1e-3, -2e-3)],
                         ids=["perspective", "opencv"])
def test_pixel_to_ray_train_matches_jax(lens):
    rng = np.random.default_rng(0)
    n = 4096
    xy = rng.random((n, 2), dtype=np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    xf = np.concatenate([q, rng.standard_normal((n, 3, 1))], -1).astype(
        np.float32)
    focal = (rng.random((n, 2)) * 40 + 20).astype(np.float32)
    principal = (rng.random((n, 2)) * 0.2 + 0.4).astype(np.float32)
    res = np.float32(rng.integers(16, 64, (n, 2)))
    lp = np.zeros((n, 4), np.float32) if lens is None else \
        np.tile(np.float32(lens), (n, 1))
    j_o, j_d = jcam.pixel_to_ray_train(xy, xf, focal, principal, res, lp,
                                       lens is not None)
    t_o, t_d = tcam.pixel_to_ray_train(*map(_t, (xy, xf, focal, principal,
                                                 res, lp)), lens is not None)
    np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-6,
                               atol=1e-6)
    # the F-theta and LatLong lenses are ported (test_torch_captures.py);
    # an unknown lens mode raises
    with pytest.raises(ValueError, match="lens mode"):
        tcam.pixel_to_ray_train(*map(_t, (xy, xf, focal, principal, res, lp)),
                                False, lens_mode="fisheye")


def test_mark_untrained_and_coarse_mask_exact():
    ds, _ = sphere_scene(n_images=5)
    mc = 1
    j_d = np.asarray(jocc.mark_untrained(mc, jnp.asarray(ds.xforms),
                                         jnp.asarray(ds.focal),
                                         jnp.asarray(ds.resolution)))
    t_d = tocc.mark_untrained(mc, _t(ds.xforms), _t(ds.focal),
                              _t(ds.resolution).float()).numpy()
    np.testing.assert_array_equal(t_d, j_d)
    assert 0.001 < (j_d < 0).mean() < 0.999
    # the coarse mask of a sparse density (bitfield exact already tested)
    rng = np.random.default_rng(1)
    dens = np.where(rng.random(GV * (mc + 1)) < 2e-4, 0.5, 0.0).astype(
        np.float32)
    jg = jocc.rebuild_bitfield(jocc.init_grid(mc)._replace(
        density=jnp.asarray(dens)), mc)
    tg = tocc.rebuild_bitfield(tocc.init_grid(mc)._replace(
        density=torch.from_numpy(dens)))
    np.testing.assert_array_equal(tg.bitfield.numpy(), np.asarray(jg.bitfield))
    np.testing.assert_array_equal(tg.coarse.numpy(), np.asarray(jg.coarse))
    assert 0.01 < np.asarray(jg.coarse).mean() < 0.99
    # lookups on the mask, in and past the ends of the cascades
    pos = rng.random((20000, 3), dtype=np.float32) * 6 - 2.5
    mip = rng.integers(0, 8, 20000).astype(np.int32)
    np.testing.assert_array_equal(
        tocc.coarse_occupied_at(tg.coarse, _t(pos), _t(mip)).numpy(),
        np.asarray(jocc.coarse_occupied_at(jg.coarse, pos, mip)))
    np.testing.assert_array_equal(
        tocc.cell_idx_at(_t(pos), _t(mip)).numpy(),
        np.asarray(jocc.cell_idx_at(pos, mip)))


@pytest.mark.parametrize("ema_step", [0, 3])
def test_partial_sweep_exact(ema_step):
    """The interleaved slab sweep, with the jitter the JAX sweep draws
    handed to the port: equal density, bitfield and coarse mask."""
    mc = 1
    rng = np.random.default_rng(2)
    init = (rng.random(GV * (mc + 1)) * 0.05).astype(np.float32)
    init[rng.random(init.size) < 0.1] = -1.0

    def field(w):        # σ·Δt well above the 0.01 threshold on average
        return 400.0 * w[:, 0] * w[:, 1]
    key = jax.random.PRNGKey(ema_step)
    jg = jocc.init_grid(mc)._replace(density=jnp.asarray(init),
                                     ema_step=jnp.int32(ema_step))
    jg = jocc.update_grid(jg, field, key, mc, aabb_min=np.float32(-0.5),
                          aabb_size=np.float32(2.0))
    n = (mc + 1) * tocc.G // 4 * tocc.G * tocc.G    # every 4th z-slab
    u = jax.random.uniform(jax.random.split(key)[0], (n, 3))
    tg = tocc.init_grid(mc)._replace(density=torch.from_numpy(init.copy()),
                                     ema_step=ema_step)
    tg = tocc.update_grid(tg, field, None, mc, aabb_min=-0.5, aabb_size=2.0,
                          jitter=_t(u))
    assert tg.ema_step == int(jg.ema_step) == ema_step + 1
    td, jd = tg.density.numpy(), np.asarray(jg.density)
    np.testing.assert_array_equal(td, jd)
    assert float(jg.mean) > 0.01
    np.testing.assert_array_equal(tg.bitfield.numpy(), np.asarray(jg.bitfield))
    np.testing.assert_array_equal(tg.coarse.numpy(), np.asarray(jg.coarse))
    # a quarter of the slabs were swept, every trained cell decayed
    trained = init >= 0
    swept = td[trained] != init[trained] * np.float32(0.95)
    assert 0.2 < swept.mean() <= 0.25
    np.testing.assert_array_equal(td[init < 0], -1.0)


@pytest.fixture(scope="module")
def march_scene():
    """A density that keeps clear of the threshold, its JAX bitfield and
    coarse mask, and rays into the aabb_scale 2 box."""
    mc = 1
    rng = np.random.default_rng(3)
    dens = (rng.random(GV * (mc + 1)) * 0.05).astype(np.float32)
    dens[rng.random(dens.size) < 0.6] = 0.0
    jg = jocc.rebuild_bitfield(jocc.init_grid(mc)._replace(
        density=jnp.asarray(dens)), mc)
    n = 256
    o = (rng.random((n, 3)) * 5 - 2).astype(np.float32)
    d = rng.random((n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(mc=mc, grid=jg, o=o, d=d.astype(np.float32),
                mask=rng.random(n) < 0.9)


def _hier(scene, capacity, key):
    jg, n, mc = scene["grid"], scene["o"].shape[0], scene["mc"]
    args = (scene["o"], scene["d"])
    common = (n, 1024, 1.0 / 256.0, mc)
    j = jmarch.march_and_compact_hier(
        jg.bitfield, jg.coarse, *args, key, *common, np.float32(-0.5),
        np.float32(2.0), capacity, ray_mask=jnp.asarray(scene["mask"]))
    u = jax.random.uniform(key, (n,))
    t = tmarch.march_and_compact_hier(
        _t(jg.bitfield), _t(jg.coarse), *map(_t, args), _t(u), *common,
        -0.5, 2.0, capacity, ray_mask=_t(scene["mask"]))
    return j, t


@pytest.mark.parametrize("case", ["fits", "sample_cap", "segment_cap"])
def test_march_and_compact_hier_matches_jax(march_scene, case):
    key = jax.random.PRNGKey(4)
    j, _ = _hier(march_scene, 1 << 18, key)
    segs, total = int(j[7]), int(j[6])
    capacity = {"fits": 1 << 18,
                # segment budget holds every segment, samples overflow
                "sample_cap": (2 * segs // 8 + 2) * 8,
                # segment budget (capacity // 8 * 4) overflows
                "segment_cap": (segs // 8) * 8}[case]
    j, t = _hier(march_scene, capacity, key)
    s_t, s_dt, s_ray, counts, t_total, t_segs, s_k = t
    assert (t_total, t_segs) == (int(j[6]), int(j[7]))
    # the segment total is taken before the segment cap, the sample total
    # after it (over the segments of the rays kept) and before the sample cap
    assert t_segs == segs
    assert t_total < total if case == "segment_cap" else t_total == total
    kept = int((np.asarray(j[2]) < march_scene["o"].shape[0]).sum())
    assert s_ray.numel() == kept
    if case == "fits":
        assert kept == total
    elif case == "sample_cap":
        assert segs <= capacity // 8 * 4 and capacity - 8 < kept <= capacity
    else:
        assert segs > capacity // 8 * 4 and kept < total
    np.testing.assert_array_equal(s_ray.numpy(), np.asarray(j[2])[:kept])
    np.testing.assert_array_equal(s_k.numpy(), np.asarray(j[8])[:kept])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j[3]))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(j[0])[:kept],
                               rtol=2e-6)
    np.testing.assert_allclose(s_dt.numpy(), np.asarray(j[1])[:kept],
                               rtol=2e-6)


@pytest.mark.parametrize("capped", [False, True], ids=["fits", "capped"])
def test_flat_march_and_compact_matches_jax(march_scene, capped):
    """``hierarchical_march=False``: whole rays dropped past the cap."""
    jg, mc = march_scene["grid"], march_scene["mc"]
    o, d, mask = march_scene["o"], march_scene["d"], march_scene["mask"]
    n, key = o.shape[0], jax.random.PRNGKey(5)
    common = (n, 1024, 1.0 / 256.0, mc)
    jt, jdt, jemit = jmarch.march_rays(jg.bitfield, o, d, key, *common,
                                       np.float32(-0.5), np.float32(2.0))
    jemit = jemit & jnp.asarray(mask)[:, None]
    capacity = int(jemit.sum()) // 2 if capped else 1 << 18
    j = jmarch.compact_samples(jt, jdt, jemit, n, capacity)
    u = jax.random.uniform(key, (n,))
    s_t, s_dt, s_ray, counts, total, segs, s_k = tmarch.march_and_compact(
        _t(jg.bitfield), _t(o), _t(d), _t(u), *common, -0.5, 2.0, capacity,
        ray_mask=_t(mask))
    kept = int((np.asarray(j[2]) < n).sum())
    assert (total, segs) == (int(j[6]), 0)
    assert s_ray.numel() == kept and (kept < total) == capped
    np.testing.assert_array_equal(s_ray.numpy(), np.asarray(j[2])[:kept])
    np.testing.assert_array_equal(s_k.numpy(), np.asarray(j[7])[:kept])
    j_counts = np.where(np.asarray(j[5]), np.asarray(j[3]), 0)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(j[0])[:kept],
                               rtol=2e-6)
    np.testing.assert_allclose(s_dt.numpy(), np.asarray(j[1])[:kept],
                               rtol=2e-6)


@pytest.fixture(scope="module")
def trainers():
    ds, cfg = sphere_scene(n_images=6)
    kw = dict(n_rays=512, sample_image_proportional_to_error=True,
              sample_focal_plane_proportional_to_error=True)
    return (ds, jnerf.NerfTrainer(ds, cfg, tcfg=jnerf.NerfTrainerConfig(**kw)),
            tnerf.NerfTrainer(ds, cfg, tcfg=tnerf.NerfTrainerConfig(**kw),
                              device="cpu"))


def test_trainer_init_state_matches_jax(trainers):
    """The camera-visibility grid, the sharpness maps (1e-6) and the
    error-map CDFs of a seeded error map (1e-6)."""
    ds, jtr, ttr = trainers
    np.testing.assert_array_equal(ttr.grid.density.numpy(),
                                  np.asarray(jtr.grid.density))
    np.testing.assert_allclose(tnerf._sharpness_maps(ds),
                               jnerf._sharpness_maps(ds), rtol=1e-6,
                               atol=1e-9)
    assert tnerf._sharpness_maps(ds).max() > 0
    em = (np.random.default_rng(5).random(jtr.error_map.shape) ** 3).astype(
        np.float32)
    jtr.error_map, ttr.error_map = jnp.asarray(em), torch.from_numpy(em)
    j_es, t_es = jtr._error_state(), ttr._error_state()
    # CDFs run over [0, 1]; the two frameworks' cumsums associate
    # differently, which moves small entries by a few 1e-9
    for k in ("cdf_x", "cdf_y", "cdf_img"):
        np.testing.assert_allclose(t_es[k].numpy(), np.asarray(j_es[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("importance", [(False, False), (True, True)],
                         ids=["uniform", "error_cdf"])
def test_sample_pixels_matches_jax(trainers, importance):
    """Given the JAX draws (``nerf.py:340`` split, uniforms for the image,
    and the uniform image index as (k + 0.5)/I), the same images exactly
    and xy, texel and pdf to 1e-6."""
    ds, jtr, ttr = trainers
    n = 512
    for tr in (jtr, ttr):
        tr.tcfg.sample_image_proportional_to_error = importance[0]
        tr.tcfg.sample_focal_plane_proportional_to_error = importance[1]
    rng = np.random.default_rng(6)
    em = (rng.random(jtr.error_map.shape) ** 4).astype(np.float32)
    jtr.error_map = jnp.asarray(em)
    j_es = jtr._error_state()
    key = jax.random.PRNGKey(8)
    j_img, j_xy, j_tex, j_pdf = jtr._sample_pixels(jtr.data, j_es, key, n)
    k_img, k_xy, _ = jax.random.split(key, 3)
    u_img = np.asarray(jax.random.uniform(k_img, (n,)) if importance[0] else
                       (np.asarray(j_img) + 0.5) / ds.n_images, np.float32)
    u_xy = jax.random.uniform(k_xy, (n, 2))
    t_es = {k: _t(v) for k, v in j_es.items()}
    img, xy, tex, pdf = ttr._sample_pixels(t_es, _t(u_img), _t(u_xy))
    np.testing.assert_array_equal(img.numpy(), np.asarray(j_img))
    for got, ref in [(xy, j_xy), (tex, j_tex), (pdf, j_pdf)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
    if importance[0]:
        assert (np.asarray(j_pdf) != 1.0).any()


@pytest.mark.parametrize("mode", ["dynamic", "adapt", "adapt_capacity"])
def test_fetch_stats_adapts_like_jax(trainers, mode):
    """The ray-count (live count under ``dynamic_rays``) and capacity
    adaptation from one boundary's counts, in the regimes where the sample
    count or the segment budget binds."""
    _, jtr, ttr = trainers
    for measured, segs in [(1 << 15, 1 << 12), (1 << 19, 1 << 12),
                           (1 << 16, 1 << 17), (70000, 0)]:
        out = []
        for tr in (jtr, ttr):
            tr.tcfg.dynamic_rays = mode == "dynamic"
            tr.tcfg.adapt_rays = mode != "dynamic"
            tr.tcfg.adapt_capacity = mode == "adapt_capacity"
            tr.tcfg.n_rays = 4096
            tr._n_live, tr._rays_floor = 1000, 256
            tr._seg_capacity = tr.tcfg.target_batch_size // 8 * 4
            tr._capacity = tr.tcfg.target_batch_size
            tr.training_step = 600
            tr._warned_segcap = True
            loss = tr._fetch_stats(0.5, measured, segs, 4096)
            out.append((loss, tr.tcfg.n_rays, tr._n_live, tr._capacity,
                        tr.last_surviving_segments))
        assert out[0] == out[1], (mode, measured, segs, out)


def test_grid_and_adam_state_round_trip_through_bridge(trainers):
    """Port → JAX OccupancyGrid / AdamState → port, unchanged."""
    from ngp_tpu.opt.optimizers import AdamState as JAdamState
    _, _, ttr = trainers
    g = ttr.grid._replace(ema_step=5)
    j_grid = jocc.OccupancyGrid(**{k: jnp.asarray(v) for k, v in
                                   bridge.grid_to_numpy(g).items()})
    back = bridge.grid_from_numpy(**jax.tree.map(np.asarray,
                                                 j_grid._asdict()))
    for f in ("density", "bitfield", "mean", "coarse"):
        assert torch.equal(getattr(back, f), getattr(g, f)), f
    assert back.ema_step == 5
    st = ttr.opt_state._replace(step=3)
    j_state = JAdamState(**jax.tree.map(jnp.asarray, bridge.adam_state_to_numpy(
        st, ttr.model)))
    assert j_state.step.dtype == jnp.int32
    back = bridge.adam_state_from_numpy(
        *jax.tree.map(np.asarray, (j_state.step, j_state.mu, j_state.nu,
                                   j_state.ema_params)), ttr.model)
    assert back.step == 3
    for f in ("mu", "nu", "ema_params"):
        for k, v in getattr(st, f).items():
            assert torch.equal(getattr(back, f)[k], v), (f, k)
