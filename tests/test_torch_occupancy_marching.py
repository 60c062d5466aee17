"""Parity of the port's occupancy grid and marching/compositing
(ngp_tpu_torch/grid/occupancy.py, ngp_tpu_torch/rays/marching.py) with
the JAX package, on shared seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.grid import occupancy as jocc
from ngp_tpu.rays import marching as jmarch
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.rays import marching as tmarch

GV = tocc.GRID_VOLUME


def _density(max_cascade, mean_below_floor, seed=0):
    """A seeded density whose values keep clear of the threshold, so the
    two frameworks' f32 means (summed in different orders) cannot put a
    cell on different sides of it. Includes untrained (-1) cells."""
    rng = np.random.default_rng(seed)
    n = GV * (max_cascade + 1)
    if mean_below_floor:   # threshold = the mean (≈ 0.005), values 0/1e-3/0.1
        vals = rng.choice(np.float32([0.0, 1e-3, 0.1, -1.0]), n,
                          p=[0.5, 0.43, 0.05, 0.02])
    else:                  # threshold = NERF_MIN_OPTICAL_THICKNESS exactly
        vals = rng.random(n, dtype=np.float32) * np.float32(0.05)
        vals[rng.random(n) < 0.02] = -1.0
    return vals.astype(np.float32)


@pytest.mark.parametrize("max_cascade,below", [(0, True), (0, False),
                                               (2, True), (2, False)])
def test_rebuild_bitfield_bit_exact(max_cascade, below):
    dens = _density(max_cascade, below, seed=max_cascade)
    jg = jocc.init_grid(max_cascade)._replace(density=jnp.asarray(dens))
    jb = np.asarray(jocc.rebuild_bitfield(jg, max_cascade).bitfield)
    tg = tocc.init_grid(max_cascade)._replace(density=torch.from_numpy(dens))
    tg = tocc.rebuild_bitfield(tg)
    assert tg.bitfield.dtype == torch.uint8
    np.testing.assert_array_equal(tg.bitfield.numpy(), jb)
    assert jb.any()


def test_morton_round_trip_matches_jax():
    d = np.random.default_rng(0).random(2 * GV, dtype=np.float32)
    m = tocc.density_to_morton(d)
    np.testing.assert_array_equal(m, jocc.density_to_morton(d))
    np.testing.assert_array_equal(tocc.density_from_morton(m), d)
    np.testing.assert_array_equal(tocc.density_from_morton(m),
                                  jocc.density_from_morton(m))


def test_occupied_at_and_mips_exact():
    rng = np.random.default_rng(1)
    bitfield = rng.integers(0, 256, tocc.NERF_CASCADES * GV // 8,
                            dtype=np.uint8)
    pos = (rng.random((20000, 3), dtype=np.float32) * 6 - 2.5)
    dt = (rng.random(20000, dtype=np.float32) * 0.05).astype(np.float32)
    for mc in (0, 2, 7):
        t_mip = tocc.mip_from_dt(torch.from_numpy(dt), torch.from_numpy(pos),
                                 mc)
        j_mip = jocc.mip_from_dt(dt, pos, mc)
        np.testing.assert_array_equal(t_mip.numpy(), np.asarray(j_mip))
        got = tocc.occupied_at(torch.from_numpy(bitfield),
                               torch.from_numpy(pos), t_mip)
        ref = jocc.occupied_at(jnp.asarray(bitfield), pos, j_mip)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # indices past either end clamp like take(mode="clip")
    far = np.float32([[-1e3, -1e3, -1e3], [1e3, 1e3, 1e3]])
    mip = np.int32([0, 7])
    np.testing.assert_array_equal(
        tocc.occupied_at(torch.from_numpy(bitfield), torch.from_numpy(far),
                         torch.from_numpy(mip)).numpy(),
        np.asarray(jocc.occupied_at(jnp.asarray(bitfield), far, mip)))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) * 5 - 2).astype(np.float32)
    tgt = rng.random((n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


# (cone_angle, max_cascade, aabb_min, aabb_size): aabb_scale 1 and 4
SCENES = [(0.0, 0, np.float32(0.0), np.float32(1.0)),
          (1.0 / 256.0, 2, np.float32(-1.5), np.float32(4.0))]


@pytest.mark.parametrize("scene", SCENES, ids=["aabb1", "aabb4"])
def test_march_rays_matches_jax(scene):
    cone, mc, amin, asize = scene
    n, K = 256, 1024
    o, d = _rays(n, seed=2)
    dens = _density(mc, False, seed=3)
    jbf = jocc.rebuild_bitfield(jocc.init_grid(mc)._replace(
        density=jnp.asarray(dens)), mc).bitfield
    bf = torch.from_numpy(np.array(jbf))
    jt, jdt, jemit = jmarch.march_rays(jbf, o, d, None, n, K, cone, mc,
                                       amin, asize, t_start_min=0.05)
    tt, tdt, temit = tmarch.march_rays(bf, torch.from_numpy(o),
                                       torch.from_numpy(d), None, n, K, cone,
                                       mc, float(amin), float(asize),
                                       t_start_min=0.05)
    # exp/log1p in the cone lattice may differ by ulps between XLA and torch
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-6)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=2e-6)
    mismatch = float((temit.numpy() != np.asarray(jemit)).mean())
    print(f"march emit mismatch rate {mismatch:.2e} "
          f"({int(np.asarray(jemit).sum())} emitted)")
    assert np.asarray(jemit).sum() > 1000
    # an ulp in t can move a sample across a cell face
    assert mismatch <= 1e-4


def test_merge_compact_composite_match_jax():
    n, K, cap = 512, 256, 24
    rng = np.random.default_rng(4)
    t = np.cumsum(rng.random((n, K), dtype=np.float32) * 0.01, axis=1,
                  dtype=np.float32)
    dt = (rng.random((n, K), dtype=np.float32) * 0.01 + 1e-3).astype(
        np.float32)
    # one shared emit mask: dense rays (decimated), sparse and empty ones
    p = rng.random((n, 1)) ** 2
    emit = rng.random((n, K)) < p
    emit[:16] = False

    j_keep, j_dtm = jmarch.merge_excess_samples(jnp.asarray(emit), dt, cap)
    t_keep, t_dtm = tmarch.merge_excess_samples(torch.from_numpy(emit),
                                                torch.from_numpy(dt), cap)
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(t_dtm.numpy(), np.asarray(j_dtm))
    assert t_keep.sum(1).max() <= cap and (emit.sum(1) > cap).any()

    S = n * cap
    js_t, js_dt, js_ray, j_cnt, j_off, fits, total, js_k = \
        jmarch.compact_samples(t, j_dtm, j_keep, n, S)
    assert bool(np.asarray(fits).all())
    total = int(total)
    ts_t, ts_dt, ts_ray, t_cnt, t_off, ts_k = tmarch.compact_samples(
        torch.from_numpy(t), t_dtm, t_keep)
    assert ts_ray.numel() == total
    for got, ref in [(ts_ray, js_ray), (ts_k, js_k), (ts_t, js_t),
                     (ts_dt, js_dt)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:total])
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))

    sigma = (np.exp(rng.standard_normal(S) * 3) * 20).astype(np.float32)
    rgb = rng.random((S, 3), dtype=np.float32)
    j_rgb, j_op, j_w = jmarch.composite_samples(
        sigma, rgb, js_dt, js_ray, j_off, j_cnt, n, s_k=js_k, n_k=K)
    t_rgb, t_op, t_w = tmarch.composite_samples(
        torch.from_numpy(sigma[:total]), torch.from_numpy(rgb[:total]),
        ts_dt, ts_ray, ts_k, n, K)
    # cumsum and scatter-add orders differ between XLA and torch; the
    # transmittance exp(-prefix) turns a prefix's rounding difference
    # (up to 88·2^-23 per term summed) into a relative one
    for got, ref in [(t_rgb, j_rgb), (t_op, j_op),
                     (t_w, np.asarray(j_w)[:total])]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)
    assert float(t_op.max()) > 0.99   # some rays saturate


def test_update_grid_full_sweep():
    """Full sweep against the JAX sweep on a density field that is linear
    in x: the jitter draws differ (torch.Generator vs jax.random), so each
    cell is checked against the σ range its jitter can reach, and the two
    grids against each other statistically."""
    mc = 1
    amin, asize = np.float32(-0.5), np.float32(2.0)

    def field(w):
        return 20.0 * w[:, 0]

    init = np.zeros(GV * (mc + 1), np.float32)
    init[::97] = -1.0                   # untrained cells stay untouched
    g = torch.Generator().manual_seed(0)
    tg = tocc.init_grid(mc)._replace(density=torch.from_numpy(init))
    tg = tocc.update_grid(tg, field, g, mc, n_uniform=GV * (mc + 1),
                          n_nonuniform=1, aabb_min=float(amin),
                          aabb_size=float(asize))
    jg = jocc.init_grid(mc)._replace(density=jnp.asarray(init))
    jg = jocc.update_grid(jg, lambda w: 20.0 * w[:, 0],
                          jax.random.PRNGKey(0), mc, n_uniform=GV * (mc + 1),
                          n_nonuniform=1, aabb_min=amin, aabb_size=asize)
    td, jd = tg.density.numpy(), np.asarray(jg.density)
    assert tg.ema_step == 1
    np.testing.assert_array_equal(td[::97], -1.0)
    # per cell: σ·Δt within what x ∈ [cell, cell+1) can give
    idx = np.arange(td.size)
    lvl = idx // GV
    x = (idx % GV) % tocc.G
    scale = 2.0 ** lvl
    lo = (((x / 128 - 0.5) * scale + 0.5) - amin) / asize * 20.0
    hi = ((((x + 1) / 128 - 0.5) * scale + 0.5) - amin) / asize * 20.0
    dtm = tocc.MIN_CONE_STEPSIZE
    live = td >= 0
    assert (td[live] >= lo[live] * dtm - 1e-6).all()
    assert (td[live] <= hi[live] * dtm + 1e-6).all()
    np.testing.assert_allclose(td.mean(), jd.mean(), rtol=1e-3)
    # bitfield: what rebuild_bitfield gives for this density
    np.testing.assert_array_equal(
        tg.bitfield.numpy(),
        tocc.rebuild_bitfield(tg._replace(bitfield=tg.bitfield * 0))
        .bitfield.numpy())
    # the default budget is the partial (interleaved slab) sweep
    tp = tocc.update_grid(tg, field, g, mc, aabb_min=float(amin),
                          aabb_size=float(asize))
    assert tp.ema_step == 2
    np.testing.assert_array_equal(tp.density.numpy()[::97], -1.0)
