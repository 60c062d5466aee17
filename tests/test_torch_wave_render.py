"""The port's wave (live-sample) renderers against the JAX package's.

One tiny scene (the network of ``tests/test_torch_render.py``'s fixture: 4
levels, log2_hashmap_size 12, aabb_scale 1) renders 16×16 spp-1 pinhole
frames in chunks of 64 rays over 256 march steps: the JAX frames in one
module fixture, each held against the port's frame of the same options;
then the wave marches against the JAX package's, and the port's wave
frames against its own static frames, where the two packages' random
numbers would differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.common import MIN_CONE_STEPSIZE
from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu.rays import marching as jmarch
from ngp_tpu.render.nerf_render import NerfRenderer as JRenderer
from ngp_tpu.render.nerf_render import RenderOptions as JOptions
from ngp_tpu_torch import bridge
from ngp_tpu_torch.common import RenderMode
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork
from ngp_tpu_torch.rays import marching as tmarch
from ngp_tpu_torch.render.multi_nerf import Mask3D
from ngp_tpu_torch.render.nerf_render import NerfRenderer as TRenderer
from ngp_tpu_torch.render.nerf_render import RenderOptions as TOptions
from test_torch_render import _orbit_camera

RES, FOCAL = 16, 16.0
OPTS = dict(width=RES, height=RES, fov_axis_focal=FOCAL, chunk=64,
            march_steps=256, background=(0.1, 0.2, 0.3, 0.0),
            linear_out=True)
# the JAX frames: both host-dispatch strategies, the device dispatch, its
# decimation when the top stream binds (5000, which both packages round up
# to a bucket of 8192, under two of the four chunks' 7200-9800 kept
# samples), and a segment stream bound (R·K/8/10^6) that every chunk
# overflows, after which the JAX package renders the flat march
JAX_CASES = {
    "host_fused_bulk": dict(wave_dispatch="host"),
    "host_segmented_exact": dict(wave_dispatch="host", wave_fused=False,
                                 wave_sync="exact", wave_cap=32),
    "device": {},
    "device_top_bucket": dict(wave2_top_bucket=5000),
    "device_stream_overflow": dict(wave2_frac=10 ** 6),
}
CAM = _orbit_camera(0.4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on these small tensors it is faster, and the
    file does not thrash the cores that the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _density(model):
    """σΔt on the grid: the network at the centres of 32³ blocks of 4³
    cells, each block taking its centre's value (a full 128³ sweep costs
    ~10 s here)."""
    c = (torch.arange(32, dtype=torch.float32) * 4 + 2) / 128
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    with torch.no_grad():
        s = model.density(torch.stack([x, y, z], -1).reshape(-1, 3))
    s = (s * MIN_CONE_STEPSIZE).reshape(32, 32, 32).numpy()
    return np.ascontiguousarray(s.repeat(4, 0).repeat(4, 1).repeat(4, 2)
                                .reshape(-1), np.float32)


@pytest.fixture(scope="module")
def scene():
    """The network in both packages, one density and its bitfield (equal
    in both), and the JAX frames of ``JAX_CASES`` with their
    ``last_wave_samples``."""
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    jcfg = dict(cfg)
    jcfg["encoding"] = autofill_hashgrid_config(cfg["encoding"], 3, 2048.0,
                                                aabb_scale=1)
    jm = JNerfNetwork(jcfg)
    tree = jax.tree.map(np.array, jax.jit(jm.init_params)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree["pos_encoding"] = rng.standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    w = tree["density_net"][-1].copy()
    w[:, 0] *= 8.0
    tree["density_net"] = tree["density_net"][:-1] + (w,)
    model = TNerfNetwork(cfg, aabb_scale=1)
    params = bridge.nerf_params_from_numpy(tree, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    # the port's bitfield, bit-exact with the JAX package's
    # (test_torch_occupancy_marching), serves both
    bitfield = tocc.rebuild_bitfield(tocc.init_grid(0)._replace(
        density=torch.from_numpy(_density(model)))).bitfield
    jbits = jnp.asarray(bitfield.numpy())
    jax_frames = {}
    for name, kw in JAX_CASES.items():
        r = JRenderer(jm, np.float32(0.0), np.float32(1.0), 0.0, 0,
                      JOptions(**OPTS, wave=True, **kw))
        img = r.render(tree, jbits, CAM, RES, RES, focal=(FOCAL, FOCAL),
                       spp=1)
        jax_frames[name] = (img, r.last_wave_samples,
                            getattr(r, "_wave2_flat_sticky", False))
    return dict(model=model, params=params, bitfield=bitfield, jbits=jbits,
                jm=jm, jax=jax_frames)


def _render(scene, bitfield=None, masks=None, spp=1, **kw):
    r = TRenderer(scene["model"], 0.0, 1.0, 0.0, 0,
                  TOptions(**{**OPTS, **kw}), masks=masks)
    img = r.render(scene["params"], scene["bitfield"] if bitfield is None
                   else bitfield, CAM, RES, RES, focal=(FOCAL, FOCAL),
                   spp=spp)
    return r, img


def _assert_render_close(got, ref):
    """Per-pixel statistics, as the static render's parity test holds
    them: bf16 re-rounding in the MLPs and ulp differences of exp/log1p
    move a few samples slightly."""
    assert got.shape == ref.shape == (RES, RES, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    within = (err <= 2e-3).all(-1).mean()
    print(f"render: mean |Δ| {err.mean():.3e}, max {err.max():.3e}, "
          f"{within:.4f} of pixels within 2e-3")
    assert err.mean() <= 2e-4
    assert within >= 0.995


@pytest.fixture(scope="module")
def times_agree(scene):
    """Whether the frames' lattice sample times and live masks agree bit
    for bit between the packages, each marching the rays it makes: only
    then must the live-sample counts be equal."""
    n = RES * RES
    jr = JRenderer(scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
                   JOptions(**OPTS))

    @jax.jit
    def jax_march(bits, cam):
        o, d, _, _ = jr._gen_rays(
            jax.random.PRNGKey(0), 0, n, RES, RES, jnp.float32(FOCAL),
            jnp.float32(FOCAL), cam, cam, jnp.asarray((0.0, 0.0, 0.0, 1.0)),
            False, False)
        return jmarch.march_rays(bits, o, d, None, n, 256, 0.0, 0, 0.0, 1.0,
                                 t_start_min=0.05)
    jt, _, jemit = jax_march(scene["jbits"], jnp.asarray(CAM))
    r = TRenderer(scene["model"], 0.0, 1.0, 0.0, 0, TOptions(**OPTS))
    o, d, _, _ = r._gen_rays(0, n, RES, RES, FOCAL, FOCAL,
                             torch.from_numpy(CAM))
    t, _, emit = tmarch.march_rays(scene["bitfield"], o, d, None, n, 256,
                                   0.0, 0, 0.0, 1.0, t_start_min=0.05)
    return (np.array_equal(t.numpy(), np.asarray(jt))
            and np.array_equal(emit.numpy(), np.asarray(jemit)))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_wave_frame_matches_jax(scene, times_agree, case):
    ref, j_samples, j_fell_back = scene["jax"][case]
    r, img = _render(scene, wave=True, **JAX_CASES[case])
    _assert_render_close(img.numpy(), ref)
    n = r.last_wave_samples
    print(f"{case}: last_wave_samples {n} (JAX {j_samples}); the lattice "
          f"times agree bit for bit: {times_agree}")
    assert n > 0
    if times_agree:
        assert n == j_samples
    else:
        # an ulp of t moves a sample across a cell face or the AABB exit
        # (march emit mismatch ≤ 1e-4, test_torch_occupancy_marching)
        assert abs(n - j_samples) <= 1e-3 * j_samples + 2
    if case == "device_top_bucket":
        # the top stream binds: the per-ray cap halved in both packages
        assert j_samples < scene["jax"]["device"][1]
    if case == "device_stream_overflow":
        # the JAX segment stream overflowed and it rendered the flat
        # march; the port's streams are sized by the live counts, and the
        # bound changes nothing
        assert j_fell_back
        assert torch.equal(img, _render(scene, wave=True)[1])


@pytest.mark.parametrize("top", [1, 4096, 5000, 300_000, 1 << 18])
@pytest.mark.parametrize("march", ["hier", "flat"])
def test_wave2_layout_matches_jax(scene, top, march):
    """The device dispatch's top stream and halving caps are the JAX
    package's: its top bucket is ``wave2_top_bucket`` at least 4096, at
    most the chunk's whole-ray stream, rounded up to a power of two."""
    for n_rays, kw in ((64, {}), (16384, {}),
                       (16384, dict(wave_cap=3, march_segments=1))):
        opts = dict(OPTS, wave=True, wave2_top_bucket=top, wave_march=march,
                    **kw)
        jr = JRenderer(scene["jm"], np.float32(0.0), np.float32(1.0), 0.0, 0,
                       JOptions(**opts))
        seg, n_seg, _, cap, buckets, cands = jr._wave2_layout(
            n_rays, flat=march == "flat")
        tr = TRenderer(scene["model"], 0.0, 1.0, 0.0, 0, TOptions(**opts))
        assert tr._wave2_layout(n_rays) == (seg, n_seg, cap, buckets[-1],
                                            len(cands))


def _march_inputs(n=256, seed=3):
    """aabb_scale 2 (cone steps through all three phases of the lattice),
    two cascades, a density that keeps clear of the threshold in a block
    of the centre, and rays from around the box into it. (The coarse mask
    is a union over the coarser mips, each dilated, so near the content
    it culls nothing: the segments that go are those past the box.)"""
    mc = 1
    rng = np.random.default_rng(seed)
    dens = (rng.random((mc + 1, 128, 128, 128)) * 0.05).astype(np.float32)
    dens[rng.random(dens.shape) < 0.5] = 0.0
    dens[:, :40] = dens[:, 88:] = 0.0
    dens[:, :, :40] = dens[:, :, 88:] = 0.0
    dens[:, :, :, :40] = dens[:, :, :, 88:] = 0.0
    # the port's bitfield and coarse mask, bit-exact with the JAX
    # package's (test_torch_occupancy_marching, test_torch_train_components)
    grid = tocc.rebuild_bitfield(tocc.init_grid(mc)._replace(
        density=torch.from_numpy(dens.reshape(-1))))
    o = (rng.random((n, 3)) * 5 - 2).astype(np.float32)
    d = rng.random((n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = dict(bitfield=grid.bitfield, coarse=grid.coarse,
             o=torch.from_numpy(o), d=torch.from_numpy(d))
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    return j, t, (n, 256, 1.0 / 256.0, mc)


@pytest.mark.parametrize("frac", [1, 10 ** 6], ids=["fits", "overflows"])
def test_march_rays_hier_matches_jax(frac):
    j, t, (n, K, cone, mc) = _march_inputs()
    bound = max(n * (K // 8) // frac, 512)
    jt, jdt, jemit, jsegs = jax.jit(
        lambda b, c, o, d: jmarch.march_rays_hier(
            b, c, o, d, None, n, K, cone, mc, np.float32(-0.5),
            np.float32(2.0), t_start_min=0.05, seg_capacity=bound))(
        *j.values())
    tt, tdt, temit, tsegs = tmarch.march_rays_hier(
        t["bitfield"], t["coarse"], t["o"], t["d"], None, n, K, cone, mc,
        -0.5, 2.0, t_start_min=0.05, seg_capacity=bound)
    assert int(tsegs) == int(jsegs)
    assert (int(tsegs) > bound) == (frac > 1)
    # exp/log1p in the cone lattice may differ by ulps between XLA and
    # torch, and an ulp in t can move a sample across a cell face
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-6)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=2e-6)
    mismatch = float((temit.numpy() != np.asarray(jemit)).mean())
    print(f"hier emit mismatch {mismatch:.2e} ({int(temit.sum())} live)")
    assert mismatch <= 1e-4
    # where nothing was dropped, the port's own flat march, bit for bit
    ft, fdt, femit = tmarch.march_rays(t["bitfield"], t["o"], t["d"], None,
                                       n, K, cone, mc, -0.5, 2.0,
                                       t_start_min=0.05)
    assert torch.equal(tt, ft) and torch.equal(tdt, fdt)
    assert femit.sum() > 1000
    if frac == 1:
        assert torch.equal(temit, femit)
    else:
        # whole rays past the bound lose their live samples, as in JAX
        assert temit.sum() < femit.sum() and not (temit & ~femit).any()


def test_march_segment_stream_matches_jax():
    j, t, (n, K, cone, mc) = _march_inputs()
    segs = tmarch.coarse_segments(t["coarse"], t["o"], t["d"], n, K, cone,
                                  mc, -0.5, 2.0, t_start_min=0.05)
    live = int(segs[2].sum())
    j = jax.jit(lambda b, c, o, d: jmarch.march_segment_stream(
        b, c, o, d, n, K, cone, mc, np.float32(-0.5), np.float32(2.0), live,
        t_start_min=0.05))(*j.values())
    p = tmarch.march_segment_stream(t["bitfield"], t["coarse"], t["o"],
                                    t["d"], n, K, cone, mc, -0.5, 2.0, live,
                                    t_start_min=0.05, segments=segs)
    assert int(p[7]) == int(j[7]) == live
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))   # rays
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))   # segs
    for got, ref in [(p[0], j[0]), (p[1], j[1]), (p[4], j[4]),
                     (p[5], j[5])]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)
    mismatch = float((p[6].numpy() != np.asarray(j[6])).mean())
    assert p[6].sum() > 1000 and mismatch <= 1e-4
    # the closed-form times of the stream are the lattice's bit for bit,
    # and so is the live mask
    lt, ldt, lemit = tmarch.march_rays(t["bitfield"], t["o"], t["d"], None,
                                       n, K, cone, mc, -0.5, 2.0,
                                       t_start_min=0.05)
    ks = p[3][:, None] * 8 + torch.arange(8)
    assert torch.equal(p[4], lt[p[2][:, None], ks])
    assert torch.equal(p[5], ldt[p[2][:, None], ks])
    assert torch.equal(p[6], lemit[p[2][:, None], ks])
    # every live sample of the lattice lies in a surviving segment
    assert int(p[6].sum()) == int(lemit.sum())


@pytest.mark.parametrize("mode", ["SHADE", "DEPTH", "AO", "COST"])
def test_wave_matches_static_at_equal_caps(scene, mode):
    """The wave paths change where the network runs, not the math: host
    segmented (per-segment cap 32, the early-out between segments) against
    the static path's 4 segments at 32, and the device dispatch and the
    fused host one (whole-ray cap 32·4) against one static segment at 128."""
    kw = dict(render_mode=RenderMode[mode], march_segments=4)
    _, static4 = _render(scene, samples_per_chunk_factor=32, **kw)
    _, seg = _render(scene, wave=True, wave_cap=32, wave_fused=False,
                     wave_dispatch="host", **kw)
    np.testing.assert_allclose(seg.numpy(), static4.numpy(), rtol=2e-4,
                               atol=2e-5)
    _, static1 = _render(scene, samples_per_chunk_factor=128,
                         **{**kw, "march_segments": 1})
    for dispatch in ("host", "device"):
        _, img = _render(scene, wave=True, wave_cap=32,
                         wave_dispatch=dispatch, **kw)
        np.testing.assert_allclose(img.numpy(), static1.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_wave_spp_and_masks_match_static(scene, dispatch):
    """spp 2 with pixel jitter and a Mask3D box: every path draws each work
    item's jitter from the frame's generator in the same order, so the
    rays are the static frame's."""
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = 0.5
    mask = [Mask3D(shape="box", transform=xf,
                   dims=np.asarray([0.4, 0.4, 0.4], np.float32),
                   feather=0.1)]
    _, static = _render(scene, masks=mask, spp=2, march_segments=1,
                        samples_per_chunk_factor=256)
    _, img = _render(scene, masks=mask, spp=2, wave=True,
                     wave_dispatch=dispatch)
    assert not torch.equal(img, _render(scene, spp=2, wave=True,
                                        wave_dispatch=dispatch)[1])
    np.testing.assert_allclose(img.numpy(), static.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_hier_march_bit_equal_to_flat(scene):
    """The host dispatch's hierarchical march gives the flat march's
    lattice, and so its frame bit for bit, also where its segment stream
    overflows the bound and it marches flat again; the device dispatch's
    segment stream gives the flat one's frame up to the order of its
    sums. The buffer-size options change nothing on the device."""
    for kw in (dict(), dict(wave_fused=False, wave_sync="exact")):
        host = dict(wave=True, wave_dispatch="host", **kw)
        _, flat = _render(scene, wave_march="flat", **host)
        for frac in (1, 10 ** 6):
            r, hier = _render(scene, wave_march="hier", wave_hier_frac=frac,
                              **host)
            assert torch.equal(hier, flat)
            # past an overflow the renderer marches flat
            assert r._wave_flat_sticky == (frac > 1)
    _, dev_hier = _render(scene, wave=True)
    _, dev_flat = _render(scene, wave=True, wave_march="flat")
    np.testing.assert_allclose(dev_hier.numpy(), dev_flat.numpy(),
                               rtol=2e-4, atol=2e-5)
    for kw in (dict(wave2_frac=1), dict(wave_hier_frac=10 ** 6),
               dict(dispatch_chunks=1)):
        assert torch.equal(_render(scene, wave=True, **kw)[1], dev_hier)


@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_wave_empty_bitfield_evaluates_nothing(scene, dispatch):
    r, img = _render(scene, bitfield=torch.zeros_like(scene["bitfield"]),
                     wave=True, wave_dispatch=dispatch, linear_out=False)
    assert r.last_wave_samples == 0 and r.last_n_samples == 0
    assert torch.equal(img[..., :3], torch.tensor(
        OPTS["background"][:3]).expand(RES, RES, 3))
    assert torch.equal(img[..., 3], torch.zeros(RES, RES))


@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_wave_crop_matches_static(scene, dispatch):
    """A render AABB crop cuts the same samples on the wave paths as on
    the static one."""
    crop = dict(render_aabb_min=(0.3, 0.25, 0.2),
                render_aabb_max=(0.7, 0.8, 0.65))
    _, static = _render(scene, march_segments=1,
                        samples_per_chunk_factor=256, **crop)
    _, img = _render(scene, wave=True, wave_dispatch=dispatch, **crop)
    assert not torch.equal(img, _render(scene, wave=True,
                                        wave_dispatch=dispatch)[1])
    np.testing.assert_allclose(img.numpy(), static.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_wave_leaves_other_modes_to_the_static_path(scene):
    """NORMALS is not a wave mode (nor is glow): wave=True renders the
    static frame, as in the JAX package."""
    for kw in (dict(render_mode=RenderMode.NORMALS),
               dict(glow_mode=1, glow_y_cutoff=0.5)):
        r, img = _render(scene, wave=True, **kw)
        assert not r._wave_supported()
        assert torch.equal(img, _render(scene, **kw)[1])
    with pytest.raises(ValueError, match="wave_dispatch"):
        TRenderer(scene["model"], 0.0, 1.0, 0.0, 0,
                  TOptions(**OPTS, wave=True, wave_dispatch="tpu"))


@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_wave_int8_matches_static(scene, dispatch):
    """Under encode_int8="fwd" the frame's table is quantised once and
    every encode goes through it, on the wave paths as on the static."""
    def render(**kw):
        r = TRenderer(scene["model"], 0.0, 1.0, 0.0, 0,
                      TOptions(**OPTS, **kw), encode_int8="fwd")
        return r.render(scene["params"], scene["bitfield"], CAM, RES, RES,
                        focal=(FOCAL, FOCAL))
    static = render(march_segments=1, samples_per_chunk_factor=256)
    img = render(wave=True, wave_dispatch=dispatch)
    np.testing.assert_allclose(img.numpy(), static.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert not torch.equal(img, _render(scene, wave=True,
                                        wave_dispatch=dispatch)[1])
