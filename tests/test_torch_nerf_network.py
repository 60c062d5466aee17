"""Parity of the port's encodings, MLP and NerfNetwork with the JAX
package, on JAX-initialised parameters moved through bridge.py."""
import jax
import numpy as np
import pytest
import torch

from ngp_tpu.config import autofill_hashgrid_config as j_autofill
from ngp_tpu.config import load_network_config
from ngp_tpu.nn import encodings as jenc
from ngp_tpu.nn.mlp import MLP as JMLP
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu_torch import bridge
from ngp_tpu_torch.nn import encodings as tenc
from ngp_tpu_torch.nn.mlp import MLP as TMLP
from ngp_tpu_torch.nn.models import NerfNetwork as TNerfNetwork


def _small_cfg():
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    cfg["network"]["n_neurons"] = 32
    cfg["rgb_network"]["n_neurons"] = 32
    return cfg


def _mostly_close(got, ref, rtol, atol, frac, hard_atol):
    """bf16 re-rounding between MLP layers: where the two frameworks' f32
    sums differ in the last bit next to a bf16 rounding boundary, one
    activation moves by a bf16 ulp (2^-8 relative). So all but a small
    fraction of outputs match to f32 precision, and all to ``hard_atol``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.abs(got - ref) <= atol + rtol * np.abs(ref)
    assert ok.mean() >= frac, (ok.mean(), np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=hard_atol)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_spherical_harmonics_matches_jax(degree):
    d = np.random.default_rng(degree).random((1000, 3), dtype=np.float32)
    got = tenc.SphericalHarmonics(3, degree)(torch.from_numpy(d)).numpy()
    ref = np.asarray(jenc.SphericalHarmonics(3, degree).apply((), d))
    assert got.shape == (1000, degree * degree)
    # same polynomials in f32; XLA may fuse/reassociate a product
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_composite_dir_encoding_matches_jax():
    cfg = load_network_config("configs/nerf/base.json")["dir_encoding"]
    d = np.random.default_rng(0).random((777, 3), dtype=np.float32)
    tc = tenc.create_encoding(3, cfg)
    jc = jenc.create_encoding(3, cfg)
    assert tc.n_output_dims == jc.n_output_dims == 16
    got = tc(torch.from_numpy(d)).numpy()
    ref = np.asarray(jc.apply(jc.init_params(jax.random.PRNGKey(0)), d))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_unported_encodings_raise():
    # Frequency and OneBlob are ported (test_torch_encoded_network), the
    # DenseGrid too (the tcnn-layout grid, test_torch_hashgrid); the
    # Takikawa octree encoding needs the mesh's surface, so the SDF trainer
    # builds it (test_torch_takikawa), not the factory
    assert tenc.create_encoding(3, {"otype": "Frequency"}).n_output_dims == 72
    assert tenc.create_encoding(3, {"otype": "OneBlob"}).n_output_dims == 48
    with pytest.raises(ValueError, match="Takikawa"):
        tenc.create_encoding(3, {"otype": "Takikawa"})


def test_mlp_matches_jax():
    spec = dict(n_neurons=32, n_hidden_layers=2, activation="ReLU",
                output_activation="None")
    jm = JMLP(24, 5, **spec)
    w = [np.array(a) for a in jm.init_params(jax.random.PRNGKey(3))]
    tm = TMLP(24, 5, **spec)
    assert [tuple(p.shape) for p in tm.weights] == [a.shape for a in w]
    with torch.no_grad():
        for p, a in zip(tm.weights, w):
            p.copy_(torch.from_numpy(a))
    x = np.random.default_rng(0).standard_normal((4096, 24)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply(tuple(w), x))
    assert got.dtype == np.float32 and ref.dtype == np.float32
    _mostly_close(got, ref, rtol=1e-5, atol=1e-6, frac=0.999,
                  hard_atol=2e-2)
    # the last layer is accumulated in f32, not rounded to bf16
    bf = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    assert (bf != got).mean() > 0.5


def _jax_scene_params(cfg, aabb_scale, seed=0):
    jcfg = dict(cfg)
    jcfg["encoding"] = j_autofill(cfg["encoding"], 3, 2048.0,
                                  aabb_scale=aabb_scale)
    jm = JNerfNetwork(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    # a table well above tcnn's ±1e-4 init, so the encoding shapes the output
    rng = np.random.default_rng(seed)
    tree["pos_encoding"] = rng.standard_normal(
        tree["pos_encoding"].shape).astype(np.float32)
    return jm, tree


def test_nerf_network_matches_jax():
    cfg = _small_cfg()
    jm, tree = _jax_scene_params(cfg, aabb_scale=1)
    tm = TNerfNetwork(cfg, aabb_scale=1)
    params = bridge.nerf_params_from_numpy(tree, tm)
    rng = np.random.default_rng(5)
    pos = rng.random((4096, 3), dtype=np.float32)
    dirs = rng.random((4096, 3), dtype=np.float32)
    with torch.no_grad():
        rgb, dens = torch.func.functional_call(
            tm, params, (torch.from_numpy(pos), torch.from_numpy(dirs)))
        sigma = torch.func.functional_call(
            tm, params, (torch.from_numpy(pos),))[:, 0]
    j_rgb, j_dens = jm.apply(tree, pos, dirs)
    assert rgb.shape == (4096, 3) and dens.shape == (4096,)
    _mostly_close(rgb.numpy(), j_rgb, 1e-5, 1e-6, 0.995, 5e-2)
    _mostly_close(dens.numpy(), j_dens, 1e-5, 1e-6, 0.995, 5e-2)
    np.testing.assert_array_equal(sigma.numpy(), dens.numpy())
    # activated density, with the ±15 clamp on the exponent
    tm.load_state_dict(params)
    with torch.no_grad():
        got = tm.density(torch.from_numpy(pos)).numpy()
    _mostly_close(got, jm.density(tree, pos), 1e-5, 1e-6, 0.995, 5e-1)


@pytest.mark.parametrize("max_level", [0.5, "per-sample"])
def test_grid_max_level_mask_matches_jax(max_level):
    cfg = _small_cfg()
    jm, tree = _jax_scene_params(cfg, aabb_scale=1)
    tm = TNerfNetwork(cfg, aabb_scale=1)
    tm.load_state_dict(bridge.nerf_params_from_numpy(tree, tm))
    rng = np.random.default_rng(6)
    pos = rng.random((512, 3), dtype=np.float32)
    ml = (rng.random(512, dtype=np.float32) if max_level == "per-sample"
          else np.float32(max_level))
    with torch.no_grad():
        got = tm.pos_encoding(torch.from_numpy(pos),
                              max_level=torch.as_tensor(ml)).numpy()
    ref = np.asarray(jm.pos_encoding.apply(tree["pos_encoding"], pos,
                                           max_level=ml))
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_bridge_round_trip():
    cfg = _small_cfg()
    _, tree = _jax_scene_params(cfg, aabb_scale=4, seed=2)
    tm = TNerfNetwork(cfg, aabb_scale=4)
    params = bridge.nerf_params_from_numpy(tree, tm)
    assert set(params) == set(dict(tm.named_parameters()))
    back = bridge.nerf_params_to_numpy(params, tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, density_net=tree["density_net"][:1])
    with pytest.raises(ValueError):
        bridge.nerf_params_from_numpy(bad, tm)


def test_seeded_init_is_reproducible_and_tcnn_like():
    cfg = _small_cfg()
    a = TNerfNetwork(cfg, 4, generator=torch.Generator().manual_seed(7))
    b = TNerfNetwork(cfg, 4, generator=torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert float(a.pos_encoding.table.detach().abs().max()) <= 1e-4
    w0 = a.density_net.weights[0]
    limit = (6.0 / sum(w0.shape)) ** 0.5
    assert float(w0.detach().abs().max()) <= limit
