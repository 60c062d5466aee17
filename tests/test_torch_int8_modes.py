"""The int8 encode modes (``"fwd"``, ``"full"``) of the port's
encoded-network engines against the JAX package's. The JAX blocked grid
reads ``NGP_TPU_ENCODE_INT8`` on a TPU only and runs its plain f32 encode
elsewhere, so each JAX encoding here has its ``apply`` routed through the
Pallas int8 function that a TPU runs under the switch
(``blocked_grid_encode_i8fwd`` or ``blocked_grid_encode_int8``), in
interpret mode; nothing in the JAX package changes. Also: the uv gradient
of the image field (the 2D K3's plain version) against ``jax.grad``, one
``ImageTrainer`` step and its inference in each mode, and the Testbed's
mapping of ``NGP_TPU_ENCODE_INT8`` into every mode's trainer."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu.config import autofill_hashgrid_config as j_autofill
from ngp_tpu.nn import encodings as jenc
from ngp_tpu.nn.models import EncodedNetwork as JEncodedNetwork
from ngp_tpu.train import image as jimage
from ngp_tpu_torch import bridge
from ngp_tpu_torch.api import testbed as ttestbed
from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.nn import encodings as tenc
from ngp_tpu_torch.nn.models import EncodedNetwork as TEncodedNetwork
from ngp_tpu_torch.train import image as timage
from test_torch_blocked_grid import pallas_calls_in_turn
from test_torch_encode_pos_grad import _tile_quanta
from test_torch_image import BATCH, H, W, small_config, synth_image

MODES = ["fwd", "full"]
NETWORK = {"otype": "FullyFusedMLP", "activation": "ReLU",
           "output_activation": "None", "n_neurons": 16,
           "n_hidden_layers": 2}
# forward: K4's int8 selection is exact in both, so the outputs agree to
# f32 sums in another order, except where the bf16 re-rounding between MLP
# layers moves an activation by a bf16 ulp (test_torch_encoded_network's
# rule: all but MOSTLY within FWD_TOL, every one within BF16_TOL)
FWD_TOL, MOSTLY, BF16_TOL = 1e-5, 0.999, 2e-2
# MLP gradients: relative to the largest entry, as in
# test_torch_encoded_network
GRAD_TOL = 1e-4


def _grid(n_dims):
    return j_autofill({"otype": "HashGrid", "n_levels": 4,
                       "n_features_per_level": 2, "log2_hashmap_size": 12,
                       "base_resolution": 4}, n_dims, 64.0)


# (input dims, output dims, encoding): the image field, the volume field,
# and a 2D grid nested in a Composite beside an analytic encoding
CASES = {
    "2d-image": (2, 3, _grid(2)),
    "3d-volume": (3, 4, _grid(3)),
    "3d-composite": (3, 1, {"otype": "Composite", "nested": [
        dict(_grid(2), n_dims_to_encode=2),
        {"otype": "Frequency", "n_frequencies": 3}]}),
}


@pytest.fixture(autouse=True)
def _no_jax_knobs(monkeypatch):
    for k in ("NGP_TPU_BLOCKED_LOG2_ROWS", "NGP_TPU_BLOCKED_HASH",
              "NGP_TPU_ENCODE_INT8", "NGP_TPU_GRID_IMPL"):
        monkeypatch.delenv(k, raising=False)


def route_int8(monkeypatch, enc, mode: str) -> int:
    """Route every blocked grid of the JAX encoding ``enc`` (nested ones
    included) through the Pallas int8 function of ``mode``, as a TPU runs
    it under ``NGP_TPU_ENCODE_INT8``; returns how many were routed."""
    from ngp_tpu.kernels.hashgrid_pallas import (blocked_grid_encode_i8fwd,
                                                 blocked_grid_encode_int8)
    if isinstance(enc, jenc.Composite):
        return sum(route_int8(monkeypatch, e, mode) for _, e in enc.parts)
    if not isinstance(enc, jenc.BlockedGridEncoding):
        return 0
    fn = {"fwd": blocked_grid_encode_i8fwd,
          "full": blocked_grid_encode_int8}[mode]
    meta = enc.meta

    def apply(params, x, max_level=None, **_):
        assert max_level is None
        return fn(params, x, meta)
    monkeypatch.setattr(enc, "apply", apply)
    return 1


def _pair(name, seed=0):
    n_in, n_out, enc = CASES[name]
    jm = JEncodedNetwork(n_in, n_out, enc, NETWORK)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree["encoding"] = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        tree["encoding"])
    tm = TEncodedNetwork(n_in, n_out, enc, NETWORK)
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(tree, tm).items():
            dict(tm.named_parameters())[k].copy_(v)
    x = rng.random((1500, n_in), dtype=np.float32)
    return jm, tree, tm, x


def _grids(tm):
    enc = tm.encoding
    parts = enc.parts if isinstance(enc, tenc.Composite) else [enc]
    return [p for p in parts if isinstance(p, tenc.BlockedGridEncoding)]


def _fwd_close(got, ref):
    err = np.abs(got - ref)
    ok = err <= FWD_TOL + FWD_TOL * np.abs(ref)
    assert ok.mean() >= MOSTLY, (ok.mean(), err.max())
    assert err.max() <= BF16_TOL, err.max()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_encoded_network_int8_matches_jax(name, mode, monkeypatch):
    """Forward and gradients of the port's EncodedNetwork in an int8 mode
    against the JAX network routed through the Pallas int8 encode. The
    table gradient: under ``"fwd"`` the plain f32 K2 against the Pallas
    K2, which rounds its row gradients to bf16 (test_torch_encode_grad's
    tolerance: rtol 5e-2, atol 4e-3 relative to the largest entry); under
    ``"full"`` both quantise the same products per (level, tile), so each
    entry within one quantum per contributing sample of the port's own
    tile scales (test_torch_encode_pos_grad's rule)."""
    jm, tree, tm, x = _pair(name)
    assert route_int8(monkeypatch, jm.encoding, mode) == 1
    grids = _grids(tm)
    seen = {}

    def hook(module, args, out):
        seen["pos"] = args[0].detach()
        out.register_hook(lambda g: seen.setdefault("cot", g.detach()))
    grids[0].register_forward_hook(hook)
    out = tm(torch.from_numpy(x), int8=mode)
    cot = np.random.default_rng(1).standard_normal(out.shape).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(jm.apply(tree, x))
        j_grads = jax.grad(lambda p: jnp.sum(jm.apply(p, x) * cot))(tree)
    _fwd_close(out.detach().numpy(), ref)
    names = list(dict(tm.named_parameters()))
    t_grads = dict(zip(names, torch.autograd.grad(
        torch.sum(out * torch.from_numpy(cot)),
        [dict(tm.named_parameters())[k] for k in names])))
    ref_flat = bridge.encoded_params_from_numpy(
        jax.tree.map(np.asarray, j_grads), tm)
    for k in names:
        got, want = t_grads[k].numpy(), ref_flat[k].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        if not k.endswith("table"):
            err = np.abs(got - want) / scale
            assert (err <= GRAD_TOL).mean() >= MOSTLY, (k, err.max())
            continue
        meta = grids[0].meta
        if mode == "fwd":
            np.testing.assert_allclose(got / scale, want / scale, rtol=5e-2,
                                       atol=4e-3)
        else:
            quanta = _tile_quanta(seen["pos"], seen["cot"], meta,
                                  tbg.eff_tile(x.shape[0]))
            assert np.all(np.abs(got - want) <= quanta * (1 + 1e-5)
                          + 1e-6 * scale), k
            assert np.all(got[quanta == 0] == 0)
        assert (got != 0).mean() > 0.01


def test_tcnn_grid_refuses_and_analytic_encodings_ignore_the_mode():
    """The tcnn-layout grid has no int8 mode; the analytic encodings give
    the same output in every mode."""
    tcnn = TEncodedNetwork(2, 3, _grid(2), NETWORK, grid_impl="tcnn")
    x = torch.rand(64, 2)
    with pytest.raises(NotImplementedError, match="int8"):
        tcnn(x, int8="fwd")
    freq = TEncodedNetwork(2, 3, {"otype": "Frequency", "n_frequencies": 4},
                           NETWORK)
    with torch.no_grad():
        torch.testing.assert_close(freq(x, int8="full"), freq(x), rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="int8 mode"):
        TEncodedNetwork(2, 3, _grid(2), NETWORK)(x, int8="half")


@pytest.mark.parametrize("mode", ["", "full"])
def test_uv_gradient_matches_jax(mode, monkeypatch):
    """The gradient of the image field by its uv (the 2D K3's plain
    version, from the f32 table in every mode) against jax.grad: in the
    f32 mode against the JAX package's plain encode, each component within
    1e-5 of the sum of the encoding's term magnitudes (K3's rule, from the
    port's own cotangent at the encoding) plus f32 rounding of the MLP;
    under ``"full"`` against the Pallas K3, which reads the table in bf16:
    2^-8 of that sum."""
    jm, tree, tm, x = _pair("2d-image", seed=3)
    if mode:
        route_int8(monkeypatch, jm.encoding, mode)
    seen = {}

    def hook(module, args, out):
        out.register_hook(lambda g: seen.setdefault("cot", g.detach()))
    tm.encoding.register_forward_hook(hook)
    cot = np.random.default_rng(4).standard_normal((x.shape[0], 3)).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(tm(xt, int8=mode)
                                           * torch.from_numpy(cot)), xt)
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(jax.grad(lambda p: jnp.sum(
            jm.apply(tree, p) * cot))(x))
    mag = tbg.encode_position_backward_reference(
        tm.encoding.table.detach(), torch.from_numpy(x), seen["cot"],
        tm.encoding.meta, magnitude=True).numpy()
    tol = (2.0 ** -8 if mode else 1e-5) * mag + 1e-6 * np.abs(ref).max()
    assert got.shape == x.shape
    assert np.all(np.abs(got.numpy() - ref) <= tol)
    assert np.abs(ref).max() > 0


@pytest.fixture(scope="module", params=MODES)
def image_pair(request):
    """A JAX ImageTrainer whose encoding runs the Pallas int8 function of
    the mode (interpret mode, under jit) and the port's ImageTrainer on the
    CPU in that mode, with the same seeded parameters, in Halton mode."""
    mode = request.param
    mp = pytest.MonkeyPatch()
    cfg = small_config()
    img = synth_image()
    jtr = jimage.ImageTrainer(img, cfg, batch_size=BATCH)
    route_int8(mp, jtr.model.encoding, mode)
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, jtr.params)
    params["encoding"] = (rng.standard_normal(params["encoding"].shape)
                          * 0.3).astype(np.float32)
    # copies: the JAX step donates its parameter and state buffers
    jtr.params = jax.tree.map(jnp.array, params)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array,
                                                           params))
    ttr = timage.ImageTrainer(img, cfg, batch_size=BATCH, device="cpu",
                              encode_int8=mode)
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(params,
                                                     ttr.model).items():
            ttr.params[k].copy_(v)
            ttr.opt_state.ema_params[k].copy_(v)
    for tr in (jtr, ttr):
        tr.random_mode = "halton"
    yield mode, jtr, ttr, params
    mp.undo()


def test_image_step_in_int8_mode_matches_jax(image_pair):
    """One step of each on the same Halton positions: the loss to 1e-5;
    the Adam-updated MLP matrices as test_torch_image holds them (all but
    MOSTLY within 1e-6, every entry within 2·lr: the first Adam step moves
    a parameter by about lr·sign(g)); the table within 2·lr, and the
    entries that moved the same in both but where the JAX K2's bf16 sums
    (``"fwd"``) or a quantum at a rounding tie (``"full"``) leave a
    gradient exactly 0 on one side only (at most 0.1 %)."""
    mode, jtr, ttr, params = image_pair
    pos = ttr.sample_batch()
    t_loss = float(ttr.step(pos))
    with pltpu.force_tpu_interpret_mode():
        j_loss = jtr.train(1)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    lr = ttr.opt_cfg.learning_rate
    got = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    ref = jax.tree.map(np.asarray, jtr.params)
    for g, r in zip(jax.tree.leaves(got["net"]), jax.tree.leaves(ref["net"])):
        err = np.abs(g - r)
        assert (err <= 1e-6).mean() >= MOSTLY
        assert err.max() <= 2 * lr + 1e-6
    err = np.abs(got["encoding"] - ref["encoding"])
    assert err.max() <= 2 * lr + 1e-6
    moved_t = got["encoding"] != params["encoding"]
    moved_j = ref["encoding"] != params["encoding"]
    assert (moved_t != moved_j).mean() <= 1e-3
    assert 0.01 < moved_t.mean() < 0.99


def test_image_inference_in_int8_mode_matches_jax(image_pair):
    """compute_mse and a frame in the mode (the JAX ``_infer`` traces the
    routed encoding too) against the JAX trainer's, on the same inference
    parameters."""
    mode, jtr, ttr, params = image_pair
    jp = bridge.encoded_params_to_numpy(ttr.inference_params(), ttr.model)
    jtr.params = jax.tree.map(jnp.array, jp)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array, jp))
    with pltpu.force_tpu_interpret_mode():
        j_mse = jtr.compute_mse()
        j_img = jtr.render(W // 2, H // 2)
    np.testing.assert_allclose(ttr.compute_mse(), j_mse, rtol=1e-4)
    _fwd_close(ttr.render(W // 2, H // 2), j_img)
    # and the mode is not the f32 encode
    f32 = copy.copy(ttr)
    f32.encode_int8 = ""
    assert abs(f32.compute_mse() - ttr.compute_mse()) > 0


class _Built(Exception):
    """Raised by a stand-in trainer with the arguments it was built
    with."""


@pytest.mark.parametrize("env,want", [("", ""), ("fwd", "fwd"),
                                      ("full", "full"), ("1", "fwd")])
def test_testbed_maps_encode_int8_into_every_mode(env, want, monkeypatch,
                                                  tmp_path):
    """``NGP_TPU_ENCODE_INT8`` reaches the trainer of every mode as its
    ``encode_int8`` (NeRF: ``NerfTrainerConfig.encode_int8``), read as the
    JAX blocked grid reads it: "full", else "fwd" for any non-empty
    value."""
    from ngp_tpu_torch.data import image_io, nerf_loader
    from ngp_tpu_torch.train import nerf, sdf, volume

    def stand_in(*args, **kw):
        raise _Built(kw)
    monkeypatch.setenv("NGP_TPU_ENCODE_INT8", env)
    for module, cls in ((timage, "ImageTrainer"), (sdf, "SdfTrainer"),
                        (volume, "VolumeTrainer"), (nerf, "NerfTrainer")):
        monkeypatch.setattr(module, cls, stand_in)
    monkeypatch.setattr(image_io, "read_image", lambda p: np.zeros((4, 4, 3)))
    monkeypatch.setattr(nerf_loader, "load_nerf", lambda *a, **k: None)
    assert ttestbed.encode_int8_from_env() == want
    for mode, scene in (("image", "x.png"), ("sdf", "x.obj"),
                        ("volume", "x.nvdb"), ("nerf", "transforms.json")):
        tb = ttestbed.Testbed(mode, device="cpu")
        tb.network_config = {"encoding": {}}
        with pytest.raises(_Built) as built:
            tb.load_training_data(tmp_path / scene)
        kw = built.value.args[0]
        got = kw["tcfg"].encode_int8 if mode == "nerf" else kw["encode_int8"]
        assert got == want, mode
    assert blocked_grid_cuda.check_int8_mode(want) == want


@pytest.mark.parametrize("mode", MODES)
def test_sdf_step_in_int8_mode_matches_jax(mode, tmp_path, monkeypatch):
    """The SDF engine in an int8 mode: distances before, and one step on
    the same batch, against the JAX SdfTrainer routed through the Pallas
    int8 encode (test_torch_sdf's tolerances: MAPE's loss to 2e-3, the
    parameters as an Adam first step moves them, within 2·lr)."""
    from ngp_tpu.train import sdf as jsdf
    from ngp_tpu_torch.train import sdf as tsdf
    from test_torch_sdf import private_jax_bvh, write_torus_obj
    from test_torch_sdf import small_config as sdf_config
    private_jax_bvh(tmp_path / "jax_bvh")
    torus = write_torus_obj(tmp_path / "torus.obj")
    cfg = sdf_config()
    jtr = jsdf.SdfTrainer(torus, cfg, batch_size=BATCH)
    route_int8(monkeypatch, jtr.model.encoding, mode)
    ttr = tsdf.SdfTrainer(torus, cfg, batch_size=BATCH, device="cpu",
                          encode_int8=mode)
    tree = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    tree["encoding"] = (np.random.default_rng(2).standard_normal(
        tree["encoding"].shape) * 0.1).astype(np.float32)
    with torch.no_grad():
        for k, val in bridge.encoded_params_from_numpy(tree,
                                                       ttr.model).items():
            ttr.params[k].copy_(val)
            ttr.opt_state.ema_params[k].copy_(val)
    jtr.params = jax.tree.map(jnp.array, tree)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array, tree))
    pts = np.random.default_rng(5).random((2048, 3), dtype=np.float32)
    pos, dist = ttr.generate_training_batch()
    with pltpu.force_tpu_interpret_mode():
        ref = jtr.distance_at(pts)
        jtr.params, jtr.state, j_loss = jtr._train_step(
            jtr.params, jtr.state, jnp.asarray(pos), jnp.asarray(dist))
    _fwd_close(ttr.distance_at(pts), ref)
    np.testing.assert_allclose(float(ttr.step(pos, dist)), float(j_loss),
                               rtol=2e-3)
    lr = ttr.opt_cfg.learning_rate
    got = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(
            jax.tree.map(np.asarray, jtr.params))):
        assert np.abs(g - r).max() <= 2 * lr + 1e-6
    assert (got["encoding"] != tree["encoding"]).any()
