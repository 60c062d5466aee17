"""Parity of the port's EncodedNetwork (the image and SDF engines' network),
its encodings, activations and tcnn losses with the JAX package, on
JAX-initialised parameters moved through bridge.py; the plain 2D encode
and table backward against the Pallas kernels in interpret mode; and the
CUDA wrapper's 2D contract on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.kernels.blocked_grid as jbg
import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu.config import autofill_hashgrid_config as j_autofill
from ngp_tpu.nn.mlp import MLP as JMLP
from ngp_tpu.nn.models import EncodedNetwork as JEncodedNetwork
from ngp_tpu.opt.losses import create_loss as j_create_loss
from ngp_tpu_torch import bridge
from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.nn.mlp import MLP as TMLP
from ngp_tpu_torch.nn.models import EncodedNetwork as TEncodedNetwork
from ngp_tpu_torch.opt.losses import create_loss as t_create_loss
from test_torch_blocked_grid import pallas_calls_in_turn

# forward: the same f32 arithmetic up to the order of sums; gradients:
# relative to the largest entry of each parameter's gradient. The bf16
# re-rounding between MLP layers moves an activation by a bf16 ulp where
# the two frameworks' f32 sums differ in the last bit next to a rounding
# boundary, so (as in test_torch_nerf_network) all but MOSTLY of the
# entries meet these tolerances, and every entry the bf16 ones.
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
MOSTLY, BF16_FWD_TOL, BF16_GRAD_TOL = 0.999, 2e-2, 2e-2

NETWORK = {"otype": "FullyFusedMLP", "activation": "ReLU",
           "output_activation": "None", "n_neurons": 16,
           "n_hidden_layers": 2}


def _grid(n_dims, otype="HashGrid"):
    return j_autofill({"otype": otype, "n_levels": 4,
                       "n_features_per_level": 2, "log2_hashmap_size": 12,
                       "base_resolution": 4}, n_dims, 64.0)


# (input dims, output dims, encoding, JAX grid implementation)
CASES = {
    "2d-blocked": (2, 3, _grid(2), "blocked"),
    "3d-blocked": (3, 1, _grid(3), "blocked"),
    "3d-tcnn": (3, 1, _grid(3), "tcnn"),
    "2d-tcnn": (2, 3, _grid(2), "tcnn"),
    "2d-dense": (2, 3, _grid(2, "DenseGrid"), "blocked"),
    "2d-frequency": (2, 3, {"otype": "Frequency", "n_frequencies": 6},
                     "blocked"),
    "3d-oneblob": (3, 1, {"otype": "OneBlob", "n_bins": 8}, "blocked"),
    "3d-composite": (3, 1, {"otype": "Composite", "nested": [
        {"otype": "OneBlob", "n_bins": 4, "n_dims_to_encode": 1},
        {"otype": "Frequency", "n_frequencies": 3}]}, "blocked"),
}


def _pair(name, monkeypatch, network=NETWORK, seed=0):
    """A JAX EncodedNetwork with seeded parameters (the grid's table well
    above tcnn's ±1e-4 init, so the encoding shapes the output) and the
    port's, with the same parameters."""
    n_in, n_out, enc, impl = CASES[name]
    monkeypatch.setenv("NGP_TPU_GRID_IMPL", impl)
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)
    jm = JEncodedNetwork(n_in, n_out, enc, network)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree["encoding"] = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        tree["encoding"])
    tm = TEncodedNetwork(n_in, n_out, enc, network, grid_impl=impl)
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(tree, tm).items():
            dict(tm.named_parameters())[k].copy_(v)
    x = rng.random((2048, n_in), dtype=np.float32)
    return jm, tree, tm, x


def _assert_fwd_close(got, ref):
    err = np.abs(got - ref)
    ok = err <= FWD_TOL + FWD_TOL * np.abs(ref)
    assert ok.mean() >= MOSTLY, (ok.mean(), err.max())
    assert err.max() <= BF16_FWD_TOL, err.max()


def _assert_grad_close(got, ref):
    err = np.abs(got - ref) / max(float(np.abs(ref).max()), 1e-12)
    assert (err <= GRAD_TOL).mean() >= MOSTLY, ((err <= GRAD_TOL).mean(),
                                               err.max())
    assert err.max() <= BF16_GRAD_TOL, err.max()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name, monkeypatch):
    jm, tree, tm, x = _pair(name, monkeypatch)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply(tree, x))
    assert got.shape == ref.shape == (x.shape[0], jm.n_output_dims)
    _assert_fwd_close(got, ref)
    cot = np.random.default_rng(1).standard_normal(ref.shape).astype(
        np.float32)
    j_grads = jax.grad(lambda p: jnp.sum(jm.apply(p, x) * cot))(tree)
    out = torch.sum(tm(torch.from_numpy(x)) * torch.from_numpy(cot))
    names = list(dict(tm.named_parameters()))
    t_grads = dict(zip(names, torch.autograd.grad(
        out, [dict(tm.named_parameters())[k] for k in names])))
    ref_flat = bridge.encoded_params_from_numpy(
        jax.tree.map(np.asarray, j_grads), tm)
    assert set(ref_flat) == set(t_grads)
    for k in names:
        _assert_grad_close(t_grads[k].numpy(), ref_flat[k].numpy())


ACTIVATIONS = ["None", "ReLU", "LeakyReLU", "Exponential", "Sigmoid",
               "Logistic", "Sine", "Squareplus", "Softplus", "Tanh"]


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activations_match_jax(activation):
    """Each activation as the hidden and the output activation of an MLP,
    forward and input gradient."""
    spec = dict(n_neurons=16, n_hidden_layers=2, activation=activation,
                output_activation=activation)
    jmlp = JMLP(8, 4, **spec)
    w = [np.asarray(a) for a in jmlp.init_params(jax.random.PRNGKey(5))]
    tmlp = TMLP(8, 4, **spec)
    with torch.no_grad():
        for p, a in zip(tmlp.weights, w):
            p.copy_(torch.from_numpy(a))
    # inputs small enough that three stacked exponentials stay finite
    x = (np.random.default_rng(2).standard_normal((1024, 8)) * 0.3).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmlp(xt)
    ref = np.asarray(jmlp.apply(tuple(w), x))
    _assert_fwd_close(got.detach().numpy(), ref)
    (g,) = torch.autograd.grad(got.sum(), xt)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jmlp.apply(tuple(w), v)))(x))
    _assert_grad_close(g.numpy(), jg)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        TMLP(4, 4, activation="Gelu")


@pytest.mark.parametrize("otype", ["L2", "RelativeL2", "L1", "MAPE", "SMAPE",
                                   "Huber", "LogL1"])
def test_create_loss_matches_jax(otype):
    """tcnn's losses by otype: values, and gradients by the prediction
    (the normalisers of RelativeL2, MAPE and SMAPE held constant)."""
    rng = np.random.default_rng(3)
    target = rng.standard_normal(4096).astype(np.float32)
    pred = rng.standard_normal(4096).astype(np.float32)
    tl, jl = t_create_loss({"otype": otype}), j_create_loss({"otype": otype})
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = tl(torch.from_numpy(target), pt)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jl(target, pred)), rtol=1e-6,
                               atol=1e-7)
    (g,) = torch.autograd.grad(got.sum(), pt)
    jg = jax.grad(lambda p: jnp.sum(jl(target, p)))(pred)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        t_create_loss({"otype": "Nope"})


def test_encoded_bridge_round_trip_and_leaf_order(monkeypatch):
    jm, tree, tm, _ = _pair("3d-composite", monkeypatch)
    assert tree["encoding"] == ((), ())
    jm, tree, tm, _ = _pair("2d-blocked", monkeypatch)
    params = dict(tm.named_parameters())
    back = bridge.encoded_params_to_numpy(params, tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the pyngp params vector: the JAX leaf order
    flat = bridge.nerf_params_to_flat(params, tm)
    np.testing.assert_array_equal(flat, np.concatenate(
        [np.ravel(a) for a in jax.tree.leaves(tree)]))
    again = bridge.nerf_params_from_flat(flat, tm)
    for k, v in again.items():
        torch.testing.assert_close(v, params[k].detach(), rtol=0, atol=0)
    with pytest.raises(ValueError):
        bridge.encoded_params_from_numpy(dict(tree, net=tree["net"][:1]), tm)
    assert tm.matrix_param_names() == {f"net.weights.{i}" for i in range(3)}


# a 2D meta of several levels, dense and hashed, in few rows (the Pallas
# kernels in interpret mode take a one-hot over every row)
META_2D = dict(n_dims=2, n_levels=4, base_resolution=16,
               per_level_scale=2.0, log2_rows=6)


def _inputs_2d(seed, n=512):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((4, 1 << 6, 128)) * 0.3).astype(np.float32)
    pos = rng.random((n, 2), dtype=np.float32)
    cot = rng.standard_normal((n, 8)).astype(np.float32)
    cot[::7] = 0.0
    return table, pos, cot


def test_plain_2d_encode_and_backward_match_pallas_interpret():
    """The port's plain 2D encode and table backward (the CPU path, and the
    oracles of the 2D K1 and K2 on the card) against the Pallas K1 and K2
    in interpret mode on a 2D grid, with the bf16 tolerances of
    tests/test_pallas_interpret.py (the Pallas kernels round the table and
    the row gradients to bf16)."""
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import blocked_grid_encode
    table, pos, cot = _inputs_2d(6)
    jm, tm = jbg.BlockedGridMeta(**META_2D), tbg.BlockedGridMeta(**META_2D)
    assert any(tm.level_is_dense) and not all(tm.level_is_dense)
    got = tbg.encode_reference(torch.from_numpy(table),
                               torch.from_numpy(pos), tm).numpy()
    dgot = tbg.encode_backward_reference(torch.from_numpy(pos),
                                         torch.from_numpy(cot), tm).numpy()
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(blocked_grid_encode(table, pos, jm, 256))
        dref = np.asarray(jax.grad(lambda t: jnp.sum(
            blocked_grid_encode(t, pos, jm, 256) * cot))(table))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=4e-3)
    np.testing.assert_allclose(dgot, dref, rtol=5e-2, atol=4e-3)
    assert not ((dref != 0) & (dgot == 0)).any()


def test_wrapper_2d_contract_on_cpu():
    """A 2D grid on CPU tensors runs the plain versions without a launch;
    every kernel wrapper (K1–K5) takes the 2D grid and stops only at the
    CPU tensors, and launches under its ``_2d`` name."""
    table, pos, cot = _inputs_2d(7, n=256)
    meta = tbg.BlockedGridMeta(**META_2D)
    t = torch.from_numpy(table).requires_grad_(True)
    before = dict(blocked_grid_cuda.launches)
    out = blocked_grid_cuda.blocked_grid_encode(t, torch.from_numpy(pos),
                                                meta)
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), t)
    assert blocked_grid_cuda.launches == before
    torch.testing.assert_close(out.detach(), tbg.encode_reference(
        torch.from_numpy(table), torch.from_numpy(pos), meta), rtol=0, atol=0)
    torch.testing.assert_close(g, tbg.encode_backward_reference(
        torch.from_numpy(pos), torch.from_numpy(cot), meta), rtol=0, atol=0)
    p, c, tb = (torch.from_numpy(a) for a in (pos, cot, table))
    for call in (lambda: blocked_grid_cuda.launch_fwd(tb, p, meta),
                 lambda: blocked_grid_cuda.launch_bwd(p, c, meta),
                 lambda: blocked_grid_cuda.launch_bwd_pos(tb, p, c, meta),
                 lambda: blocked_grid_cuda.launch_fwd_i8(
                     tb.to(torch.int8), torch.ones(4), p, meta),
                 lambda: blocked_grid_cuda.launch_bwd_i8(p, c, meta, 64)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for k in blocked_grid_cuda.GROUP_KERNELS:
        assert blocked_grid_cuda.launch_name(k, meta) == f"{k}_2d"
        assert blocked_grid_cuda.launches[f"{k}_2d"] == before[f"{k}_2d"]
