"""Parity of the plain versions of the training kernels with the JAX
package: the table backward (K2's plain version) against JAX autodiff and
the Pallas K2 in interpret mode, the int8 quantisation, and the int8-table
forward (K4's plain version) against the Pallas K4 in interpret mode. The
CUDA kernels run only on the card; chip_smoke.py holds them against these
plain versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.kernels.blocked_grid as jbg
import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu_torch.kernels import blocked_grid_cuda
from test_torch_blocked_grid import (SMALL, SMALL_IDS, _positions,
                                     pallas_calls_in_turn)

# a meta whose Pallas kernels run several row-width groups (as in
# tests/test_pallas_interpret.py)
MULTIGROUP = dict(n_dims=3, n_levels=6, base_resolution=16,
                  per_level_scale=1.6, log2_rows=11)
# its 2D counterpart: dense levels of three row counts, the finest hashed
MULTIGROUP_2D = dict(n_dims=2, n_levels=6, base_resolution=16,
                     per_level_scale=1.6, log2_rows=8)


@pytest.fixture(autouse=True)
def _no_jax_layout_knobs(monkeypatch):
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)


def _inputs(meta_kw, seed, n=1024):
    rng = np.random.default_rng(seed)
    L = meta_kw["n_levels"]
    table = (rng.standard_normal((L, 1 << meta_kw["log2_rows"], 128))
             * 0.3).astype(np.float32)
    pos = _positions(meta_kw, n=n, seed=seed)
    cot = rng.standard_normal((pos.shape[0], L * 2)).astype(np.float32)
    cot[::7] = 0.0               # samples of rays without a loss
    return table, pos, cot


@pytest.mark.parametrize("meta_kw", SMALL, ids=SMALL_IDS)
def test_encode_backward_reference_matches_jax_autodiff(meta_kw):
    table, pos, cot = _inputs(meta_kw, seed=4)
    got = tbg.encode_backward_reference(
        torch.from_numpy(pos), torch.from_numpy(cot),
        tbg.BlockedGridMeta(**meta_kw)).numpy()
    jm = jbg.BlockedGridMeta(**meta_kw)
    ref = np.asarray(jax.grad(lambda t: jnp.sum(
        jbg.encode_reference(t, pos, jm) * cot))(table))
    assert got.shape == table.shape
    # the same f32 products, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    # the zero-gradient skip keys on exact zeros
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert 0.01 < (ref == 0).mean() < 0.999


def test_encode_backward_reference_matches_pallas_interpret():
    """Against K2 itself (hashgrid_pallas _bwd_table_kernel), which rounds
    its row gradients to bf16: the bf16 tolerance of
    tests/test_pallas_interpret.py, and the same touched entries."""
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import blocked_grid_encode
    table, pos, cot = _inputs(MULTIGROUP, seed=5, n=512)
    jm = jbg.BlockedGridMeta(**MULTIGROUP)
    got = tbg.encode_backward_reference(
        torch.from_numpy(pos), torch.from_numpy(cot),
        tbg.BlockedGridMeta(**MULTIGROUP)).numpy()
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(jax.grad(lambda t: jnp.sum(
            blocked_grid_encode(t, pos, jm, 256) * cot))(table))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=4e-3)
    # every entry K2 touches, the plain version touches; K2's bf16 sums
    # may cancel a few small entries to exactly 0 where f32 does not
    assert not ((ref != 0) & (got == 0)).any()
    extra = (ref == 0) & (got != 0)
    assert extra.mean() < 1e-5 and np.abs(got[extra]).max(initial=0) < 4e-3


def test_wrapper_backward_on_cpu_runs_plain_version_without_launch():
    """On CPU tensors the autograd function's table gradient is the plain
    backward, its position gradient the plain position backward (which
    agrees with autograd of the plain encode to f32 rounding of its
    cancelling terms), and no kernel is launched."""
    meta_kw = SMALL[0]
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = (torch.from_numpy(a) for a in _inputs(meta_kw, 6, 256))
    before = dict(blocked_grid_cuda.launches)
    for encode in (blocked_grid_cuda.blocked_grid_encode,
                   blocked_grid_cuda.blocked_grid_encode_i8fwd):
        t = table.clone().requires_grad_()
        p = pos.clone().requires_grad_()
        d_table, d_pos = torch.autograd.grad(
            (encode(t, p, meta) * cot).sum(), (t, p))
        torch.testing.assert_close(
            d_table, tbg.encode_backward_reference(pos, cot, meta),
            rtol=0, atol=0)
        torch.testing.assert_close(
            d_pos, tbg.encode_position_backward_reference(table, pos, cot,
                                                          meta),
            rtol=0, atol=0)
        p_ref = pos.clone().requires_grad_()
        ref_pos, = torch.autograd.grad(
            (tbg.encode_reference(table, p_ref, meta) * cot).sum(), p_ref)
        mag = tbg.encode_position_backward_reference(table, pos, cot, meta,
                                                     magnitude=True)
        assert bool(((d_pos - ref_pos).abs() <= 1e-5 * mag).all())
    # only the table asks for a gradient: none is computed for pos
    t = table.clone().requires_grad_()
    out = blocked_grid_cuda.blocked_grid_encode(t, pos, meta)
    out.backward(cot)
    assert pos.grad is None and t.grad is not None
    assert blocked_grid_cuda.launches == before


def test_quantize_table_i8_matches_jax_exactly():
    """The int8 table and the per-level scales bit for bit, with values on
    the .5 rounding ties (both frameworks round half to even) and one level
    of zeros (the 1e-20 floor)."""
    rng = np.random.default_rng(7)
    table = (rng.standard_normal((4, 64, 128)) * 0.3).astype(np.float32)
    s = np.abs(table[1]).max() / np.float32(127.0)
    table[1, 0, :8] = (np.arange(8, dtype=np.float32) - 3.5) * s
    table[3] = 0.0
    q, scales = tbg.quantize_table_i8(torch.from_numpy(table))
    j_scales = jnp.maximum(jnp.max(jnp.abs(table), axis=(1, 2)),
                           1e-20) / 127.0
    j_q = jnp.clip(jnp.round(table / j_scales[:, None, None]), -127,
                   127).astype(jnp.int8)
    assert q.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(j_scales).view(np.uint32))
    assert np.abs(q.numpy()).max() == 127


def test_i8_forward_matches_pallas_interpret():
    """The plain int8-table encode against ``blocked_grid_encode_i8fwd``
    (K4, hashgrid_pallas _fwd_kernel_i8) in interpret mode: its int8
    selection is exact and the scale applies after, so the two agree to
    f32 rounding."""
    _check_i8_forward_against_pallas(MULTIGROUP, 8)


def test_i8_forward_matches_pallas_interpret_2d():
    """The plain 2D K4 (the neural image's int8 forward) against the
    Pallas K4 on a 2D grid of three level groups, to f32 rounding."""
    _check_i8_forward_against_pallas(MULTIGROUP_2D, 18)


def _check_i8_forward_against_pallas(meta_kw, seed):
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import blocked_grid_encode_i8fwd
    table, pos, _ = _inputs(meta_kw, seed=seed, n=512)
    meta = tbg.BlockedGridMeta(**meta_kw)
    got = blocked_grid_cuda.blocked_grid_encode_i8fwd(
        torch.from_numpy(table), torch.from_numpy(pos), meta).numpy()
    tq, sc = tbg.quantize_table_i8(torch.from_numpy(table))
    np.testing.assert_array_equal(
        got, tbg.encode_reference_i8(tq, sc, torch.from_numpy(pos),
                                     meta).numpy())
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(blocked_grid_encode_i8fwd(
            table, pos, jbg.BlockedGridMeta(**meta_kw), 256))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # and it is the f32 encode up to the quantisation step
    f32 = tbg.encode_reference(torch.from_numpy(table), torch.from_numpy(pos),
                               meta).numpy()
    step = np.abs(table).max() / 127.0
    assert 0 < np.abs(got - f32).max() < step


def test_i8_backward_equals_f32_backward():
    """The int8 forward keeps the exact f32 table backward."""
    meta = tbg.BlockedGridMeta(**MULTIGROUP)
    table, pos, cot = (torch.from_numpy(a)
                       for a in _inputs(MULTIGROUP, seed=9, n=512))
    grads = []
    for encode in (blocked_grid_cuda.blocked_grid_encode,
                   blocked_grid_cuda.blocked_grid_encode_i8fwd):
        t = table.clone().requires_grad_()
        (encode(t, pos, meta) * cot).sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert float(grads[0].abs().sum()) > 0
