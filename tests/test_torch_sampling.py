"""The image trainer's samplers (ngp_tpu_torch/rays/sampling.py) against the
JAX package's: Halton and Sobol points bit for bit, stratify2 on given
positions bit for bit. The uniform draws themselves come from a
torch.Generator in the port (an intended divergence), so only their
shape, range and stratification are checked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.rays import sampling as js
from ngp_tpu_torch.rays import sampling as ts


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("mode", ["halton", "sobol"])
@pytest.mark.parametrize("step", [0, 1, 37, 16383, 70000])
def test_low_discrepancy_batches_match_jax_bit_for_bit(mode, step):
    # B·step passes 2^32 for the last step: the index wraps as uint32
    got = ts.sample_positions(mode, None, 1 << 16, step).numpy()
    ref = js.sample_positions(mode, jax.random.PRNGKey(0), 1 << 16, step)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_sobol_seed_scramble_and_halton_parts_match_jax():
    idx = np.arange(0, 1 << 20, 97, dtype=np.uint32)
    t_idx = torch.from_numpy(idx.astype(np.int64))
    for seed in (0, 1, 1337):
        np.testing.assert_array_equal(
            _bits(ts.sobol2(t_idx, seed).numpy()),
            _bits(js.sobol2(jnp.asarray(idx), seed)))
    np.testing.assert_array_equal(
        _bits(ts.radical_inverse(t_idx, 3).numpy()),
        _bits(js.radical_inverse(jnp.asarray(idx), 3)))


@pytest.mark.parametrize("log2_batch", [2, 8, 12])
def test_stratify2_matches_jax_on_given_positions(log2_batch):
    pos = np.random.default_rng(log2_batch).random(
        (3 << log2_batch, 2), dtype=np.float32)
    got = ts.stratify2(torch.from_numpy(pos), log2_batch).numpy()
    ref = js.stratify2(jnp.asarray(pos), log2_batch)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_generator_draws_are_stratified_and_seeded():
    g = torch.Generator().manual_seed(5)
    a = ts.sample_positions("stratified", g, 1 << 10, 0)
    b = ts.sample_positions("stratified",
                            torch.Generator().manual_seed(5), 1 << 10, 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (1 << 10, 2) and a.dtype == torch.float32
    cell = torch.floor(a * 32).long()
    k = torch.arange(1 << 10)
    torch.testing.assert_close(cell[:, 0], k % 32, rtol=0, atol=0)
    torch.testing.assert_close(cell[:, 1], k // 32, rtol=0, atol=0)
    # a batch that is not an even power of two stays uniform
    u = ts.sample_positions("stratified", g, 1 << 9, 0)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert not torch.equal(torch.floor(u * 16).long()[:, 0],
                           torch.arange(1 << 9) % 16)
