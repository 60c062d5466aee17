"""Low-discrepancy and stratified samplers of the image trainer (port of
``ngp_tpu/rays/sampling.py``; ref: halton23 / sobol2 / stratify2,
src/testbed_image.cu:34-76, random_val.cuh).

Unsigned 32-bit arithmetic runs on int64 tensors holding uint32 values,
masked to 32 bits where it could overflow. Halton and Sobol points are
deterministic and equal the JAX package's bit for bit.

Intended divergence: the uniform draws under the stratified and uniform
modes come from a ``torch.Generator`` on the caller's device, not from a
``jax.random`` key; the two give other numbers from one seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_U32 = 0xFFFFFFFF
# 2^-32 as an f32: a uint32 → [0, 1)
_INV_2_32 = 2.3283064365386963e-10


def _u32(x) -> torch.Tensor:
    return x.to(torch.int64) & _U32


def _to_unit(i: torch.Tensor) -> torch.Tensor:
    """uint32 values → f32 in [0, 1): rounded to f32, then scaled."""
    return i.to(torch.float32) * torch.tensor(_INV_2_32, dtype=torch.float32,
                                              device=i.device)


def radical_inverse_base2(i: torch.Tensor) -> torch.Tensor:
    """Van der Corput sequence: the bit-reversed index, as f32 in [0, 1)."""
    i = _u32(i)
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i << 16) | (i >> 16)) & _U32
    return _to_unit(i)


def radical_inverse(i: torch.Tensor, base: int,
                    n_digits: int = 20) -> torch.Tensor:
    """Radical inverse in ``base`` over a fixed digit count, summed in f32
    digit by digit as the JAX package sums it."""
    i = _u32(i)
    inv = torch.tensor(1.0 / base, dtype=torch.float32, device=i.device)
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    factor = inv.clone()
    for _ in range(n_digits):
        result = result + (i % base).to(torch.float32) * factor
        factor = factor * inv
        i = i // base
    return result


def halton23(indices: torch.Tensor) -> torch.Tensor:
    """(N,) indices → (N, 2) Halton points (bases 2 and 3)."""
    return torch.stack([radical_inverse_base2(indices),
                        radical_inverse(indices, 3)], -1)


def _sobol_dim2_directions() -> np.ndarray:
    """Sobol dimension-2 direction numbers (primitive polynomial x²+x+1,
    m = [1, 3])."""
    v = np.zeros(32, np.uint32)
    m, a, s = [1, 3], 1, 2
    for i in range(s):
        v[i] = np.uint32(m[i] << (31 - i))
    for i in range(s, 32):
        val = v[i - s] ^ (v[i - s] >> s)
        for k in range(1, s):
            if (a >> (s - 1 - k)) & 1:
                val ^= v[i - k]
        v[i] = val
    return v


_SOBOL_V2 = _sobol_dim2_directions()


def sobol2(indices: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """(N,) indices → (N, 2) Sobol points (dimensions 1 and 2), the second
    XOR-scrambled by ``seed``."""
    i = _u32(indices)
    x = radical_inverse_base2(i)
    acc = torch.zeros_like(i)
    for bit in range(32):
        acc = acc ^ torch.where((i >> bit) & 1 > 0, int(_SOBOL_V2[bit]), 0)
    if seed:
        acc = acc ^ ((seed * 2654435761) & _U32)
    return torch.stack([x, _to_unit(acc)], -1)


def stratify2(positions: torch.Tensor, log2_batch_size: int) -> torch.Tensor:
    """Uniform (N, 2) samples stratified over a √B × √B grid per batch of
    B = 2^log2_batch_size (ref: stratify2_kernel,
    src/testbed_image.cu:62-76): sample k lands in cell (k mod √B, k div
    √B) of its batch. Needs an even log2_batch_size."""
    n = positions.shape[0]
    log2_size = log2_batch_size // 2
    size = 1 << log2_size
    idx = torch.arange(n, dtype=torch.int64, device=positions.device) \
        & ((1 << log2_batch_size) - 1)
    cell = torch.stack([(idx & (size - 1)).to(torch.float32),
                        (idx >> log2_size).to(torch.float32)], -1)
    div = torch.tensor(float(size), dtype=torch.float32,
                       device=positions.device)
    return positions / div + cell / div


def sample_positions(mode: str, generator: Optional[torch.Generator],
                     batch_size: int, step: int, seed: int = 1337,
                     device=None) -> torch.Tensor:
    """A (B, 2) training batch like Testbed::train_image (ref:
    src/testbed_image.cu:227-252): Halton or Sobol points from index
    B·step (mod 2^32), or uniform draws from ``generator``, stratified
    when B is an even power of two."""
    mode = mode.lower()
    if mode in ("halton", "sobol"):
        base = (batch_size * int(step)) & _U32
        idx = (base + torch.arange(batch_size, dtype=torch.int64,
                                   device=device)) & _U32
        return halton23(idx) if mode == "halton" else sobol2(idx, seed)
    pos = torch.rand((batch_size, 2), generator=generator, device=device,
                     dtype=torch.float32)
    if mode == "stratified":
        lb = int(batch_size).bit_length() - 1
        if (1 << lb) == batch_size and lb % 2 == 0:
            pos = stratify2(pos, lb)
    return pos
