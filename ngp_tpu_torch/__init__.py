"""PyTorch / CUDA port of ``ngp_tpu`` for one NVIDIA H100.

The JAX package ``ngp_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find. It imports torch and
numpy only — never jax, and never a ``ngp_tpu`` module (that package
imports jax at the top).

Ported so far: the NeRF render path (``render.nerf_render.NerfRenderer``
in SHADE mode) with the blocked hash-grid encode forward as a
hand-written CUDA kernel (``csrc/blocked_grid_encode.cu``).
"""
