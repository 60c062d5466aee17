"""PyTorch / CUDA port of ``ngp_tpu`` for one NVIDIA H100.

The JAX package ``ngp_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find. It imports torch and
numpy only — never jax, and never a ``ngp_tpu`` module (that package
imports jax at the top).

Ported so far: the user surface in NeRF, SDF and image mode
(``api.testbed.Testbed``, ``python -m ngp_tpu_torch`` and ``python -m
ngp_tpu_torch.run``), the NeRF renderer with its render modes
(``render.nerf_render``), the multi-NeRF engine (``render.multi_nerf``),
the NeRF trainer with camera optimisation (``train.nerf``), the image and
SDF trainers (``train.image``, ``train.sdf``) and the SDF renderer
(``render.sdf_render``), with the blocked hash-grid encode and its
gradients as hand-written CUDA kernels (``csrc/blocked_grid_encode.cu``;
the forward and table backward for 2D grids too).
"""
