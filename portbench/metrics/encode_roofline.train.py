"""The blocked-grid encode kernels' share of their roofline in the traced
steps (``readers.encode_roofline``). Layer: the kernels
(``kernels/blocked_grid_cuda.py``, ``csrc/blocked_grid_encode.cu``).
Source: device trace. Cell nerf-train-synth;
moves train_ms_per_step."""
from portbench.lib import readers

CAPTURES = readers.ENCODES

read = readers.encode_roofline
