"""The blocked-grid encode kernels' share of their roofline in the traced
steps (``readers.encode_roofline``). Layer: the kernels
(``kernels/blocked_grid_cuda.py``, ``csrc/blocked_grid_encode.cu``).
Source: device trace. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

CAPTURES = readers.ENCODES

read = readers.encode_roofline
