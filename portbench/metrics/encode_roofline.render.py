"""The blocked-grid encode kernels' share of their roofline in the traced
frames (``readers.encode_roofline``). Layer: the kernels
(``kernels/blocked_grid_cuda.py``, ``csrc/blocked_grid_encode.cu``).
Source: device trace. Cell nerf-render-720p;
moves frame_ms."""
from portbench.lib import readers

CAPTURES = readers.ENCODES

read = readers.encode_roofline
