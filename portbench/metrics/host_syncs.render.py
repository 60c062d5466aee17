"""Host syncs a frame: the synchronizing CUDA operations of the traced
frames, with the program's own event waits. Layer: the train loop and the
renderer's host code. Source: program counter. Cell nerf-render-720p;
moves frame_ms."""
from portbench.lib import readers

read = readers.host_syncs
