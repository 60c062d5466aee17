"""Host syncs a frame: the synchronizing CUDA operations of the traced
frames, with the program's own event waits. Layer: the train loop and the
renderer's host code. Source: program counter. Cell image-view-1080p;
moves frame_ms.image."""
from portbench.lib import readers

read = readers.host_syncs
