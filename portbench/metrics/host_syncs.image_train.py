"""Host syncs a step: the synchronizing CUDA operations of the traced
steps, with the program's own event waits. Layer: the train loop and the
renderer's host code. Source: program counter. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

read = readers.host_syncs
