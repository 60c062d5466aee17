"""Samples a frame that the renderer evaluated, by the program's
``samples`` counter (its ``last_n_samples``, an integer the host holds).
Layer: march. Source: program counter. Cell nerf-render-720p; moves
frame_ms."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.count_per_unit(tc, "samples", "ngp.frame")
