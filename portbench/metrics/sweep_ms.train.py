"""Device ms a step launched inside the program's ``ngp.sweep`` span (the
occupancy grid's sweep every 16 steps: its density forwards and the
bitfield's rebuild), over the steps of the window. Layer: occupancy grid
(``grid/occupancy.py``). Source: device trace. Cell nerf-train-synth;
moves train_ms_per_step."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.span_ms(tc, "ngp.sweep")
