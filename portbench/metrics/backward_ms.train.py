"""Device ms a step launched inside the program's ``ngp.backward`` span
(the autograd backward: the MLPs' backward products and the table's
gradient, K2 on the card), which runs on the calling thread while a
profiler records. Layer: network backward and K2. Source: device trace.
Cell nerf-train-synth; moves train_ms_per_step."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.span_ms(tc, "ngp.backward")
