"""Device idle ms a step that no layer's span explains: idle gaps
whose innermost open span is the harness's window or the self time of the
program's ``ngp.step`` span. Layer: train loop and renderer host. Source:
device trace. Cell nerf-train-synth; moves train_ms_per_step."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.unspanned_idle_ms(tc, "ngp.step")
