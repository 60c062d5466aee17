"""Device idle ms a step that no layer's span explains: idle gaps
whose innermost open span is the harness's window or the self time of the
program's ``ngp.step`` span. Layer: train loop and renderer host. Source:
device trace. Cell image-train-8k; moves train_ms_per_step.image."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.unspanned_idle_ms(tc, "ngp.step")
