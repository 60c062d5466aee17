"""Device idle ms a frame that no layer's span explains: idle gaps
whose innermost open span is the harness's window or the self time of the
program's ``ngp.frame`` span. Layer: train loop and renderer host. Source:
device trace. Cell nerf-render-720p; moves frame_ms."""
from portbench.lib import program

SPANS = program.SPANS


def read(tc):
    return program.unspanned_idle_ms(tc, "ngp.frame")
