"""Device ms a frame launched inside the march's span (lattice, occupancy
tests and compaction). Layer: the march (``rays/marching.py``,
``grid/occupancy.py``). Source: device trace. Cell nerf-render-720p;
moves frame_ms."""
from portbench.lib import readers

SPANS = readers.FRAME_MARCH


def read(tc):
    return readers.span_ms(tc, "march")
