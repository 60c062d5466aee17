"""Device ms a step launched inside the march's span (lattice, occupancy
tests and compaction). Layer: the march (``rays/marching.py``,
``grid/occupancy.py``). Source: device trace. Cell nerf-train-synth;
moves train_ms_per_step."""
from portbench.lib import readers

SPANS = readers.TRAIN_MARCH


def read(tc):
    return readers.span_ms(tc, "march")
