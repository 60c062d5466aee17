"""Device ms a step launched inside ``apply_update``'s span (Adam, the
decay and the EMA over every parameter). Layer: the optimizer
(``opt/optimizers.py``). Source: device trace. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

SPANS = readers.ADAM


def read(tc):
    return readers.span_ms(tc, "adam")
