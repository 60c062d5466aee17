"""Device ms a step launched inside the network forward's span (the
encode, K1 on the card, and the MLPs). Layer: the network
(``nn/models.py``, ``nn/mlp.py``, ``nn/encodings.py``). Source: device
trace. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

SPANS = readers.TRAIN_NETWORK


def read(tc):
    return readers.span_ms(tc, "network")
