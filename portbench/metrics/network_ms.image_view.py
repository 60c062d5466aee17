"""Device ms a frame launched inside the network forward's span (the
encode, K1 on the card, and the MLPs). Layer: the network
(``nn/models.py``, ``nn/mlp.py``, ``nn/encodings.py``). Source: device
trace. Cell image-view-1080p;
moves frame_ms.image."""
from portbench.lib import readers

SPANS = readers.FRAME_NETWORK


def read(tc):
    return readers.span_ms(tc, "network")
