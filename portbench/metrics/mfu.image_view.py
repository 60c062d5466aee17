"""The whole frame's share of the card's f32 peak, with TF32 off as the
program runs its products (``readers.mfu``). Layer: the device. Source:
device trace. Cell image-view-1080p;
moves frame_ms.image."""
from portbench.lib import readers

SPANS = readers.FRAME_NETWORK
CAPTURES = readers.ENCODES

read = readers.mfu
