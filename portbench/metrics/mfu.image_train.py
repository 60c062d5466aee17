"""The whole step's share of the card's f32 peak, with TF32 off as the
program runs its products (``readers.mfu``). Layer: the device. Source:
device trace. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

SPANS = readers.TRAIN_NETWORK
CAPTURES = readers.ENCODES

read = readers.mfu
