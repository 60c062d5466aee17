"""The device's idle share of the traced steps. Layer: the device.
Source: device trace. Cell image-train-8k;
moves train_ms_per_step.image."""
from portbench.lib import readers

read = readers.idle_share
