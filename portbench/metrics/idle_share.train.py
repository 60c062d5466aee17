"""The device's idle share of the traced steps. Layer: the device.
Source: device trace. Cell nerf-train-synth;
moves train_ms_per_step."""
from portbench.lib import readers

read = readers.idle_share
