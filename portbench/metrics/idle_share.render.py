"""The device's idle share of the traced frames. Layer: the device.
Source: device trace. Cell nerf-render-720p;
moves frame_ms."""
from portbench.lib import readers

read = readers.idle_share
