"""The device's idle share of the traced frames. Layer: the device.
Source: device trace. Cell image-view-1080p;
moves frame_ms.image."""
from portbench.lib import readers

read = readers.idle_share
