"""The bodies of the per-layer metrics' readers, and the spans and captures
they need. A reader (``metrics/<name>.py``) names its ``SPANS`` and
``CAPTURES`` and reads its metric from the traced window (``tc``, the
harness's ``TraceContext``) with one of these; each returns None where the
window had nothing for it to read.
"""
from __future__ import annotations

from portbench.lib import geometry as geo

MODELS = "ngp_tpu_torch.nn.models"
KERNELS = "ngp_tpu_torch.kernels.blocked_grid_cuda"

# every blocked-grid encode launch: (module, attribute, kind, index of the
# positions argument)
ENCODES = [(KERNELS, "launch_fwd", "fwd", 1), (KERNELS, "launch_bwd", "bwd", 0),
           (KERNELS, "launch_fwd_i8", "fwd_i8", 2),
           (KERNELS, "launch_bwd_i8", "bwd_i8", 0),
           (KERNELS, "launch_bwd_pos", "bwd_pos", 1)]
# the network's forward: in a training step (the NeRF trainer's ``apply``,
# the image trainer's encoded network), and in a frame
TRAIN_NETWORK = [(MODELS, "NerfNetwork.apply", "network"),
                 (MODELS, "EncodedNetwork.forward", "network")]
FRAME_NETWORK = [(MODELS, "NerfNetwork.forward", "network"),
                 (MODELS, "EncodedNetwork.forward", "network")]
ADAM = [("ngp_tpu_torch.train.nerf", "apply_update", "adam"),
        ("ngp_tpu_torch.train.image", "apply_update", "adam")]
TRAIN_MARCH = [("ngp_tpu_torch.train.nerf", "march_and_compact_hier",
                "march"),
               ("ngp_tpu_torch.train.nerf", "march_and_compact", "march")]
FRAME_MARCH = [("ngp_tpu_torch.render.nerf_render",
                "NerfRenderer._wave_march", "march"),
               ("ngp_tpu_torch.render.nerf_render",
                "NerfRenderer._wave2_stream", "march"),
               ("ngp_tpu_torch.render.nerf_render", "march_rays", "march")]


def span_ms(tc, name: str):
    """Device ms a step or frame launched inside span ``name``."""
    s = tc.span_s(name)
    return None if s is None else 1e3 * s / tc.units


def host_syncs(tc):
    """Synchronizing CUDA operations that the card's sync debug mode warns
    of, with the program's own event waits, a step or frame (frozen from
    ``chip_smoke.count_syncs``)."""
    return (tc.syncs + tc.event_waits) / tc.units


def idle_share(tc):
    """1 − (the union of the device's busy intervals) / (the window)."""
    if tc.busy_s <= 0:
        return None
    return 1.0 - tc.busy_s / tc.window_s


def encode_roofline(tc):
    """The encode calls' least time (each the larger of its bytes over the
    HBM rate and its operations over the f32 rate) over the device time of
    the ``blocked_grid_encode*`` kernels, in %. Bytes count the entries
    the corners touch, a table gradient's too (``lib/geometry.py``)."""
    kernel_s = tc.op_s("blocked_grid_encode")
    if not tc.rec.encodes or kernel_s <= 0:
        return None
    least = sum(geo.encode_least_s(kind, tc.meta[pos.shape[1]], pos)
                for kind, pos in tc.rec.encodes)
    return 100.0 * least / kernel_s


def mfu(tc):
    """The whole window's share of the f32 peak, in %: 2 FLOPs a
    multiply-add of the MLPs at the published widths for every sample the
    network span was given, times the passes (3 a training step: the
    forward and both backward products; 1 a frame), plus every captured
    encode call's operations."""
    n = tc.samples("network")
    if not n or tc.busy_s <= 0:
        return None
    flops = 2.0 * tc.macs_per_sample * tc.passes * n
    flops += sum(geo.flops_per_lookup(kind, pos.shape[1]) * pos.shape[0]
                 * tc.meta[pos.shape[1]].n_levels
                 for kind, pos in tc.rec.encodes)
    return 100.0 * flops / (tc.window_s * geo.F32_FLOPS)
