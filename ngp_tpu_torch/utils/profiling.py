"""Tracing and profiling: EMA-smoothed phase meters and a torch.profiler
trace (port of ``ngp_tpu/utils/profiling.py``; ref: the Ema class,
common.h:253-298, and the training_prep/train/render meters,
testbed.h:867-874).

``device_trace`` records the host's and, where there is one, the card's
activity with ``torch.profiler`` (CUPTI on the card) where the JAX
package records a ``jax.profiler`` trace; the trace is written as a Chrome
trace (``trace.json``, for Perfetto or chrome://tracing) into ``logdir``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from ngp_tpu_torch.common import EmaMeter


class PhaseTimers:
    """Named EMA wall-clock meters: with timers.scope("train"): ..."""

    def __init__(self, half_life: float = 1.0):
        self.meters: Dict[str, EmaMeter] = {}
        self.half_life = half_life

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.meters.setdefault(name, EmaMeter(self.half_life)).update(ms)

    def report(self) -> str:
        return "  ".join(f"{k}={m.value:.1f}ms"
                         for k, m in sorted(self.meters.items()))


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """Trace the enclosed work with torch.profiler (CPU, and CUDA when the
    card is there) into ``<logdir>/trace.json``; ``logdir`` defaults to
    ``ngp_tpu_torch_trace`` in the temporary directory. Yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "ngp_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
