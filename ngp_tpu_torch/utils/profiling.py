"""Tracing: the program's named spans and counters, and a Chrome-trace
exporter.

``span(name)`` opens a ``torch.profiler`` range (``record_function``)
while a profiler records, and otherwise returns one shared null context,
so a span costs a flag test when no one traces. Being profiler ranges,
the spans share the profiler's clock with the card's kernels (CUPTI): a
trace charges each kernel launch and each idle gap of the card to the
innermost span open on the host. ``count(name, n)`` adds an integer the
host already holds (never a device read) to a counter, again only while a
profiler records; each opening of a span counts under the span's name.
``counters()`` returns the counts of the current traced window: a window
ends when the program, or a read of ``counters()``, finds no profiler
recording, and the next count then starts a new one.

``device_trace`` records the host's and, where there is one, the card's
activity with ``torch.profiler`` (CUPTI on the card) where the JAX
package records a ``jax.profiler`` trace; the trace, spans included, is
written as a Chrome trace (``trace.json``, for Perfetto or
chrome://tracing) into ``logdir``.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

# every span the program opens, and what it covers
SPAN_NAMES = (
    # one training step: NerfTrainer._train_step, ImageTrainer.step
    "ngp.step",
    # one frame: NerfRenderer.render, ImageTrainer.render
    "ngp.frame",
    # the draws, pixels, targets and rays of a step or work item (the
    # error-map CDFs with them); the image's positions and their targets
    "ngp.sample",
    # the occupancy march and its compaction into a sample stream
    "ngp.march",
    # a network forward (NerfNetwork.forward, EncodedNetwork.forward), and
    # around it a caller's sample positions and output activations; it may
    # open inside itself
    "ngp.network",
    # a training step's composite and loss, from the network's output to
    # the scaled loss
    "ngp.loss",
    # a renderer's composite of its samples into pixels and the frame
    "ngp.composite",
    # the backward of a step; while a profiler records it runs on the
    # calling thread, so its launches lie inside the span
    "ngp.backward",
    # the optimizer updates: apply_update, camera_adam
    "ngp.adam",
    # the error map's deposit
    "ngp.error_map",
    # an occupancy-grid sweep (its network forwards nest inside)
    "ngp.sweep",
    # the training loop's reads of its loss and counts, and the ray-budget
    # probe
    "ngp.stats",
    # a renderer's host reads of its counts (event waits, list reads)
    "ngp.wait",
    # the copy of a finished frame to host memory
    "ngp.to_host",
)
# host-known integers a step or frame counts: the samples its march
# emitted (a renderer's: those it evaluated)
COUNTER_NAMES = ("samples",)
_KNOWN = frozenset(SPAN_NAMES + COUNTER_NAMES)
_NULL = contextlib.nullcontext()


class _Window:
    """The counts of the current traced window (the renderer of the pyngp
    shim counts from a thread of its own, hence the lock)."""

    def __init__(self):
        self.counts: dict = {}
        self.ended = False
        self.lock = threading.Lock()

    def add(self, name: str, n: int):
        if name not in _KNOWN:
            raise ValueError(f"unknown span or counter {name!r}")
        with self.lock:
            if self.ended:
                self.counts, self.ended = {}, False
            self.counts[name] = self.counts.get(name, 0) + int(n)


_window = _Window()


def span(name: str):
    """A context that is the profiler range ``name`` (one of SPAN_NAMES)
    while a profiler records, and a shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        _window.ended = True
        return _NULL
    _window.add(name, 1)
    if name != "ngp.backward":
        return _profiler.record_function(name)
    stack = contextlib.ExitStack()
    stack.enter_context(torch.autograd.set_multithreading_enabled(False))
    stack.enter_context(_profiler.record_function(name))
    return stack


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int):
    """Add the host integer ``n`` to counter ``name`` (one of
    COUNTER_NAMES) while a profiler records."""
    if not _profiler._is_profiler_enabled:
        _window.ended = True
        return
    _window.add(name, n)


def counters() -> dict:
    """The counts of the current traced window, or of the last one once
    it has ended: each counter's sum and each span's openings, by name.

    A window ends only when a span, a count or this read finds no
    profiler recording. Two profiler sessions run back to back, with no
    such call between them, share one window and read the sum of both;
    read ``counters()`` between them to keep them apart."""
    if not _profiler._is_profiler_enabled:
        _window.ended = True
    with _window.lock:
        return dict(_window.counts)


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
