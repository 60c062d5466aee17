"""Spans, captures, sync counts and the reading of a device trace.

Frozen here from ``chip_smoke.py``: ``_attribute_kernels`` (device work
matched to the span that launched it through the profiler's correlation
ids) and ``count_syncs`` (the card's sync debug mode). The spans are
``record_function`` ranges put around the program's functions from
outside, by module and attribute, while a traced window runs.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import math
import warnings

import torch


def resolve(path: str, attr: str):
    """(owner, name) of ``attr`` (``Class.method`` or ``function``) in the
    module ``path``, or None where the program has no such attribute."""
    try:
        owner = importlib.import_module(path)
    except ImportError:
        return None
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    return (owner, name) if hasattr(owner, name) else None


class Recorder:
    """What the spans saw: per span name, its calls and the samples (first
    dimension of the first tensor argument) it was given; and the
    captured encode calls (kind, positions)."""

    def __init__(self):
        self.calls = collections.Counter()
        self.samples = collections.Counter()
        self.encodes = []


def _first_tensor(args):
    return next((a for a in args if isinstance(a, torch.Tensor)), None)


@contextlib.contextmanager
def installed(spans, captures, rec: Recorder):
    """Wrap each (module, attribute, span name) of ``spans`` in a
    ``record_function`` range and each (module, attribute, kind, index of
    the positions argument) of ``captures`` in a recorder of its positions,
    for the duration of the block; attributes the program lacks are
    skipped."""
    from torch.profiler import record_function
    undo = []

    def patch(path, attr, make):
        found = resolve(path, attr)
        if found is None:
            return
        owner, name = found
        fn = getattr(owner, name)
        setattr(owner, name, make(fn))
        undo.append((owner, name, fn))

    def span(fn, name):
        def wrapped(*args, **kwargs):
            t = _first_tensor(args)
            rec.calls[name] += 1
            if t is not None and t.dim() > 0:
                rec.samples[name] += t.shape[0]
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    def capture(fn, kind, index):
        def wrapped(*args, **kwargs):
            rec.encodes.append((kind, args[index].detach().clone()))
            return fn(*args, **kwargs)
        return wrapped
    try:
        for path, attr, name in dict.fromkeys(map(tuple, spans)):
            patch(path, attr, lambda fn, n=name: span(fn, n))
        for path, attr, kind, index in dict.fromkeys(map(tuple, captures)):
            patch(path, attr, lambda fn, k=kind, i=index: capture(fn, k, i))
        yield rec
    finally:
        for owner, name, fn in reversed(undo):
            setattr(owner, name, fn)


@contextlib.contextmanager
def sync_counter():
    """Count the synchronizing CUDA operations in the block (each
    ``nonzero``, ``.item()``, waiting copy and synchronize), as the card's
    sync debug mode warns of them. Yields a list that holds the count once
    the block has ended."""
    out = [0]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield out
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out[0] = sum("synchronizing" in str(w.message) for w in caught)


def read_trace(prof, span_names: set, main_span: str) -> dict:
    """Device work of a trace: per span name, the device seconds of the
    work launched inside it on the thread that launched it (a kernel counts
    in every span around its launch; the backward runs on autograd's own
    thread and counts in none of the main thread's); device seconds by
    operation name; the busy seconds (the union of the device intervals)
    and the device intervals, merged, with the innermost span of the main
    thread open where each idle gap starts. A kernel counts once in a span
    name, however many spans of that name are open around its launch."""
    from torch.autograd import DeviceType
    ev = prof.profiler.kineto_results.events()
    work = [e for e in ev if e.device_type() == DeviceType.CUDA
            and e.name() not in span_names]
    launch = {e.correlation_id(): e for e in ev
              if e.device_type() == DeviceType.CPU
              and (e.name().startswith(("cuda", "cu")) and "Launch" in e.name()
                   or e.name().startswith(("cudaMemcpy", "cudaMemset")))}
    spans = [e for e in ev if e.device_type() == DeviceType.CPU
             and e.name() in span_names]
    main = [s for s in spans if s.name() == main_span]
    main_tids = {s.start_thread_id() for s in main}
    per_span = collections.Counter()
    by_op = collections.Counter()
    unmatched = 0
    for k in work:
        s = k.duration_ns() / 1e9
        by_op[k.name()] += s
        r = launch.get(k.correlation_id())
        if r is None:
            unmatched += 1
            continue
        for name in {sp.name() for sp in spans
                     if sp.start_thread_id() == r.start_thread_id()
                     and sp.start_ns() <= r.start_ns() <= sp.end_ns()}:
            per_span[name] += s
    merged = []
    for s0, s1 in sorted((k.start_ns(), k.end_ns()) for k in work):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    busy = sum(s1 - s0 for s0, s1 in merged) / 1e9
    lo = min((s.start_ns() for s in main), default=None)
    hi = max((s.end_ns() for s in main), default=None)
    gaps = collections.Counter()
    if lo is not None:
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        host = [s for s in spans if s.start_thread_id() in main_tids]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            g0, g1 = max(g0, lo), min(g1, hi)
            if g1 <= g0:
                continue
            open_ = [s for s in host if s.start_ns() <= g0 < s.end_ns()]
            inner = min(open_, key=lambda s: s.end_ns() - s.start_ns(),
                        default=None)
            gaps[inner.name() if inner else "outside the window"] += \
                (g1 - g0) / 1e9
    return {"per_span_s": dict(per_span), "by_op_s": dict(by_op),
            "busy_s": busy, "idle_by_span_s": dict(gaps),
            "unmatched": unmatched, "events": len(work)}


def top(counter: dict, n: int = 10) -> list:
    """The ``n`` largest entries as [[name, seconds], ...]."""
    return [[k[:120], v] for k, v in sorted(counter.items(),
                                             key=lambda kv: -kv[1])[:n]]


def finite(x) -> bool:
    return x is not None and math.isfinite(x)
