"""The program's own spans and counters (``ngp_tpu_torch/utils/
profiling.py``), as the per-layer readers read them.

The program opens its spans itself, as ``torch.profiler`` ranges, while a
profiler records; a reader names them in its ``SPANS`` only so that the
trace reads them. Each entry gives an attribute the module does not have,
so ``lib/trace.py``'s ``resolve`` finds nothing and no wrapper is put
around anything. The names are frozen here: they are part of what the
metrics measure. A program without the spans or the counters (one older
than they are) gives every reader None.
"""
from __future__ import annotations

from portbench.lib import trace

PROFILING = "ngp_tpu_torch.utils.profiling"
NOT_AN_ATTRIBUTE = "<a span the program opens itself>"
NAMES = ("ngp.step", "ngp.frame", "ngp.sample", "ngp.march", "ngp.network",
         "ngp.loss", "ngp.composite", "ngp.backward", "ngp.adam",
         "ngp.error_map", "ngp.sweep", "ngp.stats", "ngp.wait",
         "ngp.to_host")
SPANS = [(PROFILING, NOT_AN_ATTRIBUTE, name) for name in NAMES]


def counters() -> dict:
    """The program's counts of the traced window (each counter's sum and
    each span's openings, by name), or {} where it keeps none. Found by
    name, as the spans' wrappers find what they wrap."""
    found = trace.resolve(PROFILING, "counters")
    if found is None:
        return {}
    owner, name = found
    return getattr(owner, name)()


def span_ms(tc, name: str):
    """Device ms a step or frame launched inside program span ``name``;
    None where the span never opened."""
    if not counters().get(name):
        return None
    return 1e3 * tc.tr["per_span_s"].get(name, 0.0) / tc.units


def unspanned_idle_ms(tc, top: str):
    """Device idle ms a step or frame whose innermost open span is the
    harness's ``window`` or the self time of the program's ``top`` span
    (``ngp.step``, ``ngp.frame``): idle that no layer's span explains.
    None where ``top`` never opened."""
    if not counters().get(top):
        return None
    idle = tc.tr["idle_by_span_s"]
    return 1e3 * (idle.get("window", 0.0) + idle.get(top, 0.0)) / tc.units


def count_per_unit(tc, name: str, top: str):
    """Counter ``name`` a step or frame; None where ``top`` never opened
    or the counter never counted."""
    c = counters()
    if not c.get(top) or name not in c:
        return None
    return c[name] / tc.units
