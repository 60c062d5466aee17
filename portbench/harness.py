"""The benchmark's runner, the same for every cell.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), the entry that its window drives
(``entries/<entry>.py``) and its traffic parameters. The metrics a cell
reports are those of ``BENCHMARK.json`` that list it; a per-layer metric
is read by ``metrics/<metric>.py``. Adding a cell, a configuration or a
per-layer metric takes new files and manifest entries only.

One run: set-up (the entry builds its data, the program and its state
from the seed, and warms up every shape the window uses), then a window
of calls for ``seconds``, each ending in a device synchronize; then the
quality measured after the window, the device's memory peak, the
program's state released, and the entry's comparison with the plain
reference. With ``trace`` the untraced window is followed by a traced
one of the cell's ``trace_calls`` calls, and the per-layer metrics are
read from it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench.lib import imports, trace

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


class Refused(RuntimeError):
    """A run that may print no result."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (deep_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def cell_metrics(manifest: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) of ``manifest`` that list
    ``cell`` under their ``workloads``. An end-to-end metric without
    ``workloads`` (``setup_s``) is reported in every cell; a per-layer
    metric always lists its cells."""
    return ([m for m in manifest["end_to_end"]
             if "workloads" not in m or cell in m["workloads"]],
            [m for m in manifest["per_layer"] if cell in m["workloads"]])


def quantity(name: str) -> str:
    """What an end-to-end metric measures: its name up to the first ``.``;
    the rest names the cells that one quantity is split into, each with a
    bound of its own (``frame_ms.image``)."""
    return name.split(".")[0]


def load_metric(name: str, root: Path = HERE):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Device:
    """The device a run measures on: the card, or the CPU in a rehearsal
    of the harness (whose numbers are no device metrics)."""

    def __init__(self, name: str):
        self.dev = torch.device(name)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def syncs(self):
        return (trace.sync_counter() if self.cuda
                else contextlib.nullcontext([0]))

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def info(self) -> dict:
        return {"platform": "gpu" if self.cuda else "cpu",
                "kind": (torch.cuda.get_device_name(self.dev) if self.cuda
                         else "cpu"),
                "count": 1}


class TraceContext:
    """What a per-layer metric's reader reads from a traced window."""

    def __init__(self, rec, tr: dict, units: int, window_s: float,
                 syncs: int, entry):
        self.rec, self.tr, self.units, self.window_s = rec, tr, units, window_s
        self.syncs = syncs
        self.event_waits = entry.event_waits
        self.busy_s = tr["busy_s"]
        self.meta = entry.metas          # grid geometry by dimension
        self.macs_per_sample = entry.macs_per_sample
        self.passes = entry.passes       # 3 for a training step, 1 a frame

    def span_s(self, name: str):
        """Device seconds launched inside span ``name``, None where the span
        never ran."""
        if not self.rec.calls.get(name):
            return None
        return self.tr["per_span_s"].get(name, 0.0)

    def samples(self, name: str) -> int:
        return self.rec.samples.get(name, 0)

    def op_s(self, substring: str) -> float:
        return sum(s for k, s in self.tr["by_op_s"].items()
                   if substring in k)


def _checks_text(checks: list) -> list:
    return [f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in checks]


def run(cell: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float = None, overrides=None,
        breaker=None, manifest: dict = None, log=print,
        control: bool = False) -> dict:
    """One run of ``cell``; returns the result's object (the last line a
    run prints). ``overrides`` (``{"config": {...}, "workload": {...}}``)
    are merged into the cell's files, for rehearsals at a small size;
    ``breaker``, a context manager, is held around set-up and window (a
    fault planted in the program, for the tests of the comparison). With
    ``control`` the result also holds, under ``control``, the numbers of
    the reference computed one precision lower put in the program's
    place."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_json(MANIFEST)
    overrides = overrides or {}
    workload = deep_merge(load_json(HERE / "workloads" / f"{cell}.json"),
                          overrides.get("workload"))
    config = deep_merge(load_json(HERE / "configs"
                                  / f"{workload['config']}.json"),
                        overrides.get("config"))
    e2e, layer = cell_metrics(manifest, cell)
    readers = {m["name"]: load_metric(m["name"]) for m in layer} \
        if traced else {}
    dev = Device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry_mod = importlib.import_module(
        f"portbench.entries.{workload['entry']}")
    entry = entry_mod.Entry(config, workload, int(seed), dev)
    brk = breaker if breaker is not None else contextlib.nullcontext()

    with brk:
        entry.setup()
        dev.sync()
        setup_s = time.perf_counter() - t_start
        _refuse_forbidden(log)
        units, times = 0, []
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            units += entry.call()
            dev.sync()
            times.append(time.perf_counter() - c0)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        per_unit = [t * 1e3 for t in times]
        window_vals = entry.window_metrics(units, window_s, per_unit)
        traced_out = (_traced_window(entry, dev, readers, workload)
                      if traced else None)
    quality = {} if traced else entry.after_window()
    peak = dev.peak()
    entry.release()
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()
    checks = entry.check()
    ctrl = entry.control() if control else None
    dev.sync()
    _refuse_forbidden(log)

    values = {"setup_s": setup_s, **quality, **window_vals}
    unit_of = {m["name"]: m["unit"] for m in manifest["end_to_end"]
               + manifest["per_layer"]}
    if traced:
        metrics = {k: v for k, v in traced_out["values"].items()
                   if v is not None}
    else:
        metrics = {m["name"]: values[quantity(m["name"])] for m in e2e}
    correct = all(trace.finite(v) and v <= lim for _, v, lim in checks) \
        and all(trace.finite(v) for v in metrics.values())
    n_fail = sum(1 for _, v, lim in checks
                 if not (trace.finite(v) and v <= lim))
    log(f"window: {units} {entry.unit}s in {window_s:.4f} s; "
        f"median {statistics.median(per_unit):.4f} ms a call; "
        + "; ".join(f"{k} {v!r}" for k, v in values.items()), file=sys.stderr)
    for line in entry.notes():
        log(line, file=sys.stderr)
    device_info = {**dev.info(), "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": units, "failed": n_fail,
           "metrics": {k: {"value": v, "unit": unit_of[k]}
                       for k, v in metrics.items()},
           "device": device_info}
    if traced:
        device_info.update(busy_s=traced_out["busy_s"],
                           window_s=traced_out["window_s"])
        out["breakdown"] = traced_out["breakdown"]
    if ctrl is not None:
        out["control"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in ctrl}
        out["detail"] = getattr(entry, "detail", None)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for line in _checks_text(checks):
        log(line, file=sys.stderr)
    return out


def _traced_window(entry, dev, readers: dict, workload: dict) -> dict:
    """Trace the cell's ``trace_calls`` calls with the readers' spans and
    captures in place, and read every per-layer metric."""
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = [s for r in readers.values() for s in getattr(r, "SPANS", [])]
    captures = [c for r in readers.values()
                for c in getattr(r, "CAPTURES", [])]
    names = {s[2] for s in spans} | {"window"}
    rec = trace.Recorder()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if dev.cuda else [])
    entry.reset_counters()
    units, syncs = 0, 0
    dev.sync()
    with trace.installed(spans, captures, rec), \
            profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(int(workload["traffic"]["trace_calls"])):
            with record_function("window"):
                with dev.syncs() as counted:
                    units += entry.call()
                dev.sync()
            syncs += counted[0]
        window_s = time.perf_counter() - t0
    tr = trace.read_trace(prof, names, "window")
    tc = TraceContext(rec, tr, units, window_s, syncs, entry)
    values = {}
    for name, reader in readers.items():
        v = reader.read(tc)
        values[name] = None if v is None else float(v)
    idle = dict(tr["idle_by_span_s"])
    return {"values": values, "busy_s": tr["busy_s"] if dev.cuda else 0.0,
            "window_s": window_s,
            "breakdown": {"device_ops": trace.top(tr["by_op_s"]),
                          "idle_gaps": trace.top(idle)}}


def _refuse_forbidden(log):
    found = imports.forbidden_loaded()
    if found:
        log("refused: loaded " + ", ".join(found), file=sys.stderr)
        raise Refused("forbidden modules loaded: " + ", ".join(found))

