"""What every entry shares: the cell's files, the device, the counters the
harness reads, and a seeded sample of the window's results."""
from __future__ import annotations

import statistics

import numpy as np

# the keys of instant-ngp's network configs, the part of a configuration
# file that the program reads
NETWORK_KEYS = ("loss", "optimizer", "encoding", "network", "dir_encoding",
                "rgb_network", "distortion_map", "envmap")


class BaseEntry:
    unit = "call"
    passes = 1

    def __init__(self, config: dict, workload: dict, seed: int, dev):
        self.config, self.workload, self.seed, self.dev = (config, workload,
                                                           seed, dev)
        self.device = dev.dev
        self.network_config = {k: config[k] for k in NETWORK_KEYS
                               if k in config}
        self.data = config["dataset"]
        self.traffic = workload["traffic"]
        self.limits = workload["limits"]
        self.event_waits = 0
        self.metas = {}
        self.macs_per_sample = 0
        self._notes = []

    def note(self, line: str):
        self._notes.append(line)

    def notes(self) -> list:
        return self._notes

    def reset_counters(self):
        self.event_waits = 0

    def after_window(self) -> dict:
        return {}


class Sample:
    """The results of a seeded choice of ``k`` of the first ``among`` calls
    of the window (and of the first call, so that a short window keeps
    one): which calls are kept depends on the seed alone."""

    def __init__(self, seed: int, k: int, among: int):
        rng = np.random.default_rng(seed)
        self.picks = {0} | {int(i) for i in rng.choice(
            among, size=min(k, among), replace=False)}
        self.seen, self.kept = 0, []

    def offer(self, item):
        if self.seen in self.picks:
            self.kept.append(item)
        self.seen += 1


def step_metrics(units: int, window_s: float) -> dict:
    return {"train_ms_per_step": window_s * 1e3 / max(units, 1)}


def frame_metrics(units: int, window_s: float, per_call_ms: list) -> dict:
    p95 = (statistics.quantiles(per_call_ms, n=20)[-1]
           if len(per_call_ms) >= 2 else per_call_ms[0])
    return {"frame_ms": window_s * 1e3 / max(units, 1),
            "frame_ms_p50": statistics.median(per_call_ms),
            "frame_ms_p95": p95}


def mlp_macs(shapes: dict) -> int:
    """Multiply-adds a sample of the MLP matrices in ``shapes`` takes."""
    return sum(s[0] * s[1] for s in shapes.values() if len(s) == 2)
