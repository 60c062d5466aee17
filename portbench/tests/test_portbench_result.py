"""The last line's keys, and the refusals of run.py."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.sizes import TINY

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced, quiet):
    cell = "image-view-1080p"
    out = harness.run(cell, 3, 0.2, traced, "cpu", overrides=TINY[cell],
                      log=quiet)
    assert list(out) == KEYS + (["breakdown"] if traced else []) + ["checks"]
    json.dumps(out)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    else:
        assert set(out["metrics"]) == {"frame_ms.image", "frame_ms_p95",
                                      "setup_s"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_metrics_of_each_cell_follow_the_manifest():
    manifest = harness.load_json(harness.MANIFEST)
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    for w in manifest["workloads"]:
        e2e, layer = harness.cell_metrics(manifest, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert all(m["moves"] in names for m in layer)
        for m in layer:
            assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "image-view-1080p",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_run_refuses_without_the_program(tmp_path, card):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "image-view-1080p",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
