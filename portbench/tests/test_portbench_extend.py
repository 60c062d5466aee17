"""A new configuration, cell and per-layer metric take new files and
manifest entries only: in a copy of the benchmark, a dummy image
configuration, a cell on it and a metric that counts its calls are added,
and a traced run reports the metric, with no file that was there
changed."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

METRIC = '''"""Calls of the image network a frame (a dummy of the test)."""
SPANS = [("ngp_tpu_torch.nn.models", "EncodedNetwork.forward", "net")]


def read(tc):
    return tc.rec.calls.get("net", 0) / tc.units
'''


def _digest(root: Path) -> dict:
    files = [p for p in sorted(root.rglob("*"))
             if p.is_file() and "__pycache__" not in p.parts]
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_new_cell_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "image-base.json").read_text())
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["dataset"].update(resolution=64, n_discs=3)
    (pb / "configs" / "dummy-image.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "dummy-view.json").write_text(json.dumps({
        "config": "dummy-image", "entry": "image_view",
        "traffic": {"frame": [32, 16], "weights": {"table": [-1, 1]},
                    "warmup_frames": 1, "compare_frames": 1,
                    "compare_among": 4, "trace_calls": 3},
        "limits": {"rel_mean": 2e-5, "share_off": 1e-5}}))
    (pb / "metrics" / "net_calls.render.py").write_text(METRIC)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({**manifest["configs"][1],
                                "name": "dummy-image",
                                "file": "portbench/configs/dummy-image.json"})
    manifest["workloads"].append({"name": "dummy-view",
                                  "config": "dummy-image",
                                  "traffic": "dummy-view", "chips": 1,
                                  "why": "a test's dummy"})
    for m in manifest["end_to_end"]:
        if m["name"] == "frame_ms.image":
            m["workloads"].append("dummy-view")
    manifest["per_layer"].append({
        "name": "net_calls.render", "unit": "calls/frame", "better": "lower",
        "source": "program_counter", "layer": "network",
        "moves": "frame_ms.image", "workloads": ["dummy-view"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digest(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from portbench import harness; "
            "assert harness.__file__.startswith(sys.argv[1]); "
            "print(json.dumps(harness.run('dummy-view', 4, 0.2, True, 'cpu',"
            " log=lambda *a, **k: None)))")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                           str(ROOT)], capture_output=True, text=True,
                          check=True, cwd=tmp_path)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["net_calls.render"]["value"] >= 1
