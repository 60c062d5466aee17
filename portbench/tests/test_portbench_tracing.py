"""The readers of the program's own spans and counters
(``lib/program.py``): a traced rehearsal of each cell at a tiny size on
the CPU reports each of them; on a program without the counters each
reads None and none raises; and the files the benchmark had before them
are unchanged (their digests below)."""
import hashlib
from pathlib import Path

import pytest

from portbench import harness
from portbench.lib import program
from portbench.tests.sizes import TINY

ROOT = Path(__file__).resolve().parents[2]
# the per-layer metrics that read the program's spans and counters
READERS = {
    "nerf-train-synth": ["backward_ms.train", "sweep_ms.train",
                         "unspanned_idle_ms.train"],
    "image-train-8k": ["backward_ms.image_train",
                       "unspanned_idle_ms.image_train"],
    "nerf-render-720p": ["samples.render", "unspanned_idle_ms.render"],
    "image-view-1080p": ["unspanned_idle_ms.image_view"],
}
# sha256 (first 16 hex digits) of each file the benchmark had before the
# readers of the program's spans were added
BEFORE = {
    "__init__.py": "e3b0c44298fc1c14",
    "configs/image-base.json": "181e6d3de1e335e4",
    "configs/nerf-base.json": "98b58b96af743ab9",
    "conftest.py": "ac27093ddec88782",
    "entries/__init__.py": "e3b0c44298fc1c14",
    "entries/base.py": "cacd4757686f4e00",
    "entries/image_train.py": "a6cf7fd9a4f0e120",
    "entries/image_view.py": "92833180e2e8263f",
    "entries/nerf_render.py": "378c08ee4b844193",
    "entries/nerf_train.py": "03a3f4a96f7b06ec",
    "harness.py": "a6f6f54c7c973cd7",
    "lib/__init__.py": "e3b0c44298fc1c14",
    "lib/compare.py": "9d3740846d706805",
    "lib/faults.py": "a5ef96db94fe4a43",
    "lib/geometry.py": "76699b1495aab47d",
    "lib/imports.py": "4f676640b96f3ef3",
    "lib/readers.py": "85b684055e080815",
    "lib/scenes.py": "cf0db24fc594ba57",
    "lib/trace.py": "fafd0118f7418119",
    "lib/weights.py": "13f9dbcc9820b36b",
    "metrics/adam_ms.image_train.py": "014191841f9412b8",
    "metrics/adam_ms.train.py": "9a25f55685cc1c97",
    "metrics/encode_roofline.image_train.py": "bb164b050ac0878e",
    "metrics/encode_roofline.image_view.py": "edeed7ca4e2a14e7",
    "metrics/encode_roofline.render.py": "37a36d542c6cf8fb",
    "metrics/encode_roofline.train.py": "970000a1cdf80537",
    "metrics/host_syncs.image_train.py": "06068d19d2fc37ab",
    "metrics/host_syncs.image_view.py": "e1b7183ae01b8cc1",
    "metrics/host_syncs.render.py": "d08834d5b5065b52",
    "metrics/host_syncs.train.py": "f1ae5e1ca4dbb935",
    "metrics/idle_share.image_train.py": "04954082ac38bd9f",
    "metrics/idle_share.image_view.py": "1d07ce30aad859ef",
    "metrics/idle_share.render.py": "0217d06ccbc9e3cf",
    "metrics/idle_share.train.py": "629c75a2598ba86e",
    "metrics/march_ms.render.py": "fe9aed079f561dca",
    "metrics/march_ms.train.py": "73fa227304aa1b9d",
    "metrics/mfu.image_train.py": "4b1ebf1d0c9f8430",
    "metrics/mfu.image_view.py": "30188ad26a06ba33",
    "metrics/mfu.render.py": "57a0df487a34014e",
    "metrics/mfu.train.py": "2aa577bed0241fbf",
    "metrics/network_ms.image_train.py": "97fcaf3b16ab84e2",
    "metrics/network_ms.image_view.py": "aaff1319dbe5e5bf",
    "metrics/network_ms.render.py": "fb1614e156ccf8e2",
    "metrics/network_ms.train.py": "2e0e6f66605c8175",
    "reference/__init__.py": "e3b0c44298fc1c14",
    "reference/image.py": "01e5f821fcc78723",
    "reference/nerf.py": "5b686a5ceb4fb7d6",
    "reference/plain.py": "42baac22e9c8b32a",
    "run.py": "9757db561c567a33",
    "survey.py": "d40e0fd14fbf0a36",
    "tests/__init__.py": "e3b0c44298fc1c14",
    "tests/sizes.py": "79f05c2984cf4af2",
    "tests/test_portbench_card.py": "e461614368c5b384",
    "tests/test_portbench_cells.py": "3f0e7f3004c1b9f2",
    "tests/test_portbench_data.py": "bd2383e12870723a",
    "tests/test_portbench_extend.py": "dc6849828b5817ec",
    "tests/test_portbench_geometry.py": "fd5f929629b82d60",
    "tests/test_portbench_imports.py": "ccca28f3e83223bd",
    "tests/test_portbench_result.py": "fe118ca459bd5670",
    "workloads/image-train-8k.json": "72b4d6665d5fb44f",
    "workloads/image-view-1080p.json": "59aaf399bf1e60fe",
    "workloads/nerf-render-720p.json": "de58b69e548e8a5f",
    "workloads/nerf-train-synth.json": "2ddd47de2fbaed75",
}


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


def test_files_the_benchmark_had_are_unchanged():
    changed = {name for name, sha in BEFORE.items()
               if _sha(ROOT / "portbench" / name) != sha}
    assert not changed


def test_readers_are_in_the_manifest_with_their_cells():
    manifest = harness.load_json(harness.MANIFEST)
    for cell, names in READERS.items():
        _, layer = harness.cell_metrics(manifest, cell)
        assert set(names) <= {m["name"] for m in layer}
    for m in manifest["per_layer"]:
        mod = harness.load_metric(m["name"])
        if getattr(mod, "SPANS", None) is program.SPANS:
            assert m["name"] in READERS[m["workloads"][0]]


@pytest.mark.parametrize("cell", sorted(READERS))
def test_traced_rehearsal_reports_the_program_metrics(cell, quiet):
    out = harness.run(cell, 2 ** 33 + 5, 0.2, True, "cpu",
                      overrides=TINY[cell], log=quiet)
    assert out["correct"], out["checks"]
    for name in READERS[cell]:
        assert name in out["metrics"], name
        assert out["metrics"][name]["value"] >= 0
    # the idle gaps are charged to the program's spans by name
    assert {name for name, _ in out["breakdown"]["idle_gaps"]} <= \
        set(program.NAMES) | {"window", "outside the window", "march",
                              "network", "adam"}
    if cell == "nerf-render-720p":
        counts = program.counters()
        assert out["metrics"]["samples.render"]["value"] == \
            counts["samples"] / counts["ngp.frame"]


def test_a_program_without_counters_reads_none(monkeypatch, quiet):
    """A program older than its spans (the parent of the readers): the
    readers return None, and the run still reports every other metric."""
    import ngp_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "counters")
    assert program.counters() == {}
    cell = "image-view-1080p"
    out = harness.run(cell, 11, 0.2, True, "cpu", overrides=TINY[cell],
                      log=quiet)
    assert out["correct"]
    assert "unspanned_idle_ms.image_view" not in out["metrics"]
    assert "host_syncs.image_view" in out["metrics"]
