"""The port's named spans and counters (``utils/profiling.py``), on the
CPU at a tiny size: under ``torch.profiler`` a NeRF training step, an
image step and frame, and a NeRF frame of each renderer open their spans,
nested as ``SPAN_NAMES`` says, and count their samples from integers the
host already holds; with no profiler recording nothing is entered or
counted; two traced windows read their own counts; the runner's
``--trace_dir`` writes one Chrome trace with the spans in it."""
import json
import os
import sys
import threading

import numpy as np
import pytest
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from ngp_tpu_torch import run
from ngp_tpu_torch.config import load_network_config
from ngp_tpu_torch.data.nerf_loader import NerfDataset
from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
from ngp_tpu_torch.train import nerf as tnerf
from ngp_tpu_torch.train.image import ImageTrainer
from ngp_tpu_torch.utils import profiling

RES, N_VIEWS = 16, 4


def _orbit_dataset():
    """Four 16² views of random colours from cameras on a circle around
    the unit cube's centre."""
    xfs = []
    for i in range(N_VIEWS):
        a = i * 2 * np.pi / N_VIEWS
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        xfs.append(np.stack([np.cross(fwd, up), -up, fwd,
                             0.5 - 1.5 * fwd], 1))
    xfs = np.stack(xfs).astype(np.float32)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (N_VIEWS, RES, RES, 4), dtype=np.uint8)
    u8[..., 3] = 255
    return NerfDataset(
        images=u8.astype(np.float32) / 255.0, xforms=xfs,
        xforms_end=xfs.copy(), focal=np.full((N_VIEWS, 2), 20.0, np.float32),
        principal=np.full((N_VIEWS, 2), 0.5, np.float32),
        resolution=np.full((N_VIEWS, 2), RES, np.int32),
        lens_params=np.zeros((N_VIEWS, 7), np.float32), lens_is_opencv=False,
        depth_images=None, aabb_scale=1, scale=1.0,
        offset=np.zeros(3, np.float32), n_extra_learnable_dims=0,
        sharpness=np.ones(N_VIEWS, np.float32), paths=[],
        up=np.array([0.0, 0.0, 1.0], np.float32), images_u8=u8)


def _small(path):
    cfg = load_network_config(path)
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    return cfg


@pytest.fixture(scope="module")
def nerf():
    """A NeRF trainer past its first step (the first sweep and the ray
    budget's probe done), at 64 rays and 2^13 samples a step."""
    tr = tnerf.NerfTrainer(_orbit_dataset(), _small("configs/nerf/base.json"),
                           tcfg=tnerf.NerfTrainerConfig(
                               n_rays=64, target_batch_size=1 << 13),
                           device="cpu")
    tr.train(1)
    return tr


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(1)
    return ImageTrainer(rng.random((24, 32, 3), dtype=np.float32),
                        _small("configs/image/base.json"), batch_size=1024,
                        device="cpu")


def _traced(fn):
    """(the profiler, fn's result) of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _spans(prof) -> list:
    """(name, the innermost program span around it or None, start, end) of
    every program span the trace holds."""
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name in profiling.SPAN_NAMES]
    out = []
    for name, t0, t1 in ev:
        around = [(n, s0, s1) for n, s0, s1 in ev
                  if s0 <= t0 and t1 <= s1 and (s0, s1) != (t0, t1)]
        inner = min(around, key=lambda s: s[2] - s[1], default=None)
        out.append((name, inner and inner[0], t0, t1))
    return out


def _children(spans, parent) -> set:
    return {n for n, p, _, _ in spans if p == parent}


def test_nerf_training_step_holds_its_spans(nerf):
    # the window runs the steps to a 16-step boundary and one more: the
    # stats read and the partial sweep at the boundary, then a step
    n = 17 - nerf.training_step % 16
    prof, _ = _traced(lambda: nerf.train(n))
    spans = _spans(prof)
    assert _children(spans, "ngp.step") == {
        "ngp.sample", "ngp.march", "ngp.network", "ngp.loss",
        "ngp.backward", "ngp.adam", "ngp.error_map"}
    # the loop's own: the draws, the stats reads, the sweep
    assert _children(spans, None) == {"ngp.step", "ngp.sample",
                                      "ngp.stats", "ngp.sweep"}
    assert _children(spans, "ngp.sweep") == {"ngp.network"}
    counts = profiling.counters()
    assert counts["ngp.step"] == n
    assert counts["ngp.sweep"] == 1
    assert counts["ngp.march"] == n


def test_samples_count_the_march_total_without_a_host_read(nerf,
                                                          monkeypatch):
    """``samples`` is the sum of the march's ``total`` over the window's
    steps, and every host read of a device scalar in the window lies in
    the march or the loop's stats reads: counting added none."""
    totals = []
    march = tnerf.march_and_compact_hier

    def recording(*a, **kw):
        out = march(*a, **kw)
        totals.append(out[4])
        return out
    monkeypatch.setattr(tnerf, "march_and_compact_hier", recording)
    prof, _ = _traced(lambda: nerf.train(3))
    assert len(totals) == 3 and sum(totals) > 0
    assert profiling.counters()["samples"] == sum(totals)
    spans = _spans(prof)
    reads = [e.time_range for e in prof.events()
             if e.name == "aten::_local_scalar_dense"]
    assert reads
    for r in reads:
        around = [n for n, _, s0, s1 in spans if s0 <= r.start <= s1]
        assert {"ngp.march", "ngp.stats"} & set(around), around


def test_image_step_and_frame_hold_their_spans(image):
    prof, _ = _traced(lambda: (image.train(2), image.render(16, 12)))
    spans = _spans(prof)
    assert _children(spans, "ngp.step") == {
        "ngp.sample", "ngp.network", "ngp.loss", "ngp.backward", "ngp.adam"}
    assert _children(spans, "ngp.frame") == {
        "ngp.sample", "ngp.network", "ngp.composite", "ngp.to_host"}
    assert _children(spans, None) == {"ngp.step", "ngp.frame", "ngp.stats"}
    counts = profiling.counters()
    assert counts["ngp.step"] == 2 and counts["ngp.frame"] == 1
    assert counts["samples"] == 2 * image.batch_size + 16 * 12


@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_nerf_frame_holds_its_spans(nerf, dispatch):
    r = NerfRenderer.for_trainer(nerf, RenderOptions(
        wave=True, wave_dispatch=dispatch, chunk=128))
    prof, _ = _traced(lambda: r.render(
        nerf.inference_params(), nerf.grid.bitfield,
        nerf.dataset.xforms[0], RES, RES, focal=(20.0, 20.0)))
    spans = _spans(prof)
    assert _children(spans, "ngp.frame") == {
        "ngp.sample", "ngp.march", "ngp.network", "ngp.composite",
        "ngp.wait"}
    assert _children(spans, None) == {"ngp.frame"}
    counts = profiling.counters()
    assert r.last_n_samples > 0
    assert counts["samples"] == r.last_n_samples


def test_nothing_is_entered_or_counted_without_a_profiler(nerf, image,
                                                        monkeypatch):
    monkeypatch.setattr(profiling, "_window", profiling._Window())

    def entered(name):
        raise AssertionError(f"a range was entered: {name}")
    monkeypatch.setattr(profiling._profiler, "record_function", entered)
    nerf.train(2)
    image.train(1)
    image.render(8, 6)
    NerfRenderer.for_trainer(nerf, RenderOptions(wave=True)).render(
        None, nerf.grid.bitfield, nerf.dataset.xforms[0], 8, 8,
        focal=(10.0, 10.0))
    assert profiling.span("ngp.step") is profiling.span("ngp.frame")
    assert profiling.counters() == {}


def _frame(nerf):
    """A wave renderer past one untraced frame, and its frame: a first
    frame whose segment stream overflows turns the renderer to the flat
    march from then on."""
    r = NerfRenderer.for_trainer(nerf, RenderOptions(
        wave=True, wave_dispatch="host"))
    args = (nerf.inference_params(), nerf.grid.bitfield,
            nerf.dataset.xforms[1], RES, RES)
    r.render(*args, focal=(20.0, 20.0))
    return r, lambda: r.render(*args, focal=(20.0, 20.0))


@pytest.mark.parametrize("between", ["read", "untraced_frame"])
def test_two_traced_windows_read_their_own_counts(nerf, between):
    """A window ends at the first read of the counts or untraced span
    after its profiler stops, so the second reads its own counts."""
    r, frame = _frame(nerf)
    reads = []
    for _ in range(2):
        _traced(frame)
        if between == "read":
            reads.append(profiling.counters())
        else:
            frame()
            reads.append(profiling.counters())
    assert reads[0] == reads[1]
    assert reads[0]["ngp.frame"] == 1
    assert reads[0]["samples"] == r.last_n_samples


def test_back_to_back_windows_share_their_counts(nerf):
    """Two profiler sessions with no call of the program or read of the
    counts between them are one window, as ``counters()`` documents."""
    r, frame = _frame(nerf)
    _traced(frame)
    _traced(frame)
    counts = profiling.counters()
    assert counts["ngp.frame"] == 2
    assert counts["samples"] == 2 * r.last_n_samples


def test_unknown_names_are_refused_while_tracing():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="unknown span"):
            profiling.span("ngp.nothing")
        with pytest.raises(ValueError, match="unknown span or counter"):
            profiling.count("tokens", 1)


def test_counts_from_many_threads_add_up():
    """Counts from more threads than cores, with a short switch interval,
    lose no update."""
    n_threads, n = 2 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=lambda: [
                profiling.count("samples", 1) for _ in range(n)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters() == {"samples": n_threads * n}


def test_runner_trace_dir_writes_the_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("NGP_TPU_TESTBED_BATCH", "1024")
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).save(
        tmp_path / "image.png")
    (tmp_path / "image.json").write_text(json.dumps(
        _small("configs/image/base.json")))
    assert run.main(["--mode", "image", "--scene",
                     str(tmp_path / "image.png"), "--network",
                     str(tmp_path / "image.json"), "--n_steps", "2",
                     "--device", "cpu", "--trace_dir",
                     str(tmp_path / "trace")]) == 0
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"ngp.step", "ngp.network", "ngp.backward",
            "ngp.adam"} <= names

