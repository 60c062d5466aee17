"""The port's utilities against the JAX package's: the FLIP metric (a
numpy copy: its map and mean agree to 1e-6) and the torch.profiler trace
written as a Chrome trace."""
import json

import numpy as np
import pytest
import torch

from ngp_tpu.utils import flip as jflip
from ngp_tpu_torch.utils import flip as tflip
from ngp_tpu_torch.utils import profiling as tprof


def _pair(seed: int, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    ref = rng.random(shape)
    y, x = np.mgrid[0:shape[0], 0:shape[1]] / shape[1]
    ref[..., 0] = 0.5 + 0.4 * np.sin(12 * x)            # an edge-rich band
    test = np.clip(ref + rng.normal(0, 0.05, shape), 0, 1)
    test[10:20, 10:30] = 1.0 - test[10:20, 10:30]       # a block of error
    return ref, test


@pytest.mark.parametrize("ppd", [67.0, 30.0])
def test_flip_matches_jax(ppd):
    ref, test = _pair(0)
    got = tflip.compute_flip_map(ref, test, ppd)
    want = jflip.compute_flip_map(ref, test, ppd)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert 0.01 < float(np.mean(got)) < 0.9


def test_flip_under_standard_viewing_matches_jax():
    """``flip``'s mean at the reference's monitor (0.7 m at 0.7 m wide,
    3840 pixels: ~67 pixels per degree)."""
    ref, test = _pair(1)
    assert abs(tflip.flip(test, ref) - jflip.flip(test, ref)) <= 1e-6
    assert tflip.flip(ref, ref) == pytest.approx(0.0, abs=1e-6)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert logdir == str(tmp_path / "trace")
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in doc["traceEvents"])
