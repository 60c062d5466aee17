"""The fused Adam kernel on the card: bit-identical to the eager update,
one launch and no host sync a step, its ``adam_fused`` count. Each test
takes the ``card`` fixture and skips where there is no CUDA device. The
card's machine has no JAX, which ``tests/conftest.py`` imports, so run
them there without it, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_fused_adam_card.py
"""
import pytest
import torch

from ngp_tpu_torch.kernels import fused_adam_cuda as fa
from ngp_tpu_torch.opt import optimizers as topt
from ngp_tpu_torch.utils import profiling

import fused_adam_cases as cases


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("make", [
    lambda dev: cases.image_like(dev, rows=1 << 14),
    lambda dev: cases.nerf_like(dev, rows=4096),
    cases.odd_sizes], ids=["image-like", "nerf-like", "odd-sizes"])
def test_kernel_is_bit_identical_to_the_eager_update(card, make):
    case = make(card)
    before = fa.launches["fused_adam"]
    cases.run_both(case, 20)
    live = sum(1 for p in case.params.values() if p.numel())
    assert fa.launches["fused_adam"] - before == 20 * -(-live //
                                                        fa.MAX_TENSORS)


@pytest.mark.card
def test_one_launch_and_no_sync_a_step(card):
    case = cases.nerf_like(card, rows=4096)
    grads = case.grads_of(0)
    state = case.state
    torch.cuda.synchronize()
    before = fa.launches["fused_adam"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state = topt.apply_update(case.params, grads, state,
                                          case.cfg, case.matrix_names)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts = profiling.counters()
    torch.cuda.synchronize()
    assert fa.launches["fused_adam"] - before == 3
    assert counts["ngp.adam"] == 3
    assert counts["adam_fused"] == 3 * sum(p.numel()
                                           for p in case.params.values())
