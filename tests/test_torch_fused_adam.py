"""The fused Adam kernel's arithmetic and dispatch on the CPU.

ngp_tpu_torch/csrc/fused_adam.cu is compiled by the host C++ compiler
against a sequential stand-in for the CUDA runtime (``RUNTIME``: each
launch runs its blocks, and each block's threads, one after another; the
kernel has no shared memory, warp exchanges or atomics) and launched
through ``fused_adam_cuda.launch`` on CPU tensors. Each case is held bit
for bit against the eager update (``apply_update_plain``) on the CPU, whose
operations round as the card's do, one IEEE f32 rounding each, but for
``torch.sqrt``: on the CPU it is vectorised to within about half an ulp
and is not correctly rounded (on ~0.6 % of inputs), where the card's, like
the kernel's ``__fsqrt_rn``, is; here the eager update takes numpy's
correctly rounded square root instead. The f32 ``pow`` of the learning
rate and the bias corrections is the host's libm on both sides here (the
card's ``powf`` on both sides there: ``tests/test_torch_fused_adam_card.py``
and ``chip_smoke.py``).

The device-side scalar recipe is also mirrored in numpy f32 and held
against the JAX package's ``lr_at_step`` and bias corrections. About 8 s
alone.
"""
import ctypes
import ctypes.util
import dataclasses
import re
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.opt.optimizers as jopt
import ngp_tpu_torch.opt.optimizers as topt
from ngp_tpu_torch import bridge
from ngp_tpu_torch.io.snapshot import load_snapshot, save_snapshot
from ngp_tpu_torch.kernels import fused_adam_cuda as fa
from ngp_tpu_torch.kernels.blocked_grid_cuda import CSRC
from ngp_tpu_torch.train.image import ImageTrainer
from ngp_tpu_torch.utils import profiling

import fused_adam_cases as cases

RUNTIME = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __grid_constant__
struct U3 { unsigned x, y, z; };
inline U3 threadIdx, blockIdx;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> void emulate(unsigned blocks, unsigned threads, F f) {
  for (unsigned b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {t, 0, 0};
      f();
    }
}
"""

TINY_IMAGE = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                  "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 4,
                 "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 4, "per_level_scale": 2.0},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 16,
                "n_hidden_layers": 1}}


def emulated_source(src: str) -> str:
    """The kernel source with its launch run by ``emulate`` and the
    runtime stand-in included."""
    out, n = re.subn(
        r"(\w+)<<<([^,]+),\s*(\w+),\s*0,.*?>>>\((\w+)\);",
        r"emulate(\2, \3, [&] { \1(\4); });", src, flags=re.S)
    assert n == 1
    return out.replace("#include <cuda_runtime.h>",
                       '#include "emulated_runtime.h"')


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    """The kernel built for the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    d = tmp_path_factory.mktemp("fused_adam")
    (d / "emulated_runtime.h").write_text(RUNTIME)
    (d / "fused_adam.cpp").write_text(emulated_source(
        (CSRC / "fused_adam.cu").read_text()))
    lib = d / "libfused_adam.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off",
         "-fno-strict-aliasing", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         f"-I{d}", "-o", str(lib), str(d / "fused_adam.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(emulated_lib, monkeypatch):
    """``fused_adam_cuda.launch`` launching into the host build from CPU
    tensors."""
    monkeypatch.setattr(fa, "build", lambda: emulated_lib)
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    return emulated_lib


def _ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (numpy's)."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def test_image_like_set_is_bit_identical_to_the_eager_update(emulated):
    case = cases.image_like("cpu", rows=64)
    assert all(case.state.ema_params[k] is p for k, p in case.params.items())
    before = fa.launches["fused_adam"]
    kp, ks = cases.run_both(case, 20)
    assert fa.launches["fused_adam"] - before == 20
    assert all(ks.ema_params[k] is kp[k] for k in kp)
    frozen = (ks.mu["table"] == 0) & (ks.nu["table"] == 0)
    assert 0 < frozen.float().mean() < 1
    assert torch.equal(kp["table"][frozen], case.params["table"][frozen])


def test_nerf_like_set_is_bit_identical_to_the_eager_update(emulated):
    cases.run_both(cases.nerf_like("cpu", rows=32), 20)


def test_odd_sizes_and_lone_entries_are_bit_identical(emulated):
    case = cases.odd_sizes("cpu")
    assert sum(1 for p in case.params.values() if p.numel()) \
        > fa.MAX_TENSORS
    assert any(p.data_ptr() % 16 and p.numel() >= 8
               for p in case.params.values())
    before = fa.launches["fused_adam"]
    kp, ks = cases.run_both(case, 5)
    assert fa.launches["fused_adam"] - before == 5 * 2
    for k in kp:
        cases.assert_bits(ks.ema_params[k], kp[k], k)


def test_cpu_tensors_take_the_plain_path():
    """Dispatch by device: no launch and no ``adam_fused`` count for CPU
    tensors; a tensor on another device raises."""
    case = cases.image_like("cpu", rows=16)
    before = fa.launches["fused_adam"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        state = topt.apply_update(case.params, case.grads_of(0), case.state,
                                  case.cfg, case.matrix_names)
        counts = profiling.counters()
    assert state.step == 1 and counts["ngp.adam"] == 1
    assert counts.get("adam_fused", 0) == 0
    assert fa.launches["fused_adam"] == before
    meta = {k: torch.empty(p.shape, device="meta")
            for k, p in case.params.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        topt.apply_update(meta, meta, topt.init_state(meta, case.cfg),
                          case.cfg)


def test_wrapper_refuses_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.launch([fa.Entry(p, p, p, p, p, True, False, fa.EMA_NONE)],
                  fa.AdamScalars())


def _powf():
    """The C library's f32 pow, which ``torch.pow`` of two 0-d f32 CPU
    tensors runs (numpy's float32 power is a vectorised one of its own)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    libm.powf.restype = ctypes.c_float
    return lambda b, e: np.float32(libm.powf(b, e))


def kernel_scalars(cfg: topt.AdamConfig, step: int, powf):
    """The kernel's ``step_scalars`` in numpy f32 (``powf`` its pow): the
    learning rate, its decay factor and the powers β^step of the bias
    corrections 1 − β^step."""
    f = np.float32
    lr, n, factor = f(cfg.learning_rate), 0, f(1)
    if cfg.decay_interval > 0 and cfg.decay_base != 1.0:
        eff = min(step, cfg.decay_end)
        n = (0 if eff < cfg.decay_start
             else (eff - cfg.decay_start) // cfg.decay_interval + 1)
        factor = powf(f(cfg.decay_base), f(n))
        lr = f(lr * factor)
    return lr, (n, factor), [powf(f(b), f(step))
                             for b in (cfg.beta1, cfg.beta2)]


def _ulps(got, want, of) -> float:
    """|got − want| in ulps of ``of``."""
    return float(abs(np.float32(got) - np.float32(want))
                 / np.spacing(np.float32(of)))


@pytest.mark.parametrize("decay", [(20000, 10000, 0.33, 10 ** 9),
                                   (5, 3, 0.33, 15), (0, 1, 0.5, 40),
                                   (0, 0, 1.0, 2 ** 31 - 1)],
                         ids=["base-json", "crossing", "every-step", "off"])
def test_device_scalar_recipe_matches_jax(decay):
    """At steps around the decay's start, its interval boundaries and its
    end: the recipe equals the eager update's ``lr_at_step`` and
    ``_f32_pow`` bit for bit (both take the C library's powf here), and the
    JAX package's within one f32 ulp of each power (XLA's f32 pow is not
    the C library's: they differ by an ulp at ~2 % of these)."""
    start, interval, base, end = decay
    cfg = topt.AdamConfig(learning_rate=1e-2, beta1=0.9, beta2=0.99,
                          decay_start=start, decay_interval=interval,
                          decay_base=base, decay_end=end)
    jcfg = jopt.AdamConfig(**dataclasses.asdict(cfg))
    steps = {1, 2, 3, 4, 100, 1000}
    for edge in (start, end, start + interval, start + 5 * interval):
        steps |= {max(1, edge + d) for d in (-1, 0, 1)}
    powf = _powf()
    for step in sorted(t for t in steps if t < 2 ** 31):
        lr, (n, factor), powers = kernel_scalars(cfg, step, powf)
        js = jnp.int32(step)
        assert lr == np.float32(topt.lr_at_step(cfg, step)), step
        assert _ulps(lr, jopt.lr_at_step(jcfg, js), lr) <= 1.0, step
        assert factor == np.float32(topt._f32_pow(base, n, None)), step
        assert _ulps(factor, jnp.power(jnp.float32(base), jnp.float32(n)),
                     factor) <= 1.0, step
        for got, b in zip(powers, (cfg.beta1, cfg.beta2)):
            bc = np.float32(1) - got
            assert bc == np.float32(1.0 - topt._f32_pow(b, step, None))
            want = 1.0 - jnp.power(jnp.float32(b), js.astype(jnp.float32))
            assert _ulps(bc, want, got) <= 1.0, (step, b)


def test_no_ema_keeps_the_ema_equal_to_the_parameters(tmp_path):
    """With no Ema the Ema is the parameters: after steps that freeze most
    table rows, and after a snapshot whose Ema differs from its parameters
    is restored (the parameters win), then after more steps."""
    img = np.random.default_rng(4).random((32, 32, 3)).astype(np.float32)
    tr = ImageTrainer(img, TINY_IMAGE, batch_size=256, device="cpu")
    assert tr.opt_cfg.ema_decay == 0.0
    tr.train(3)
    for k, p in tr.params.items():
        assert tr.opt_state.ema_params[k] is p
    frozen = (tr.opt_state.mu["encoding.table"] == 0).float().mean()
    assert frozen > 0.5, frozen
    tree = bridge.encoded_params_to_numpy(tr.params, tr.model)
    ema = jax.tree.map(lambda v: np.asarray(v) + np.float32(1), tree)
    save_snapshot(tmp_path / "s.msgpack", TINY_IMAGE, params=tree,
                  ema_params=ema, training_step=3)
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    with torch.no_grad():
        for p in tr.params.values():
            p.add_(1.0)
    tr.load_snapshot_state(tmp_path / "s.msgpack")
    for k, p in tr.params.items():
        assert torch.equal(p.detach(), before[k]), k
        assert tr.opt_state.ema_params[k] is p
    tr.train(2)
    for k, p in tr.params.items():
        assert torch.equal(tr.opt_state.ema_params[k], p.detach()), k


def test_no_ema_snapshot_saved_after_a_restore_holds_the_parameters(
        tmp_path):
    """With no Ema, a snapshot saved right after a restore holds the
    restored parameters as its Ema, not the restored snapshot's own Ema
    (the JAX package keeps that one until its next step)."""
    img = np.random.default_rng(6).random((32, 32, 3)).astype(np.float32)
    tr = ImageTrainer(img, TINY_IMAGE, batch_size=256, device="cpu")
    tr.train(1)
    tree = bridge.encoded_params_to_numpy(tr.params, tr.model)
    ema = jax.tree.map(lambda v: np.asarray(v) + np.float32(1), tree)
    save_snapshot(tmp_path / "in.msgpack", TINY_IMAGE, params=tree,
                  ema_params=ema, training_step=1)
    tr.load_snapshot_state(tmp_path / "in.msgpack")
    tr.save_snapshot(tmp_path / "out.msgpack", TINY_IMAGE)
    snap = load_snapshot(tmp_path / "out.msgpack")["snapshot"]
    saved = jax.tree.leaves(snap["ngp_tpu_params"])
    assert len(saved) == len(jax.tree.leaves(tree)) > 0
    for got, want in zip(saved, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jax.tree.leaves(snap["ngp_tpu_ema_params"]), saved):
        np.testing.assert_array_equal(got, want)


def test_no_ema_writes_an_ema_of_its_own_to_every_entry(emulated):
    """A state whose Ema tensors are its own (not the parameters), restored
    to values unequal to the parameters: kernel steps with most table
    entries frozen set every Ema entry to its parameter, as the eager
    update does."""
    case = cases.image_like("cpu", rows=32, seed=5)
    state = case.state._replace(ema_params={
        k: p.detach() + 1.0 for k, p in case.params.items()})
    kp, ks = cases.run_both(case._replace(state=state), 2)
    for k in kp:
        assert ks.ema_params[k] is not kp[k]
        assert torch.equal(ks.ema_params[k], kp[k]), k
