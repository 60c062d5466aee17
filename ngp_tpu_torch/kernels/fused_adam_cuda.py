"""Wrapper of the hand-written CUDA fused Adam (``ngp_tpu_torch/csrc/
fused_adam.cu``): one launch a step updates every parameter tensor, its
moments and its Ema in place. ``opt/optimizers.py`` ``apply_update`` calls
it for CUDA tensors and keeps the eager update (``apply_update_plain``) as
the plain version for CPU tensors; there is no fallback from the kernel.

The kernel is built into the blocked-grid kernels' library
(``blocked_grid_cuda.build``: every ``csrc/*.cu``) and loaded with
``ctypes``. The tensor table and the scalars travel by value in the
kernel's parameters, up to ``MAX_TENSORS`` tensors a launch; a longer list
is split into launches of that many. Each tensor is a run of blocks of
``THREADS`` threads, ``VECS`` float4s a thread.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ngp_tpu_torch.kernels.blocked_grid_cuda import build

# the kernel's geometry: kMaxTensors, kThreads and kVecs of fused_adam.cu
# (the grid is planned here; the tests' launches would fail on a mismatch)
MAX_TENSORS, THREADS, VECS = 32, 256, 4
ENTRIES_PER_BLOCK = THREADS * VECS * 4
# what a tensor's Ema takes: nothing (e is p), e = p, e = d·e + (1 − d)·p
EMA_NONE, EMA_COPY, EMA_DECAY = 0, 1, 2

# kernel launches since the last reset, raised only where the kernel is
# launched, so a run can show that its optimizer went through the kernel
launches = {"fused_adam": 0}


class AdamTensor(ctypes.Structure):
    """One tensor of the launch: the C struct ``AdamTensor``."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("e", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("block0", ctypes.c_longlong), ("dense", ctypes.c_int),
                ("l2", ctypes.c_int), ("ema", ctypes.c_int),
                ("aligned", ctypes.c_int)]


class AdamScalars(ctypes.Structure):
    """The step's scalars: the C struct ``AdamScalars`` (floats are
    rounded to f32 as ctypes stores them)."""
    _fields_ = [(k, ctypes.c_float) for k in (
        "lr", "decay_base", "b1", "omb1", "b2", "omb2", "eps", "l2",
        "inv_ls", "ema_d", "ema_omd")] + [(k, ctypes.c_int) for k in (
            "step", "decay_on", "decay_start", "decay_interval",
            "decay_end")]


class Entry(NamedTuple):
    """A parameter ``p``, its gradient ``g``, moments ``m`` and ``v`` and
    Ema ``e``; ``dense``: update every entry (else freeze those whose
    gradient is 0); ``l2``: add L2 to the gradient; ``ema``: EMA_*."""
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    e: torch.Tensor
    dense: bool
    l2: bool
    ema: int


def _entry_point():
    fn = build().ngp_fused_adam
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(r: Entry, device: torch.device):
    ts = (r.p, r.g, r.m, r.v, r.e)
    if not all(t.is_cuda and t.device == device for t in ts):
        raise ValueError("fused Adam: all tensors must be on one CUDA "
                         "device")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError("fused Adam takes float32 parameters, gradients, "
                        "moments and Ema")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused Adam takes contiguous tensors")
    if not all(t.shape == r.p.shape for t in ts):
        raise ValueError(f"fused Adam: shapes differ from the parameter's "
                         f"{tuple(r.p.shape)}: "
                         f"{[tuple(t.shape) for t in ts]}")


def _row(r: Entry, block0: int) -> AdamTensor:
    ptrs = [t.data_ptr() for t in (r.p, r.g, r.m, r.v, r.e)]
    return AdamTensor(*ptrs, r.p.numel(), block0, int(r.dense), int(r.l2),
                      r.ema, int(all(a % 16 == 0 for a in ptrs)))


def launch(entries, scalars: AdamScalars) -> int:
    """One Adam step over ``entries`` (``Entry``s on one CUDA device),
    launched on the current stream; returns the parameter entries
    updated."""
    entries = list(entries)
    if not entries:
        return 0
    device = entries[0].p.device
    for r in entries:
        _check(r, device)
    live = [r for r in entries if r.p.numel()]
    fn = None
    stream = torch.cuda.current_stream(device).cuda_stream
    for i in range(0, len(live), MAX_TENSORS):
        part, rows, blocks = live[i:i + MAX_TENSORS], [], 0
        for r in part:
            rows.append(_row(r, blocks))
            blocks += -(-r.p.numel() // ENTRIES_PER_BLOCK)
        table = (AdamTensor * len(rows))(*rows)
        fn = fn or _entry_point()
        rc = fn(ctypes.addressof(table), len(rows),
                ctypes.addressof(scalars), blocks, stream)
        if rc != 0:
            raise RuntimeError("fused_adam launch failed: "
                               + build().ngp_cuda_error_string(rc).decode())
        launches["fused_adam"] += 1
    return sum(r.p.numel() for r in live)
