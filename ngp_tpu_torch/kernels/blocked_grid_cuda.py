"""Wrappers of the hand-written CUDA blocked-grid kernels: K1 (encode
forward), K2 (table backward) and K4 (int8-table forward).

``blocked_grid_encode`` and ``blocked_grid_encode_i8fwd`` are the entry
points. Both pick by the device of the tensors they are given: CPU tensors
go to the plain PyTorch versions in ``blocked_grid.py``, CUDA tensors to the
kernels in ``ngp_tpu_torch/csrc/blocked_grid_encode.cu``; anything else
raises. There is no fallback from a kernel to its plain version.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface on first use (into ``build/ngp_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an unchanged tree is
not rebuilt) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ngp_tpu_torch.kernels.blocked_grid import (LANES, BlockedGridMeta,
                                                encode_backward_reference,
                                                encode_reference,
                                                encode_reference_i8,
                                                quantize_table_i8)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last reset, by kernel; each count is raised
# only where its kernel is launched, so a run can show that its main path
# went through the kernels.
launches = {"blocked_grid_encode_fwd": 0, "blocked_grid_encode_bwd": 0,
            "blocked_grid_encode_fwd_i8": 0}

_lib = None
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build ngp_tpu_torch/csrc")
    return path


def library_path() -> Path:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libngp_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    levels = [vp, vp, vp, ci, ci, ci, ci, vp]   # per-level arrays … stream
    lib.ngp_blocked_grid_encode_fwd.argtypes = [vp, vp, vp] + levels
    lib.ngp_blocked_grid_encode_bwd.argtypes = [vp, vp, vp] + levels
    lib.ngp_blocked_grid_encode_fwd_i8.argtypes = [vp, vp, vp, vp] + levels
    for fn in (lib.ngp_blocked_grid_encode_fwd,
               lib.ngp_blocked_grid_encode_bwd,
               lib.ngp_blocked_grid_encode_fwd_i8):
        fn.restype = ci
    lib.ngp_cuda_error_string.argtypes = [ci]
    lib.ngp_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(meta: BlockedGridMeta, pos: torch.Tensor, *tensors):
    """Raise on what the kernels do not take: every tensor on one CUDA
    device and contiguous, 3D float32 positions, F=2, a known row hash."""
    if not all(t.is_cuda and t.device == pos.device for t in (pos, *tensors)):
        raise ValueError("blocked-grid kernel: all tensors must be on one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in (pos, *tensors)):
        raise ValueError("blocked-grid kernel takes contiguous tensors")
    if pos.dtype != torch.float32:
        raise TypeError("blocked-grid kernel takes float32 positions")
    if meta.n_dims != 3 or pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"blocked-grid kernel takes 3D positions (N, 3), "
                         f"got {tuple(pos.shape)} for a {meta.n_dims}D grid")
    if meta.n_features_per_level != 2 or meta.row_hash not in ("prime",
                                                               "morton"):
        raise ValueError("blocked-grid kernel takes F=2 and the prime or "
                         "morton row hash")


def _check_table(table: torch.Tensor, meta: BlockedGridMeta,
                 dtype: torch.dtype):
    if table.dtype != dtype:
        raise TypeError(f"blocked-grid kernel takes a {dtype} table, got "
                        f"{table.dtype}")
    if tuple(table.shape) != (meta.n_levels, meta.rows, LANES):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"{(meta.n_levels, meta.rows, LANES)}")


def _level_args(meta: BlockedGridMeta, pos: torch.Tensor):
    """The per-level host arrays and scalars every entry point takes, in
    order; the arrays are returned too, to stay alive over the call."""
    arrays = (np.asarray(meta.level_scales, np.float32),
              np.asarray(meta.level_blocks_per_dim, np.int32),
              np.asarray(meta.level_is_dense, np.uint8))
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    args = [a.ctypes.data for a in arrays] + [
        pos.shape[0], meta.n_levels, meta.log2_rows,
        int(meta.row_hash == "morton"), stream]
    return args, arrays


def _run(name: str, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + build().ngp_cuda_error_string(rc).decode())
    launches[name] += 1


def launch_fwd(table: torch.Tensor, pos: torch.Tensor,
               meta: BlockedGridMeta) -> torch.Tensor:
    """K1: (L, R, 128) f32 table + (N, 3) positions → (N, L·2)."""
    _check(meta, pos, table)
    _check_table(table, meta, torch.float32)
    out = torch.empty((pos.shape[0], meta.n_levels * 2), dtype=torch.float32,
                      device=pos.device)
    if pos.shape[0] == 0:
        return out
    lib = build()
    args, _keep = _level_args(meta, pos)
    _run("blocked_grid_encode_fwd", lib.ngp_blocked_grid_encode_fwd,
         pos.data_ptr(), table.data_ptr(), out.data_ptr(), *args)
    return out


def launch_fwd_i8(table_q: torch.Tensor, qscales: torch.Tensor,
                  pos: torch.Tensor, meta: BlockedGridMeta) -> torch.Tensor:
    """K4: (L, R, 128) int8 table + (L,) f32 scales + (N, 3) positions →
    (N, L·2)."""
    _check(meta, pos, table_q, qscales)
    _check_table(table_q, meta, torch.int8)
    if qscales.dtype != torch.float32 or tuple(qscales.shape) != (
            meta.n_levels,):
        raise ValueError("int8 kernel takes (L,) float32 level scales")
    out = torch.empty((pos.shape[0], meta.n_levels * 2), dtype=torch.float32,
                      device=pos.device)
    if pos.shape[0] == 0:
        return out
    lib = build()
    args, _keep = _level_args(meta, pos)
    _run("blocked_grid_encode_fwd_i8", lib.ngp_blocked_grid_encode_fwd_i8,
         pos.data_ptr(), table_q.data_ptr(), qscales.data_ptr(),
         out.data_ptr(), *args)
    return out


def launch_bwd(pos: torch.Tensor, grad: torch.Tensor,
               meta: BlockedGridMeta) -> torch.Tensor:
    """K2: (N, 3) positions + (N, L·2) f32 cotangent → dTable
    (L, R, 128) f32."""
    _check(meta, pos, grad)
    if grad.dtype != torch.float32 or tuple(grad.shape) != (
            pos.shape[0], meta.n_levels * 2):
        raise ValueError(f"cotangent must be float32 (N, L·2), got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if pos.shape[0] == 0:
        return dtable
    lib = build()
    args, _keep = _level_args(meta, pos)
    _run("blocked_grid_encode_bwd", lib.ngp_blocked_grid_encode_bwd,
         pos.data_ptr(), grad.data_ptr(), dtable.data_ptr(), *args)
    return dtable


class _BlockedGridEncode(torch.autograd.Function):
    """Encode forward (K1, or K4 on the int8-quantised table) with the
    table backward (K2) on CUDA; the plain versions of all three on the
    CPU. The int8 forward keeps the exact f32 backward, as the JAX
    package's ``blocked_grid_encode_i8fwd``."""

    @staticmethod
    def forward(ctx, table, pos, meta, int8_table):
        ctx.meta = meta
        ctx.save_for_backward(table, pos)
        if int8_table:
            table_q, qscales = quantize_table_i8(table)
            if pos.is_cuda:
                return launch_fwd_i8(table_q, qscales, pos, meta)
            return encode_reference_i8(table_q, qscales, pos, meta)
        if pos.is_cuda:
            return launch_fwd(table, pos, meta)
        return encode_reference(table, pos, meta)

    @staticmethod
    def backward(ctx, grad):
        table, pos = ctx.saved_tensors
        meta = ctx.meta
        grad = grad.contiguous()
        d_table = d_pos = None
        if ctx.needs_input_grad[0]:
            d_table = (launch_bwd(pos, grad, meta) if pos.is_cuda
                       else encode_backward_reference(pos, grad, meta))
        if ctx.needs_input_grad[1]:
            if pos.is_cuda:
                raise NotImplementedError(
                    "position gradient of the blocked-grid encode needs K3 "
                    "(hashgrid_pallas.py:_bwd_frac_kernel), not ported yet")
            with torch.enable_grad():
                p = pos.detach().requires_grad_()
                out = encode_reference(table.detach(), p, meta)
                d_pos, = torch.autograd.grad(out, p, grad)
        return d_table, d_pos, None, None


def _encode(table, pos, meta, int8_table: bool):
    if not (table.device.type == pos.device.type
            and pos.device.type in ("cpu", "cuda")):
        raise ValueError(f"blocked_grid_encode: unsupported devices "
                         f"{table.device} / {pos.device}")
    return _BlockedGridEncode.apply(table, pos, meta, int8_table)


def blocked_grid_encode(table: torch.Tensor, pos: torch.Tensor,
                        meta: BlockedGridMeta) -> torch.Tensor:
    """(L, R, 128) table + (N, D) positions → (N, L·2) features; K1 forward,
    K2 table backward."""
    return _encode(table, pos, meta, False)


def blocked_grid_encode_i8fwd(table: torch.Tensor, pos: torch.Tensor,
                              meta: BlockedGridMeta) -> torch.Tensor:
    """The encode on the int8-quantised table (per-level scale
    ``max|T|/127``): K4 forward, the exact K2 table backward (port of
    ``hashgrid_pallas.blocked_grid_encode_i8fwd``)."""
    return _encode(table, pos, meta, True)
