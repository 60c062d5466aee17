"""Wrapper of the hand-written CUDA blocked-grid encode (K1 of the port).

``blocked_grid_encode`` is the one entry point. It picks by the device of
the tensors it is given: a CPU tensor goes to the plain PyTorch version
(``blocked_grid.encode_reference``), a CUDA tensor to the kernel in
``ngp_tpu_torch/csrc/blocked_grid_encode.cu``; anything else raises.
There is no fallback from the kernel to the plain version.

The kernel is compiled with ``nvcc`` into a shared library with a plain C
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
                                                encode_reference)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last reset; raised only where the kernel is
# launched, so a run can show that its main path went through the kernel.
launches = 0

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
    lib.ngp_blocked_grid_encode_fwd.argtypes = [vp, vp, vp, vp, vp, vp,
                                                ci, ci, ci, ci, vp]
    lib.ngp_blocked_grid_encode_fwd.restype = ci
    lib.ngp_cuda_error_string.argtypes = [ci]
    lib.ngp_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _launch(table: torch.Tensor, pos: torch.Tensor,
            meta: BlockedGridMeta) -> torch.Tensor:
    global launches
    L = meta.n_levels
    if not (table.is_cuda and pos.is_cuda and table.device == pos.device):
        raise ValueError("blocked-grid kernel: table and pos must be on one "
                         "CUDA device")
    if table.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError("blocked-grid kernel takes float32 table and pos")
    if tuple(table.shape) != (L, meta.rows, LANES):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"{(L, meta.rows, LANES)}")
    if meta.n_dims != 3 or pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"blocked-grid kernel takes 3D positions (N, 3), "
                         f"got {tuple(pos.shape)} for a {meta.n_dims}D grid")
    if not (table.is_contiguous() and pos.is_contiguous()):
        raise ValueError("blocked-grid kernel takes contiguous tensors")
    if meta.n_features_per_level != 2 or meta.row_hash not in ("prime",
                                                               "morton"):
        raise ValueError("blocked-grid kernel takes F=2 and the prime or "
                         "morton row hash")
    n = pos.shape[0]
    out = torch.empty((n, L * 2), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    lib = build()
    scales = np.asarray(meta.level_scales, np.float32)
    blocks = np.asarray(meta.level_blocks_per_dim, np.int32)
    dense = np.asarray(meta.level_is_dense, np.uint8)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = lib.ngp_blocked_grid_encode_fwd(
        pos.data_ptr(), table.data_ptr(), out.data_ptr(),
        scales.ctypes.data, blocks.ctypes.data, dense.ctypes.data,
        n, L, meta.log2_rows, int(meta.row_hash == "morton"), stream)
    if rc != 0:
        raise RuntimeError("blocked-grid kernel launch failed: "
                           + lib.ngp_cuda_error_string(rc).decode())
    launches += 1
    return out


class _BlockedGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pos, meta):
        return _launch(table, pos, meta)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("K2: training slice")


def blocked_grid_encode(table: torch.Tensor, pos: torch.Tensor,
                        meta: BlockedGridMeta) -> torch.Tensor:
    """(L, R, 128) table + (N, D) positions → (N, L·2) features."""
    if pos.device.type == "cpu" and table.device.type == "cpu":
        return encode_reference(table, pos, meta)
    if pos.device.type == "cuda":
        return _BlockedGridEncode.apply(table, pos, meta)
    raise ValueError(f"blocked_grid_encode: unsupported devices "
                     f"{table.device} / {pos.device}")
