"""Wrappers of the hand-written CUDA blocked-grid kernels: K1 (encode
forward), K2 (table backward), K3 (position backward), K4 (int8-table
forward) and K5 (int8 table backward).

``blocked_grid_encode``, ``blocked_grid_encode_i8fwd`` and
``blocked_grid_encode_int8`` are the entry points. They pick by the device
of the tensors they are given: CPU tensors go to the plain PyTorch
versions in ``blocked_grid.py``, CUDA tensors to the kernels in
``ngp_tpu_torch/csrc/blocked_grid_encode.cu``; anything else raises. There
is no fallback from a kernel to its plain version.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface on first use (into ``build/ngp_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an unchanged tree is
not rebuilt) and loaded with ``ctypes``. K1 and K2 are launched as
``launch_plan`` sizes them: one thread per (sample, level), neighbouring
threads on neighbouring levels of one sample.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ngp_tpu_torch.kernels.blocked_grid import (
    LANES, BlockedGridMeta, eff_tile, encode_backward_reference,
    encode_backward_reference_i8, encode_position_backward_reference,
    encode_reference, encode_reference_i8, quantize_table_i8)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ngp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last reset, by kernel; each count is raised
# only where its kernel is launched, so a run can show that its main path
# went through the kernels.
launches = {"blocked_grid_encode_fwd": 0, "blocked_grid_encode_bwd": 0,
            "blocked_grid_encode_bwd_pos": 0, "blocked_grid_encode_fwd_i8": 0,
            "blocked_grid_encode_bwd_i8": 0}

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


def compile_library(sources, out: Path) -> str:
    """nvcc ``sources`` into the shared library ``out``; returns nvcc's
    output (with ``-Xptxas -v``: each kernel's registers and spills)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def load_library(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc`` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    levels = [vp, vp, vp, ci, ci, ci, ci, vp]   # per-level arrays … stream
    planned = levels[:-1] + [ci, ci, ci, vp]    # … blocks, threads, log2 group
    lib.ngp_blocked_grid_encode_fwd.argtypes = [vp, vp, vp] + planned
    lib.ngp_blocked_grid_encode_bwd.argtypes = [vp, vp, vp] + planned
    lib.ngp_blocked_grid_encode_fwd_i8.argtypes = [vp, vp, vp, vp] + levels
    lib.ngp_blocked_grid_encode_bwd_pos.argtypes = [vp, vp, vp, vp] + levels
    lib.ngp_blocked_grid_encode_bwd_i8.argtypes = ([vp, vp, vp, vp]
                                                   + levels[:-1] + [ci, vp])
    lib.ngp_blocked_grid_group.argtypes = [ci]
    for fn in (lib.ngp_blocked_grid_encode_fwd,
               lib.ngp_blocked_grid_encode_bwd,
               lib.ngp_blocked_grid_encode_bwd_pos,
               lib.ngp_blocked_grid_encode_fwd_i8,
               lib.ngp_blocked_grid_encode_bwd_i8,
               lib.ngp_blocked_grid_group):
        fn.restype = ci
    lib.ngp_cuda_error_string.argtypes = [ci]
    lib.ngp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        build_log = compile_library(sorted(CSRC.glob("*.cu")), out)
    _lib = load_library(out)
    return _lib


# threads per block of K1's and K2's launches
THREADS = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A launch of K1 or K2 over the (sample, level) pairs: ``groups``
    level groups of ``width`` levels (grid y), each covered by ``blocks``
    blocks of ``threads`` threads (grid x). Thread t of block b in group k
    takes pair p = b·threads + t: sample p // width, level k·width + p %
    width. Threads past sample n - 1 are idle."""
    n: int
    n_levels: int
    width: int
    threads: int
    blocks: int
    groups: int

    @property
    def log2_width(self) -> int:
        return self.width.bit_length() - 1

    def pairs(self):
        """(sample, level) of every thread, each (groups, blocks·threads),
        in thread order; a sample ≥ n marks an idle thread."""
        p = np.arange(self.blocks * self.threads, dtype=np.int64)
        sample = np.broadcast_to(p // self.width, (self.groups, p.size))
        level = np.arange(self.groups)[:, None] * self.width \
            + p % self.width
        return sample, level


def launch_plan(n: int, n_levels: int, group: int,
                threads: int = THREADS) -> LaunchPlan:
    """Size K1's or K2's launch for n samples × n_levels levels, with the
    kernel's level group ``group`` (a power of two, the library's
    ``ngp_blocked_grid_group``). Groups are ``group`` levels wide, or,
    where that does not divide n_levels, as wide as the largest power of
    two that does: no group is ragged, and each sample's group is 8·width
    contiguous bytes of output, aligned to 8·width."""
    if group < 1 or group & (group - 1) or group > 32:
        raise ValueError(f"level group must be a power of two ≤ 32, got "
                         f"{group}")
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"threads per block must be whole warps ≤ 1024, "
                         f"got {threads}")
    width = min(group, n_levels & -n_levels)
    return LaunchPlan(n, n_levels, width, threads,
                      -(-n * width // threads), n_levels // width)


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


def _check_cotangent(pos: torch.Tensor, grad: torch.Tensor,
                     meta: BlockedGridMeta):
    if grad.dtype != torch.float32 or tuple(grad.shape) != (
            pos.shape[0], meta.n_levels * 2):
        raise ValueError(f"cotangent must be float32 (N, L·2), got "
                         f"{grad.dtype} {tuple(grad.shape)}")


def level_arrays(meta: BlockedGridMeta):
    """The per-level parameters every kernel takes: f32 scales, int32
    blocks per dimension, uint8 dense flags."""
    return (np.asarray(meta.level_scales, np.float32),
            np.asarray(meta.level_blocks_per_dim, np.int32),
            np.asarray(meta.level_is_dense, np.uint8))


def _level_args(meta: BlockedGridMeta, pos: torch.Tensor):
    """The per-level host arrays and scalars every entry point takes, in
    order; the arrays are returned too, to stay alive over the call."""
    arrays = level_arrays(meta)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    args = [a.ctypes.data for a in arrays] + [
        pos.shape[0], meta.n_levels, meta.log2_rows,
        int(meta.row_hash == "morton"), stream]
    return args, arrays


def _planned_args(meta: BlockedGridMeta, pos: torch.Tensor, backward: bool):
    """``_level_args`` with K1's (or K2's) launch plan before the stream."""
    args, arrays = _level_args(meta, pos)
    plan = launch_plan(pos.shape[0], meta.n_levels,
                       build().ngp_blocked_grid_group(int(backward)))
    return args[:-1] + [plan.blocks, plan.threads, plan.log2_width,
                        args[-1]], arrays


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
    args, _keep = _planned_args(meta, pos, backward=False)
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
    _check_cotangent(pos, grad, meta)
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if pos.shape[0] == 0:
        return dtable
    lib = build()
    args, _keep = _planned_args(meta, pos, backward=True)
    _run("blocked_grid_encode_bwd", lib.ngp_blocked_grid_encode_bwd,
         pos.data_ptr(), grad.data_ptr(), dtable.data_ptr(), *args)
    return dtable


def launch_bwd_pos(table: torch.Tensor, pos: torch.Tensor,
                   grad: torch.Tensor, meta: BlockedGridMeta) -> torch.Tensor:
    """K3: (L, R, 128) f32 table + (N, 3) positions + (N, L·2) f32
    cotangent → dpos (N, 3) f32."""
    _check(meta, pos, table, grad)
    _check_table(table, meta, torch.float32)
    _check_cotangent(pos, grad, meta)
    dpos = torch.empty((pos.shape[0], 3), dtype=torch.float32,
                       device=pos.device)
    if pos.shape[0] == 0:
        return dpos
    lib = build()
    args, _keep = _level_args(meta, pos)
    _run("blocked_grid_encode_bwd_pos", lib.ngp_blocked_grid_encode_bwd_pos,
         pos.data_ptr(), table.data_ptr(), grad.data_ptr(), dpos.data_ptr(),
         *args)
    return dpos


def launch_bwd_i8(pos: torch.Tensor, grad: torch.Tensor,
                  meta: BlockedGridMeta, tile: int) -> torch.Tensor:
    """K5: (N, 3) positions + (N, L·2) f32 cotangent → dTable (L, R, 128)
    f32, the products w·g quantised to int8 per (level, tile of ``tile``
    samples)."""
    _check(meta, pos, grad)
    _check_cotangent(pos, grad, meta)
    if tile < 32 or tile & (tile - 1):
        raise ValueError(f"int8 backward tile must be a power of two ≥ 32, "
                         f"got {tile}")
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if pos.shape[0] == 0:
        return dtable
    n_tiles = -(-pos.shape[0] // tile)
    tile_max = torch.zeros((meta.n_levels, n_tiles), dtype=torch.int32,
                           device=pos.device)
    lib = build()
    args, _keep = _level_args(meta, pos)
    _run("blocked_grid_encode_bwd_i8", lib.ngp_blocked_grid_encode_bwd_i8,
         pos.data_ptr(), grad.data_ptr(), tile_max.data_ptr(),
         dtable.data_ptr(), *args[:-1], tile.bit_length() - 1, args[-1])
    return dtable


# int8 modes of the encode (the JAX package's NGP_TPU_ENCODE_INT8): "" the
# f32 table; "fwd" the int8 forward (K4) with the exact f32 backward (K2);
# "full" the int8 forward and the int8-quantised table backward (K5). The
# position gradient (K3) reads the f32 table in every mode.
INT8_MODES = ("", "fwd", "full")


class _BlockedGridEncode(torch.autograd.Function):
    """Encode forward (K1, or K4 on the int8-quantised table), table
    backward (K2, or K5 in the ``full`` mode) and position backward (K3) on
    CUDA; the plain versions of all five on the CPU."""

    @staticmethod
    def forward(ctx, table, pos, meta, mode, tile):
        ctx.meta, ctx.mode, ctx.tile = meta, mode, tile
        ctx.save_for_backward(table, pos)
        if mode:
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
            if ctx.mode == "full":
                d_table = (launch_bwd_i8(pos, grad, meta, ctx.tile)
                           if pos.is_cuda else
                           encode_backward_reference_i8(pos, grad, meta,
                                                        ctx.tile))
            else:
                d_table = (launch_bwd(pos, grad, meta) if pos.is_cuda
                           else encode_backward_reference(pos, grad, meta))
        if ctx.needs_input_grad[1]:
            d_pos = (launch_bwd_pos(table, pos, grad, meta) if pos.is_cuda
                     else encode_position_backward_reference(table, pos,
                                                             grad, meta))
        return d_table, d_pos, None, None, None


def _encode(table, pos, meta, mode: str, tile: int):
    if not (table.device.type == pos.device.type
            and pos.device.type in ("cpu", "cuda")):
        raise ValueError(f"blocked_grid_encode: unsupported devices "
                         f"{table.device} / {pos.device}")
    return _BlockedGridEncode.apply(table, pos, meta, mode, tile)


def blocked_grid_encode(table: torch.Tensor, pos: torch.Tensor,
                        meta: BlockedGridMeta) -> torch.Tensor:
    """(L, R, 128) table + (N, D) positions → (N, L·2) features; K1 forward,
    K2 table backward, K3 position backward."""
    return _encode(table, pos, meta, "", 0)


def blocked_grid_encode_i8fwd(table: torch.Tensor, pos: torch.Tensor,
                              meta: BlockedGridMeta) -> torch.Tensor:
    """The encode on the int8-quantised table (per-level scale
    ``max|T|/127``): K4 forward, the exact K2 table backward (port of
    ``hashgrid_pallas.blocked_grid_encode_i8fwd``)."""
    return _encode(table, pos, meta, "fwd", 0)


def blocked_grid_encode_int8(table: torch.Tensor, pos: torch.Tensor,
                             meta: BlockedGridMeta,
                             tile: Optional[int] = None) -> torch.Tensor:
    """The ``full`` int8 encode (port of
    ``hashgrid_pallas.blocked_grid_encode_int8``): K4 forward, and the table
    backward K5 with the cotangent products quantised per (level, tile of
    ``tile`` samples). ``tile`` defaults to ``eff_tile(N)``; a caller whose
    JAX counterpart runs on a padded stream passes that stream's tile."""
    return _encode(table, pos, meta, "full",
                   eff_tile(pos.shape[0]) if tile is None else tile)


def encode_mode(table: torch.Tensor, pos: torch.Tensor,
                meta: BlockedGridMeta, mode: str = "",
                tile: Optional[int] = None) -> torch.Tensor:
    """The encode in one of ``INT8_MODES``."""
    if mode == "full":
        return blocked_grid_encode_int8(table, pos, meta, tile)
    if mode == "fwd":
        return blocked_grid_encode_i8fwd(table, pos, meta)
    if mode == "":
        return blocked_grid_encode(table, pos, meta)
    raise ValueError(f"int8 mode must be one of {INT8_MODES}, got {mode!r}")
