"""Wrappers of the hand-written CUDA blocked-grid kernels: K1 (encode
forward), K2 (table backward), K3 (position backward), K4 (int8-table
forward) and K5 (int8 table backward). Each takes 3D and 2D grids; a 2D
grid launches the kernel's ``_2d`` entry point and counts under its own
name (``launch_name``: ``blocked_grid_encode_fwd_2d`` and so on).

``blocked_grid_encode``, ``blocked_grid_encode_i8fwd``,
``blocked_grid_encode_int8`` and ``encode_quantized`` are the entry
points. They pick by the device of the tensors they are given: CPU
tensors go to the plain PyTorch versions in ``blocked_grid.py``, CUDA
tensors to the kernels in ``ngp_tpu_torch/csrc/blocked_grid_encode.cu``;
anything else raises. There is no fallback from a kernel to its plain
version.

The kernels are compiled with ``nvcc`` into a shared library with a plain C
interface on first use (into ``build/ngp_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an unchanged tree is
not rebuilt) and loaded with ``ctypes``. Every kernel on 3D grids is
launched as ``launch_plan`` sizes it: one thread per (sample, level),
neighbouring threads on neighbouring levels of one sample, in level groups
of each kernel's own width (``ngp_blocked_grid_group``). On 2D grids (the
neural image) K1, K3 and K4 take ``fwd_plan_2d``'s plan: one block per
tile of samples × all levels, neighbouring lanes on neighbouring samples
of one level (K3 then adds each sample's levels in level order); K2 and
K5 take ``table_bwd_plan_2d``'s: one block per chunk of samples and group
of levels, a level's gradient summed in shared memory where its rows fit,
else in L2.
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

# the kernels by launch name, in the order of ``ngp_blocked_grid_group``'s
# argument (K1, K2, K4, K5, K3)
GROUP_KERNELS = ("blocked_grid_encode_fwd", "blocked_grid_encode_bwd",
                 "blocked_grid_encode_fwd_i8", "blocked_grid_encode_bwd_i8",
                 "blocked_grid_encode_bwd_pos")

# Kernel launches since the last reset, by launch name (``launch_name``:
# each kernel on 3D and on 2D grids); each count is raised only where its
# kernel is launched, so a run can show that its main path went through
# the kernels.
launches = {f"{k}{d}": 0 for d in ("", "_2d") for k in GROUP_KERNELS}

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
    argtypes = {"blocked_grid_encode_fwd": [vp, vp, vp] + planned,
                "blocked_grid_encode_bwd": [vp, vp, vp] + planned,
                "blocked_grid_encode_fwd_i8": [vp, vp, vp, vp] + planned,
                "blocked_grid_encode_bwd_pos": [vp] * 5 + planned,
                "blocked_grid_encode_bwd_i8": ([vp, vp, vp, vp]
                                               + planned[:-1] + [ci, vp])}
    # the 2D twins, with the same arguments but K3's: no partial sums
    argtypes.update({f"{name}_2d": types for name, types in argtypes.items()})
    argtypes["blocked_grid_encode_bwd_pos_2d"] = [vp] * 4 + planned
    lib.ngp_blocked_grid_group.argtypes = [ci]
    lib.ngp_blocked_grid_group.restype = ci
    for name, types in argtypes.items():
        # a library built from older sources without some 2D twins (a
        # baseline of scripts/encode_group_sweep.py) serves 3D there
        if hasattr(lib, f"ngp_{name}"):
            fn = getattr(lib, f"ngp_{name}")
            fn.argtypes, fn.restype = types, ci
    # K2 and K5 on 2D grids (absent from a library of older sources)
    if hasattr(lib, "ngp_blocked_grid_table_bwd_2d"):
        lib.ngp_blocked_grid_table_bwd_2d.argtypes = (
            [vp] * 7 + [ci] * 9 + [vp])
        lib.ngp_blocked_grid_table_bwd_2d.restype = ci
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


# threads per block of the planned launches
THREADS = 256

# the level groups scripts/encode_group_sweep.py times each kernel at; the
# source's groups are the fastest of these
SWEPT_GROUPS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A launch of a kernel over the (sample, level) pairs:
    ``groups`` level groups of ``width`` levels (grid y), each covered by
    ``blocks`` blocks of ``threads`` threads (grid x). Thread t of block b
    in group k takes pair p = b·threads + t: sample p // width, level
    k·width + p % width. Threads past sample n - 1 are idle."""
    n: int
    n_levels: int
    width: int
    threads: int
    blocks: int
    groups: int

    @property
    def log2_width(self) -> int:
        return self.width.bit_length() - 1

    @property
    def launch_args(self) -> tuple:
        """The plan as the entry points take it, before the stream."""
        return self.blocks, self.threads, self.log2_width

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
    """Size a planned launch for n samples × n_levels levels, with the
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


# The 2D encode forward's tile (samples a block, a power of two from 32)
# and the most levels each warp walks in turn (1: one warp per 32 samples
# of a level; 32: one thread per sample): for K1 and K4 alike the fastest
# on an H100 on an image step and on a frame's pixel centres of those
# scripts/encode_group_sweep.py timed (PERF.md); the 2D K3 takes the same
# plan
FWD_2D_SAMPLES, FWD_2D_LEVELS_PER_WARP = 32, 4
# the most shared memory its tile may take (the entry point's limit)
FWD_2D_SMEM = 48 << 10


def fwd_2d_smem_bytes(samples: int, n_levels: int) -> int:
    """The shared memory of a 2D encode-forward tile: 2 floats a (sample,
    level) and one pad word per 32 floats."""
    floats = 2 * n_levels * samples
    return (floats + floats // 32) * 4


@dataclasses.dataclass(frozen=True)
class FwdPlan2D:
    """A launch of the 2D encode forward (K1, K4) or of the 2D position
    backward (K3): ``blocks`` blocks of ``threads`` threads, block b
    taking the tile of samples [b·samples, (b + 1)·samples) × all
    ``n_levels`` levels. The tile has samples / 32 columns of 32
    consecutive samples, and each column the same number of warps,
    ``steps`` = threads / samples: warp w takes column c = w mod
    (samples / 32), lane j its sample 32·c + j, and walks the levels
    w // (samples / 32), + steps, .... The features pass through
    ``smem_bytes`` of shared memory and leave as 16-byte stores, thread t
    taking the tile's floats 4t, 4t + 4·threads, ...; a lane past sample
    n - 1 looks that sample up again and stores nothing. K3's cotangent
    comes into the same shared memory by the same 16-byte steps (zeros
    past sample n - 1), each lane writes its level's dfrac·scale over its
    cotangent, and thread t adds component t mod 2 of sample t // 2 of the
    tile (and t + threads, ...) over the levels in level order (``sums``)."""
    n: int
    n_levels: int
    samples: int
    threads: int
    blocks: int

    @property
    def log2_samples(self) -> int:
        return self.samples.bit_length() - 1

    @property
    def smem_bytes(self) -> int:
        return fwd_2d_smem_bytes(self.samples, self.n_levels)

    @property
    def launch_args(self) -> tuple:
        """The plan as the entry points take it, before the stream."""
        return self.blocks, self.threads, self.log2_samples

    @property
    def steps(self) -> int:
        """Warps per 32-sample column: the stride of a warp's walk."""
        return self.threads // self.samples

    @property
    def walk(self) -> int:
        """The most levels a warp walks."""
        return -(-self.n_levels // self.steps)

    def pairs(self):
        """(sample, level, warp) of every lookup, each (blocks, lookups of
        a tile, 32 lanes), in the kernel's own mapping (each warp's walk in
        turn); a sample ≥ n marks a lane whose lookup is not stored."""
        cols = self.samples // 32
        warp = np.repeat(np.arange(self.threads // 32),
                         [len(range(w // cols, self.n_levels, self.steps))
                          for w in range(self.threads // 32)])
        level = np.concatenate([np.arange(w // cols, self.n_levels,
                                          self.steps)
                                for w in range(self.threads // 32)])
        sample = (np.arange(self.blocks)[:, None, None] * self.samples
                  + (warp % cols * 32)[None, :, None] + np.arange(32))
        shape = sample.shape
        return (sample, np.broadcast_to(level[None, :, None], shape),
                np.broadcast_to(warp[None, :, None], shape))

    def sums(self):
        """K3's sums: (block, thread, sample, component) of every
        (sample, component) of dpos with sample < n, in the kernel's own
        mapping; each is stored by its thread, at float 2·sample +
        component."""
        out = []
        for b in range(self.blocks):
            k = np.arange(2 * min(self.samples, self.n - b * self.samples))
            out.append((np.full(k.size, b), k % self.threads,
                        b * self.samples + k // 2, k % 2))
        return tuple(np.concatenate(a) for a in zip(*out))

    def stores(self):
        """Every store of the features to the output, in the kernel's own
        mapping: (block, byte offset, bytes) arrays, one 16-byte store per
        4 floats of a tile and a 4-byte one per float of a tail shorter
        than 4."""
        width = 2 * self.n_levels
        block, offset, size = [], [], []
        for b in range(self.blocks):
            floats = min(self.samples, self.n - b * self.samples) * width
            whole = np.arange(0, floats - 3, 4)
            tail = np.arange(4 * whole.size, floats)
            base = b * self.samples * width
            for t, nbytes in ((whole, 16), (tail, 4)):
                block.append(np.full(t.size, b))
                offset.append(4 * (base + t))
                size.append(np.full(t.size, nbytes))
        return tuple(np.concatenate(a) if a else np.zeros(0, np.int64)
                     for a in (block, offset, size))


def fwd_plan_2d(n: int, meta: BlockedGridMeta) -> FwdPlan2D:
    """The plan of K1, K3 and K4 on the 2D grid ``meta`` for n samples: tiles
    of FWD_2D_SAMPLES samples, each warp walking at most
    FWD_2D_LEVELS_PER_WARP levels of a 32-sample column (all L where that
    is more), so a block of samples / 32 · ⌈L / walk⌉ warps. Raises
    ValueError for what the kernel does not take: a grid that is not 2D or
    has more than 32 levels, a tile that is not a power of two in [32,
    1024], a walk below 1, more than 1024 threads or a tile past
    FWD_2D_SMEM."""
    n_levels, samples = meta.n_levels, FWD_2D_SAMPLES
    per_warp = min(FWD_2D_LEVELS_PER_WARP, n_levels)
    if meta.n_dims != 2 or not 1 <= n_levels <= 32:
        raise ValueError(f"the 2D encode forward takes 2D grids of 1 to 32 "
                         f"levels, got {meta.n_dims}D, {n_levels} levels")
    if samples < 32 or samples & (samples - 1) or samples > 1024:
        raise ValueError(f"2D encode-forward tile must be a power of two in "
                         f"[32, 1024], got {samples}")
    if per_warp < 1:
        raise ValueError(f"levels a warp walks must be at least 1, got "
                         f"{per_warp}")
    threads = samples // 32 * -(-n_levels // per_warp) * 32
    if threads > 1024 or fwd_2d_smem_bytes(samples, n_levels) > FWD_2D_SMEM:
        raise ValueError(f"a 2D encode-forward tile of {samples} samples × "
                         f"{n_levels} levels takes {threads} threads and "
                         f"{fwd_2d_smem_bytes(samples, n_levels)} bytes of "
                         f"shared memory (limits 1024, {FWD_2D_SMEM})")
    return FwdPlan2D(n, n_levels, samples, threads, -(-n // samples))


# Where the 2D table backward sums a level's gradient (``where`` of
# ``TableBwdPlan``): by reductions straight to L2, or in a copy of the
# level's rows in shared memory
SUM_L2, SUM_LEVEL = 0, 1
# levels per block of the 2D table backward, K2's and K5's: the fastest of
# 1, 2 and 4 on an H100 on an image step (scripts/encode_group_sweep.py;
# PERF.md). At 4 a sample's levels take one whole 32-byte sector of the
# cotangent; K2's blocks of 2 run runs half as long, twice as many.
TABLE_BWD_GROUP, TABLE_BWD_GROUP_I8 = 2, 4
# the 2D table backward's shared memory a level group may sum in, and K2's
# samples per block: the fastest on an H100 of those
# scripts/encode_group_sweep.py timed (PERF.md)
TABLE_BWD_SMEM = 64 << 10
TABLE_BWD_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class TableBwdPlan:
    """A launch of the 2D table backward: ``chunks`` × L / ``width``
    blocks of ``threads`` threads, block (c, k) taking levels
    [k·width, (k + 1)·width) of samples [c·chunk, (c + 1)·chunk) (K5:
    chunk = the quantisation tile; thread t level t % width of a run of
    chunk·width / threads consecutive samples) with ``smem_bytes`` of
    shared memory for its SUM_LEVEL levels' rows; ``where`` per level
    (``SUM_*``)."""
    n: int
    chunk: int
    width: int
    threads: int
    chunks: int
    smem_bytes: int
    where: tuple

    @property
    def log2_chunk(self) -> int:
        return self.chunk.bit_length() - 1

    @property
    def log2_width(self) -> int:
        return self.width.bit_length() - 1


def table_bwd_plan_2d(n: int, meta: BlockedGridMeta,
                      tile: Optional[int] = None) -> TableBwdPlan:
    """The plan of K2 (``tile`` None: chunks of TABLE_BWD_CHUNK samples,
    level groups of TABLE_BWD_GROUP) or K5 (chunks of ``tile``, groups of
    TABLE_BWD_GROUP_I8) on the 2D grid ``meta``, each group narrowed as
    ``launch_plan`` narrows where it does not divide the level count: a
    level whose ``level_needed_rows`` fit
    in its share of TABLE_BWD_SMEM (a group's levels share it equally) is
    summed in shared memory, the others in L2."""
    chunk = TABLE_BWD_CHUNK if tile is None else tile
    if chunk < 32 or chunk & (chunk - 1) or chunk > 1 << 24:
        raise ValueError(f"table backward chunk must be a power of two in "
                         f"[32, 2^24], got {chunk}")
    group = TABLE_BWD_GROUP if tile is None else TABLE_BWD_GROUP_I8
    width = min(group, meta.n_levels & -meta.n_levels)
    smem_rows = TABLE_BWD_SMEM // (LANES * 4)
    where = tuple(SUM_LEVEL if dense and needed <= smem_rows // width
                  else SUM_L2
                  for dense, needed in zip(meta.level_is_dense,
                                           meta.level_needed_rows))
    # a block's shared rows: its group's SUM_LEVEL levels' blocks^2 each
    rows = max(sum(meta.level_blocks_per_dim[l] ** 2
                   for l in range(l0, l0 + width) if where[l] == SUM_LEVEL)
               for l0 in range(0, meta.n_levels, width))
    return TableBwdPlan(n, chunk, width, min(chunk * width, THREADS),
                        -(-n // chunk), rows * LANES * 4, where)


def _check(meta: BlockedGridMeta, pos: torch.Tensor, *tensors):
    """Raise on what the kernels do not take: every tensor on one CUDA
    device and contiguous, float32 positions (N, D) of the grid's D (2 or
    3), F=2, a known row hash."""
    if not all(t.is_cuda and t.device == pos.device for t in (pos, *tensors)):
        raise ValueError("blocked-grid kernel: all tensors must be on one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in (pos, *tensors)):
        raise ValueError("blocked-grid kernel takes contiguous tensors")
    if pos.dtype != torch.float32:
        raise TypeError("blocked-grid kernel takes float32 positions")
    if pos.dim() != 2 or pos.shape[1] != meta.n_dims:
        raise ValueError(f"blocked-grid kernel takes positions (N, "
                         f"{meta.n_dims}), got {tuple(pos.shape)} for a "
                         f"{meta.n_dims}D grid")
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


def kernel_plan(name: str, n: int, meta: BlockedGridMeta) -> LaunchPlan:
    """The launch plan of kernel ``name`` (one of ``GROUP_KERNELS``) for n
    samples, with its level group as the library was built with it."""
    return launch_plan(n, meta.n_levels, build().ngp_blocked_grid_group(
        GROUP_KERNELS.index(name)))


def _planned_args(meta: BlockedGridMeta, pos: torch.Tensor, plan):
    """``_level_args`` with a launch plan (a ``LaunchPlan`` or a
    ``FwdPlan2D``) before the stream."""
    args, arrays = _level_args(meta, pos)
    return args[:-1] + [*plan.launch_args, args[-1]], arrays


def check_warps_in_tiles(plan: LaunchPlan, tile: int):
    """K5 reduces each warp's maxima and sums its quanta under one tile's
    scale: every warp's 32 / width samples, which start at a multiple of
    32 / width, must lie inside one tile of ``tile`` samples."""
    per_warp = 32 // plan.width
    if plan.threads % 32 or tile < per_warp or tile % per_warp:
        raise ValueError(f"a warp of {per_warp} samples does not lie inside "
                         f"one tile of {tile}")


def _run(name: str, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + build().ngp_cuda_error_string(rc).decode())
    launches[name] += 1


def launch_name(kernel: str, meta: BlockedGridMeta) -> str:
    """The launch name (a key of ``launches``) of ``kernel`` (one of
    ``GROUP_KERNELS``) on ``meta``'s grid: ``kernel`` itself in 3D,
    ``kernel + "_2d"`` in 2D."""
    return kernel if meta.n_dims == 3 else f"{kernel}_2d"


def _fwd_plan(kernel: str, n: int, meta: BlockedGridMeta):
    """The plan of K1 or K4 (``kernel``): ``fwd_plan_2d``'s on 2D grids,
    the kernel's level groups on 3D ones."""
    if meta.n_dims == 2:
        return fwd_plan_2d(n, meta)
    return kernel_plan(kernel, n, meta)


def launch_fwd(table: torch.Tensor, pos: torch.Tensor,
               meta: BlockedGridMeta) -> torch.Tensor:
    """K1: (L, R, 128) f32 table + (N, D) positions → (N, L·2), D = 3 or
    2."""
    _check(meta, pos, table)
    _check_table(table, meta, torch.float32)
    out = torch.empty((pos.shape[0], meta.n_levels * 2), dtype=torch.float32,
                      device=pos.device)
    if pos.shape[0] == 0:
        return out
    lib = build()
    name = launch_name("blocked_grid_encode_fwd", meta)
    args, _keep = _planned_args(meta, pos, _fwd_plan(
        "blocked_grid_encode_fwd", pos.shape[0], meta))
    _run(name, getattr(lib, f"ngp_{name}"), pos.data_ptr(), table.data_ptr(),
         out.data_ptr(), *args)
    return out


def launch_fwd_i8(table_q: torch.Tensor, qscales: torch.Tensor,
                  pos: torch.Tensor, meta: BlockedGridMeta) -> torch.Tensor:
    """K4: (L, R, 128) int8 table + (L,) f32 scales + (N, D) positions →
    (N, L·2), D = 3 or 2."""
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
    name = launch_name("blocked_grid_encode_fwd_i8", meta)
    args, _keep = _planned_args(meta, pos, _fwd_plan(
        "blocked_grid_encode_fwd_i8", pos.shape[0], meta))
    _run(name, getattr(lib, f"ngp_{name}"), pos.data_ptr(),
         table_q.data_ptr(), qscales.data_ptr(), out.data_ptr(), *args)
    return out


def _launch_table_bwd_2d(pos: torch.Tensor, grad: torch.Tensor,
                         meta: BlockedGridMeta,
                         tile: Optional[int]) -> torch.Tensor:
    """K2 (``tile`` None) or K5 on a 2D grid, on ``table_bwd_plan_2d``'s
    plan."""
    n = pos.shape[0]
    plan = table_bwd_plan_2d(n, meta, tile)
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if n == 0:
        return dtable
    lib = build()
    name = launch_name("blocked_grid_encode_bwd_i8" if tile else
                       "blocked_grid_encode_bwd", meta)
    arrays = level_arrays(meta) + (np.asarray(plan.where, np.uint8),)
    _run(name, lib.ngp_blocked_grid_table_bwd_2d, pos.data_ptr(),
         grad.data_ptr(), dtable.data_ptr(), *[a.ctypes.data for a in arrays],
         n, meta.n_levels, meta.log2_rows, int(meta.row_hash == "morton"),
         plan.log2_chunk, plan.log2_width, plan.threads, plan.smem_bytes,
         int(tile is not None), torch.cuda.current_stream(pos.device).cuda_stream)
    return dtable


def launch_bwd(pos: torch.Tensor, grad: torch.Tensor,
               meta: BlockedGridMeta) -> torch.Tensor:
    """K2: (N, D) positions + (N, L·2) f32 cotangent → dTable
    (L, R, 128) f32, D = 3 or 2."""
    _check(meta, pos, grad)
    _check_cotangent(pos, grad, meta)
    if meta.n_dims == 2:
        return _launch_table_bwd_2d(pos, grad, meta, None)
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if pos.shape[0] == 0:
        return dtable
    lib = build()
    name = launch_name("blocked_grid_encode_bwd", meta)
    args, _keep = _planned_args(meta, pos, kernel_plan(
        "blocked_grid_encode_bwd", pos.shape[0], meta))
    _run(name, getattr(lib, f"ngp_{name}"), pos.data_ptr(), grad.data_ptr(),
         dtable.data_ptr(), *args)
    return dtable


def launch_bwd_pos(table: torch.Tensor, pos: torch.Tensor,
                   grad: torch.Tensor, meta: BlockedGridMeta) -> torch.Tensor:
    """K3: (L, R, 128) f32 table + (N, D) positions + (N, L·2) f32
    cotangent → dpos (N, D) f32, D = 3 or 2."""
    _check(meta, pos, table, grad)
    _check_table(table, meta, torch.float32)
    _check_cotangent(pos, grad, meta)
    n, d = pos.shape
    dpos = torch.empty((n, d), dtype=torch.float32, device=pos.device)
    if n == 0:
        return dpos
    lib = build()
    name = launch_name("blocked_grid_encode_bwd_pos", meta)
    if meta.n_dims == 2:
        args, _keep = _planned_args(meta, pos, fwd_plan_2d(n, meta))
        _run(name, lib.ngp_blocked_grid_encode_bwd_pos_2d, pos.data_ptr(),
             table.data_ptr(), grad.data_ptr(), dpos.data_ptr(), *args)
        return dpos
    plan = kernel_plan("blocked_grid_encode_bwd_pos", n, meta)
    # each level group's sum, added up in group order by the second pass
    partial = (torch.empty((plan.groups, n, d), dtype=torch.float32,
                           device=pos.device) if plan.groups > 1 else None)
    args, _keep = _planned_args(meta, pos, plan)
    _run(name, getattr(lib, f"ngp_{name}"), pos.data_ptr(), table.data_ptr(),
         grad.data_ptr(), dpos.data_ptr(),
         None if partial is None else partial.data_ptr(), *args)
    return dpos


def launch_bwd_i8(pos: torch.Tensor, grad: torch.Tensor,
                  meta: BlockedGridMeta, tile: int) -> torch.Tensor:
    """K5: (N, D) positions + (N, L·2) f32 cotangent → dTable (L, R, 128)
    f32, the products w·g quantised to int8 per (level, tile of ``tile``
    samples), D = 3 or 2."""
    _check(meta, pos, grad)
    _check_cotangent(pos, grad, meta)
    if tile < 32 or tile & (tile - 1):
        raise ValueError(f"int8 backward tile must be a power of two ≥ 32, "
                         f"got {tile}")
    if meta.n_dims == 2:
        return _launch_table_bwd_2d(pos, grad, meta, tile)
    dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                         dtype=torch.float32, device=pos.device)
    if pos.shape[0] == 0:
        return dtable
    n_tiles = -(-pos.shape[0] // tile)
    tile_max = torch.zeros((meta.n_levels, n_tiles), dtype=torch.int32,
                           device=pos.device)
    lib = build()
    plan = kernel_plan("blocked_grid_encode_bwd_i8", pos.shape[0], meta)
    check_warps_in_tiles(plan, tile)
    args, _keep = _planned_args(meta, pos, plan)
    name = launch_name("blocked_grid_encode_bwd_i8", meta)
    _run(name, getattr(lib, f"ngp_{name}"), pos.data_ptr(), grad.data_ptr(),
         tile_max.data_ptr(), dtable.data_ptr(), *args[:-1],
         tile.bit_length() - 1, args[-1])
    return dtable


# int8 modes of the encode (the JAX package's NGP_TPU_ENCODE_INT8): "" the
# f32 table; "fwd" the int8 forward (K4) with the exact f32 backward (K2);
# "full" the int8 forward and the int8-quantised table backward (K5). The
# position gradient (K3) reads the f32 table in every mode.
INT8_MODES = ("", "fwd", "full")


def check_int8_mode(mode: str) -> str:
    """``mode`` if it is one of ``INT8_MODES``; raises ValueError
    otherwise."""
    if mode not in INT8_MODES:
        raise ValueError(f"int8 mode must be one of {INT8_MODES}, got "
                         f"{mode!r}")
    return mode


class _BlockedGridEncode(torch.autograd.Function):
    """Encode forward (K1, or K4 on the int8-quantised table), table
    backward (K2, or K5 in the ``full`` mode) and position backward (K3) on
    CUDA; the plain versions of all five on the CPU."""

    @staticmethod
    def forward(ctx, table, pos, meta, mode, tile):
        ctx.meta, ctx.mode, ctx.tile = meta, mode, tile
        ctx.save_for_backward(table, pos)
        if mode:
            return encode_quantized(*quantize_table_i8(table), pos, meta)
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


def encode_quantized(table_q: torch.Tensor, qscales: torch.Tensor,
                     pos: torch.Tensor, meta: BlockedGridMeta) -> torch.Tensor:
    """The int8 forward (K4) on a table already quantised by
    ``quantize_table_i8``, for callers that encode many chunks of positions
    through one unchanged table (the grid sweep). Nothing is
    differentiated: the int8 table carries no gradient."""
    if pos.is_cuda:
        return launch_fwd_i8(table_q, qscales, pos, meta)
    if pos.device.type != "cpu":
        raise ValueError(f"encode_quantized: unsupported device {pos.device}")
    return encode_reference_i8(table_q, qscales, pos, meta)


def encode_mode(table: torch.Tensor, pos: torch.Tensor,
                meta: BlockedGridMeta, mode: str = "",
                tile: Optional[int] = None) -> torch.Tensor:
    """The encode in one of ``INT8_MODES``."""
    if mode == "full":
        return blocked_grid_encode_int8(table, pos, meta, tile)
    if mode == "fwd":
        return blocked_grid_encode_i8fwd(table, pos, meta)
    check_int8_mode(mode)
    return blocked_grid_encode(table, pos, meta)
