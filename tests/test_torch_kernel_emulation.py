"""The CUDA kernels' arithmetic on the CPU. ngp_tpu_torch/csrc/
blocked_grid_encode.cu is compiled by the host C++ compiler against a
stand-in for the CUDA runtime (``RUNTIME`` below) that runs the blocks of
each launch one after another and each block's threads at once, one host
thread each: ``__syncthreads`` is a barrier of the block, and every warp
intrinsic (shuffles, ``__match_any_sync``, ``__reduce_max_sync``) a
barrier of the warp's lanes, which swap their values through slots;
atomics take a lock; a launch's dynamic shared memory (``extern
__shared__``) is one buffer per block, filled with 0xff bytes (NaN floats,
-1 ints) so that a sum the kernel does not zero first shows. The library is loaded through the wrapper's own
ctypes declarations; the launches then go through ``blocked_grid_cuda``'s
``launch_*`` wrappers (their plans, argument order and launch names) on
CPU tensors and are held against the plain versions with chip_smoke.py's
tolerances. This covers each kernel's geometry, its corner loads (K4's
byte picks from 2D and 3D lines), weights, warp sums and stores on 2D and
3D grids, and every kernel at 7 and 6 levels, whose plans take level
groups of width 1 and 2. The 2D table backward (K2, K5) runs on an
all-dense grid whose coarse levels are summed in shared memory and whose
finer ones in L2, on stratified and on uniform positions; the 2D encode
forward (K1, K4) at 16, 7 and 6 levels on the image path's three inputs
(a stratified batch, a chunk of row-major pixel centres, uniform
positions with the edge positions), under its default plan and two
others, each with a ragged last tile, into outputs filled with NaN so
that a (sample, level) it does not store shows; the 2D position backward
(K3) on the same grids, inputs and plans, its cotangent also from a
tensor that is not 16-byte aligned, into a NaN-filled dpos, bit-equal
over two launches.

What a host cannot show is the card's own: the order in which a warp's
lanes run, f32 atomics' flush of denormals and the compiler's FMAs stay
with chip_smoke.py on the card."""
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from ngp_tpu_torch.rays.sampling import sample_positions

# chip_smoke.py's tolerances: K1, K4 absolute; K2 relative to Σ|w·g|; K3
# relative to Σ|term|; K5 relative to Σ_t scale_t·Σ|q|
KERNEL_TOL, KERNEL_BWD_TOL, KERNEL_POS_TOL, KERNEL_I8_TOL = \
    1e-5, 1e-4, 1e-5, 1e-5

RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct U3 { unsigned x, y, z; };
inline thread_local U3 threadIdx;
inline U3 blockIdx, blockDim;
// the dynamic shared memory of the block that runs
inline std::vector<unsigned char> g_dynamic_smem;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
// a block's threads run at once, one std::thread each; a warp's lanes
// meet at a barrier in every warp intrinsic and swap values through slots
struct Warp {
  std::unique_ptr<std::barrier<>> bar;
  uint64_t slot[32];
  bool live[32];
};
inline std::unique_ptr<std::barrier<>> g_block;
inline std::vector<Warp> g_warps;
inline std::mutex g_atomic;
inline Warp& my_warp() { return g_warps[threadIdx.x / 32]; }
template <class T> uint64_t to_slot(T v) {
  uint64_t u = 0; memcpy(&u, &v, sizeof(T)); return u; }
template <class T> T from_slot(uint64_t u) { T v; memcpy(&v, &u, sizeof(T)); return v; }
// every lane publishes v, then reads what pick(lane slots) gives it
template <class T, class F> T exchange(T v, F pick) {
  Warp& w = my_warp();
  w.slot[threadIdx.x & 31] = to_slot(v);
  w.bar->arrive_and_wait();
  const T r = pick(w);
  w.bar->arrive_and_wait();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return exchange(v, [&](Warp& w) { return from_slot<T>(w.slot[src & 31]); });
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  const int j = ((int)(threadIdx.x & 31)) ^ m;
  return exchange(v, [&](Warp& w) { return from_slot<T>(w.slot[j]); });
}
inline unsigned __match_any_sync(unsigned, unsigned long long v) {
  return exchange(v, [&](Warp& w) {
    unsigned m = 0;
    for (int j = 0; j < 32; ++j)
      if (w.live[j] && w.slot[j] == v) m |= 1u << j;
    return (unsigned long long)m; });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return exchange(v, [&](Warp& w) {
    unsigned m = 0;
    for (int j = 0; j < 32; ++j)
      if (w.live[j]) m = std::max(m, (unsigned)w.slot[j]);
    return m; });
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline float2 atomicAdd(float2* p, float2 v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const float2 o = *p; p->x += v.x; p->y += v.y; return o; }
inline float4 atomicAdd(float4* p, float4 v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const float4 o = *p; p->x += v.x; p->y += v.y; p->z += v.z; p->w += v.w;
  return o; }
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const float o = *p; *p += v; return o; }
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const int o = *p; *p += v; return o; }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const unsigned o = *p; *p = std::max(o, v); return o; }
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// the launch: t host threads, made once, run the blocks one after
// another, all t at once in each; between blocks they wait at `start`
// while this thread sets the next block up (its `smem` bytes of dynamic
// shared memory filled with 0xff), and a thread whose kernel returns
// leaves its block's and its warp's barriers
template <class F> void emulate(dim3 g, unsigned t, size_t smem, F f) {
  blockDim = {t, 1, 1};
  const unsigned n_blocks = g.x * g.y;
  std::barrier<> start(t + 1), done(t + 1);
  std::vector<std::thread> threads;
  for (unsigned tx = 0; tx < t; ++tx)
    threads.emplace_back([&, tx] {
      threadIdx = {tx, 0, 0};
      for (unsigned b = 0; b < n_blocks; ++b) {
        start.arrive_and_wait();
        f();
        Warp& w = my_warp();
        w.live[tx & 31] = false;
        w.bar->arrive_and_drop();
        g_block->arrive_and_drop();
        done.arrive_and_wait();
      }
    });
  for (unsigned b = 0; b < n_blocks; ++b) {
    blockIdx = {b % g.x, b / g.x, 0};
    g_dynamic_smem.assign(smem, 0xff);
    g_block = std::make_unique<std::barrier<>>(t);
    g_warps = std::vector<Warp>((t + 31) / 32);
    for (unsigned k = 0; k < g_warps.size(); ++k) {
      const unsigned lanes = std::min(32u, t - 32 * k);
      g_warps[k].bar = std::make_unique<std::barrier<>>(lanes);
      for (unsigned j = 0; j < 32; ++j) g_warps[k].live[j] = j < lanes;
    }
    start.arrive_and_wait();
    done.arrive_and_wait();
  }
  for (auto& th : threads) th.join();
}
using std::max;
using std::min;
"""


def _split_top(s: str) -> list:
    """``s`` split at the commas outside parentheses and brackets."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def emulated_source(src: str) -> str:
    """The kernel source with each ``kernel<<<grid, threads, smem,
    ...>>>(args)`` launch run by ``emulate``, each ``extern __shared__``
    array on the launch's dynamic shared memory, and the runtime stand-in
    included."""
    def launch(m):
        cfg = _split_top(m.group(2))
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"emulate(dim3({cfg[0]}), {cfg[1]}, {smem}, [&] {{ "
                f"{m.group(1)}({m.group(3)}); }});")
    out = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, src,
                 flags=re.S)
    assert out.count("emulate(") == src.count("<<<") > 0
    out = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_dynamic_smem.data());",
                 out)
    return out.replace("#include <cuda_runtime.h>",
                       '#include "emulated_runtime.h"')


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, with ``blocked_grid_cuda``
    launching into it from CPU tensors."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    d = tmp_path_factory.mktemp("kernel_emulation")
    (d / "emulated_runtime.h").write_text(RUNTIME)
    (d / "kernels.cpp").write_text(emulated_source(
        (bgc.CSRC / "blocked_grid_encode.cu").read_text()))
    lib = d / "libkernels.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-Wno-unknown-pragmas", f"-I{d}", "-o", str(lib),
         str(d / "kernels.cpp")], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    mp = pytest.MonkeyPatch()
    mp.setattr(bgc, "build", lambda: loaded)
    mp.setattr(bgc, "_check", lambda *a: None)
    mp.setattr(torch.cuda, "current_stream",
               lambda *a: types.SimpleNamespace(cuda_stream=0))
    loaded = bgc.load_library(lib)
    yield loaded
    mp.undo()


# 2D and 3D, both row hashes, dense and hashed levels
METAS = [dict(n_dims=2, n_levels=4, base_resolution=16, per_level_scale=2.0,
              log2_rows=8),
         dict(n_dims=2, n_levels=16, base_resolution=16, per_level_scale=1.5,
              log2_rows=10),
         dict(n_dims=2, n_levels=4, base_resolution=16, per_level_scale=2.0,
              log2_rows=8, row_hash="morton"),
         dict(n_dims=3, n_levels=4, base_resolution=8, per_level_scale=2.0,
              log2_rows=9)]
META_IDS = ["2d", "2d-16-levels", "2d-morton", "3d"]


def _inputs(meta, seed: int, n: int = 2000):
    """A seeded table at std 0.5, uniform positions with some outside the
    unit square or cube and the two corners, and a cotangent with every
    fifth sample zero."""
    rng = np.random.default_rng(seed)
    d = meta.n_dims
    table = (rng.standard_normal((meta.n_levels, meta.rows, 128))
             * 0.5).astype(np.float32)
    pos = np.concatenate([rng.random((n, d), dtype=np.float32),
                          rng.random((64, d), dtype=np.float32) * 1.2 - 0.1,
                          np.zeros((1, d), np.float32),
                          np.ones((1, d), np.float32)])
    cot = rng.standard_normal((pos.shape[0], meta.n_levels * 2)).astype(
        np.float32)
    cot[::5] = 0.0
    return (torch.from_numpy(table), torch.from_numpy(pos),
            torch.from_numpy(cot))


def _count(kernel, meta) -> int:
    return bgc.launches[bgc.launch_name(kernel, meta)]


@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_emulated_forward_kernels_match_plain(emulated, meta_kw):
    """K1 on the f32 table and K4 on the int8-quantised one (its line
    loads and byte picks) against their plain versions."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, _ = _inputs(meta, 1)
    k1, k4 = (_count(k, meta) for k in ("blocked_grid_encode_fwd",
                                        "blocked_grid_encode_fwd_i8"))
    got = bgc.launch_fwd(table, pos, meta)
    assert float((got - tbg.encode_reference(table, pos, meta)).abs().max()
                 ) <= KERNEL_TOL
    tq, qs = tbg.quantize_table_i8(table)
    got = bgc.launch_fwd_i8(tq, qs, pos, meta)
    ref = tbg.encode_reference_i8(tq, qs, pos, meta)
    assert float((got - ref).abs().max()) <= KERNEL_TOL
    assert float(ref.abs().max()) > 0.1
    assert _count("blocked_grid_encode_fwd", meta) == k1 + 1
    assert _count("blocked_grid_encode_fwd_i8", meta) == k4 + 1


@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_emulated_table_backward_kernels_match_plain(emulated, meta_kw):
    """K2 (relative to Σ|w·g|, equal zero patterns) and K5 in tiles of 64
    (on the 4-level grids: the plain version loops over levels × tiles)
    and 2048 samples (relative to Σ_t scale_t·Σ|q|, exact zeros where
    every quantum is 0) against their plain versions."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    _, pos, cot = _inputs(meta, 2)
    got = bgc.launch_bwd(pos, cot, meta)
    ref = tbg.encode_backward_reference(pos, cot, meta)
    scale = tbg.encode_backward_reference(pos, cot.abs(), meta)
    assert float(((got - ref).abs() / scale.clamp(min=1e-30)).max()) \
        <= KERNEL_BWD_TOL
    assert torch.equal(got == 0, ref == 0)
    for tile in ((64, 2048) if meta.n_levels <= 4 else (2048,)):
        got = bgc.launch_bwd_i8(pos, cot, meta, tile)
        ref = tbg.encode_backward_reference_i8(pos, cot, meta, tile)
        mag = tbg.encode_backward_reference_i8(pos, cot, meta, tile,
                                               magnitude=True)
        assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
            <= KERNEL_I8_TOL
        assert bool((got[mag == 0] == 0).all()) and bool((mag > 0).any())


@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_emulated_position_backward_matches_plain(emulated, meta_kw):
    """K3 level by level (a one-level grid at about each level's scale,
    the level's table and cotangent): (N, D) within KERNEL_POS_TOL of
    Σ|term|, exactly 0 where every term is."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = _inputs(meta, 3, n=1000)
    for level in (0, meta.n_levels // 2, meta.n_levels - 1):
        one = tbg.BlockedGridMeta(
            meta.n_dims, 1, int(round(meta.level_scales[level] + 1)), 2.0,
            log2_rows=meta.log2_rows, row_hash=meta.row_hash)
        t = table[level:level + 1].contiguous()
        c = cot[:, 2 * level:2 * level + 2].contiguous()
        got = bgc.launch_bwd_pos(t, pos, c, one)
        ref = tbg.encode_position_backward_reference(t, pos, c, one)
        mag = tbg.encode_position_backward_reference(t, pos, c, one,
                                                     magnitude=True)
        assert got.shape == pos.shape
        assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
            <= KERNEL_POS_TOL
        assert bool((got[mag == 0] == 0).all())


# level counts whose launch plans give level groups narrower than the
# kernels' own: 7 levels (the Takikawa octree at depths 4..10) in groups of
# width 1, 6 levels in groups of width 2
ODD_METAS = [dict(n_dims=3, n_levels=7, base_resolution=16,
                  per_level_scale=2.0, log2_rows=9),
             dict(n_dims=3, n_levels=6, base_resolution=8,
                  per_level_scale=1.5, log2_rows=9),
             dict(n_dims=2, n_levels=7, base_resolution=16,
                  per_level_scale=2.0, log2_rows=8),
             dict(n_dims=2, n_levels=6, base_resolution=16,
                  per_level_scale=1.5, log2_rows=8)]
ODD_IDS = ["3d-L7", "3d-L6", "2d-L7", "2d-L6"]


@pytest.mark.parametrize("meta_kw", ODD_METAS, ids=ODD_IDS)
def test_emulated_kernels_at_odd_level_counts(emulated, meta_kw):
    """All five kernels through their wrappers on a whole 7- or 6-level
    grid, each 3D plan in groups of width 1 or 2: K1 and K4 absolute, K2
    and K5 (tiles of 64 and 2048) relative with their zero patterns, and K3
    relative to Σ|term| (in 3D with its group partials added in order by
    its second pass; in 2D in one pass, on K1's 2D plan), bit-equal over
    two launches."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = _inputs(meta, 4, n=600)
    width = 1 if meta.n_levels == 7 else 2
    if meta.n_dims == 3:
        for name in bgc.GROUP_KERNELS:
            plan = bgc.kernel_plan(name, pos.shape[0], meta)
            assert plan.width == width \
                and plan.groups == meta.n_levels // width
    else:
        plan = bgc.fwd_plan_2d(pos.shape[0], meta)
        assert (plan.samples, plan.threads) == (32, 64)   # 2 walks
    before = {k: _count(k, meta) for k in bgc.GROUP_KERNELS}
    got = bgc.launch_fwd(table, pos, meta)
    assert float((got - tbg.encode_reference(table, pos, meta)).abs().max()
                 ) <= KERNEL_TOL
    tq, qs = tbg.quantize_table_i8(table)
    got = bgc.launch_fwd_i8(tq, qs, pos, meta)
    assert float((got - tbg.encode_reference_i8(tq, qs, pos, meta)).abs()
                 .max()) <= KERNEL_TOL
    got = bgc.launch_bwd(pos, cot, meta)
    ref = tbg.encode_backward_reference(pos, cot, meta)
    scale = tbg.encode_backward_reference(pos, cot.abs(), meta)
    assert float(((got - ref).abs() / scale.clamp(min=1e-30)).max()) \
        <= KERNEL_BWD_TOL
    assert torch.equal(got == 0, ref == 0)
    for tile in (64, 2048):
        got = bgc.launch_bwd_i8(pos, cot, meta, tile)
        ref = tbg.encode_backward_reference_i8(pos, cot, meta, tile)
        mag = tbg.encode_backward_reference_i8(pos, cot, meta, tile,
                                               magnitude=True)
        assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
            <= KERNEL_I8_TOL
        assert bool((got[mag == 0] == 0).all())
    got = bgc.launch_bwd_pos(table, pos, cot, meta)
    ref = tbg.encode_position_backward_reference(table, pos, cot, meta)
    mag = tbg.encode_position_backward_reference(table, pos, cot, meta,
                                                 magnitude=True)
    assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
        <= KERNEL_POS_TOL
    assert bool((got[mag == 0] == 0).all()) and float(mag.max()) > 0.1
    assert torch.equal(bgc.launch_bwd_pos(table, pos, cot, meta), got)
    after = {k: _count(k, meta) for k in bgc.GROUP_KERNELS}
    assert after == {k: before[k] + {"blocked_grid_encode_bwd_i8": 2,
                                     "blocked_grid_encode_bwd_pos": 2
                                     }.get(k, 1) for k in before}


# An all-dense 2D grid (8 levels of 9 to 1600 rows in 2048, the image
# grid's shape at a small size): of TABLE_BWD_SMEM's 128 rows a level
# takes 64 in K2's groups of 2 levels (levels 0-3 in shared memory, 4-7
# in L2) and 32 in K5's groups of 4 (levels 0-1, and 2-7 in L2)
DENSE_2D = dict(n_dims=2, n_levels=8, base_resolution=16,
                per_level_scale=1.5, log2_rows=11)
# the kernel and its tile (K2: None)
TABLE_BWD_CASES = [("K2", None), ("K5", 64), ("K5", 512), ("K5", 2048)]
TABLE_BWD_IDS = ["K2", "K5-tile64", "K5-tile512", "K5-tile2048"]


def _dense_2d_inputs(kind: str):
    """The grid, 4096 stratified positions (the image step's order, 64 ×
    64 strata) or 4096 uniform ones with edge positions (corners 0 and 1,
    points up to 0.1 outside the square, every level's lattice vertices),
    and a seeded cotangent with every fifth sample zero."""
    meta = tbg.BlockedGridMeta(**DENSE_2D)
    rng = np.random.default_rng(5)
    if kind == "stratified":
        pos = sample_positions("stratified", torch.Generator().manual_seed(5),
                               1 << 12, 0).numpy()
    else:
        pts = [rng.random((1 << 12, 2), dtype=np.float32),
               rng.random((64, 2), dtype=np.float32) * 1.2 - 0.1,
               np.zeros((1, 2), np.float32), np.ones((1, 2), np.float32)]
        for sc in meta.level_scales:
            m = rng.integers(1, int(sc) + 1, (32, 2)).astype(np.float32)
            pts.append(np.clip((m - np.float32(0.5)) / np.float32(sc), 0, 1))
        pos = np.concatenate(pts).astype(np.float32)
    cot = rng.standard_normal((pos.shape[0], 16)).astype(np.float32)
    cot[::5] = 0.0
    return meta, torch.from_numpy(pos), torch.from_numpy(cot)


@pytest.mark.parametrize("kind", ["stratified", "uniform+edge"])
@pytest.mark.parametrize("kernel,tile", TABLE_BWD_CASES, ids=TABLE_BWD_IDS)
def test_emulated_2d_table_backward_matches_plain(emulated, kind, kernel,
                                                  tile):
    """The 2D K2 (relative to Σ|w·g|, equal zero patterns) and K5 at
    tiles 64, 512 and 2048 (relative to Σ_t scale_t·Σ|q|, exact zeros
    where every quantum is 0) against their plain versions, one launch
    each: K2 in groups of 2 levels with levels 0-3 in shared memory (a
    block's largest pair 36 + 64 rows), K5 in groups of 4 with levels 0-1
    (9 + 16 rows); the rest in L2."""
    meta, pos, cot = _dense_2d_inputs(kind)
    plan = bgc.table_bwd_plan_2d(pos.shape[0], meta, tile)
    shared, width, rows = (4, 2, 100) if tile is None else (2, 4, 25)
    assert plan.where == (bgc.SUM_LEVEL,) * shared + (bgc.SUM_L2,) * (
        8 - shared)
    assert (plan.width, plan.threads, plan.smem_bytes) == (width, 256,
                                                           rows * 512)
    name = "blocked_grid_encode_bwd" if tile is None \
        else "blocked_grid_encode_bwd_i8"
    before = _count(name, meta)
    if tile is None:
        got = bgc.launch_bwd(pos, cot, meta)
        ref = tbg.encode_backward_reference(pos, cot, meta)
        scale = tbg.encode_backward_reference(pos, cot.abs(), meta)
        assert float(((got - ref).abs() / scale.clamp(min=1e-30)).max()) \
            <= KERNEL_BWD_TOL
        assert torch.equal(got == 0, ref == 0)
    else:
        got = bgc.launch_bwd_i8(pos, cot, meta, tile)
        ref = tbg.encode_backward_reference_i8(pos, cot, meta, tile)
        mag = tbg.encode_backward_reference_i8(pos, cot, meta, tile,
                                               magnitude=True)
        assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
            <= KERNEL_I8_TOL
        assert bool((got[mag == 0] == 0).all()) and bool((mag > 0).any())
    assert _count(name, meta) == before + 1


@pytest.fixture
def nan_outputs(monkeypatch):
    """``torch.empty`` filling float tensors with NaN, so a feature the
    kernel does not store shows, whatever memory the output reuses."""
    empty = torch.empty

    def filled(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t
    monkeypatch.setattr(torch, "empty", filled)


# the 2D encode forward's grids: the image grid's shape at a small size
# (dense coarse levels of 9 to 2048 rows, hashed fine ones) at 16 levels,
# and at 7 and 6 levels
FWD_2D_METAS = {16: dict(n_dims=2, n_levels=16, base_resolution=16,
                         per_level_scale=1.3, log2_rows=11),
                7: dict(n_dims=2, n_levels=7, base_resolution=16,
                        per_level_scale=2.0, log2_rows=11),
                6: dict(n_dims=2, n_levels=6, base_resolution=16,
                        per_level_scale=1.5, log2_rows=11)}
# (samples a tile, the most levels a warp walks): a warp a level, four
# levels a warp (the default's walk), and one thread per sample
FWD_2D_PLANS = [(32, 1), (64, 4), (128, 32)]


def _fwd_2d_positions(kind: str, meta) -> torch.Tensor:
    """The image path's inputs at a small size, none a whole number of
    tiles: a stratified batch (64 × 64 strata, as the image step's) less
    its last 5 samples, the first 3000 row-major pixel centres of a 96²
    frame (an eval chunk's order), or 4096 uniform positions with the edge
    positions (corners 0 and 1, points up to 0.1 outside the square, every
    level's lattice vertices)."""
    from ngp_tpu_torch.train.image import pixel_centres
    if kind == "stratified":
        return sample_positions("stratified", torch.Generator().manual_seed(7),
                                1 << 12, 0)[:-5].contiguous()
    if kind == "pixels":
        return pixel_centres(96, 96)[:3000].contiguous()
    rng = np.random.default_rng(7)
    pts = [rng.random((1 << 12, 2), dtype=np.float32),
           rng.random((64, 2), dtype=np.float32) * 1.2 - 0.1,
           np.zeros((1, 2), np.float32), np.ones((1, 2), np.float32)]
    for sc in meta.level_scales:
        m = rng.integers(1, int(sc) + 1, (32, 2)).astype(np.float32)
        pts.append(np.clip((m - np.float32(0.5)) / np.float32(sc), 0, 1))
    return torch.from_numpy(np.concatenate(pts).astype(np.float32))


@pytest.mark.parametrize("kind", ["stratified", "pixels", "uniform+edge"])
@pytest.mark.parametrize("n_levels", [16, 7, 6])
def test_emulated_2d_encode_forward_matches_plain(emulated, nan_outputs,
                                                  monkeypatch, n_levels,
                                                  kind):
    """The 2D K1 and K4 (one kernel, ``fwd_plan_2d``'s plan) against their
    plain versions within KERNEL_TOL, under a warp per 32 samples of a
    level, tiles of 64 with four levels a warp (the default's walk), and
    tiles of 128 with one thread a sample; every input ends in a ragged
    tile, and each launch counts once under its own launch name."""
    meta = tbg.BlockedGridMeta(**FWD_2D_METAS[n_levels])
    pos = _fwd_2d_positions(kind, meta)
    assert pos.shape[0] % 32 != 0
    rng = np.random.default_rng(n_levels)
    table = torch.from_numpy((rng.standard_normal(
        (meta.n_levels, meta.rows, 128)) * 0.5).astype(np.float32))
    tq, qs = tbg.quantize_table_i8(table)
    ref = tbg.encode_reference(table, pos, meta)
    ref8 = tbg.encode_reference_i8(tq, qs, pos, meta)
    assert float(ref8.abs().max()) > 0.1
    for samples, per_warp in FWD_2D_PLANS:
        monkeypatch.setattr(bgc, "FWD_2D_SAMPLES", samples)
        monkeypatch.setattr(bgc, "FWD_2D_LEVELS_PER_WARP", per_warp)
        k1, k4 = (_count(k, meta) for k in ("blocked_grid_encode_fwd",
                                            "blocked_grid_encode_fwd_i8"))
        got = bgc.launch_fwd(table, pos, meta)
        assert float((got - ref).abs().max()) <= KERNEL_TOL, (samples, kind)
        got = bgc.launch_fwd_i8(tq, qs, pos, meta)
        assert float((got - ref8).abs().max()) <= KERNEL_TOL, (samples, kind)
        assert _count("blocked_grid_encode_fwd", meta) == k1 + 1
        assert _count("blocked_grid_encode_fwd_i8", meta) == k4 + 1


def test_emulated_2d_encode_forward_refuses_other_plans(emulated):
    """The 2D encode forward's entry points launch only what
    ``fwd_plan_2d`` could plan: a block count that does not cover n
    samples exactly, a tile outside [32, 1024], threads that are not whole
    warps, exceed the tile's columns × levels or give its columns unequal
    warps, and a tile past the shared-memory limit are refused before any
    launch (a nonzero return); the plan itself launches (0)."""
    meta = tbg.BlockedGridMeta(**FWD_2D_METAS[16])
    table, pos, _ = _inputs(meta, 8, n=200)
    out = torch.full((pos.shape[0], 32), float("nan"))
    plan = bgc.fwd_plan_2d(pos.shape[0], meta)
    lib = emulated

    def run(blocks, threads, log2_samples):
        args, _keep = bgc._level_args(meta, pos)
        return lib.ngp_blocked_grid_encode_fwd_2d(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(), *args[:-1],
            blocks, threads, log2_samples, args[-1])
    for bad in ((plan.blocks + 1, plan.threads, plan.log2_samples),
                (plan.blocks - 1, plan.threads, plan.log2_samples),
                (-(-pos.shape[0] // 16), 512, 4),
                (-(-pos.shape[0] // 2048), 512, 11),
                (plan.blocks, 48, plan.log2_samples),
                (plan.blocks, 544, plan.log2_samples),
                (-(-pos.shape[0] // 64), 96, 6),       # 3 warps, 2 columns
                (-(-pos.shape[0] // 512), 1024, 9)):   # 264 KiB a tile
        assert run(*bad) != 0, bad
    assert bool(out.isnan().all())
    assert run(*plan.launch_args) == 0
    assert float((out - tbg.encode_reference(table, pos, meta)).abs().max()
                 ) <= KERNEL_TOL


def _check_k3(got, table, pos, cot, meta, what):
    """K3's output against the plain position backward: within
    KERNEL_POS_TOL of each component's Σ|term|, exactly 0 where every term
    is."""
    ref = tbg.encode_position_backward_reference(table, pos, cot, meta)
    mag = tbg.encode_position_backward_reference(table, pos, cot, meta,
                                                 magnitude=True)
    assert got.shape == pos.shape and bool(torch.isfinite(got).all()), what
    assert float(((got - ref).abs() / mag.clamp(min=1e-30)).max()) \
        <= KERNEL_POS_TOL, what
    assert bool((got[mag == 0] == 0).all()) and bool((mag == 0).any()), what
    assert float(mag.max()) > 0.1


# the 2D K3's plans (samples a tile, the most levels a warp walks), none
# above 128 threads at 16 levels (the emulation's cost is its host
# threads): the default, tiles of 64 with walks of 8, one thread a sample
# in tiles of 128
K3_2D_PLANS = [(32, 4), (64, 8), (128, 32)]


@pytest.mark.parametrize("kind", ["stratified", "pixels", "uniform+edge"])
@pytest.mark.parametrize("n_levels", [16, 7, 6])
def test_emulated_2d_position_backward_matches_plain(emulated, nan_outputs,
                                                     monkeypatch, n_levels,
                                                     kind):
    """The 2D K3 (one launch on ``fwd_plan_2d``'s plan, no partial sums)
    against the plain position backward under K3_2D_PLANS, on 1003 of the
    2D forward's inputs (the first of the stratified batch and of the
    pixel chunk, the last of the uniform set: its edge positions), so the
    last tile is ragged, into a NaN-filled dpos (the dynamic shared memory
    starts NaN too, so a slot read before it is written shows): within
    KERNEL_POS_TOL of Σ|term|, exactly 0 where every term is (every fifth
    sample's cotangent is zero, and some samples' first two levels), and
    the same bits under every plan, from a second launch and from a
    cotangent that is not 16-byte aligned; each launch counts once under
    ``blocked_grid_encode_bwd_pos_2d``."""
    meta = tbg.BlockedGridMeta(**FWD_2D_METAS[n_levels])
    pos = _fwd_2d_positions(kind, meta)
    pos = (pos[-1003:] if kind == "uniform+edge" else pos[:1003]).contiguous()
    n = pos.shape[0]
    rng = np.random.default_rng(100 + n_levels)
    table = torch.from_numpy((rng.standard_normal(
        (meta.n_levels, meta.rows, 128)) * 0.5).astype(np.float32))
    cot = rng.standard_normal((n, 2 * n_levels)).astype(np.float32)
    cot[::5] = 0.0
    cot[1::7, :4] = 0.0
    cot = torch.from_numpy(cot)
    # the same cotangent 4 bytes past a 16-byte boundary
    flat = torch.empty(cot.numel() + 4)
    shifted = flat[1:cot.numel() + 1].view(cot.shape).copy_(cot)
    assert shifted.data_ptr() % 16 != 0
    name = bgc.launch_name("blocked_grid_encode_bwd_pos", meta)
    assert name == "blocked_grid_encode_bwd_pos_2d"
    before = bgc.launches[name]
    runs = []
    for samples, per_warp in K3_2D_PLANS:
        monkeypatch.setattr(bgc, "FWD_2D_SAMPLES", samples)
        monkeypatch.setattr(bgc, "FWD_2D_LEVELS_PER_WARP", per_warp)
        runs.append(bgc.launch_bwd_pos(table, pos, cot, meta))
        if not runs[1:]:
            runs += [bgc.launch_bwd_pos(table, pos, c, meta)
                     for c in (cot, shifted)]
    _check_k3(runs[0], table, pos, cot, meta, kind)
    for got in runs[1:]:
        assert torch.equal(got.view(torch.int32), runs[0].view(torch.int32))
    assert bgc.launches[name] == before + len(runs) == before + 5


def test_emulated_2d_position_backward_refuses_other_plans(emulated):
    """The 2D K3's entry point launches only what ``fwd_plan_2d`` could
    plan (the refusals of the 2D encode forward's, and the 3D K3's pair
    plan of the same grid) before any launch; the plan itself launches, in
    one pass with no partial sums."""
    meta = tbg.BlockedGridMeta(**FWD_2D_METAS[16])
    table, pos, cot = _inputs(meta, 9, n=200)
    n = pos.shape[0]
    dpos = torch.full((n, 2), float("nan"))
    plan = bgc.fwd_plan_2d(n, meta)
    pair = bgc.kernel_plan("blocked_grid_encode_bwd_pos", n, meta)
    lib = emulated

    def run(blocks, threads, log2_samples):
        args, _keep = bgc._level_args(meta, pos)
        return lib.ngp_blocked_grid_encode_bwd_pos_2d(
            pos.data_ptr(), table.data_ptr(), cot.data_ptr(),
            dpos.data_ptr(), *args[:-1], blocks, threads, log2_samples,
            args[-1])
    for bad in ((plan.blocks + 1, plan.threads, plan.log2_samples),
                (plan.blocks - 1, plan.threads, plan.log2_samples),
                (-(-n // 16), 512, 4),
                (-(-n // 2048), 512, 11),
                (plan.blocks, 48, plan.log2_samples),
                (plan.blocks, 544, plan.log2_samples),
                (-(-n // 64), 96, 6),          # 3 warps, 2 columns
                (-(-n // 512), 1024, 9),       # 264 KiB a tile
                pair.launch_args):
        assert run(*bad) != 0, bad
    assert bool(dpos.isnan().all())
    assert run(*plan.launch_args) == 0
    _check_k3(dpos, table, pos, cot, meta, "the plan")
