// Blocked hash-grid encode kernels for Hopper (sm_90a), sharing one
// lookup-geometry function; one thread per (sample, level), except K3. In
// K1 and K2 neighbouring lanes take neighbouring levels of one sample:
//
//   K1 blocked_grid_encode_fwd_kernel    (L, R, 128) f32 table + (N, 3) f32
//      positions -> (N, L*2) f32 features, sample-major.
//      Replaces ngp_tpu/kernels/hashgrid_pallas.py:_fwd_kernel.
//   K2 blocked_grid_encode_bwd_kernel    (N, 3) positions + (N, L*2) f32
//      cotangent -> dTable (L, R, 128) f32 (zeroed by the caller).
//      Replaces hashgrid_pallas.py:_bwd_table_kernel.
//   K3 blocked_grid_encode_bwd_pos_kernel f32 table + positions + cotangent
//      -> dpos (N, 3) f32; one thread per sample, looping over the levels.
//      Replaces hashgrid_pallas.py:_bwd_frac_kernel and the einsum that
//      chains its dfrac to dpos.
//   K4 blocked_grid_encode_fwd_i8_kernel (L, R, 128) int8 table + (L,) f32
//      per-level scales + positions -> (N, L*2) f32 features.
//      Replaces hashgrid_pallas.py:_fwd_kernel_i8.
//   K5 blocked_grid_encode_bwd_i8{_max,}_kernel positions + cotangent ->
//      dTable with the products w*g quantised to int8 per (level, sample
//      tile): pass 1 takes each tile's max |w*g|, pass 2 is K2's scatter
//      of scale*q. Replaces hashgrid_pallas.py:_bwd_table_kernel_i8.
//
// The TPU kernels bring each sample's table row to the sample with a
// one-hot matmul, because the TPU has no fast gather, and keep the lookup
// geometry (row, base lane, fractions) computed by XLA as residuals
// between forward and backward. Hopper has a fast gather, so here each
// thread computes the lookup_geometry of ngp_tpu/kernels/blocked_grid.py
// itself and touches the 8 corners directly: a corner's two features sit
// in adjacent lanes (lane = (x + 4y + 16z) * 2 + f), so each corner is one
// 8-byte (f32) or 2-byte (int8) access, and all 8 lie in one row. The
// backward recomputes the geometry from the positions instead of storing
// it (the JAX package keeps ~80 MB of residuals per training batch).
//
// What bounds them on this card:
//  - K1, K4: random reads scattered inside table rows (64 MiB f32 or
//    16 MiB int8 at the full NeRF width: 16 levels x 8192 rows), bound by
//    the sectors gathered from L2, not by arithmetic. K4 reads a quarter of
//    K1's bytes per corner. K1 groups levels so its output leaves in whole
//    sectors (its note below); K4 keeps the first design, one level per
//    block row.
//  - K2: f32 vector reductions into L2. Coarse dense levels have few rows,
//    so many samples add into the same addresses and serialise there; K2
//    sums equal addresses inside the warp first (its note below). The sum
//    order, and so the last bits, vary between runs.
//  - K3: the same scattered corner reads as K1 (the f32 table, even in the
//    int8 modes, as the JAX package's int8 backward reuses the f32 K3),
//    plus the cotangent; it writes only 12 bytes per sample.
//  - K5: K2's atomics, minus those of zero quanta, after a first pass
//    that reads the positions and cotangent once more. The TPU sums the
//    quanta of a tile exactly in int32 before scaling; here each scale*q
//    is added in f32, so entries differ from that sum by f32 rounding of
//    the order (the checks are relative to sum_t scale_t * sum|q|).
//
// Numerics: x = pos * scale + 0.5 is rounded twice (__fmul_rn, __fadd_rn),
// like the separate multiply and add of the reference; a fused multiply-add
// rounds once and flips floor() for positions on lattice vertices. Unlike
// the TPU kernels, K1 reads the table in f32 (no bf16 rounding), K2 sums in
// f32 (the Pallas K2 rounds dA to bf16), and K4 multiplies each int8 corner
// value by its level's scale before the trilinear weights, as the Pallas K4
// does after its exact int8 selection.
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxLevels = 32;
constexpr int kDims = 3;
constexpr int kSide = 4;     // vertices per block side (4^3 * 2 = 128 lanes)
constexpr int kStride = 3;   // blocks overlap with a stride of 3 cells
constexpr int kCorners = 1 << kDims;

// Levels per thread group of K1 and K2: a group's threads cover one
// sample's levels side by side (see the plan in
// ngp_tpu_torch/kernels/blocked_grid_cuda.py, launch_plan). Where a group
// does not divide the level count, the plan narrows it to the largest
// power of two that does. 4 was the fastest of 4, 8 and 16 for both
// kernels on uniform and on ray-ordered positions on an H100
// (scripts/encode_group_sweep.py; PERF.md).
constexpr int kGroupFwd = 4;
constexpr int kGroupBwd = 4;

struct LevelParams {
  float scale[kMaxLevels];
  int blocks_per_dim[kMaxLevels];
  unsigned char is_dense[kMaxLevels];
};

// One level's parameters, as the lookup geometry takes them
struct Level {
  float scale;
  int blocks_per_dim;
  int is_dense;
};

__device__ __forceinline__ Level level_of(const LevelParams& lp, int l) {
  return {lp.scale[l], lp.blocks_per_dim[l], lp.is_dense[l]};
}

// K1 and K2 give neighbouring lanes neighbouring levels, so a warp indexes
// the levels with a lane-varying index: from the parameter space that is
// served one address at a time. The group's levels are staged in shared
// memory once per block instead. A block covers `width` levels
// blockIdx.y * width + [0, width).
__device__ __forceinline__ void stage_group_levels(Level* s, const LevelParams& lp,
                                                   int width) {
  const int t = threadIdx.x;
  if (t < width) s[t] = level_of(lp, (int)blockIdx.y * width + t);
  __syncthreads();
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// 3D Morton bit spread (10 bits per axis), the legacy row hash
__device__ __forceinline__ uint32_t part_bits(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// The lookup geometry of sample i at level l: the row within the level's
// table, the lane of the base corner's feature 0, and the fractions.
struct Lookup {
  uint32_t row;
  int base_lane;
  float frac[kDims];
};

__device__ __forceinline__ Lookup lookup_geometry(
    const float* __restrict__ pos, int i, const Level& lv, int log2_rows,
    int morton_hash) {
  const uint32_t primes[kDims] = {1u, 2654435761u, 805459861u};
  const float scale = lv.scale;
  const int nblk = lv.blocks_per_dim;
  Lookup g;
  int block[kDims], local[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    const float x = __fadd_rn(__fmul_rn(pos[(size_t)i * kDims + d], scale), 0.5f);
    const float x0 = floorf(x);
    g.frac[d] = __fsub_rn(x, x0);
    const int base = (int)x0;
    const int b = floor_div(base, kStride);
    local[d] = base - b * kStride;          // taken before the clip below
    block[d] = min(max(b, 0), nblk - 1);
  }
  if (lv.is_dense) {
    int r = 0, acc = 1;
#pragma unroll
    for (int d = 0; d < kDims; ++d) { r += block[d] * acc; acc *= nblk; }
    g.row = (uint32_t)r;
  } else {
    uint32_t h = 0;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      h ^= morton_hash ? (part_bits((uint32_t)block[d]) << d)
                       : (uint32_t)block[d] * primes[d];
    }
    g.row = h & ((1u << log2_rows) - 1u);
  }
  int lane = 0, lane_stride = 1;
#pragma unroll
  for (int d = 0; d < kDims; ++d) { lane += local[d] * lane_stride; lane_stride *= kSide; }
  g.base_lane = lane * 2;
  return g;
}

// Corner c's lane offset from the base lane, and its trilinear weight.
__device__ __forceinline__ int corner_offset(int c) {
  return 2 * ((c & 1) + ((c >> 1) & 1) * kSide + ((c >> 2) & 1) * kSide * kSide);
}

__device__ __forceinline__ float corner_weight(const Lookup& g, int c) {
  float w = 1.f;
#pragma unroll
  for (int d = 0; d < kDims; ++d) w *= ((c >> d) & 1) ? g.frac[d] : 1.f - g.frac[d];
  return w;
}

// The (sample, level) pair of a thread of K1 or K2: pair p covers sample
// p >> log2_group and level blockIdx.y * width + (p & (width - 1)), so a
// group of `width` neighbouring lanes holds one sample's levels.
struct Pair {
  int i;   // sample
  int j;   // level within the block's group
  int l;   // level
};

__device__ __forceinline__ Pair pair_of_thread(int log2_group) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int j = (int)(p & ((1 << log2_group) - 1));
  return {(int)(p >> log2_group), j, (int)(blockIdx.y << log2_group) + j};
}

// K1. A group of lanes covers one sample's levels side by side, so each
// group stores 8 * width contiguous, aligned bytes (whole 32 B sectors
// for width >= 4) and reads its position at one address (a broadcast).
// One level per block row instead stores 8 B per lane at a stride of
// 8 * L bytes: each output sector is then finished by several level
// passes thousands of blocks apart, and at 2^20 samples the 134 MB
// output leaves the 50 MB L2 between them. The table slice in flight
// grows with the group (4 MiB per level at the NeRF width), which is why
// kGroupFwd is 4 and not 16: 16 levels are 64 MiB, more than L2. What
// bounds K1 is the random corner gathers: 4 sectors per lookup from L2,
// and the L1 wavefronts of the gathers, which the 16-byte paired loads
// below cut by about a third.
__global__ void blocked_grid_encode_fwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    float* __restrict__ out, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash, int log2_group) {
  __shared__ Level levels[kGroupFwd];
  stage_group_levels(levels, lp, 1 << log2_group);
  const Pair q = pair_of_thread(log2_group);
  if (q.i >= n) return;
  const Lookup g = lookup_geometry(pos, q.i, levels[q.j], log2_rows, morton_hash);
  const float* rowp = table + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
  // corners c and c + 1 (x and x + 1 at one y, z) are 4 adjacent floats,
  // 16-byte aligned where x is even: one load instead of two there
  const bool paired = (g.base_lane & 2) == 0;
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < kCorners; c += 2) {
    const float* p = rowp + corner_offset(c);
    float4 v;
    if (paired) {
      v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
      v = make_float4(a.x, a.y, b.x, b.y);
    }
    const float w0 = corner_weight(g, c), w1 = corner_weight(g, c + 1);
    f0 += v.x * w0;
    f1 += v.y * w0;
    f0 += v.z * w1;
    f1 += v.w * w1;
  }
  reinterpret_cast<float2*>(out)[(size_t)q.i * n_levels + q.l] = make_float2(f0, f1);
}

__global__ void blocked_grid_encode_fwd_i8_kernel(
    const float* __restrict__ pos, const int8_t* __restrict__ table,
    const float* __restrict__ qscale, float* __restrict__ out,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const Lookup g = lookup_geometry(pos, i, level_of(lp, l), log2_rows, morton_hash);
  const int8_t* rowp = table + (((size_t)l << log2_rows) + g.row) * kLanes + g.base_lane;
  const float s = __ldg(qscale + l);
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float w = corner_weight(g, c);
    const char2 q = __ldg(reinterpret_cast<const char2*>(rowp + corner_offset(c)));
    f0 += __fmul_rn((float)q.x, s) * w;
    f1 += __fmul_rn((float)q.y, s) * w;
  }
  reinterpret_cast<float2*>(out + (size_t)i * n_levels * 2)[l] = make_float2(f0, f1);
}

// A denormal flushed to zero, as the reductions into L2 flush what they
// add and what they leave (.FTZ). K2's warp sums flush each product and
// each partial sum so that they add what one reduction per lane would:
// the cotangents of a trained scene reach the denormal range, and an
// entry that only denormal products reach must stay exactly 0, as it
// does in the plain version on the card (scatter_add_, by the same
// reductions).
__device__ __forceinline__ float flush(float x) { return fabsf(x) < FLT_MIN ? 0.f : x; }

// K2. K1's mapping: each group's cotangent is read as whole sectors and
// each position once per group. A corner's two features, adjacent and
// 8-byte aligned, go to L2 as one vector reduction (atomicAdd on float2,
// global memory, compute capability 9.x): 8 reductions per lookup, not
// 16. Those reductions bound K2, most where many of them hit one entry:
// the dense coarse levels (216 rows at level 0 of the NeRF grid) under
// the render path's ray-ordered samples, whose neighbours share cells.
// Lanes of a warp that share a cell are summed in the warp first, so one
// reduction goes out per cell; a group of 4 levels puts 8 samples of a
// ray in each warp.
__global__ void blocked_grid_encode_bwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    float* __restrict__ dtable, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash, int log2_group) {
  __shared__ Level levels[kGroupBwd];
  stage_group_levels(levels, lp, 1 << log2_group);
  const Pair q = pair_of_thread(log2_group);
  // every lane runs to the end: the warp's lanes vote together below
  float2 gv = make_float2(0.f, 0.f);
  if (q.i < n) gv = __ldg(reinterpret_cast<const float2*>(grad) + (size_t)q.i * n_levels + q.l);
  // a zero cotangent adds only zeros: skipping it leaves dTable unchanged
  const bool live = gv.x != 0.f || gv.y != 0.f;
  Lookup g = {};
  float* rowp = nullptr;
  if (live) {
    g = lookup_geometry(pos, q.i, levels[q.j], log2_rows, morton_hash);
    rowp = dtable + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
  }
  // Lanes with the same row and base corner add into the same 8 entries
  // (neighbouring samples of a ray in one coarse cell): the lowest of them
  // sums its peers' products, fetched by shuffles, and adds alone. A lane
  // that adds nothing keys on its own lane id, no address, and has no peer.
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(
      full, live ? reinterpret_cast<unsigned long long>(rowp) : (unsigned long long)lane);
  float2 sum[kCorners];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float w = corner_weight(g, c);
    sum[c] = make_float2(flush(__fmul_rn(w, gv.x)), flush(__fmul_rn(w, gv.y)));
  }
  const int rounds = __reduce_max_sync(full, __popc(peers)) - 1;
  unsigned rest = peers & (peers - 1);          // the peers after the lowest
  for (int r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
    Lookup h;
#pragma unroll
    for (int d = 0; d < kDims; ++d) h.frac[d] = __shfl_sync(full, g.frac[d], src);
    const float2 hv = make_float2(__shfl_sync(full, gv.x, src), __shfl_sync(full, gv.y, src));
    if (src != lane) {
#pragma unroll
      for (int c = 0; c < kCorners; ++c) {
        const float w = corner_weight(h, c);
        sum[c].x = flush(sum[c].x + flush(__fmul_rn(w, hv.x)));
        sum[c].y = flush(sum[c].y + flush(__fmul_rn(w, hv.y)));
      }
    }
  }
  if (!live || lane != __ffs(peers) - 1) return;
#pragma unroll
  for (int c = 0; c < kCorners; ++c)
    atomicAdd(reinterpret_cast<float2*>(rowp + corner_offset(c)), sum[c]);
}

// K3: one thread per sample, looping over the levels in order, so dpos is
// summed as the reference's einsum over levels: no atomics, deterministic.
__global__ void blocked_grid_encode_bwd_pos_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    const float* __restrict__ grad, float* __restrict__ dpos,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[kDims] = {0.f, 0.f, 0.f};
  for (int l = 0; l < n_levels; ++l) {
    const float2 gv = __ldg(reinterpret_cast<const float2*>(grad + (size_t)i * n_levels * 2) + l);
    if (gv.x == 0.f && gv.y == 0.f) continue;   // adds only zeros
    const Lookup g = lookup_geometry(pos, i, level_of(lp, l), log2_rows, morton_hash);
    const float* rowp = table + (((size_t)l << log2_rows) + g.row) * kLanes + g.base_lane;
    float dfrac[kDims] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(rowp + corner_offset(c)));
      // d/dw of the output at this corner, summed over the two features
      const float gg = v.x * gv.x + v.y * gv.y;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        float prod = 1.f;
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) {
          if (dd != d) prod *= ((c >> dd) & 1) ? g.frac[dd] : 1.f - g.frac[dd];
        }
        dfrac[d] += ((c >> d) & 1) ? gg * prod : -(gg * prod);
      }
    }
    const float s = lp.scale[l];
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[d] += dfrac[d] * s;
  }
#pragma unroll
  for (int d = 0; d < kDims; ++d) dpos[(size_t)i * kDims + d] = acc[d];
}

// K5, pass 1: the largest |w*g| of each (level, sample tile) into
// tile_max[l * n_tiles + t], as float bits. For non-negative floats the
// bit patterns order as the values, so an unsigned atomicMax is exact and
// order-free. A warp lies inside one tile (tiles are powers of two of at
// least 32 samples), so it reduces first and adds one atomic.
__global__ void blocked_grid_encode_bwd_i8_max_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    unsigned int* __restrict__ tile_max, const LevelParams lp, int n,
    int n_levels, int log2_rows, int morton_hash, int log2_tile,
    int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  float m = 0.f;
  if (i < n) {
    const float2 gv = __ldg(reinterpret_cast<const float2*>(grad + (size_t)i * n_levels * 2) + l);
    if (gv.x != 0.f || gv.y != 0.f) {
      const Lookup g = lookup_geometry(pos, i, level_of(lp, l), log2_rows, morton_hash);
#pragma unroll
      for (int c = 0; c < kCorners; ++c) {
        const float w = corner_weight(g, c);
        m = fmaxf(m, fmaxf(fabsf(__fmul_rn(w, gv.x)), fabsf(__fmul_rn(w, gv.y))));
      }
    }
  }
  const unsigned int bits = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if ((threadIdx.x & 31) == 0 && bits != 0u && i < n)
    atomicMax(tile_max + (size_t)l * n_tiles + (i >> log2_tile), bits);
}

// K5, pass 2: K2's scatter, adding scale * q with the tile's scale
// max(tile_max, 1e-20) / 127 and q = clip(rint((w*g) / scale), +-127).
// A zero q adds nothing, so entries whose every q is 0 stay exactly 0.
__global__ void blocked_grid_encode_bwd_i8_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    const unsigned int* __restrict__ tile_max, float* __restrict__ dtable,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_tile, int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const float2 gv = __ldg(reinterpret_cast<const float2*>(grad + (size_t)i * n_levels * 2) + l);
  if (gv.x == 0.f && gv.y == 0.f) return;
  const float tmax = __uint_as_float(__ldg(tile_max + (size_t)l * n_tiles + (i >> log2_tile)));
  const float scale = __fdiv_rn(fmaxf(tmax, 1e-20f), 127.f);
  const Lookup g = lookup_geometry(pos, i, level_of(lp, l), log2_rows, morton_hash);
  float* rowp = dtable + (((size_t)l << log2_rows) + g.row) * kLanes + g.base_lane;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float w = corner_weight(g, c);
    float* p = rowp + corner_offset(c);
    const float q0 = fminf(fmaxf(rintf(__fdiv_rn(__fmul_rn(w, gv.x), scale)), -127.f), 127.f);
    const float q1 = fminf(fmaxf(rintf(__fdiv_rn(__fmul_rn(w, gv.y), scale)), -127.f), 127.f);
    if (q0 != 0.f) atomicAdd(p, __fmul_rn(q0, scale));
    if (q1 != 0.f) atomicAdd(p + 1, __fmul_rn(q1, scale));
  }
}

int fill_levels(LevelParams* lp, const float* scales,
                const int* blocks_per_dim, const unsigned char* is_dense,
                int n, int n_levels, int log2_rows) {
  if (n_levels < 1 || n_levels > kMaxLevels || n < 1 || log2_rows < 0 ||
      log2_rows > 24)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l) {
    lp->scale[l] = scales[l];
    lp->blocks_per_dim[l] = blocks_per_dim[l];
    lp->is_dense[l] = is_dense[l];
  }
  return 0;
}

constexpr int kThreads = 256;

dim3 grid_for(int n, int n_levels) {
  return dim3((n + kThreads - 1) / kThreads, n_levels);
}

// Checks a pair launch of K1 or K2 (kernels/blocked_grid_cuda.py,
// launch_plan): groups of the largest power of two dividing both `group`
// and n_levels, `threads` per block (whole warps), and exactly the
// `blocks` per group that cover n samples.
int check_plan(int n, int n_levels, int group, int blocks, int threads,
               int log2_group) {
  const int width = std::min(group, n_levels & -n_levels);
  if (log2_group < 0 || log2_group > 5 || (1 << log2_group) != width ||
      threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (long long)blocks != (((long long)n << log2_group) + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K1's and K2's level groups, so the wrapper can plan their launches.
extern "C" int ngp_blocked_grid_group(int backward) {
  return backward ? kGroupBwd : kGroupFwd;
}

// Each entry point launches on `stream` (a cudaStream_t passed as a
// pointer) and returns the cudaError_t of the launch; 0 on success.
// Per-level arrays are host memory, n_levels entries each; they travel in
// the kernel's parameters. Tensors are device memory, contiguous. K1 and
// K2 take the wrapper's launch plan (blocks and threads per level group,
// log2 of the group's width).
extern "C" int ngp_blocked_grid_encode_fwd(
    const float* pos, const float* table, float* out,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, int blocks, int threads, int log2_group, void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                       log2_rows);
  if (rc == 0) rc = check_plan(n, n_levels, kGroupFwd, blocks, threads, log2_group);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_kernel<<<dim3(blocks, n_levels >> log2_group), threads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      pos, table, out, lp, n, n_levels, log2_rows, morton_hash, log2_group);
  return (int)cudaGetLastError();
}

extern "C" int ngp_blocked_grid_encode_fwd_i8(
    const float* pos, const int8_t* table, const float* qscale, float* out,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, void* stream) {
  LevelParams lp = {};
  const int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n,
                             n_levels, log2_rows);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_i8_kernel<<<grid_for(n, n_levels), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      pos, table, qscale, out, lp, n, n_levels, log2_rows, morton_hash);
  return (int)cudaGetLastError();
}

// dtable must be zeroed by the caller; the kernel only adds into it.
extern "C" int ngp_blocked_grid_encode_bwd(
    const float* pos, const float* grad, float* dtable,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, int blocks, int threads, int log2_group, void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                       log2_rows);
  if (rc == 0) rc = check_plan(n, n_levels, kGroupBwd, blocks, threads, log2_group);
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_kernel<<<dim3(blocks, n_levels >> log2_group), threads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      pos, grad, dtable, lp, n, n_levels, log2_rows, morton_hash, log2_group);
  return (int)cudaGetLastError();
}

// K3: dpos (N, 3) is written in full; no zeroing needed.
extern "C" int ngp_blocked_grid_encode_bwd_pos(
    const float* pos, const float* table, const float* grad, float* dpos,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, void* stream) {
  LevelParams lp = {};
  const int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n,
                             n_levels, log2_rows);
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_pos_kernel<<<(n + kThreads - 1) / kThreads,
                                       kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      pos, table, grad, dpos, lp, n, n_levels, log2_rows, morton_hash);
  return (int)cudaGetLastError();
}

// K5, both passes on one stream. tile_max (L * ceil(n / 2^log2_tile)
// uint32) and dtable must be zeroed by the caller.
extern "C" int ngp_blocked_grid_encode_bwd_i8(
    const float* pos, const float* grad, unsigned int* tile_max,
    float* dtable, const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_tile, void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                       log2_rows);
  if (rc != 0) return rc;
  if (log2_tile < 5 || log2_tile > 30) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)n + (1LL << log2_tile) - 1) >> log2_tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  blocked_grid_encode_bwd_i8_max_kernel<<<grid_for(n, n_levels), kThreads, 0, s>>>(
      pos, grad, tile_max, lp, n, n_levels, log2_rows, morton_hash, log2_tile,
      n_tiles);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_i8_kernel<<<grid_for(n, n_levels), kThreads, 0, s>>>(
      pos, grad, tile_max, dtable, lp, n, n_levels, log2_rows, morton_hash,
      log2_tile, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* ngp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
