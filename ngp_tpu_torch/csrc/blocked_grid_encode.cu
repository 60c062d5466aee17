// Blocked hash-grid encode kernels for Hopper (sm_90a), sharing one
// lookup-geometry function; one thread per (sample, level), except K3:
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
//    16 MiB int8 at the full NeRF width: 16 levels x 8192 rows). The coarse
//    levels stay in the 50 MB L2; the fine, hashed levels do not, so the
//    forward is bound by sectors fetched, not by arithmetic. K4 reads a
//    quarter of K1's bytes per corner.
//  - K2: f32 atomics into L2. Coarse dense levels have few rows, so many
//    samples add into the same addresses and serialise there. This first
//    version adds scalar atomics per lane and does nothing yet against the
//    contention; the sum order, and so the last bits, vary between runs.
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxLevels = 32;
constexpr int kDims = 3;
constexpr int kSide = 4;     // vertices per block side (4^3 * 2 = 128 lanes)
constexpr int kStride = 3;   // blocks overlap with a stride of 3 cells
constexpr int kCorners = 1 << kDims;

struct LevelParams {
  float scale[kMaxLevels];
  int blocks_per_dim[kMaxLevels];
  unsigned char is_dense[kMaxLevels];
};

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
    const float* __restrict__ pos, int i, int l, const LevelParams& lp,
    int log2_rows, int morton_hash) {
  const uint32_t primes[kDims] = {1u, 2654435761u, 805459861u};
  const float scale = lp.scale[l];
  const int nblk = lp.blocks_per_dim[l];
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
  if (lp.is_dense[l]) {
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

__global__ void blocked_grid_encode_fwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    float* __restrict__ out, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
  const float* rowp = table + (((size_t)l << log2_rows) + g.row) * kLanes + g.base_lane;
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float w = corner_weight(g, c);
    const float2 v = __ldg(reinterpret_cast<const float2*>(rowp + corner_offset(c)));
    f0 += v.x * w;
    f1 += v.y * w;
  }
  reinterpret_cast<float2*>(out + (size_t)i * n_levels * 2)[l] = make_float2(f0, f1);
}

__global__ void blocked_grid_encode_fwd_i8_kernel(
    const float* __restrict__ pos, const int8_t* __restrict__ table,
    const float* __restrict__ qscale, float* __restrict__ out,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
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

__global__ void blocked_grid_encode_bwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    float* __restrict__ dtable, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const float2 gv = __ldg(reinterpret_cast<const float2*>(grad + (size_t)i * n_levels * 2) + l);
  // a zero cotangent adds only zeros: skipping it leaves dTable unchanged
  if (gv.x == 0.f && gv.y == 0.f) return;
  const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
  float* rowp = dtable + (((size_t)l << log2_rows) + g.row) * kLanes + g.base_lane;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float w = corner_weight(g, c);
    float* p = rowp + corner_offset(c);
    atomicAdd(p, __fmul_rn(w, gv.x));
    atomicAdd(p + 1, __fmul_rn(w, gv.y));
  }
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
    const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
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
      const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
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
  const Lookup g = lookup_geometry(pos, i, l, lp, log2_rows, morton_hash);
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

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t passed as a
// pointer) and returns the cudaError_t of the launch; 0 on success.
// Per-level arrays are host memory, n_levels entries each; they travel in
// the kernel's parameters. Tensors are device memory, contiguous.
extern "C" int ngp_blocked_grid_encode_fwd(
    const float* pos, const float* table, float* out,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, void* stream) {
  LevelParams lp = {};
  const int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n,
                             n_levels, log2_rows);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_kernel<<<grid_for(n, n_levels), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      pos, table, out, lp, n, n_levels, log2_rows, morton_hash);
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
    int morton_hash, void* stream) {
  LevelParams lp = {};
  const int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n,
                             n_levels, log2_rows);
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_kernel<<<grid_for(n, n_levels), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      pos, grad, dtable, lp, n, n_levels, log2_rows, morton_hash);
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
