// Blocked hash-grid encode, forward: (L, R, 128) f32 table + (N, 3) f32
// positions -> (N, L*2) f32 features, sample-major.
//
// Replaces the TPU kernel ngp_tpu/kernels/hashgrid_pallas.py:_fwd_kernel
// (launched by _encode_fwd_impl). That kernel brings each sample's table
// row to the sample with a bf16 one-hot matmul, because the TPU has no fast
// gather; and the lookup geometry (row, base lane, fractions) is computed
// by XLA and stored between steps. Hopper has a fast gather, so here one
// thread per (sample, level) computes the whole lookup_geometry of
// ngp_tpu/kernels/blocked_grid.py itself and reads the 8 corners directly
// from the f32 table: a corner's two features sit in adjacent lanes
// (lane = (x + 4y + 16z) * 2 + f), so each corner is one 8-byte load, and
// all 8 lie in one 512-byte row. Unlike the TPU kernel, the table is read
// in f32, not rounded to bf16.
//
// What bounds it on this card: random 64-byte reads scattered inside
// 512-byte rows of the table (64 MiB at the full NeRF width: 16 levels x
// 8192 rows). The coarse levels stay in the 50 MB L2; the fine, hashed
// levels do not, so the kernel is bound by device-memory sectors fetched,
// not by arithmetic. This first version keeps the layout simple (level on
// blockIdx.y, samples on x) and does nothing yet to raise locality.
//
// Numerics: x = pos * scale + 0.5 is rounded twice (__fmul_rn, __fadd_rn),
// like the separate multiply and add of the reference; a fused multiply-add
// rounds once and flips floor() for positions on lattice vertices.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxLevels = 32;

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

// One thread per (sample, level); 3D: a row holds 4x4x4 vertices x 2
// features, blocks overlap with a stride of 3 cells.
__global__ void blocked_grid_encode_fwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    float* __restrict__ out, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash) {
  constexpr int D = 3;
  constexpr int kSide = 4;
  constexpr int kStride = 3;
  constexpr int kCorners = 1 << D;
  const uint32_t primes[3] = {1u, 2654435761u, 805459861u};

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;

  const float scale = lp.scale[l];
  const int nblk = lp.blocks_per_dim[l];
  int block[D], local[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = __fadd_rn(__fmul_rn(pos[(size_t)i * D + d], scale), 0.5f);
    const float x0 = floorf(x);
    frac[d] = __fsub_rn(x, x0);
    const int base = (int)x0;
    const int b = floor_div(base, kStride);
    local[d] = base - b * kStride;          // taken before the clip below
    block[d] = min(max(b, 0), nblk - 1);
  }

  uint32_t row;
  const uint32_t rows = 1u << log2_rows;
  if (lp.is_dense[l]) {
    int r = 0, acc = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) { r += block[d] * acc; acc *= nblk; }
    row = (uint32_t)r;
  } else {
    uint32_t h = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      h ^= morton_hash ? (part_bits((uint32_t)block[d]) << d)
                       : (uint32_t)block[d] * primes[d];
    }
    row = h & (rows - 1u);
  }

  const float* rowp = table + ((size_t)l * rows + row) * kLanes;
  int base_lane = 0, lane_stride = 1;
#pragma unroll
  for (int d = 0; d < D; ++d) { base_lane += local[d] * lane_stride; lane_stride *= kSide; }
  base_lane *= 2;

  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    int off = 0, s = 1;
    float w = 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (c >> d) & 1;
      off += bit * s;
      s *= kSide;
      w *= bit ? frac[d] : 1.f - frac[d];
    }
    const float2 v = __ldg(reinterpret_cast<const float2*>(rowp + base_lane + 2 * off));
    f0 += v.x * w;
    f1 += v.y * w;
  }
  reinterpret_cast<float2*>(out + (size_t)i * n_levels * 2)[l] = make_float2(f0, f1);
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns the
// cudaError_t of the launch; 0 on success. Per-level arrays are host
// memory, n_levels entries each; they travel in the kernel's parameters.
extern "C" int ngp_blocked_grid_encode_fwd(
    const float* pos, const float* table, float* out,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n < 1 || log2_rows < 0 ||
      log2_rows > 24)
    return (int)cudaErrorInvalidValue;
  LevelParams lp = {};
  for (int l = 0; l < n_levels; ++l) {
    lp.scale[l] = scales[l];
    lp.blocks_per_dim[l] = blocks_per_dim[l];
    lp.is_dense[l] = is_dense[l];
  }
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blocked_grid_encode_fwd_kernel<<<grid, threads, 0, s>>>(
      pos, table, out, lp, n, n_levels, log2_rows, morton_hash);
  return (int)cudaGetLastError();
}

extern "C" const char* ngp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
