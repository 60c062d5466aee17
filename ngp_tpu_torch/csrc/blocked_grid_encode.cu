// Blocked hash-grid encode kernels for Hopper (sm_90a), sharing one
// lookup-geometry function; one thread per (sample, level), neighbouring
// lanes on neighbouring levels of one sample, except on 2D grids (below):
//
//   K1 blocked_grid_encode_fwd_kernel<3> (L, R, 128) f32 table + (N, 3) f32
//      positions -> (N, L*2) f32 features, sample-major (NeRF, SDF); on 2D
//      grids (the neural image) blocked_grid_encode_fwd_2d_kernel<false>,
//      one block per tile of samples x all levels, lanes on neighbouring
//      samples of one level.
//      Replaces ngp_tpu/kernels/hashgrid_pallas.py:_fwd_kernel.
//   K2 blocked_grid_encode_bwd_kernel<3> (N, 3) positions + (N, L*2) f32
//      cotangent -> dTable (L, R, 128) f32 (zeroed by the caller); on 2D
//      grids blocked_grid_encode_bwd_2d_kernel<false>, one block per
//      (level, chunk of samples). Replaces
//      hashgrid_pallas.py:_bwd_table_kernel.
// K3, K4 and K5 take 2D grids too (the neural image runs them: its int8
// modes and its uv gradient).
//   K3 blocked_grid_encode_bwd_pos_kernel<3> f32 table + positions +
//      cotangent -> dpos (N, 3) f32, summed across levels by shuffles
//      and, between level groups, by a second pass, in a fixed order (no
//      atomics); on 2D grids blocked_grid_encode_bwd_pos_2d_kernel, K1's 2D
//      mapping, the levels summed in level order in shared memory.
//      Replaces hashgrid_pallas.py:_bwd_frac_kernel and the einsum that
//      chains its dfrac to dpos.
//   K4 blocked_grid_encode_fwd_i8_kernel<3> (L, R, 128) int8 table + (L,)
//      f32 per-level scales + positions -> (N, L*2) f32 features; on 2D
//      grids blocked_grid_encode_fwd_2d_kernel<true>, K1's 2D mapping.
//      Replaces hashgrid_pallas.py:_fwd_kernel_i8.
//   K5 blocked_grid_encode_bwd_i8{_max,}_kernel<3> positions + cotangent ->
//      dTable with the products w*g quantised to int8 per (level, sample
//      tile): pass 1 takes each tile's max |w*g|, pass 2 is K2's scatter
//      of scale*q; on 2D grids blocked_grid_encode_bwd_2d_kernel<true>,
//      one block per (level, tile) in one pass. Replaces
//      hashgrid_pallas.py:_bwd_table_kernel_i8.
//
// The TPU kernels bring each sample's table row to the sample with a
// one-hot matmul, because the TPU has no fast gather, and keep the lookup
// geometry (row, base lane, fractions) computed by XLA as residuals
// between forward and backward. Hopper has a fast gather, so here each
// thread computes the lookup_geometry of ngp_tpu/kernels/blocked_grid.py
// itself and touches the 2^D corners directly: a corner's two features sit
// in adjacent lanes (lane = (x + 4y + 16z) * 2 + f in 3D, (x + 8y) * 2 + f
// in 2D), so each corner is one 8-byte (f32) or 2-byte (int8) access, and
// all of them lie in one row. The
// backward recomputes the geometry from the positions instead of storing
// it (the JAX package keeps ~80 MB of residuals per training batch).
//
// What bounds them on this card:
//  - K1, K4: random reads scattered inside table rows (64 MiB f32 or
//    16 MiB int8 at the full NeRF width: 16 levels x 8192 rows), bound by
//    the sectors gathered from L2, not by arithmetic. Both group levels so
//    the output leaves in whole sectors (K1's note below). K4 reads a
//    quarter of K1's bytes per corner: a lookup's 8 corners lie in 2
//    sectors of its row and come in 2-4 aligned line loads; the whole
//    int8 table fits in L2, so its group is set by the sweep alone (K4's
//    note below). On 2D grids (the neural image: every level dense, 26.1
//    MB of f32 rows reachable, 6.5 MB of int8 ones, both inside L2) the
//    bytes bind neither: the gathers' L1 line lookups and each lookup's
//    instructions do, and the 2D encode forward gives each warp 32
//    neighbouring samples of one level, whose coherent positions share
//    rows (its note below).
//  - K2: f32 vector reductions into L2. Coarse dense levels have few rows,
//    so many samples add into the same addresses and serialise there; K2
//    sums equal addresses inside the warp first (its note below). The sum
//    order, and so the last bits, vary between runs. In 2D (the neural
//    image: every level dense, 9 to 21,609 reachable rows, 26.1 MB of a
//    268 MB gradient) the 2D table backward sums each level in shared
//    memory where its rows fit (its note below).
//  - K3: the same scattered corner reads as K1 (the f32 table, even in the
//    int8 modes, as the JAX package's int8 backward reuses the f32 K3),
//    plus the cotangent; it writes only 12 bytes per sample (and 12 per
//    sample and level group of partial sums, read back once; in 2D 8
//    bytes per sample and no partial sums).
//  - K5: K2's reductions, minus those whose quanta are all 0, after a
//    first pass that reads the positions and cotangent once more (but
//    computes no row). Corners x and x + 1 go as one float4 reduction
//    where aligned. Its group is 4, as K2's: the f32 gradient is 4 MiB
//    per level, so a group of 16 spreads its reductions over 64 MiB,
//    more than L2 (1.6x slower in the sweep). Lanes of a warp on the same
//    cell sum their quanta as integers, exactly, as the TPU sums a tile's
//    quanta in int32 before scaling; the sums of different warps meet in
//    f32, so entries differ from the TPU's by f32 rounding of the order
//    (the checks are relative to sum_t scale_t * sum|q|). In 2D the 2D
//    table backward sums a whole tile's quanta as int32, in one pass.
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
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxLevels = 32;

// The block of a D-dimensional grid: kSide vertices per side, overlapping
// its neighbours with a stride of kStride cells; kSide^D vertices x 2
// features fill the 128 lanes of a row.
template <int D> struct Block;
template <> struct Block<3> { static constexpr int kSide = 4, kStride = 3; };
template <> struct Block<2> { static constexpr int kSide = 8, kStride = 7; };

// Levels per thread group of each kernel: a group's threads cover one
// sample's levels side by side (see the plan in
// ngp_tpu_torch/kernels/blocked_grid_cuda.py, launch_plan). Where a group
// does not divide the level count, the plan narrows it to the largest
// power of two that does. Each is the fastest of 4, 8 and 16 on an H100
// (scripts/encode_group_sweep.py; PERF.md): 4 for K1 and K2 on uniform
// and ray-ordered positions, 16 for K4 on uniform and grid-sweep
// positions, 4 for K5 on uniform positions and a training step's, 16 for
// K3 on ray-ordered positions and a camera-optimising step's (8 was 8 %
// faster on uniform positions). 2D grids take none of them.
constexpr int kGroupFwd = 4;
constexpr int kGroupBwd = 4;
constexpr int kGroupPos = 16;
constexpr int kGroupI8 = 16;
constexpr int kGroupI8Bwd = 4;

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

// Every kernel gives neighbouring lanes neighbouring levels, so a warp
// indexes the levels with a lane-varying index: from the parameter space
// that is served one address at a time. The group's levels are staged in
// shared memory once per block instead. A block covers `width` levels
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

// Morton bit spread, the legacy row hash: 10 bits per axis in 3D, 16 in
// 2D
template <int D> __device__ __forceinline__ uint32_t part_bits(uint32_t x);

template <> __device__ __forceinline__ uint32_t part_bits<3>(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

template <> __device__ __forceinline__ uint32_t part_bits<2>(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// The lookup geometry of sample i at level l: the row within the level's
// table, the lane of the base corner's feature 0, and the fractions.
template <int D>
struct Lookup {
  uint32_t row;
  int base_lane;
  float frac[D];
};

// Sample i's coordinate along d on a level's vertex lattice
template <int D>
__device__ __forceinline__ float lattice_coord(const float* __restrict__ pos,
                                               int i, int d, float scale) {
  return __fadd_rn(__fmul_rn(pos[(size_t)i * D + d], scale), 0.5f);
}

// The fractions alone (what the corner weights need), bit-equal to
// lookup_geometry's
template <int D>
__device__ __forceinline__ Lookup<D> lookup_fractions(
    const float* __restrict__ pos, int i, float scale) {
  Lookup<D> g = {};
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = lattice_coord<D>(pos, i, d, scale);
    g.frac[d] = __fsub_rn(x, floorf(x));
  }
  return g;
}

template <int D>
__device__ __forceinline__ Lookup<D> lookup_geometry(
    const float* __restrict__ pos, int i, const Level& lv, int log2_rows,
    int morton_hash) {
  // the instant-ngp primes (identity along x); a 2D grid takes two
  const uint32_t primes[3] = {1u, 2654435761u, 805459861u};
  constexpr int kStrideD = Block<D>::kStride;
  const float scale = lv.scale;
  const int nblk = lv.blocks_per_dim;
  Lookup<D> g;
  int block[D], local[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = lattice_coord<D>(pos, i, d, scale);
    const float x0 = floorf(x);
    g.frac[d] = __fsub_rn(x, x0);
    const int base = (int)x0;
    const int b = floor_div(base, kStrideD);
    local[d] = base - b * kStrideD;         // taken before the clip below
    block[d] = min(max(b, 0), nblk - 1);
  }
  if (lv.is_dense) {
    int r = 0, acc = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) { r += block[d] * acc; acc *= nblk; }
    g.row = (uint32_t)r;
  } else {
    uint32_t h = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      h ^= morton_hash ? (part_bits<D>((uint32_t)block[d]) << d)
                       : (uint32_t)block[d] * primes[d];
    }
    g.row = h & ((1u << log2_rows) - 1u);
  }
  int lane = 0, lane_stride = 1;
#pragma unroll
  for (int d = 0; d < D; ++d) { lane += local[d] * lane_stride; lane_stride *= Block<D>::kSide; }
  g.base_lane = lane * 2;
  return g;
}

// Corner c's lane offset from the base lane (3D: 2 * (x + 4y + 16z); 2D:
// 2 * (x + 8y) for the corner's bits x, y, z), and its multilinear weight.
template <int D>
__device__ __forceinline__ int corner_offset(int c) {
  int off = 0, stride = 1;
#pragma unroll
  for (int d = 0; d < D; ++d) { off += ((c >> d) & 1) * stride; stride *= Block<D>::kSide; }
  return 2 * off;
}

template <int D>
__device__ __forceinline__ float corner_weight(const Lookup<D>& g, int c) {
  float w = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) w *= ((c >> d) & 1) ? g.frac[d] : 1.f - g.frac[d];
  return w;
}

// The (sample, level) pair of a thread: pair p covers sample
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

// The features of corners c and c + 1 (x and x + 1 at one y, z) of a
// lookup at rowp: 4 adjacent floats, 16-byte aligned where x is even
// (`paired`, base_lane & 2 == 0: the other terms of the lane are
// multiples of 4 in 2D and 3D alike), so one load there instead of two.
template <int D>
__device__ __forceinline__ float4 corner_pair(const float* __restrict__ rowp, int c,
                                              bool paired) {
  const float* p = rowp + corner_offset<D>(c);
  if (paired) return __ldg(reinterpret_cast<const float4*>(p));
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
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
// below cut by about a third. 2D grids take the 2D encode forward below:
// the neural image's table reaches only 26.1 MB of rows, inside L2, so
// the slice in flight does not bound it, and its batches are coherent.
template <int D>
__global__ void blocked_grid_encode_fwd_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    float* __restrict__ out, const LevelParams lp, int n, int n_levels,
    int log2_rows, int morton_hash, int log2_group) {
  __shared__ Level levels[kGroupFwd];
  stage_group_levels(levels, lp, 1 << log2_group);
  const Pair q = pair_of_thread(log2_group);
  if (q.i >= n) return;
  const Lookup<D> g = lookup_geometry<D>(pos, q.i, levels[q.j], log2_rows, morton_hash);
  const float* rowp = table + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
  const bool paired = (g.base_lane & 2) == 0;
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); c += 2) {
    const float4 v = corner_pair<D>(rowp, c, paired);
    const float w0 = corner_weight(g, c), w1 = corner_weight(g, c + 1);
    f0 += v.x * w0;
    f1 += v.y * w0;
    f0 += v.z * w1;
    f1 += v.w * w1;
  }
  reinterpret_cast<float2*>(out)[(size_t)q.i * n_levels + q.l] = make_float2(f0, f1);
}

// Byte k of x as a signed int8 value
__device__ __forceinline__ int sbyte(uint32_t x, int k) {
  return (int)(x << (24 - 8 * k)) >> 24;
}

// K4's int8 corners: for each line of the lookup (the 2^(D-1) corner
// pairs x, x + 1 at one (y, z)), the four bytes q0(x) q1(x) q0(x+1)
// q1(x+1) of the row at rowp, packed into one word.
//
// 3D: an int8 row is 128 bytes, one cache line: vertex (x, y, z) holds
// its two features at byte 2 * (x + 4y + 16z), so a z-plane of the block
// (16 vertices) is one 32-byte sector, and a (y, z) line of 4 vertices is
// 8 contiguous bytes, 8-aligned, at byte 8 * (y + 4z). A lookup's 8
// corners lie on the 4 lines (y or y + 1, z or z + 1), in 2 sectors: each
// line is one aligned 8-byte load, from which the x and x + 1 corners
// (bytes 2x .. 2x + 3, x <= 2) come by one byte permute. That is 4 loads
// per lookup where the first design made 8 two-byte ones; where y is
// even, lines y and y + 1 are 16-byte aligned and come in one 16-byte load
// (2 loads for 2/3 of lookups: 5-9 % faster on every input set of the
// sweep).
//
// 2D: vertex (x, y) holds its features at byte 2 * (x + 8y), so a y-line
// of 8 vertices is 16 contiguous bytes, 16-aligned, at byte 16 * y.
// Corners x and x + 1 (x <= 6) are bytes 2x .. 2x + 3, in words x / 2 and,
// for odd x, x / 2 + 1 of the line: each line comes as those two 4-byte
// loads (one word twice where x is even) and one byte permute. Loading
// the whole line in one 16-byte load and picking the two words by selects
// took 4-5 % longer on the image path (PERF.md): the selects, not the
// loads, cost there.
template <int D> struct I8Lines;

template <> struct I8Lines<3> {
  static __device__ __forceinline__ void load(const int8_t* __restrict__ rowp,
                                              int base_lane, uint32_t* v) {
    constexpr int kSide = Block<3>::kSide;
    // byte 8 * (y + 4z) of the base corner's line; its x corner at byte 2x
    const int8_t* linep = rowp + (base_lane & ~7);
    const uint32_t sel = 0x3210u + 0x2222u * (uint32_t)((base_lane & 7) >> 1);
    uint2 line[4];   // (dy, dz) = (k & 1, k >> 1)
    if ((base_lane & 8) == 0) {   // y even
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(linep));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(linep + 8 * kSide));
      line[0] = make_uint2(a.x, a.y);
      line[1] = make_uint2(a.z, a.w);
      line[2] = make_uint2(b.x, b.y);
      line[3] = make_uint2(b.z, b.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        line[k] = __ldg(reinterpret_cast<const uint2*>(linep + 8 * ((k & 1) + kSide * (k >> 1))));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __byte_perm(line[k].x, line[k].y, sel);
  }
};

template <> struct I8Lines<2> {
  static __device__ __forceinline__ void load(const int8_t* __restrict__ rowp,
                                              int base_lane, uint32_t* v) {
    // word x / 2 of the base corner's line (byte 16 * y + 2x, rounded down
    // to 4), and the word after it where x is odd
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(rowp + (base_lane & ~3));
    const int odd = (base_lane >> 1) & 1;
    const uint32_t sel = odd ? 0x5432u : 0x3210u;
#pragma unroll
    for (int k = 0; k < 2; ++k) v[k] = __byte_perm(__ldg(wp + 4 * k), __ldg(wp + 4 * k + odd), sel);
  }
};

// K4. K1's mapping and whole-sector stores; the corners come as lines
// (I8Lines above). The table is 1 MiB per level at the NeRF width, all 16
// levels 16 MiB, inside the 50 MB L2 at once: unlike K1's, K4's group is
// not held down by the table slice in flight, and the widest group (16:
// all levels of a sample in one group, each position read once) was the
// fastest. As the 16-byte loads' gain suggests, what bounds K4 now is the
// gathers' line lookups in L1 (a warp's load touches up to 32 lines), not
// bytes. On 2D grids the 2D encode forward below takes K4 too: with the
// level-fastest lanes a warp's load there spanned 16 levels of 2 samples,
// 16 or more lines.
template <int D>
__global__ void blocked_grid_encode_fwd_i8_kernel(
    const float* __restrict__ pos, const int8_t* __restrict__ table,
    const float* __restrict__ qscale, float* __restrict__ out,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_group) {
  __shared__ Level levels[kGroupI8];
  stage_group_levels(levels, lp, 1 << log2_group);
  const Pair q = pair_of_thread(log2_group);
  if (q.i >= n) return;
  const Lookup<D> g = lookup_geometry<D>(pos, q.i, levels[q.j], log2_rows, morton_hash);
  uint32_t v[1 << (D - 1)];   // corners c (x) and c + 1 (x + 1) in v[c / 2]
  I8Lines<D>::load(table + (((size_t)q.l << log2_rows) + g.row) * kLanes, g.base_lane, v);
  const float s = __ldg(qscale + q.l);
  float f0 = 0.f, f1 = 0.f;
#pragma unroll
  for (int c = 0; c < (1 << D); c += 2) {
    // bytes q0(x) q1(x) q0(x+1) q1(x+1)
    const uint32_t b = v[c >> 1];
    const float w0 = corner_weight(g, c), w1 = corner_weight(g, c + 1);
    f0 += __fmul_rn((float)sbyte(b, 0), s) * w0;
    f1 += __fmul_rn((float)sbyte(b, 1), s) * w0;
    f0 += __fmul_rn((float)sbyte(b, 2), s) * w1;
    f1 += __fmul_rn((float)sbyte(b, 3), s) * w1;
  }
  reinterpret_cast<float2*>(out)[(size_t)q.i * n_levels + q.l] = make_float2(f0, f1);
}

// K1 and K4 on 2D grids (the neural image), and the mapping of K3 there.
// Replace hashgrid_pallas.py:_fwd_kernel and _fwd_kernel_i8 for D = 2.
//
// What bounds them on this card: not bytes (the image grid,
// configs/image/base.json at a 2048^2 image, is dense at every level and
// reaches 26.1 MB of f32 rows or 6.5 MB of int8 ones, inside the 50 MB
// L2), but the gathers' L1 line lookups and, once those are few, the
// instructions of each lookup. The pair kernels above give neighbouring
// lanes neighbouring levels of one sample, so a load spans 4 (K1) or 16
// (K4) levels, each its own row. The image's batches are coherent: the
// stratified training batch puts sample k in cell (k mod 512, k div 512),
// and the eval chunks are row-major pixel centres. So here a block takes
// a tile of 2^log2_samples consecutive samples x all levels, and each
// warp one level of 32 consecutive samples at a time (lanes
// sample-fastest): its 32 lookups fall in about one row on the coarse
// levels and about 10 on the finest (32 samples of a stratified row span
// ~64 cells there, blocks of 7). The level is warp-uniform, so its
// parameters are one uniform read of the kernel's parameters (no shared
// staging). The features pass through shared memory (one pad word per
// 32, so a warp's 32 samples of one level land on 32 banks) and leave as
// float4 stores, each tile's 8 * L * 2^log2_samples contiguous bytes in
// whole 128-byte lines. A warp takes one 32-sample column of the tile
// (its lanes' positions read once) and walks its levels warp / columns,
// + warps / columns, ...; a lane past sample n - 1 looks that sample up
// again (not stored), so no lane branches. On an H100 (PERF.md): the
// sample-fastest lanes alone, one warp a level, took 10-12 % off the pair
// kernels on an image step; the plan's 4 warps a tile of 32 samples, each
// walking 4 levels, most of the rest (each position read once for 4
// lookups, a quarter of the blocks); one thread a sample had too few
// warps in flight. Issuing a walk's gathers ahead of its sums made the
// coherent inputs slower and only uniform ones faster. K1 is 30 % faster
// on a frame's pixel centres, its most coherent input, than on the
// stratified step, K4 4 %: K4 is bound by its instructions (the byte
// picks, conversions and scale products), K1 more by its gathers. Where x
// is odd, K1's corners x and x + 1 straddle a 16-byte boundary and come
// as two 8-byte loads (two aligned 16-byte loads and selects were slower
// on the pixel centres). Each lookup's arithmetic is the pair kernels':
// the same lattice coordinate, corner loads, order of sums and, for K4,
// __fmul_rn(q, scale) before the weight, so the outputs equal theirs bit
// for bit.
//
// The shared memory of a tile of 2^log2_samples samples x n_levels: 2
// floats a (sample, level) and one pad word per 32 floats
__host__ __device__ __forceinline__ int fwd_2d_smem_bytes(int log2_samples, int n_levels) {
  const int floats = (2 * n_levels) << log2_samples;
  return (floats + floats / 32) * 4;
}

// Float f of a tile's (samples, 2 * n_levels) floats in shared memory, at
// f + f / 32: a warp's 32 samples of one level land on 32 banks, and for
// even f, f + 1 is in f's 32
__device__ __forceinline__ int tile_slot(int f) { return f + (f >> 5); }

// A thread of a 2D tile mapping: the tile's first sample, the thread's
// sample s in the tile and its position, read once, and its warp's walk
// over the levels (level, level + level_step, ...). Warp w takes column
// w mod (tile / 32) of 32 consecutive samples (the plan gives each column
// the same number of warps); a lane past sample n - 1 (the last tile's)
// takes that sample's position, so that no lane branches.
struct TileLane2D {
  int first, s, level, level_step;
  float xy[2];
};

__device__ __forceinline__ TileLane2D tile_lane_2d(const float* __restrict__ pos, int n,
                                                   int log2_samples) {
  const int lane = (int)(threadIdx.x & 31), warp = (int)(threadIdx.x >> 5);
  const int log2_cols = log2_samples - 5;    // 32-sample columns per level
  TileLane2D t;
  t.first = (int)blockIdx.x << log2_samples;
  t.s = ((warp & ((1 << log2_cols) - 1)) << 5) + lane;
  const size_t i = (size_t)min(t.first + t.s, n - 1);
  t.xy[0] = __ldg(pos + 2 * i);
  t.xy[1] = __ldg(pos + 2 * i + 1);
  t.level = warp >> log2_cols;
  t.level_step = (int)(blockDim.x >> 5) >> log2_cols;
  return t;
}

// The f32 table at a 2D lookup's base corner at level l: the level's
// table, then the row's offset in it in 32 bits (rows < 2^24)
__device__ __forceinline__ const float* f32_corner_2d(const float* __restrict__ table, int l,
                                                     int log2_rows, const Lookup<2>& g) {
  return table + ((size_t)l << log2_rows) * kLanes + g.row * kLanes + g.base_lane;
}

template <bool kInt8>
__global__ void blocked_grid_encode_fwd_2d_kernel(
    const float* __restrict__ pos, const void* __restrict__ table,
    const float* __restrict__ qscale, float* __restrict__ out,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_samples) {
  extern __shared__ float tile_features[];
  const TileLane2D t = tile_lane_2d(pos, n, log2_samples);
  const int width = 2 * n_levels;            // floats a sample
  for (int l = t.level; l < n_levels; l += t.level_step) {
    const Lookup<2> g = lookup_geometry<2>(t.xy, 0, level_of(lp, l), log2_rows, morton_hash);
    float f0 = 0.f, f1 = 0.f;
    if constexpr (kInt8) {
      uint32_t v[2];   // corners c (x) and c + 1 (x + 1) in v[c / 2]
      // the level's table, then the row's offset in it in 32 bits
      const int8_t* rowp = static_cast<const int8_t*>(table)
                           + ((size_t)l << log2_rows) * kLanes + g.row * kLanes;
      I8Lines<2>::load(rowp, g.base_lane, v);
      const float sc = __ldg(qscale + l);
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        // bytes q0(x) q1(x) q0(x+1) q1(x+1)
        const uint32_t q = v[c >> 1];
        const float w0 = corner_weight(g, c), w1 = corner_weight(g, c + 1);
        f0 += __fmul_rn((float)sbyte(q, 0), sc) * w0;
        f1 += __fmul_rn((float)sbyte(q, 1), sc) * w0;
        f0 += __fmul_rn((float)sbyte(q, 2), sc) * w1;
        f1 += __fmul_rn((float)sbyte(q, 3), sc) * w1;
      }
    } else {
      const float* rowp = f32_corner_2d(static_cast<const float*>(table), l, log2_rows, g);
      const bool paired = (g.base_lane & 2) == 0;
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        const float4 v = corner_pair<2>(rowp, c, paired);
        const float w0 = corner_weight(g, c), w1 = corner_weight(g, c + 1);
        f0 += v.x * w0;
        f1 += v.y * w0;
        f0 += v.z * w1;
        f1 += v.w * w1;
      }
    }
    // one pointer for both features: tile_slot(f + 1) would be computed
    // apart (on an H100: 8 more instructions, K4 3 % slower on an image
    // step; PERF.md)
    float* slot = tile_features + tile_slot(t.s * width + 2 * l);
    slot[0] = f0;
    slot[1] = f1;
  }
  __syncthreads();
  // the tile's samples below n, 16 bytes a thread at a time (the tile
  // starts 256-byte aligned), the last 8 bytes of an odd tail alone
  const int floats = min(1 << log2_samples, n - t.first) * width;
  float* o = out + (size_t)t.first * width;
  for (int k = 4 * (int)threadIdx.x; k < floats; k += 4 * (int)blockDim.x) {
    const float* src = tile_features + tile_slot(k);
    if (k + 4 <= floats) {
      *reinterpret_cast<float4*>(o + k) = make_float4(src[0], src[1], src[2], src[3]);
    } else {
      for (int j = 0; j < floats - k; ++j) o[k + j] = src[j];
    }
  }
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
// ray in each warp. The neural image's stratified batch is coherent the
// same way, but 2D grids take the 2D table backward below instead.
template <int D>
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
  constexpr int kCornersD = 1 << D;
  Lookup<D> g = {};
  float* rowp = nullptr;
  if (live) {
    g = lookup_geometry<D>(pos, q.i, levels[q.j], log2_rows, morton_hash);
    rowp = dtable + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
  }
  // Lanes with the same row and base corner add into the same 2^D corners
  // (neighbouring samples of a ray in one coarse cell): the lowest of them
  // sums its peers' products, fetched by shuffles, and adds alone. A lane
  // that adds nothing keys on its own lane id, no address, and has no peer.
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(
      full, live ? reinterpret_cast<unsigned long long>(rowp) : (unsigned long long)lane);
  float2 sum[kCornersD];
#pragma unroll
  for (int c = 0; c < kCornersD; ++c) {
    const float w = corner_weight(g, c);
    sum[c] = make_float2(flush(__fmul_rn(w, gv.x)), flush(__fmul_rn(w, gv.y)));
  }
  const int rounds = __reduce_max_sync(full, __popc(peers)) - 1;
  unsigned rest = peers & (peers - 1);          // the peers after the lowest
  for (int r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
    Lookup<D> h;
#pragma unroll
    for (int d = 0; d < D; ++d) h.frac[d] = __shfl_sync(full, g.frac[d], src);
    const float2 hv = make_float2(__shfl_sync(full, gv.x, src), __shfl_sync(full, gv.y, src));
    if (src != lane) {
#pragma unroll
      for (int c = 0; c < kCornersD; ++c) {
        const float w = corner_weight(h, c);
        sum[c].x = flush(sum[c].x + flush(__fmul_rn(w, hv.x)));
        sum[c].y = flush(sum[c].y + flush(__fmul_rn(w, hv.y)));
      }
    }
  }
  if (!live || lane != __ffs(peers) - 1) return;
#pragma unroll
  for (int c = 0; c < kCornersD; ++c)
    atomicAdd(reinterpret_cast<float2*>(rowp + corner_offset<D>(c)), sum[c]);
}

// K3's corner term: adds corner c's share of d/dfrac to dfrac, given gg,
// the output's derivative by the corner's weight (summed over the two
// features): +-gg * the product of the other dimensions' weights.
template <int D>
__device__ __forceinline__ void add_corner_dfrac(float* dfrac, const Lookup<D>& g, int c,
                                                 float gg) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float prod = 1.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      if (dd != d) prod *= ((c >> dd) & 1) ? g.frac[dd] : 1.f - g.frac[dd];
    }
    dfrac[d] += ((c >> d) & 1) ? gg * prod : -(gg * prod);
  }
}

// K3, pass 1. K1's mapping: each group's cotangent is read as whole
// sectors (a float2 per lane), each position once per group, corners x
// and x + 1 as one 16-byte load where aligned. Each lane forms its level's
// dfrac * scale; the group's lanes sum those by xor butterflies (at
// distances 1, 2, ..., width / 2): a lane and its partner add the same two
// values, and IEEE addition commutes, so every lane of the group ends
// with the same bits and the order is fixed by the plan alone. The group's
// sum goes to `out`: dpos itself where one group covers all levels, else
// the group's partial (groups, N, D), which pass 2 adds up in group order.
// Lane j of a group stores the components d = j, j + width, ..., so a
// warp stores its samples' 4 * D bytes each contiguously. A zero cotangent
// adds only zeros: such a lane skips its loads, not the shuffles, and
// where every term is 0 the sum is exactly 0. Unlike K1's, K3's group is
// 16, a sample's levels in one half-warp: at the NeRF width no partials
// and no second pass; the whole 64 MiB table is then in flight, which
// cost 8 % on uniform positions against G = 8, but the path's own inputs
// (a pose step's ~10^4 samples, ray-ordered samples whose neighbours share
// rows) gained 5-14 % over G = 8. 2D grids take the 2D position backward
// below.
template <int D>
__global__ void blocked_grid_encode_bwd_pos_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    const float* __restrict__ grad, float* __restrict__ out,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_group) {
  __shared__ Level levels[kGroupPos];
  const int width = 1 << log2_group;
  stage_group_levels(levels, lp, width);
  const Pair q = pair_of_thread(log2_group);
  // every lane runs to the end: the group's lanes sum together below
  float2 gv = make_float2(0.f, 0.f);
  if (q.i < n) gv = __ldg(reinterpret_cast<const float2*>(grad) + (size_t)q.i * n_levels + q.l);
  float acc[D] = {};
  if (gv.x != 0.f || gv.y != 0.f) {
    const Level lv = levels[q.j];
    const Lookup<D> g = lookup_geometry<D>(pos, q.i, lv, log2_rows, morton_hash);
    const float* rowp = table + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
    const bool paired = (g.base_lane & 2) == 0;
    float dfrac[D] = {};
#pragma unroll
    for (int c = 0; c < (1 << D); c += 2) {
      const float4 v = corner_pair<D>(rowp, c, paired);
      add_corner_dfrac(dfrac, g, c, v.x * gv.x + v.y * gv.y);
      add_corner_dfrac(dfrac, g, c + 1, v.z * gv.x + v.w * gv.y);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = dfrac[d] * lv.scale;
  }
  for (int m = 1; m < width; m <<= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], m);
  }
  if (q.i >= n) return;
  float* o = out + ((size_t)blockIdx.y * n + q.i) * D;
  // component d from registers by selects (an index into acc would go
  // through local memory)
  for (int d = q.j; d < D; d += width) {
    float v = acc[0];
#pragma unroll
    for (int k = 1; k < D; ++k) v = d == k ? acc[k] : v;
    o[d] = v;
  }
}

// K3, pass 2: dpos = the partials of groups 0, 1, ... added in that order,
// one thread per (sample, component), as the reference's sum over levels
// runs in level order; nd = N * D entries.
__global__ void blocked_grid_encode_bwd_pos_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ dpos, int nd,
    int groups) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nd) return;
  float s = __ldg(partial + t);
  for (int k = 1; k < groups; ++k) s += __ldg(partial + (size_t)k * nd + t);
  dpos[t] = s;
}

// K3 on 2D grids (the neural image's uv gradient). Replaces
// hashgrid_pallas.py:_bwd_frac_kernel, and the einsum that chains its
// dfrac to dpos, for D = 2.
//
// What bounds it on this card: K1's gathers on the f32 table (the image
// grid reaches 26.1 MB of rows, inside L2) plus the cotangent, so the
// gathers' L1 line lookups and each lookup's instructions, not bytes. The
// pair kernel above gave a warp 2 samples x 16 levels, whose corner loads
// touched 16 or more rows, and summed a sample's levels by 4 butterfly
// rounds (at 7 and 6 levels in groups of 1 or 2, with partial sums and a
// second pass). This one takes the 2D encode forward's mapping and plan
// (fwd_plan_2d): a block per tile of 2^log2_samples consecutive samples x
// all levels, each warp one 32-sample column walking its levels, lanes on
// neighbouring samples of one level, each lane's position read once. The
// cotangent comes in as the forward's features leave, backwards: the
// tile's (samples, 2L) floats as 16-byte loads into shared memory, in the
// forward's padded layout (so a warp's 32 samples of one level read 32
// banks, where a direct 8-byte load of its level would touch 32 lines),
// zeros past sample n - 1. A lane whose cotangent is zero skips its loads,
// so dpos is exactly 0 where every term is; the others form their level's
// dfrac * scale as the pair kernel does (the same corner loads and order
// of terms) and write it over their cotangent. Then one thread per
// (sample, component) adds the L values in level order, as the plain
// version does, and the tile's dpos leaves as contiguous bytes: no
// shuffles, partial sums or second pass at any level count, and the same
// bits from launch to launch.
__global__ void blocked_grid_encode_bwd_pos_2d_kernel(
    const float* __restrict__ pos, const float* __restrict__ table,
    const float* __restrict__ grad, float* __restrict__ dpos,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_samples) {
  extern __shared__ float tile_cot[];
  const TileLane2D t = tile_lane_2d(pos, n, log2_samples);
  const int width = 2 * n_levels;            // floats a sample
  const int samples = min(1 << log2_samples, n - t.first);   // below n
  const int floats = samples * width;
  // the tile's cotangent, 16 bytes a thread at a time where the tile's
  // start is 16-byte aligned (the caller's tensor may start anywhere),
  // zeros past sample n - 1
  const float* g = grad + (size_t)t.first * width;
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  for (int k = 4 * (int)threadIdx.x; k < (width << log2_samples); k += 4 * (int)blockDim.x) {
    float v[4];
    if (aligned && k + 4 <= floats) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(g + k));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = k + j < floats ? __ldg(g + k + j) : 0.f;
    }
    // k is a multiple of 4: its 4 floats are in one 32
    float* dst = tile_cot + tile_slot(k);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = v[j];
  }
  __syncthreads();
  for (int l = t.level; l < n_levels; l += t.level_step) {
    float* slot = tile_cot + tile_slot(t.s * width + 2 * l);
    const float g0 = slot[0], g1 = slot[1];
    const Level lv = level_of(lp, l);
    float dfrac[2] = {};
    if (g0 != 0.f || g1 != 0.f) {
      const Lookup<2> q = lookup_geometry<2>(t.xy, 0, lv, log2_rows, morton_hash);
      const float* rowp = f32_corner_2d(table, l, log2_rows, q);
      const bool paired = (q.base_lane & 2) == 0;
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        const float4 v = corner_pair<2>(rowp, c, paired);
        add_corner_dfrac(dfrac, q, c, v.x * g0 + v.y * g1);
        add_corner_dfrac(dfrac, q, c + 1, v.z * g0 + v.w * g1);
      }
    }
    slot[0] = dfrac[0] * lv.scale;
    slot[1] = dfrac[1] * lv.scale;
  }
  __syncthreads();
  // thread k takes component k & 1 of sample k >> 1: a warp's stores are
  // 128 contiguous bytes
  float* o = dpos + (size_t)t.first * 2;
  for (int k = (int)threadIdx.x; k < 2 * samples; k += (int)blockDim.x) {
    const int f = (k >> 1) * width + (k & 1);
    float acc = tile_cot[tile_slot(f)];
    for (int l = 1; l < n_levels; ++l) acc += tile_cot[tile_slot(f + 2 * l)];
    o[k] = acc;
  }
}

// K5, pass 1: the largest |w*g| of each (level, sample tile) into
// tile_max[l * n_tiles + t], as float bits. For non-negative floats the
// bit patterns order as the values, so an unsigned atomicMax is exact and
// order-free. K1's mapping, so the cotangent is read as whole sectors; the
// weights need only the fractions, no row. A warp holds 32 / width
// consecutive samples, aligned to 32 / width, and tiles are powers of two
// of at least 32 samples, so the warp lies inside one tile: the lanes of
// level j (j, j + width, ...) reduce by shuffles at xor distances width,
// 2 * width, ..., and lane j adds one atomic for its level.
template <int D>
__global__ void blocked_grid_encode_bwd_i8_max_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    unsigned int* __restrict__ tile_max, const LevelParams lp, int n,
    int n_levels, int log2_group, int log2_tile, int n_tiles) {
  __shared__ Level levels[kGroupI8Bwd];
  const int width = 1 << log2_group;
  stage_group_levels(levels, lp, width);
  const Pair q = pair_of_thread(log2_group);
  // every lane runs to the end: the warp's lanes reduce together below
  float m = 0.f;
  if (q.i < n) {
    const float2 gv = __ldg(reinterpret_cast<const float2*>(grad) + (size_t)q.i * n_levels + q.l);
    if (gv.x != 0.f || gv.y != 0.f) {
      const Lookup<D> g = lookup_fractions<D>(pos, q.i, levels[q.j].scale);
#pragma unroll
      for (int c = 0; c < (1 << D); ++c) {
        const float w = corner_weight(g, c);
        m = fmaxf(m, fmaxf(fabsf(__fmul_rn(w, gv.x)), fabsf(__fmul_rn(w, gv.y))));
      }
    }
  }
  unsigned int bits = __float_as_uint(m);
  for (int d = width; d < 32; d <<= 1)
    bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, d));
  // lane j < width holds level j of the warp's first sample, in its tile
  if ((int)(threadIdx.x & 31) < width && bits != 0u)
    atomicMax(tile_max + (size_t)q.l * n_tiles + (q.i >> log2_tile), bits);
}

// One quantum: q = clip(rint((w*g) / scale), +-127)
__device__ __forceinline__ int quantum(float w, float g, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(__fmul_rn(w, g), scale)), -127.f), 127.f);
}

// K5, pass 2: K2's scatter, adding scale * q with the tile's scale
// max(tile_max, 1e-20) / 127, on K2's mapping: one float2 reduction per
// corner, or one float4 for corners x and x + 1 where x is even (16-byte
// aligned; 16 % faster on uniform positions, equal on a training step's),
// skipped where all its quanta are 0, so an entry whose every q is 0
// stays exactly 0 (adding +0.0 to a neighbour leaves it unchanged).
// Lanes of a warp on the same row and base corner (found by
// __match_any_sync) are on one level and, as the warp lies inside one
// tile, share one scale: the lowest sums its peers' quanta as integers,
// exactly, and adds scale * sum once. The 2 * 2^D quanta of a lookup
// travel packed as bytes, 2^(D-1) shuffles per peer. Unlike K2's sums,
// none needs a flush: every scale is at least 1e-20 / 127, so every
// scale * q with q != 0 is a normal float. 2D grids take the 2D table
// backward below.
template <int D>
__global__ void blocked_grid_encode_bwd_i8_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    const unsigned int* __restrict__ tile_max, float* __restrict__ dtable,
    const LevelParams lp, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_group, int log2_tile, int n_tiles) {
  __shared__ Level levels[kGroupI8Bwd];
  stage_group_levels(levels, lp, 1 << log2_group);
  const Pair q = pair_of_thread(log2_group);
  // every lane runs to the end: the warp's lanes vote together below
  float2 gv = make_float2(0.f, 0.f);
  if (q.i < n) gv = __ldg(reinterpret_cast<const float2*>(grad) + (size_t)q.i * n_levels + q.l);
  const bool live = gv.x != 0.f || gv.y != 0.f;
  float scale = 0.f;
  float* rowp = nullptr;
  constexpr int kCorners = 1 << D;
  // the quanta (q0, q1) of corners 2k and 2k + 1 as the 4 bytes of packed[k]
  uint32_t packed[kCorners / 2] = {};
  if (live) {
    const float tmax = __uint_as_float(__ldg(tile_max + (size_t)q.l * n_tiles + (q.i >> log2_tile)));
    scale = __fdiv_rn(fmaxf(tmax, 1e-20f), 127.f);
    const Lookup<D> g = lookup_geometry<D>(pos, q.i, levels[q.j], log2_rows, morton_hash);
    rowp = dtable + (((size_t)q.l << log2_rows) + g.row) * kLanes + g.base_lane;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      const float w = corner_weight(g, c);
      const uint32_t b = (uint32_t)(quantum(w, gv.x, scale) & 0xff)
                         | ((uint32_t)(quantum(w, gv.y, scale) & 0xff) << 8);
      packed[c >> 1] |= b << (16 * (c & 1));
    }
  }
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(
      full, live ? reinterpret_cast<unsigned long long>(rowp) : (unsigned long long)lane);
  int sum[2 * kCorners];   // feature f of corner c at 2c + f
#pragma unroll
  for (int k = 0; k < 2 * kCorners; ++k) sum[k] = sbyte(packed[k >> 2], k & 3);
  const int rounds = __reduce_max_sync(full, __popc(peers)) - 1;
  unsigned rest = peers & (peers - 1);          // the peers after the lowest
  for (int r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
    uint32_t hp[kCorners / 2];
#pragma unroll
    for (int k = 0; k < kCorners / 2; ++k) hp[k] = __shfl_sync(full, packed[k], src);
    if (src != lane) {
#pragma unroll
      for (int k = 0; k < 2 * kCorners; ++k) sum[k] += sbyte(hp[k >> 2], k & 3);
    }
  }
  if (!live || lane != __ffs(peers) - 1) return;
  // corners c and c + 1 (x and x + 1) are 4 adjacent floats
  const bool paired = (reinterpret_cast<uintptr_t>(rowp) & 15) == 0;
#pragma unroll
  for (int c = 0; c < kCorners; c += 2) {
    const int* a = sum + 2 * c;     // q0, q1 of corner c, then of c + 1
    float* p = rowp + corner_offset<D>(c);
    if (paired) {
      if ((a[0] | a[1] | a[2] | a[3]) != 0)
        atomicAdd(reinterpret_cast<float4*>(p),
                  make_float4(__fmul_rn((float)a[0], scale), __fmul_rn((float)a[1], scale),
                              __fmul_rn((float)a[2], scale), __fmul_rn((float)a[3], scale)));
    } else {
      if ((a[0] | a[1]) != 0)
        atomicAdd(reinterpret_cast<float2*>(p),
                  make_float2(__fmul_rn((float)a[0], scale), __fmul_rn((float)a[1], scale)));
      if ((a[2] | a[3]) != 0)
        atomicAdd(reinterpret_cast<float2*>(p + 2),
                  make_float2(__fmul_rn((float)a[2], scale), __fmul_rn((float)a[3], scale)));
    }
  }
}

// K2 and K5 on 2D grids (the neural image). Replace
// hashgrid_pallas.py:_bwd_table_kernel and _bwd_table_kernel_i8 for D = 2.
//
// What bounds them on this card: the image grid (configs/image/base.json
// at a 2048^2 image: 16 levels x 32768 rows, 256 MiB of gradient) is
// dense at every level, so a level can address only blocks^2 rows: 50,940
// rows in all, 26.1 MB, inside L2; the other 242 MB of the output are
// zeros that no sample can reach (the caller's torch.zeros, most of the
// bound). The pair-per-thread scatter above sent every corner of 2^18 x
// 16 lookups to L2 as a vector reduction, and on the coarse levels (9 to
// 256 rows) those serialise on a few addresses; what is left bounding
// this kernel is the number of reductions into L2. The TPU kernel keeps
// each level's dTable block in VMEM across its sequential tile axis.
// Here one block takes a group of 4 (K5) or 2 (K2) levels of a chunk of
// consecutive samples (K5: one quantisation tile), neighbouring lanes on
// one sample's levels as in K1, so the cotangent comes as whole or half
// sectors; each thread takes a run of consecutive samples of one level. The image's stratified batch runs
// along x, so on the coarse levels a run stays in one cell for many
// samples: its corner sums are formed in registers and leave once per
// run. The plan (kernels/blocked_grid_cuda.py, table_bwd_plan_2d, from
// level_needed_rows) says per level where they go:
//  - kSumLevel: the level's needed rows fit in its share of the block's
//    shared memory; the run sums go there by shared-memory atomics (int32
//    ones are native; f32 ones are compare-and-swap loops on this card),
//    and each nonzero 16-byte group of entries then leaves once: no
//    reduction into L2 serialises on the 9-row level 0 of uniform
//    positions.
//  - kSumL2: one float2 reduction a corner, or one float4 for corners x
//    and x + 1 where x is even (the other levels). Summing a finer dense
//    level in the strip of rows its chunk reaches was slower on the
//    image's batch (PERF.md): its runs already fold the coarse levels,
//    and the finer ones have 1-3 samples a vertex.
// K5 takes each level's tile max |w*g| by a block reduction (exact and
// order-free), then quantises. A run sums its quanta as int32, and a
// kSumLevel level's shared rows sum the whole tile's, as the TPU kernel
// does, then add f32(sum q) * scale once per entry: bit-equal to the
// plain version's tile term, so only the f32 order across tiles remains;
// elsewhere f32(run sum) * scale goes to L2. One launch, no tile_max
// buffer: the block reads its tile's samples a second time from L2.
enum : unsigned char { kSumL2 = 0, kSumLevel = 1 };

struct TableBwdLevels {
  Level level[kMaxLevels];
  unsigned char where[kMaxLevels];
};

// the rows of a level that a sample can reach: blocks^2 dense, all hashed
__host__ __device__ __forceinline__ int reachable_rows_2d(const Level& lv, int log2_rows) {
  return lv.is_dense ? lv.blocks_per_dim * lv.blocks_per_dim : 1 << log2_rows;
}

// The most levels a block of the 2D table backward takes: a sample's 4
// levels share one 32-byte sector of the cotangent, so a block of 4 levels
// reads whole sectors (lanes 4s .. 4s + 3 hold one sample's levels, as in
// K1); the plan gives K5 4 and K2 2 (half sectors, runs half as long)
constexpr int kGroupTableBwd = 4;

// Each of the block's `width` levels' largest |w*g| over the whole block,
// level j's in out[j] (shared memory), visible to every thread on return:
// the lanes of one level (j, j + width, ...) reduce by xor shuffles, then
// thread j takes the warps' largest (exact and order-free)
__device__ __forceinline__ void block_level_max(float m, int width, float* out) {
  __shared__ float warp_max[32][kGroupTableBwd];
  for (int d = 16; d >= width; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  const int lane = threadIdx.x & 31;
  if (lane < width) warp_max[threadIdx.x >> 5][lane] = m;
  __syncthreads();
  if ((int)threadIdx.x < width) {
    float r = warp_max[0][threadIdx.x];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, warp_max[w][threadIdx.x]);
    out[threadIdx.x] = r;
  }
  __syncthreads();
}

// Where a block of the 2D table backward sums each of its levels: level
// j holds its rows in shared rows [off[j], off[j] + nr[j]) (nr[j] = 0:
// summed in L2), `used` rows in all; scale[j] is K5's
struct SharedRows {
  int off[kGroupTableBwd], nr[kGroupTableBwd];
  float scale[kGroupTableBwd];
  int used;
};

// Adds the float4 `v` to the 16 aligned bytes at p, or nothing where it is
// all zero
__device__ __forceinline__ void add_nonzero4(float* p, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(p), v);
}

// Adds corners c and c + 1 (x and x + 1: 4 adjacent floats at p) to L2:
// one float4 reduction where p is 16-byte aligned, else two float2
__device__ __forceinline__ void add_corner_pair(float* p, float4 v, bool paired) {
  if (paired) {
    add_nonzero4(p, v);
    return;
  }
  if (v.x != 0.f || v.y != 0.f) atomicAdd(reinterpret_cast<float2*>(p), make_float2(v.x, v.y));
  if (v.z != 0.f || v.w != 0.f) atomicAdd(reinterpret_cast<float2*>(p + 2), make_float2(v.z, v.w));
}

// A run's sums (feature f of corner c at 2c + f: f32 products for K2,
// int32 quanta for K5) added where its level is summed: into the shared
// rows `smem` at row `srow`, or, with srow < 0, to L2 at `gridp` (the
// run's base corner in the gradient); zeros skipped
template <bool kInt8>
__device__ __forceinline__ void add_run(const float* acc, const int* qacc, float4* smem,
                                        int srow, int base_lane, float* gridp, float scale) {
  if (srow >= 0) {
    const int s = srow * kLanes + base_lane;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int at = s + corner_offset<2>(k >> 1) + (k & 1);
      if (kInt8) {
        if (qacc[k] != 0) atomicAdd(reinterpret_cast<int*>(smem) + at, qacc[k]);
      } else {
        if (acc[k] != 0.f) atomicAdd(reinterpret_cast<float*>(smem) + at, acc[k]);
      }
    }
    return;
  }
  const bool paired = (base_lane & 2) == 0;
#pragma unroll
  for (int c = 0; c < 4; c += 2) {
    const int k = 2 * c;
    const float4 v = kInt8 ? make_float4(__fmul_rn((float)qacc[k], scale), __fmul_rn((float)qacc[k + 1], scale),
                                         __fmul_rn((float)qacc[k + 2], scale), __fmul_rn((float)qacc[k + 3], scale))
                           : make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    add_corner_pair(gridp + corner_offset<2>(c), v, paired);
  }
}

template <bool kInt8>
__global__ void blocked_grid_encode_bwd_2d_kernel(
    const float* __restrict__ pos, const float* __restrict__ grad,
    float* __restrict__ dtable, const TableBwdLevels tl, int n, int n_levels,
    int log2_rows, int morton_hash, int log2_chunk, int log2_width) {
  extern __shared__ float4 smem4[];
  // block b takes level group b % groups of chunk b / groups: a chunk's
  // groups run side by side, so its positions and cotangent come from
  // device memory once and from L2 after; thread t takes level
  // t % width of the group, lanes 4s .. 4s + 3 one sample's 4 levels
  const int width = 1 << log2_width, groups = n_levels >> log2_width;
  const int group = (int)(blockIdx.x % groups), chunk_id = (int)(blockIdx.x / groups);
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int j = t & (width - 1), l0 = group << log2_width, l = l0 + j;
  const Level lv = tl.level[l];
  const size_t rows = (size_t)1 << log2_rows;
  // this thread's samples: a run of `per` consecutive ones, [begin, end)
  const int per = (1 << (log2_chunk + log2_width)) / nthreads;
  const int begin = (chunk_id << log2_chunk) + (t >> log2_width) * per;
  const int end = min(begin + per, n);
  const float2* g2 = reinterpret_cast<const float2*>(grad);

  // K5, pass 1: each level's largest |w*g| in the block (its tile)
  __shared__ float level_max[kGroupTableBwd];
  if (kInt8) {
    float m = 0.f;
    for (int i = begin; i < end; ++i) {
      const float2 gv = __ldg(g2 + (size_t)i * n_levels + l);
      if (gv.x == 0.f && gv.y == 0.f) continue;
      const Lookup<2> g = lookup_fractions<2>(pos, i, lv.scale);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = corner_weight(g, c);
        m = fmaxf(m, fmaxf(fabsf(__fmul_rn(w, gv.x)), fabsf(__fmul_rn(w, gv.y))));
      }
    }
    block_level_max(m, width, level_max);
  }
  // The shared rows, set by thread 0: the group's kSumLevel levels' whole
  // rows, side by side (the plan keeps them inside the block's rows)
  __shared__ SharedRows sr;
  if (t == 0) {
    int used = 0;
    for (int jj = 0; jj < width; ++jj) {
      const int nr = tl.where[l0 + jj] == kSumLevel
                         ? reachable_rows_2d(tl.level[l0 + jj], log2_rows) : 0;
      sr.off[jj] = used;
      sr.nr[jj] = nr;
      sr.scale[jj] = kInt8 ? __fdiv_rn(fmaxf(level_max[jj], 1e-20f), 127.f) : 0.f;
      used += nr;
    }
    sr.used = used;
  }
  __syncthreads();
  // this thread's level: its shared rows (none: L2) and K5's scale
  const int used = sr.used, my_off = sr.off[j], my_nr = sr.nr[j];
  const float my_scale = sr.scale[j];
  for (int k = t; k < used * (kLanes / 4); k += nthreads) smem4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // pass 2: the scatter. A thread's samples lie side by side along x, so
  // on the coarse levels runs of them share a cell: their corner sums
  // are formed in registers and added once per run.
  float* level_grad = dtable + (size_t)l * rows * kLanes;
  float acc[8];
  int qacc[8];
  int key = -1;   // the run's row * 128 + base lane; -1: no run
  for (int i = begin; i <= end; ++i) {
    float2 gv = make_float2(0.f, 0.f);
    Lookup<2> g = {};
    int k2 = -1;
    if (i < end) {
      gv = __ldg(g2 + (size_t)i * n_levels + l);
      if (gv.x == 0.f && gv.y == 0.f) continue;
      g = lookup_geometry<2>(pos, i, lv, log2_rows, morton_hash);
      k2 = (int)g.row * kLanes + g.base_lane;
    }
    if (k2 != key) {
      if (key >= 0) {
        const int row = key / kLanes, base_lane = key % kLanes;
        add_run<kInt8>(acc, qacc, smem4, my_nr > 0 ? row + my_off : -1, base_lane,
                       level_grad + (size_t)row * kLanes + base_lane, my_scale);
      }
      key = k2;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[k] = 0.f;
        qacc[k] = 0;
      }
    }
    if (i == end) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = corner_weight(g, c);
      if (kInt8) {
        qacc[2 * c] += quantum(w, gv.x, my_scale);
        qacc[2 * c + 1] += quantum(w, gv.y, my_scale);
      } else {
        acc[2 * c] = flush(acc[2 * c] + flush(__fmul_rn(w, gv.x)));
        acc[2 * c + 1] = flush(acc[2 * c + 1] + flush(__fmul_rn(w, gv.y)));
      }
    }
  }
  __syncthreads();
  // the shared sums to the gradient, 16 bytes at a time, skipping zeros
  for (int k = t; k < used * (kLanes / 4); k += nthreads) {
    const int r = k / (kLanes / 4);
    int jl = 0;
    for (int jj = 0; jj < width; ++jj)
      if (r >= sr.off[jj] && r < sr.off[jj] + sr.nr[jj]) jl = jj;
    const float sc = sr.scale[jl];
    float* dst = dtable + ((l0 + jl) * rows + (r - sr.off[jl])) * kLanes + (k % (kLanes / 4)) * 4;
    if (kInt8) {
      const int4 v = reinterpret_cast<const int4*>(smem4)[k];
      add_nonzero4(dst, make_float4(__fmul_rn((float)v.x, sc), __fmul_rn((float)v.y, sc),
                                    __fmul_rn((float)v.z, sc), __fmul_rn((float)v.w, sc)));
    } else {
      const float4 v = smem4[k];
      add_nonzero4(dst, make_float4(flush(v.x), flush(v.y), flush(v.z), flush(v.w)));
    }
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

// Checks a pair launch of K1–K5 (kernels/blocked_grid_cuda.py,
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

// The per-level parameters and the plan of a pair launch, checked.
int prepare(LevelParams* lp, const float* scales, const int* blocks_per_dim,
            const unsigned char* is_dense, int n, int n_levels, int log2_rows,
            int group, int blocks, int threads, int log2_group) {
  const int rc = fill_levels(lp, scales, blocks_per_dim, is_dense, n, n_levels,
                             log2_rows);
  return rc != 0 ? rc : check_plan(n, n_levels, group, blocks, threads, log2_group);
}

// K1 and K2 for a D-dimensional grid, planned and checked
template <int D>
int encode_fwd(const float* pos, const float* table, float* out,
               const float* scales, const int* blocks_per_dim,
               const unsigned char* is_dense, int n, int n_levels, int log2_rows,
               int morton_hash, int blocks, int threads, int log2_group, void* stream) {
  LevelParams lp = {};
  const int rc = prepare(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                         log2_rows, kGroupFwd, blocks, threads, log2_group);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_kernel<D><<<dim3(blocks, n_levels >> log2_group), threads,
                                      0, static_cast<cudaStream_t>(stream)>>>(
      pos, table, out, lp, n, n_levels, log2_rows, morton_hash, log2_group);
  return (int)cudaGetLastError();
}

template <int D>
int encode_bwd(const float* pos, const float* grad, float* dtable,
               const float* scales, const int* blocks_per_dim,
               const unsigned char* is_dense, int n, int n_levels, int log2_rows,
               int morton_hash, int blocks, int threads, int log2_group, void* stream) {
  LevelParams lp = {};
  const int rc = prepare(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                         log2_rows, kGroupBwd, blocks, threads, log2_group);
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_kernel<D><<<dim3(blocks, n_levels >> log2_group), threads,
                                      0, static_cast<cudaStream_t>(stream)>>>(
      pos, grad, dtable, lp, n, n_levels, log2_rows, morton_hash, log2_group);
  return (int)cudaGetLastError();
}

// K4 for a D-dimensional grid, planned and checked
template <int D>
int encode_fwd_i8(const float* pos, const int8_t* table, const float* qscale,
                  float* out, const float* scales, const int* blocks_per_dim,
                  const unsigned char* is_dense, int n, int n_levels, int log2_rows,
                  int morton_hash, int blocks, int threads, int log2_group,
                  void* stream) {
  LevelParams lp = {};
  const int rc = prepare(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                         log2_rows, kGroupI8, blocks, threads, log2_group);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_i8_kernel<D><<<dim3(blocks, n_levels >> log2_group),
                                         threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      pos, table, qscale, out, lp, n, n_levels, log2_rows, morton_hash,
      log2_group);
  return (int)cudaGetLastError();
}

// the most shared memory a tile of the 2D encode forward may take: the
// limit without an opt-in attribute
constexpr int kFwd2dMaxSmemBytes = 48 << 10;

// Checks a launch on kernels/blocked_grid_cuda.py's fwd_plan_2d plan (the
// 2D encode forward's, and the 2D position backward's): tiles of
// 2^log2_samples samples (32 to 1024), `threads` per block (whole warps,
// the same number on each 32-sample column of the tile, at most one per
// level), exactly the blocks that cover n samples, and the tile's floats
// within kFwd2dMaxSmemBytes.
int check_plan_2d(int n, int n_levels, int blocks, int threads, int log2_samples) {
  if (log2_samples < 5 || log2_samples > 10 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || threads > (n_levels << log2_samples) ||
      (threads >> 5) % (1 << (log2_samples - 5)) != 0 ||
      (long long)blocks != (((long long)n + (1 << log2_samples) - 1) >> log2_samples) ||
      fwd_2d_smem_bytes(log2_samples, n_levels) > kFwd2dMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// K1 (kInt8 false) and K4 on a 2D grid, on fwd_plan_2d's plan, checked
template <bool kInt8>
int encode_fwd_2d(const float* pos, const void* table, const float* qscale,
                  float* out, const float* scales, const int* blocks_per_dim,
                  const unsigned char* is_dense, int n, int n_levels, int log2_rows,
                  int morton_hash, int blocks, int threads, int log2_samples,
                  void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels, log2_rows);
  if (rc == 0) rc = check_plan_2d(n, n_levels, blocks, threads, log2_samples);
  if (rc != 0) return rc;
  blocked_grid_encode_fwd_2d_kernel<kInt8><<<blocks, threads,
                                              fwd_2d_smem_bytes(log2_samples, n_levels),
                                              static_cast<cudaStream_t>(stream)>>>(
      pos, table, qscale, out, lp, n, n_levels, log2_rows, morton_hash, log2_samples);
  return (int)cudaGetLastError();
}

// K3 on a 2D grid, on fwd_plan_2d's plan, checked: one pass
int encode_bwd_pos_2d(const float* pos, const float* table, const float* grad,
                      float* dpos, const float* scales, const int* blocks_per_dim,
                      const unsigned char* is_dense, int n, int n_levels, int log2_rows,
                      int morton_hash, int blocks, int threads, int log2_samples,
                      void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels, log2_rows);
  if (rc == 0) rc = check_plan_2d(n, n_levels, blocks, threads, log2_samples);
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_pos_2d_kernel<<<blocks, threads,
                                          fwd_2d_smem_bytes(log2_samples, n_levels),
                                          static_cast<cudaStream_t>(stream)>>>(
      pos, table, grad, dpos, lp, n, n_levels, log2_rows, morton_hash, log2_samples);
  return (int)cudaGetLastError();
}

// K3 for a 3D grid: both passes on one stream
template <int D>
int encode_bwd_pos(const float* pos, const float* table, const float* grad,
                   float* dpos, float* partial, const float* scales,
                   const int* blocks_per_dim, const unsigned char* is_dense, int n,
                   int n_levels, int log2_rows, int morton_hash, int blocks,
                   int threads, int log2_group, void* stream) {
  LevelParams lp = {};
  int rc = prepare(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                   log2_rows, kGroupPos, blocks, threads, log2_group);
  if (rc != 0) return rc;
  const int groups = n_levels >> log2_group;
  if ((groups > 1 && partial == nullptr) || n > INT_MAX / D)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  blocked_grid_encode_bwd_pos_kernel<D><<<dim3(blocks, groups), threads, 0, s>>>(
      pos, table, grad, groups > 1 ? partial : dpos, lp, n, n_levels,
      log2_rows, morton_hash, log2_group);
  rc = (int)cudaGetLastError();
  if (rc != 0 || groups == 1) return rc;
  const int nd = n * D;
  blocked_grid_encode_bwd_pos_sum_kernel<<<(nd + kThreads - 1) / kThreads,
                                           kThreads, 0, s>>>(partial, dpos, nd,
                                                             groups);
  return (int)cudaGetLastError();
}

// K5 for a D-dimensional grid: both passes on one stream, on one plan
template <int D>
int encode_bwd_i8(const float* pos, const float* grad, unsigned int* tile_max,
                  float* dtable, const float* scales, const int* blocks_per_dim,
                  const unsigned char* is_dense, int n, int n_levels, int log2_rows,
                  int morton_hash, int blocks, int threads, int log2_group,
                  int log2_tile, void* stream) {
  LevelParams lp = {};
  int rc = prepare(&lp, scales, blocks_per_dim, is_dense, n, n_levels,
                   log2_rows, kGroupI8Bwd, blocks, threads, log2_group);
  if (rc != 0) return rc;
  if (log2_tile < 5 || log2_tile > 30) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)n + (1LL << log2_tile) - 1) >> log2_tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, n_levels >> log2_group);
  blocked_grid_encode_bwd_i8_max_kernel<D><<<grid, threads, 0, s>>>(
      pos, grad, tile_max, lp, n, n_levels, log2_group, log2_tile, n_tiles);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  blocked_grid_encode_bwd_i8_kernel<D><<<grid, threads, 0, s>>>(
      pos, grad, tile_max, dtable, lp, n, n_levels, log2_rows, morton_hash,
      log2_group, log2_tile, n_tiles);
  return (int)cudaGetLastError();
}

// the most shared memory a block of this card may take (dynamic and
// static together)
constexpr int kMaxSmemBytes = 232448;

// K2 (int8 = 0) or K5 (int8 = 1, chunks of the quantisation tile) on a 2D
// grid, as kernels/blocked_grid_cuda.py's table_bwd_plan_2d plans it:
// chunks of 2^log2_chunk samples, groups of 2^log2_width levels (at most
// kGroupTableBwd), `threads` per block (a power of two from 32 to 256, at
// most chunk x width), `smem_bytes` of shared memory (whole rows), `where`
// per level; checked.
template <bool kInt8>
int table_bwd_2d(const float* pos, const float* grad, float* dtable,
                 const float* scales, const int* blocks_per_dim,
                 const unsigned char* is_dense, const unsigned char* where,
                 int n, int n_levels, int log2_rows, int morton_hash,
                 int log2_chunk, int log2_width, int threads, int smem_bytes,
                 void* stream) {
  LevelParams lp = {};
  int rc = fill_levels(&lp, scales, blocks_per_dim, is_dense, n, n_levels, log2_rows);
  if (rc != 0) return rc;
  const int smem_rows = smem_bytes / (kLanes * 4);
  const int width = 1 << std::max(log2_width, 0);
  if (log2_chunk < 5 || log2_chunk > 24 || log2_width < 0 || width > kGroupTableBwd ||
      n_levels % width != 0 || threads < 32 || threads > kThreads ||
      (threads & (threads - 1)) != 0 || threads > (width << log2_chunk) ||
      smem_bytes < 0 || smem_bytes > kMaxSmemBytes || smem_bytes % (kLanes * 4) != 0)
    return (int)cudaErrorInvalidValue;
  TableBwdLevels tl = {};
  // every level's where valid, and each group's whole levels inside the
  // block's rows
  int level_rows = 0;
  for (int l = 0; l < n_levels; ++l) {
    tl.level[l] = {lp.scale[l], lp.blocks_per_dim[l], lp.is_dense[l]};
    tl.where[l] = where[l];
    if (l % width == 0) level_rows = 0;
    if (where[l] == kSumLevel) level_rows += reachable_rows_2d(tl.level[l], log2_rows);
    const bool ok = where[l] == kSumL2 || (where[l] == kSumLevel && lp.is_dense[l]);
    if (!ok || level_rows > smem_rows) return (int)cudaErrorInvalidValue;
  }
  // above 48 KiB a kernel takes dynamic shared memory only up to its
  // attribute, raised here once to the largest plan seen (not a stream
  // operation: a call inside a graph capture that needs no raise makes
  // none)
  static int smem_allowed = 48 << 10;
  if (smem_bytes > smem_allowed) {
    rc = (int)cudaFuncSetAttribute(blocked_grid_encode_bwd_2d_kernel<kInt8>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
    if (rc != 0) return rc;
    smem_allowed = smem_bytes;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = ((long long)n + (1 << log2_chunk) - 1) >> log2_chunk;
  if (chunks * n_levels > INT_MAX) return (int)cudaErrorInvalidValue;
  blocked_grid_encode_bwd_2d_kernel<kInt8><<<(unsigned)(chunks * n_levels / width), threads,
                                             smem_bytes, s>>>(
      pos, grad, dtable, tl, n, n_levels, log2_rows, morton_hash, log2_chunk, log2_width);
  return (int)cudaGetLastError();
}

}  // namespace

// The level group of kernel 0 = K1, 1 = K2, 2 = K4, 3 = K5, 4 = K3 on 3D
// grids, so the wrapper can plan their launches; -1 for any other. On 2D
// grids every kernel takes a plan of its own.
extern "C" int ngp_blocked_grid_group(int kernel) {
  switch (kernel) {
    case 0: return kGroupFwd;
    case 1: return kGroupBwd;
    case 2: return kGroupI8;
    case 3: return kGroupI8Bwd;
    case 4: return kGroupPos;
    default: return -1;
  }
}

// Each entry point launches on `stream` (a cudaStream_t passed as a
// pointer) and returns the cudaError_t of the launch; 0 on success.
// Per-level arrays are host memory, n_levels entries each; they travel in
// the kernel's parameters. Tensors are device memory, contiguous. Every
// kernel takes the wrapper's launch plan (blocks and threads per level
// group, log2 of the group's width). Each takes a 3D grid and positions
// (N, 3); its _2d twin takes a 2D grid and positions (N, 2), with the same
// arguments (K1's, K3's and K4's with a plan of their own in the last
// three, K3's without partial sums).
#define NGP_ENCODE_FWD_ARGS                                                   \
    const float* pos, const float* table, float* out, const float* scales,    \
    const int* blocks_per_dim, const unsigned char* is_dense, int n,           \
    int n_levels, int log2_rows, int morton_hash, int blocks, int threads,     \
    int log2_group, void* stream
#define NGP_ENCODE_FWD_PASS                                                   \
    pos, table, out, scales, blocks_per_dim, is_dense, n, n_levels, log2_rows, \
    morton_hash, blocks, threads, log2_group, stream

// K1
extern "C" int ngp_blocked_grid_encode_fwd(NGP_ENCODE_FWD_ARGS) {
  return encode_fwd<3>(NGP_ENCODE_FWD_PASS);
}

// K1 on a 2D grid, on fwd_plan_2d's plan: `blocks` tiles of
// 2^log2_samples samples, `threads` per block
extern "C" int ngp_blocked_grid_encode_fwd_2d(
    const float* pos, const float* table, float* out, const float* scales,
    const int* blocks_per_dim, const unsigned char* is_dense, int n,
    int n_levels, int log2_rows, int morton_hash, int blocks, int threads,
    int log2_samples, void* stream) {
  return encode_fwd_2d<false>(pos, table, nullptr, out, scales, blocks_per_dim,
                              is_dense, n, n_levels, log2_rows, morton_hash,
                              blocks, threads, log2_samples, stream);
}

// K4
#define NGP_ENCODE_FWD_I8_ARGS                                                \
    const float* pos, const int8_t* table, const float* qscale, float* out,   \
    const float* scales, const int* blocks_per_dim,                            \
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,         \
    int morton_hash, int blocks, int threads, int log2_group, void* stream
#define NGP_ENCODE_FWD_I8_PASS                                                \
    pos, table, qscale, out, scales, blocks_per_dim, is_dense, n, n_levels,    \
    log2_rows, morton_hash, blocks, threads, log2_group, stream

extern "C" int ngp_blocked_grid_encode_fwd_i8(NGP_ENCODE_FWD_I8_ARGS) {
  return encode_fwd_i8<3>(NGP_ENCODE_FWD_I8_PASS);
}

// K4 on a 2D grid, on fwd_plan_2d's plan (K1's arguments and the level
// scales)
extern "C" int ngp_blocked_grid_encode_fwd_i8_2d(
    const float* pos, const int8_t* table, const float* qscale, float* out,
    const float* scales, const int* blocks_per_dim,
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,
    int morton_hash, int blocks, int threads, int log2_samples, void* stream) {
  return encode_fwd_2d<true>(pos, table, qscale, out, scales, blocks_per_dim,
                             is_dense, n, n_levels, log2_rows, morton_hash,
                             blocks, threads, log2_samples, stream);
}

// K2: dtable must be zeroed by the caller; the kernel only adds into it.
#define NGP_ENCODE_BWD_ARGS                                                   \
    const float* pos, const float* grad, float* dtable, const float* scales,  \
    const int* blocks_per_dim, const unsigned char* is_dense, int n,           \
    int n_levels, int log2_rows, int morton_hash, int blocks, int threads,     \
    int log2_group, void* stream
#define NGP_ENCODE_BWD_PASS                                                   \
    pos, grad, dtable, scales, blocks_per_dim, is_dense, n, n_levels,          \
    log2_rows, morton_hash, blocks, threads, log2_group, stream

extern "C" int ngp_blocked_grid_encode_bwd(NGP_ENCODE_BWD_ARGS) {
  return encode_bwd<3>(NGP_ENCODE_BWD_PASS);
}

// K3: dpos (N, 3) is written in full; no zeroing needed. Where the plan
// has more than one level group, `partial` holds (groups, N, D) floats of
// scratch (written in full by pass 1, read by pass 2 on the same stream);
// it may be null for a single group.
#define NGP_ENCODE_BWD_POS_ARGS                                               \
    const float* pos, const float* table, const float* grad, float* dpos,     \
    float* partial, const float* scales, const int* blocks_per_dim,            \
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,         \
    int morton_hash, int blocks, int threads, int log2_group, void* stream
#define NGP_ENCODE_BWD_POS_PASS                                               \
    pos, table, grad, dpos, partial, scales, blocks_per_dim, is_dense, n,      \
    n_levels, log2_rows, morton_hash, blocks, threads, log2_group, stream

extern "C" int ngp_blocked_grid_encode_bwd_pos(NGP_ENCODE_BWD_POS_ARGS) {
  return encode_bwd_pos<3>(NGP_ENCODE_BWD_POS_PASS);
}

// K3 on a 2D grid, on fwd_plan_2d's plan: `blocks` tiles of
// 2^log2_samples samples, `threads` per block; no partial sums
extern "C" int ngp_blocked_grid_encode_bwd_pos_2d(
    const float* pos, const float* table, const float* grad, float* dpos,
    const float* scales, const int* blocks_per_dim, const unsigned char* is_dense,
    int n, int n_levels, int log2_rows, int morton_hash, int blocks, int threads,
    int log2_samples, void* stream) {
  return encode_bwd_pos_2d(pos, table, grad, dpos, scales, blocks_per_dim, is_dense, n,
                           n_levels, log2_rows, morton_hash, blocks, threads,
                           log2_samples, stream);
}

// K5: tile_max (L * ceil(n / 2^log2_tile) uint32) and dtable must be
// zeroed by the caller. A tile of at least 32 samples holds every warp's
// samples whole.
#define NGP_ENCODE_BWD_I8_ARGS                                                \
    const float* pos, const float* grad, unsigned int* tile_max,              \
    float* dtable, const float* scales, const int* blocks_per_dim,             \
    const unsigned char* is_dense, int n, int n_levels, int log2_rows,         \
    int morton_hash, int blocks, int threads, int log2_group, int log2_tile,   \
    void* stream
#define NGP_ENCODE_BWD_I8_PASS                                                \
    pos, grad, tile_max, dtable, scales, blocks_per_dim, is_dense, n,          \
    n_levels, log2_rows, morton_hash, blocks, threads, log2_group, log2_tile,  \
    stream

extern "C" int ngp_blocked_grid_encode_bwd_i8(NGP_ENCODE_BWD_I8_ARGS) {
  return encode_bwd_i8<3>(NGP_ENCODE_BWD_I8_PASS);
}

// K2 (int8 = 0) and K5 (int8 = 1, chunks of the quantisation tile) on a
// 2D grid: positions (N, 2), the per-level arrays and `where` (n_levels
// entries each, host memory), the plan of table_bwd_plan_2d; dtable must
// be zeroed by the caller.
extern "C" int ngp_blocked_grid_table_bwd_2d(
    const float* pos, const float* grad, float* dtable, const float* scales,
    const int* blocks_per_dim, const unsigned char* is_dense,
    const unsigned char* where, int n, int n_levels, int log2_rows,
    int morton_hash, int log2_chunk, int log2_width, int threads,
    int smem_bytes, int int8, void* stream) {
  return (int8 ? table_bwd_2d<true> : table_bwd_2d<false>)(
      pos, grad, dtable, scales, blocks_per_dim, is_dense, where, n, n_levels,
      log2_rows, morton_hash, log2_chunk, log2_width, threads, smem_bytes,
      stream);
}

extern "C" const char* ngp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
