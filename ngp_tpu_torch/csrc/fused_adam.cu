// Fused multi-tensor Adam for Hopper (sm_90a): one launch a step updates
// every parameter tensor of a model in place, with tcnn's semantics as
// ngp_tpu_torch/opt/optimizers.py apply_update states them: the gradient
// divided by the loss scale, L2 on matrices, the ExponentialDecay learning
// rate, Adam's moments and bias corrections, non-matrix entries whose
// gradient is exactly 0 frozen with their moments (skip_zero_grad), and
// the Ema (e = d*e + (1-d)*p, or e = p with no Ema).
//
// It replaces no Pallas kernel: the JAX package leaves Adam to XLA, which
// fuses the update into a few passes. The port's plain version is eager
// PyTorch, ~20 passes over each tensor (the image step's 2 GiB table
// among them); this kernel is added to make the update one pass.
//
// What bounds it on this card: bytes. It does ~30 flops per updated entry
// against at least 28 bytes of p, m, v read and written, far below the
// card's ~20 flops a byte. A dense pass moves 7 x 4 bytes an entry (g, p,
// m, v read; p, m, v written): 15.0 GB, 4.5 ms at 3.35 TB/s, for the
// image's 2^29-entry table. The skip makes it sparse: a thread first reads
// its g as 16-byte vectors, and reads and writes p, m and v only for the
// vectors that hold a touched entry (or belong to a matrix), selecting per
// entry inside the vector. A 2^18-position image step touches a few
// percent of the finest levels' entries, so the pass moves the 2 GiB of g
// plus the touched vectors. An Ema reads e and p and writes e at every
// entry (the NeRF network's 64 MiB table: 4 passes of it); with no Ema the
// wrapper passes e = p (the optimizer aliases them) and the kernel writes
// no e, or, for a separate e, writes e = p everywhere.
//
// Design: a 1D grid over all tensors, each tensor a run of blocks of
// kThreads threads, kVecs float4s a thread (neighbouring threads on
// neighbouring vectors, each thread's vectors kThreads apart): 16 KiB of
// g a block, its loads issued together, many blocks an SM. The tensor
// table (pointers, sizes, flags, each tensor's first block) and the
// scalars travel by value in the launch's parameters (__grid_constant__,
// read in place, not copied to the device). No shared memory, no atomics,
// no host sync. A tensor whose pointers are not all 16-byte aligned, and
// the ragged last vector of any tensor, take scalar loads and stores.
//
// Numerics: bit-identical to the eager update on the card. Each operation
// rounds once, in the eager path's order (__fmul_rn and friends, which nvcc
// never contracts into an FMA); the learning rate, its decay factor and
// both bias corrections are computed on the device from the integer step
// with powf, the same f32 pow that torch.pow runs on two 0-d f32 tensors.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 32;   // tensors a launch takes (the wrapper splits)
constexpr int kThreads = 256;
constexpr int kVecs = 4;          // float4s a thread
constexpr long long kVecsPerBlock = (long long)kThreads * kVecs;

// what a tensor's Ema takes: nothing (e is p, or there is no e), e = p, or
// e = d*e + (1-d)*p
enum EmaMode { kEmaNone = 0, kEmaCopy = 1, kEmaDecay = 2 };

// one parameter tensor; the layout of fused_adam_cuda.AdamTensor
struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* e;
  long long n;        // entries
  long long block0;   // its first block in the grid
  int dense;          // 1: update every entry (a matrix, or no skip)
  int l2;             // 1: add l2 * p to the gradient
  int ema;            // EmaMode
  int aligned;        // 1: p, g, m, v (and e) are 16-byte aligned
};

// the step's scalars, each an f32 as PyTorch rounds the Python float (or
// the difference 1 - x taken in double first); the layout of
// fused_adam_cuda.AdamScalars
struct AdamScalars {
  float lr, decay_base;
  float b1, omb1, b2, omb2;   // beta and 1 - beta
  float eps, l2, inv_ls;
  float ema_d, ema_omd;       // Ema decay and 1 - decay
  int step;                   // the step being taken, from 1
  int decay_on;               // decay_interval > 0 and decay_base != 1
  int decay_start, decay_interval, decay_end;
};

struct AdamTable {
  AdamTensor t[kMaxTensors];
  AdamScalars s;
  int n_tensors;
};

// lr_at_step and the bias corrections 1 - beta^step, as the eager update
// computes them on 0-d device tensors
__device__ __forceinline__ void step_scalars(const AdamScalars& s, float& lr,
                                             float& bc1, float& bc2) {
  lr = s.lr;
  if (s.decay_on) {
    const int eff = s.step < s.decay_end ? s.step : s.decay_end;
    const int n = eff < s.decay_start
                      ? 0 : (eff - s.decay_start) / s.decay_interval + 1;
    lr = __fmul_rn(lr, powf(s.decay_base, (float)n));
  }
  bc1 = __fsub_rn(1.0f, powf(s.b1, (float)s.step));
  bc2 = __fsub_rn(1.0f, powf(s.b2, (float)s.step));
}

__device__ __forceinline__ float4 load4(const float* a, long long vi,
                                        long long n, bool vec) {
  const long long i = 4 * vi;
  if (vec && i + 4 <= n) return reinterpret_cast<const float4*>(a)[vi];
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  r.x = a[i];
  if (i + 1 < n) r.y = a[i + 1];
  if (i + 2 < n) r.z = a[i + 2];
  if (i + 3 < n) r.w = a[i + 3];
  return r;
}

__device__ __forceinline__ void store4(float* a, long long vi, long long n,
                                       bool vec, float4 x) {
  const long long i = 4 * vi;
  if (vec && i + 4 <= n) {
    reinterpret_cast<float4*>(a)[vi] = x;
    return;
  }
  a[i] = x.x;
  if (i + 1 < n) a[i + 1] = x.y;
  if (i + 2 < n) a[i + 2] = x.z;
  if (i + 3 < n) a[i + 3] = x.w;
}

// one entry, in the eager update's order of operations; the skip keeps p,
// m and v where g_raw == 0 (-0.0 included; NaN counts as touched)
__device__ __forceinline__ void adam_entry(const AdamScalars& s, bool dense,
                                           bool l2, float lr, float bc1,
                                           float bc2, float g_raw, float& p,
                                           float& m, float& v) {
  float g = __fmul_rn(g_raw, s.inv_ls);
  if (l2) g = __fadd_rn(g, __fmul_rn(p, s.l2));
  const float m_new = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  const float v_new = __fadd_rn(__fmul_rn(v, s.b2),
                                __fmul_rn(__fmul_rn(g, s.omb2), g));
  const float mhat = __fdiv_rn(m_new, bc1);
  const float vhat = __fdiv_rn(v_new, bc2);
  const float p_new = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(lr, mhat), __fadd_rn(__fsqrt_rn(vhat), s.eps)));
  if (dense || g_raw != 0.0f) {
    p = p_new;
    m = m_new;
    v = v_new;
  }
}

__device__ __forceinline__ bool touched(float4 g) {
  return g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const __grid_constant__ AdamTable tab) {
  const long long b = blockIdx.x;
  int k = 0;
  while (k + 1 < tab.n_tensors && tab.t[k + 1].block0 <= b) ++k;
  const AdamTensor& t = tab.t[k];
  const AdamScalars& s = tab.s;
  const bool vec = t.aligned, dense = t.dense, l2 = t.l2;
  const long long n_vec = (t.n + 3) / 4;
  const long long first = (b - t.block0) * kVecsPerBlock + threadIdx.x;

  float4 g[kVecs];
  bool any = dense;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long vi = first + (long long)j * kThreads;
    g[j] = vi < n_vec ? load4(t.g, vi, t.n, vec)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    any = any || touched(g[j]);
  }
  if (!any && t.ema == kEmaNone) return;
  float lr = 0.0f, bc1 = 1.0f, bc2 = 1.0f;
  if (any) step_scalars(s, lr, bc1, bc2);

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long vi = first + (long long)j * kThreads;
    if (vi >= n_vec) break;
    float4 p;
    const bool upd = dense || touched(g[j]);
    if (upd) {
      p = load4(t.p, vi, t.n, vec);
      float4 m = load4(t.m, vi, t.n, vec);
      float4 v = load4(t.v, vi, t.n, vec);
      adam_entry(s, dense, l2, lr, bc1, bc2, g[j].x, p.x, m.x, v.x);
      adam_entry(s, dense, l2, lr, bc1, bc2, g[j].y, p.y, m.y, v.y);
      adam_entry(s, dense, l2, lr, bc1, bc2, g[j].z, p.z, m.z, v.z);
      adam_entry(s, dense, l2, lr, bc1, bc2, g[j].w, p.w, m.w, v.w);
      store4(t.p, vi, t.n, vec, p);
      store4(t.m, vi, t.n, vec, m);
      store4(t.v, vi, t.n, vec, v);
    }
    if (t.ema == kEmaNone) continue;
    if (!upd) p = load4(t.p, vi, t.n, vec);
    if (t.ema == kEmaDecay) {
      float4 e = load4(t.e, vi, t.n, vec);
      e.x = __fadd_rn(__fmul_rn(e.x, s.ema_d), __fmul_rn(p.x, s.ema_omd));
      e.y = __fadd_rn(__fmul_rn(e.y, s.ema_d), __fmul_rn(p.y, s.ema_omd));
      e.z = __fadd_rn(__fmul_rn(e.z, s.ema_d), __fmul_rn(p.z, s.ema_omd));
      e.w = __fadd_rn(__fmul_rn(e.w, s.ema_d), __fmul_rn(p.w, s.ema_omd));
      store4(t.e, vi, t.n, vec, e);
    } else {
      store4(t.e, vi, t.n, vec, p);
    }
  }
}

}  // namespace

// One Adam step over n_tensors (1..kMaxTensors) tensors, launched on
// `stream` over `blocks` blocks; `tensors` (n_tensors AdamTensor) and
// `scalars` (one AdamScalars) are host memory, passed untyped so that the
// C interface names no type of this file's (they travel in the kernel's
// parameters), the tensors device memory, contiguous and f32. Returns the
// cudaError_t of the launch; 0 on success.
extern "C" int ngp_fused_adam(const void* tensors, int n_tensors,
                              const void* scalars, long long blocks,
                              void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || blocks < 1 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  AdamTable tab;
  memset(&tab, 0, sizeof(tab));
  memcpy(tab.t, tensors, sizeof(AdamTensor) * n_tensors);
  memcpy(&tab.s, scalars, sizeof(AdamScalars));
  tab.n_tensors = n_tensors;
  fused_adam_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(tab);
  return (int)cudaGetLastError();
}
