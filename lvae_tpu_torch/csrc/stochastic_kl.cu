// Fused sample + KL for one Gaussian latent layer: forward and backward.
//
// Replaces lvae_tpu/kernels/stochastic_pallas.py:
//   K2      _run_fwd (:149), bodies _fwd_kernel (:63, on-core PRNG) and
//           _fwd_eps_kernel (:93, given eps): z and the elementwise KL map;
//   K1      _run_fwd_reduced (:318), bodies _fwd_reduce_kernel (:237) and
//           _fwd_reduce_eps_kernel (:265): z and the KL summed per row [B];
//   K2-bwd  _run_bwd (:178), body _bwd_kernel (:103);
//   K1-bwd  _run_bwd_reduced (:350), body _bwd_reduce_kernel (:283): as
//           K2-bwd with the KL cotangent given per row and broadcast.
// Per element:
//   eps = sqrt(-2 ln u1) cos(2 pi u2)      (Philox4x32-10, Box-Muller)
//   z   = mu_q + exp(lv_q / 2) eps
//   kl  = (exp(lv_q - lv_p) + (mu_q - mu_p)^2 exp(-lv_p) - 1 - lv_q + lv_p) / 2
// and backward, with d = mu_q - mu_p, r = exp(lv_q - lv_p):
//   dmu_q = gz + gkl d exp(-lv_p)          dmu_p = -gkl d exp(-lv_p)
//   dlv_q = gz exp(lv_q / 2) eps / 2 + gkl (r - 1) / 2
//   dlv_p = gkl (1 - r - d^2 exp(-lv_p)) / 2
//
// Layout: q and p are the conv heads' NCHW [rows, 2c, h, w] outputs, read
// in place (mu = channels [0, c), log-variance = [c, 2c)), so splitting
// the heads copies nothing. p has its own row stride: the top layer's
// learned prior [1, 2c, h, w] is read with stride 0, never broadcast in
// memory. z and kl are [rows, c, h, w]; the per-row KL is [rows]. The
// backward writes dq as [rows, 2c, h, w], the layout of the heads'
// gradients, and dp likewise, or, for a stride-0 prior, as [1, 2c, h, w]:
// its gradient summed over the rows in the kernel.
//
// Noise: counter (offset in the image's [c, h, w] map, index[row],
// sample[row], stream word), key = the two words of the 64-bit seed, the
// uniforms are the top 24 bits + 1 over 2^24. lvae_tpu_torch/ops/philox.py
// is the same generator in plain PyTorch, so both give the same eps.
//
// eps in the backward: REGENERATED from the Philox counter, not recovered
// from z as lvae_tpu's VJP does (stochastic_pallas.py:382, :435): the
// value is the forward's exactly, where (z - mu) exp(-lv/2) would lose the
// low bits of eps wherever |mu| >> sigma. The given-eps entry points take
// eps as an operand in both directions.
//
// What bounds them. Per element the forward reads 16 B (q and p) and
// writes 4 B (K1: z) or 8 B (K2: z, kl); the backward reads 20 B (q, p,
// gz; p once per row of its own) and writes 16 B (dq, dp). With keyed
// noise each element also costs a Philox4x32-10 call (~70 integer
// operations), accurate logf, cosf and sqrtf, and three or four expf,
// ~200 instructions under -fmad=false: over celeba64's 1.39M latent
// elements per step that is ~0.010 ms of instruction issue on an H100,
// beside ~0.008 ms of bytes for K1 and ~0.015 ms for K1-bwd. At the
// flagship's shapes (172k elements) a launch is a few microseconds,
// bound by its latency.
//
// Design.
// - K2 (and K2's map): one thread per element in a grid-stride loop.
// - K1: a launch plan from kernels/stochastic.py k1_plan, which the C side
//   checks against the shape. A row goes to one CTA of up to 512 threads,
//   each taking ceil(units / 512) units of the row or fewer. A unit is 4
//   consecutive elements (float4 loads of q's and p's planes and a float4 store of z)
//   where the row is longer than 2,048 elements, c h w % 4 == 0 and the
//   planes are 16-byte aligned, else 1 element, so that a short row
//   spreads over more threads. A thread issues its next unit's loads
//   before this unit's noise and KL math.
//   The row sum is deterministic without atomics: each thread sums in
//   fp64 in element order, a fixed warp-shuffle tree adds the threads,
//   and warp 0 adds the warps in a fixed tree. A relaunch is bit-equal
//   and a resumed run matches an uninterrupted one.
//   Unlike the TPU kernel, which folds partial sums into [B, 128] lanes
//   and so needs F % 128 == 0 (lvae_tpu falls back to K2 + a sum
//   otherwise), it takes any F. On an H100 a row spread over a thread
//   block cluster ran slower at the models' sizes than one CTA per row.
// - K1-bwd and K2-bwd: a launch plan from kernels/stochastic.py
//   k1_bwd_plan, a grid over (row group, slice of the row), so a thread
//   knows its row and offset from its block's indices: no element
//   divides by the row length. A thread takes one unit (4 consecutive
//   elements as float4 from 2^18 elements a launch, else 1) of one row,
//   reads gkl[row] once (K1-bwd) and regenerates eps from the counter.
//   For a stride-0 prior, one CTA takes all the rows of a slice of 2
//   elements: each thread loads the prior's elements once, walks every
//   ry-th row, sums dp in fp64 in row order, and the CTA adds its
//   threads' sums over the rows in a fixed tree in shared memory and
//   writes dp [1, 2c, h, w]: no [rows, 2c, h, w] dp is written, no second
//   launch sums it, and no sum crosses CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using lvae::philox4x32_10;

constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;        // K2
constexpr int kK1MaxThreads = 512;   // kernels/stochastic.py K1_MAX_THREADS
constexpr int kBwdMaxThreads = 256;  // kernels/stochastic.py BWD_MAX_THREADS
constexpr int kSumMaxThreads = 512;  // ... SUM_MAX_THREADS: the prior's sum

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (static_cast<float>(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
}

// Where a row's noise comes from: a given eps map, or the keyed Philox
// counter (offset, index[row], sample[row] or sample_word, stream_word).
struct Noise {
  const float* eps;            // given eps [rows, per_row], or null
  const long long* index;      // [rows]
  const long long* sample;     // [rows], or null for sample_word
  uint32_t sample_word, k0, k1, stream_word;

  // the row's two counter words, read once per row
  __device__ __forceinline__ uint2 row(long long b) const {
    return make_uint2(static_cast<uint32_t>(index[b]),
                      sample ? static_cast<uint32_t>(sample[b]) : sample_word);
  }

  __device__ __forceinline__ float draw(uint2 words, long long r) const {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(r), words.x, words.y, stream_word), k0, k1);
    const float u1 = uniform24(w.x), u2 = uniform24(w.y);
    return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
  }

  __device__ __forceinline__ float at(long long b, long long r, long long e) const {
    if (eps) return eps[e];
    return draw(row(b), r);
  }
};

// Same operation order as the plain PyTorch versions in
// kernels/stochastic.py; built with -fmad=false, so each step rounds where
// PyTorch's does.
__device__ __forceinline__ float kl_term(float qmu, float qlv, float pmu, float plv) {
  const float d = qmu - pmu;
  return 0.5f * (expf(qlv - plv) + d * d * expf(-plv) - 1.0f - qlv + plv);
}

// V consecutive floats: one 16-byte access where V is 4
template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = src[j];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = v[j];
  }
}

// K2: z and the elementwise KL map.
__global__ void sample_kl_kernel(const float* __restrict__ q, const float* __restrict__ p,
                                 long long p_row_stride, Noise noise,
                                 float* __restrict__ z, float* __restrict__ kl,
                                 long long rows, long long per_row) {
  const long long n = rows * per_row;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += step) {
    const long long b = e / per_row;
    const long long r = e - b * per_row;
    const float* qr = q + b * 2 * per_row;
    const float* pr = p + b * p_row_stride;
    const float qmu = qr[r], qlv = qr[r + per_row];
    z[e] = qmu + expf(0.5f * qlv) * noise.at(b, r, e);
    kl[e] = kl_term(qmu, qlv, pr[r], pr[r + per_row]);
  }
}

// K1's launch (kernels/stochastic.py K1Plan): row b is CTA b; its thread
// t takes the units i threads + t of the row, i < per_thread.
struct K1Plan {
  long long rows;
  int per_row;      // c h w
  int vec;          // elements per unit: 4 (float4) or 1
  int threads;      // per CTA
  int per_thread;   // units per thread, at most
};

struct K1Args {
  const float* q;
  const float* p;
  long long p_row_stride;
  Noise noise;
  float* z;
  float* kl_rows;
  K1Plan plan;
};

// The CTA's sum of one double per thread, in thread 0: a fixed
// shuffle tree within each warp, then warp 0 over the warps' sums.
__device__ __forceinline__ double cta_sum(double v, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, o);
  }
  return s;
}

// One K1 unit's operands: q's and p's planes, and eps where it is given.
template <int V>
struct K1Unit {
  float qmu[V], qlv[V], pmu[V], plv[V], eps[V];
};

template <int V>
__device__ __forceinline__ void load_unit(const float* qr, const float* pr, const float* er,
                                          int per_row, int r, K1Unit<V>& x) {
  load_v<V>(qr + r, x.qmu);
  load_v<V>(qr + per_row + r, x.qlv);
  load_v<V>(pr + r, x.pmu);
  load_v<V>(pr + per_row + r, x.plv);
  if (er) load_v<V>(er + r, x.eps);
}

// K1: z and the KL summed over the row; a CTA per row.
template <int V>
__global__ void __launch_bounds__(kK1MaxThreads) sample_kl_rows_kernel(const K1Args a) {
  __shared__ double warp_sums[32];
  const K1Plan& pl = a.plan;
  const long long b = blockIdx.x;
  const int per_row = pl.per_row, units = per_row / V;
  const float* qr = a.q + b * 2 * per_row;
  const float* pr = a.p + b * a.p_row_stride;
  float* zr = a.z + b * per_row;
  const float* er = a.noise.eps ? a.noise.eps + b * per_row : nullptr;
  const uint2 words = er ? make_uint2(0u, 0u) : a.noise.row(b);
  // this thread's units: first + i threads, i < n
  const int first = static_cast<int>(threadIdx.x);
  const int n = first < units ? min(pl.per_thread, (units - first + pl.threads - 1) / pl.threads)
                              : 0;
  double acc = 0.0;
  K1Unit<V> cur, next;
  if (n > 0) load_unit<V>(qr, pr, er, per_row, first * V, cur);
  for (int i = 0; i < n; ++i) {
    const int r = (first + i * pl.threads) * V;
    // the next unit's loads go out before this unit's noise and KL math
    if (i + 1 < n) load_unit<V>(qr, pr, er, per_row, r + pl.threads * V, next);
    float eps[V], z[V];
#pragma unroll
    for (int j = 0; j < V; ++j) eps[j] = er ? cur.eps[j] : a.noise.draw(words, r + j);
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = cur.qmu[j] + expf(0.5f * cur.qlv[j]) * eps[j];
    store_v<V>(zr + r, z);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc += static_cast<double>(kl_term(cur.qmu[j], cur.qlv[j], cur.pmu[j], cur.plv[j]));
    }
    if (i + 1 < n) cur = next;
  }
  const double s = cta_sum(acc, warp_sums);
  if (threadIdx.x == 0) a.kl_rows[b] = static_cast<float>(s);
}

// The backward's launch (kernels/stochastic.py BwdPlan): the grid is
// (row groups, slices of px units of the row); a CTA is px threads along
// the row (one unit each) by ry across the rows. Thread (tx, ty) takes
// unit slice px + tx of row group ry + ty; with prior_sum (p one row read
// with stride 0, dp summed over the rows) there is one row group, and the
// thread takes rows ty, ty + ry, ... of all the rows.
struct BwdPlan {
  long long rows;
  int per_row;
  int vec;
  int px;
  int ry;
  int prior_sum;
};

struct BwdArgs {
  const float* q;
  const float* p;
  long long p_row_stride;
  Noise noise;
  const float* gz;
  const float* gkl;
  float* dq;
  float* dp;
  BwdPlan plan;
};

// K2-bwd (kPerRow false: gkl [rows, per_row]) and K1-bwd (kPerRow true:
// gkl [rows], broadcast over the row); kPriorSum: dp summed over the rows
// (units of one element).
template <bool kPerRow, int V, bool kPriorSum>
__global__ void __launch_bounds__(kPriorSum ? kSumMaxThreads : kBwdMaxThreads)
    sample_kl_bwd_kernel(const BwdArgs a) {
  static_assert(!kPriorSum || V == 1, "the prior's sum takes units of one element");
  const BwdPlan& pl = a.plan;
  const int per_row = pl.per_row;
  const int tx = static_cast<int>(threadIdx.x) % pl.px, ty = static_cast<int>(threadIdx.x) / pl.px;
  // the slice of the row: blockIdx.y, or with kPriorSum (one row group)
  // blockIdx.x
  const int u = static_cast<int>(kPriorSum ? blockIdx.x : blockIdx.y) * pl.px + tx;
  const bool live = u < per_row / V;
  const int r = u * V;
  float pmu[V], plv[V];
  double sum_mu = 0.0, sum_lv = 0.0;
  if (kPriorSum && live) {
    load_v<V>(a.p + r, pmu);
    load_v<V>(a.p + per_row + r, plv);
  }
  // one row per thread, or with kPriorSum rows ty, ty + ry, ...
  const long long first = kPriorSum ? ty : static_cast<long long>(blockIdx.x) * pl.ry + ty;
  const long long step = kPriorSum ? pl.ry : pl.rows;
  for (long long b = first; live && b < pl.rows; b += step) {
    const float* qr = a.q + b * 2 * per_row;
    const long long e = b * per_row + r;
    float qmu[V], qlv[V], g_z[V], g_kl[V], eps[V];
    load_v<V>(qr + r, qmu);
    load_v<V>(qr + per_row + r, qlv);
    load_v<V>(a.gz + e, g_z);
    if (!kPriorSum) {
      const float* pr = a.p + b * a.p_row_stride;
      load_v<V>(pr + r, pmu);
      load_v<V>(pr + per_row + r, plv);
    }
    if (kPerRow) {
      const float g = a.gkl[b];
#pragma unroll
      for (int j = 0; j < V; ++j) g_kl[j] = g;
    } else {
      load_v<V>(a.gkl + e, g_kl);
    }
    if (a.noise.eps) {
      load_v<V>(a.noise.eps + e, eps);
    } else {
      const uint2 words = a.noise.row(b);
#pragma unroll
      for (int j = 0; j < V; ++j) eps[j] = a.noise.draw(words, r + j);
    }
    float dqmu[V], dqlv[V], dpmu[V], dplv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float diff = qmu[j] - pmu[j];
      const float inv_pvar = expf(-plv[j]);
      const float var_ratio = expf(qlv[j] - plv[j]);
      const float sigma_q = expf(0.5f * qlv[j]);
      dqmu[j] = g_z[j] + g_kl[j] * diff * inv_pvar;
      dqlv[j] = g_z[j] * 0.5f * sigma_q * eps[j] + g_kl[j] * 0.5f * (var_ratio - 1.0f);
      dpmu[j] = -g_kl[j] * diff * inv_pvar;
      dplv[j] = g_kl[j] * 0.5f * (1.0f - var_ratio - diff * diff * inv_pvar);
    }
    float* dqr = a.dq + b * 2 * per_row;
    store_v<V>(dqr + r, dqmu);
    store_v<V>(dqr + per_row + r, dqlv);
    if (kPriorSum) {
      sum_mu += static_cast<double>(dpmu[0]);
      sum_lv += static_cast<double>(dplv[0]);
    } else {
      float* dpr = a.dp + b * 2 * per_row;
      store_v<V>(dpr + r, dpmu);
      store_v<V>(dpr + per_row + r, dplv);
    }
  }
  if constexpr (kPriorSum) {
    // the threads' sums of each unit added over ty in a fixed tree (ry a
    // power of 2): no atomics, the same bits at every launch
    __shared__ double part[kSumMaxThreads][2];
    part[threadIdx.x][0] = sum_mu;
    part[threadIdx.x][1] = sum_lv;
    __syncthreads();
    for (int half = pl.ry / 2; half > 0; half /= 2) {
      if (ty < half) {
        part[threadIdx.x][0] += part[threadIdx.x + half * pl.px][0];
        part[threadIdx.x][1] += part[threadIdx.x + half * pl.px][1];
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
      a.dp[r] = static_cast<float>(part[threadIdx.x][0]);
      a.dp[per_row + r] = static_cast<float>(part[threadIdx.x][1]);
    }
  }
}

unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

Noise keyed(const void* index, const void* sample, unsigned int sample_word,
            unsigned long long seed, unsigned int stream_word, const void* eps) {
  return Noise{static_cast<const float*>(eps), static_cast<const long long*>(index),
               static_cast<const long long*>(sample), sample_word,
               static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
               stream_word};
}

Noise given(const void* eps) {
  return Noise{static_cast<const float*>(eps), nullptr, nullptr, 0u, 0u, 0u, 0u};
}

bool misaligned(const void* ptr) {
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// a K1 plan that covers the shape (kernels/stochastic.py k1_plan makes
// only these): every unit of the row in its CTA
bool bad_k1_plan(const K1Plan& p, long long rows, long long per_row) {
  if (p.rows != rows || p.per_row != per_row || per_row < 1 || per_row > 0x3FFFFFFFLL) return true;
  if ((p.vec != 1 && p.vec != 4) || per_row % p.vec != 0) return true;
  if (p.threads < 32 || p.threads > kK1MaxThreads || p.threads % 32 != 0 || p.per_thread < 1) {
    return true;
  }
  return static_cast<long long>(p.threads) * p.per_thread < per_row / p.vec || rows > 0x7FFFFFFFLL;
}

// a backward plan that covers the shape (kernels/stochastic.py
// k1_bwd_plan makes only these)
bool bad_bwd_plan(const BwdPlan& p, long long rows, long long per_row, bool prior_sum) {
  if (p.rows != rows || p.per_row != per_row || per_row < 1 || per_row > 0x3FFFFFFFLL) return true;
  if ((p.vec != 1 && p.vec != 4) || per_row % p.vec != 0) return true;
  const int threads = p.px * p.ry;
  if (p.px < 1 || p.ry < 1 || threads % 32 != 0 || p.prior_sum != (prior_sum ? 1 : 0)) {
    return true;
  }
  const long long slices = (per_row / p.vec + p.px - 1) / p.px;
  if (prior_sum) {
    return p.vec != 1 || threads > kSumMaxThreads || (p.ry & (p.ry - 1)) != 0 ||
           slices > 0x7FFFFFFFLL;
  }
  return threads > kBwdMaxThreads || slices > 65535 || (rows + p.ry - 1) / p.ry > 0x7FFFFFFFLL;
}

// a launch of one of the kernels above; its status
template <typename Args>
int launch(void (*fn)(Args), dim3 grid, int threads, const Args& args, cudaStream_t s) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, args);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// sample: int64 [rows] per-row sample words, or null to give every row
// sample_word
extern "C" int lvae_sample_kl(const void* q, const void* p, long long p_row_stride,
                              const void* index, const void* sample,
                              unsigned int sample_word,
                              unsigned long long seed, unsigned int stream_word,
                              void* z, void* kl, long long rows, int c, int hw,
                              void* stream) {
  const long long per_row = static_cast<long long>(c) * hw;
  const long long n = rows * per_row;
  if (n == 0) return 0;
  sample_kl_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
      keyed(index, sample, sample_word, seed, stream_word, nullptr),
      static_cast<float*>(z), static_cast<float*>(kl), rows, per_row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lvae_sample_kl_eps(const void* q, const void* p, long long p_row_stride,
                                  const void* eps, void* z, void* kl, long long rows,
                                  int c, int hw, void* stream) {
  const long long per_row = static_cast<long long>(c) * hw;
  const long long n = rows * per_row;
  if (n == 0) return 0;
  sample_kl_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
      given(eps), static_cast<float*>(z), static_cast<float*>(kl), rows, per_row);
  return static_cast<int>(cudaGetLastError());
}

// K1 with the plan (kernels/stochastic.py K1Plan); eps null draws keyed
// noise, else reads the given eps. Operands 16-byte aligned where the
// plan's vec is 4.
extern "C" int lvae_sample_kl_per_sample(const void* plan, const void* q, const void* p,
                                         long long p_row_stride, const void* index,
                                         const void* sample, unsigned int sample_word,
                                         unsigned long long seed,
                                         unsigned int stream_word, const void* eps,
                                         void* z, void* kl_rows, long long rows, int c,
                                         int hw, void* stream) {
  if (rows == 0) return 0;
  const K1Plan& pl = *static_cast<const K1Plan*>(plan);
  if (bad_k1_plan(pl, rows, static_cast<long long>(c) * hw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pl.vec == 4 && (misaligned(q) || misaligned(p) || misaligned(eps) || misaligned(z))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const K1Args a{static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
                 keyed(index, sample, sample_word, seed, stream_word, eps),
                 static_cast<float*>(z), static_cast<float*>(kl_rows), pl};
  auto fn = pl.vec == 4 ? sample_kl_rows_kernel<4> : sample_kl_rows_kernel<1>;
  return launch(fn, dim3(static_cast<unsigned>(rows)), pl.threads, a,
                static_cast<cudaStream_t>(stream));
}

// K2-bwd (per_row_gkl 0: gkl is [rows, c, h, w]) and K1-bwd (per_row_gkl
// 1: gkl is [rows]) with the plan (kernels/stochastic.py BwdPlan); eps
// null regenerates the keyed noise. dp is [1, 2c, h, w], summed over the
// rows, where p_row_stride is 0, else [rows, 2c, h, w].
static int launch_bwd(bool per_row_gkl, const void* plan, const void* q, const void* p,
                      long long p_row_stride, const void* index, const void* sample,
                      unsigned int sample_word, unsigned long long seed,
                      unsigned int stream_word, const void* eps, const void* gz,
                      const void* gkl, void* dq, void* dp, long long rows, int c, int hw,
                      void* stream) {
  if (rows == 0) return 0;
  const BwdPlan& pl = *static_cast<const BwdPlan*>(plan);
  const bool sum = p_row_stride == 0;
  if (bad_bwd_plan(pl, rows, static_cast<long long>(c) * hw, sum)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pl.vec == 4 && (misaligned(q) || misaligned(p) || misaligned(eps) || misaligned(gz) ||
                      (!per_row_gkl && misaligned(gkl)) || misaligned(dq) || misaligned(dp))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
                  keyed(index, sample, sample_word, seed, stream_word, eps),
                  static_cast<const float*>(gz), static_cast<const float*>(gkl),
                  static_cast<float*>(dq), static_cast<float*>(dp), pl};
  const long long units = pl.per_row / pl.vec;
  const unsigned slices = static_cast<unsigned>((units + pl.px - 1) / pl.px);
  const dim3 grid = sum ? dim3(slices) : dim3(static_cast<unsigned>((rows + pl.ry - 1) / pl.ry),
                                              slices);
  void (*fn)(BwdArgs);
  if (sum) {
    fn = per_row_gkl ? sample_kl_bwd_kernel<true, 1, true> : sample_kl_bwd_kernel<false, 1, true>;
  } else if (per_row_gkl) {
    fn = pl.vec == 4 ? sample_kl_bwd_kernel<true, 4, false> : sample_kl_bwd_kernel<true, 1, false>;
  } else {
    fn = pl.vec == 4 ? sample_kl_bwd_kernel<false, 4, false> : sample_kl_bwd_kernel<false, 1, false>;
  }
  return launch(fn, grid, pl.px * pl.ry, a, static_cast<cudaStream_t>(stream));
}

extern "C" int lvae_sample_kl_bwd(const void* plan, const void* q, const void* p,
                                  long long p_row_stride, const void* index, const void* sample,
                                  unsigned int sample_word, unsigned long long seed,
                                  unsigned int stream_word, const void* eps,
                                  const void* gz, const void* gkl, void* dq, void* dp,
                                  long long rows, int c, int hw, void* stream) {
  return launch_bwd(false, plan, q, p, p_row_stride, index, sample, sample_word, seed,
                    stream_word, eps, gz, gkl, dq, dp, rows, c, hw, stream);
}

extern "C" int lvae_sample_kl_per_sample_bwd(const void* plan, const void* q, const void* p,
                                             long long p_row_stride, const void* index,
                                             const void* sample, unsigned int sample_word,
                                             unsigned long long seed,
                                             unsigned int stream_word, const void* eps,
                                             const void* gz, const void* gkl_rows,
                                             void* dq, void* dp, long long rows, int c,
                                             int hw, void* stream) {
  return launch_bwd(true, plan, q, p, p_row_stride, index, sample, sample_word, seed,
                    stream_word, eps, gz, gkl_rows, dq, dp, rows, c, hw, stream);
}
