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
// backward writes dq and dp as [rows, 2c, h, w], the layout of the heads'
// gradients; for a stride-0 prior the caller sums dp over the rows.
//
// Noise: counter (offset in the image's [c, h, w] map, index[row],
// sample[row], stream word), key = the two words of the 64-bit seed, the
// uniforms are the top 24 bits + 1 over 2^24. lvae_tpu_torch/ops/philox.py
// is the same generator in plain PyTorch, so both give the same eps.
//
// eps in the backward: REGENERATED from the Philox counter, not recovered
// from z as lvae_tpu's VJP does (stochastic_pallas.py:382, :435). Ten
// rounds of integer multiplies per element cost less than reading z back,
// the value is the forward's exactly, and (z - mu) exp(-lv/2) would lose
// the low bits of eps wherever |mu| >> sigma. The given-eps entry points
// take eps as an operand in both directions.
//
// Per-row KL: one block per row; each thread sums its strided elements in
// fp64 in a fixed order, then a fixed tree in shared memory adds the 256
// partial sums. No atomics, so two launches give bit-equal sums and a
// resumed run matches an uninterrupted one. Unlike the TPU kernel, which
// folds partial sums into [B, 128] lanes over a (B/bb, F/fb) grid and so
// needs F % 128 == 0 (lvae_tpu falls back to K2 + a sum otherwise), this
// kernel takes any F = c h w.
//
// Bound: device memory. Forward 16 B read and 8 B (K2) or 4 B (K1) written
// per element; backward 20-24 B read and 16 B written, against ~40 flops,
// three or four exp and, for keyed noise, log/cos/sqrt and ten Philox
// rounds. At the flagship's B=64 training shapes (131k, 33k, 8k elements
// per layer) every launch is a few microseconds, bound by launch latency.
// Design: one thread per element (grid-stride loop) for the elementwise
// kernels and one block per row for K1; neighbouring threads read and
// write neighbouring addresses of every plane, so all accesses coalesce;
// the noise is made in registers and never stored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using lvae::philox4x32_10;

constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;

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

  __device__ __forceinline__ float at(long long b, long long r, long long e) const {
    if (eps) return eps[e];
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(index[b]),
                   sample ? static_cast<uint32_t>(sample[b]) : sample_word,
                   stream_word),
        k0, k1);
    const float u1 = uniform24(w.x), u2 = uniform24(w.y);
    return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
  }
};

// Same operation order as the plain PyTorch versions in
// kernels/stochastic.py; built with -fmad=false, so each step rounds where
// PyTorch's does.
__device__ __forceinline__ float kl_term(float qmu, float qlv, float pmu, float plv) {
  const float d = qmu - pmu;
  return 0.5f * (expf(qlv - plv) + d * d * expf(-plv) - 1.0f - qlv + plv);
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

// K1: z and the KL summed over the row; one block per row.
__global__ void sample_kl_rows_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      long long p_row_stride, Noise noise,
                                      float* __restrict__ z,
                                      float* __restrict__ kl_rows, long long per_row) {
  __shared__ double partial[kThreads];
  const long long b = blockIdx.x;
  const float* qr = q + b * 2 * per_row;
  const float* pr = p + b * p_row_stride;
  double acc = 0.0;
  for (long long r = threadIdx.x; r < per_row; r += kThreads) {
    const float qmu = qr[r], qlv = qr[r + per_row];
    const long long e = b * per_row + r;
    z[e] = qmu + expf(0.5f * qlv) * noise.at(b, r, e);
    acc += static_cast<double>(kl_term(qmu, qlv, pr[r], pr[r + per_row]));
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) kl_rows[b] = static_cast<float>(partial[0]);
}

// K2-bwd (kPerRow false: gkl [rows, per_row]) and K1-bwd (kPerRow true:
// gkl [rows], broadcast over the row).
template <bool kPerRow>
__global__ void sample_kl_bwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                                     long long p_row_stride, Noise noise,
                                     const float* __restrict__ gz,
                                     const float* __restrict__ gkl,
                                     float* __restrict__ dq, float* __restrict__ dp,
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
    const float pmu = pr[r], plv = pr[r + per_row];
    const float eps = noise.at(b, r, e);
    const float g_z = gz[e];
    const float g_kl = kPerRow ? gkl[b] : gkl[e];

    const float diff = qmu - pmu;
    const float inv_pvar = expf(-plv);
    const float var_ratio = expf(qlv - plv);
    const float sigma_q = expf(0.5f * qlv);
    float* dqr = dq + b * 2 * per_row;
    float* dpr = dp + b * 2 * per_row;
    dqr[r] = g_z + g_kl * diff * inv_pvar;
    dqr[r + per_row] = g_z * 0.5f * sigma_q * eps + g_kl * 0.5f * (var_ratio - 1.0f);
    dpr[r] = -g_kl * diff * inv_pvar;
    dpr[r + per_row] = g_kl * 0.5f * (1.0f - var_ratio - diff * diff * inv_pvar);
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

// K1: eps null draws keyed noise, else reads the given eps
extern "C" int lvae_sample_kl_per_sample(const void* q, const void* p,
                                         long long p_row_stride, const void* index,
                                         const void* sample, unsigned int sample_word,
                                         unsigned long long seed,
                                         unsigned int stream_word, const void* eps,
                                         void* z, void* kl_rows, long long rows, int c,
                                         int hw, void* stream) {
  const long long per_row = static_cast<long long>(c) * hw;
  if (rows == 0) return 0;
  if (rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  sample_kl_rows_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
      keyed(index, sample, sample_word, seed, stream_word, eps),
      static_cast<float*>(z), static_cast<float*>(kl_rows), per_row);
  return static_cast<int>(cudaGetLastError());
}

// K2-bwd (per_row_gkl 0: gkl is [rows, c, h, w]) and K1-bwd (per_row_gkl
// 1: gkl is [rows]); eps null regenerates the keyed noise
static int launch_bwd(bool per_row_gkl, const void* q, const void* p,
                      long long p_row_stride, const void* index, const void* sample,
                      unsigned int sample_word, unsigned long long seed,
                      unsigned int stream_word, const void* eps, const void* gz,
                      const void* gkl, void* dq, void* dp, long long rows, int c, int hw,
                      void* stream) {
  const long long per_row = static_cast<long long>(c) * hw;
  const long long n = rows * per_row;
  if (n == 0) return 0;
  const Noise noise = keyed(index, sample, sample_word, seed, stream_word, eps);
  auto s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* pf = static_cast<const float*>(p);
  const float* gzf = static_cast<const float*>(gz);
  const float* gklf = static_cast<const float*>(gkl);
  if (per_row_gkl) {
    sample_kl_bwd_kernel<true><<<grid_for(n), kThreads, 0, s>>>(
        qf, pf, p_row_stride, noise, gzf, gklf, static_cast<float*>(dq),
        static_cast<float*>(dp), rows, per_row);
  } else {
    sample_kl_bwd_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
        qf, pf, p_row_stride, noise, gzf, gklf, static_cast<float*>(dq),
        static_cast<float*>(dp), rows, per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lvae_sample_kl_bwd(const void* q, const void* p, long long p_row_stride,
                                  const void* index, const void* sample,
                                  unsigned int sample_word, unsigned long long seed,
                                  unsigned int stream_word, const void* eps,
                                  const void* gz, const void* gkl, void* dq, void* dp,
                                  long long rows, int c, int hw, void* stream) {
  return launch_bwd(false, q, p, p_row_stride, index, sample, sample_word, seed,
                    stream_word, eps, gz, gkl, dq, dp, rows, c, hw, stream);
}

extern "C" int lvae_sample_kl_per_sample_bwd(const void* q, const void* p,
                                             long long p_row_stride, const void* index,
                                             const void* sample, unsigned int sample_word,
                                             unsigned long long seed,
                                             unsigned int stream_word, const void* eps,
                                             const void* gz, const void* gkl_rows,
                                             void* dq, void* dp, long long rows, int c,
                                             int hw, void* stream) {
  return launch_bwd(true, q, p, p_row_stride, index, sample, sample_word, seed,
                    stream_word, eps, gz, gkl_rows, dq, dp, rows, c, hw, stream);
}
