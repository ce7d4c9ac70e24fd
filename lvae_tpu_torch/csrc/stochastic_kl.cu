// Fused sample + KL for one Gaussian latent layer (forward, eval path).
//
// Replaces lvae_tpu/kernels/stochastic_pallas.py: _run_fwd (:149) with its
// bodies _fwd_kernel (:63, on-core PRNG) and _fwd_eps_kernel (:93, given
// eps). Per element:
//   eps = sqrt(-2 ln u1) cos(2 pi u2)      (Philox4x32-10, Box-Muller)
//   z   = mu_q + exp(lv_q / 2) eps
//   kl  = (exp(lv_q - lv_p) + (mu_q - mu_p)^2 exp(-lv_p) - 1 - lv_q + lv_p) / 2
//
// Layout: q and p are the conv heads' NCHW [rows, 2c, h, w] outputs, read
// in place (mu = channels [0, c), log-variance = [c, 2c)), so splitting
// the heads copies nothing. p has its own row stride: the top layer's
// learned prior [1, 2c, h, w] is read with stride 0, never broadcast in
// memory. z and kl are [rows, c, h, w].
//
// Noise: counter (offset in the image's [c, h, w] map, index[row],
// sample[row], stream word), key = the two words of the 64-bit seed, the
// uniforms are the top 24 bits + 1 over 2^24. lvae_tpu_torch/ops/philox.py
// is the same generator in plain PyTorch, so both give the same eps.
//
// Bound: device memory. 16 B read and 8 B written per element, against
// ~40 flops and three transcendentals (exp, exp, exp) plus log/cos/sqrt
// and ten Philox rounds of integer multiplies. At the flagship's B=1000
// shapes (2.0M, 0.5M, 0.13M elements) the whole pass is 63 MB of traffic.
// Design: one thread per element in a grid-stride loop; neighbouring
// threads read neighbouring addresses of all four parameter planes and
// write neighbouring z / kl, so every access is coalesced; the noise is
// made in registers and never stored. The TPU kernel's (8,128) tiling and
// its padding to 1024-lane rows have no counterpart here: the kernel
// takes any shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (static_cast<float>(bits >> 8) + 1.0f) * (1.0f / 16777216.0f);
}

// Same operation order as the plain PyTorch version (_plain_sample_kl_eps
// in kernels/stochastic.py); built with -fmad=false, so each step rounds
// where PyTorch's does.
template <bool kGivenEps>
__global__ void sample_kl_kernel(const float* __restrict__ q,
                                 const float* __restrict__ p,
                                 long long p_row_stride,
                                 const long long* __restrict__ index,
                                 const long long* __restrict__ sample,
                                 uint32_t sample_word,
                                 const float* __restrict__ eps_in,
                                 uint32_t k0, uint32_t k1, uint32_t stream_word,
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
    const float pmu = pr[r], plv = pr[r + per_row];
    float eps;
    if (kGivenEps) {
      eps = eps_in[e];
    } else {
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(index[b]),
                     sample ? static_cast<uint32_t>(sample[b]) : sample_word,
                     stream_word),
          k0, k1);
      const float u1 = uniform24(w.x), u2 = uniform24(w.y);
      eps = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
    }
    z[e] = qmu + expf(0.5f * qlv) * eps;
    const float d = qmu - pmu;
    kl[e] = 0.5f * (expf(qlv - plv) + d * d * expf(-plv) - 1.0f - qlv + plv);
  }
}

unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
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
  sample_kl_kernel<false><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
      static_cast<const long long*>(index), static_cast<const long long*>(sample),
      sample_word, nullptr, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32),
      stream_word, static_cast<float*>(z), static_cast<float*>(kl), rows, per_row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lvae_sample_kl_eps(const void* q, const void* p, long long p_row_stride,
                                  const void* eps, void* z, void* kl, long long rows,
                                  int c, int hw, void* stream) {
  const long long per_row = static_cast<long long>(c) * hw;
  const long long n = rows * per_row;
  if (n == 0) return 0;
  sample_kl_kernel<true><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), p_row_stride,
      nullptr, nullptr, 0u, static_cast<const float*>(eps), 0u, 0u, 0u,
      static_cast<float*>(z), static_cast<float*>(kl), rows, per_row);
  return static_cast<int>(cudaGetLastError());
}
