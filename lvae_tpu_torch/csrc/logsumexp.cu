// logsumexp over the importance-sample axis: [k, B] row-major -> [B].
//
// Replaces lvae_tpu/kernels/logsumexp_pallas.py: _lse_impl (:36) with its
// body _kernel (:25). Per column: the max over k; a non-finite max (an all
// -inf column, a +inf or a NaN) gives -inf, as the TPU kernel's guard
// (:31-33) does; otherwise max + log(sum exp(x - max)).
//
// Bound: device memory and, at the IW-LL's shape, launch latency. The
// flagship calls it once per test batch on [100, 1000] fp32 (400 KB,
// read twice: once for the max, once for the sum; the second read hits
// L2). Design: one thread per column, looping over the k rows, so at each
// j neighbouring threads read neighbouring addresses and every load is
// coalesced. Any B is taken without padding (the TPU kernel padded B to
// its 512-column block with -inf). With B=1000 only 4 blocks run: the
// kernel is microseconds against a k-forward batch of convolutions, so
// it is kept simple.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void logsumexp_kernel(const float* __restrict__ x, int k, long long b,
                                 float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       col < b; col += step) {
    float m = -INFINITY;
    bool has_nan = false;
    for (int j = 0; j < k; ++j) {
      const float v = x[j * b + col];
      has_nan |= isnan(v);
      m = fmaxf(m, v);
    }
    const bool finite = !has_nan && isfinite(m);
    const float safe_m = finite ? m : 0.0f;
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s += expf(x[j * b + col] - safe_m);
    out[col] = finite ? safe_m + logf(s) : -INFINITY;
  }
}

}  // namespace

extern "C" int lvae_logsumexp(const void* x, int k, long long b, void* out, void* stream) {
  if (b == 0) return 0;
  long long blocks = (b + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  logsumexp_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), k, b, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Shared by every entry point of the library: the wrappers turn a
// non-zero status into an exception carrying this text.
extern "C" const char* lvae_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
