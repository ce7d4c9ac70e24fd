// Train-mode [bits8 dropout ->] BatchNorm -> ELU/ReLU: forward and backward.
//
// Replaces lvae_tpu/kernels/segment_pallas.py:
//   K5      _segment_fwd_impl (:291) through _call (:270): _stats_kernel
//           (:125), the [C]-sized glue (:303-308), _apply_kernel (:148);
//   K5-bwd  _segment_bwd_impl (:318): _bwd_reduce_kernel (:163), the glue
//           (:335-339), _bwd_apply_kernel (:190).
// Entry fused_dropout_bn_act (:380). Plain PyTorch twin:
// lvae_tpu_torch/ops/math.py segment_forward / segment_backward.
//
// Per channel, with n = B H W and u = the dropped input (x scaled by 256/t
// where its byte < t, else 0; x itself when t >= 256):
//   mean = sum(u) / n,  var = sum(u^2) / n - mean^2 (biased, as flax),
//   r = 1 / sqrt(var + eps),  scale = gamma r,  shift = beta - mean scale,
//   y = act(u scale + shift)
// and backward from g, with z = u scale + shift, dz = g act'(z), xhat =
// (u - mean) r:
//   dbeta = sum(dz),  dgamma = sum(dz xhat),  m1 = dbeta / n,  m2 = dgamma / n
//   dx = [byte < t] (256/t) gamma r ((dz - m1) - xhat m2)
// which is the full train-mode BatchNorm backward with its batch-statistics
// terms; dx is exactly 0 at every dropped element. act is ELU (expm1f; the
// derivative expf) or ReLU (a compare); CUDA has expm1f, so the Mosaic
// series of segment_pallas.py:81-89 has no counterpart.
//
// Dropout bytes: element e (its flat NCHW index) takes byte e % 16 of
// Philox4x32-10 at counter (e / 16 low word, high word, 0, kStream) under
// the two words of the 64-bit seed: word (e % 16) / 4, bits 8 (e % 4) up.
// Every pass regenerates the bytes, so no mask is ever stored; the seed
// is mix_seed(train seed, step, dropout site), computed by the caller.
//
// Layout and design. The TPU kernel folds NHWC to [N/f, f C] rows for its
// 128 lanes and carries the sums across its sequential grid in place. On
// the card the port's maps are NCHW, so one channel is B strips of H W
// contiguous floats, and blocks run in no order. Every pass here uses one
// grid: channel x a fixed number of batch slices (chosen by the caller from
// the shape). A block walks its strips in units of 4 floats (a 16-byte
// load, and one Philox call per unit) where H W % 4 == 0 and the pointers
// are 16-byte aligned, else one float at a time. The reduce passes write
// one fp64 partial pair per block; a finalise kernel (one thread per
// channel) adds the partials in a fixed order, so there are no atomics and
// two launches are bit-equal. fp64: E[u^2] - mean^2 cancels in fp32 at
// n = 524,288 (celeba64's 64x64 maps). The forward's finalise also moves
// the running statistics (ra = m ra + (1 - m) stat, biased variance), so
// the caller has no [C]-sized launches left. Residuals are x and the [C]
// statistics: the backward recomputes u, z and act'(z) from x.
//
// Bound: device memory. The forward reads x twice and writes y (12 B per
// element), the backward reads x and g twice and writes dx (20 B); a
// one-pass kernel would move 8 and 12 B. At [128, 64, 64, 64] (134 MB per
// map) that is 0.12 ms forward and 0.20 ms backward at 3.35 TB/s, against
// one-pass floors of 0.08 and 0.12 ms. The generator costs ~70 integer
// operations per Philox call, one per 4 elements (4x the 16 bytes a call
// gives; the unit is 4 so that a channel of a 2x2 map still takes 16-byte
// loads), ~18 per element per pass.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 128;
constexpr uint32_t kStream = 0x80000005u;   // ops/philox.py STREAM_SEGMENT_DROPOUT

enum Act { kElu = 0, kRelu = 1 };

struct Drop {
  bool on;        // t < 256: a mask applies (t <= 0 drops everything)
  int t;
  float scale;    // 256 / t rounded to fp32 (0 when t <= 0)
  uint32_t k0, k1;
};

// The Philox word that holds the bytes of elements e & ~3 .. (e & ~3) + 3.
__device__ __forceinline__ uint32_t mask_word(const Drop& d, long long e) {
  const unsigned long long grp = static_cast<unsigned long long>(e) >> 4;
  const uint4 w = lvae::philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), static_cast<uint32_t>(grp >> 32), 0u, kStream),
      d.k0, d.k1);
  switch ((e >> 2) & 3) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
    default: return w.w;
  }
}

__device__ __forceinline__ bool kept(const Drop& d, uint32_t word, int j) {
  return static_cast<int>((word >> (8 * j)) & 255u) < d.t;
}

// u of one element: x where kept (scaled), 0 where dropped
__device__ __forceinline__ float dropped(const Drop& d, float v, bool keep) {
  if (!d.on) return v;
  return keep ? v * d.scale : 0.0f;
}

template <int kAct>
__device__ __forceinline__ float act(float z) {
  if constexpr (kAct == kElu) return z > 0.0f ? z : expm1f(z);
  return z > 0.0f ? z : 0.0f;
}

template <int kAct>
__device__ __forceinline__ float act_grad(float z) {
  if constexpr (kAct == kElu) return z > 0.0f ? 1.0f : expf(z);
  return z > 0.0f ? 1.0f : 0.0f;
}

// kVec consecutive floats at p (kVec = 4: one 16-byte access)
template <int kVec>
struct Vec {
  float v[kVec];
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    if constexpr (kVec == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ p) const {
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
};

// Calls f(e, keep[]) for every unit of kVec elements of channel blockIdx.x
// in batch slice blockIdx.y of `slices`; keep[j] is element e + j's mask
// (all true when no mask applies).
template <int kVec, typename F>
__device__ __forceinline__ void for_units(long long b, int c, long long hw, int slices,
                                          const Drop& d, F&& f) {
  const int ch = blockIdx.x;
  const long long b0 = b * blockIdx.y / slices, b1 = b * (blockIdx.y + 1) / slices;
  const unsigned per_row = static_cast<unsigned>(hw / kVec);
  const unsigned units = static_cast<unsigned>(b1 - b0) * per_row;
  for (unsigned u = threadIdx.x; u < units; u += blockDim.x) {
    const unsigned r = u / per_row;
    const long long e = ((b0 + r) * c + ch) * hw + static_cast<long long>(u - r * per_row) * kVec;
    bool keep[kVec];
    if (d.on) {
      const uint32_t word = mask_word(d, e);
#pragma unroll
      for (int j = 0; j < kVec; ++j) keep[j] = kept(d, word, static_cast<int>((e + j) & 3));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) keep[j] = true;
    }
    f(e, keep);
  }
}

// The block's two fp64 sums to partial[0][ch][slice], partial[1][ch][slice]
// (a fixed tree: the same order every launch).
__device__ __forceinline__ void block_partials(double s1, double s2, double* partial, int c,
                                               int slices) {
  __shared__ double sh[2][kThreads];
  sh[0][threadIdx.x] = s1;
  sh[1][threadIdx.x] = s2;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sh[0][threadIdx.x] += sh[0][threadIdx.x + s];
      sh[1][threadIdx.x] += sh[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long i = static_cast<long long>(blockIdx.x) * slices + blockIdx.y;
    partial[i] = sh[0][0];
    partial[static_cast<long long>(c) * slices + i] = sh[1][0];
  }
}

// K5 pass 1: sum(u), sum(u^2) per (channel, slice)
template <int kVec>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ x, long long b, int c, long long hw, int slices,
             Drop d, double* __restrict__ partial) {
  double s1 = 0.0, s2 = 0.0;
  for_units<kVec>(b, c, hw, slices, d, [&](long long e, const bool (&keep)[kVec]) {
    Vec<kVec> xv;
    xv.load(x + e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const double u = dropped(d, xv.v[j], keep[j]);
      s1 += u;
      s2 += u * u;
    }
  });
  block_partials(s1, s2, partial, c, slices);
}

// stats rows: mean, var, r, scale, shift (each [c])
__global__ void stats_final_kernel(const double* __restrict__ partial, int c, int slices,
                                   double n, double eps, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ stats,
                                   float* __restrict__ running_mean,
                                   float* __restrict__ running_var, float momentum,
                                   float one_minus_momentum) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double s1 = 0.0, s2 = 0.0;
  for (int s = 0; s < slices; ++s) {
    s1 += partial[static_cast<long long>(ch) * slices + s];
    s2 += partial[static_cast<long long>(c + ch) * slices + s];
  }
  const double mean_d = s1 / n;
  const double var_d = s2 / n - mean_d * mean_d;
  const float mean = static_cast<float>(mean_d);
  const float var = static_cast<float>(var_d);
  const float r = static_cast<float>(1.0 / sqrt(var_d + eps));
  const float scale = gamma[ch] * r;
  stats[ch] = mean;
  stats[c + ch] = var;
  stats[2 * c + ch] = r;
  stats[3 * c + ch] = scale;
  stats[4 * c + ch] = beta[ch] - mean * scale;
  if (running_mean != nullptr) {
    running_mean[ch] = momentum * running_mean[ch] + one_minus_momentum * mean;
    running_var[ch] = momentum * running_var[ch] + one_minus_momentum * var;
  }
}

// K5 pass 2: y = act(u scale + shift)
template <int kVec, int kAct>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ stats, long long b, int c,
             long long hw, int slices, Drop d, float* __restrict__ y) {
  const float scale = stats[3 * c + blockIdx.x], shift = stats[4 * c + blockIdx.x];
  for_units<kVec>(b, c, hw, slices, d, [&](long long e, const bool (&keep)[kVec]) {
    Vec<kVec> v;
    v.load(x + e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v.v[j] = act<kAct>(dropped(d, v.v[j], keep[j]) * scale + shift);
    }
    v.store(y + e);
  });
}

// the recomputed forward of one element: dz and xhat
struct Fwd {
  float mean, r, scale, shift;
};

template <int kAct>
__device__ __forceinline__ void dz_xhat(const Fwd& f, float u, float g, float& dz, float& xhat) {
  dz = g * act_grad<kAct>(u * f.scale + f.shift);
  xhat = (u - f.mean) * f.r;
}

__device__ __forceinline__ Fwd fwd_of(const float* __restrict__ stats, int c, int ch) {
  return Fwd{stats[ch], stats[2 * c + ch], stats[3 * c + ch], stats[4 * c + ch]};
}

// K5-bwd pass 1: sum(dz), sum(dz xhat) per (channel, slice)
template <int kVec, int kAct>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ stats, long long b, int c, long long hw,
                  int slices, Drop d, double* __restrict__ partial) {
  const Fwd f = fwd_of(stats, c, blockIdx.x);
  double s1 = 0.0, s2 = 0.0;
  for_units<kVec>(b, c, hw, slices, d, [&](long long e, const bool (&keep)[kVec]) {
    Vec<kVec> xv, gv;
    xv.load(x + e);
    gv.load(g + e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float dz, xhat;
      dz_xhat<kAct>(f, dropped(d, xv.v[j], keep[j]), gv.v[j], dz, xhat);
      s1 += static_cast<double>(dz);
      s2 += static_cast<double>(dz * xhat);
    }
  });
  block_partials(s1, s2, partial, c, slices);
}

// bstats rows: dgamma, dbeta, m1, m2, gamma r (each [c])
__global__ void bwd_final_kernel(const double* __restrict__ partial, int c, int slices,
                                 double n, const float* __restrict__ gamma,
                                 const float* __restrict__ stats, float* __restrict__ bstats) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double s1 = 0.0, s2 = 0.0;
  for (int s = 0; s < slices; ++s) {
    s1 += partial[static_cast<long long>(ch) * slices + s];
    s2 += partial[static_cast<long long>(c + ch) * slices + s];
  }
  bstats[ch] = static_cast<float>(s2);
  bstats[c + ch] = static_cast<float>(s1);
  bstats[2 * c + ch] = static_cast<float>(s1 / n);
  bstats[3 * c + ch] = static_cast<float>(s2 / n);
  bstats[4 * c + ch] = gamma[ch] * stats[2 * c + ch];
}

// K5-bwd pass 2: dx
template <int kVec, int kAct>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ stats, const float* __restrict__ bstats,
                 long long b, int c, long long hw, int slices, Drop d, float* __restrict__ dx) {
  const int ch = blockIdx.x;
  const Fwd f = fwd_of(stats, c, ch);
  const float m1 = bstats[2 * c + ch], m2 = bstats[3 * c + ch], gr = bstats[4 * c + ch];
  for_units<kVec>(b, c, hw, slices, d, [&](long long e, const bool (&keep)[kVec]) {
    Vec<kVec> xv, gv;
    xv.load(x + e);
    gv.load(g + e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float dz, xhat;
      dz_xhat<kAct>(f, dropped(d, xv.v[j], keep[j]), gv.v[j], dz, xhat);
      const float du = gr * ((dz - m1) - xhat * m2);
      xv.v[j] = d.on ? (keep[j] ? du * d.scale : 0.0f) : du;
    }
    xv.store(dx + e);
  });
}

Drop make_drop(int t, unsigned long long seed) {
  Drop d;
  d.on = t < 256;
  d.t = t;
  d.scale = t > 0 ? static_cast<float>(256.0 / t) : 0.0f;
  d.k0 = static_cast<uint32_t>(seed);
  d.k1 = static_cast<uint32_t>(seed >> 32);
  return d;
}

// shapes the kernels take: a channel's units index in 32 bits
bool bad_shape(long long b, int c, long long hw, int slices, int vec) {
  return b < 1 || c < 1 || hw < 1 || slices < 1 || slices > b || slices > 65535 ||
         (vec != 1 && vec != 4) || hw % vec != 0 || b * hw > 0x7FFFFFFFLL;
}

}  // namespace

// K5: x [b, c, hw] -> y, stats [5, c] (mean, var, r, scale, shift); moves
// running_mean / running_var (unless NULL). partial: fp64 scratch [2, c,
// slices]. vec 4 needs hw % 4 == 0 and 16-byte aligned x and y. act 0 elu,
// 1 relu.
extern "C" int lvae_segment_fwd(const void* x, const void* gamma, const void* beta,
                                void* running_mean, void* running_var, void* y, void* stats,
                                void* partial, long long b, int c, long long hw, int slices,
                                int t, int act, double eps, float momentum,
                                float one_minus_momentum, unsigned long long seed, int vec,
                                void* stream) {
  if (bad_shape(b, c, hw, slices, vec) || (act != kElu && act != kRelu)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Drop d = make_drop(t, seed);
  const dim3 grid(c, slices);
  auto xp = static_cast<const float*>(x);
  auto pp = static_cast<double*>(partial);
  auto st = static_cast<float*>(stats);
  auto yp = static_cast<float*>(y);
  if (vec == 4) {
    stats_kernel<4><<<grid, kThreads, 0, s>>>(xp, b, c, hw, slices, d, pp);
  } else {
    stats_kernel<1><<<grid, kThreads, 0, s>>>(xp, b, c, hw, slices, d, pp);
  }
  stats_final_kernel<<<(c + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, s>>>(
      pp, c, slices, static_cast<double>(b * hw), eps, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), st, static_cast<float*>(running_mean),
      static_cast<float*>(running_var), momentum, one_minus_momentum);
  if (vec == 4 && act == kElu) {
    apply_kernel<4, kElu><<<grid, kThreads, 0, s>>>(xp, st, b, c, hw, slices, d, yp);
  } else if (vec == 4) {
    apply_kernel<4, kRelu><<<grid, kThreads, 0, s>>>(xp, st, b, c, hw, slices, d, yp);
  } else if (act == kElu) {
    apply_kernel<1, kElu><<<grid, kThreads, 0, s>>>(xp, st, b, c, hw, slices, d, yp);
  } else {
    apply_kernel<1, kRelu><<<grid, kThreads, 0, s>>>(xp, st, b, c, hw, slices, d, yp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5-bwd: g [b, c, hw] with the forward's x and stats -> dx and bstats [5,
// c] (dgamma, dbeta, m1, m2, gamma r). partial: fp64 scratch [2, c,
// slices]; vec 4 needs hw % 4 == 0 and 16-byte aligned x, g and dx.
extern "C" int lvae_segment_bwd(const void* x, const void* g, const void* gamma,
                                const void* stats, void* dx, void* bstats, void* partial,
                                long long b, int c, long long hw, int slices, int t, int act,
                                unsigned long long seed, int vec, void* stream) {
  if (bad_shape(b, c, hw, slices, vec) || (act != kElu && act != kRelu)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Drop d = make_drop(t, seed);
  const dim3 grid(c, slices);
  auto xp = static_cast<const float*>(x);
  auto gp = static_cast<const float*>(g);
  auto st = static_cast<const float*>(stats);
  auto pp = static_cast<double*>(partial);
  auto bs = static_cast<float*>(bstats);
  auto dxp = static_cast<float*>(dx);
  if (vec == 4 && act == kElu) {
    bwd_reduce_kernel<4, kElu><<<grid, kThreads, 0, s>>>(xp, gp, st, b, c, hw, slices, d, pp);
  } else if (vec == 4) {
    bwd_reduce_kernel<4, kRelu><<<grid, kThreads, 0, s>>>(xp, gp, st, b, c, hw, slices, d, pp);
  } else if (act == kElu) {
    bwd_reduce_kernel<1, kElu><<<grid, kThreads, 0, s>>>(xp, gp, st, b, c, hw, slices, d, pp);
  } else {
    bwd_reduce_kernel<1, kRelu><<<grid, kThreads, 0, s>>>(xp, gp, st, b, c, hw, slices, d, pp);
  }
  bwd_final_kernel<<<(c + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, s>>>(
      pp, c, slices, static_cast<double>(b * hw), static_cast<const float*>(gamma), st, bs);
  if (vec == 4 && act == kElu) {
    bwd_apply_kernel<4, kElu><<<grid, kThreads, 0, s>>>(xp, gp, st, bs, b, c, hw, slices, d, dxp);
  } else if (vec == 4) {
    bwd_apply_kernel<4, kRelu><<<grid, kThreads, 0, s>>>(xp, gp, st, bs, b, c, hw, slices, d, dxp);
  } else if (act == kElu) {
    bwd_apply_kernel<1, kElu><<<grid, kThreads, 0, s>>>(xp, gp, st, bs, b, c, hw, slices, d, dxp);
  } else {
    bwd_apply_kernel<1, kRelu><<<grid, kThreads, 0, s>>>(xp, gp, st, bs, b, c, hw, slices, d, dxp);
  }
  return static_cast<int>(cudaGetLastError());
}
