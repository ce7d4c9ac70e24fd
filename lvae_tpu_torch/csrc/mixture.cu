// Discretized-logistic-mixture log-prob (PixelCNN++ head): forward and
// backward.
//
// Replaces lvae_tpu/kernels/mixture_pallas.py:
//   K3      _run_fwd (:323), body _fwd_kernel (:217) over _mixture_core
//           (:152): the per-pixel log p(x) [B, H, W];
//   K3-bwd  _run_bwd (:338), body _bwd_kernel (:227) with
//           _bin_logprob_and_grads (:93): dparams in the parameter map's
//           own layout and dx, from the cotangent g [B, H, W].
// Oracle: lvae_tpu/ops/likelihoods.py:109 discretized_logistic_mix_log_prob;
// its plain PyTorch twin is lvae_tpu_torch/ops/likelihoods.py.
//
// Per pixel, with xs = 2x - 1, hb = 1/(n_bins - 1), component j, channel c:
//   m_jc  = mean[j, c] (+ tanh(co[j, 0]) xs_0 for c = 1,
//                        + tanh(co[j, 1]) xs_0 + tanh(co[j, 2]) xs_1 for c = 2;
//                        no autoregression for C = 1)
//   ls_jc = max(ls_raw[j, c], -7),  a = (xs_c - m - hb) e^-ls,  d = 2 hb e^-ls
//   lp_jc = a + d + log(-expm1(-d)) - softplus(a) - softplus(a + d)   interior
//         = log sigmoid(a + d)                    left edge  (xs < -1 + hb)
//         = log sigmoid(-a)                       right edge (xs >  1 - hb)
//   t_j   = sum_c lp_jc + pi_j,   ll = logsumexp_j t_j - logsumexp_j pi_j
// which is logsumexp_j(sum_c lp_jc + log_softmax(pi)_j). Backward, with
// w = softmax(t) (the posterior over components):
//   dpi_j = g (w_j - softmax(pi)_j)
//   dm_jc = g w_j dL/dm,  dls_jc = g w_j dL/dls (0 where ls_raw <= -7:
//           the floor blocks it, as the Pallas kernel's ls_raw > floor rule)
//   dco   through 1 - tanh^2 and the autoregression, dx = 2 dxs.
// dL/da and dL/dd per bin case are _bin_logprob_and_grads's; CUDA has
// expm1f and log1pf, so 1/(e^d - 1) is 1/expm1f(d) and the TPU kernel's
// series work-arounds (_log1mexp, _inv_expm1) have no counterpart.
//
// Layout: the model's own NCHW, read in place. params [B, K(1 + 3C), H, W]
// with channel q the flax channel q: [pi (K)] ++ [means (KC)] ++
// [log_scales (KC)] ++ [coeffs (KC)], component j channel c at slab entry
// C j + c; x [B, C, H, W]; ll [B, H, W]. One thread per pixel (b, p = h W +
// w) reads channel q at b Q HW + q HW + p, so at every q a warp reads 32
// neighbouring floats: all loads and stores coalesce, with no transpose or
// regroup around the call (the TPU kernel streams batch-minor tiles). The
// backward writes dparams in the same layout, and dx only when given a
// pointer. K is a runtime argument; C is 1 or 3 (a template argument).
//
// The forward keeps two running (max, sum) pairs in registers, for
// logsumexp(pi) and logsumexp(t), in place of the 100 values of its pixel.
// The backward has two schedules (kernels/mixture.py bwd_plan):
//   one pass (the default where it fits, K (2 + 2C + 3[C = 3]) floats a
//     thread, 56,320 B a CTA of 128 at K = 10, C = 3: four CTAs per SM):
//     each component is built once, with its gradient factors sharing the
//     bin's exponentials (bin_terms), and its t_j, pi_j, dm, masked dls and
//     tanh(coeffs) wait in shared memory, [value][thread], until the two
//     logsumexps are known; a second loop over them writes the gradients
//     with two exponentials a component and no bin math. This is the Pallas
//     kernel's idea (_mixture_core holds every bin's lp, dm and dls in
//     VMEM) in a CTA's shared memory.
//   two passes (any K; the default where one pass leaves no room for a
//     second CTA on an SM): the first pass finds the two logsumexps, the
//     second recomputes every t_j and its bin terms and writes that
//     component's 1 + 3C gradients.
//
// Bound: at celeba64's training shape [128, 100, 64, 64] the forward reads
// 400 B of params, 12 B of x and writes 4 B per pixel: 218 MB, ~65 us at
// 3.35 TB/s. The backward reads the same plus g (4 B) and writes 400 B of
// dparams (and 12 B of dx when asked): ~420-435 MB, ~128 us. What bounds
// the two-pass schedule on an H100 is instruction issue: ~30 accurate
// special functions per bin per pass (expf, log1pf, expm1f, logf, two
// divisions, tanhf), 2,696 SASS instructions (90 MUFU) for
// mix_bwd_kernel<3>, and a throwaway build with -use_fast_math ran it 20%
// faster. The one pass builds each bin once, shares e^-|v| between
// softplus and sigmoid, and uses the hardware's approximate exp, log and
// reciprocal where a few ulp are harmless (1,128 instructions, 44 MUFU);
// fast math gains it only 6%, and prefetching the next component's ten
// loads 2.4% (4.6% at C = 1). Measured by chip_smoke.py phase 10 on an
// NVIDIA H100 80GB HBM3 at 700 W, dparams only (PERF.md section 6 has each
// run's numbers): one pass ~0.19 ms, two passes ~0.36 ms of device time
// (the forward ~0.13 ms), against ~3.5 ms for the plain PyTorch backward,
// 1.5x the memory bound; a one-pass CTA alone on its SM (K = 24) is slower
// than two passes (~0.29 against ~0.23 ms per call at [32, 240, 64, 64]).
// Determinism: every pixel is independent, with no atomics, so two
// launches are bit-equal.
//
// Storage: params (and so dparams) are fp32 or bf16 (P); x, g, ll and dx
// are fp32 whatever P is. Under --precision bf16 lvae_tpu hands its kernel
// the raw bf16 conv output and the fp32 image, upcasts per block, computes
// in fp32 and casts dparams back to bf16 (mixture_pallas.py:214,328,341-342,
// 513). Here a thread converts each bf16 parameter to fp32 as it loads it,
// all the math is the fp32 kernel's, and dparams is written as bf16
// directly: the fp32 value rounded to nearest even is the cast's bits, at
// half the bytes and with no second kernel. A bf16 map halves the
// parameter bytes: at [128, 100, 64, 64] the forward moves 218 -> 113 MB,
// the backward 435 -> 226 MB (with dx).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kLogScaleMin = -7.0f;

using bf16 = __nv_bfloat16;

// A parameter as fp32; bf16 -> fp32 is exact (the 16 bits are the fp32
// value's top half). Read through the pointer here: converting a bf16
// passed by value (p[i]) ran the forward at 2.2x this form's time on an
// H100 (PERF.md), for reasons its opcode counts do not show.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(*p)) << 16);
}

template <typename P>
__device__ __forceinline__ P down(float v) {
  if constexpr (std::is_same_v<P, float>) return v;
  else return __float2bfloat16_rn(v);     // round to nearest even, as PyTorch's cast
}

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Fold v into a running logsumexp (m, s): logsumexp = m + log(s). An all
// -inf sequence stays (-inf, 0), whose logsumexp is -inf; a NaN propagates.
__device__ __forceinline__ void lse_push(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else if (v != -INFINITY) {
    s += expf(v - m);
  }
}

struct Bin {
  float lp;    // log P(bin)
  float dm;    // d lp / d m
  float dls;   // d lp / d ls (ls already floored)
};

// The bin log-prob of xs under logistic(m, e^ls), and its gradients when
// kGrad (lvae_tpu/kernels/mixture_pallas.py:93-133).
template <bool kGrad>
__device__ __forceinline__ Bin bin_logprob(float xs, float m, float ls, float hb) {
  const float inv_s = expf(-ls);
  const float a = inv_s * ((xs - m) - hb);
  const float d = (2.0f * hb) * inv_s;
  const float plus = a + d;
  Bin r;
  float da = 0.0f, dd = 0.0f;
  if (xs < -1.0f + hb) {            // left edge: log sigmoid(a + d)
    r.lp = -softplus(-plus);
    if constexpr (kGrad) da = dd = 1.0f - sigmoid(plus);
  } else if (xs > 1.0f - hb) {      // right edge: log sigmoid(-a)
    r.lp = -softplus(a);
    if constexpr (kGrad) {
      da = -sigmoid(a);
      dd = 0.0f;
    }
  } else {                          // interior, cancellation-free
    r.lp = plus + logf(-expm1f(-d)) - softplus(a) - softplus(plus);
    if constexpr (kGrad) {
      const float sp = sigmoid(plus);
      da = 1.0f - sigmoid(a) - sp;
      dd = 1.0f + 1.0f / expm1f(d) - sp;
    }
  }
  if constexpr (kGrad) {
    r.dm = -inv_s * da;             // a = inv_s (xs - m - hb)
    r.dls = -a * da - d * dd;       // da/dls = -a, dd/dls = -d
  }
  return r;
}

// Component j of one pixel: its autoregressed means, floored log-scales,
// tanh coefficients and bin terms. p points at the pixel's channel 0 of
// params (fp32 or bf16, read as fp32); channel q is p[q * hw].
template <int C, bool kGrad>
struct Component {
  float t;            // sum_c lp + pi_j
  float pi;
  float co[C];        // tanh(coeffs) (C = 3)
  bool free_ls[C];    // ls_raw > floor: the log-scale gradient passes
  float dm[C], dls[C];

  template <typename P>
  __device__ __forceinline__ Component(const P* p, long long hw, int k, int j,
                                       const float (&xs)[C], float hb) {
    pi = ld(p + j * hw);
    const P* mean = p + (k + C * j) * hw;
    const P* lsr = p + (k + k * C + C * j) * hw;
    const P* cor = p + (k + 2 * k * C + C * j) * hw;
    float m[C];
#pragma unroll
    for (int c = 0; c < C; ++c) m[c] = ld(mean + c * hw);
    if constexpr (C == 3) {
#pragma unroll
      for (int c = 0; c < C; ++c) co[c] = tanhf(ld(cor + c * hw));
      m[1] = m[1] + co[0] * xs[0];
      m[2] = (m[2] + co[1] * xs[0]) + co[2] * xs[1];
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float raw = ld(lsr + c * hw);
      free_ls[c] = raw > kLogScaleMin;
      const Bin r = bin_logprob<kGrad>(xs[c], m[c], fmaxf(raw, kLogScaleMin), hb);
      s += r.lp;
      if constexpr (kGrad) {
        dm[c] = r.dm;
        dls[c] = r.dls;
      }
    }
    t = s + pi;
  }
};

template <int C>
__device__ __forceinline__ void load_xs(const float* x, long long b, long long hw,
                                        long long p, float (&xs)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) xs[c] = 2.0f * x[(b * C + c) * hw + p] - 1.0f;
}

// The two logsumexps of a pixel: over pi, and over t_j.
template <int C, typename P>
__device__ __forceinline__ void pixel_lse(const P* p, long long hw, int k,
                                          const float (&xs)[C], float hb,
                                          float& lse_pi, float& lse_t) {
  float mp = -INFINITY, sp = 0.0f, mt = -INFINITY, st = 0.0f;
  for (int j = 0; j < k; ++j) {
    const Component<C, false> cj(p, hw, k, j, xs, hb);
    lse_push(mp, sp, cj.pi);
    lse_push(mt, st, cj.t);
  }
  lse_pi = mp + logf(sp);
  lse_t = mt + logf(st);
}

template <int C, typename P>
__global__ void mix_fwd_kernel(const float* __restrict__ x, const P* __restrict__ params,
                               float* __restrict__ out, long long npix, long long hw,
                               int k, float hb) {
  const long long q = static_cast<long long>(k) * (1 + 3 * C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < npix; i += step) {
    const long long b = i / hw, p = i - b * hw;
    float xs[C];
    load_xs<C>(x, b, hw, p, xs);
    float lse_pi, lse_t;
    pixel_lse<C>(params + b * q * hw + p, hw, k, xs, hb, lse_pi, lse_t);
    out[i] = lse_t - lse_pi;
  }
}

template <int C, typename P>
__global__ void mix_bwd_kernel(const float* __restrict__ x, const P* __restrict__ params,
                               const float* __restrict__ g, P* __restrict__ dparams,
                               float* __restrict__ dx, long long npix, long long hw, int k,
                               float hb) {
  const long long q = static_cast<long long>(k) * (1 + 3 * C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < npix; i += step) {
    const long long b = i / hw, p = i - b * hw;
    float xs[C];
    load_xs<C>(x, b, hw, p, xs);
    const P* pp = params + b * q * hw + p;
    P* dp = dparams + b * q * hw + p;
    float lse_pi, lse_t;
    pixel_lse<C>(pp, hw, k, xs, hb, lse_pi, lse_t);
    const float gi = g[i];
    float dxs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dxs[c] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const Component<C, true> cj(pp, hw, k, j, xs, hb);
      const float w = expf(cj.t - lse_t);
      const float gw = gi * w;
      dp[j * hw] = down<P>(gi * (w - expf(cj.pi - lse_pi)));
      float dm[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dm[c] = gw * cj.dm[c];
        dp[(k + C * j + c) * hw] = down<P>(dm[c]);
        dp[(k + k * C + C * j + c) * hw] = down<P>(cj.free_ls[c] ? gw * cj.dls[c] : 0.0f);
      }
      P* dco = dp + (k + 2 * k * C + C * j) * hw;
      if constexpr (C == 3) {
        const float* co = cj.co;
        dco[0] = down<P>(dm[1] * xs[0] * (1.0f - co[0] * co[0]));
        dco[hw] = down<P>(dm[2] * xs[0] * (1.0f - co[1] * co[1]));
        dco[2 * hw] = down<P>(dm[2] * xs[1] * (1.0f - co[2] * co[2]));
        // the bin terms see xs_c - m_c; the autoregression adds couplings
        dxs[0] += (-dm[0] + dm[1] * co[0]) + dm[2] * co[1];
        dxs[1] += -dm[1] + dm[2] * co[2];
        dxs[2] += -dm[2];
      } else {
        dco[0] = down<P>(0.0f);     // C = 1: the coefficients are unused
        dxs[0] += -dm[0];
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int c = 0; c < C; ++c) dx[(b * C + c) * hw + p] = 2.0f * dxs[c];
    }
  }
}

// One bin's log-prob and its two gradient factors for the one-pass
// backward, with the special functions shared between them: e = e^-|v|
// gives softplus(v) = max(v, 0) + log1p(e) and both sigmoid(v) and
// sigmoid(-v) through one reciprocal, for v = a and v = a + d; and
// 1 + 1/expm1(d) = -1/expm1(-d) reuses the interior's log term. The
// exponentials, logarithms and reciprocals are the hardware's approximate
// ones (__expf, __logf, __fdividef: a few ulp, which moves dparams by about
// 1e-6 of their max); expm1f stays accurate, as 1/expm1(-d) needs its
// relative accuracy at small d. The forward's bin_logprob<false> is left as
// it is.
__device__ __forceinline__ Bin bin_terms(float xs, float m, float ls, float hb) {
  const float inv_s = __expf(-ls);
  const float a = inv_s * ((xs - m) - hb);
  const float d = (2.0f * hb) * inv_s;
  const float plus = a + d;
  const float ea = __expf(-fabsf(a)), ep = __expf(-fabsf(plus));
  const float ra = __fdividef(1.0f, 1.0f + ea), rp = __fdividef(1.0f, 1.0f + ep);
  const float sig_a = a >= 0.0f ? ra : ea * ra;          // sigmoid(a)
  const float sig_p = plus >= 0.0f ? rp : ep * rp;       // sigmoid(a + d)
  const float sp_a = fmaxf(a, 0.0f) + __logf(1.0f + ea); // softplus(a)
  const float l1p = __logf(1.0f + ep);
  Bin r;
  float da, dd;
  if (xs < -1.0f + hb) {            // left edge: log sigmoid(a + d)
    r.lp = -(fmaxf(-plus, 0.0f) + l1p);
    da = dd = plus >= 0.0f ? ep * rp : rp;               // sigmoid(-(a + d))
  } else if (xs > 1.0f - hb) {      // right edge: log sigmoid(-a)
    r.lp = -sp_a;
    da = -sig_a;
    dd = 0.0f;
  } else {                          // interior, cancellation-free
    const float em = expm1f(-d);    // in (-1, 0)
    r.lp = plus + __logf(-em) - sp_a - (fmaxf(plus, 0.0f) + l1p);
    da = (a >= 0.0f ? ea * ra : ra) - sig_p;             // sigmoid(-a) - sigmoid(a + d)
    dd = -__fdividef(1.0f, em) - sig_p;
  }
  r.dm = -inv_s * da;
  r.dls = -a * da - d * dd;
  return r;
}

// lse_push with the hardware's approximate exponential (the one-pass
// backward's weights; lse_push, which the forward uses, stays as it is).
__device__ __forceinline__ void lse_push_approx(float& m, float& s, float v) {
  if (v > m) {
    s = s * __expf(m - v) + 1.0f;
    m = v;
  } else if (v != -INFINITY) {
    s += __expf(v - m);
  }
}

// Floats the one-pass backward keeps per component: t_j, pi_j, dm and the
// masked dls per channel, and tanh(coeffs) (C = 3).
template <int C>
constexpr int kStored = C == 3 ? 11 : 4;
// Parameter values a component reads: pi, means, log-scales, coeffs (C = 3)
template <int C>
constexpr int kRead = C == 3 ? 10 : 3;

template <int C, typename P>
__device__ __forceinline__ void load_component(const P* p, long long hw, int k, int j,
                                               float (&v)[kRead<C>]) {
  v[0] = ld(p + j * hw);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[1 + c] = ld(p + (k + C * j + c) * hw);
    v[1 + C + c] = ld(p + (k + k * C + C * j + c) * hw);
    if constexpr (C == 3) v[1 + 2 * C + c] = ld(p + (k + 2 * k * C + C * j + c) * hw);
  }
}

// K3-bwd in one pass of bin math: each thread builds its pixel's K
// components once (bin_terms), keeps what the gradients need in shared
// memory as [value][thread] (a warp's 32 accesses on 32 banks) and folds
// t_j and pi_j into the two running logsumexps; a second loop over the
// stored values writes the 1 + 3C gradients per component with two
// exponentials and products. Component j + 1's values load while j is
// computed.
template <int C, typename P>
__global__ void __launch_bounds__(kThreads, 4)
mix_bwd_one_pass_kernel(const float* __restrict__ x, const P* __restrict__ params,
                        const float* __restrict__ g, P* __restrict__ dparams,
                        float* __restrict__ dx, long long npix, long long hw, int k,
                        float hb) {
  extern __shared__ float stash[];
  constexpr int V = kStored<C>;
  const long long q = static_cast<long long>(k) * (1 + 3 * C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  float* mine = stash + threadIdx.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < npix; i += step) {
    const long long b = i / hw, p = i - b * hw;
    const float gi = g[i];
    float xs[C];
    load_xs<C>(x, b, hw, p, xs);
    const P* pp = params + b * q * hw + p;
    P* dp = dparams + b * q * hw + p;
    float mp = -INFINITY, sp = 0.0f, mt = -INFINITY, st = 0.0f;
    float cur[kRead<C>];
    load_component<C>(pp, hw, k, 0, cur);
    for (int j = 0; j < k; ++j) {
      float nxt[kRead<C>];
      load_component<C>(pp, hw, k, j + 1 < k ? j + 1 : j, nxt);
      float* s = mine + j * V * kThreads;
      float m[C], co[C];
#pragma unroll
      for (int c = 0; c < C; ++c) m[c] = cur[1 + c];
      if constexpr (C == 3) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          co[c] = tanhf(cur[1 + 2 * C + c]);
          s[(2 + 2 * C + c) * kThreads] = co[c];
        }
        m[1] = m[1] + co[0] * xs[0];
        m[2] = (m[2] + co[1] * xs[0]) + co[2] * xs[1];
      }
      float lp = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float raw = cur[1 + C + c];
        const Bin r = bin_terms(xs[c], m[c], fmaxf(raw, kLogScaleMin), hb);
        lp += r.lp;
        s[(2 + c) * kThreads] = r.dm;
        s[(2 + C + c) * kThreads] = raw > kLogScaleMin ? r.dls : 0.0f;
      }
      const float t = lp + cur[0];
      s[0] = t;
      s[kThreads] = cur[0];
      lse_push_approx(mp, sp, cur[0]);
      lse_push_approx(mt, st, t);
#pragma unroll
      for (int v = 0; v < kRead<C>; ++v) cur[v] = nxt[v];
    }
    const float lse_pi = mp + logf(sp), lse_t = mt + logf(st);
    float dxs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dxs[c] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float* s = mine + j * V * kThreads;
      const float w = __expf(s[0] - lse_t);
      const float gw = gi * w;
      dp[j * hw] = down<P>(gi * (w - __expf(s[kThreads] - lse_pi)));
      float dm[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dm[c] = gw * s[(2 + c) * kThreads];
        dp[(k + C * j + c) * hw] = down<P>(dm[c]);
        dp[(k + k * C + C * j + c) * hw] = down<P>(gw * s[(2 + C + c) * kThreads]);
      }
      P* dco = dp + (k + 2 * k * C + C * j) * hw;
      if constexpr (C == 3) {
        float co[C];
#pragma unroll
        for (int c = 0; c < C; ++c) co[c] = s[(2 + 2 * C + c) * kThreads];
        dco[0] = down<P>(dm[1] * xs[0] * (1.0f - co[0] * co[0]));
        dco[hw] = down<P>(dm[2] * xs[0] * (1.0f - co[1] * co[1]));
        dco[2 * hw] = down<P>(dm[2] * xs[1] * (1.0f - co[2] * co[2]));
        dxs[0] += (-dm[0] + dm[1] * co[0]) + dm[2] * co[1];
        dxs[1] += -dm[1] + dm[2] * co[2];
        dxs[2] += -dm[2];
      } else {
        dco[0] = down<P>(0.0f);
        dxs[0] += -dm[0];
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int c = 0; c < C; ++c) dx[(b * C + c) * hw + p] = 2.0f * dxs[c];
    }
  }
}

unsigned int grid_for(long long npix) {
  long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  return static_cast<unsigned int>(blocks);
}

// The backward's schedules, which kernels/mixture.py bwd_plan chooses
// from K and C: kOnePass keeps each pixel's component terms in kStored<C> K
// floats of shared memory per thread and needs them to fit one CTA;
// kTwoPass, the original schedule, recomputes them (no shared memory, any
// K).
constexpr int kOnePass = 0, kTwoPass = 1;
constexpr long long kSmemMax = 232448;         // what one CTA can have
constexpr int kMaxDevices = 64;

long long one_pass_smem(int k, int c) {
  return 4LL * k * (c == 3 ? kStored<3> : kStored<1>) * kThreads;
}

// Lift the one-pass kernel's dynamic shared memory limit to kSmemMax, once
// per device. The limit is only a ceiling: each launch's own size sets its
// occupancy.
template <int C, typename P>
cudaError_t allow_one_pass_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    e = cudaFuncSetAttribute(mix_bwd_one_pass_kernel<C, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return e;
    done[dev].store(true);
  }
  return cudaSuccess;
}

template <int C, typename P>
int launch_bwd(int plan, const float* x, const void* params, const float* g, void* dparams,
               float* dx, long long npix, long long hw, int k, float hb, cudaStream_t s) {
  const P* pp = static_cast<const P*>(params);
  P* dpp = static_cast<P*>(dparams);
  if (plan == kTwoPass) {
    mix_bwd_kernel<C, P><<<grid_for(npix), kThreads, 0, s>>>(x, pp, g, dpp, dx, npix, hw, k,
                                                             hb);
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = one_pass_smem(k, C);
  if (plan != kOnePass || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_one_pass_smem<C, P>();
  if (e != cudaSuccess) return static_cast<int>(e);
  mix_bwd_one_pass_kernel<C, P><<<grid_for(npix), kThreads, smem, s>>>(
      x, pp, g, dpp, dx, npix, hw, k, hb);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_fwd(const float* x, const void* params, float* out, long long npix, long long hw,
               int k, int c, float hb, cudaStream_t s) {
  const P* pp = static_cast<const P*>(params);
  if (c == 3) {
    mix_fwd_kernel<3, P><<<grid_for(npix), kThreads, 0, s>>>(x, pp, out, npix, hw, k, hb);
  } else if (c == 1) {
    mix_fwd_kernel<1, P><<<grid_for(npix), kThreads, 0, s>>>(x, pp, out, npix, hw, k, hb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, c, hw] fp32, params [b, k (1 + 3c), hw] fp32 (esize 4) or bf16
// (esize 2), out [b, hw] fp32; c in {1, 3}.
extern "C" int lvae_mix_log_prob(const void* x, const void* params, void* out, long long b,
                                 long long hw, int k, int c, int n_bins, int esize,
                                 void* stream) {
  const long long npix = b * hw;
  if (esize != 4 && esize != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (npix == 0) return 0;
  const float hb = 1.0f / static_cast<float>(n_bins - 1);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto op = static_cast<float*>(out);
  return esize == 4 ? launch_fwd<float>(xp, params, op, npix, hw, k, c, hb, s)
                    : launch_fwd<bf16>(xp, params, op, npix, hw, k, c, hb, s);
}

// g [b, hw] fp32 -> dparams [b, k (1 + 3c), hw] in params' storage (esize
// 4: fp32, 2: bf16) and, when dx is not NULL, dx [b, c, hw] fp32, on the
// schedule plan (kOnePass or kTwoPass).
extern "C" int lvae_mix_log_prob_bwd_plan(const void* x, const void* params, const void* g,
                                          void* dparams, void* dx, long long b, long long hw,
                                          int k, int c, int n_bins, int plan, int esize,
                                          void* stream) {
  const long long npix = b * hw;
  if (esize != 4 && esize != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (npix == 0) return 0;
  const float hb = 1.0f / static_cast<float>(n_bins - 1);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto gp = static_cast<const float*>(g);
  auto dxp = static_cast<float*>(dx);
  if (c == 3) {
    return esize == 4 ? launch_bwd<3, float>(plan, xp, params, gp, dparams, dxp, npix, hw, k,
                                             hb, s)
                      : launch_bwd<3, bf16>(plan, xp, params, gp, dparams, dxp, npix, hw, k,
                                            hb, s);
  }
  if (c == 1) {
    return esize == 4 ? launch_bwd<1, float>(plan, xp, params, gp, dparams, dxp, npix, hw, k,
                                             hb, s)
                      : launch_bwd<1, bf16>(plan, xp, params, gp, dparams, dxp, npix, hw, k,
                                            hb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same on one pass where its terms fit one CTA, else two passes (the
// port's wrapper calls lvae_mix_log_prob_bwd_plan with bwd_plan's choice).
extern "C" int lvae_mix_log_prob_bwd(const void* x, const void* params, const void* g,
                                     void* dparams, void* dx, long long b, long long hw,
                                     int k, int c, int n_bins, int esize, void* stream) {
  const int plan = one_pass_smem(k, c) <= kSmemMax ? kOnePass : kTwoPass;
  return lvae_mix_log_prob_bwd_plan(x, params, g, dparams, dx, b, hw, k, c, n_bins, plan,
                                    esize, stream);
}
