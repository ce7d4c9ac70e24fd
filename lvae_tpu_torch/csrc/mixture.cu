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
// C j + c; x [B, C, H, W]; ll [B, H, W]. A thread of the backward takes one
// pixel (b, p = h W + w), a thread of the forward V neighbouring ones, and
// reads channel q at b Q HW + q HW + p, so at every q a warp reads 32 (or
// 32 V) neighbouring values: all loads and stores coalesce, with no
// transpose or regroup around the call (the TPU kernel streams batch-minor
// tiles). The backward writes dparams in the same layout, and dx only when
// given a pointer. K is a runtime argument; C is 1 or 3 (a template
// argument).
//
// The forward (mix_fwd_kernel<C, P, V>, redesigned for the H100; the
// parent design, a grid-stride loop of one pixel a thread with accurate
// special functions, had 881 SASS instructions in its component loop):
//   - the grid is (pixel blocks, batch), so no thread divides by hw;
//   - a thread takes V = 1, 2 or 4 neighbouring pixels and reads each
//     channel with one load of V values (float4, or 4 bf16 as a 64-bit
//     word), kernels/mixture.py fwd_plan choosing V from B and hw; rows
//     that are not V-aligned run V = 1, which gives the same bits;
//   - a bin costs four hardware exponentials (e^-ls, e^-|a|, e^-|a + d|,
//     and e^-d where d >= 0.25) and no logarithm of its own: with the
//     edges as -inf / +inf added to a and a + d,
//       lp = min(a + d, -a, 0) + log(-expm1(-d)) - log((1 + e^-|a|)(1 + e^-|a + d|)),
//     where log(-expm1(-d)) stays accurate for narrow bins as
//     log(2 hb) - ls + log(series of (1 - e^-d) / d) below d = 0.25 and
//     log(1 - e^-d) above, and the C channels' logarithms are taken once,
//     of the products (two lg2 a component);
//   - tanh(coeffs) is 1 - 2 / (1 + e^(2|v|)): one exponential and one
//     reciprocal;
//   - t_j and pi_j fold into running logsumexps without a branch: one
//     exponential of -|v - m| each.
// Per pixel and component, C = 3: ~200 SASS instructions (V = 4) and 22
// MUFU. Holding every t_j and pi_j in registers (the loop unrolled, a max
// then a sum) was measured and lost at every V (PERF.md, PR 15).
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
// 3.35 TB/s (bf16 params: 113 MB, ~34 us). The backward reads the same plus
// g (4 B) and writes 400 B of dparams (and 12 B of dx when asked): ~420-435
// MB, ~128 us. What bounds the two-pass schedule on an H100 is instruction
// issue: ~30 accurate special functions per bin per pass (expf, log1pf,
// expm1f, logf, two divisions, tanhf), 2,696 SASS instructions (90 MUFU) for
// mix_bwd_kernel<3>, and a throwaway build with -use_fast_math ran it 20%
// faster. The one pass builds each bin once, shares e^-|v| between
// softplus and sigmoid, and uses the hardware's approximate exp, log and
// reciprocal where a few ulp are harmless (1,128 instructions, 44 MUFU);
// fast math gains it only 6%, and prefetching the next component's ten
// loads 2.4% (4.6% at C = 1). Measured by chip_smoke.py phase 10 on an
// NVIDIA H100 80GB HBM3 at 700 W, dparams only (PERF.md section 6 has each
// run's numbers): one pass ~0.19 ms, two passes ~0.36 ms of device time,
// against ~3.5 ms for the plain PyTorch backward, 1.5x the memory bound; a
// one-pass CTA alone on its SM (K = 24) is slower than two passes (~0.29
// against ~0.23 ms per call at [32, 240, 64, 64]). The forward at [128,
// 100, 64, 64] (lvae_tpu_torch/mixture_ab.py, in turns with the parent
// design): fp32 0.075 ms against 0.127 (87% of its byte bound), bf16 0.051
// against 0.127 (66%), where the special-function unit (22 MUFU a pixel
// and component, ~0.03 ms) and instruction issue (~0.035 ms) sit beside the
// bytes.
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
// the backward 435 -> 226 MB (with dx). The forward loads bf16 values as
// 16-, 32- or 64-bit words and moves each to an fp32's top half with a
// shift or a mask. A first build of it chose between a vector and a scalar
// load per channel with a branch; each conversion then sat in the branch
// right after its load, so every load waited on the one before, and bf16 at
// V = 2 ran at 2.4x its time with one branch-free load (PERF.md, PR 15).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kLogScaleMin = -7.0f;

using bf16 = __nv_bfloat16;

// A parameter as fp32 (the backward's loads); bf16 -> fp32 is exact (the 16
// bits are the fp32 value's top half). Read through the pointer here:
// converting a bf16 passed by value (p[i]) ran the parent forward at 2.2x
// this form's time on an H100 (PERF.md), with the same opcode counts.
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
// relative accuracy at small d. The two-pass schedule's bin_logprob is
// left as it is.
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
// backward's weights; lse_push, which the two-pass schedule uses, stays as
// it is).
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

// ---------------------------------------------------------------------------
// K3, the forward (see the header): V pixels a thread, each channel read
// with one vector load, the bin terms from four hardware exponentials and
// the component's sum from two logarithms, and logsumexps without a branch.

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// below this d the bin's -expm1(-d) is d times a series, with log d taken
// from the log-scale itself
constexpr float kSeriesMax = 0.25f;

// The hardware's approximations (a few ulp; subnormal results flush to 0).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// tanh |v| = 1 - 2 / (1 + e^(2|v|)): one exponential and one reciprocal
// (a few ulp of 1 off tanhf; chip_smoke.py phase 10 holds ll to the plain
// version's tanhf at 1e-4 + 1e-5 |ll|).
__device__ __forceinline__ float tanh_fast(float v) {
  const float e = ex2(fabsf(v) * (2.0f * kLog2e));
  return copysignf(fmaf(-2.0f, rcp(1.0f + e), 1.0f), v);
}

// (1 - e^-d) / d = 1 - d/2 + d^2/6 - ...: relative error 6e-8 at d = 0.25
__device__ __forceinline__ float expm1_ratio(float d) {
  float h = fmaf(d, -1.0f / 720.0f, 1.0f / 120.0f);
  h = fmaf(d, h, -1.0f / 24.0f);
  h = fmaf(d, h, 1.0f / 6.0f);
  h = fmaf(d, h, -0.5f);
  return fmaf(d, h, 1.0f);
}

__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// V neighbouring values from p (V-aligned) as fp32, with one vector load.
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  } else if constexpr (V == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = r.x; o[1] = r.y;
  } else {
    o[0] = __ldg(p);
  }
}

// bf16: the words as loaded, each value's 16 bits moved to the top of an
// fp32 (exact); no bf16 value is converted by value.
template <int V>
__device__ __forceinline__ void load_v(const bf16* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = lo_bf16(r.x); o[1] = hi_bf16(r.x); o[2] = lo_bf16(r.y); o[3] = hi_bf16(r.y);
  } else if constexpr (V == 2) {
    const unsigned r = __ldg(reinterpret_cast<const unsigned*>(p));
    o[0] = lo_bf16(r); o[1] = hi_bf16(r);
  } else {
    o[0] = lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// A pixel's data for every component: xs = 2x - 1 per channel, and the
// bin's edge as two additive masks: -inf on a where xs is in the left edge
// bin (xs < -1 + hb), +inf on a + d where it is in the right one.
template <int C, int V>
struct Pixels {
  float xs[C][V], left[C][V], right[C][V];
};

// Component j's t_j = sum_c lp_jc + pi_j and pi_j for V pixels; img points
// at the first pixel's channel 0. Per bin, with A = a + left, B = a + d +
// right, D = d + right - left (+inf at either edge):
//   lp = min(B, -A, 0) + log((1 - e^-D) or d h(d)) - log((1 + e^-|A|)(1 + e^-|B|))
// which is the interior's a + d + log(-expm1(-d)) - softplus(a) -
// softplus(a + d), the left edge's -softplus(-(a + d)) and the right
// edge's -softplus(a). log d = log(2 hb) - ls exactly; the C channels'
// logarithms are taken once, of the products.
template <int C, int V, typename P>
__device__ __forceinline__ void component(const P* img, long long hw, int k, int j,
                                          const Pixels<C, V>& px, float hb, float log_2hb,
                                          float (&pi)[V], float (&t)[V]) {
  float m[C][V], ls[C][V];
  load_v<V>(img + j * hw, pi);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    load_v<V>(img + (k + C * j + c) * hw, m[c]);
    load_v<V>(img + (k + k * C + C * j + c) * hw, ls[c]);
  }
  if constexpr (C == 3) {
    float co[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c) load_v<V>(img + (k + 2 * k * C + C * j + c) * hw, co[c]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float t0 = tanh_fast(co[0][v]), t1 = tanh_fast(co[1][v]), t2 = tanh_fast(co[2][v]);
      m[1][v] = m[1][v] + t0 * px.xs[0][v];
      m[2][v] = (m[2][v] + t1 * px.xs[0][v]) + t2 * px.xs[1][v];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float lin = 0.0f, num = 1.0f, den = 1.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float l = fmaxf(ls[c][v], kLogScaleMin);
      const float inv_s = ex2(l * -kLog2e);
      const float a = inv_s * ((px.xs[c][v] - m[c][v]) - hb);
      const float d = (2.0f * hb) * inv_s;
      const float A = a + px.left[c][v], B = (a + d) + px.right[c][v];
      const float D = d + (px.right[c][v] - px.left[c][v]);
      const bool series = D < kSeriesMax;
      lin += fminf(fminf(B, -A), 0.0f) + (series ? log_2hb - l : 0.0f);
      num *= series ? expm1_ratio(D) : 1.0f - ex2(D * -kLog2e);
      den *= (1.0f + ex2(fabsf(A) * -kLog2e)) * (1.0f + ex2(fabsf(B) * -kLog2e));
    }
    t[v] = (lin + kLn2 * (lg2(num) - lg2(den))) + pi[v];
  }
}

// Fold v into a running logsumexp (m, s) without a branch: one exponential
// of -|v - m|, which is e^(v - m) or e^(m - v) as v or m is the larger. An
// all -inf sequence gives (-inf, n), whose logsumexp is -inf; a NaN
// propagates through s.
__device__ __forceinline__ void lse_fold(float& m, float& s, float v) {
  const float e = v == m ? 1.0f : ex2(fabsf(v - m) * -kLog2e);
  const bool up = v > m;
  s = up ? fmaf(s, e, 1.0f) : s + e;
  m = up ? v : m;
}

// K3: ll [B, HW] for a [B, K(1 + 3C), HW] parameter map whose rows are
// V-aligned (hw % V == 0, aligned pointers; the C entry launches V = 1
// where they are not). Grid: x over the image's pixels, V to a thread; y
// over the batch (a loop where B is above 65,535). Each thread folds its
// pixels' t_j and pi_j into running logsumexps, component by component;
// every V computes the same bits.
template <int C, typename P, int V>
__global__ void __launch_bounds__(kThreads, 4)
mix_fwd_kernel(const float* __restrict__ x, const P* __restrict__ params,
               float* __restrict__ out, long long nb, long long hw, int k, float hb,
               float log_2hb) {
  const long long p0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (p0 >= hw) return;
  const long long q = static_cast<long long>(k) * (1 + 3 * C);
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    Pixels<C, V> px;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      load_v<V>(x + (b * C + c) * hw + p0, px.xs[c]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xs = 2.0f * px.xs[c][v] - 1.0f;
        const bool left = xs < -1.0f + hb;
        px.xs[c][v] = xs;
        px.left[c][v] = left ? -INFINITY : 0.0f;
        px.right[c][v] = !left && xs > 1.0f - hb ? INFINITY : 0.0f;
      }
    }
    const P* img = params + b * q * hw + p0;
    float mt[V], st[V], mp[V], sp[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mt[v] = mp[v] = -INFINITY;
      st[v] = sp[v] = 0.0f;
    }
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      float pj[V], tj[V];
      component<C, V>(img, hw, k, j, px, hb, log_2hb, pj, tj);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        lse_fold(mt[v], st[v], tj[v]);
        lse_fold(mp[v], sp[v], pj[v]);
      }
    }
    float ll[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      ll[v] = (mt[v] + kLn2 * lg2(st[v])) - (mp[v] + kLn2 * lg2(sp[v]));
    store_v<V>(out + b * hw + p0, ll);
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

// K3's launch at V pixels a thread (kernels/mixture.py fwd_plan).
struct FwdArgs {
  const float* x;
  const void* params;
  float* out;
  long long nb, hw;
  int k;
  float hb, log_2hb;
  cudaStream_t s;
};

constexpr long long kMaxGridY = 65535;

template <int C, typename P, int V>
int launch_fwd(const FwdArgs& a) {
  const dim3 grid(static_cast<unsigned>((a.hw + kThreads * V - 1) / (kThreads * V)),
                  static_cast<unsigned>(a.nb < kMaxGridY ? a.nb : kMaxGridY));
  mix_fwd_kernel<C, P, V><<<grid, kThreads, 0, a.s>>>(
      a.x, static_cast<const P*>(a.params), a.out, a.nb, a.hw, a.k, a.hb, a.log_2hb);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename P>
int launch_fwd(int v, const FwdArgs& a) {
  if (v == 4) return launch_fwd<C, P, 4>(a);
  if (v == 2) return launch_fwd<C, P, 2>(a);
  return launch_fwd<C, P, 1>(a);
}

}  // namespace

// x [b, c, hw] fp32, params [b, k (1 + 3c), hw] fp32 (esize 4) or bf16
// (esize 2), out [b, hw] fp32; c in {1, 3}; v pixels a thread (1, 2 or 4;
// kernels/mixture.py fwd_plan). Rows that are not v-aligned (hw % v != 0,
// or a pointer off a multiple of v elements) are read one value at a
// time: the v = 1 kernel, the same bits.
extern "C" int lvae_mix_log_prob(const void* x, const void* params, void* out, long long b,
                                 long long hw, int k, int c, int n_bins, int v, int esize,
                                 void* stream) {
  if ((esize != 4 && esize != 2) || (c != 1 && c != 3) || (v != 1 && v != 2 && v != 4) ||
      k < 1 || n_bins < 2 || b < 0 || hw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hw == 0) return 0;
  const auto aligned = [v](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % (static_cast<uintptr_t>(v) * bytes) == 0;
  };
  const float hb = 1.0f / static_cast<float>(n_bins - 1);
  if (hw % v != 0 || !aligned(x, 4) || !aligned(out, 4) || !aligned(params, esize)) v = 1;
  const FwdArgs a{static_cast<const float*>(x), params, static_cast<float*>(out), b, hw, k, hb,
                  static_cast<float>(std::log(2.0 * static_cast<double>(hb))),
                  static_cast<cudaStream_t>(stream)};
  if (c == 3) return esize == 4 ? launch_fwd<3, float>(v, a) : launch_fwd<3, bf16>(v, a);
  return esize == 4 ? launch_fwd<1, float>(v, a) : launch_fwd<1, bf16>(v, a);
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
