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
// dL/da and dL/dd per bin case are _bin_logprob_and_grads's, the TPU
// kernel's series work-arounds (_log1mexp, _inv_expm1) replaced by the
// forward's formulation (below).
//
// Layout: the model's own NCHW, read in place. params [B, K(1 + 3C), H, W]
// with channel q the flax channel q: [pi (K)] ++ [means (KC)] ++
// [log_scales (KC)] ++ [coeffs (KC)], component j channel c at slab entry
// C j + c; x [B, C, H, W]; ll [B, H, W]. A thread of the forward takes V
// neighbouring pixels (b, p = h W + w), two lanes of the backward's one pass
// V of them, and read channel q at b Q HW + q HW + p, so at every q a warp
// (or half-warp) reads neighbouring values: all loads and stores coalesce,
// with no transpose or regroup around the call (the TPU kernel streams
// batch-minor tiles). The backward writes dparams in the same layout, and
// dx only when given a pointer. K is a runtime argument; C is 1 or 3 (a
// template argument).
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
//   one pass (mix_bwd_one_pass_kernel<C, P, V>, redesigned for the H100 and
//     bf16 parameters; the default where a CTA leaves room for a second on
//     an SM): each component is built once and its t_j, pi_j, dm, masked
//     dls and tanh(coeffs) wait in shared memory until the two logsumexps
//     are known, then a loop over them writes the gradients with products
//     alone. This is the Pallas kernel's idea (_mixture_core holds every
//     bin's lp, dm and dls in VMEM) in a CTA's shared memory. Its design:
//   - the grid is (pixel groups, batch), as the forward's, so no thread
//     divides by hw (the parent design divided a 64-bit index by hw a
//     pixel in a grid-stride loop);
//   - lanes l and l ^ 16 of a warp share V = 2 (or 1) neighbouring pixels,
//     l taking the even components and l ^ 16 the odd ones, and swap their
//     maxima, sums and dx with two shuffles. The stash is per pixel (K x 11
//     floats, C = 3), so the CTAs an SM holds are set by pixels; the split
//     gives each pixel two lanes' worth of independent work and V = 2 two
//     pixels' a lane, where one lane a pixel left the loop waiting on its
//     loads. Each channel is one access of V values (bf16: 32 bits, fp32:
//     64) both ways: a fifth of the parent's 100 2-byte loads and 100
//     2-byte stores a pixel;
//   - the loads of component j + 2 are issued before component j is
//     computed, and the slabs of j + 4 prefetched into L2 (prefetch_l2);
//     the per-lane addresses are two pointers stepped a component at a
//     time, the channels' offsets shared by every lane (Slabs);
//   - the bin math is the forward's (four hardware exponentials, the
//     channels' logarithms of products), and its two gradient factors come
//     from one reciprocal more (bin_grads): 5 MUFU a bin where the parent
//     spent 10 with accurate expm1f; tanh(coeffs) is the forward's, the
//     three reciprocals taken as one (tanh3); the logsumexps are a max in
//     the first loop and e^(v - max) in a short second one, which leaves
//     one exponential a component for each of w_j and softmax(pi)_j;
//   - shared memory is [component][value][lane] of V floats, a warp's
//     accesses on distinct banks.
//   Per pixel and component, C = 3, V = 2: ~280 SASS instructions in the
//   first loop, ~13 in the second and ~56 in the last, 23 MUFU (the parent
//   design: ~570 and ~140, 42 MUFU).
//   two passes (any K; the default where one pass at V = 1 leaves no room
//     for a second CTA on an SM, K > 40 at C = 3): the first pass finds the
//     two logsumexps, the second recomputes every t_j and its bin terms
//     and writes that component's 1 + 3C gradients.
//
// Bound: at celeba64's training shape [128, 100, 64, 64] the forward reads
// 400 B of params, 12 B of x and writes 4 B per pixel: 218 MB, ~65 us at
// 3.35 TB/s (bf16 params: 113 MB, ~34 us). The backward reads the same plus
// g (4 B) and writes 400 B of dparams (and 12 B of dx when asked): ~420-435
// MB, ~128 us (bf16: 218 MB, ~65 us). The two-pass schedule is bound by
// instruction issue: ~30 accurate special functions per bin per pass,
// 2,696 SASS instructions (90 MUFU) for mix_bwd_kernel<3>. The one pass, in
// turns with the parent design (lvae_tpu_torch/mixture_ab.py --kernels bwd,
// NVIDIA H100 80GB HBM3 at 700 W, dparams only; PERF.md section 6 has each
// run's numbers): bf16 ~0.098 ms against 0.153 at [128, 100, 64, 64] (67%
// of its bound), ~0.029 against 0.042 at cifar10-deep's [128, 100, 32, 32];
// fp32 ~0.151 against 0.193 (85%); at K = 24, V = 1, ~0.095 (bf16) and
// ~0.115 (fp32) against two passes' ~0.233. Cutting an eighth of its
// instructions (the addresses, hand FMAs) gained it 1-4%, an L2 prefetch of
// the next component but one 3-7%: it waits on its loads' latency, at the
// four CTAs an SM that both its shared memory and its 128 registers allow.
// Measured and dropped: 64-thread CTAs (equal), tanh(coeffs) recomputed in
// the last loop to fit a fifth CTA (it spilled, 8% slower), the first loop
// unrolled by two, a prefetch three components ahead, loads asking L2 for
// 256 bytes (within 1%), and K = 10 as a template argument (bf16 1-4%
// faster, fp32 1-3% slower).
// The forward at [128, 100, 64, 64] (mixture_ab.py, in turns with the parent
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
// the backward 435 -> 226 MB (with dx). Both kernels load bf16 values as
// 16-, 32- or 64-bit words and move each to an fp32's top half with a
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

// The V pixels at p0 of image b of x [B, C, HW].
template <int C, int V>
__device__ __forceinline__ Pixels<C, V> load_pixels(const float* x, long long b, long long hw,
                                                    long long p0, float hb) {
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
  return px;
}

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
    const Pixels<C, V> px = load_pixels<C, V>(x, b, hw, p0, hb);
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


// ---------------------------------------------------------------------------
// K3-bwd in one pass (see the header): a pixel group of V neighbouring
// pixels is shared by lanes l and l ^ 16 of a warp, l taking the even
// components and l ^ 16 the odd ones; each channel is read and written
// with one access of V values.

constexpr int kSplit = 2;                       // lanes a pixel group
constexpr int kGroups = kThreads / kSplit;      // pixel groups a CTA

// Floats the one-pass backward keeps per component and pixel: t_j (then
// e^(t_j - max t)), pi_j (then e^(pi_j - max pi)), dm and the masked dls
// per channel, and tanh(coeffs) (C = 3).
template <int C>
constexpr int kStash = C == 3 ? 11 : 4;
// Parameter values a component reads: pi, means, log-scales, coeffs (C = 3)
template <int C>
constexpr int kRead = C == 3 ? 10 : 3;

// One access of V values of P as it is loaded (bf16 words stay packed
// until they are used, so a load never waits on the one before).
template <typename P, int V> struct Word;
template <> struct Word<float, 1> { using T = float; };
template <> struct Word<float, 2> { using T = float2; };
template <> struct Word<bf16, 1> { using T = unsigned short; };
template <> struct Word<bf16, 2> { using T = unsigned; };
template <typename P, int V>
using word_t = typename Word<P, V>::T;

template <typename P, int V>
__device__ __forceinline__ word_t<P, V> ld_word(const P* p) {
  return __ldg(reinterpret_cast<const word_t<P, V>*>(p));
}
__device__ __forceinline__ void unpack(float w, float (&o)[1]) { o[0] = w; }
__device__ __forceinline__ void unpack(float2 w, float (&o)[2]) { o[0] = w.x; o[1] = w.y; }
__device__ __forceinline__ void unpack(unsigned short w, float (&o)[1]) { o[0] = lo_bf16(w); }
__device__ __forceinline__ void unpack(unsigned w, float (&o)[2]) {
  o[0] = lo_bf16(w);
  o[1] = hi_bf16(w);
}

// V values to P with one access; bf16 rounds to nearest even, as PyTorch's
// cast does.
template <int V>
__device__ __forceinline__ void store_p(float* p, const float (&r)[V]) { store_v<V>(p, r); }
template <int V>
__device__ __forceinline__ void store_p(bf16* p, const float (&r)[V]) {
  unsigned h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = __bfloat16_as_ushort(__float2bfloat16_rn(r[v]));
  if constexpr (V == 2) *reinterpret_cast<unsigned*>(p) = h[0] | (h[1] << 16);
  else *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(h[0]);
}

// V floats of shared memory (8-byte aligned at V = 2).
template <int V>
__device__ __forceinline__ void lds_v(const float* p, float (&o)[V]) {
  if constexpr (V == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    o[0] = r.x;
    o[1] = r.y;
  } else {
    o[0] = p[0];
  }
}

// Where component j's slabs lie: pi at pi_j = img + j hw, channel c of the
// means, log-scales and coeffs at cj = img + C j hw plus m[c], ls[c], co[c],
// offsets that are the same for every lane (kept out of the per-lane
// address arithmetic).
template <int C>
struct Slabs {
  long long m[C], ls[C], co[C];

  __device__ __forceinline__ Slabs(long long hw, int k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m[c] = (k + c) * hw;
      ls[c] = (k + k * C + c) * hw;
      co[c] = (k + 2 * k * C + c) * hw;
    }
  }
};

// Component j's slabs brought into L2 ahead of their loads (V = 2: at V = 1
// the prefetches cost more than they hide). The loop waits on its loads'
// latency, and one component ahead in registers is all the registers hold
// (PERF.md, section 6).
template <int C, typename P>
__device__ __forceinline__ void prefetch_l2(const P* pi_j, const P* cj, const Slabs<C>& at) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(pi_j));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(cj + at.m[c]));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(cj + at.ls[c]));
    if constexpr (C == 3) asm volatile("prefetch.global.L2 [%0];" ::"l"(cj + at.co[c]));
  }
}

// Component j's parameter words for V pixels: pi, means, log-scales and
// (C = 3) coefficients.
template <int C, typename P, int V>
struct Words {
  word_t<P, V> w[kRead<C>];

  __device__ __forceinline__ void load(const P* pi_j, const P* cj, const Slabs<C>& at) {
    w[0] = ld_word<P, V>(pi_j);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w[1 + c] = ld_word<P, V>(cj + at.m[c]);
      w[1 + C + c] = ld_word<P, V>(cj + at.ls[c]);
      if constexpr (C == 3) w[1 + 2 * C + c] = ld_word<P, V>(cj + at.co[c]);
    }
  }
};

// tanh of a component's three coefficients, as tanh_fast, with the three
// reciprocals taken as one: |v| is clamped at 10 (tanh is 1 in fp32 past
// it; the product of the three 1 + e^(2|v|) stays finite), and a NaN passes.
__device__ __forceinline__ void tanh3(float (&v)[3]) {
  float e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float av = fabsf(v[i]) > 10.0f ? 10.0f : fabsf(v[i]);
    e[i] = 1.0f + ex2(av * (2.0f * kLog2e));
  }
  const float e01 = e[0] * e[1];
  const float r = rcp(e01 * e[2]);
  const float ri[3] = {(e[1] * e[2]) * r, (e[0] * e[2]) * r, e01 * r};
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = copysignf(fmaf(-2.0f, ri[i], 1.0f), v[i]);
}

// Pixel v's bin terms for one component (the forward's, see `component`)
// and their gradient factors: returns sum_c lp_c and sets dm[c] = d lp_c /
// d m_c and dls[c] = d lp_c / d ls_c (0 where the raw log-scale is at or
// under the floor). With q = 1 - e^-D (d h(D) below the series' bound) and
// one reciprocal R = 1 / ((1 + e^-|A|)(1 + e^-|B|) q):
//   sigmoid(-A) - sigmoid(B) = d lp / da,  1 / q - sigmoid(B) = d lp / dd,
// the interior's 1 - sigmoid(a) - sigmoid(a + d) and 1 + 1 / expm1(d) -
// sigmoid(a + d); at the left edge (A = -inf, D = +inf) both are 1 -
// sigmoid(a + d), at the right (B = D = +inf) -sigmoid(a) and 0. q keeps its
// relative accuracy at small d, which 1 / q needs.
template <int C, int V>
__device__ __forceinline__ float bin_grads(const Pixels<C, V>& px, int v, const float (&m)[C],
                                           const float (&raw)[C], float hb, float log_2hb,
                                           float (&dm)[C], float (&dls)[C]) {
  float lin = 0.0f, num = 1.0f, den = 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float l = fmaxf(raw[c], kLogScaleMin);
    const float inv_s = ex2(l * -kLog2e);
    const float a = inv_s * ((px.xs[c][v] - m[c]) - hb);
    const float d = (2.0f * hb) * inv_s;
    const float A = a + px.left[c][v], B = (a + d) + px.right[c][v];
    const float D = d + (px.right[c][v] - px.left[c][v]);
    const bool series = D < kSeriesMax;
    const float h = expm1_ratio(D);
    const float q = series ? D * h : 1.0f - ex2(D * -kLog2e);
    lin += fminf(fminf(B, -A), 0.0f) + (series ? log_2hb - l : 0.0f);
    num *= series ? h : q;
    const float ea = ex2(fabsf(A) * -kLog2e), eb = ex2(fabsf(B) * -kLog2e);
    const float pa = 1.0f + ea, pb = 1.0f + eb;
    const float pab = pa * pb;
    den *= pab;
    const float r = rcp(pab * q), qr = q * r;
    const float ra = pb * qr, rb = pa * qr;                 // 1 / (1 + e^-|A|), 1 / (1 + e^-|B|)
    const float sig_b = B >= 0.0f ? rb : eb * rb;           // sigmoid(B)
    const float da = (A >= 0.0f ? ea * ra : ra) - sig_b;    // sigmoid(-A) - sigmoid(B)
    const float dd = fmaf(pab, r, -sig_b);                  // 1 / q - sigmoid(B)
    dm[c] = -inv_s * da;                                    // a = inv_s (xs - m - hb)
    dls[c] = raw[c] > kLogScaleMin ? -fmaf(a, da, d * dd) : 0.0f;  // da/dls = -a, dd/dls = -d
  }
  return lin + kLn2 * (lg2(num) - lg2(den));
}

// K3-bwd, one pass, for a map whose rows are V-aligned (the C entry
// launches V = 1 where they are not; every V computes the same bits).
// Grid: x over pixel groups, kGroups a CTA; y over the batch (a loop where
// B is above 65,535). Each lane builds its components once (bin_grads) and
// keeps t_j, pi_j, dm, the masked dls and tanh(coeffs) in shared memory,
// [component][value][thread] of V floats, tracking the two maxima; the
// pair swaps its maxima, turns t_j and pi_j into e^(t_j - max) and e^(pi_j
// - max), swaps the sums, and writes the 1 + 3C gradients of each of its
// components with products alone; the pair's dx sums meet in the lane of
// the even components, which writes dx.
template <int C, typename P, int V>
__global__ void __launch_bounds__(kThreads, 4)
mix_bwd_one_pass_kernel(const float* __restrict__ x, const P* __restrict__ params,
                        const float* __restrict__ g, P* __restrict__ dparams,
                        float* __restrict__ dx, long long nb, long long hw, int k, float hb,
                        float log_2hb) {
  extern __shared__ float stash[];
  constexpr int S = kStash<C>;
  constexpr int kValue = kThreads * V;               // floats between two values of a lane
  const int lane = threadIdx.x & 31, half = lane >> 4;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * kGroups + (threadIdx.x >> 5) * 16 + (lane & 15)) * V;
  if (p0 >= hw) return;                              // the pair leaves together
  const unsigned pair = (1u << lane) | (1u << (lane ^ 16));
  const long long q = static_cast<long long>(k) * (1 + 3 * C);
  const int n = (k - half + 1) >> 1;                 // this lane's components: j = 2 i + half
  const Slabs<C> at(hw, k);
  const long long step_pi = 2 * hw, step_c = 2 * C * hw;   // from component j to j + 2
  float* mine = stash + threadIdx.x * V;
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    const Pixels<C, V> px = load_pixels<C, V>(x, b, hw, p0, hb);
    const P* img = params + b * q * hw + p0;
    float mt[V], mp[V];
#pragma unroll
    for (int v = 0; v < V; ++v) mt[v] = mp[v] = -INFINITY;
    const P* pi_j = img + half * hw;
    const P* cj = img + C * half * hw;
    Words<C, P, V> cur;
    if (n > 0) cur.load(pi_j, cj, at);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if (i + 1 < n) {                               // the next component's words
        pi_j += step_pi;
        cj += step_c;
      }
      Words<C, P, V> nxt;
      nxt.load(pi_j, cj, at);
      if (V == 2 && i + 2 < n) prefetch_l2<C>(pi_j + step_pi, cj + step_c, at);
      float pi[V], m[C][V], raw[C][V], co[C][V];
      unpack(cur.w[0], pi);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        unpack(cur.w[1 + c], m[c]);
        unpack(cur.w[1 + C + c], raw[c]);
        if constexpr (C == 3) unpack(cur.w[1 + 2 * C + c], co[c]);
      }
      float t[V], dm[C][V], dls[C][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float mv[C], rv[C], dmv[C], dlsv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          mv[c] = m[c][v];
          rv[c] = raw[c][v];
        }
        if constexpr (C == 3) {
          float cv[3] = {co[0][v], co[1][v], co[2][v]};
          tanh3(cv);
#pragma unroll
          for (int c = 0; c < C; ++c) co[c][v] = cv[c];
          mv[1] = fmaf(cv[0], px.xs[0][v], mv[1]);
          mv[2] = fmaf(cv[2], px.xs[1][v], fmaf(cv[1], px.xs[0][v], mv[2]));
        }
        t[v] = bin_grads<C, V>(px, v, mv, rv, hb, log_2hb, dmv, dlsv) + pi[v];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dm[c][v] = dmv[c];
          dls[c][v] = dlsv[c];
        }
        mt[v] = fmaxf(mt[v], t[v]);
        mp[v] = fmaxf(mp[v], pi[v]);
      }
      float* s = mine + i * S * kValue;
      store_v<V>(s, t);
      store_v<V>(s + kValue, pi);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store_v<V>(s + (2 + c) * kValue, dm[c]);
        store_v<V>(s + (2 + C + c) * kValue, dls[c]);
        if constexpr (C == 3) store_v<V>(s + (2 + 2 * C + c) * kValue, co[c]);
      }
      cur = nxt;
    }
    float st[V], sp[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mt[v] = fmaxf(mt[v], __shfl_xor_sync(pair, mt[v], 16));
      mp[v] = fmaxf(mp[v], __shfl_xor_sync(pair, mp[v], 16));
      st[v] = sp[v] = 0.0f;
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      float* s = mine + i * S * kValue;
      float t[V], pi[V];
      lds_v<V>(s, t);
      lds_v<V>(s + kValue, pi);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        t[v] = ex2((t[v] - mt[v]) * kLog2e);
        pi[v] = ex2((pi[v] - mp[v]) * kLog2e);
        st[v] += t[v];
        sp[v] += pi[v];
      }
      store_v<V>(s, t);
      store_v<V>(s + kValue, pi);
    }
    float gt[V], gp[V];
    load_v<V>(g + b * hw + p0, gt);
#pragma unroll
    for (int v = 0; v < V; ++v) {   // g / sum e^(t_j - max), g / sum e^(pi_j - max)
      gp[v] = gt[v] * rcp(sp[v] + __shfl_xor_sync(pair, sp[v], 16));
      gt[v] = gt[v] * rcp(st[v] + __shfl_xor_sync(pair, st[v], 16));
    }
    P* dpi_j = dparams + b * q * hw + p0 + half * hw;
    P* dcj = dparams + b * q * hw + p0 + C * half * hw;
    float dxs[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) dxs[c][v] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < n; ++i, dpi_j += step_pi, dcj += step_c) {
      const float* s = mine + i * S * kValue;
      float et[V], ep[V], dm[C][V], dls[C][V], co[C][V];
      lds_v<V>(s, et);
      lds_v<V>(s + kValue, ep);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        lds_v<V>(s + (2 + c) * kValue, dm[c]);
        lds_v<V>(s + (2 + C + c) * kValue, dls[c]);
        if constexpr (C == 3) lds_v<V>(s + (2 + 2 * C + c) * kValue, co[c]);
      }
      float dpi[V], dco[C][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gw = et[v] * gt[v];                // g w_j
        dpi[v] = gw - ep[v] * gp[v];                   // g (w_j - softmax(pi)_j)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dm[c][v] = gw * dm[c][v];
          dls[c][v] = gw * dls[c][v];
        }
        if constexpr (C == 3) {
          const float xs0 = px.xs[0][v], xs1 = px.xs[1][v];
          const float c0 = co[0][v], c1 = co[1][v], c2 = co[2][v];
          dco[0][v] = dm[1][v] * xs0 * fmaf(-c0, c0, 1.0f);
          dco[1][v] = dm[2][v] * xs0 * fmaf(-c1, c1, 1.0f);
          dco[2][v] = dm[2][v] * xs1 * fmaf(-c2, c2, 1.0f);
          // the bin terms see xs_c - m_c; the autoregression adds couplings
          dxs[0][v] += fmaf(dm[2][v], c1, fmaf(dm[1][v], c0, -dm[0][v]));
          dxs[1][v] += fmaf(dm[2][v], c2, -dm[1][v]);
          dxs[2][v] += -dm[2][v];
        } else {
          dco[0][v] = 0.0f;                            // C = 1: the coefficients are unused
          dxs[0][v] += -dm[0][v];
        }
      }
      store_p<V>(dpi_j, dpi);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store_p<V>(dcj + at.m[c], dm[c]);
        store_p<V>(dcj + at.ls[c], dls[c]);
        store_p<V>(dcj + at.co[c], dco[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) dxs[c][v] += __shfl_xor_sync(pair, dxs[c][v], 16);
    if (dx != nullptr && half == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = 2.0f * dxs[c][v];
        store_v<V>(dx + (b * C + c) * hw + p0, o);
      }
    }
  }
}

unsigned int grid_for(long long npix) {
  long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  return static_cast<unsigned int>(blocks);
}

// The backward's schedules, which kernels/mixture.py bwd_plan chooses
// from K and C: kOnePass keeps each pixel's component terms in shared
// memory, kStash<C> floats a component, and needs them to fit one CTA;
// kTwoPass, the original schedule, recomputes them (no shared memory, any
// K).
constexpr int kOnePass = 0, kTwoPass = 1;
constexpr long long kSmemMax = 232448;         // what one CTA can have
constexpr int kMaxDevices = 64;
constexpr long long kMaxGridY = 65535;

// A CTA's stash: kThreads lanes, each ceil(K / 2) components of V pixels
long long one_pass_smem(int k, int c, int v) {
  return 4LL * kThreads * ((k + 1) / 2) * (c == 3 ? kStash<3> : kStash<1>) * v;
}

// Lift the one-pass kernel's dynamic shared memory limit to kSmemMax, once
// per device. The limit is only a ceiling: each launch's own size sets its
// occupancy.
template <int C, typename P, int V>
cudaError_t allow_one_pass_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    e = cudaFuncSetAttribute(mix_bwd_one_pass_kernel<C, P, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return e;
    done[dev].store(true);
  }
  return cudaSuccess;
}

struct BwdArgs {
  const float* x;
  const void* params;
  const float* g;
  void* dparams;
  float* dx;
  long long nb, hw;
  int k;
  float hb, log_2hb;
  cudaStream_t s;
};

template <int C, typename P, int V>
int launch_one_pass(const BwdArgs& a) {
  const long long smem = one_pass_smem(a.k, C, V);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_one_pass_smem<C, P, V>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((a.hw + kGroups * V - 1) / (kGroups * V)),
                  static_cast<unsigned>(a.nb < kMaxGridY ? a.nb : kMaxGridY));
  mix_bwd_one_pass_kernel<C, P, V><<<grid, kThreads, smem, a.s>>>(
      a.x, static_cast<const P*>(a.params), a.g, static_cast<P*>(a.dparams), a.dx, a.nb, a.hw,
      a.k, a.hb, a.log_2hb);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename P>
int launch_bwd(int plan, int v, const BwdArgs& a) {
  if (plan == kTwoPass) {
    const long long npix = a.nb * a.hw;
    mix_bwd_kernel<C, P><<<grid_for(npix), kThreads, 0, a.s>>>(
        a.x, static_cast<const P*>(a.params), a.g, static_cast<P*>(a.dparams), a.dx, npix,
        a.hw, a.k, a.hb);
    return static_cast<int>(cudaGetLastError());
  }
  if (plan != kOnePass) return static_cast<int>(cudaErrorInvalidValue);
  return v == 2 ? launch_one_pass<C, P, 2>(a) : launch_one_pass<C, P, 1>(a);
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

// p is a multiple of v elements of `bytes` each
bool aligned(const void* p, int v, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (static_cast<uintptr_t>(v) * bytes) == 0;
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
  const float hb = 1.0f / static_cast<float>(n_bins - 1);
  if (hw % v != 0 || !aligned(x, v, 4) || !aligned(out, v, 4) || !aligned(params, v, esize))
    v = 1;
  const FwdArgs a{static_cast<const float*>(x), params, static_cast<float*>(out), b, hw, k, hb,
                  static_cast<float>(std::log(2.0 * static_cast<double>(hb))),
                  static_cast<cudaStream_t>(stream)};
  if (c == 3) return esize == 4 ? launch_fwd<3, float>(v, a) : launch_fwd<3, bf16>(v, a);
  return esize == 4 ? launch_fwd<1, float>(v, a) : launch_fwd<1, bf16>(v, a);
}

// g [b, hw] fp32 -> dparams [b, k (1 + 3c), hw] in params' storage (esize
// 4: fp32, 2: bf16) and, when dx is not NULL, dx [b, c, hw] fp32, on the
// schedule plan (kOnePass or kTwoPass; kernels/mixture.py bwd_plan) at v
// pixels a group (1 or 2; one pass only). Rows that are not v-aligned run
// the v = 1 kernel, which gives the same bits.
extern "C" int lvae_mix_log_prob_bwd_plan(const void* x, const void* params, const void* g,
                                          void* dparams, void* dx, long long b, long long hw,
                                          int k, int c, int n_bins, int plan, int v, int esize,
                                          void* stream) {
  if ((esize != 4 && esize != 2) || (c != 1 && c != 3) || (v != 1 && v != 2) || k < 1 ||
      n_bins < 2 || b < 0 || hw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hw == 0) return 0;
  if (hw % v != 0 || !aligned(x, v, 4) || !aligned(g, v, 4) || !aligned(dx, v, 4) ||
      !aligned(params, v, esize) || !aligned(dparams, v, esize))
    v = 1;
  const float hb = 1.0f / static_cast<float>(n_bins - 1);
  const BwdArgs a{static_cast<const float*>(x), params, static_cast<const float*>(g), dparams,
                  static_cast<float*>(dx), b, hw, k, hb,
                  static_cast<float>(std::log(2.0 * static_cast<double>(hb))),
                  static_cast<cudaStream_t>(stream)};
  if (c == 3)
    return esize == 4 ? launch_bwd<3, float>(plan, v, a) : launch_bwd<3, bf16>(plan, v, a);
  return esize == 4 ? launch_bwd<1, float>(plan, v, a) : launch_bwd<1, bf16>(plan, v, a);
}
