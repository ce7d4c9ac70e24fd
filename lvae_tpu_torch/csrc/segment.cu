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
// the two words of the 64-bit key: word (e % 16) / 4, bits 8 (e % 4) up.
// No mask is stored in device memory. The key is mix_seed(train seed,
// step, dropout site) (ops/philox.py): the caller passes the seed and the
// site by value and the step as a pointer to device memory, and every
// thread derives the key from them at its start (drop_key), so a CUDA
// graph of a train step launches the kernels with the step of each replay.
//
// What bounds it. Both directions are a per-channel reduction followed by
// an elementwise map that needs the reduction's result, so the least work
// reads each input once and writes each output once: 8 B per element
// forward (x in, y out), 12 B backward (x and g in, dx out); at [128, 64,
// 64, 64] 0.080 and 0.120 ms at 3.35 TB/s. The TPU kernel carries its sums
// across a sequential grid; on the card blocks run in no order, so a
// reduction across blocks needs a second pass over the data or an
// exchange between blocks, and a launch per pass costs 6-9 us at the small
// maps of the models.
//
// Design: one launch per direction, at every shape, with the launch's shape
// from kernels/segment.py _plan (a function of the tensor's shape and dtype).
// - A thread block cluster reduces one channel. Each CTA takes a fixed
//   contiguous share of the channel's units; its threads walk the share 16
//   bytes at a time, neighbouring threads on neighbouring addresses. Each
//   thread sums in fp64 element by element (E[u^2] - mean^2 cancels in fp32
//   at n = 524,288, and the fp32 statistics must round as the plain
//   version's fp64 ones do: a bf16 y one ulp from its plain version leaves
//   no room for a shift or scale one fp32 ulp off), the CTA in a fixed
//   tree (warp shuffles, then in every warp a butterfly over the warps'
//   pairs, so no warp waits for another after the one barrier). The CTAs
//   exchange their pairs through distributed shared memory and every warp
//   adds them in the same fixed butterfly over the ranks, so all hold the
//   same statistics, two launches are bit-equal and no float atomics are
//   used. mean and var come from the sums times 1 / n, r from the fp64
//   rsqrt: no division or square root slow path on a small map's chain.
//   Rank 0 writes the [5, C] row and moves the running statistics
//   (forward), or writes dgamma and dbeta (backward); the channel's gamma,
//   beta and running statistics are loaded while its data is in flight. A
//   channel of up to 2,048 16-byte accesses takes a cluster of one, which
//   needs no cluster barrier. The grid holds at most the clusters that fit
//   on the card at once (cudaOccupancyMaxActiveClusters, asked once per
//   kernel and plan), and they walk the channels; _plan prefers a cluster
//   a half or a quarter the size where that puts every channel's cluster
//   on the card at once with its share on chip (bf16's 32x32 forward: 2
//   CTAs a channel, one wave, where 4 took two rounds), and 256 threads
//   where a cluster of 16's share leaves room for three CTAs an SM.
// - On chip: where a CTA's share fits in shared memory (up to ~200 KB, a
//   cluster of up to 16) and leaves room for a second CTA on the SM (or
//   the grid is one wave), the CTA copies its share in with cp.async, all
//   of it in flight at once, turns it into u (forward) or dz (backward) in
//   place, and writes the output from there: 8 and 12 B per element of
//   device memory in fp32, the bound. Each slot, once written out, takes
//   the CTA's next channel, so that channel's reads overlap this one's
//   writes. Elsewhere (celeba64's 64x64 maps) the CTA keeps what fits
//   beside a second CTA on the SM and reads the rest twice, the second
//   time last chunk first (the likeliest still in L2); the outputs and the
//   second reads stream past L2 (evict first) so that the rest stays
//   there. Loads of what is read twice stay packed in registers until used
//   (bf16: 2 B an element), which keeps the bf16 kernels within 64
//   registers without spills.
// - The dropout bytes: a unit is 16 consecutive elements of one (b, c)
//   strip where H W % 16 == 0, else 4 (a 2x2 map) or 1; one Philox call
//   (~70 integer operations) per unit gives its keep bits, its bytes
//   compared with t four at a time (below4), staged in shared memory while
//   the share's copies are in flight, generated once per direction on chip.
// - bf16's ELU (act_out): exp(z) - 1 from ex2.approx, z + z^2 / 2 near 0,
//   ~10 instructions against expm1f's ~33, within a hundredth of a bf16 ulp
//   of expm1f; fp32 keeps expm1f. The backward keeps dz in fp32 in shared
//   memory from its first sweep to its second, so that act'(z) (expf, the
//   plain version's bits) is computed once an element.
// - What still costs: every element's fp64 conversion and adds (forward
//   one F2F.F64.F32, a DADD and a DFMA; backward two F2F.F64.F32 and two
//   DADD) and, backward, expf; each channel's reduction and cluster barrier
//   stall its SM between the reads and the writes, and at 64x64 a cluster
//   of 16 (four rounds of channels) takes the card in lockstep phases, so
//   the bf16 backward there stays at a third of its bound (PERF.md).
//
// Storage: x, y, g and dx are fp32 or bf16 (lvae_tpu's segment reads and
// writes x.dtype, segment_pallas.py:103,160,211,312,344; the model's bf16
// activation stream under --precision bf16), each kernel instantiated for
// both (T, the plan's esize). The arithmetic, the sums, the statistics,
// gamma, beta, the running statistics, dgamma and dbeta are fp32 (fp64
// sums) either way; a bf16 output is the fp32 result rounded to nearest
// even, as PyTorch's cast rounds it, and the dropout bytes and the keep
// rule do not depend on T, so bf16 and fp32 runs drop the same elements.
// A device-memory access is 16 bytes, F = 16 / sizeof(T) elements (8 in
// bf16; 4, 8 bytes, on a 2x2 map's units of 4). On chip the forward keeps x
// in T (fp32 turns it into u in place; bf16 keeps the raw input and drops
// it again), the backward dz in fp32 and x in T (fp32 turns x into xhat in
// place; bf16 recomputes xhat, a select and two operations): 2 B an
// element forward and 6 B backward in bf16, where bf16 moves 4 and 6 B of
// device memory.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

// Two translation units: this file alone holds K5, K5-bwd and the dropout
// kernel; segment_split.cu compiles it with LVAE_SEGMENT_SPLIT set to 1 and
// holds the split launches (K5-split, K5-bwd-split) alone, so that the two
// halves build side by side (kernels/build.py starts one nvcc a source).
#ifndef LVAE_SEGMENT_SPLIT
#define LVAE_SEGMENT_SPLIT 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;          // 16 warps: sum16's lanes
constexpr int kSmemMax = 232448;          // a CTA's shared memory on an H100
constexpr uint32_t kStream = 0x80000005u;   // ops/philox.py STREAM_SEGMENT_DROPOUT

enum Act { kElu = 0, kRelu = 1 };

}  // namespace

// kernels/segment.py _Plan, field for field (ctypes.Structure _CPlan)
struct SegPlan {
  long long b, hw;
  int c;
  int vec;        // elements per unit: 16, 4 or 1
  int cluster;    // CTAs per channel (the cluster's size)
  int threads;    // per CTA, a multiple of 32, <= 512
  int clusters;   // the grid; cluster i takes channels i, i + clusters, ...
  int chip;       // units of a CTA's share kept in shared memory (0: none)
  int smem;       // dynamic shared memory per CTA
  int esize;      // bytes per element of x, y, g and dx: 4 (fp32) or 2 (bf16)
};

namespace {

struct Drop {
  bool on;        // t < 256: a mask applies (t <= 0 drops everything)
  int t;
  float scale;    // 256 / t rounded to fp32 (0 when t <= 0)
  unsigned long long seed, site;   // the train seed and the dropout site
  const long long* step;           // the step in device memory (NULL: no bytes drawn)
  uint32_t k0, k1;                 // the Philox key, set on chip by drop_key
  lvae::ElementMap at;             // local element e is global element
                                   // global_element(at, e): this rank's rows of the
                                   // global batch, or its band of them (the identity
                                   // but for the dropout alone; the split launches
                                   // walk strips, SplitArgs gstride and base)
};

// the global element of this rank's element e
__device__ __forceinline__ long long global_at(const Drop& d, long long e) {
  return lvae::global_element(d.at, e);
}

// one word of ops/philox.py mix_seed (splitmix64)
__device__ __forceinline__ unsigned long long mix_word(unsigned long long h,
                                                       unsigned long long w) {
  h = (h ^ w) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

// d with its Philox key mix_seed(seed, *step, site); every thread reads
// the same 8 bytes of the step
__device__ __forceinline__ Drop drop_key(Drop d) {
  if (d.step != nullptr) {
    unsigned long long h = 0x9E3779B97F4A7C15ull;
    h = mix_word(h, d.seed);
    h = mix_word(h, static_cast<unsigned long long>(*d.step));
    h = mix_word(h, d.site);
    h >>= 1;
    d.k0 = static_cast<uint32_t>(h);
    d.k1 = static_cast<uint32_t>(h >> 32);
  }
  return d;
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

// K5's act of z for storage T. fp32 keeps act (expm1f, the plain version's
// bits). A bf16 output is rounded to 8 significant bits, so its ELU below 0
// is ex2.approx's exp(z) - 1 where z <= -2^-6 (relative error under 2e-5
// there: 2^-22.5 of exp(z) over |exp(z) - 1| >= 0.0155) and z + z^2 / 2
// above (the series' next term: under 4e-5 of z), a hundredth of a bf16 ulp
// either way, so y stays within one ulp of the plain version's; about 10
// instructions where expm1f takes ~33.
template <typename T, int kAct>
__device__ __forceinline__ float act_out(float z) {
  if constexpr (kAct == kElu && !std::is_same_v<T, float>) {
    const float big = __expf(z) - 1.0f;
    const float small = __fmaf_rn(0.5f * z, z, z);
    return z > 0.0f ? z : (z > -0.015625f ? small : big);
  } else {
    return act<kAct>(z);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// bit j: byte j of w below t, tt = t (0..255) in every byte: the four
// unsigned byte compares at once (z's sign bits: the low seven bits' >=),
// their sign bits gathered into bits 28-31 by one multiply
__device__ __forceinline__ uint32_t below4(uint32_t w, uint32_t tt) {
  const uint32_t z = (w | 0x80808080u) - (tt & 0x7F7F7F7Fu);
  const uint32_t lt = ((~w & tt) | (~(w ^ tt) & ~z)) & 0x80808080u;
  return (lt * 0x00204081u) >> 28;
}

// t in every byte of a word, for below4 (0 where t <= 0: nothing kept)
__device__ __forceinline__ uint32_t t_bytes(const Drop& d) {
  return static_cast<uint32_t>(d.t > 0 ? d.t : 0) * 0x01010101u;
}

// bit j: whether element e + j of a unit of V is kept (all set without a
// mask); one Philox call for the unit, its bytes compared four at a time
// (V = 1 or 4: e's word, from byte e % 4)
template <int V>
__device__ __forceinline__ uint32_t keep_bits(const Drop& d, long long e) {
  if (!d.on) return 0xFFFFFFFFu;
  const unsigned long long grp = static_cast<unsigned long long>(e) >> 4;
  const uint4 w = lvae::philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), static_cast<uint32_t>(grp >> 32), 0u, kStream),
      d.k0, d.k1);
  const uint32_t tt = t_bytes(d);
  if constexpr (V == 16) {
    return below4(w.x, tt) | below4(w.y, tt) << 4 | below4(w.z, tt) << 8 |
           below4(w.w, tt) << 12;
  } else {
    return (below4(word_of(w, static_cast<int>((e >> 2) & 3)), tt) >> (e & 3)) &
           ((1u << V) - 1u);
  }
}

// whether the global element g is kept (its byte alone: one Philox call)
__device__ __forceinline__ bool keep_at(const Drop& d, long long g) {
  if (!d.on) return true;
  const unsigned long long grp = static_cast<unsigned long long>(g) >> 4;
  const uint4 w = lvae::philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), static_cast<uint32_t>(grp >> 32), 0u, kStream),
      d.k0, d.k1);
  const int j = static_cast<int>(g & 15);
  return static_cast<int>((word_of(w, j >> 2) >> (8 * (j & 3))) & 255u) < d.t;
}

// keep_bits<n> of n <= 16 global elements from any g0, element by element
__device__ __forceinline__ uint32_t keep_bits_at(const Drop& d, long long g0, int n = 16) {
  if (!d.on) return 0xFFFFFFFFu;
  uint32_t bits = 0;
  for (int j = 0; j < n; ++j) bits |= static_cast<uint32_t>(keep_at(d, g0 + j)) << j;
  return bits;
}

// keep_bits<16> of 16 local elements from e0, each mapped to its global
// element (a band's elements across the end of a channel's rows)
__device__ __forceinline__ uint32_t keep_bits_mapped(const Drop& d, long long e0) {
  if (!d.on) return 0xFFFFFFFFu;
  uint32_t bits = 0;
  for (int j = 0; j < 16; ++j) {
    bits |= static_cast<uint32_t>(keep_at(d, lvae::global_element(d.at, e0 + j))) << j;
  }
  return bits;
}

// u of one element: x where kept (scaled), 0 where dropped
__device__ __forceinline__ float dropped(const Drop& d, float v, bool keep) {
  if (!d.on) return v;
  return keep ? v * d.scale : 0.0f;
}

using bf16 = __nv_bfloat16;

// The raw word of N bytes: one access
template <int N> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float up(float v) { return v; }
// bf16 -> fp32 is exact: the 16 bits are the fp32 value's top half
__device__ __forceinline__ float up(bf16 v) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16);
}
template <typename T>
__device__ __forceinline__ T down(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);     // round to nearest even, as PyTorch's cast
}

// Elements of T per device-memory access for units of V: 16 bytes, or the
// unit where it is shorter (V = 4 in bf16: 8 bytes), or 1 (V = 1)
template <typename T, int V>
__host__ __device__ constexpr int access_elems() {
  return V == 1 ? 1 : (V < static_cast<int>(16 / sizeof(T)) ? V : static_cast<int>(16 / sizeof(T)));
}

// F consecutive elements of T, held as floats: one access of F sizeof(T)
// bytes. The device-memory accesses that are a value's last (an output,
// the second sweep's reads) stream (evict first), so that L2 keeps what
// the second sweep reads again.
template <typename T, int F>
struct Vec {
  using Word = typename Raw<F * static_cast<int>(sizeof(T))>::type;
  float v[F];
  __device__ __forceinline__ void load(const T* __restrict__ p, bool last = false) {
    const Word* q = reinterpret_cast<const Word*>(p);
    alignas(16) T e[F];
    *reinterpret_cast<Word*>(e) = last ? __ldcs(q) : *q;
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = up(e[j]);
  }
  __device__ __forceinline__ Word word() const {
    if constexpr (std::is_same_v<T, bf16> && F % 2 == 0) {
      alignas(16) __nv_bfloat162 e[F / 2];      // two roundings to nearest even at once
#pragma unroll
      for (int j = 0; j < F / 2; ++j) e[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      return *reinterpret_cast<const Word*>(e);
    } else {
      alignas(16) T e[F];
#pragma unroll
      for (int j = 0; j < F; ++j) e[j] = down<T>(v[j]);
      return *reinterpret_cast<const Word*>(e);
    }
  }
  __device__ __forceinline__ void store(T* __restrict__ p) const {
    *reinterpret_cast<Word*>(p) = word();
  }
  __device__ __forceinline__ void stream(T* __restrict__ p) const {
    __stcs(reinterpret_cast<Word*>(p), word());
  }
};

// F elements of T held as loaded (one access; bf16 stays packed, so the
// loads in flight take half the registers of floats), `last` as Vec's
template <typename T, int F>
struct Packed {
  using Word = typename Raw<F * static_cast<int>(sizeof(T))>::type;
  Word w;
  __device__ __forceinline__ void load(const T* __restrict__ p, bool last = false) {
    const Word* q = reinterpret_cast<const Word*>(p);
    w = last ? __ldcs(q) : *q;
  }
  __device__ __forceinline__ float operator[](int j) const {
    return up(reinterpret_cast<const T*>(&w)[j]);
  }
  __device__ __forceinline__ Vec<T, F> unpacked() const {
    Vec<T, F> v;
#pragma unroll
    for (int j = 0; j < F; ++j) v.v[j] = (*this)[j];
    return v;
  }
};

// N bytes (16, or 8 for a bf16 2x2 unit) from device to shared memory,
// asynchronously (cp.async; the thread that waits with cp_async_wait_all()
// sees them)
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    static_assert(N == 8, "cp.async of 16 or 8 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// F floats to and from shared memory, 16 bytes at a time (F a multiple of
// 4; F = 1 only on paths that keep nothing on chip)
template <int F>
__device__ __forceinline__ void put_floats(float* p, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) p[j] = v[j];
  }
}

template <int F>
__device__ __forceinline__ void get_floats(const float* p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = p[j];
  }
}

// This CTA's units of a channel, and where its elements lie in device
// memory. A unit is a Philox group of V elements; the sweeps walk the
// share F elements at a time, neighbouring threads on neighbouring 16
// bytes.
struct Share {
  unsigned lo, n;           // first unit (of the channel's) and count
  int vec;
  int hw_shift;             // log2(hw) where hw is a power of two, else -1
  unsigned hw;              // strip length
  long long chw;            // C H W

  // the flat NCHW index of the channel's element ce (channel-local, < 2^31)
  __device__ __forceinline__ long long at(unsigned ce, int ch) const {
    const unsigned row = hw_shift >= 0 ? ce >> hw_shift : ce / hw;
    return static_cast<long long>(row) * chw +
           (static_cast<long long>(ch) * hw + (ce - row * hw));
  }
  // the share's element l (l = 0 is unit lo's first)
  __device__ __forceinline__ long long elem(unsigned l, int ch) const {
    return at(lo * static_cast<unsigned>(vec) + l, ch);
  }
};

__device__ __forceinline__ Share share_of(const SegPlan& p, unsigned rank) {
  const unsigned long long units = static_cast<unsigned long long>(p.b) * p.hw / p.vec;
  Share s;
  s.lo = static_cast<unsigned>(units * rank / p.cluster);
  s.n = static_cast<unsigned>(units * (rank + 1) / p.cluster) - s.lo;
  s.vec = p.vec;
  s.hw_shift = (p.hw & (p.hw - 1)) == 0 ? __ffsll(p.hw) - 1 : -1;
  s.hw = static_cast<unsigned>(p.hw);
  s.chw = static_cast<long long>(p.c) * p.hw;
  return s;
}

// units [u0, u0 + n) of the share: their keep words into keep[0 .. n),
// one Philox call each (nothing without a mask)
template <int V>
__device__ __forceinline__ void keep_words(const Share& sh, int ch, const Drop& d, unsigned u0,
                                           unsigned n, uint32_t* keep) {
  if (!d.on) return;
  for (unsigned u = threadIdx.x; u < n; u += blockDim.x) {
    keep[u] = keep_bits<V>(d, sh.elem((u0 + u) * V, ch));
  }
}

// the keep bits of the elements from the share's element l (bit 0 is l's),
// of a chunk whose keep words start at unit u0
template <int V>
__device__ __forceinline__ uint32_t keep_of(const Drop& d, const uint32_t* keep, unsigned u0,
                                            unsigned l) {
  if (!d.on) return 0xFFFFFFFFu;
  return keep[l / V - u0] >> (l % V);
}

// Lanes 0-15's (a, b) summed in a fixed butterfly (IEEE addition commutes,
// so every lane ends with the same bits); lanes 16-31 hold zeros
__device__ __forceinline__ void sum16(double& a, double& b) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, o);
  }
}

// The cluster barrier in two halves (barrier.cluster, release then
// acquire): the kernel arrives once its last distributed shared memory
// read is done and waits just before it exits, so no CTA exits while
// another may still read its `red`, and the wait overlaps the output.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The channel's two fp64 sums in every thread of every CTA of the cluster:
// each CTA's by a fixed tree (shuffles within the warps, then, in every
// warp, a butterfly over the warps' pairs, so that no warp waits for
// another after the one barrier), the CTAs' through distributed shared
// memory in a fixed butterfly over the ranks, again in every warp; a
// cluster of one skips the exchange. Every warp ends with the same bits.
// (Warp 0 alone reading the ranks' pairs and handing the total on through
// shared memory measured up to 14% slower in clusters of 2-16.) `red`
// alternates between two slots from one channel to the next: a CTA writes
// a slot again only after the next channel's cluster.sync(), which every
// thread reaches after reading it; warp_sums is written again only after
// the next channel's first barrier.
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, double& s1,
                                             double& s2, double (*warp_sums)[2], double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(0xFFFFFFFFu, s1, o);
    s2 += __shfl_down_sync(0xFFFFFFFFu, s2, o);
  }
  const unsigned lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[threadIdx.x >> 5][0] = s1;
    warp_sums[threadIdx.x >> 5][1] = s2;
  }
  __syncthreads();
  const unsigned k = cluster.num_blocks();
  const bool mine = lane < (blockDim.x >> 5);
  double a = mine ? warp_sums[lane][0] : 0.0, b = mine ? warp_sums[lane][1] : 0.0;
  sum16(a, b);
  if (k > 1) {
    if (threadIdx.x == 0) {
      red[0] = a;
      red[1] = b;
    }
    cluster.sync();
    // lane r reads rank r's pair, one 16-byte access
    a = 0.0;
    b = 0.0;
    if (lane < k) {
      const double2 q = *reinterpret_cast<const double2*>(cluster.map_shared_rank(red, lane));
      a = q.x;
      b = q.y;
    }
    sum16(a, b);
  }
  s1 = __shfl_sync(0xFFFFFFFFu, a, 0);
  s2 = __shfl_sync(0xFFFFFFFFu, b, 0);
}

// The keep words of the units swept twice are staged kChunk at a time
constexpr unsigned kChunk = 2048;

// For each unit chunk [u0, u0 + nu) of the units [from, sh.n) of the
// share, in order, or last to first where `reverse` (the second sweep:
// what the first sweep read last is the likeliest still in L2): its keep
// words staged in keep[0 .. nu) (the second sweep of a single chunk keeps
// the first's), then for every F elements, kUnroll accesses in flight per
// thread: load(k, e, reverse) of the element e, then body(k, l, bits) with
// l the share's element index and bits their keep bits
template <int V, int F, int kUnroll, typename Load, typename Body>
__device__ __forceinline__ void sweep_rest(const Share& sh, int ch, const Drop& d,
                                           unsigned from, bool reverse, uint32_t* keep,
                                           Load&& load, Body&& body) {
  const unsigned T = blockDim.x;
  const unsigned chunks = sh.n > from ? (sh.n - from + kChunk - 1) / kChunk : 0;
  for (unsigned q = 0; q < chunks; ++q) {
    const unsigned u0 = from + (reverse ? chunks - 1 - q : q) * kChunk;
    const unsigned nu = min(kChunk, sh.n - u0), m = nu * V / F, l0 = u0 * V;
    if (chunks > 1 || !reverse) {
      __syncthreads();
      keep_words<V>(sh, ch, d, u0, nu, keep);
      __syncthreads();
    }
    for (unsigned i = threadIdx.x; i < m; i += kUnroll * T) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (i + k * T < m) load(k, sh.elem(l0 + (i + k * T) * F, ch), reverse);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (i + k * T < m) {
          const unsigned l = l0 + (i + k * T) * F;
          body(k, l, keep_of<V>(d, keep, u0, l));
        }
      }
    }
  }
}

// A channel's statistics from its sums s1 = sum(u), s2 = sum(u^2): mean =
// s1 / n and var = s2 / n - mean^2 in fp64, 1 / n a multiplication (exact
// where n is a power of two, as at every model shape; else within an fp64
// ulp of the quotient), r = rsqrt(var + eps) in fp64 (within an fp64 ulp,
// with no division or square root slow path on the way), each rounded once
// to fp32 as the plain version rounds its fp64 values
struct Coef {
  float mean, var, r;
};

__device__ __forceinline__ Coef coef_of(double s1, double s2, double inv_n, double eps) {
  const double mean = s1 * inv_n;
  const double var = s2 * inv_n - mean * mean;
  return Coef{static_cast<float>(mean), static_cast<float>(var),
              static_cast<float>(rsqrt(var + eps))};
}

#if !LVAE_SEGMENT_SPLIT
template <typename T>
struct FwdArgs {
  const T* x;
  const float* gamma;
  const float* beta;
  float* running_mean;      // NULL: not moved
  float* running_var;
  T* y;
  float* stats;             // [5, c]: mean, var, r, scale, shift
  SegPlan p;
  Drop d;
  double eps;
  double inv_n;             // 1 / (b hw)
  float momentum, one_minus_momentum;
};

// K5: stats, then y, in one launch. The first p.chip units of a CTA's
// share are staged in shared memory in element order (cp.async, all in
// flight while their keep words are computed) and read back for y, each
// slot then taking the CTA's next channel; fp32 turns x into u in place,
// bf16 keeps x and drops it again. The rest of the share (none where it
// fits) is read twice from device memory. Shared memory: [chip V] of T,
// [chip] keep words, [kChunk] keep words of the rest.
template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kMaxThreads, 2) fwd_kernel(const FwdArgs<T> a) {
  constexpr int F = access_elems<T, V>();
  constexpr int kBytes = F * static_cast<int>(sizeof(T));
  constexpr bool kInPlace = std::is_same_v<T, float>;
  constexpr int kUnroll = 4;
  extern __shared__ float4 smem4[];
  __shared__ double warp_sums[kMaxThreads / 32][2];
  __shared__ __align__(16) double red[2][2];
  cg::cluster_group cluster = cg::this_cluster();
  const Share sh = share_of(a.p, cluster.block_rank());
  const unsigned chip = static_cast<unsigned>(a.p.chip);
  T* x_smem = reinterpret_cast<T*>(smem4);
  uint32_t* keep_chip = reinterpret_cast<uint32_t*>(x_smem + static_cast<size_t>(V) * chip);
  uint32_t* keep_rest = keep_chip + chip;
  const Drop d = drop_key(a.d);
  const int c = a.p.c;
  const unsigned T_ = blockDim.x;
  const unsigned n_chip = min(sh.n, chip), m_chip = n_chip * V / F;
  auto drop = [&](Vec<T, F>& v, uint32_t bits) {
#pragma unroll
    for (int j = 0; j < F; ++j) v.v[j] = dropped(d, v.v[j], (bits >> j) & 1u);
  };
  const int ch_step = gridDim.x / a.p.cluster;
  // the chip units of channel ch into shared memory, asynchronously
  auto stage = [&](int ch) {
    if constexpr (V > 1) {
      for (unsigned i = threadIdx.x; i < m_chip; i += T_) {
        cp_async<kBytes>(x_smem + i * F, a.x + sh.elem(i * F, ch));
      }
    }
  };
  const bool multi = cluster.num_blocks() > 1;
  const bool writer = cluster.block_rank() == 0 && threadIdx.x == 0;
  stage(blockIdx.x / a.p.cluster);
  for (int ch = blockIdx.x / a.p.cluster; ch < c; ch += ch_step) {
    const int next = ch + ch_step;
    // the channel's parameters, loaded while its copies are in flight
    const float gam = a.gamma[ch], bet = a.beta[ch];
    float rm = 0.0f, rv = 0.0f;
    if (writer && a.running_mean != nullptr) {
      rm = a.running_mean[ch];
      rv = a.running_var[ch];
    }
    double s1 = 0.0, s2 = 0.0;
    auto add = [&](const Vec<T, F>& v) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const double u = v.v[j];
        s1 += u;
        s2 = __fma_rn(u, u, s2);
      }
    };
    Packed<T, F> buf[kUnroll];
    auto load = [&](int k, long long e, bool last) { buf[k].load(a.x + e, last); };
    if constexpr (V > 1) {
      // channel ch's copies were issued by stage() before the loop or
      // during the previous channel's output (which, in bf16, has read
      // keep_chip)
      if constexpr (!kInPlace) __syncthreads();
      keep_words<V>(sh, ch, d, 0, n_chip, keep_chip);
      cp_async_wait_all();
      __syncthreads();
      for (unsigned i = threadIdx.x; i < m_chip; i += T_) {
        Vec<T, F> v;
        v.load(x_smem + i * F);
        drop(v, keep_of<V>(d, keep_chip, 0, i * F));
        add(v);
        if constexpr (kInPlace) v.store(x_smem + i * F);
      }
    }
    sweep_rest<V, F, kUnroll>(sh, ch, d, n_chip, false, keep_rest, load,
                              [&](int k, unsigned, uint32_t bits) {
                                Vec<T, F> v = buf[k].unpacked();
                                drop(v, bits);
                                add(v);
                              });
    const int slot = (ch / ch_step) & 1;
    cluster_sums(cluster, s1, s2, warp_sums, red[slot]);
    if (multi && next >= c) cluster_arrive();
    const Coef co = coef_of(s1, s2, a.inv_n, a.eps);
    const float scale = gam * co.r;
    const float shift = bet - co.mean * scale;
    if (writer) {
      a.stats[ch] = co.mean;
      a.stats[c + ch] = co.var;
      a.stats[2 * c + ch] = co.r;
      a.stats[3 * c + ch] = scale;
      a.stats[4 * c + ch] = shift;
      if (a.running_mean != nullptr) {
        a.running_mean[ch] = a.momentum * rm + a.one_minus_momentum * co.mean;
        a.running_var[ch] = a.momentum * rv + a.one_minus_momentum * co.var;
      }
    }
    auto emit = [&](Vec<T, F>& v, unsigned l) {
#pragma unroll
      for (int j = 0; j < F; ++j) v.v[j] = act_out<T, kAct>(v.v[j] * scale + shift);
      v.stream(a.y + sh.elem(l, ch));
    };
    if constexpr (V > 1) {
      // each slot, once read, takes the next channel's x (the thread
      // that reads a slot is the one that fills it)
      for (unsigned i = threadIdx.x; i < m_chip; i += T_) {
        Vec<T, F> v;
        v.load(x_smem + i * F);
        if constexpr (!kInPlace) drop(v, keep_of<V>(d, keep_chip, 0, i * F));
        emit(v, i * F);
        if (next < c) cp_async<kBytes>(x_smem + i * F, a.x + sh.elem(i * F, next));
      }
    }
    sweep_rest<V, F, kUnroll>(sh, ch, d, n_chip, true, keep_rest, load,
                              [&](int k, unsigned l, uint32_t bits) {
                                Vec<T, F> v = buf[k].unpacked();
                                drop(v, bits);
                                emit(v, l);
                              });
  }
  if (multi) cluster_wait();   // no CTA exits while another may read its `red`
}

template <typename T>
struct BwdArgs {
  const T* x;
  const T* g;
  const float* gamma;
  const float* stats;       // the forward's [5, c]
  T* dx;
  float* dgb;               // [2, c]: dgamma, dbeta
  SegPlan p;
  Drop d;
  double inv_n;             // 1 / (b hw)
};

// K5-bwd: sum(dz), sum(dz xhat), then dx, in one launch. As the forward:
// the first p.chip units of the share of g and x are staged. The first
// sweep turns g into dz in an fp32 slot an access (bf16's raw g is copied
// into the first half of its slot), so the second sweep takes dz as it is,
// with no act'(z) again; fp32 turns x into xhat in place, bf16 keeps x and
// recomputes xhat (a select and two operations). The rest is read twice.
// Shared memory: [chip V] floats of dz, [chip V] of T for x (xhat), [chip]
// keep words, [kChunk] keep words.
template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kMaxThreads, 2) bwd_kernel(const BwdArgs<T> a) {
  constexpr int F = access_elems<T, V>();
  constexpr int kBytes = F * static_cast<int>(sizeof(T));
  constexpr bool kInPlace = std::is_same_v<T, float>;
  constexpr int kUnroll = 2;
  extern __shared__ float4 smem4[];
  __shared__ double warp_sums[kMaxThreads / 32][2];
  __shared__ __align__(16) double red[2][2];
  cg::cluster_group cluster = cg::this_cluster();
  const Share sh = share_of(a.p, cluster.block_rank());
  const unsigned chip = static_cast<unsigned>(a.p.chip);
  float* dz_smem = reinterpret_cast<float*>(smem4);
  T* x_smem = reinterpret_cast<T*>(dz_smem + static_cast<size_t>(V) * chip);
  uint32_t* keep_chip = reinterpret_cast<uint32_t*>(x_smem + static_cast<size_t>(V) * chip);
  uint32_t* keep_rest = keep_chip + chip;
  const Drop d = drop_key(a.d);
  const int c = a.p.c;
  const unsigned T_ = blockDim.x;
  const unsigned n_chip = min(sh.n, chip), m_chip = n_chip * V / F;
  const int ch_step = gridDim.x / a.p.cluster;
  // slot i's g and x of channel ch into shared memory, asynchronously
  auto stage_slot = [&](unsigned i, int ch) {
    if constexpr (V > 1) {
      const long long e = sh.elem(i * F, ch);
      cp_async<kBytes>(dz_smem + i * F, a.g + e);
      cp_async<kBytes>(x_smem + i * F, a.x + e);
    }
  };
  if constexpr (V > 1) {
    for (unsigned i = threadIdx.x; i < m_chip; i += T_) stage_slot(i, blockIdx.x / a.p.cluster);
  }
  const bool multi = cluster.num_blocks() > 1;
  for (int ch = blockIdx.x / a.p.cluster; ch < c; ch += ch_step) {
    const int next = ch + ch_step;
    // the channel's parameters, loaded while its copies are in flight
    const float mean = a.stats[ch], r = a.stats[2 * c + ch];
    const float scale = a.stats[3 * c + ch], shift = a.stats[4 * c + ch];
    const float gr = a.gamma[ch] * r;
    // g, x -> dz, xhat of F elements, in place
    auto recompute = [&](Vec<T, F>& dz, Vec<T, F>& xhat, uint32_t bits) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float u = dropped(d, xhat.v[j], (bits >> j) & 1u);
        dz.v[j] = dz.v[j] * act_grad<kAct>(u * scale + shift);
        xhat.v[j] = (u - mean) * r;
      }
    };
    double s1 = 0.0, s2 = 0.0;
    auto add = [&](const Vec<T, F>& dz, const Vec<T, F>& xhat) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        s1 += static_cast<double>(dz.v[j]);
        s2 += static_cast<double>(dz.v[j] * xhat.v[j]);
      }
    };
    Packed<T, F> gb[kUnroll], xb[kUnroll];
    auto load = [&](int k, long long e, bool last) {
      gb[k].load(a.g + e, last);
      xb[k].load(a.x + e, last);
    };
    if constexpr (V > 1) {
      __syncthreads();     // the previous channel's output has read keep_chip
      keep_words<V>(sh, ch, d, 0, n_chip, keep_chip);
      cp_async_wait_all();
      __syncthreads();
      for (unsigned i = threadIdx.x; i < m_chip; i += T_) {
        Vec<T, F> dz, xhat;
        dz.load(reinterpret_cast<const T*>(dz_smem + i * F));
        xhat.load(x_smem + i * F);
        recompute(dz, xhat, keep_of<V>(d, keep_chip, 0, i * F));
        add(dz, xhat);
        put_floats<F>(dz_smem + i * F, dz.v);
        if constexpr (kInPlace) xhat.store(x_smem + i * F);
      }
    }
    sweep_rest<V, F, kUnroll>(sh, ch, d, n_chip, false, keep_rest, load,
                              [&](int k, unsigned, uint32_t bits) {
                                Vec<T, F> dz = gb[k].unpacked(), xhat = xb[k].unpacked();
                                recompute(dz, xhat, bits);
                                add(dz, xhat);
                              });
    const int slot = (ch / ch_step) & 1;
    cluster_sums(cluster, s1, s2, warp_sums, red[slot]);
    if (multi && next >= c) cluster_arrive();
    const float m1 = static_cast<float>(s1 * a.inv_n), m2 = static_cast<float>(s2 * a.inv_n);
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
      a.dgb[ch] = static_cast<float>(s2);
      a.dgb[c + ch] = static_cast<float>(s1);
    }
    auto emit = [&](Vec<T, F>& dz, const Vec<T, F>& xhat, uint32_t bits, unsigned l) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float du = gr * ((dz.v[j] - m1) - xhat.v[j] * m2);
        dz.v[j] = d.on ? (((bits >> j) & 1u) ? du * d.scale : 0.0f) : du;
      }
      dz.stream(a.dx + sh.elem(l, ch));
    };
    if constexpr (V > 1) {
      for (unsigned i = threadIdx.x; i < m_chip; i += T_) {
        Vec<T, F> dz, xhat;
        get_floats<F>(dz_smem + i * F, dz.v);
        xhat.load(x_smem + i * F);
        const uint32_t bits = keep_of<V>(d, keep_chip, 0, i * F);
        if constexpr (!kInPlace) {
#pragma unroll
          for (int j = 0; j < F; ++j) {
            xhat.v[j] = (dropped(d, xhat.v[j], (bits >> j) & 1u) - mean) * r;
          }
        }
        emit(dz, xhat, bits, i * F);
        if (next < c) stage_slot(i, next);
      }
    }
    sweep_rest<V, F, kUnroll>(sh, ch, d, n_chip, true, keep_rest, load,
                              [&](int k, unsigned l, uint32_t bits) {
                                Vec<T, F> dz = gb[k].unpacked(), xhat = xb[k].unpacked();
                                recompute(dz, xhat, bits);
                                emit(dz, xhat, bits, l);
                              });
  }
  if (multi) cluster_wait();   // no CTA exits while another may read its `red`
}
#endif  // !LVAE_SEGMENT_SPLIT

// the bytes are drawn only for 0 < t < 256, and then the step is needed
Drop make_drop(int t, unsigned long long seed, unsigned long long site, const void* step) {
  Drop d;
  d.on = t < 256;
  d.t = t;
  d.scale = t > 0 ? static_cast<float>(256.0 / t) : 0.0f;
  d.seed = seed;
  d.site = site;
  d.step = t > 0 && t < 256 ? static_cast<const long long*>(step) : nullptr;
  d.k0 = d.k1 = 0;
  d.at = lvae::ElementMap{0, 0, 0};
  return d;
}

bool bad_key(int t, const void* step) { return t > 0 && t < 256 && step == nullptr; }

#if !LVAE_SEGMENT_SPLIT
// dynamic shared memory per CTA: the chip units' data (x forward, esize
// bytes per element; dz, 4 bytes, and x backward) and keep words, and the
// keep words of a chunk of the units swept twice, where the share has more
// than chip
long long smem_of(const SegPlan& p, bool bwd) {
  const long long units = p.b * p.hw / p.vec;
  const long long stride = (units + p.cluster - 1) / p.cluster;
  const long long rest = stride - p.chip;
  return p.chip * ((bwd ? 4LL + p.esize : p.esize) * p.vec + 4) +
         4LL * (rest < kChunk ? rest : kChunk);
}

// a plan the kernels take (kernels/segment.py _plan makes only these)
bool bad_plan(const SegPlan& p, bool bwd) {
  if (p.b < 1 || p.c < 1 || p.hw < 1 || p.b * p.hw > 0x7FFFFFFFLL) return true;
  if (p.esize != 4 && p.esize != 2) return true;
  if ((p.vec != 1 && p.vec != 4 && p.vec != 16) || p.hw % p.vec != 0) return true;
  if (p.cluster < 1 || p.cluster > 16 || p.threads < 32 || p.threads > kMaxThreads ||
      p.threads % 32 != 0 || p.clusters < 1 || p.clusters > p.c) return true;
  const long long stride = (p.b * p.hw / p.vec + p.cluster - 1) / p.cluster;
  if (p.chip < 0 || p.chip > stride || (p.vec == 1 && p.chip != 0)) return true;
  return static_cast<long long>(p.smem) != smem_of(p, bwd);
}

template <typename Args>
using Kernel = void (*)(Args);

template <typename T>
Kernel<FwdArgs<T>> pick_fwd(const SegPlan& p, int act) {
  if (p.vec == 16) return act == kElu ? fwd_kernel<T, 16, kElu> : fwd_kernel<T, 16, kRelu>;
  if (p.vec == 4) return act == kElu ? fwd_kernel<T, 4, kElu> : fwd_kernel<T, 4, kRelu>;
  return act == kElu ? fwd_kernel<T, 1, kElu> : fwd_kernel<T, 1, kRelu>;
}

template <typename T>
Kernel<BwdArgs<T>> pick_bwd(const SegPlan& p, int act) {
  if (p.vec == 16) return act == kElu ? bwd_kernel<T, 16, kElu> : bwd_kernel<T, 16, kRelu>;
  if (p.vec == 4) return act == kElu ? bwd_kernel<T, 4, kElu> : bwd_kernel<T, 4, kRelu>;
  return act == kElu ? bwd_kernel<T, 1, kElu> : bwd_kernel<T, 1, kRelu>;
}

// The launch configuration of a plan. The first use of a kernel allows it
// the most dynamic shared memory and clusters of 16 (non-portable).
template <typename Args>
cudaError_t config_of(Kernel<Args> fn, const SegPlan& p, cudaStream_t s,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  static const void* ready[64];
  static int n_ready = 0;
  bool found = false;
  for (int i = 0; i < n_ready; ++i) found = found || ready[i] == reinterpret_cast<const void*>(fn);
  if (!found) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, fn);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax - static_cast<int>(fa.sharedSizeBytes));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    if (n_ready < 64) ready[n_ready++] = reinterpret_cast<const void*>(fn);
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(p.clusters) * p.cluster);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// cudaOccupancyMaxActiveClusters of a configuration (0 where it fails),
// asked once per kernel and plan shape
template <typename Args>
int active_clusters(Kernel<Args> fn, const SegPlan& p, const cudaLaunchConfig_t& cfg) {
  struct Seen {
    const void* fn;
    int cluster, threads, smem, n;
  };
  static Seen seen[256];
  static int n_seen = 0;
  const void* key = reinterpret_cast<const void*>(fn);
  for (int i = 0; i < n_seen; ++i) {
    const Seen& e = seen[i];
    if (e.fn == key && e.cluster == p.cluster && e.threads == p.threads && e.smem == p.smem) {
      return e.n;
    }
  }
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  if (n_seen < 256) seen[n_seen++] = Seen{key, p.cluster, p.threads, p.smem, n};
  return n;
}

// One launch of fn with plan p: a grid of at most as many clusters as fit
// on the card at once, which walk the channels (the order of every sum
// depends on the shape alone, not on the grid).
template <typename Args>
int launch(Kernel<Args> fn, const SegPlan& p, const Args& args, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = config_of(fn, p, s, attr, &cfg);
  if (err == cudaSuccess) {
    const int n = active_clusters(fn, p, cfg);
    if (n > 0 && n < p.clusters) cfg.gridDim = dim3(static_cast<unsigned>(n) * p.cluster);
    err = cudaLaunchKernelEx(&cfg, fn, args);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The dropout alone, for a bits8 Dropout that no segment absorbs (the
// trailing 'd' of a residual block, or every dropout without --fused
// segments|all): y = u, the segment's dropped input, under the segment's
// bytes and key, in x's storage type T (fp32 or bf16: u computed in fp32,
// rounded to nearest even, as FastDropout casts it back). Linear in x, so
// the backward is the same kernel on the cotangent. A thread takes 16
// consecutive elements, one Philox call; its bound is the bytes, x read
// and y written once (2 sizeof(T) B an element). The port's plain version
// (ops/philox.py dropout_bytes, ~270 PyTorch ops a call) would put
// hundreds of launches a site into every train step.
template <typename T>
__global__ void __launch_bounds__(256) dropout_kernel(const T* __restrict__ x,
                                                     T* __restrict__ y, long long n,
                                                     const Drop a) {
  constexpr int G = 16 / static_cast<int>(sizeof(T));   // elements per 16-byte access
  const Drop d = drop_key(a);
  const long long groups = (n + 15) / 16;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  for (long long grp = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       grp < groups; grp += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e0 = grp * 16;
    // the bytes of the global elements of e0 on: one Philox call where
    // they are one run that starts a group of 16, else one per element (a
    // rank's part of a batch whose per-rank size is not a multiple of 16,
    // or a band whose rows of a channel are not)
    const long long g0 = global_at(d, e0);
    const bool run = d.at.plane == 0 || (e0 % d.at.plane) + 16 <= d.at.plane;
    const uint32_t bits = run && (g0 & 15) == 0 ? keep_bits<16>(d, g0)
                          : run ? keep_bits_at(d, g0) : keep_bits_mapped(d, e0);
    if (vec && e0 + 16 <= n) {
      if constexpr (std::is_same_v<T, float>) {
        // float4 by float4, as before the bf16 instantiation: the generic
        // path below measured 1.46x this one's time in fp32 (PERF.md)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 v = reinterpret_cast<const float4*>(x + e0)[q];
          v.x = dropped(d, v.x, (bits >> (4 * q)) & 1u);
          v.y = dropped(d, v.y, (bits >> (4 * q + 1)) & 1u);
          v.z = dropped(d, v.z, (bits >> (4 * q + 2)) & 1u);
          v.w = dropped(d, v.w, (bits >> (4 * q + 3)) & 1u);
          reinterpret_cast<float4*>(y + e0)[q] = v;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16 / G; ++q) {
          Vec<T, G> v;
          v.load(x + e0 + q * G);
#pragma unroll
          for (int j = 0; j < G; ++j) v.v[j] = dropped(d, v.v[j], (bits >> (q * G + j)) & 1u);
          v.store(y + e0 + q * G);
        }
      }
    } else {
      for (int j = 0; j < 16 && e0 + j < n; ++j) {
        y[e0 + j] = down<T>(dropped(d, up(x[e0 + j]), (bits >> j) & 1u));
      }
    }
  }
}

template <typename T>
void launch_dropout(const void* x, void* y, long long n, const Drop& d, cudaStream_t s) {
  const long long groups = (n + 15) / 16;
  const long long blocks = (groups + 255) / 256;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  dropout_kernel<T><<<grid, 256, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), n, d);
}

template <typename T>
int segment_fwd(const SegPlan& p, const void* x, const void* gamma, const void* beta,
                void* running_mean, void* running_var, void* y, void* stats, int act,
                double eps, float momentum, float one_minus_momentum, const Drop& d,
                cudaStream_t s) {
  FwdArgs<T> a{static_cast<const T*>(x), static_cast<const float*>(gamma),
               static_cast<const float*>(beta), static_cast<float*>(running_mean),
               static_cast<float*>(running_var), static_cast<T*>(y),
               static_cast<float*>(stats), p, d, eps,
               1.0 / static_cast<double>(p.b * p.hw), momentum, one_minus_momentum};
  return launch(pick_fwd<T>(p, act), p, a, s);
}

template <typename T>
int segment_bwd(const SegPlan& p, const void* x, const void* g, const void* gamma,
                const void* stats, void* dx, void* dgb, int act, const Drop& d,
                cudaStream_t s) {
  BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(g),
               static_cast<const float*>(gamma), static_cast<const float*>(stats),
               static_cast<T*>(dx), static_cast<float*>(dgb), p, d,
               1.0 / static_cast<double>(p.b * p.hw)};
  return launch(pick_bwd<T>(p, act), p, a, s);
}

template <typename T>
cudaError_t max_clusters(const SegPlan& p, int direction, int act, int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err;
  if (direction == 0) {
    const Kernel<FwdArgs<T>> fn = pick_fwd<T>(p, act);
    err = config_of(fn, p, nullptr, attr, &cfg);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  } else {
    const Kernel<BwdArgs<T>> fn = pick_bwd<T>(p, act);
    err = config_of(fn, p, nullptr, attr, &cfg);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  }
  return err;
}
#endif  // !LVAE_SEGMENT_SPLIT

#if LVAE_SEGMENT_SPLIT
// ---------------------------------------------------------------------------
// K5-split and K5-bwd-split: the segment over R > 1 ranks (--num-data-shards)
//
// Replaces nothing of lvae_tpu by itself: on lvae_tpu's `data` mesh the
// segment's statistics are reductions over the global batch, which XLA's
// SPMD partitioner makes cross-shard (segment_pallas.py _segment_fwd_impl
// :291 and _segment_bwd_impl :318 over a sharded batch). One launch cannot
// hold an all-reduce, so at R > 1 each direction is two launches with the
// reduction over the ranks between them (kernels/segment.py _SplitSegment):
//   forward:  split_stats     x -> part [2, S, C] fp64: per channel and
//                             slice, sum(u) and sum(u^2) of this rank's rows;
//             all_reduce(part) over the ranks;
//             split_apply     the S slices summed; mean, var, r, scale and
//                             shift from the global sums and n = R B H W, as
//                             K5 computes them; y; the [5, C] statistics;
//                             the running statistics;
//   backward: split_bwd_reduce  x, g, stats -> part: sum(dz), sum(dz xhat);
//             all_reduce(a copy of part);
//             split_bwd_apply   dx from the global m1 = sum(dz) / n and
//                               m2 = sum(dz xhat) / n; dbeta and dgamma the
//                               rank's own sums (the train step sums the
//                               gradients over the ranks).
// The order is flax's BatchNorm and _segment_fwd_impl's: one sweep of
// sum(u) and sum(u^2) (the "fast variance"), var = E[u^2] - E[u]^2. The
// sums are fp64 element by element, as K5's (E[u^2] - mean^2 cancels in
// fp32), in a fixed order within a thread, a fixed tree within a block, a
// fixed butterfly over the slices and the collective across the ranks: two
// launches are bit-equal, and no float atomics are used. Dropout bytes are
// those of the global element: this rank's element e takes the byte of
// global element global_element(at, e) (its rows of the global batch: e +
// rank x the rank's element count; its band of them under
// --spatial-shards: the band map), so R ranks drop what one rank drops. A
// rank whose band is empty (b hw = 0) writes zero sums.
//
// What bounds it. Each launch reads its inputs once and writes its outputs
// once: 4 B an element (split_stats), 8 (split_apply, split_bwd_reduce) and
// 12 (split_bwd_apply) in fp32, half in bf16; at [32, 64, 32, 32] fp32 2.5,
// 5.0, 5.0 and 7.5 us at 3.35 TB/s. Against K5 the split costs a second
// read of x (and g), which the all-reduce between the launches forces.
// Per element the launches also take a dropout byte (a Philox call gives
// 16), convert to fp64 and add (F2F.F64.F32 issues at an eighth of the fp32
// rate), or apply ELU (expm1f, ~30 instructions) or its derivative (expf):
// in bf16, whose bytes are half, that work and not the bytes is what holds
// the launches at the largest maps. The design keeps the rest off the path:
// - Units, as K5's: 16 consecutive elements of one (row, channel) strip
//   where H W % 16 == 0, else 4 (a 2x2 map) or 1. A strip is one run of
//   global elements under both maps, so a unit's bytes are one Philox call
//   (~70 integer operations) where its run starts a Philox group (V = 16)
//   or word (V = 4), compared with t four at a time (below4); else element
//   by element (keep_bits_at, dropout_kernel's rule; no model's map makes
//   such runs).
// - A warp takes 32 units at a time (a tile): lane l draws unit l's keep
//   bits, the tile's V / F accesses a lane of 16 bytes (F elements: 4 in
//   fp32, 8 in bf16) run over the tile with neighbouring lanes on
//   neighbouring addresses, and a unit's bits reach the lanes that hold its
//   accesses by one shuffle. bf16 stays packed in registers until used.
// - Two stages in flight: a thread's tiles go in stages of kSplitAccesses
//   accesses (split_stage), and the next stage's loads are issued before
//   the current stage's bits are drawn and its elements used, so a
//   thread's Philox calls and arithmetic run under its loads.
// - No division per element: a unit's row is one multiply-high, an add
//   and a shift (FastDiv by the units of a strip, its magic computed on
//   the host), once per access.
// - The grid is (S, C), a block per (slice, channel), S and the block's
//   threads from kernels/segment.py split_plan, a function of the longest
//   band's shape alone (so every rank's part has one shape): one wave of
//   two blocks an SM on the small maps (4 slices of 8 warps at [32, 64, 32,
//   32]: 256 blocks, where a block per 2,048 elements took 1,024), more
//   slices where a warp would take more than 4 tiles (16 at [64, 64, 64,
//   64]); the all-reduced [2, S, C] sums shrink with S (a quarter at both).
// - The apply launches: every warp sums the S slices (a butterfly over its
//   lanes, the same bits in every warp and block of the channel) and
//   derives the channel's coefficients itself, after issuing its first
//   stage, so that no warp waits on another.
constexpr int kSplitMaxThreads = 256;
constexpr int kSplitAccesses = 4;     // 16-byte accesses of a stage, over the inputs

// tiles of 32 units in a stage of a thread's walk: kSplitAccesses accesses
// over the launch's `operands` inputs, at least one tile (the walk's
// mirror in tests/test_torch_segment_split.py takes the same)
template <typename T, int V>
__host__ __device__ constexpr int split_stage(int operands) {
  return kSplitAccesses / (operands * (V / access_elems<T, V>())) > 0
             ? kSplitAccesses / (operands * (V / access_elems<T, V>()))
             : 1;
}

// x / d for 0 <= x < 2^31 by a multiply-high, an add and a shift (the
// round-up method, s = ceil(log2 d))
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t div_of(const FastDiv& f, uint32_t x) {
  return (__umulhi(x, f.m) + x) >> f.s;
}

template <typename T>
struct SplitArgs {
  const T* x;
  const T* g;               // backward: the cotangent of y
  const float* gamma;
  const float* beta;
  const double* part;       // [2, S, C]: the forward's or the backward's global sums
  const double* local;      // backward: this rank's sums
  double* out_part;         // the reduce launches' output
  float* running_mean;      // NULL: not moved
  float* running_var;
  float* stats;             // [5, C]: written forward, read backward
  T* y;                     // forward y, backward dx
  float* dgb;               // backward: dgamma, dbeta [2, C]
  unsigned units;           // a channel's units, b hw / V
  unsigned hw;              // elements of a strip
  FastDiv per_row;          // units of a strip, hw / V
  int c, slices;
  long long gstride;        // global elements from a strip's first to the next's
  long long base;           // the global element of local element 0
  double n_global;          // elements per channel over every rank
  double eps;
  float momentum, one_minus_momentum;
  Drop d;
};

// unit u of channel ch: the flat NCHW index of its first element and, where
// g is given, that element's global element
template <int V, typename T>
__device__ __forceinline__ long long unit_at(const SplitArgs<T>& a, int ch, unsigned u,
                                             long long* g = nullptr) {
  const unsigned row = div_of(a.per_row, u);
  const unsigned within = (u - row * a.per_row.d) * V;
  const long long strip = static_cast<long long>(row) * a.c + ch;
  if (g != nullptr) *g = strip * a.gstride + a.base + within;
  return strip * a.hw + within;
}

// the keep bits of a unit of V elements from global element g0 (tt: t in
// every byte): one Philox call where the unit's run starts a group (V = 16)
// or a word (V = 4) of its bytes, compared four at a time; else element by
// element
template <int V>
__device__ __forceinline__ uint32_t keep_unit(const Drop& d, uint32_t tt, long long g0) {
  if (V > 1 && (g0 & (V - 1)) != 0) return keep_bits_at(d, g0, V);
  const unsigned long long grp = static_cast<unsigned long long>(g0) >> 4;
  const uint4 w = lvae::philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), static_cast<uint32_t>(grp >> 32), 0u, kStream),
      d.k0, d.k1);
  if constexpr (V == 16) {
    return below4(w.x, tt) | below4(w.y, tt) << 4 | below4(w.z, tt) << 8 |
           below4(w.w, tt) << 12;
  } else {
    return (below4(word_of(w, static_cast<int>((g0 >> 2) & 3)), tt) >> (g0 & 3)) &
           ((1u << V) - 1u);
  }
}

// a walk's stage 1 registers into stage 0 (split_walk's shift)
template <typename P, int kS, int A>
__device__ __forceinline__ void copy_stage(P (&buf)[2][kS][A]) {
#pragma unroll
  for (int k = 0; k < kS; ++k) {
#pragma unroll
    for (int q = 0; q < A; ++q) buf[0][k][q] = buf[1][k][q];
  }
}

// slice s's first unit of a channel
template <typename T>
__device__ __forceinline__ unsigned slice_lo(const SplitArgs<T>& a, int s) {
  return static_cast<unsigned>(static_cast<unsigned long long>(a.units) * s / a.slices);
}

// The units [lo, hi) of channel ch, a warp's tiles of 32 units at a time
// (tiles warp, warp + nw, ...), in stages of kS tiles, two stages in
// flight: load(s, k, q, e) of access q of the k-th tile of stage s (e its
// first element's index); once the thread has issued its first stage,
// ready() (in every thread: it may hold warp shuffles); then for each
// stage, in order, the next stage's loads and body(s, k, q, e, bits), bits
// the access's keep bits from bit 0. Every loop bound is the warp's, so the
// shuffles see every lane. With kOneBody, a loop iteration drains stage 0
// only and shift() then moves stage 1's registers to stage 0: one copy of
// body in the loop, which keeps a long body (ELU, the backward) within the
// instruction cache (a two-body loop of split_apply_kernel<bf16, 16> was
// 5,372 instructions and ran 1-16% slower); else the loop holds both
// stages' bodies and no copies (split_stats, a short body, 5% faster so).
template <typename T, int V, int kS, bool kOneBody, typename Load, typename Ready,
          typename Body, typename Shift>
__device__ __forceinline__ void split_walk(const SplitArgs<T>& a, const Drop& d, int ch,
                                           unsigned lo, unsigned hi, Load&& load,
                                           Ready&& ready, Body&& body, Shift&& shift) {
  constexpr int F = access_elems<T, V>(), A = V / F;
  const unsigned lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const unsigned tiles = (hi - lo + 31) / 32, step = nw * kS;
  const uint32_t tt = t_bytes(d);
  auto issue = [&](int s, unsigned t0) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const unsigned tu = lo + (t0 + k * nw) * 32;
#pragma unroll
      for (int q = 0; q < A; ++q) {
        const unsigned i = lane + 32 * q;
        if (t0 + k * nw < tiles && tu + i / A < hi) {
          load(s, k, q, unit_at<V>(a, ch, tu + i / A) + (i % A) * F);
        }
      }
    }
  };
  auto drain = [&](int s, unsigned t0) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      if (t0 + k * nw >= tiles) break;
      const unsigned tu = lo + (t0 + k * nw) * 32;
      uint32_t own = 0xFFFFFFFFu;
      if (d.on && tu + lane < hi) {
        long long g0;
        unit_at<V>(a, ch, tu + lane, &g0);
        own = keep_unit<V>(d, tt, g0);
      }
#pragma unroll
      for (int q = 0; q < A; ++q) {
        const unsigned i = lane + 32 * q;
        const uint32_t bits =
            (A == 1 ? own : __shfl_sync(0xFFFFFFFFu, own, i / A)) >> ((i % A) * F);
        if (tu + i / A < hi) body(s, k, q, unit_at<V>(a, ch, tu + i / A) + (i % A) * F, bits);
      }
    }
  };
  const unsigned warp = threadIdx.x >> 5;
  issue(0, warp);
  ready();
  if constexpr (kOneBody) {
    for (unsigned t0 = warp; t0 < tiles; t0 += step) {
      issue(1, t0 + step);
      drain(0, t0);
      shift();
    }
  } else {
    for (unsigned t0 = warp; t0 < tiles; t0 += 2 * step) {
      issue(1, t0 + step);
      drain(0, t0);
      issue(0, t0 + 2 * step);
      drain(1, t0 + step);
    }
  }
}

// the block's (s1, s2) in a fixed tree, in thread 0
__device__ __forceinline__ void block_sums(double& s1, double& s2) {
  __shared__ double ws[kSplitMaxThreads / 32][2];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(0xFFFFFFFFu, s1, o);
    s2 += __shfl_down_sync(0xFFFFFFFFu, s2, o);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ws[w][0] = s1;
    ws[w][1] = s2;
  }
  __syncthreads();
  if (w == 0) {
    const int nw = static_cast<int>(blockDim.x >> 5);
    s1 = lane < nw ? ws[lane][0] : 0.0;
    s2 = lane < nw ? ws[lane][1] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_down_sync(0xFFFFFFFFu, s1, o);
      s2 += __shfl_down_sync(0xFFFFFFFFu, s2, o);
    }
  }
}

// channel ch's two sums over the S slices of part, in every lane of the
// calling warp: lane l adds slices l, l + 32, ... in order, then a fixed
// butterfly over the lanes (IEEE addition commutes: every lane ends with the
// same bits, in every block of the channel)
__device__ __forceinline__ void slice_total(const double* part, int slices, int c, int ch,
                                            double& s1, double& s2) {
  s1 = 0.0;
  s2 = 0.0;
  for (int k = threadIdx.x & 31; k < slices; k += 32) {
    s1 += part[static_cast<long long>(k) * c + ch];
    s2 += part[static_cast<long long>(slices + k) * c + ch];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, o);
    s2 += __shfl_xor_sync(0xFFFFFFFFu, s2, o);
  }
}

// the reduce launches' output: this block's pair at slice s of channel ch
template <typename T>
__device__ __forceinline__ void put_part(const SplitArgs<T>& a, int s, int ch, double s1,
                                         double s2) {
  if (threadIdx.x == 0) {
    a.out_part[static_cast<long long>(s) * a.c + ch] = s1;
    a.out_part[static_cast<long long>(a.slices + s) * a.c + ch] = s2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kSplitMaxThreads) split_stats_kernel(const SplitArgs<T> a) {
  constexpr int F = access_elems<T, V>(), kS = split_stage<T, V>(1);
  const int s = blockIdx.x, ch = blockIdx.y;
  const Drop d = drop_key(a.d);
  Packed<T, F> xb[2][kS][V / F];
  double s1 = 0.0, s2 = 0.0;
  split_walk<T, V, kS, false>(
      a, d, ch, slice_lo(a, s), slice_lo(a, s + 1),
      [&](int st, int k, int q, long long e) { xb[st][k][q].load(a.x + e); }, [] {},
      [&](int st, int k, int q, long long, uint32_t bits) {
#pragma unroll
        for (int j = 0; j < F; ++j) {
          const double u = dropped(d, xb[st][k][q][j], (bits >> j) & 1u);
          s1 += u;
          s2 = __fma_rn(u, u, s2);
        }
      },
      [] {});
  block_sums(s1, s2);
  put_part(a, s, ch, s1, s2);
}

template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kSplitMaxThreads) split_apply_kernel(const SplitArgs<T> a) {
  constexpr int F = access_elems<T, V>(), kS = split_stage<T, V>(1);
  const int s = blockIdx.x, ch = blockIdx.y;
  const Drop d = drop_key(a.d);
  Packed<T, F> xb[2][kS][V / F];
  float scale = 0.0f, shift = 0.0f;
  split_walk<T, V, kS, true>(
      a, d, ch, slice_lo(a, s), slice_lo(a, s + 1),
      [&](int st, int k, int q, long long e) { xb[st][k][q].load(a.x + e); },
      [&] {
        // every warp derives the coefficients itself (the same bits in
        // each), so none waits for another
        double s1, s2;
        slice_total(a.part, a.slices, a.c, ch, s1, s2);
        const double mean_d = s1 / a.n_global;
        const double var_d = s2 / a.n_global - mean_d * mean_d;
        const float mean = static_cast<float>(mean_d);
        const float var = static_cast<float>(var_d);
        const float r = static_cast<float>(1.0 / sqrt(var_d + a.eps));
        scale = a.gamma[ch] * r;
        shift = a.beta[ch] - mean * scale;
        if (s == 0 && threadIdx.x == 0) {
          a.stats[ch] = mean;
          a.stats[a.c + ch] = var;
          a.stats[2 * a.c + ch] = r;
          a.stats[3 * a.c + ch] = scale;
          a.stats[4 * a.c + ch] = shift;
          if (a.running_mean != nullptr) {
            a.running_mean[ch] = a.momentum * a.running_mean[ch] + a.one_minus_momentum * mean;
            a.running_var[ch] = a.momentum * a.running_var[ch] + a.one_minus_momentum * var;
          }
        }
      },
      [&](int st, int k, int q, long long e, uint32_t bits) {
        Vec<T, F> v;
#pragma unroll
        for (int j = 0; j < F; ++j) {
          v.v[j] = act<kAct>(dropped(d, xb[st][k][q][j], (bits >> j) & 1u) * scale + shift);
        }
        v.store(a.y + e);
      },
      [&] { copy_stage(xb); });
}

// the forward's statistics of channel ch that dz and xhat are computed from
struct SplitStats {
  float mean, r, scale, shift;
};

template <typename T>
__device__ __forceinline__ SplitStats split_stats_of(const SplitArgs<T>& a, int ch) {
  return SplitStats{a.stats[ch], a.stats[2 * a.c + ch], a.stats[3 * a.c + ch],
                    a.stats[4 * a.c + ch]};
}

// dz and xhat of one element from x's v and g's dy, kept or not
template <int kAct>
__device__ __forceinline__ void split_dz(const Drop& d, const SplitStats& st, float v, float dy,
                                         bool keep, float& dz, float& xhat) {
  const float u = dropped(d, v, keep);
  dz = dy * act_grad<kAct>(u * st.scale + st.shift);
  xhat = (u - st.mean) * st.r;
}

template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kSplitMaxThreads) split_bwd_reduce_kernel(const SplitArgs<T> a) {
  constexpr int F = access_elems<T, V>(), kS = split_stage<T, V>(2);
  const int s = blockIdx.x, ch = blockIdx.y;
  const Drop d = drop_key(a.d);
  const SplitStats sts = split_stats_of(a, ch);
  Packed<T, F> xb[2][kS][V / F], gb[2][kS][V / F];
  double s1 = 0.0, s2 = 0.0;
  split_walk<T, V, kS, true>(
      a, d, ch, slice_lo(a, s), slice_lo(a, s + 1),
      [&](int st, int k, int q, long long e) {
        xb[st][k][q].load(a.x + e);
        gb[st][k][q].load(a.g + e);
      },
      [] {},
      [&](int st, int k, int q, long long, uint32_t bits) {
#pragma unroll
        for (int j = 0; j < F; ++j) {
          float dz, xhat;
          split_dz<kAct>(d, sts, xb[st][k][q][j], gb[st][k][q][j], (bits >> j) & 1u, dz, xhat);
          s1 += static_cast<double>(dz);
          s2 += static_cast<double>(dz * xhat);
        }
      },
      [&] {
        copy_stage(xb);
        copy_stage(gb);
      });
  block_sums(s1, s2);
  put_part(a, s, ch, s1, s2);
}

template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kSplitMaxThreads) split_bwd_apply_kernel(const SplitArgs<T> a) {
  constexpr int F = access_elems<T, V>(), kS = split_stage<T, V>(2);
  const int s = blockIdx.x, ch = blockIdx.y;
  const Drop d = drop_key(a.d);
  const SplitStats sts = split_stats_of(a, ch);
  const float gr = a.gamma[ch] * sts.r;
  Packed<T, F> xb[2][kS][V / F], gb[2][kS][V / F];
  float m1 = 0.0f, m2 = 0.0f;
  split_walk<T, V, kS, true>(
      a, d, ch, slice_lo(a, s), slice_lo(a, s + 1),
      [&](int st, int k, int q, long long e) {
        xb[st][k][q].load(a.x + e);
        gb[st][k][q].load(a.g + e);
      },
      [&] {
        double s1, s2;
        slice_total(a.part, a.slices, a.c, ch, s1, s2);   // in every warp, as the forward's
        m1 = static_cast<float>(s1 / a.n_global);
        m2 = static_cast<float>(s2 / a.n_global);
        if (s == 0 && threadIdx.x < 32) {
          slice_total(a.local, a.slices, a.c, ch, s1, s2);
          if (threadIdx.x == 0) {
            a.dgb[ch] = static_cast<float>(s2);
            a.dgb[a.c + ch] = static_cast<float>(s1);
          }
        }
      },
      [&](int st, int k, int q, long long e, uint32_t bits) {
        Vec<T, F> v;
#pragma unroll
        for (int j = 0; j < F; ++j) {
          const bool keep = (bits >> j) & 1u;
          float dz, xhat;
          split_dz<kAct>(d, sts, xb[st][k][q][j], gb[st][k][q][j], keep, dz, xhat);
          const float du = gr * ((dz - m1) - xhat * m2);
          v.v[j] = d.on ? (keep ? du * d.scale : 0.0f) : du;
        }
        v.store(a.y + e);
      },
      [&] {
        copy_stage(xb);
        copy_stage(gb);
      });
}

enum SplitLaunch { kSplitStats = 0, kSplitApply = 1, kSplitBwdReduce = 2, kSplitBwdApply = 3 };

template <typename T, int V, int kAct>
void split_launch_v(int which, const SplitArgs<T>& a, int threads, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.slices), static_cast<unsigned>(a.c));
  switch (which) {
    case kSplitStats: split_stats_kernel<T, V><<<grid, threads, 0, s>>>(a); break;
    case kSplitApply: split_apply_kernel<T, V, kAct><<<grid, threads, 0, s>>>(a); break;
    case kSplitBwdReduce: split_bwd_reduce_kernel<T, V, kAct><<<grid, threads, 0, s>>>(a); break;
    default: split_bwd_apply_kernel<T, V, kAct><<<grid, threads, 0, s>>>(a); break;
  }
}

template <typename T, int V>
void split_launch(int which, int act, const SplitArgs<T>& a, int threads, cudaStream_t s) {
  if (act == kElu) {
    split_launch_v<T, V, kElu>(which, a, threads, s);
  } else {
    split_launch_v<T, V, kRelu>(which, a, threads, s);
  }
}

// the arguments of every split launch, the pointers not a launch reads NULL
struct SplitCall {
  const void *x, *g, *gamma, *beta;
  const double *part, *local;
  double* out_part;
  void *running_mean, *running_var, *stats, *y, *dgb;
  long long b, hw;
  lvae::ElementMap at;
  int c, slices, threads, esize, t, act;
  double n_global, eps;
  float momentum, one_minus_momentum;
  unsigned long long seed, site;
  const void* step;
};

// the unit of a strip of hw elements (hw = 0, an empty band: no units)
int split_vec(long long hw) { return hw % 16 == 0 ? 16 : hw % 4 == 0 ? 4 : 1; }

template <typename T>
cudaError_t split_run(int which, const SplitCall& k, cudaStream_t s) {
  const int vec = split_vec(k.hw);
  SplitArgs<T> a{static_cast<const T*>(k.x), static_cast<const T*>(k.g),
                 static_cast<const float*>(k.gamma), static_cast<const float*>(k.beta),
                 k.part, k.local, k.out_part,
                 static_cast<float*>(k.running_mean), static_cast<float*>(k.running_var),
                 static_cast<float*>(k.stats), static_cast<T*>(k.y),
                 static_cast<float*>(k.dgb),
                 static_cast<unsigned>(k.b * k.hw / vec), static_cast<unsigned>(k.hw),
                 fast_div(k.hw > 0 ? static_cast<uint32_t>(k.hw / vec) : 1u), k.c, k.slices,
                 k.at.plane == 0 ? k.hw : k.at.gplane, k.at.base, k.n_global, k.eps,
                 k.momentum, k.one_minus_momentum, make_drop(k.t, k.seed, k.site, k.step)};
  if (vec == 16) {
    split_launch<T, 16>(which, k.act, a, k.threads, s);
  } else if (vec == 4) {
    split_launch<T, 4>(which, k.act, a, k.threads, s);
  } else {
    split_launch<T, 1>(which, k.act, a, k.threads, s);
  }
  return cudaGetLastError();
}

// whether a split launch can take its tensors: 16-byte accesses (8 for a
// bf16 unit of 4) need the data that aligned; a unit of 1 needs nothing
bool split_misaligned(const SplitCall& k) {
  if (split_vec(k.hw) == 1) return false;
  const uintptr_t align = static_cast<uintptr_t>(
      (split_vec(k.hw) == 4 ? 4 : 16 / k.esize) * k.esize);
  const void* data[3] = {k.x, k.g, k.y};
  for (const void* p : data) {
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % align != 0) return true;
  }
  return false;
}
#endif  // LVAE_SEGMENT_SPLIT

// a band map (plane, gplane, base) as the entry points take it: plane 0
// (a contiguous run from base) or a band of a taller map
bool bad_map(long long plane, long long gplane, long long base) {
  return plane < 0 || base < 0 || (plane > 0 && gplane < plane);
}

}  // namespace

#if !LVAE_SEGMENT_SPLIT
// The bits8 dropout alone: y = x where its byte (the segment's, under
// mix_seed(seed, *step, site)) is below t, scaled by 256 / t, else 0; for
// 0 < t < 256 (the caller takes the other thresholds). x and y [n], fp32
// (esize 4) or bf16 (esize 2); element e takes the byte of global element
// global_element({plane, gplane, base}, e) (a rank's part of the global
// batch, or its band of it; 0, 0, 0 on one rank).
extern "C" int lvae_dropout_bits8(const void* x, void* y, long long n, int esize, int t,
                                  unsigned long long seed, unsigned long long site,
                                  const void* step, long long plane, long long gplane,
                                  long long base, void* stream) {
  if (n < 0 || t <= 0 || t >= 256 || step == nullptr || (esize != 4 && esize != 2) ||
      bad_map(plane, gplane, base)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    Drop d = make_drop(t, seed, site, step);
    d.at = lvae::ElementMap{plane, gplane, base};
    const auto s = static_cast<cudaStream_t>(stream);
    if (esize == 4) {
      launch_dropout<float>(x, y, n, d, s);
    } else {
      launch_dropout<bf16>(x, y, n, d, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: x [b, c, hw] -> y, stats [5, c] (mean, var, r, scale, shift); moves
// running_mean / running_var (unless NULL). x and y of the plan's esize
// (4: fp32, 2: bf16), 16-byte aligned where the plan's vec is 4 or 16;
// gamma, beta, the running statistics and stats fp32. act 0 elu, 1 relu.
// The mask's key is mix_seed(seed, *step, site), step an int64 in device
// memory, read by the kernel (needed where 0 < t < 256, else it may be
// NULL).
extern "C" int lvae_segment_fwd(const SegPlan* plan, const void* x, const void* gamma,
                                const void* beta, void* running_mean, void* running_var,
                                void* y, void* stats, int t, int act, double eps,
                                float momentum, float one_minus_momentum,
                                unsigned long long seed, unsigned long long site,
                                const void* step, void* stream) {
  if (bad_plan(*plan, false) || (act != kElu && act != kRelu) || bad_key(t, step)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Drop d = make_drop(t, seed, site, step);
  const auto s = static_cast<cudaStream_t>(stream);
  return plan->esize == 4
             ? segment_fwd<float>(*plan, x, gamma, beta, running_mean, running_var, y, stats,
                                  act, eps, momentum, one_minus_momentum, d, s)
             : segment_fwd<bf16>(*plan, x, gamma, beta, running_mean, running_var, y, stats,
                                 act, eps, momentum, one_minus_momentum, d, s);
}

// K5-bwd: g [b, c, hw] with the forward's x and stats -> dx and dgb [2, c]
// (dgamma, dbeta, fp32); x, g and dx of the plan's esize, 16-byte aligned
// where vec is 4 or 16. The key as the forward's.
extern "C" int lvae_segment_bwd(const SegPlan* plan, const void* x, const void* g,
                                const void* gamma, const void* stats, void* dx, void* dgb,
                                int t, int act, unsigned long long seed,
                                unsigned long long site, const void* step, void* stream) {
  if (bad_plan(*plan, true) || (act != kElu && act != kRelu) || bad_key(t, step)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Drop d = make_drop(t, seed, site, step);
  const auto s = static_cast<cudaStream_t>(stream);
  return plan->esize == 4 ? segment_bwd<float>(*plan, x, g, gamma, stats, dx, dgb, act, d, s)
                          : segment_bwd<bf16>(*plan, x, g, gamma, stats, dx, dgb, act, d, s);
}

// cudaOccupancyMaxActiveClusters of a plan's kernel (direction 0 forward,
// 1 backward) into *out; returns the CUDA status.
extern "C" int lvae_segment_max_clusters(const SegPlan* plan, int direction, int act,
                                         int* out) {
  if (bad_plan(*plan, direction != 0) || (act != kElu && act != kRelu)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(plan->esize == 4 ? max_clusters<float>(*plan, direction, act, out)
                                           : max_clusters<bf16>(*plan, direction, act, out));
}
#endif  // !LVAE_SEGMENT_SPLIT

#if LVAE_SEGMENT_SPLIT
// K5-split / K5-bwd-split, the four launches of the segment over R > 1
// ranks (the comment above kSplitMaxThreads): `which` 0 split_stats, 1
// split_apply, 2 split_bwd_reduce, 3 split_bwd_apply, on a grid of
// (slices, c) blocks of `threads` (kernels/segment.py split_plan). x [b, c,
// hw] (and g, y / dx) of esize 4 (fp32) or 2 (bf16), 16-byte aligned (8 for
// bf16 where hw % 16 != 0) unless hw % 4 != 0; part, local and out_part [2,
// slices, c] fp64; gamma, beta, stats [5, c], the running statistics and
// dgb [2, c] fp32; n_global the elements per channel over every rank; the
// dropout key as K5's, element e taking global element global_element({plane,
// gplane, base}, e)'s byte, plane 0 (a run) or hw (a band of whole rows).
// hw may be 0 (a rank's empty band: zero sums, nothing written but the
// statistics). Returns the CUDA status.
extern "C" int lvae_segment_split(int which, const void* x, const void* g, const void* gamma,
                                  const void* beta, const double* part, const double* local,
                                  double* out_part, void* running_mean, void* running_var,
                                  void* stats, void* y, void* dgb, long long b, int c,
                                  long long hw, int slices, int threads, int esize, int t,
                                  int act, double n_global, double eps, float momentum,
                                  float one_minus_momentum, unsigned long long seed,
                                  unsigned long long site, const void* step, long long plane,
                                  long long gplane, long long base, void* stream) {
  if (which < kSplitStats || which > kSplitBwdApply || b < 1 || c < 1 || c > 65535 ||
      hw < 0 || b * hw > 0x7FFFFFFFLL || slices < 1 || slices > 65535 || threads < 32 ||
      threads > kSplitMaxThreads || threads % 32 != 0 || (esize != 4 && esize != 2) ||
      (act != kElu && act != kRelu) || bad_key(t, step) || bad_map(plane, gplane, base) ||
      (plane != 0 && plane != hw) || n_global < 1.0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SplitCall k{x, g, gamma, beta, part, local, out_part, running_mean, running_var,
                    stats, y, dgb, b, hw, lvae::ElementMap{plane, gplane, base}, c, slices,
                    threads, esize, t, act, n_global, eps, momentum, one_minus_momentum, seed,
                    site, step};
  if (split_misaligned(k)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(esize == 4 ? split_run<float>(which, k, s)
                                     : split_run<bf16>(which, k, s));
}
#endif  // LVAE_SEGMENT_SPLIT
