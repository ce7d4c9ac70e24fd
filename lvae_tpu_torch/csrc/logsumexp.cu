// logsumexp over the importance-sample axis: [k, B] row-major -> [B].
//
// Replaces lvae_tpu/kernels/logsumexp_pallas.py: _lse_impl (:36) with its
// body _kernel (:25). Per column: the max over k; a non-finite max (an all
// -inf column, a +inf or a NaN) gives -inf, as the TPU kernel's guard
// (:31-33) does; otherwise max + log(sum exp(x - max)).
//
// What bounds it. At the IW-LL's shapes ([100, 1000] for the flagship,
// [100, 500] for celeba64: 400 KB and 200 KB) the bytes take ~0.1 us at
// 3.35 TB/s, so a launch is bound by its latency: the launch itself (a
// trivial kernel takes ~1 us of device time on an H100) and the chain of
// dependent steps each thread runs (load, max, exchange, exp and sum,
// exchange, log). Bytes bound it only from roughly 10^7 elements.
//
// Why the first design was slow: one thread per column walked the k rows
// twice (once for the max, once for the sum of exp), ~2k loads in two
// loops of run-time length, and at B = 1000 that was 4 CTAs of 256
// threads on 4 of 132 SMs, too few warps to hide the loads' latency.
//
// Design: a launch plan from the shape (kernels/logsumexp.py lse_plan),
// which the C side checks against (k, B) and refuses on a mismatch.
// - A CTA takes 32 consecutive columns, a lane one of them, so a
//   warp-row is one 128-byte transaction. (float4 loads, 4 columns a
//   lane, were slower at every shape swept, PERF.md §6.)
// - The k rows are split over the CTA's `warps` warps, each a contiguous
//   block of rows x chunks rows. A thread issues all `rows` loads of a
//   chunk at once into registers (an unrolled loop to kMaxRows), so the
//   matrix is read once, in one burst per thread where chunks = 1. At the
//   IW shapes that is 8 warps of 13 rows: 32 CTAs at B = 1000, 16 at 500.
//   Where the grid is large the plan takes fewer warps a CTA, and more
//   chunks, so that the launch's warps stay near what the card holds.
// - Where k needs more than one chunk, the earlier chunks fold into a
//   running (max, sum of exp) per thread and the last stays in registers.
// - Combine in a fixed order, no atomics (relaunches are bit-equal): each
//   thread writes its max (NaN if it saw one) to shared memory; after a
//   barrier every thread takes the column's max M over the warps in warp
//   order and sums exp(v - M) over its rows in row order; after a second
//   barrier warp 0 adds the warps' sums in warp order and writes
//   M + log(s), or -inf.
// Accurate expf and logf; no FMA contraction (-fmad=false).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRows = 16;            // kernels/logsumexp.py LSE_MAX_ROWS
constexpr int kMaxWarps = 32;           // kernels/logsumexp.py LSE_MAX_WARPS

// kernels/logsumexp.py LsePlan
struct LsePlan {
  long long b;      // columns; CTA i takes [32 i, 32 i + 32)
  int k;            // rows
  int warps;        // warp w takes rows [w span, (w + 1) span), span = rows chunks
  int rows;         // rows a thread loads at once, at most kMaxRows
  int chunks;       // loads of `rows` rows a thread makes
};

__global__ void __launch_bounds__(kMaxWarps * 32)
logsumexp_kernel(const float* __restrict__ x, const LsePlan p, float* __restrict__ out) {
  __shared__ float maxima[kMaxWarps][32], sums[kMaxWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = col < p.b;
  const int first = warp * p.rows * p.chunks;
  const int end = min(p.k, first + p.rows * p.chunks);

  float v[kMaxRows];
  float m = -INFINITY, s = 0.0f;        // the earlier chunks' max and sum of exp(x - m)
  bool nan = false;
  for (int c = 0; c < p.chunks; ++c) {
    const int r0 = first + c * p.rows;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const bool in = live && i < p.rows && r0 + i < end;
      v[i] = in ? __ldg(x + static_cast<long long>(r0 + i) * p.b + col) : -INFINITY;
    }
    if (c + 1 == p.chunks) break;       // the last chunk stays in registers
    float cm = m;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < p.rows) {
        nan |= isnan(v[i]);
        cm = fmaxf(cm, v[i]);
      }
    }
    const float safe = isfinite(cm) ? cm : 0.0f;
    float acc = s * expf(m - safe);
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < p.rows) acc += expf(v[i] - safe);
    }
    m = cm;
    s = acc;
  }

  float tm = m;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < p.rows) {
      nan |= isnan(v[i]);
      tm = fmaxf(tm, v[i]);
    }
  }
  maxima[warp][lane] = nan ? NAN : tm;
  __syncthreads();

  // the column's max over the warps, in warp order; non-finite: -inf out
  float mm = -INFINITY;
  bool bad = false;
  for (int w = 0; w < p.warps; ++w) {
    bad |= isnan(maxima[w][lane]);
    mm = fmaxf(mm, maxima[w][lane]);
  }
  bad = bad || !isfinite(mm);
  mm = bad ? 0.0f : mm;
  float acc = s * expf(m - mm);
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < p.rows) acc += expf(v[i] - mm);
  }
  sums[warp][lane] = acc;
  __syncthreads();

  if (warp != 0 || !live) return;
  float total = 0.0f;
  for (int w = 0; w < p.warps; ++w) total += sums[w][lane];
  out[col] = bad ? -INFINITY : mm + logf(total);
}

// a plan that covers the shape (kernels/logsumexp.py lse_plan makes only
// these): every row in exactly one warp, no warp empty
bool bad_plan(const LsePlan& p, int k, long long b) {
  if (p.k != k || p.b != b || k < 1 || b < 1 || (b + 31) / 32 > 0x7FFFFFFFLL) return true;
  if (p.warps < 1 || p.warps > kMaxWarps || p.rows < 1 || p.rows > kMaxRows || p.chunks < 1) {
    return true;
  }
  const long long span = static_cast<long long>(p.rows) * p.chunks;
  return span * p.warps < k || span * (p.warps - 1) >= k;
}

}  // namespace

// K4 with the plan (kernels/logsumexp.py LsePlan)
extern "C" int lvae_logsumexp(const void* plan, const void* x, int k, long long b, void* out,
                              void* stream) {
  if (b == 0) return 0;
  const LsePlan& pl = *static_cast<const LsePlan*>(plan);
  if (bad_plan(pl, k, b)) return static_cast<int>(cudaErrorInvalidValue);
  logsumexp_kernel<<<static_cast<unsigned>((b + 31) / 32), pl.warps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), pl, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Shared by every entry point of the library: the wrappers turn a
// non-zero status into an exception carrying this text.
extern "C" const char* lvae_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
