// Philox4x32-10 (Random123), the port's one counter-based generator.
// lvae_tpu_torch/ops/philox.py is the same generator in plain PyTorch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvae {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x, hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z, hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Where a rank's elements lie in the global tensor (ops/philox.py
// ElementMap): local element e is global element e + base where plane is 0
// (a contiguous run: a rank's rows of the global batch), else
// (e / plane) gplane + e % plane + base (a band of rows of every image:
// plane its rows' elements of one channel, gplane the whole map's).
struct ElementMap {
  long long plane, gplane, base;
};

__device__ __forceinline__ long long global_element(const ElementMap& m, long long e) {
  if (m.plane == 0) return e + m.base;
  const long long q = e / m.plane;
  return q * m.gplane + (e - q * m.plane) + m.base;
}

}  // namespace lvae
