// Threefry-2x32-20 (Salmon, Moraes, Dror & Shaw, SC'11) as a device function.
//
// Port of optpricer_tpu/ops/swprng.py:threefry2x32; the plain torch form is
// optpricer_tpu_torch/ops/swprng.py. Same rotation schedule, key schedule
// and round-number tweak, on native uint32 arithmetic, so the bits equal
// the JAX function's for the same (key, counter).
#pragma once

#include <cstdint>

namespace optpricer {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t &out0, uint32_t &out1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[(block % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
  }
  out0 = x0;
  out1 = x1;
}

}  // namespace optpricer
