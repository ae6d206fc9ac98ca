// Counter-based Philox4x32-10 and the kernels' bits -> uniform map.
#pragma once
#include <stdint.h>

namespace hydrolim {

// Philox4x32 with 10 rounds (Salmon et al., SC'11): four 32-bit words per
// (counter, key).  Stateless, so every (replica, step, draw, lane) can be
// drawn independently by whichever thread owns it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// The TPU kernels' map: the low 24 bits times 2^-24, exact in f32.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return (float)(bits & 0x00FFFFFFu) * 5.9604644775390625e-08f;
}

}  // namespace hydrolim
