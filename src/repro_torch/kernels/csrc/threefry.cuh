// Counter-based uniforms made inside the draw kernels (K5, K10).
//
// threefry2x32 is the device form of repro_torch/kernels/rng.py's
// threefry2x32 (and of the reference's src/repro/kernels/rng.py): 20
// rounds, rotations (13, 15, 26, 6) / (17, 29, 16, 24), key-schedule
// parity 0x1BD11BDA.  Every word is a uint32_t, whose + and << wrap at
// 2^32 by themselves, where the plain version masks int64 words.  The
// uniform of a row is bits_to_uniform(word 0 of threefry(s, (row, 0))):
// the top 24 bits times 2^-24, exact in fp32, so the device and plain
// uniforms are equal bit for bit.
//
// philox4x32_10 (Salmon et al. 2011, Random123's philox4x32 with 10
// rounds) stands in for the TPU's hardware PRNG of the reference's
// hw=True branch, which has no bit-equal counterpart here.  Its plain
// version is rng.philox4x32 (16-bit halves for the 32x32 -> 64-bit
// products, which int64 cannot hold).
//
// The uniform sources below are what the draw kernels are instantiated
// on: an array of given uniforms (K4, K9), Threefry (K5, K10) or Philox
// (K5 with hw=True).  A source maps the sample's row within the launch to
// its uniform; the seeded sources add the launch's row_offset in uint32,
// so global rows wrap at 2^32 as the reference's uint32 counters do.
#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rots[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// The top 24 bits times 2^-24: a float in [0, 1), exact.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1,
                                               uint4 c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

struct ArrayU {  // given uniforms, one per sample of the launch
  const float* __restrict__ u;
  __device__ __forceinline__ float operator()(int s) const { return u[s]; }
};

struct ThreefryU {  // u(s) = uniform(seed, (row_offset + s, 0))
  uint32_t s0, s1, row_offset;
  __device__ __forceinline__ float operator()(int s) const {
    const uint32_t row = row_offset + static_cast<uint32_t>(s);
    return bits_to_uniform(threefry2x32(s0, s1, row, 0u).x);
  }
};

struct PhiloxU {  // u(s) from word 0 of philox(seed, (row_offset + s, 0, 0, 0))
  uint32_t s0, s1, row_offset;
  __device__ __forceinline__ float operator()(int s) const {
    const uint32_t row = row_offset + static_cast<uint32_t>(s);
    return bits_to_uniform(philox4x32_10(s0, s1, make_uint4(row, 0u, 0u, 0u)).x);
  }
};

}  // namespace threefry
