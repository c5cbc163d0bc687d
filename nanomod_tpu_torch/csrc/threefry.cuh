// threefry2x32 and jax.random's key derivation and randint reduction, in
// device code: the kernel-side copy of nanomod_tpu_torch/stats/threefry.py
// (which is tested bit for bit against jax.random).
//
//   fold_in(key, d) = hash(key, (0, d))
//   split(key)      = fold_in(key, 0), fold_in(key, 1)
//   bits(key, n)    = y0 ^ y1 of hash(key, (0, n)), n the flat element index
//   randint         = (bits(kh, n) % span * mult + bits(kl, n) % span) % span
//                     with (kh, kl) = split(key), mult = (2^16 % span)^2 % span
//
// All arithmetic is uint32 and wraps, as in jax.random.

#pragma once

#include <stdint.h>

namespace nm_threefry {

struct Key {
  uint32_t a, b;
};

__host__ __device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__host__ __device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1,
                                                int r0, int r1, int r2,
                                                int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// the 20-round threefry2x32 block of key k on the counter pair (x0, x1)
__host__ __device__ __forceinline__ void hash(Key k, uint32_t x0, uint32_t x1,
                                              uint32_t& y0, uint32_t& y1) {
  const uint32_t k0 = k.a, k1 = k.b, k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
  y0 = x0;
  y1 = x1;
}

__host__ __device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  Key out;
  hash(k, 0u, d, out.a, out.b);
  return out;
}

__host__ __device__ __forceinline__ uint32_t bits(Key k, uint32_t n) {
  uint32_t y0, y1;
  hash(k, 0u, n, y0, y1);
  return y0 ^ y1;
}

// randint(key, shape, 0, span) for one element: (kh, kl) = split(key)
struct Randint {
  Key hi, lo;
  uint32_t span, mult;

  __host__ __device__ __forceinline__ Randint(Key key, uint32_t maxval) {
    hi = fold_in(key, 0u);
    lo = fold_in(key, 1u);
    span = maxval;
    const uint32_t m = 65536u % span;
    mult = (m * m) % span;
  }

  __host__ __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return ((bits(hi, n) % span) * mult + bits(lo, n) % span) % span;
  }
};

}  // namespace nm_threefry
