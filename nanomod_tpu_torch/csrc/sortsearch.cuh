// Sorting and searching for the battery kernels K3 (battery.cu) and K6
// (capped_ks.cu): order keys, a bitonic sort of a warp's registers, a
// segmented bitonic sort of a block's shared memory, and counts below a key
// in a sorted array.
//
// Order keys.  Both kernels count, for a value z, the values v of a group
// with v <= z and v < z.  A value becomes a uint32 key that orders and ties
// exactly as the value compares:
//   - int16: x + 32768;
//   - float: -0.0 is folded into +0.0 first (they compare equal, so they
//     must tie), then the usual monotone map of the bits (negative: all bits
//     flipped; positive: the sign bit set);
//   - NaN (float only) maps to NAN_KEY, above every other key.  A NaN is
//     neither <= nor < any value, so the kernels keep NaNs out of their
//     counts and give a NaN query its counts of 0 themselves.
// Keys of real values stay below 0xFF800001 (+inf), so NAN_KEY and an
// all-ones padding key sort after every real value, and a count below a real
// key never includes them.

#pragma once

#include <stdint.h>

namespace nm_sort {

constexpr uint32_t NAN_KEY = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t sort_key(int16_t x) {
  return (uint32_t)((int)x + 32768);
}

__device__ __forceinline__ uint32_t sort_key(float x) {
  if (x != x) return NAN_KEY;
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) { return a < b ? a : b; }
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) { return a < b ? b : a; }

// Ascending bitonic sort of the first 32 NS keys a warp holds, element r *
// 32 + lane in x[r] of that lane (r < NS <= E, NS a power of two).
// Distances below 32 are exchanged by shuffles, larger ones between a lane's
// own registers.  Every loop is unrolled, so x stays in registers.  No
// shared memory, no __syncthreads.
template <int NS, int E, typename K>
__device__ __forceinline__ void warp_sort(K (&x)[E], int lane) {
  static_assert(NS <= E && (NS & (NS - 1)) == 0, "NS: a power of two <= E");
  constexpr int N = 32 * NS;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int jr = j >> 5;
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          if ((r & jr) == 0) {
            // k >= 64 here, so the direction depends on r alone
            const bool up = ((r << 5) & k) == 0;
            const K a = x[r], b = x[r | jr];
            x[r] = up ? kmin(a, b) : kmax(a, b);
            x[r | jr] = up ? kmax(a, b) : kmin(a, b);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          const K y = __shfl_xor_sync(0xffffffffu, x[r], j);
          const bool up = ((((r << 5) | lane)) & k) == 0;
          const bool lower = (lane & j) == 0;
          x[r] = (lower == up) ? kmin(x[r], y) : kmax(x[r], y);
        }
      }
    }
  }
}

// Sort each aligned segment of `seg` keys of a[0, n) ascending (seg a power
// of two dividing n), all threads of the block taking part.  The caller
// synchronises before; this returns after a final __syncthreads.
template <typename K>
__device__ void block_sort(K* a, int n, int seg) {
  const int half = n >> 1;
  for (int k = 2; k <= seg; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
        // the last merge of a segment is ascending in every segment
        const bool up = k == seg || (i & k) == 0;
        const K lo = a[i], hi = a[i + j];
        if (up ? hi < lo : lo < hi) {
          a[i] = hi;
          a[i + j] = lo;
        }
      }
      __syncthreads();
    }
  }
}

// #{i < n : a[i] <= key} (LE) or #{i < n : a[i] < key} (LT) for a[0, n)
// sorted ascending: the upper or the lower bound of key, by binary lifting.
template <bool LE, typename K>
__device__ __forceinline__ int count_below(const K* a, int n, K key) {
  int pos = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
    const int q = pos + step;
    if (q <= n && (LE ? a[q - 1] <= key : a[q - 1] < key)) pos = q;
  }
  return pos;
}

}  // namespace nm_sort
