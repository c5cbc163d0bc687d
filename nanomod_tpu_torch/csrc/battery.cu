// K3: per-position two-sample battery components (KS, Mann-Whitney U,
// tie sums, exact milli-domain Welch sums), Hopper.
//
// Replaces the XLA device function nanomod_tpu/stats/kernels.py:186
// battery_components_packed_milli (with _pairwise_counts :53,
// _pairwise_components :70 and _milli_exact_sums :168) and the rank rows of
// battery_components_packed (:150).  For each valid pooled value z of a row
// and each group g, le_g(z) = #{valid v in g : v <= z} and lt_g(z) = #{v <
// z}; every output is an exact int32 of these counts, bit-equal to the JAX
// function and to the native host battery (sort_core.cpp nm_battery_milli):
//
//   0 ks_num  = max_z |le_a(z)*n2 - le_b(z)*n1|      (D = ks_num/(n1*n2))
//   1 two_rank_sum = sum over group-1 z of lt + le + 1  (lt, le pooled)
//   2 tie_sum = sum over z of t*t - 1,  t = le - lt
//   3-5 sum1, sum(x*x >> 15), sum(x*x & 0x7fff) of group 1  (milli only)
//   6-8 the same for group 2                                 (milli only)
//
// n1, n2 in the KS formula are the counts as given; the valid prefix of a
// group is clamp(count, 0, width).  A NaN (f32 tiles only) is neither <=
// nor < anything: it adds 0 to every count, and as a query it adds 0 to the
// KS max, 1 to the rank sum if it is in group 1, and -1 to the tie sum.
//
// What bounds it on this card.  The inputs are read once (2 bytes a value
// on the main path), so the roofline bound is the bytes: 2.7 us for a
// 16,384 x 128 int16 tile.  The first design compared every pooled value
// with every value of both groups, N^2 compares a row from shared memory
// (N ~ 60-200), about 49x that bound.  This one sorts each row once and
// reads every count off the sorted order.
//
// Warp variant (pooled width c1 + c2 <= 256, the main path: counts of 30-100
// are bucketed to 128 a group).  One warp a row, eight rows a block, no
// __syncthreads.  The pooled values are loaded 32 E at a time (E = 1, 2, 4
// or 8 from the tile's width) as keys (value key << 1 | is-group-1) into E
// registers a lane, NaNs and padding past every real key, and sorted by a
// register bitonic network (sortsearch.cuh).  In sorted order a tie run is
// a stretch of equal value keys: for an element at sorted index i in the
// run [s, e], lt = s and le = e + 1 (pooled), and le_a is the number of
// group-1 elements at or before e.  Two ballots a register (run ends, group
// 1) and prefix counts over the E registers give s, e and le_a with find
// first / last set bit and popc, so the rank and tie sums take one pass and
// the KS max is read at the run ends.  Work a row: the sort's E (log2 32E
// + 1) log2 32E / 2 compare-exchanges a lane (half the registers where the
// row fills at most half), then ~20 operations an element.
//
// Block variant (c1 + c2 > 256: rows up to 645 a group, capacity 1024; the
// wrapper accepts c1 + c2 <= 8192).  One block a row: each group's keys are
// sorted in shared memory (one segmented bitonic sort, the groups padded to
// a power of two), and every valid pooled value searches its lower and upper
// bound in both sorted groups (4 binary searches).  The tile's widths pick
// the variant; there is no knob.
//
// The milli moment rows 3-8 keep their single pass over the loaded values.
//
// The pooled entry (nm_battery_pooled) replaces the XLA device function
// nanomod_tpu/stats/kernels.py:252 pooled_rank_components: rows of N pooled
// values with a label each (the sharded demo step's layout), rows 0-2 above
// with the KS numerator from the caller's counts, and d = ks_num / (n1 n2)
// written by the kernel.  It reads each row in place, one launch for the
// whole function: the warp variant by N (not 2N: no group is padded to N),
// the block variant above 256.  Its bound is the bytes again (z and lab
// read, 12 bytes a row written); the sort is the work, as in K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sortsearch.cuh"

namespace {

using nm_sort::NAN_KEY;
using nm_sort::block_sort;
using nm_sort::count_below;
using nm_sort::sort_key;
using nm_sort::warp_sort;

constexpr int NOUT = 9;
constexpr int WARP_ROWS = 8;         // rows (warps) a block, warp variant
constexpr int WARP_MAX_POOL = 256;   // widest pooled row of the warp variant
constexpr int BLOCK_THREADS = 256;   // block variant
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
// widest pooled row of nm_battery_pooled: two segments of 8,192 keys, 64 KB
constexpr int POOLED_MAX_N = 8192;

// the warp variant's sort key: value key << 1 | is-group-1 (int16 keys have
// 16 bits, f32 keys 32)
template <typename T> struct PoolKey { using K = unsigned long long; };
template <> struct PoolKey<int16_t> { using K = uint32_t; };

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}

// one row's moments, milli rows 3-8 (acc[3..5] group 1, acc[6..8] group 2;
// acc is indexed by constants only so it stays in registers)
__device__ __forceinline__ void add_moments(int (&acc)[NOUT], int x,
                                            bool g1) {
  const int sq = x * x;
  if (g1) {
    acc[3] += x;
    acc[4] += sq >> 15;
    acc[5] += sq & 0x7fff;
  } else {
    acc[6] += x;
    acc[7] += sq >> 15;
    acc[8] += sq & 0x7fff;
  }
}

// A warp's rank rows from its sorted keys x (value key << 1 | is-group-1,
// the m real keys first): this lane's shares of acc[0] (the KS max over the
// run ends, from the counts n1, n2 as given), acc[1] (the rank sum) and
// acc[2] (the tie sum).
template <int E, typename K>
__device__ __forceinline__ void warp_rank_rows(const K (&x)[E], int m,
                                               int lane, int n1r, int n2r,
                                               int (&acc)[NOUT]) {
  // ballots a register: the run ends (the next element has another value
  // key; NaN and padding keys differ from every real one) and group 1
  unsigned endm[E], labm[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    K next = __shfl_down_sync(0xffffffffu, x[r], 1);
    const K wrap = __shfl_sync(0xffffffffu, x[r + 1 < E ? r + 1 : r], 0);
    if (lane == 31) next = r + 1 < E ? wrap : ~K(0);
    const bool real = ((r << 5) | lane) < m;
    endm[r] = __ballot_sync(0xffffffffu, real && (x[r] >> 1) != (next >> 1));
    labm[r] = __ballot_sync(0xffffffffu, real && (x[r] & 1));
  }
  // over the registers before r: the last run end and the group-1 count;
  // after r: the first run end
  int last_end[E], ca[E], first_end[E];
  {
    int last = -1, cnt = 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      last_end[r] = last;
      ca[r] = cnt;
      if (endm[r]) last = (r << 5) + 31 - __clz(endm[r]);
      cnt += __popc(labm[r]);
    }
    int first = 32 * E;
#pragma unroll
    for (int r = E - 1; r >= 0; --r) {
      first_end[r] = first;
      if (endm[r]) first = (r << 5) + __ffs(endm[r]) - 1;
    }
  }
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = (r << 5) | lane;
    if (i < m) {
      const unsigned below = endm[r] & lt_mask;
      const unsigned from = endm[r] & ~lt_mask;
      const int s = (below ? (r << 5) + 31 - __clz(below) : last_end[r]) + 1;
      const int e = from ? (r << 5) + __ffs(from) - 1 : first_end[r];
      const int t = e - s + 1;  // le - lt
      if (x[r] & 1) acc[1] += s + e + 2;  // lt + le + 1
      acc[2] += t * t - 1;
      if (e == i) {
        const int le_a = ca[r] + __popc(labm[r] & (lt_mask | (1u << lane)));
        const int le_b = e + 1 - le_a;
        acc[0] = max(acc[0], abs(le_a * n2r - le_b * n1r));
      }
    }
  }
}

template <typename T, bool MILLI, int E>
__global__ void __launch_bounds__(WARP_ROWS * 32)
    battery_warp(const T* __restrict__ v1, const int32_t* __restrict__ c1,
                 int cap1, const T* __restrict__ v2,
                 const int32_t* __restrict__ c2, int cap2, int p_total,
                 int32_t* __restrict__ out) {
  using K = typename PoolKey<T>::K;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (p >= p_total) return;  // the whole warp leaves together
  const int n1r = c1[p];     // counts as given (the KS formula uses them)
  const int n2r = c2[p];
  const int n1 = min(max(n1r, 0), cap1);  // valid prefix lengths
  const int n2 = min(max(n2r, 0), cap2);
  const int n = n1 + n2;
  const T* row1 = v1 + (size_t)p * cap1;
  const T* row2 = v2 + (size_t)p * cap2;

  int acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0;
  int nan_all = 0, nan1 = 0;
  K x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = (r << 5) | lane;
    K key = ~K(0);  // padding sorts last
    if (i < n) {
      const bool g1 = i < n1;
      const T v = g1 ? row1[i] : row2[i - n1];
      if (MILLI) add_moments(acc, (int)v, g1);
      const uint32_t vk = sort_key(v);
      nan_all += vk == NAN_KEY;
      nan1 += g1 && vk == NAN_KEY;
      key = ((K)vk << 1) | (K)g1;
    }
    x[r] = key;
  }
  // a row whose values fill at most half the registers sorts that half:
  // the rest is padding, already last (about half the rows at counts of
  // 30-100 a group)
  constexpr int H = E > 1 ? E / 2 : 1;
  if (E > 1 && n <= 32 * H)
    warp_sort<H>(x, lane);
  else
    warp_sort<E>(x, lane);
  nan_all = warp_sum(nan_all);
  nan1 = warp_sum(nan1);
  const int m = n - nan_all;  // real values: sorted indices [0, m)

  warp_rank_rows(x, m, lane, n1r, n2r, acc);
  acc[0] = warp_max(acc[0]);
  constexpr int nrows = MILLI ? 9 : 3;
#pragma unroll
  for (int r = 1; r < nrows; ++r) acc[r] = warp_sum(acc[r]);
  if (lane == 0) {
    acc[1] += nan1;     // a NaN of group 1: lt + le + 1 = 1
    acc[2] -= nan_all;  // every NaN: t = 0
#pragma unroll
    for (int r = 0; r < nrows; ++r) out[(size_t)r * p_total + p] = acc[r];
  }
}

// A block's rank rows from its sorted groups ka[0, seg) and kb[0, seg)
// (the n1 and n2 valid keys first, NaNs last): this thread's shares of
// acc[0] (the KS max, from the counts n1r, n2r as given), acc[1] (the rank
// sum) and acc[2] (the tie sum), over every valid value of either group.
__device__ __forceinline__ void block_rank_rows(const uint32_t* ka,
                                                const uint32_t* kb, int seg,
                                                int n1, int n2, int n1r,
                                                int n2r, int (&acc)[NOUT]) {
  for (int q = threadIdx.x; q < n1 + n2; q += BLOCK_THREADS) {
    const bool g1 = q < n1;
    const uint32_t z = g1 ? ka[q] : kb[q - n1];
    if (z == NAN_KEY) {
      acc[1] += g1;
      acc[2] -= 1;
      continue;
    }
    const int le_a = count_below<true>(ka, seg, z);
    const int lt_a = count_below<false>(ka, seg, z);
    const int le_b = count_below<true>(kb, seg, z);
    const int lt_b = count_below<false>(kb, seg, z);
    acc[0] = max(acc[0], abs(le_a * n2r - le_b * n1r));
    const int cle = le_a + le_b;
    const int clt = lt_a + lt_b;
    if (g1) acc[1] += clt + cle + 1;
    const int t = cle - clt;
    acc[2] += t * t - 1;
  }
}

// The block's totals of acc's first NROWS rows (row 0 a max, the others
// sums): thread r < NROWS returns total r.  All threads call it.
template <int NROWS>
__device__ __forceinline__ int block_totals(int (&acc)[NOUT],
                                            int (&red)[BLOCK_WARPS][NOUT]) {
  const int tid = threadIdx.x;
  acc[0] = warp_max(acc[0]);
#pragma unroll
  for (int r = 1; r < NROWS; ++r) acc[r] = warp_sum(acc[r]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) red[tid >> 5][r] = acc[r];
  }
  __syncthreads();
  int v = 0;
  if (tid < NROWS) {
    v = red[0][tid];
    for (int wi = 1; wi < BLOCK_WARPS; ++wi)
      v = tid == 0 ? max(v, red[wi][tid]) : v + red[wi][tid];
  }
  return v;
}

template <typename T, bool MILLI>
__global__ void __launch_bounds__(BLOCK_THREADS)
    battery_block(const T* __restrict__ v1, const int32_t* __restrict__ c1,
                  int cap1, const T* __restrict__ v2,
                  const int32_t* __restrict__ c2, int cap2, int p_total,
                  int seg, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2 seg]: group 1's keys sorted in [0, seg), group 2's in [seg, 2 seg)
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);
  __shared__ int red[BLOCK_WARPS][NOUT];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int n1r = c1[p];
  const int n2r = c2[p];
  const int n1 = min(max(n1r, 0), cap1);
  const int n2 = min(max(n2r, 0), cap2);
  const T* row1 = v1 + (size_t)p * cap1;
  const T* row2 = v2 + (size_t)p * cap2;

  int acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0;
  for (int j = tid; j < seg; j += BLOCK_THREADS) {
    uint32_t k1 = NAN_KEY, k2 = NAN_KEY;  // padding sorts last
    if (j < n1) {
      k1 = sort_key(row1[j]);
      if (MILLI) add_moments(acc, (int)row1[j], true);
    }
    if (j < n2) {
      k2 = sort_key(row2[j]);
      if (MILLI) add_moments(acc, (int)row2[j], false);
    }
    keys[j] = k1;
    keys[seg + j] = k2;
  }
  __syncthreads();
  block_sort(keys, 2 * seg, seg);

  block_rank_rows(keys, keys + seg, seg, n1, n2, n1r, n2r, acc);
  constexpr int nrows = MILLI ? 9 : 3;
  const int v = block_totals<nrows>(acc, red);
  if (tid < nrows) out[(size_t)tid * p_total + p] = v;
}

template <typename T, bool MILLI, int E>
int launch_warp(const void* v1, const void* c1, int cap1, const void* v2,
                const void* c2, int cap2, int p_total, void* out,
                cudaStream_t stream) {
  const int blocks = (p_total + WARP_ROWS - 1) / WARP_ROWS;
  battery_warp<T, MILLI, E><<<blocks, WARP_ROWS * 32, 0, stream>>>(
      (const T*)v1, (const int32_t*)c1, cap1, (const T*)v2,
      (const int32_t*)c2, cap2, p_total, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool MILLI>
int launch(const void* v1, const void* c1, int cap1, const void* v2,
           const void* c2, int cap2, int p_total, void* out,
           cudaStream_t stream) {
  const int pool = cap1 + cap2;
  if (pool <= 32)
    return launch_warp<T, MILLI, 1>(v1, c1, cap1, v2, c2, cap2, p_total, out,
                                    stream);
  if (pool <= 64)
    return launch_warp<T, MILLI, 2>(v1, c1, cap1, v2, c2, cap2, p_total, out,
                                    stream);
  if (pool <= 128)
    return launch_warp<T, MILLI, 4>(v1, c1, cap1, v2, c2, cap2, p_total, out,
                                    stream);
  if (pool <= WARP_MAX_POOL)
    return launch_warp<T, MILLI, 8>(v1, c1, cap1, v2, c2, cap2, p_total, out,
                                    stream);
  int seg = 1;
  while (seg < cap1 || seg < cap2) seg <<= 1;
  const size_t smem = (size_t)2 * seg * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        battery_block<T, MILLI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  battery_block<T, MILLI><<<p_total, BLOCK_THREADS, smem, stream>>>(
      (const T*)v1, (const int32_t*)c1, cap1, (const T*)v2,
      (const int32_t*)c2, cap2, p_total, seg, (int32_t*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pooled layout (nm_battery_pooled): row p holds N values z and labels
// lab, a value is valid where z < +inf (NaN and +inf are padding, -inf is
// valid), in group 1 where lab > 0.5 and in group 2 where lab <= 0.5 (a NaN
// label is in neither).  Each row is read in place: the members' keys are
// built as they load and the non-members' keys are padding, so the sort
// puts the members first; no compaction runs before the launch.  The KS
// term takes the caller's counts n1, n2 truncated to int32, and the kernel
// writes d = f32(ks_num) / (n1 * n2) in round-to-nearest f32 operations,
// two_rank_sum and tie_sum.

// a pooled value is valid where it is below +inf (NaN compares false)
__device__ __forceinline__ bool pooled_valid(float v) {
  return v < __int_as_float(0x7f800000);
}

// the row's counts as the KS term takes them: n truncated toward zero
// (saturating, NaN to 0: XLA's f32 -> s32 conversion)
__device__ __forceinline__ int count_as_given(float n) {
  return __float2int_rz(n);
}

__device__ __forceinline__ float pooled_d(int ks_num, float n1, float n2) {
  return __fdiv_rn(__int2float_rn(ks_num), __fmul_rn(n1, n2));
}

// Warp variant (N <= WARP_MAX_POOL): one warp a row, eight rows a block;
// the members are counted by ballots and the 32 E keys sorted in registers
// (K3's warp variant).
template <int E>
__global__ void __launch_bounds__(WARP_ROWS * 32)
    pooled_warp(const float* __restrict__ z, const float* __restrict__ lab,
                const float* __restrict__ c1, const float* __restrict__ c2,
                int p_total, int width, float* __restrict__ d_out,
                int32_t* __restrict__ trs_out,
                int32_t* __restrict__ ties_out) {
  using K = unsigned long long;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (p >= p_total) return;  // the whole warp leaves together
  const float* zr = z + (size_t)p * width;
  const float* lr = lab + (size_t)p * width;
  int acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0;
  int m = 0;  // members of either group
  K x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = (r << 5) | lane;
    K key = ~K(0);  // padding sorts last
    bool member = false;
    if (i < width) {
      const float v = zr[i];
      const float l = lr[i];
      const bool g1 = l > 0.5f;
      member = pooled_valid(v) && (g1 || l <= 0.5f);
      if (member) key = ((K)sort_key(v) << 1) | (K)g1;
    }
    x[r] = key;
    m += __popc(__ballot_sync(0xffffffffu, member));
  }
  warp_sort<E>(x, lane);
  const float n1 = c1[p];
  const float n2 = c2[p];
  warp_rank_rows(x, m, lane, count_as_given(n1), count_as_given(n2), acc);
  acc[0] = warp_max(acc[0]);
  acc[1] = warp_sum(acc[1]);
  acc[2] = warp_sum(acc[2]);
  if (lane == 0) {
    d_out[p] = pooled_d(acc[0], n1, n2);
    trs_out[p] = acc[1];
    ties_out[p] = acc[2];
  }
}

// Block variant (N > WARP_MAX_POOL): one block a row, each group's member
// keys sorted in its own segment of shared memory (non-members padded with
// NAN_KEY, which no member has), the counts read off the sorted segments
// and the queries answered by K3's block variant.
__global__ void __launch_bounds__(BLOCK_THREADS)
    pooled_block(const float* __restrict__ z, const float* __restrict__ lab,
                 const float* __restrict__ c1, const float* __restrict__ c2,
                 int width, int seg, float* __restrict__ d_out,
                 int32_t* __restrict__ trs_out,
                 int32_t* __restrict__ ties_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);
  __shared__ int red[BLOCK_WARPS][NOUT];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const float* zr = z + (size_t)p * width;
  const float* lr = lab + (size_t)p * width;
  for (int j = tid; j < seg; j += BLOCK_THREADS) {
    uint32_t k1 = NAN_KEY, k2 = NAN_KEY;
    if (j < width) {
      const float v = zr[j];
      const float l = lr[j];
      if (pooled_valid(v)) {
        if (l > 0.5f)
          k1 = sort_key(v);
        else if (l <= 0.5f)
          k2 = sort_key(v);
      }
    }
    keys[j] = k1;
    keys[seg + j] = k2;
  }
  __syncthreads();
  block_sort(keys, 2 * seg, seg);
  const int n1m = count_below<false>(keys, seg, NAN_KEY);
  const int n2m = count_below<false>(keys + seg, seg, NAN_KEY);
  const float n1 = c1[p];
  const float n2 = c2[p];
  int acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0;
  block_rank_rows(keys, keys + seg, seg, n1m, n2m, count_as_given(n1),
                  count_as_given(n2), acc);
  const int v = block_totals<3>(acc, red);
  if (tid == 0) d_out[p] = pooled_d(v, n1, n2);
  if (tid == 1) trs_out[p] = v;
  if (tid == 2) ties_out[p] = v;
}

template <int E>
int launch_pooled_warp(const void* z, const void* lab, const void* c1,
                       const void* c2, int p_total, int width, void* d,
                       void* trs, void* ties, cudaStream_t stream) {
  const int blocks = (p_total + WARP_ROWS - 1) / WARP_ROWS;
  pooled_warp<E><<<blocks, WARP_ROWS * 32, 0, stream>>>(
      (const float*)z, (const float*)lab, (const float*)c1,
      (const float*)c2, p_total, width, (float*)d, (int32_t*)trs,
      (int32_t*)ties);
  return (int)cudaGetLastError();
}

}  // namespace

// is_i16: values are int16 (else f32).  milli: also emit rows 3-8 (int16
// only).  out: [9 | 3, P] int32.
extern "C" int nm_battery(const void* v1, const void* c1, int cap1,
                          const void* v2, const void* c2, int cap2,
                          int p_total, int is_i16, int milli, void* out,
                          void* stream) {
  if (p_total <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_i16) {
    return milli ? launch<int16_t, true>(v1, c1, cap1, v2, c2, cap2, p_total,
                                         out, st)
                 : launch<int16_t, false>(v1, c1, cap1, v2, c2, cap2,
                                          p_total, out, st);
  }
  if (milli) return (int)cudaErrorInvalidValue;
  return launch<float, false>(v1, c1, cap1, v2, c2, cap2, p_total, out, st);
}

// The pooled layout: z, lab [P, N] f32, n1, n2 [P] f32 (the counts as
// given); out d [P] f32, two_rank_sum and tie_sum [P] int32.  The width N
// picks the variant (the warp's up to WARP_MAX_POOL); N <= POOLED_MAX_N.
extern "C" int nm_battery_pooled(const void* z, const void* lab,
                                 const void* n1, const void* n2, int p_total,
                                 int width, void* d, void* trs, void* ties,
                                 void* stream) {
  if (p_total <= 0) return 0;
  if (width < 1 || width > POOLED_MAX_N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (width <= 32)
    return launch_pooled_warp<1>(z, lab, n1, n2, p_total, width, d, trs,
                                 ties, st);
  if (width <= 64)
    return launch_pooled_warp<2>(z, lab, n1, n2, p_total, width, d, trs,
                                 ties, st);
  if (width <= 128)
    return launch_pooled_warp<4>(z, lab, n1, n2, p_total, width, d, trs,
                                 ties, st);
  if (width <= WARP_MAX_POOL)
    return launch_pooled_warp<8>(z, lab, n1, n2, p_total, width, d, trs,
                                 ties, st);
  int seg = 1;
  while (seg < width) seg <<= 1;
  const size_t smem = (size_t)2 * seg * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pooled_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pooled_block<<<p_total, BLOCK_THREADS, smem, st>>>(
      (const float*)z, (const float*)lab, (const float*)n1, (const float*)n2,
      width, seg, (float*)d, (int32_t*)trs, (int32_t*)ties);
  return (int)cudaGetLastError();
}
