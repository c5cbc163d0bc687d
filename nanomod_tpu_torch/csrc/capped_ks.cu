// K6: coverage-capped repeated-subsample KS numerator, Hopper.
//
// Replaces the XLA device function nanomod_tpu/stats/kernels.py
// capped_ks_d.  Per position row p, with ne = min(count, cov) per group:
// for each of `repeats` subsamples, a group whose count exceeds cov is
// replaced by cov values drawn with replacement (jax.random.randint keyed
// by split(fold_in(PRNGKey(seed), row_index[p])), threefry.cuh), a group
// within the cap keeps its first `count` values; the repeat's KS numerator
// is max over the pooled valid values z of |le_a(z)*ne2 - le_b(z)*ne1|.
// The output is the quantile_idx-th largest of the `repeats` numerators,
// exact int32, bit-equal to the JAX function.
//
// The JAX version materialises the drawn indices as [P, R, cov] int32
// (1.3 GB a tile at P = 16,384, R = cov = 100) and a [P, cov, 2 cov]
// compare tensor per repeat.  Here the draws are recomputed in registers
// and never stored: one block takes one row, each thread draws its
// columns' indices (counter r * cov + j, as the partitionable iota gives
// it) and gathers the values into shared memory, then counts a strided share of the pooled queries against both groups
// and the block max-reduces the numerator.  The R numerators stay in shared
// memory; the quantile is selected by counting (ties need no order, only
// the value is returned).  A row with both groups within the cap has the
// same subsample in every repeat and is computed once.
//
// What bounds it: integer work, no device-memory traffic to speak of
// (the inputs are read once, the gathers hit L1/L2).  Per capped row about
// 4 R cov threefry blocks (two draws of two hashes per group) and
// R (ne1 + ne2)^2 compares from shared memory.  int16 milli values are
// held as f32 in shared memory: exact and order preserving.
//
// Shared memory: min(cov, cap1) + min(cov, cap2) floats for the two
// subsamples (a group's effective width never exceeds its pool's: a count
// above cov needs a pool wider than cov) and R ints for the numerators.
// Above the default 48 KB the launch raises the kernel's dynamic limit;
// above the card's 227 KB the wrapper refuses the call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using nm_threefry::Key;
using nm_threefry::Randint;
using nm_threefry::fold_in;

constexpr int THREADS = 128;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// value `j` of a row of width `cap` (columns past the width read as the
// zero padding of the JAX version, which pads the pools to cov columns)
template <typename T>
__device__ __forceinline__ float at(const T* row, int j, int cap) {
  return j < cap ? (float)row[j] : 0.f;
}

// the two groups' randint streams of row `row_index`
__device__ __forceinline__ void row_draws(Key base, int32_t row_index,
                                          Key& g1, Key& g2) {
  const Key row = fold_in(base, (uint32_t)row_index);
  g1 = fold_in(row, 0u);
  g2 = fold_in(row, 1u);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    capped_ks_kernel(const T* __restrict__ v1, const int32_t* __restrict__ c1,
                     int cap1, const T* __restrict__ v2,
                     const int32_t* __restrict__ c2, int cap2,
                     const int32_t* __restrict__ row_index, int cov,
                     int repeats, int q_idx, Key base,
                     int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [width]: ne1 values, then ne2 (width = min(cov, cap1) + min(cov, cap2))
  float* s = reinterpret_cast<float*>(smem_raw);
  int* nums = reinterpret_cast<int*>(s + min(cov, cap1) + min(cov, cap2));

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  // counts never exceed the pool widths; clamping them to a width below
  // cov keeps a bad count inside the shared buffer
  int n1 = max(c1[p], 0);
  int n2 = max(c2[p], 0);
  if (cap1 < cov) n1 = min(n1, cap1);
  if (cap2 < cov) n2 = min(n2, cap2);
  const bool capped1 = n1 > cov;
  const bool capped2 = n2 > cov;
  const int ne1 = min(n1, cov);
  const int ne2 = min(n2, cov);
  const int n = ne1 + ne2;
  const T* row1 = v1 + (size_t)p * cap1;
  const T* row2 = v2 + (size_t)p * cap2;

  Key g1, g2;
  row_draws(base, row_index[p], g1, g2);
  const Randint draw1(g1, (uint32_t)max(n1, 1));
  const Randint draw2(g2, (uint32_t)max(n2, 1));

  // a group within the cap is its prefix in every repeat
  const int reps = (capped1 || capped2) ? repeats : 1;
  for (int r = tid; r < reps; r += THREADS) nums[r] = 0;
  if (!capped1)
    for (int j = tid; j < ne1; j += THREADS) s[j] = at(row1, j, cap1);
  if (!capped2)
    for (int j = tid; j < ne2; j += THREADS) s[ne1 + j] = at(row2, j, cap2);

  for (int r = 0; r < reps; ++r) {
    const uint32_t base_n = (uint32_t)r * (uint32_t)cov;
    if (capped1)
      for (int j = tid; j < cov; j += THREADS)
        s[j] = at(row1, (int)draw1(base_n + j), cap1);
    if (capped2)
      for (int j = tid; j < cov; j += THREADS)
        s[ne1 + j] = at(row2, (int)draw2(base_n + j), cap2);
    __syncthreads();
    int best = 0;
    for (int q = tid; q < n; q += THREADS) {
      const float z = s[q];
      int le_a = 0, le_b = 0;
#pragma unroll 4
      for (int j = 0; j < ne1; ++j) le_a += s[j] <= z;
#pragma unroll 4
      for (int j = ne1; j < n; ++j) le_b += s[j] <= z;
      best = max(best, abs(le_a * ne2 - le_b * ne1));
    }
    best = warp_max(best);
    if ((tid & 31) == 0) atomicMax(&nums[r], best);
    __syncthreads();
  }

  if (reps == 1) {
    if (tid == 0) out[p] = nums[0];
    return;
  }
  // the q_idx-th largest: the value v with #{> v} <= q_idx < #{>= v}
  for (int r = tid; r < reps; r += THREADS) {
    const int v = nums[r];
    int gt = 0, ge = 0;
    for (int k = 0; k < reps; ++k) {
      gt += nums[k] > v;
      ge += nums[k] >= v;
    }
    if (gt <= q_idx && q_idx < ge) out[p] = v;  // every such r holds v
  }
}

// the drawn indices of one group, [P, repeats * cov], for tests
__global__ void capped_draws_kernel(const int32_t* __restrict__ counts,
                                    const int32_t* __restrict__ row_index,
                                    int total, Key base, int group,
                                    int32_t* __restrict__ out) {
  const int p = blockIdx.x;
  Key g1, g2;
  row_draws(base, row_index[p], g1, g2);
  const Randint draw(group == 0 ? g1 : g2, (uint32_t)max(counts[p], 1));
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    out[(size_t)p * total + i] = (int32_t)draw((uint32_t)i);
}

template <typename T>
int launch(const void* v1, const void* c1, int cap1, const void* v2,
           const void* c2, int cap2, const void* row_index, int p_total,
           int cov, int repeats, int q_idx, Key base, void* out,
           cudaStream_t stream) {
  const int width = (cov < cap1 ? cov : cap1) + (cov < cap2 ? cov : cap2);
  const size_t smem =
      (size_t)width * sizeof(float) + (size_t)repeats * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        capped_ks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  capped_ks_kernel<T><<<p_total, THREADS, smem, stream>>>(
      (const T*)v1, (const int32_t*)c1, cap1, (const T*)v2,
      (const int32_t*)c2, cap2, (const int32_t*)row_index, cov, repeats,
      q_idx, base, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// is_i16: values are int16 (else f32; the caller promotes mixed types).
// seed_hi/seed_lo: the two words of PRNGKey(seed).  out: [P] int32.
extern "C" int nm_capped_ks(const void* v1, const void* c1, int cap1,
                            const void* v2, const void* c2, int cap2,
                            const void* row_index, int p_total, int cov,
                            int repeats, int q_idx, unsigned seed_hi,
                            unsigned seed_lo, int is_i16, void* out,
                            void* stream) {
  if (p_total <= 0) return 0;
  const Key base{seed_hi, seed_lo};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_i16)
    return launch<int16_t>(v1, c1, cap1, v2, c2, cap2, row_index, p_total,
                           cov, repeats, q_idx, base, out, st);
  return launch<float>(v1, c1, cap1, v2, c2, cap2, row_index, p_total, cov,
                       repeats, q_idx, base, out, st);
}

// group 0 or 1: the indices capped_ks draws for that group, [P, total]
extern "C" int nm_capped_draws(const void* counts, const void* row_index,
                               int p_total, int total, unsigned seed_hi,
                               unsigned seed_lo, int group, void* out,
                               void* stream) {
  if (p_total <= 0) return 0;
  const Key base{seed_hi, seed_lo};
  capped_draws_kernel<<<p_total, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const int32_t*)row_index, total, base, group,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
