// K6: coverage-capped repeated-subsample KS numerator, Hopper.
//
// Replaces the XLA device function nanomod_tpu/stats/kernels.py:279
// capped_ks_d.  Per position row p, with ne = min(count, cov) per group:
// for each of `repeats` subsamples, a group whose count exceeds cov is
// replaced by cov values drawn with replacement (jax.random.randint keyed
// by split(fold_in(PRNGKey(seed), row_index[p])), threefry.cuh), a group
// within the cap keeps its first `count` values; the repeat's KS numerator
// is max over the pooled valid values z of |le_a(z)*ne2 - le_b(z)*ne1|.
// The output is the quantile_idx-th largest of the `repeats` numerators,
// exact int32, bit-equal to the JAX function.
//
// What bounds it on this card: integer work.  The inputs are read once; the
// floor is the threefry draws, 2 R cov blocks of 20 rounds per capped group
// (at the capped detect's input over nine tenths of the roofline bound).
// The first design compared every pooled value of a subsample with every
// other, R (ne1 + ne2)^2 compares a row with two __syncthreads and an
// atomicMax a repeat, ~20x that bound.
//
// This design ranks the row once, then histograms each repeat.
//   Once a row (the block): every value a subsample can take, the sources,
//   is sorted with its source index (a capped group's first min(count,
//   width) values, plus one zero when a bad count runs past the width,
//   which reads as the JAX version's zero padding; an uncapped group's
//   first ne values).  Each source gets the index of its tie run in the
//   pooled order: equal values of the two groups share a run, -0.0 ties
//   +0.0, and a NaN gets no run (a NaN is neither <= nor < anything, so it
//   adds to no count and as a query has le = 0 on both sides).  For each
//   run the number of sources of each group at or before it (pre_a, pre_b)
//   is kept: for an uncapped group these are its le counts in every repeat.
//   A row with neither group capped is finished here (one pass).
//   Once a repeat (one warp; the repeats are spread over the block's
//   warps): draw the cov indices of each capped group, add one a draw to
//   the drawn source's run in the warp's own histogram (shared-memory
//   atomics; group 1 in the low 16 bits, group 2 in the high 16: a group
//   adds at most cov, and a capped group needs cov < 65536, see launch),
//   then one warp scan over the k runs gives le_a and le_b at every run,
//   and the numerator is their max |le_a*ne2 - le_b*ne1|.  No mask is
//   needed: a run that this repeat drew from neither group has the same
//   (le_a, le_b) as the last run before it that was drawn, or (0, 0) if
//   there is none, so it never raises the max.
//   The quantile is selected by counting (ties need no order).
// Work a capped row: a sort of ~(n1 + n2) log^2 keys once, then a repeat
// costs cov draws a capped group, cov shared atomics and k / 32 scan steps
// a lane, against (2 cov)^2 compares before.
//
// Shared memory (sized by the tile's widths at launch, dynamic above 48 KB):
// the sort buffer (8 bytes a key, a power of two >= the sources), reused as
// the warps' histograms (4 bytes a source a warp); the runs of the sources,
// pre_a and pre_b (4 bytes a source each) and the R numerators.  A block has
// 8 warps, fewer when that does not fit the card's 227 KB; above that even
// with one warp the wrapper refuses the call (stats/kernels.py mirrors this
// layout).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sortsearch.cuh"
#include "threefry.cuh"

namespace {

using nm_sort::NAN_KEY;
using nm_sort::block_sort;
using nm_sort::sort_key;
using nm_threefry::Key;
using nm_threefry::Randint;
using nm_threefry::fold_in;

constexpr int MAX_WARPS = 8;
constexpr int THREADS = 128;  // the draws kernel
// the card's shared memory a block, less room for the static buffers
constexpr size_t SMEM_CAP = 232448 - 1024;

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}

// the sort key of value `j` of a row of width `cap` (columns past the width
// read as the zero padding of the JAX version)
template <typename T>
__device__ __forceinline__ uint32_t key_at(const T* row, int j, int cap) {
  return sort_key(j < cap ? row[j] : T(0));
}

// the two groups' randint streams of row `row_index`
__device__ __forceinline__ void row_draws(Key base, int32_t row_index,
                                          Key& g1, Key& g2) {
  const Key row = fold_in(base, (uint32_t)row_index);
  g1 = fold_in(row, 0u);
  g2 = fold_in(row, 1u);
}

// exclusive prefix sums of three ints over the block's threads, in thread
// order; `total` gets the sums
__device__ __forceinline__ void block_scan3(int (&v)[3], int (&total)[3],
                                            int (*scratch)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int x = v[c];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    incl[c] = x;
    if (lane == 31) scratch[c][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int before = 0, all = 0;
    for (int w = 0; w < nw; ++w) {
      const int s = scratch[c][w];
      if (w < warp) before += s;
      all += s;
    }
    v[c] = before + incl[c] - v[c];
    total[c] = all;
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    capped_ks_kernel(const T* __restrict__ v1, const int32_t* __restrict__ c1,
                     int cap1, const T* __restrict__ v2,
                     const int32_t* __restrict__ c2, int cap2,
                     const int32_t* __restrict__ row_index, int cov,
                     int repeats, int q_idx, Key base, int n_max,
                     int sort_max, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int scratch[3][32];
  __shared__ int red[MAX_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  // the sort buffer, then the same bytes as the warps' histograms
  size_t u_bytes = (size_t)8 * sort_max;
  if ((size_t)4 * nw * n_max > u_bytes) u_bytes = (size_t)4 * nw * n_max;
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem_raw);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem_raw) + warp * n_max;
  int* run_of = reinterpret_cast<int*>(smem_raw + u_bytes);  // [n_max]
  int* pre_a = run_of + n_max;                                // [n_max]
  int* pre_b = pre_a + n_max;                                 // [n_max]
  int* nums = pre_b + n_max;                                  // [repeats]

  const int p = blockIdx.x;
  // counts never exceed the pool widths; clamping them to a width below
  // cov keeps a bad count inside the shared buffers
  int n1 = max(c1[p], 0);
  int n2 = max(c2[p], 0);
  if (cap1 < cov) n1 = min(n1, cap1);
  if (cap2 < cov) n2 = min(n2, cap2);
  const bool capped1 = n1 > cov;
  const bool capped2 = n2 > cov;
  const int ne1 = min(n1, cov);
  const int ne2 = min(n2, cov);
  const T* row1 = v1 + (size_t)p * cap1;
  const T* row2 = v2 + (size_t)p * cap2;
  // the sources: a capped group draws from its first n values (a draw at
  // or past the width reads the one zero source at index `cap`); an
  // uncapped group is its first ne values (ne <= its width)
  const int s1 = capped1 ? min(n1, cap1) + (n1 > cap1) : ne1;
  const int s2 = capped2 ? min(n2, cap2) + (n2 > cap2) : ne2;
  const int n = s1 + s2;
  int np = 1;
  while (np < n) np <<= 1;

  // sort (key, source) pairs; NaNs and padding last
  for (int i = tid; i < np; i += blockDim.x) {
    unsigned long long e = ~0ull;
    if (i < n) {
      const uint32_t k = i < s1 ? key_at(row1, i, cap1)
                                : key_at(row2, i - s1, cap2);
      e = ((unsigned long long)k << 32) | (unsigned)i;
    }
    buf[i] = e;
  }
  __syncthreads();
  block_sort(buf, np, np);

  // tie runs: each thread walks a stretch of the sorted order twice, first
  // counting run starts and each group's sources, then, after a block scan
  // of those counts, writing each source's run and each run's pre_a/pre_b
  const int ch = (np + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * ch, np);
  const int hi = min(lo + ch, np);
  int cnt[3] = {0, 0, 0};  // run starts, group-1 sources, group-2 sources
  for (int s = lo; s < hi; ++s) {
    const uint32_t hk = (uint32_t)(buf[s] >> 32);
    if (hk == NAN_KEY) continue;
    const bool g1 = (uint32_t)buf[s] < (uint32_t)s1;
    cnt[0] += s == 0 || (uint32_t)(buf[s - 1] >> 32) != hk;
    cnt[1] += g1;
    cnt[2] += !g1;
  }
  int total[3];
  block_scan3(cnt, total, scratch);
  const int k = total[0];  // runs
  {
    int run = cnt[0] - 1, a = cnt[1], b = cnt[2];
    for (int s = lo; s < hi; ++s) {
      const unsigned long long e = buf[s];
      const uint32_t hk = (uint32_t)(e >> 32);
      const uint32_t idx = (uint32_t)e;
      if (hk == NAN_KEY) {
        if (idx < (uint32_t)n) run_of[idx] = -1;  // a NaN, not padding
        continue;
      }
      run += s == 0 || (uint32_t)(buf[s - 1] >> 32) != hk;
      const bool g1 = idx < (uint32_t)s1;
      a += g1;
      b += !g1;
      run_of[idx] = run;
      if (s + 1 == np || (uint32_t)(buf[s + 1] >> 32) != hk) {
        pre_a[run] = a;
        pre_b[run] = b;
      }
    }
  }
  __syncthreads();  // the sort buffer becomes the histograms

  if (!capped1 && !capped2) {
    // every repeat is the two prefixes: one pass over the runs
    int best = 0;
    for (int r = tid; r < k; r += blockDim.x)
      best = max(best, abs(pre_a[r] * ne2 - pre_b[r] * ne1));
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nw; ++w) best = max(best, red[w]);
      out[p] = max(best, red[0]);
    }
    return;
  }

  Key g1, g2;
  row_draws(base, row_index[p], g1, g2);
  const Randint draw1(g1, (uint32_t)max(n1, 1));
  const Randint draw2(g2, (uint32_t)max(n2, 1));
  // a lane's stretch of the runs: an odd length, so that the 32 lanes'
  // stretches start in 32 different banks
  const int chr = ((k + 31) >> 5) | 1;
  const int rlo = min(lane * chr, k);
  const int rhi = min(rlo + chr, k);
  for (int r = warp; r < repeats; r += nw) {
    for (int x = lane; x < k; x += 32) hist[x] = 0u;
    __syncwarp();
    const uint32_t base_n = (uint32_t)r * (uint32_t)cov;
    if (capped1) {
      for (int j = lane; j < cov; j += 32) {
        const int run = run_of[min((int)draw1(base_n + j), cap1)];
        if (run >= 0) atomicAdd(&hist[run], 1u);
      }
    }
    if (capped2) {
      for (int j = lane; j < cov; j += 32) {
        const int run = run_of[s1 + min((int)draw2(base_n + j), cap2)];
        if (run >= 0) atomicAdd(&hist[run], 65536u);
      }
    }
    __syncwarp();
    uint32_t sum = 0;
    for (int x = rlo; x < rhi; ++x) sum += hist[x];
    uint32_t acc = sum;  // inclusive, then exclusive, warp scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, acc, o);
      if (lane >= o) acc += y;
    }
    acc -= sum;
    int best = 0;
    for (int x = rlo; x < rhi; ++x) {
      acc += hist[x];
      const int le_a = capped1 ? (int)(acc & 0xffffu) : pre_a[x];
      const int le_b = capped2 ? (int)(acc >> 16) : pre_b[x];
      best = max(best, abs(le_a * ne2 - le_b * ne1));
    }
    best = warp_max(best);
    if (lane == 0) nums[r] = best;
    __syncwarp();
  }
  __syncthreads();

  // the q_idx-th largest: the value v with #{> v} <= q_idx < #{>= v}
  for (int r = tid; r < repeats; r += blockDim.x) {
    const int v = nums[r];
    int gt = 0, ge = 0;
    for (int i = 0; i < repeats; ++i) {
      gt += nums[i] > v;
      ge += nums[i] >= v;
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

// the most sources a group of width `cap` can have (see s1, s2)
size_t max_sources(int cap, int cov) {
  return (size_t)cap + (cap >= cov ? 1 : 0);
}

template <typename T>
int launch(const void* v1, const void* c1, int cap1, const void* v2,
           const void* c2, int cap2, const void* row_index, int p_total,
           int cov, int repeats, int q_idx, Key base, void* out,
           cudaStream_t stream) {
  // the histograms keep a group's count in 16 bits: a group is capped only
  // where its width reaches cov
  if ((cap1 >= cov || cap2 >= cov) && cov >= 65536)
    return (int)cudaErrorInvalidValue;
  const size_t n_max = max_sources(cap1, cov) + max_sources(cap2, cov);
  size_t sort_max = 1;
  while (sort_max < n_max) sort_max <<= 1;
  int nw = MAX_WARPS;
  size_t smem = 0;
  for (; nw >= 1; --nw) {
    size_t u = 8 * sort_max;
    if (4 * nw * n_max > u) u = 4 * nw * n_max;
    smem = u + 12 * n_max + 4 * (size_t)repeats;
    if (smem <= SMEM_CAP) break;
  }
  if (nw < 1) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        capped_ks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  capped_ks_kernel<T><<<p_total, nw * 32, smem, stream>>>(
      (const T*)v1, (const int32_t*)c1, cap1, (const T*)v2,
      (const int32_t*)c2, cap2, (const int32_t*)row_index, cov, repeats,
      q_idx, base, (int)n_max, (int)sort_max, (int32_t*)out);
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
