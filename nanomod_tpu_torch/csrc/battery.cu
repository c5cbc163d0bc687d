// K3: per-position two-sample battery components (KS, Mann-Whitney U,
// tie sums, exact milli-domain Welch sums), Hopper.
//
// Replaces the XLA device function nanomod_tpu/stats/kernels.py
// battery_components_packed_milli (with _pairwise_counts,
// _pairwise_components and _milli_exact_sums) and the rank rows of
// battery_components_packed.  Everything reduces to pairwise <= / < counts
// of each pooled value against each group, so every output is an exact
// int32, bit-equal to the JAX function and to the native host battery
// (sort_core.cpp nm_battery_milli):
//
//   0 ks_num  = max_q |le_a(q)*n2 - le_b(q)*n1|      (D = ks_num/(n1*n2))
//   1 two_rank_sum = sum over group-1 q of cnt_lt + cnt_le + 1
//   2 tie_sum = sum over q of t*t - 1,  t = cnt_le - cnt_lt
//   3-5 sum1, sum(x*x >> 15), sum(x*x & 0x7fff) of group 1  (milli only)
//   6-8 the same for group 2                                 (milli only)
//
// The JAX version builds the [P, C, N] compare tensor (fused by XLA on the
// TPU); a naive PyTorch port would materialise it in device memory.  Here
// one block takes one position row: the row's valid values of both groups
// (at most 1,290 of them, about 2.6 KB as int16) are staged in shared
// memory, each thread counts a strided share of the pooled queries against
// them in registers, and the block reduces the partial sums with warp
// shuffles.  What bounds it: N^2 compares per row from shared memory
// (N ~ 60-200 at real coverage), so the kernel is bound by shared-memory
// bandwidth and issue rate, not by device memory (the inputs are read
// once).  Templated on the value type: int16 milli tiles and f32 tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int NOUT = 9;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, bool MILLI>
__global__ void __launch_bounds__(THREADS)
    battery_kernel(const T* __restrict__ v1, const int32_t* __restrict__ c1,
                   int cap1, const T* __restrict__ v2,
                   const int32_t* __restrict__ c2, int cap2, int p_total,
                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  __shared__ int red[NWARPS][NOUT];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int n1r = c1[p];  // counts as given (the formula uses them as is)
  const int n2r = c2[p];
  const int n1 = min(max(n1r, 0), cap1);  // valid prefix lengths
  const int n2 = min(max(n2r, 0), cap2);
  const int n = n1 + n2;
  for (int j = tid; j < n1; j += THREADS) s[j] = v1[(size_t)p * cap1 + j];
  for (int j = tid; j < n2; j += THREADS) s[n1 + j] = v2[(size_t)p * cap2 + j];
  __syncthreads();

  int acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0;
  for (int q = tid; q < n; q += THREADS) {
    const T z = s[q];
    int le_a = 0, lt_a = 0, le_b = 0, lt_b = 0;
    for (int j = 0; j < n1; ++j) {
      const T v = s[j];
      le_a += v <= z;
      lt_a += v < z;
    }
    for (int j = n1; j < n; ++j) {
      const T v = s[j];
      le_b += v <= z;
      lt_b += v < z;
    }
    acc[0] = max(acc[0], abs(le_a * n2r - le_b * n1r));
    const int cle = le_a + le_b;
    const int clt = lt_a + lt_b;
    if (q < n1) acc[1] += clt + cle + 1;
    const int t = cle - clt;
    acc[2] += t * t - 1;
  }
  if (MILLI) {
    for (int j = tid; j < n; j += THREADS) {
      const int x = (int)s[j];
      const int sq = x * x;
      // acc is indexed by constants only so it stays in registers
      if (j < n1) {
        acc[3] += x;
        acc[4] += sq >> 15;
        acc[5] += sq & 0x7fff;
      } else {
        acc[6] += x;
        acc[7] += sq >> 15;
        acc[8] += sq & 0x7fff;
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nrows = MILLI ? 9 : 3;
  acc[0] = warp_max(acc[0]);
#pragma unroll
  for (int r = 1; r < nrows; ++r) acc[r] = warp_sum(acc[r]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < nrows; ++r) red[warp][r] = acc[r];
  }
  __syncthreads();
  if (tid < nrows) {
    int v = red[0][tid];
    for (int wi = 1; wi < NWARPS; ++wi)
      v = tid == 0 ? max(v, red[wi][tid]) : v + red[wi][tid];
    out[(size_t)tid * p_total + p] = v;
  }
}

template <typename T, bool MILLI>
int launch(const void* v1, const void* c1, int cap1, const void* v2,
           const void* c2, int cap2, int p_total, void* out,
           cudaStream_t stream) {
  const size_t smem = (size_t)(cap1 + cap2) * sizeof(T);
  battery_kernel<T, MILLI><<<p_total, THREADS, smem, stream>>>(
      (const T*)v1, (const int32_t*)c1, cap1, (const T*)v2,
      (const int32_t*)c2, cap2, p_total, (int32_t*)out);
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
