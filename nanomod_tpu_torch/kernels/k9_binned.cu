// The binned K9 that was measured in place of csrc/accumulate.cu, kept as
// a comparison source: it is not built into the kernel library, and the
// port does not call it.  nanomod_tpu_torch/kernels/k9_ab.py builds it
// alone and times it against csrc/accumulate.cu (PERF.md, K9's row).
//
// Same function as csrc/accumulate.cu: per-position (count, sum, sum of
// squares) of the events that are ok, a negative position p counting as
// p + G + 1, what lies outside [0, G) after that dropped.
//
// Where K9's float4 atomics miss L2 (a [G, 4] accumulator of E. coli's
// 4.6 M positions is 74 MB against 50 MB of L2), this design keeps the
// reduction in shared memory.  The genome is cut into tiles of tile_w
// positions, each a whole number of slices of `sub` positions whose sums
// fit a block's shared memory (k9_ab.py's plan: about whole waves of two
// tile blocks an SM), and:
//   1. count: each block adds its chunk's kept events per tile to the
//      tiles' totals through a histogram in shared memory; the last block
//      to finish turns the totals into each tile's bucket offset;
//   2. scatter: each block sorts a batch of 8,192 events by tile in shared
//      memory, reserves a run of each tile's bucket (one global atomic a
//      tile with events), and writes the batch's records (offset in the
//      tile, value; 8 bytes) run by run, coalesced whatever the order of
//      the input (scattered 8-byte writes cost partial-sector
//      read-modify-writes in HBM);
//   3. tile: a block a tile accumulates its bucket with shared-memory
//      atomics, a slice at a time, and writes its slice of the three [G]
//      outputs once, coalesced.  Every position is written, so nothing is
//      zeroed but the tile totals.
// Loads go four events a thread at a time, several at once, with streaming
// cache hints; lanes of a warp in a run of one tile share one shared-memory
// atomic; tile = (q * magic) >> shift in place of a division; scatter and
// tile launch as programmatic dependents of the kernel before them.
//
// It halves K9's time at uniform positions and is slower at read-major
// events, distributed_detect_step's shape, where K9's atomics coalesce
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTiles = 4096;      // per-tile counters a block holds
constexpr int kMaxSub = 16384;       // positions a tile block sums at once
constexpr int kChunkThreads = 512;   // count and scatter
constexpr int kTileThreads = 1024;
constexpr int kVec = 4;              // consecutive events a load
constexpr int kIters = 4;            // loads a thread issues at once
constexpr int kBatch = kChunkThreads * kVec * kIters;
constexpr int kTileUnroll = 4;       // records a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// what a thread loaded of one batch of events: kIters vectors of kVec
struct Batch {
  int4 p[kIters];
  uchar4 k[kIters];
};

__device__ __forceinline__ long long event_index(long long base, int it) {
  return base + (long long)(it * kChunkThreads + threadIdx.x) * kVec;
}

// the batch at base; past hi (a block's last, partial batch) events read
// as not ok
__device__ __forceinline__ void load_batch(const int* __restrict__ pos,
                                           const uint8_t* __restrict__ ok,
                                           long long base, long long hi,
                                           Batch* b) {
  if (base + kBatch <= hi) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const long long i = event_index(base, it);
      b->p[it] = *reinterpret_cast<const int4*>(pos + i);
      b->k[it] = *reinterpret_cast<const uchar4*>(ok + i);
    }
    return;
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long i = event_index(base, it);
    int q[kVec];
    unsigned char f[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      q[u] = i + u < hi ? pos[i + u] : 0;
      f[u] = i + u < hi ? ok[i + u] : 0;
    }
    b->p[it] = make_int4(q[0], q[1], q[2], q[3]);
    b->k[it] = make_uchar4(f[0], f[1], f[2], f[3]);
  }
}

__device__ __forceinline__ int comp(const int4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned char comp(const uchar4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_comp(int4* v, int u, int x) {
  if (u == 0) v->x = x;
  else if (u == 1) v->y = x;
  else if (u == 2) v->z = x;
  else v->w = x;
}

// the genome's tiling: q / tile_w = (q * magic) >> shift for every q in
// [0, 2^31) (magic = floor(2^shift / tile_w) + 1, shift = 31 +
// ceil(log2 tile_w): a multiply in place of a division)
struct Tiling {
  int genome_len, tile_w, shift;
  unsigned long long magic;
};

// an event's wrapped position, or -1 when it is dropped
__device__ __forceinline__ int kept_position(int p, bool keep,
                                             const Tiling& g) {
  long long q = p;
  if (q < 0) q += (long long)g.genome_len + 1;
  return keep && q >= 0 && q < g.genome_len ? (int)q : -1;
}

__device__ __forceinline__ int tile_of_position(int q, const Tiling& g) {
  return q < 0 ? -1 : (int)(((unsigned long long)q * g.magic) >> g.shift);
}

// Lanes holding the key of the lane before them extend its run.  Returns
// the number of lanes of the run before this one; *total is the run's
// length and *head its first lane.
__device__ __forceinline__ int run_rank(int key, int lane, int* total,
                                        int* head) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  const unsigned upto = kFull >> (31 - lane);        // lanes 0..lane
  const unsigned after = heads & ~upto;
  *head = 31 - __clz(heads & upto);
  const int end = after ? __ffs(after) - 1 : 32;
  *total = end - *head;
  return lane - *head;
}

// start[t] = hist[0] + ... + hist[t - 1] for t < m, over one block; returns
// the sum of all m
__device__ int block_scan(const int* hist, int* start, int m) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
  int s = 0;
  for (int t = lo; t < hi; ++t) s += hist[t];
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int excl = (warp ? warp_sum[warp - 1] : 0) + x - s;
  for (int t = lo; t < hi; ++t) {
    const int h = hist[t];
    start[t] = excl;
    excl += h;
  }
  const int total = warp_sum[nwarps - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kChunkThreads)
accumulate_count_kernel(const int* __restrict__ pos,
                        const uint8_t* __restrict__ ok, long long n,
                        const Tiling g, int ntiles, int chunk,
                        int* __restrict__ totals, unsigned* done,
                        int* __restrict__ offsets, int* __restrict__ cursor) {
  extern __shared__ int hist[];
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long base = lo; base < hi; base += kBatch) {
    Batch b;
    load_batch(pos, ok, base, hi, &b);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int tile = tile_of_position(
            kept_position(comp(b.p[it], u), comp(b.k[it], u), g), g);
        int total, head;
        run_rank(tile, lane, &total, &head);
        if (tile >= 0 && lane == head) atomicAdd(&hist[tile], total);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
    if (hist[t]) atomicAdd(&totals[t], hist[t]);
  // the last block to finish turns the totals into the buckets' offsets
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
    hist[t] = __ldcg(totals + t);
  __syncthreads();
  const int total = block_scan(hist, offsets, ntiles);
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
    cursor[t] = offsets[t];
  if (threadIdx.x == 0) offsets[ntiles] = total;
}

__global__ void __launch_bounds__(kChunkThreads, 2)
accumulate_scatter_kernel(const int* __restrict__ pos,
                          const float* __restrict__ val,
                          const uint8_t* __restrict__ ok, long long n,
                          const Tiling g, int ntiles, int chunk,
                          int* __restrict__ cursor,
                          uint2* __restrict__ bucket) {
  // per tile: the batch's events, its start in the sorted batch, its run
  // in the tile's bucket; then the sorted batch and each record's tile
  extern __shared__ int smem[];
  int* hist = smem;
  int* start = hist + ntiles;
  int* run = start + ntiles;
  uint2* rec = reinterpret_cast<uint2*>(run + ntiles + (ntiles & 1));
  uint16_t* rtile = reinterpret_cast<uint16_t*>(rec + kBatch);
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) hist[t] = 0;
  cudaGridDependencySynchronize();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long base = lo; base < hi; base += kBatch) {
    Batch b;
    load_batch(pos, ok, base, hi, &b);
    // each kept event's tile and its rank among the batch's events of
    // that tile (tile << 16 | rank; -1 when dropped), its wrapped position
    // in place of the loaded one
    int tile_rank[kIters][kVec];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int q = kept_position(comp(b.p[it], u), comp(b.k[it], u), g);
        const int tile = tile_of_position(q, g);
        int total, head;
        const int before = run_rank(tile, lane, &total, &head);
        int first = 0;
        if (tile >= 0 && lane == head) first = atomicAdd(&hist[tile], total);
        first = __shfl_sync(kFull, first, head);
        tile_rank[it][u] = tile < 0 ? -1 : (tile << 16) | (first + before);
        set_comp(&b.p[it], u, q);
      }
    }
    __syncthreads();
    const int kept = block_scan(hist, start, ntiles);
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
      if (hist[t]) run[t] = atomicAdd(&cursor[t], hist[t]);
    // the batch sorted by tile, in shared memory
    const bool full = base + kBatch <= hi;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const long long i = event_index(base, it);
      float4 v;
      if (full) {
        v = __ldcs(reinterpret_cast<const float4*>(val + i));
      } else {
        v.x = i < hi ? val[i] : 0.0f;
        v.y = i + 1 < hi ? val[i + 1] : 0.0f;
        v.z = i + 2 < hi ? val[i + 2] : 0.0f;
        v.w = i + 3 < hi ? val[i + 3] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int tr = tile_rank[it][u];
        if (tr >= 0) {
          const int tile = tr >> 16;
          const int s = start[tile] + (tr & 0xffff);
          const unsigned off = (unsigned)(comp(b.p[it], u) - tile * g.tile_w);
          rec[s] = make_uint2(off, __float_as_uint(comp(v, u)));
          rtile[s] = (uint16_t)tile;
        }
      }
    }
    __syncthreads();
    // run by run into the buckets: neighbouring threads, neighbouring slots
    for (int s = threadIdx.x; s < kept; s += blockDim.x) {
      const int t = rtile[s];
      bucket[run[t] + (s - start[t])] = rec[s];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) hist[t] = 0;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTileThreads)
accumulate_tile_kernel(const int* __restrict__ offsets,
                       const uint2* __restrict__ bucket, int genome_len,
                       int tile_w, int sub, float* __restrict__ cnt,
                       float* __restrict__ s1, float* __restrict__ s2) {
  extern __shared__ unsigned tile_smem[];
  unsigned* c_sh = tile_smem;
  float* s1_sh = reinterpret_cast<float*>(c_sh + sub);
  float* s2_sh = s1_sh + sub;
  cudaGridDependencySynchronize();
  const int beg = offsets[blockIdx.x], end = offsets[blockIdx.x + 1];
  const long long tile_lo = (long long)blockIdx.x * tile_w;
  // a tile of several slices reads its whole bucket once a slice
  for (int slo = 0; slo < tile_w; slo += sub) {
    const long long lo = tile_lo + slo;
    if (lo >= genome_len) break;
    for (int j = threadIdx.x; j < sub; j += blockDim.x) {
      c_sh[j] = 0;
      s1_sh[j] = 0.0f;
      s2_sh[j] = 0.0f;
    }
    __syncthreads();
    for (int e0 = beg + threadIdx.x; e0 < end;
         e0 += kTileUnroll * blockDim.x) {
      uint2 r[kTileUnroll];
#pragma unroll
      for (int u = 0; u < kTileUnroll; ++u) {
        const int e = e0 + u * blockDim.x;
        r[u] = e < end ? __ldcs(bucket + e) : make_uint2(kFull, 0u);
      }
#pragma unroll
      for (int u = 0; u < kTileUnroll; ++u) {
        const unsigned o = r[u].x - (unsigned)slo;
        if (o < (unsigned)sub) {
          const float v = __uint_as_float(r[u].y);
          atomicAdd(&c_sh[o], 1u);
          atomicAdd(&s1_sh[o], v);
          atomicAdd(&s2_sh[o], __fmul_rn(v, v));
        }
      }
    }
    __syncthreads();
    const int m = (int)min((long long)sub, genome_len - lo);
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      __stcs(cnt + lo + j, (float)c_sh[j]);
      __stcs(s1 + lo + j, s1_sh[j]);
      __stcs(s2 + lo + j, s2_sh[j]);
    }
    __syncthreads();
  }
}

size_t scatter_smem(int ntiles) {
  return sizeof(int) * (3 * ntiles + (ntiles & 1)) +
         (sizeof(uint2) + sizeof(uint16_t)) * kBatch;
}

}  // namespace

// pos [n] int32 and val [n] f32, 16-byte aligned; ok [n] u8, 4-byte
// aligned; out [3, genome_len] f32 (count, sum, sum of squares), every
// position written.  The plan (k9_ab.py's plan): tiles of tile_w
// positions, a whole number of slices of sub (a multiple of 256, at most
// kMaxSub), ntiles of them (at most kMaxTiles) covering genome_len;
// nblocks chunks of chunk events (a multiple of kBatch).  scratch: int32,
// 2 n (the buckets, 8-byte aligned), then 3 ntiles + 2 (totals, the
// finished-block count, offsets, cursors).
extern "C" int nm_accumulate(const void* pos, const void* val, const void* ok,
                             int n, int genome_len, int tile_w, int sub,
                             int ntiles, int nblocks, int chunk,
                             void* scratch, void* out, void* stream) {
  if (genome_len <= 0) return 0;
  if (n < 0 || sub < 256 || sub > kMaxSub || sub % 256 != 0 ||
      tile_w < sub || tile_w % sub != 0 || ntiles < 1 ||
      ntiles > kMaxTiles || (long long)ntiles * tile_w < genome_len ||
      nblocks < 1 || chunk < kBatch || chunk % kBatch != 0 ||
      (long long)nblocks * chunk < n || (uintptr_t)pos % 16 != 0 ||
      (uintptr_t)val % 16 != 0 || (uintptr_t)ok % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint2* bucket = (uint2*)scratch;
  int* totals = (int*)scratch + 2 * (size_t)n;
  unsigned* done = (unsigned*)(totals + ntiles);
  int* offsets = totals + ntiles + 1;
  int* cursor = offsets + ntiles + 1;
  float* cnt = (float*)out;
  Tiling g;
  g.genome_len = genome_len;
  g.tile_w = tile_w;
  int l = 0;
  while ((1ll << l) < tile_w) ++l;
  g.shift = 31 + l;
  g.magic = (1ull << g.shift) / (unsigned long long)tile_w + 1;
  const size_t scatter_bytes = scatter_smem(ntiles);
  const size_t tile_bytes = (size_t)12 * sub;
  cudaError_t e = cudaFuncSetAttribute(
      accumulate_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scatter_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(accumulate_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_bytes);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(totals, 0, sizeof(int) * (ntiles + 1), s);
  if (e != cudaSuccess) return (int)e;
  accumulate_count_kernel<<<nblocks, kChunkThreads, sizeof(int) * ntiles,
                            s>>>((const int*)pos, (const uint8_t*)ok, n, g,
                                 ntiles, chunk, totals, done, offsets,
                                 cursor);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kChunkThreads);
  cfg.dynamicSmemBytes = scatter_bytes;
  e = cudaLaunchKernelEx(&cfg, accumulate_scatter_kernel, (const int*)pos,
                         (const float*)val, (const uint8_t*)ok,
                         (long long)n, g, ntiles, chunk, cursor, bucket);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(ntiles);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = tile_bytes;
  e = cudaLaunchKernelEx(&cfg, accumulate_tile_kernel, (const int*)offsets,
                         (const uint2*)bucket, genome_len, tile_w, sub, cnt,
                         cnt + genome_len, cnt + 2 * (size_t)genome_len);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
