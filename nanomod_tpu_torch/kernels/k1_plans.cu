// Candidate launch plans of K1's wide kernel (csrc/banded_sw.cu, W > 1024)
// and the barriers a plan could be built on, for kernels/k1_plans.py: not
// part of the kernel library, and the port does not call it.
//
// k1p_narrow runs the narrow kernel at any band width to 1024, so that it
// can be timed beside the wide plans wherever the library's edge lies.
// k1p_launch runs banded_sw_wide_kernel under any plan of NM_CANDIDATES
// (lanes a thread, threads bound, blocks an SM asked), so that the plans
// can be timed side by side on the same inputs; csrc/banded_sw.cu
// WIDE_PLANS keeps the fastest at each band width.  k1p_barriers times a
// block barrier (__syncthreads) against a cluster barrier of two blocks on
// two SMs, with and without a read of the other block's shared memory:
// the price, a row, of spreading one read over two SMs.  k1p_lds_chain
// times a chain of dependent shared-memory loads (the latency that bounds
// K2's walk, a load a step).

#include <cooperative_groups.h>

#include "../csrc/banded_sw.cu"

namespace cg = cooperative_groups;

#define NM_CANDIDATES(X)                                                 \
  X(2, 1024, 1) X(4, 512, 1) X(4, 512, 2) X(8, 256, 2) X(8, 512, 1)     \
  X(16, 256, 1) X(16, 512, 1) X(16, 1024, 1) X(32, 1024, 1)

extern "C" int k1p_count() {
  int n = 0;
#define NM_COUNT(LP, MAXT, MINB) ++n;
  NM_CANDIDATES(NM_COUNT)
#undef NM_COUNT
  return n;
}

// out = {lanes a thread, threads bound, blocks an SM asked} of plan idx
extern "C" int k1p_plan(int idx, int* out) {
  int n = 0;
#define NM_PLAN(LP, MAXT, MINB)                                          \
  if (n++ == idx) {                                                      \
    out[0] = LP;                                                         \
    out[1] = MAXT;                                                       \
    out[2] = MINB;                                                       \
    return 0;                                                            \
  }
  NM_CANDIDATES(NM_PLAN)
#undef NM_PLAN
  return -1;
}

extern "C" int k1p_launch(int idx, const void* read, const void* ref,
                          const void* lens, void* tb, void* best, void* bi,
                          void* bk, int bsz, int m, int w, int pitch,
                          float match, float mismatch, float go, float ge,
                          void* stream) {
  int n = 0;
#define NM_LAUNCH(LP, MAXT, MINB)                                        \
  if (n++ == idx)                                                        \
    return launch_wide<LP, MAXT, MINB>(read, ref, lens, tb, best, bi, bk, \
                                       bsz, m, w, pitch, match, mismatch, \
                                       go, ge, (cudaStream_t)stream);
  NM_CANDIDATES(NM_LAUNCH)
#undef NM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// the narrow kernel (one warp a read) at any w in [1, 1024], whatever the
// library's NARROW_MAX_W: the other side of the narrow/wide crossover
extern "C" int k1p_narrow(const void* read, const void* ref,
                          const void* lens, void* tb, void* best, void* bi,
                          void* bk, int bsz, int m, int w, int pitch,
                          float match, float mismatch, float go, float ge,
                          void* stream) {
  return launch_narrow<1024>(read, ref, lens, tb, best, bi, bk, bsz, m, w,
                             pitch, match, mismatch, go, ge,
                             (cudaStream_t)stream);
}

namespace {

// iters block barriers; the SM clocks they took, one a block
__global__ void block_barriers(int iters, long long* clocks) {
  __shared__ float s[32];
  float x = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = x;
    __syncthreads();
    x += s[(threadIdx.x >> 5) ^ 1];
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
  if (x == -1.f) clocks[0] = 0;  // keeps x alive
}

// iters cluster barriers of two blocks; with `remote`, each warp's lane 0
// also reads the other block's slot (distributed shared memory) a round
__global__ void __cluster_dims__(2, 1, 1)
    cluster_barriers(int iters, int remote, long long* clocks) {
  __shared__ float s[32];
  cg::cluster_group cl = cg::this_cluster();
  float* peer = cl.map_shared_rank(s, cl.block_rank() ^ 1);
  float x = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = x;
    cl.sync();
    if (remote && (threadIdx.x & 31) == 0) x += peer[threadIdx.x >> 5];
  }
  const long long t1 = clock64();
  cl.sync();  // no block leaves while the other may read its slots
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
  if (x == -1.f) clocks[0] = 0;
}

// a chain of dependent shared-memory byte loads, each at the address the
// previous one gave (K2's walk is such a chain, a load a step): one thread,
// iters loads, their SM clocks
__global__ void lds_chain(int iters, long long* clocks) {
  __shared__ uint8_t s[256];
  s[threadIdx.x] = (uint8_t)((threadIdx.x * 37 + 11) & 255);
  __syncthreads();
  if (threadIdx.x) return;
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  unsigned x = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(x) : "r"(a + x));
  const long long t1 = clock64();
  clocks[0] = t1 - t0;
  clocks[1] = x;
}

}  // namespace

// the clocks of `iters` dependent shared-memory loads (clocks[0])
extern "C" int k1p_lds_chain(int iters, void* clocks, void* stream) {
  lds_chain<<<1, 256, 0, (cudaStream_t)stream>>>(iters, (long long*)clocks);
  return (int)cudaGetLastError();
}

// kind 0: block barriers, 1: cluster barriers, 2: cluster barriers with a
// remote read; blocks of `threads` threads, `blocks` blocks (even)
extern "C" int k1p_barriers(int kind, int blocks, int threads, int iters,
                            void* clocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    block_barriers<<<blocks, threads, 0, st>>>(iters, (long long*)clocks);
  else
    cluster_barriers<<<blocks, threads, 0, st>>>(iters, kind == 2,
                                                 (long long*)clocks);
  return (int)cudaGetLastError();
}
