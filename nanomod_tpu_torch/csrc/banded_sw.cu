// K1: batched banded affine-gap local alignment (Smith-Waterman), Hopper.
//
// Replaces the Pallas TPU kernel nanomod_tpu/resquiggle/banded_pallas.py
// banded_sw_pallas (kernel body _kernel) and its lax.scan twin
// nanomod_tpu/resquiggle/banded.py banded_sw.  Same recurrences, same
// outputs, array-equal:
//
//   F[i,k] = max(H[i-1,k+1] + go, F[i-1,k+1] + ge)
//   Hnoe   = max(H[i-1,k] + sub(i, i+k), F[i,k], 0)
//   E[i,k] = ((ge*k + go) - ge) + max_{l<k} (Hnoe[i,l] - ge*l)
//   H[i,k] = max(Hnoe, E)          rows i >= len: H = 0, F = NEG
//   tb     = src (bits 0-1) | E-extend (bit 2) | F-extend (bit 3)
//
// What bounds it on the card: the rows are a chain of M dependent steps,
// so a read is latency bound; the bulk traffic, the [B,M,W] u8 traceback
// written once, is ~10 us of device-memory time for a whole batch.  The
// design therefore shortens the chain of one row and runs one read per
// warp, with no barrier in the row loop:
//
//  * One warp a read, blocks of WARPS warps (a ragged last block just has
//    idle warps).  Thread t holds the LP consecutive band lanes
//    k = t*LP .. t*LP+LP-1 in registers (LP = W/32 rounded up to a power
//    of two).  The k+1 neighbour of a lane is in the same thread except
//    for the thread's last lane, which takes the next thread's first by
//    one __shfl_down_sync.
//  * Any W in [1, NARROW_MAX_W = 256] (wider bands: banded_sw_wide_kernel,
//    below, a block of several warps a read, which is faster from W 257
//    on at every batch size timed: kernels/k1_plans.py, PERF.md).  Lanes
//    k >= W are computed and
//    dropped: they only feed lanes above them (the running max runs up
//    the band), except through the k+1 neighbour of lane W-1, which must
//    read the band's end.  Whole threads past W are cut off by the
//    thread's edge test.
//    When W is not a multiple of LP, one thread holds lanes on both sides
//    of W (the RAGGED instantiation): it keeps H and F of its lanes past W
//    at NEG in every row, so that lane W-1 reads NEG from its neighbour,
//    as the reference's band edge gives, and leaves them out of the best
//    cell.
//  * The traceback rows have a pitch of P = W rounded up to a multiple of
//    32 bytes ([B, M, P] u8; the wrapper returns the [..., :W] view).  A
//    thread's LP bytes then never cross a row and its word store is
//    aligned at any W; K2 copies these rows with 16-byte cp.async.  On the
//    grid of 32 (P = W, never RAGGED) the PITCHED = false instantiation
//    addresses rows by W and takes the pitch as its last argument, unused:
//    its code is the one K1 had before it took other widths.  An
//    instantiation that read the pitch loaded it from the constant bank
//    inside the row loop and ran 4.5 % slower at W = 128
//    (kernels/sass_ab.py, PERF.md).
//  * The exclusive running max of Hnoe - ge*k is a serial max over the
//    thread's lanes, a 5-step shuffle scan of the thread totals, one
//    shuffle to make it exclusive, and a max per lane: exact, since max
//    is.  Seven dependent shuffles a row sit on the chain, so a row is
//    bound by their latency.
//  * The rest of a row (its tb byte: the source, the two extend tests; the
//    best-cell update; the store) is not on the chain.  A warp issues in
//    order, so that work is done for row i-1 inside row i's loop body,
//    where the scheduler can place it in the scan's shuffle stalls
//    (software pipelining across rows).  The source is chosen with
//    selects: as a chain of branches it split the body into blocks that
//    the scheduler could not interleave, and the branches sat on the
//    chain.  The row loop is unrolled twice up to 4 lanes a thread.  The
//    two scores are held in registers, so no constant-bank load sits in a
//    row.
//  * The row max leaves the loop.  Each lane keeps its best H and the
//    first row where it reached that value (a strictly higher value
//    replaces it).  One warp reduction after the loop takes the largest
//    value, then the smallest row, then the smallest k.  That is the
//    reference's cell (row by row, a row replaces the best only if its
//    max is strictly higher; the first lane within a row): if G is the
//    global best and r* the first row holding G, no lane reaches G before
//    r*, so the lanes holding G at r* are exactly the lanes whose first
//    row at their own best G is r*, and the smallest of those k is the
//    reference's first lane.  With no positive cell every lane keeps
//    (0, row 0) and the reduction gives (0, 0, 0), as the reference.
//  * Codes staged ahead: the read's codes and its reference window come
//    into shared memory in chunks of RC rows.  While the warp works on a
//    chunk, each thread already holds its share of the next chunk in
//    registers (plain loads issued at the chunk's start); they go to
//    shared memory after it.  No device-memory load sits in a row's
//    chain, and any M and row alignment work (cp.async needs aligned
//    16-byte rows, which M + W need not give).
//  * Each thread stores its LP tb bytes of a row as one word: coalesced
//    bytes a row per warp into the [B, M, P] u8 layout that K2 reads (the
//    bytes of lanes past W land in the row's padding).
//
// Rounding: at NEG = -1e9 the spacing of f32 is 64, so NEG + go rounds back
// to NEG; those values feed the extend bits at the band edges.  Every add
// is __fadd_rn (and the library is built with --fmad=false) in the
// reference's order of operations, so the bits match exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEGF = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;  // reads (warps) a block
constexpr int RC = 32;    // rows a staged chunk

// one row's LP tb bytes (packed little-endian in words) to device memory
template <int LP>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const uint32_t (&wd)[(LP + 3) / 4]) {
  if constexpr (LP == 1) {
    *dst = (uint8_t)wd[0];
  } else if constexpr (LP == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[0];
  } else if constexpr (LP == 4) {
    *reinterpret_cast<uint32_t*>(dst) = wd[0];
  } else if constexpr (LP == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
  } else {
#pragma unroll
    for (int q = 0; q < LP / 16; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(wd[4 * q], wd[4 * q + 1], wd[4 * q + 2], wd[4 * q + 3]);
  }
}

template <int LP, bool RAGGED, bool PITCHED>
__global__ void __launch_bounds__(32 * WARPS)
    banded_sw_kernel(const uint8_t* __restrict__ read,
                     const uint8_t* __restrict__ ref,
                     const int32_t* __restrict__ lens,
                     uint8_t* __restrict__ tb, float* __restrict__ best_out,
                     int32_t* __restrict__ bi_out,
                     int32_t* __restrict__ bk_out, int bsz, int m, int w,
                     float match, float mismatch, float go, float ge,
                     int pitch) {
  constexpr int REF_CHUNK = RC + 32 * LP;  // ref bytes a chunk's rows read
  // two rows a loop body while the registers allow it
  constexpr int ROW_UNROLL = LP <= 4 ? 2 : 1;
  __shared__ uint8_t s_rd[WARPS][RC];
  __shared__ uint8_t s_rf[WARPS][REF_CHUNK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= bsz) return;  // the whole warp: no barrier below spans warps
  const int rw = m + w;
  const uint8_t* rd = read + (size_t)b * m;
  const uint8_t* rf = ref + (size_t)b * rw;
  const int stride = PITCHED ? pitch : w;  // tb's row stride in bytes
  uint8_t* tbb = tb + (size_t)b * m * stride;
  const int len = lens[b];
  const int k0 = lane * LP;
  const bool live = k0 < w;        // the thread holds a lane of the band
  const bool edge = k0 + LP >= w;  // last lane's k+1 is off the band
  // RAGGED: the lanes of this thread past the band (k >= w)
  bool past[LP];
#pragma unroll
  for (int j = 0; j < LP; ++j) past[j] = RAGGED && k0 + j >= w;
  // the two scores in registers (opaque to the compiler), so that a
  // substitution is one select and no constant-bank load sits in the row
  float match_r, mismatch_r;
  asm("mov.b32 %0, %1;" : "=f"(match_r) : "f"(match));
  asm("mov.b32 %0, %1;" : "=f"(mismatch_r) : "f"(mismatch));

  float gek[LP], e_base[LP], h[LP], f[LP], bv[LP];
  int br[LP];
#pragma unroll
  for (int j = 0; j < LP; ++j) {
    gek[j] = __fmul_rn(ge, (float)(k0 + j));
    e_base[j] = __fsub_rn(__fadd_rn(gek[j], go), ge);
    h[j] = past[j] ? NEGF : 0.f;
    f[j] = NEGF;
    bv[j] = 0.f;
    br[j] = 0;
  }

  // the next chunk's codes, a thread's share.  A code of 4 or more never
  // matches: the read's become 8 and the window's 9, so that a match is
  // one compare.
  uint8_t n_rd;
  uint8_t n_rf[LP + 1];
  auto fetch = [&](int i0) {
    const int c = i0 + lane < m ? rd[i0 + lane] : 8;
    n_rd = c < 4 ? c : 8;
#pragma unroll
    for (int q = 0; q <= LP; ++q) {
      const int x = i0 + q * 32 + lane;
      const int d = x < rw ? rf[x] : 9;
      n_rf[q] = d < 4 ? d : 9;
    }
  };
  auto stage = [&]() {
    s_rd[warp][lane] = n_rd;
#pragma unroll
    for (int q = 0; q <= LP; ++q) s_rf[warp][q * 32 + lane] = n_rf[q];
  };
  fetch(0);
  stage();
  __syncwarp();

  // the previous row's values: its tb bytes and best are finished while
  // the next row's chain runs (software pipelining across rows)
  float p_hne[LP], p_e[LP], p_hd[LP], p_hu[LP];
#pragma unroll
  for (int j = 0; j < LP; ++j) {
    p_hne[j] = 0.f;
    p_e[j] = 0.f;
    p_hd[j] = 0.f;
    p_hu[j] = 0.f;
  }
  auto tail = [&](int ip) {
    float hn_left = __shfl_up_sync(FULL, p_hne[LP - 1], 1);  // Hnoe[k0-1]
    if (lane == 0) hn_left = NEGF;
    uint32_t wd[(LP + 3) / 4] = {};
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      const float h_cur = h[j];
      const float f_cur = f[j];
      const float e_cur = p_e[j];
      // selects, not branches (see the note above)
      const int s3 = f_cur >= fmaxf(p_hd[j], 0.f) ? 3 : 1;
      const int s2 = e_cur >= p_hne[j] ? 2 : s3;
      const int src = h_cur <= 0.f ? 0 : s2;
      const float hp = j ? p_hne[j - 1] : hn_left;
      const int e_ext = e_cur > __fadd_rn(__fadd_rn(hp, go), 1e-4f);
      const int f_ext = f_cur > __fadd_rn(__fadd_rn(p_hu[j], go), 1e-4f);
      wd[j >> 2] |= (uint32_t)(src | (e_ext << 2) | (f_ext << 3))
                    << (8 * (j & 3));
      if (h_cur > bv[j]) {  // a lane's first row at its best value
        bv[j] = h_cur;
        br[j] = ip;
      }
    }
    if (live && ip >= 0) store_row<LP>(tbb + (size_t)ip * stride + k0, wd);
  };

  for (int i0 = 0; i0 < m; i0 += RC) {
    const bool more = i0 + RC < m;
    if (more) fetch(i0 + RC);  // in flight while this chunk runs
    const int rows = min(RC, m - i0);
#pragma unroll ROW_UNROLL
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r;
      const bool valid = i < len;
      const int rc = s_rd[warp][r];
      const uint8_t* rr = &s_rf[warp][r + k0];

      // predecessors at (i-1, k+1)
      float hu[LP], fu[LP];
#pragma unroll
      for (int j = 0; j + 1 < LP; ++j) {
        hu[j] = h[j + 1];
        fu[j] = f[j + 1];
      }
      const float hn = __shfl_down_sync(FULL, h[0], 1);
      const float fn = __shfl_down_sync(FULL, f[0], 1);
      hu[LP - 1] = edge ? NEGF : hn;
      fu[LP - 1] = edge ? NEGF : fn;

      float fc[LP], hd[LP], hne[LP], pre[LP];
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        const float sub = rr[j] == rc ? match_r : mismatch_r;
        fc[j] = fmaxf(__fadd_rn(hu[j], go), __fadd_rn(fu[j], ge));
        hd[j] = __fadd_rn(h[j], sub);
        hne[j] = fmaxf(fmaxf(hd[j], fc[j]), 0.f);
        const float a = __fsub_rn(hne[j], gek[j]);  // Hnoe - ge*k
        pre[j] = j ? fmaxf(pre[j - 1], a) : a;     // inclusive, this thread
      }
      // the previous row's tail, independent of this row's scan
      tail(i - 1);
      // exclusive running max over the threads before this one (a lane
      // below o gets its own value back, and max(x, x) = x)
      float incl = pre[LP - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        incl = fmaxf(incl, __shfl_up_sync(FULL, incl, o));
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEGF;

#pragma unroll
      for (int j = 0; j < LP; ++j) {
        const float cm = j ? fmaxf(excl, pre[j - 1]) : excl;
        const float e_cur = __fadd_rn(e_base[j], cm);
        float h_cur = fmaxf(hne[j], e_cur);
        float f_cur = fc[j];
        if (!valid) {
          h_cur = 0.f;
          f_cur = NEGF;
        }
        if (past[j]) {  // RAGGED only: lane W-1 reads NEG at k+1
          h_cur = NEGF;
          f_cur = NEGF;
        }
        h[j] = h_cur;
        f[j] = f_cur;
        p_hne[j] = hne[j];
        p_e[j] = e_cur;
        p_hd[j] = hd[j];
        p_hu[j] = hu[j];
      }
    }
    __syncwarp();  // every lane is done with this chunk's codes
    if (more) stage();
    __syncwarp();
  }
  tail(m - 1);

  // largest value, then smallest row, then smallest k
  float v = -1.f;
  int row = 0x7fffffff, kk = 0x7fffffff;
  if (live) {
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      if (past[j]) continue;
      if (bv[j] > v || (bv[j] == v && br[j] < row)) {
        v = bv[j];
        row = br[j];
        kk = k0 + j;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(FULL, v, o);
    const int r2 = __shfl_down_sync(FULL, row, o);
    const int k2 = __shfl_down_sync(FULL, kk, o);
    if (v2 > v || (v2 == v && (r2 < row || (r2 == row && k2 < kk)))) {
      v = v2;
      row = r2;
      kk = k2;
    }
  }
  if (lane == 0) {
    best_out[b] = v;
    bi_out[b] = row;
    bk_out[b] = kk;
  }
}

template <int LP, bool RAGGED, bool PITCHED>
int launch_one(const void* read, const void* ref, const void* lens, void* tb,
               void* best, void* bi, void* bk, int bsz, int m, int w,
               int pitch, float match, float mismatch, float go, float ge,
               cudaStream_t stream) {
  const int blocks = (bsz + WARPS - 1) / WARPS;
  banded_sw_kernel<LP, RAGGED, PITCHED><<<blocks, 32 * WARPS, 0, stream>>>(
      (const uint8_t*)read, (const uint8_t*)ref, (const int32_t*)lens,
      (uint8_t*)tb, (float*)best, (int32_t*)bi, (int32_t*)bk, bsz, m, w,
      match, mismatch, go, ge, pitch);
  return (int)cudaGetLastError();
}

// on the grid of 32, w is a multiple of LP and pitch == w; off it, rows are
// pitched and the last live thread is ragged where LP does not divide w
// (always at LP = 32, never at LP = 1)
template <int LP>
int launch(const void* read, const void* ref, const void* lens, void* tb,
           void* best, void* bi, void* bk, int bsz, int m, int w, int pitch,
           float match, float mismatch, float go, float ge,
           cudaStream_t stream) {
#define NM_ONE(RAGGED, PITCHED)                                            \
  return launch_one<LP, RAGGED, PITCHED>(read, ref, lens, tb, best, bi, bk, \
                                         bsz, m, w, pitch, match, mismatch, \
                                         go, ge, stream)
  if (w % 32 == 0) NM_ONE(false, false);
  if constexpr (LP == 1) {
    NM_ONE(false, true);
  } else if constexpr (LP == 32) {
    NM_ONE(true, true);
  } else {
    if (w % LP) NM_ONE(true, true);
    NM_ONE(false, true);
  }
#undef NM_ONE
}


// ---------------------------------------------------------------------------
// W in (NARROW_MAX_W, 32768]: a block of NW = ceil(W / (32 LP)) warps a read
// ---------------------------------------------------------------------------
//
// The same recurrences, lanes and order of operations as banded_sw_kernel;
// thread t of the block holds lanes t*LP .. t*LP+LP-1.  Two things cross a
// warp boundary in a row: the k+1 neighbour of a warp's top lane (lane 0 of
// the next warp, from the previous row) and the exclusive running max of
// Hnoe - ge*k (the totals of the warps below).  Both go through shared
// memory with ONE __syncthreads a row:
//
//  * Before the barrier each warp computes its lanes and its warp scan with
//    the top lane (lane 31's last) left out, since only that lane needs the
//    next warp, and publishes the scan's total without it, T'.  At the end
//    of a row each warp publishes the state of its lane 0 (H, F) and of its
//    top lane (H).  Slots are double-buffered by row parity, so a slot is
//    never written while a warp may still read it.
//  * After the barrier lane 31 finishes its top lane from the next warp's
//    published lane 0, and the warp's prefix over the warps below is
//    max_l max(T'_l, Hnoe_top_l - ge*k_top_l) for l < g: lane l rebuilds
//    warp l's top-lane Hnoe from the published previous row (the same adds
//    in the same order, so the same bits) and one redux.sync takes the max
//    of the lanes (on the order-preserving integer image of the floats;
//    max is exact, so its order does not matter).  Lane g-1's rebuilt Hnoe
//    is also the left neighbour of the warp's lane 0 (the E-extend test).
//
// What bounds it: a read's rows are a chain, and B reads of W lanes fill
// the card, so the SMs' instruction issue is the limit, far above the
// bytes bound (the traceback written once).  The design spends few
// instructions a cell:
//
//  * No software pipelining: the row's tb byte and best are finished after
//    its own barrier, while the block's other warps and the SM's other
//    blocks fill the barrier's and the shuffles' stalls.  The previous
//    row's values are not copied a cell, and the registers they took go to
//    occupancy.  (Finishing each row during the next row's scan, with the
//    two rows' values in alternating registers, measured no faster: more
//    registers, fewer blocks an SM; PERF.md.)
//  * Shared-memory slot addresses are held in registers (smem_reg): the
//    compiler otherwise rebuilt each from the block's shared window in
//    every row, some 30 instructions a row.
//  * The substitution is one predicate and one select a cell: the thread
//    holds its LP reference codes as one-hot nibbles in registers, slid by
//    one nibble a row (one shared-memory byte a row, not one a lane), and
//    the row's read code comes as a one-hot nibble replicated eight times,
//    so that a match is one AND with an immediate mask.
//  * The tb byte reuses hu + go of F for the F-extend test, and tests
//    F >= hd for the source where the reference tests F >= max(hd, 0):
//    the source reads that test only when H > 0 and E < Hnoe, where
//    H = Hnoe = max(hd, F) > 0, and then both tests agree.
//  * Rows i >= len (H = 0, F = NEG) take their own instantiation of the row
//    body, so a valid row spends nothing on them.
//  * Lanes past the band (k >= W): only lane W is read below the band (the
//    k+1 neighbour of lane W-1), so only the thread holding lane W keeps its
//    lanes from W up at NEG, inside a branch of the one warp that holds it.
//    Whole threads past W compute lanes that feed only lanes above W.
//  * The best cell: each thread keeps its best value, the first row where
//    its largest lane reached it and the smallest such lane (one max over
//    the thread's lanes a row; the lanes are searched only in a row that
//    raises the thread's best).  The reduction over the threads takes the
//    largest value, then the smallest row, then the smallest k: the
//    reference's cell (see banded_sw_kernel's note).
//  * The codes of a chunk of RC rows come in through every thread of the
//    block, one chunk ahead in registers.
//
// The launch plan (lanes a thread, threads bound, blocks an SM) comes from
// W and the batch (WIDE_PLANS below; nanomod_tpu_torch/resquiggle/
// banded_kernel.py wide_plan mirrors it).  Above 16 warps of 16 lanes the
// lane arrays spill to local memory: slow, but bit-exact.

constexpr int WIDE_MAX_W = 32768;
// the widest band of the narrow kernel: above it the wide kernel runs
// (resquiggle/banded_kernel.py NARROW_MAX_W is the same)
constexpr int NARROW_MAX_W = 256;

// one code as a one-hot nibble: 0 for a code of 4 or more (never a match)
__device__ __forceinline__ uint32_t onehot(int c) {
  return c < 4 ? 1u << c : 0u;
}
// a float's order-preserving image as a signed int (no NaN here), and back
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}
// a shared-memory address held in a register (opaque to the compiler, which
// would otherwise rebuild it from the block's shared window in every row),
// and loads and stores through it at an immediate offset
__device__ __forceinline__ unsigned smem_reg(const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("mov.b32 %0, %0;" : "+r"(a));
  return a;
}
template <int OFF>
__device__ __forceinline__ float ld_slot(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(a), "n"(OFF));
  return v;
}
template <int OFF>
__device__ __forceinline__ void st_slot(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0+%1], %2;" ::"r"(a), "n"(OFF), "f"(v)
               : "memory");
}
// the slots of a row parity: T', lane 0's H and F, the top lane's H, a warp
// each (byte offsets in s_slot[parity])
constexpr int SLOT_T = 0, SLOT_H0 = 128, SLOT_F0 = 256, SLOT_HT = 384;
constexpr int SLOT_PARITY = 512;

template <int LP, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    banded_sw_wide_kernel(const uint8_t* __restrict__ read,
                          const uint8_t* __restrict__ ref,
                          const int32_t* __restrict__ lens,
                          uint8_t* __restrict__ tb,
                          float* __restrict__ best_out,
                          int32_t* __restrict__ bi_out,
                          int32_t* __restrict__ bk_out, int m, int w,
                          float match, float mismatch, float go, float ge,
                          int pitch) {
  static_assert(LP >= 2, "the top lane is not the thread's only lane");
  constexpr int NWIN = (LP + 7) / 8;        // words of the nibble window
  constexpr int NFETCH = (LP + 4) / 4;      // words of a chunk's LP+1 codes
  extern __shared__ uint8_t s_rf[];  // (LP + 1) * blockDim.x one-hot codes
  __shared__ uint32_t s_rd[RC];      // a read code's nibble, eight times
  // row-parity slots, one a warp: T' (this row), lane 0's H and F and the
  // top lane's H (the previous row): s_slot[parity][SLOT_* / 128][warp]
  __shared__ __align__(16) float s_slot[2][4][32];
  __shared__ float s_bv[32];
  __shared__ int s_br[32], s_bk[32];

  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int rw = m + w;
  const uint8_t* rd = read + (size_t)b * m;
  const uint8_t* rf = ref + (size_t)b * rw;
  uint8_t* trow = tb + (size_t)b * m * pitch + tid * LP;  // row 0
  const int len = lens[b];
  const int k0 = tid * LP;
  const bool live = k0 < w;
  const bool edge = k0 + LP >= w;
  // the warp of the thread holding lane W, and that thread's first lane
  // past the band (LP in every other thread)
  const bool wwarp = g == w / LP / 32;
  const int past0 = k0 <= w && w < k0 + LP ? w - k0 : LP;
  float match_r, mismatch_r;
  asm("mov.b32 %0, %1;" : "=f"(match_r) : "f"(match));
  asm("mov.b32 %0, %1;" : "=f"(mismatch_r) : "f"(mismatch));
  // lane l's part of the prefix: the top lane of warp l
  const int ktop = (lane + 1) * 32 * LP - 1;
  const float gek_top = __fmul_rn(ge, (float)ktop);

  float gek[LP], e_base[LP], h[LP], f[LP];
#pragma unroll
  for (int j = 0; j < LP; ++j) {
    gek[j] = __fmul_rn(ge, (float)(k0 + j));
    e_base[j] = __fsub_rn(__fadd_rn(gek[j], go), ge);
    h[j] = k0 + j >= w ? NEGF : 0.f;
    f[j] = NEGF;
  }
  // this thread's best: value, first row, lane (threads past W never win)
  float tv = live ? 0.f : __int_as_float(0x7f800000);
  int tr = 0, tj = 0;

  // the next chunk's codes, a thread's share, as one-hot bytes
  uint32_t n_rd = 0;
  uint32_t n_rf[NFETCH];
  auto fetch = [&](int i0) {
    if (tid < RC) n_rd = onehot(i0 + tid < m ? rd[i0 + tid] : 8);
#pragma unroll
    for (int q = 0; q < NFETCH; ++q) n_rf[q] = 0;
#pragma unroll
    for (int q = 0; q <= LP; ++q) {
      const int x = i0 + q * nt + tid;
      n_rf[q >> 2] |= onehot(x < rw ? rf[x] : 9) << (8 * (q & 3));
    }
  };
  auto stage = [&]() {
    if (tid < RC) s_rd[tid] = n_rd * 0x11111111u;
#pragma unroll
    for (int q = 0; q <= LP; ++q)
      s_rf[q * nt + tid] = (uint8_t)(n_rf[q >> 2] >> (8 * (q & 3)));
  };
  fetch(0);
  stage();
  // slot addresses: this warp's, the next warp's, lane l's warp's
  const unsigned slots = smem_reg(s_slot);
  const unsigned a_g = slots + 4 * g, a_g1 = a_g + 4, a_l = slots + 4 * lane;
  // the state of row -1 (parity 1)
  if (lane == 0) {
    st_slot<SLOT_PARITY + SLOT_H0>(a_g, h[0]);
    st_slot<SLOT_PARITY + SLOT_F0>(a_g, f[0]);
  }
  if (lane == 31) st_slot<SLOT_PARITY + SLOT_HT>(a_g, h[LP - 1]);
  __syncthreads();

  // the reference codes of this thread's lanes in the current row: lane j
  // in nibble j & 7 of word j >> 3
  uint32_t win[NWIN];

  // one row; VALID: i < len
  auto row = [&](int r, int i, auto valid_tag) {
    constexpr bool VALID = decltype(valid_tag)::value;
    const unsigned po = (i & 1) * SLOT_PARITY, qo = SLOT_PARITY - po;
    const uint32_t rcm = s_rd[r];

    float hu[LP], fu[LP];
#pragma unroll
    for (int j = 0; j + 1 < LP; ++j) {
      hu[j] = h[j + 1];
      fu[j] = f[j + 1];
    }
    const float hn = __shfl_down_sync(FULL, h[0], 1);
    const float fn = __shfl_down_sync(FULL, f[0], 1);
    // lane 31's top lane is finished after the barrier
    hu[LP - 1] = edge ? NEGF : hn;
    fu[LP - 1] = edge ? NEGF : fn;

    float hg[LP], fc[LP], hd[LP], hne[LP], pre[LP];
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      const bool hit = (win[j >> 3] & rcm & (0xfu << (4 * (j & 7)))) != 0u;
      const float sub = hit ? match_r : mismatch_r;
      hg[j] = __fadd_rn(hu[j], go);
      fc[j] = fmaxf(hg[j], __fadd_rn(fu[j], ge));
      hd[j] = __fadd_rn(h[j], sub);
      hne[j] = fmaxf(fmaxf(hd[j], fc[j]), 0.f);
      const float a = __fsub_rn(hne[j], gek[j]);
      pre[j] = j ? fmaxf(pre[j - 1], a) : a;
    }
    // the next row's window: shift in the code of lane LP
    {
      const uint32_t nib = s_rf[r + k0 + LP];
#pragma unroll
      for (int u = 0; u + 1 < NWIN; ++u)
        win[u] = __funnelshift_r(win[u], win[u + 1], 4);
      if constexpr (LP >= 8)
        win[NWIN - 1] = __funnelshift_r(win[NWIN - 1], nib, 4);
      else
        win[0] = (win[0] >> 4) | (nib << (4 * (LP - 1)));
    }
    // the warp scan without the top lane
    float incl = lane == 31 ? pre[LP - 2] : pre[LP - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      incl = fmaxf(incl, __shfl_up_sync(FULL, incl, o));
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEGF;
    if (lane == 31) st_slot<SLOT_T>(a_g + po, incl);
    __syncthreads();

    if (lane == 31 && !edge) {  // the next warp's lane 0, previous row
      hu[LP - 1] = ld_slot<SLOT_H0>(a_g1 + qo);
      fu[LP - 1] = ld_slot<SLOT_F0>(a_g1 + qo);
      hg[LP - 1] = __fadd_rn(hu[LP - 1], go);
      fc[LP - 1] = fmaxf(hg[LP - 1], __fadd_rn(fu[LP - 1], ge));
      hne[LP - 1] = fmaxf(fmaxf(hd[LP - 1], fc[LP - 1]), 0.f);
    }
    // the prefix over the warps below: lane l rebuilds warp l's top lane
    float hx = NEGF;
    int ax = ordered(NEGF);
    if (lane < g) {
      const float sub = s_rf[r + ktop] & rcm ? match_r : mismatch_r;
      const unsigned aq = a_l + qo;
      const float hd_x = __fadd_rn(ld_slot<SLOT_HT>(aq), sub);
      const float fc_x = fmaxf(__fadd_rn(ld_slot<SLOT_H0 + 4>(aq), go),
                               __fadd_rn(ld_slot<SLOT_F0 + 4>(aq), ge));
      hx = fmaxf(fmaxf(hd_x, fc_x), 0.f);
      ax = ordered(fmaxf(ld_slot<SLOT_T>(a_l + po),
                         __fsub_rn(hx, gek_top)));
    }
    excl = fmaxf(excl, unordered(__reduce_max_sync(FULL, ax)));
    const float left = __shfl_sync(FULL, hx, g > 0 ? g - 1 : 0);
    float hn_left = __shfl_up_sync(FULL, hne[LP - 1], 1);  // Hnoe[k0-1]
    if (lane == 0) hn_left = g > 0 ? left : NEGF;

    uint32_t wd[(LP + 3) / 4] = {};
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      const float cm = j ? fmaxf(excl, pre[j - 1]) : excl;
      const float e_cur = __fadd_rn(e_base[j], cm);
      const float h_cur = VALID ? fmaxf(hne[j], e_cur) : 0.f;
      const float f_cur = VALID ? fc[j] : NEGF;
      const float hp = j ? hne[j - 1] : hn_left;
      // selects, not branches (see banded_sw_kernel's note)
      const uint32_t s3 = f_cur >= hd[j] ? 3u : 1u;
      const uint32_t s2 = e_cur >= hne[j] ? 2u : s3;
      const uint32_t src = h_cur <= 0.f ? 0u : s2;
      const uint32_t e_ext =
          e_cur > __fadd_rn(__fadd_rn(hp, go), 1e-4f) ? 4u : 0u;
      const uint32_t f_ext = f_cur > __fadd_rn(hg[j], 1e-4f) ? 8u : 0u;
      wd[j >> 2] |= (src | e_ext | f_ext) << (8 * (j & 3));
      h[j] = h_cur;
      f[j] = f_cur;
    }
    if (wwarp) {  // lane W reads NEG at k+1 below it
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j >= past0) {
          h[j] = NEGF;
          f[j] = NEGF;
        }
      }
    }
    if constexpr (VALID) {  // rows past len hold H = 0 and raise nothing
      float mx[LP];
#pragma unroll
      for (int j = 0; j < LP; ++j) mx[j] = h[j];
#pragma unroll
      for (int s = 1; s < LP; s <<= 1)
#pragma unroll
        for (int j = 0; j + s < LP; j += 2 * s) mx[j] = fmaxf(mx[j], mx[j + s]);
      if (mx[0] > tv) {  // a row that raises this thread's best
        tv = mx[0];
        tr = i;
        int kj = 0;
#pragma unroll
        for (int j = LP - 1; j >= 0; --j)
          if (h[j] == tv) kj = j;
        tj = kj;
      }
    }
    if (live) store_row<LP>(trow, wd);
    trow += pitch;
    if (lane == 0) {
      st_slot<SLOT_H0>(a_g + po, h[0]);
      st_slot<SLOT_F0>(a_g + po, f[0]);
    }
    if (lane == 31) st_slot<SLOT_HT>(a_g + po, h[LP - 1]);
  };

  for (int i0 = 0; i0 < m; i0 += RC) {
    const bool more = i0 + RC < m;
    if (more) fetch(i0 + RC);
    const int rows = min(RC, m - i0);
    const int below = min(max(len - i0, 0), rows);  // rows i < len
#pragma unroll
    for (int u = 0; u < NWIN; ++u) win[u] = 0;
#pragma unroll
    for (int j = 0; j < LP; ++j)
      win[j >> 3] |= (uint32_t)s_rf[k0 + j] << (4 * (j & 7));
    for (int r = 0; r < below; ++r) row(r, i0 + r, std::true_type{});
    for (int r = below; r < rows; ++r) row(r, i0 + r, std::false_type{});
    __syncthreads();  // every thread is done with this chunk's codes
    if (more) stage();
    __syncthreads();
  }

  float v = live ? tv : -1.f;
  int row_b = live ? tr : 0x7fffffff;
  int kk = live ? k0 + tj : 0x7fffffff;
  auto reduce = [&]() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_down_sync(FULL, v, o);
      const int r2 = __shfl_down_sync(FULL, row_b, o);
      const int k2 = __shfl_down_sync(FULL, kk, o);
      if (v2 > v || (v2 == v && (r2 < row_b || (r2 == row_b && k2 < kk)))) {
        v = v2;
        row_b = r2;
        kk = k2;
      }
    }
  };
  reduce();
  if (lane == 0) {
    s_bv[g] = v;
    s_br[g] = row_b;
    s_bk[g] = kk;
  }
  __syncthreads();
  if (g == 0) {
    v = lane < nw ? s_bv[lane] : -1.f;
    row_b = lane < nw ? s_br[lane] : 0x7fffffff;
    kk = lane < nw ? s_bk[lane] : 0x7fffffff;
    reduce();
    if (lane == 0) {
      best_out[b] = v;
      bi_out[b] = row_b;
      bk_out[b] = kk;
    }
  }
}

// Launch plans of the wide kernel by band width and batch: the first row
// whose max_w is >= W, and of it the plan for a batch that fills the card
// (bsz >= FULL_BATCH reads) or the one for a batch that does not.  A block
// holds ceil(W / (32 lp)) warps; maxt bounds its threads and minb asks the
// compiler for registers enough to keep minb blocks an SM.  The fastest
// plan of kernels/k1_plans.py --batches at each (W, B) it timed (PERF.md,
// K1's row).  nanomod_tpu_torch/resquiggle/banded_kernel.py WIDE_PLANS and
// FULL_BATCH are the same table (tests/test_torch_wideplan.py holds them
// equal).
struct Launch {
  int lp, maxt, minb;
};
struct WidePlan {
  int max_w;
  Launch part, full;
};
constexpr int FULL_BATCH = 132;  // a block for each of the H100's 132 SMs
constexpr WidePlan WIDE_PLANS[] = {
    {384, {2, 1024, 1}, {2, 1024, 1}},
    {449, {4, 512, 1}, {4, 512, 1}},
    {512, {4, 512, 1}, {8, 512, 1}},
    {513, {2, 1024, 1}, {4, 512, 1}},
    {768, {4, 512, 1}, {4, 512, 1}},
    {896, {4, 512, 1}, {8, 512, 1}},
    {1024, {8, 512, 1}, {8, 512, 1}},
    {1152, {4, 512, 1}, {4, 512, 1}},
    {1536, {4, 512, 1}, {8, 512, 1}},
    {2048, {8, 512, 1}, {16, 256, 1}},
    {3072, {8, 512, 1}, {8, 512, 1}},
    {4096, {16, 256, 1}, {16, 512, 1}},
    {8192, {16, 512, 1}, {16, 512, 1}},
    {16384, {16, 1024, 1}, {16, 1024, 1}},
    {32768, {32, 1024, 1}, {32, 1024, 1}},
};

template <int LP, int MAXT, int MINB>
int launch_wide(const void* read, const void* ref, const void* lens,
                void* tb, void* best, void* bi, void* bk, int bsz, int m,
                int w, int pitch, float match, float mismatch, float go,
                float ge, cudaStream_t stream) {
  const int nt = 32 * ((w + 32 * LP - 1) / (32 * LP));
  if (nt > MAXT) return (int)cudaErrorInvalidConfiguration;
  banded_sw_wide_kernel<LP, MAXT, MINB><<<bsz, nt, (LP + 1) * nt, stream>>>(
      (const uint8_t*)read, (const uint8_t*)ref, (const int32_t*)lens,
      (uint8_t*)tb, (float*)best, (int32_t*)bi, (int32_t*)bk, m, w, match,
      mismatch, go, ge, pitch);
  return (int)cudaGetLastError();
}

// the plan for (w, bsz): of WIDE_PLANS' first row whose max_w is >= w,
// the full batch's plan from FULL_BATCH reads, else the part batch's
template <int I>
int launch_planned(const void* read, const void* ref, const void* lens,
                   void* tb, void* best, void* bi, void* bk, int bsz, int m,
                   int w, int pitch, float match, float mismatch, float go,
                   float ge, cudaStream_t stream) {
  constexpr WidePlan P = WIDE_PLANS[I];
  constexpr int N = sizeof(WIDE_PLANS) / sizeof(WIDE_PLANS[0]);
  if constexpr (I + 1 < N) {
    if (w > P.max_w)
      return launch_planned<I + 1>(read, ref, lens, tb, best, bi, bk, bsz,
                                   m, w, pitch, match, mismatch, go, ge,
                                   stream);
  }
  if (bsz >= FULL_BATCH)
    return launch_wide<P.full.lp, P.full.maxt, P.full.minb>(
        read, ref, lens, tb, best, bi, bk, bsz, m, w, pitch, match, mismatch,
        go, ge, stream);
  return launch_wide<P.part.lp, P.part.maxt, P.part.minb>(
      read, ref, lens, tb, best, bi, bk, bsz, m, w, pitch, match, mismatch,
      go, ge, stream);
}

// The narrow kernel, one warp a read, for w in [1, MAXW] (MAXW <= 1024):
// LP, the band lanes a thread, is w / 32 rounded up to a power of two.
// Only the LPs that MAXW needs are instantiated.
template <int MAXW>
int launch_narrow(const void* read, const void* ref, const void* lens,
                  void* tb, void* best, void* bi, void* bk, int bsz, int m,
                  int w, int pitch, float match, float mismatch, float go,
                  float ge, cudaStream_t stream) {
  static_assert(MAXW <= 1024, "one warp holds at most 32 lanes a thread");
  if (w > MAXW) return (int)cudaErrorInvalidValue;
  const int l = (w + 31) / 32;  // band lanes a thread must hold
#define NM_LAUNCH(LP)                                                     \
  return launch<LP>(read, ref, lens, tb, best, bi, bk, bsz, m, w, pitch, \
                    match, mismatch, go, ge, stream)
  if (l <= 1) NM_LAUNCH(1);
  if (l <= 2) NM_LAUNCH(2);
  if (l <= 4) NM_LAUNCH(4);
  if (l <= 8) NM_LAUNCH(8);
  if constexpr (MAXW > 256) {
    if (l <= 16) NM_LAUNCH(16);
  }
  if constexpr (MAXW > 512) NM_LAUNCH(32);
#undef NM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// w in [1, 32768]; pitch: tb's row stride in bytes, w rounded up to a
// multiple of 32 (the wrapper checks both)
extern "C" int nm_banded_sw(const void* read, const void* ref,
                            const void* lens, void* tb, void* best, void* bi,
                            void* bk, int bsz, int m, int w, int pitch,
                            float match, float mismatch, float go, float ge,
                            void* stream) {
  if (bsz <= 0 || m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (w > NARROW_MAX_W) {
    if (w > WIDE_MAX_W) return (int)cudaErrorInvalidValue;
    return launch_planned<0>(read, ref, lens, tb, best, bi, bk, bsz, m, w,
                             pitch, match, mismatch, go, ge, st);
  }
  return launch_narrow<NARROW_MAX_W>(read, ref, lens, tb, best, bi, bk, bsz,
                                     m, w, pitch, match, mismatch, go, ge,
                                     st);
}

extern "C" const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
