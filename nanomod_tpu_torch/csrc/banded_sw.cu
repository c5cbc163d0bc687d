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
//    of two; lanes k >= W are computed and dropped).  The k+1 neighbour
//    of a lane is in the same thread except for the thread's last lane,
//    which takes the next thread's first by one __shfl_down_sync.
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
//  * Each thread stores its LP tb bytes of a row as one word: W coalesced
//    bytes a row per warp into the [B, M, W] u8 layout that K2 reads.
//
// Rounding: at NEG = -1e9 the spacing of f32 is 64, so NEG + go rounds back
// to NEG; those values feed the extend bits at the band edges.  Every add
// is __fadd_rn (and the library is built with --fmad=false) in the
// reference's order of operations, so the bits match exactly.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int LP>
__global__ void __launch_bounds__(32 * WARPS)
    banded_sw_kernel(const uint8_t* __restrict__ read,
                     const uint8_t* __restrict__ ref,
                     const int32_t* __restrict__ lens,
                     uint8_t* __restrict__ tb, float* __restrict__ best_out,
                     int32_t* __restrict__ bi_out,
                     int32_t* __restrict__ bk_out, int bsz, int m, int w,
                     float match, float mismatch, float go, float ge) {
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
  uint8_t* tbb = tb + (size_t)b * m * w;
  const int len = lens[b];
  const int k0 = lane * LP;
  const bool live = k0 < w;        // w is a multiple of LP: whole threads
  const bool edge = k0 + LP >= w;  // last lane's k+1 is off the band
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
    h[j] = 0.f;
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
    if (live && ip >= 0) store_row<LP>(tbb + (size_t)ip * w + k0, wd);
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

template <int LP>
int launch(const void* read, const void* ref, const void* lens, void* tb,
           void* best, void* bi, void* bk, int bsz, int m, int w, float match,
           float mismatch, float go, float ge, cudaStream_t stream) {
  const int blocks = (bsz + WARPS - 1) / WARPS;
  banded_sw_kernel<LP><<<blocks, 32 * WARPS, 0, stream>>>(
      (const uint8_t*)read, (const uint8_t*)ref, (const int32_t*)lens,
      (uint8_t*)tb, (float*)best, (int32_t*)bi, (int32_t*)bk, bsz, m, w,
      match, mismatch, go, ge);
  return (int)cudaGetLastError();
}

}  // namespace

// w: a multiple of 32 in [32, 1024] (the wrapper checks it)
extern "C" int nm_banded_sw(const void* read, const void* ref,
                            const void* lens, void* tb, void* best, void* bi,
                            void* bk, int bsz, int m, int w, float match,
                            float mismatch, float go, float ge,
                            void* stream) {
  if (bsz <= 0 || m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int l = w / 32;  // band lanes a thread holds
  if (l <= 1)
    return launch<1>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                     mismatch, go, ge, st);
  if (l <= 2)
    return launch<2>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                     mismatch, go, ge, st);
  if (l <= 4)
    return launch<4>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                     mismatch, go, ge, st);
  if (l <= 8)
    return launch<8>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                     mismatch, go, ge, st);
  if (l <= 16)
    return launch<16>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                      mismatch, go, ge, st);
  return launch<32>(read, ref, lens, tb, best, bi, bk, bsz, m, w, match,
                    mismatch, go, ge, st);
}

extern "C" const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
