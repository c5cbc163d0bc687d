// K2: traceback walk of every read's banded-DP matrix, on the card, with
// the op codes packed four a byte.
//
// Replaces nanomod_tpu/resquiggle/banded.py walk_device (a lax.scan over
// 2M+W steps, vectorised over the batch) and the pack_codes2 after it, so
// that only the packed op codes, not the [B,M,W] traceback matrix, cross
// to the host.  Output is [B, (2M+W)/4] u8, byte-equal to
// pack_codes2(walk_device): step s's code (0 stop, 1 M, 2 I, 3 D, in walk
// (3'->5') order) is bits 2(s%4)..2(s%4)+1 of byte s/4.
//
// What bounds it: the walk is a chain of dependent steps, each a load at an
// address the previous step chose, so a read is latency bound; the bytes
// (the tb rows the walk visits, read once, and the codes) are a few
// microseconds of device-memory time for a batch.  The design shortens the
// chain of one step:
//
//  * One warp a read (one warp a block, so B reads spread over the SMs).
//    The warp copies tiles of ROWS = TILE_BYTES / W rows of its read's tb
//    into shared memory with 16-byte cp.async (rows are W bytes, W a
//    multiple of 32, so every tile is 16-byte aligned), two buffers: the
//    walk's row never increases (M and I steps take i-1, D stays in the
//    row), so while lane 0 walks one tile the tile of the rows just
//    before it (the next rows the walk reaches) is in flight, and each
//    tile is read once.
//  * A step is a table lookup: the automaton state selects a 64-bit table
//    whose 4-bit entry for the cell's tb nibble holds the code and the next
//    state.  Inside the matrix the reference's clamps of (i, k) are
//    identities, so lane 0 tracks the cell's shared-memory address; a
//    start cell outside the matrix (which K1 never gives) takes the
//    reference's clamped step until the walk is inside or done.
//  * Look-ahead: the three cells a step can reach (M: a - w, I: a - w + 1,
//    D: a - 1) are loaded one step early into one word, and the step picks
//    its byte with a byte permute, so no shared-memory load waits on the
//    step's decode.  They lie at most W bytes below the current tile: in a
//    guard below the first buffer, or in the other buffer.
//  * Lane 0 packs the codes four a byte into a shared ring; the warp
//    writes the complete bytes out in coalesced stores whenever lane 0
//    leaves its loop (a tile ends, the ring fills, the walk ends), and the
//    whole warp writes the zero tail after the walk.  The shared addresses
//    stay in registers (see opaque_smem).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_BYTES = 8192;
constexpr int CODE_BYTES = 512;  // a power of two: a ring
constexpr int GUARD = 1024;      // >= the widest band

// step table of automaton state st: entry x (the tb nibble) holds
// code (bits 0-1: 0 stop, 1 M, 2 I, 3 D) | next state (bits 2-3)
__host__ __device__ constexpr uint64_t step_table(int st) {
  uint64_t t = 0;
  for (int x = 0; x < 16; ++x) {
    const int src = x & 3, e_ext = (x >> 2) & 1, f_ext = (x >> 3) & 1;
    int e = 0;
    if (st == 1 || (st == 0 && src == 2)) e = 3 | (e_ext << 2);       // D
    else if (st == 2 || (st == 0 && src == 3)) e = 2 | (f_ext << 3);  // I
    else if (src == 1) e = 1;                                          // M
    else e = 0;                                                        // stop
    t |= (uint64_t)e << (4 * x);
  }
  return t;
}
constexpr uint64_t T0 = step_table(0), T1 = step_table(1), T2 = step_table(2);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a shared-memory address held in a register: without this the compiler
// rebuilds it inside the step loop (a read of the block's shared window
// base on the chain of every step)
__device__ __forceinline__ unsigned opaque_smem(const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("mov.b32 %0, %0;" : "+r"(a));
  return a;
}
__device__ __forceinline__ unsigned lds_u8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_u8(unsigned a, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* t,
                                          int lo, int hi, int w, int lane) {
  const int n16 = lo >= 0 && hi > lo ? (hi - lo) * w / 16 : 0;
  const uint8_t* src = t + (size_t)lo * w;
  for (int q = lane; q < n16; q += 32) cp_async16(dst + 16 * q, src + 16 * q);
  cp_async_commit();
}

__global__ void __launch_bounds__(32)
    walk_packed_kernel(const uint8_t* __restrict__ tb,
                       const int32_t* __restrict__ best_i,
                       const int32_t* __restrict__ best_k,
                       uint8_t* __restrict__ out, int m, int w) {
  // GUARD bytes below the two tiles: the look-ahead loads reach w <= 1024
  // bytes below the current tile
  __shared__ __align__(16) uint8_t smem[GUARD + 2 * TILE_BYTES];
  auto tile_at = [&](int q) { return smem + GUARD + q * TILE_BYTES; };
  __shared__ uint8_t cbuf[CODE_BYTES];

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int rows = TILE_BYTES / w;
  const int steps = 2 * m + w;
  const int nbytes = steps / 4;
  const uint8_t* t = tb + (size_t)b * m * w;
  uint8_t* o = out + (size_t)b * nbytes;
  const unsigned cb = opaque_smem(cbuf);
  const unsigned tb0 = opaque_smem(tile_at(0));

  int i = best_i[b];
  int k = best_k[b];
  int st = 0;
  bool done = false;
  uint32_t cur = 0;

  int ti = min(max(i, 0), m - 1) / rows;
  int buf = 0;
  load_tile(tile_at(0), t, ti * rows, min(ti * rows + rows, m), w, lane);
  load_tile(tile_at(1), t, (ti - 1) * rows, ti * rows, w, lane);
  cp_async_wait<1>();
  __syncwarp();

  int s = 0;
  int flushed = 0;
  while (true) {
    int next_tile = 0;
    if (lane == 0) {
      const unsigned tile = tb0 + buf * TILE_BYTES;
      const int lo = ti * rows;
      const int s_stop = min(steps, 4 * (flushed + CODE_BYTES));
      // (i, k) outside the matrix (never after K1): the reference's
      // clamped step.  Its loads stay in the first tile.
      while (s < s_stop && !done &&
             ((unsigned)i >= (unsigned)m || (unsigned)k >= (unsigned)w)) {
        const int ii = min(max(i, 0), m - 1);
        const int kk = min(max(k, 0), w - 1);
        const int x = lds_u8(tile + (ii - lo) * w + kk);
        const uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
        const int code = e & 3;
        st = e >> 2;
        cur = (cur >> 2) | ((unsigned)code << 6);
        sts_u8(cb + ((s >> 2) & (CODE_BYTES - 1)), cur);
        ++s;
        i -= code == 1 || code == 2;
        k += (code == 2) - (code == 3);
        done = code == 0 || i < 0 || k < 0 || k >= w;
      }
      if (!done && s < s_stop && i >= lo) {
        // inside the matrix the clamps are identities: track the cell's
        // address in the tile, and load the three cells a step can reach
        // (M: a - w, I: a - w + 1, D: a - 1) one step ahead, so that the
        // next cell's code is a select, not a load, on the chain.  They
        // lie at most w bytes below the tile: the guard or the other tile.
        const int wm1 = w - 1;
        unsigned a = tile + (i - lo) * w + k;
        uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        int x = lds_u8(a);
        // the three candidates in one word (bytes 0, 1, 2: M, I, D), so
        // that all three loads are issued before the step that picks one
        unsigned xx = lds_u8(a - w) | (lds_u8(a - wm1) << 8)
                      | (lds_u8(a - 1) << 16);
        while (true) {
          const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
          const int code = e & 3;
          const int nst = e >> 2;
          const bool mv_m = code == 1, mv_i = code == 2;
          a -= mv_m ? w : (mv_i ? wm1 : 1);
          x = (int)__byte_perm(xx, 0u, code + 0x443F);  // byte code-1
          tt = nst == 0 ? T0 : (nst == 1 ? T1 : T2);
          i -= mv_m || mv_i;
          k += (int)mv_i - (code == 3);
          cur = (cur >> 2) | ((unsigned)code << 6);
          sts_u8(cb + ((s >> 2) & (CODE_BYTES - 1)), cur);
          ++s;
          st = nst;
          done = code == 0 || i < 0 || k < 0 || k >= w;
          if (done || i < lo || s >= s_stop) {
            next_tile = !done && i < lo;
            break;
          }
          xx = lds_u8(a - w) | (lds_u8(a - wm1) << 8) | (lds_u8(a - 1) << 16);
        }
      } else if (!done && s < s_stop) {
        next_tile = 1;  // i < lo: the walk is in the tile below
      }
    }
    s = __shfl_sync(FULL, s, 0);
    const bool end = __shfl_sync(FULL, (int)(done || s >= steps), 0);
    next_tile = __shfl_sync(FULL, next_tile, 0);
    const int full = s >> 2;
    __syncwarp();
    for (int q = flushed + lane; q < full; q += 32)
      o[q] = cbuf[q & (CODE_BYTES - 1)];
    flushed = full;
    __syncwarp();
    if (end) break;
    if (next_tile) {
      cp_async_wait<0>();
      __syncwarp();
      --ti;
      buf ^= 1;
      load_tile(tile_at(buf ^ 1), t, (ti - 1) * rows, ti * rows, w, lane);
    }
  }
  cp_async_wait<0>();
  if (s & 3) {
    if (lane == 0) o[flushed] = (uint8_t)(cur >> (2 * (4 - (s & 3))));
    ++flushed;
  }
  for (int q = flushed + lane; q < nbytes; q += 32) o[q] = 0;
}

}  // namespace

extern "C" int nm_walk_packed(const void* tb, const void* bi, const void* bk,
                              void* codes, int bsz, int m, int w,
                              void* stream) {
  if (bsz <= 0) return 0;
  walk_packed_kernel<<<bsz, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int32_t*)bi, (const int32_t*)bk,
      (uint8_t*)codes, m, w);
  return (int)cudaGetLastError();
}
