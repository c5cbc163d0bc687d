// K2: traceback walk of every read's banded-DP matrix, on the card, with
// the op codes packed four a byte or, where the step count is not a
// multiple of 4, one a byte.
//
// Replaces nanomod_tpu/resquiggle/banded.py walk_device (a lax.scan over
// 2M+W steps, vectorised over the batch) and the pack_codes2 after it, so
// that only the op codes, not the [B,M,W] traceback matrix, cross to the
// host.  Step s's code is 0 stop, 1 M, 2 I, 3 D, in walk (3'->5') order.
// Packed (the reference's mode "codes2", 2M+W a multiple of 4): output
// [B, (2M+W)/4] u8, byte-equal to pack_codes2(walk_device), step s in bits
// 2(s%4)..2(s%4)+1 of byte s/4.  Unpacked (mode "codes", any 2M+W): output
// [B, 2M+W] u8, byte-equal to walk_device.
//
// What bounds it: the walk is a chain of dependent steps, each a load at an
// address the previous step chose, so a read is latency bound; the bytes
// (the tb rows the walk visits, read once, and the codes) are a few
// microseconds of device-memory time for a batch.  The design shortens the
// chain of one step:
//
//  * One warp a read (one warp a block, so B reads spread over the SMs).
//    tb comes with a row pitch P >= W, a multiple of 16 bytes (K1 writes
//    rows padded to a multiple of 32; the wrapper copies any other tb into
//    such rows), so that any W takes the same path.  The warp copies tiles
//    of ROWS = TILE_BYTES / P rows of its read's tb into shared memory with
//    16-byte cp.async (every tile is 16-byte aligned), two buffers: the
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
//  * Look-ahead: the three cells a step can reach (M: a - P, I: a - P + 1,
//    D: a - 1) are loaded one step early into one word, and the step picks
//    its byte with a byte permute, so no shared-memory load waits on the
//    step's decode.  They lie at most P bytes below the current tile: in a
//    guard below the first buffer, or in the other buffer.  (Cells in the
//    padding or in the row below the tile are loaded but never used: a
//    step onto them leaves the band or the tile, and the walk then stops
//    or reloads.)
//  * Lane 0 writes the codes (packed: four a byte) into a shared ring; the
//    warp writes the complete bytes out in coalesced stores whenever lane
//    0 leaves its loop (a tile ends, the ring fills, the walk ends), and
//    the whole warp writes the zero tail after the walk.  The shared
//    addresses stay in registers (see opaque_smem).
//  * A pitch above 1024 bytes (W > 1024) takes walk_wide_kernel, which
//    stages a window of columns around the walk instead of whole rows.
//  * With the DP's best scores given, each output row starts with the DP
//    batch's 12-byte header and the codes follow at byte 12: the layout of
//    pack_outputs (nanomod_tpu/resquiggle/banded.py:151), which the host
//    fetches in one copy.  The header is round-half-to-even(best), best_i
//    and best_k as little-endian int32, one byte a lane; it replaces
//    pack_outputs' six PyTorch operations (a launch each) on the card.  The
//    codes are written a byte at a time, so their offset costs nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_BYTES = 8192;
constexpr int CODE_BYTES = 512;  // a power of two: a ring
constexpr int GUARD = 1024;      // >= the widest row pitch

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
// the DP batch's 12-byte row header (see the note above), lanes 0-11
__device__ __forceinline__ void put_header(uint8_t* row, const float* best,
                                           int b, int bi, int bk, int lane) {
  if (lane < 12) {
    const int v = lane < 4 ? __float2int_rn(best[b]) : (lane < 8 ? bi : bk);
    row[lane] = (uint8_t)(v >> (8 * (lane & 3)));
  }
}
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* t,
                                          int lo, int hi, int p, int lane) {
  const int n16 = lo >= 0 && hi > lo ? (hi - lo) * p / 16 : 0;
  const uint8_t* src = t + (size_t)lo * p;
  for (int q = lane; q < n16; q += 32) cp_async16(dst + 16 * q, src + 16 * q);
  cp_async_commit();
}

// PACKED: four codes a byte (steps % 4 == 0); else one code a byte
template <bool PACKED>
__global__ void __launch_bounds__(32)
    walk_kernel(const uint8_t* __restrict__ tb,
                const int32_t* __restrict__ best_i,
                const int32_t* __restrict__ best_k,
                const float* __restrict__ best, uint8_t* __restrict__ out,
                int m, int w, int p, int hdr) {
  // GUARD bytes below the two tiles: the look-ahead loads reach p <= 1024
  // bytes below the current tile
  __shared__ __align__(16) uint8_t smem[GUARD + 2 * TILE_BYTES];
  auto tile_at = [&](int q) { return smem + GUARD + q * TILE_BYTES; };
  __shared__ uint8_t cbuf[CODE_BYTES];
  constexpr int PER = PACKED ? 4 : 1;  // codes a byte
  constexpr int SH = PACKED ? 2 : 0;   // log2(PER)

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int rows = TILE_BYTES / p;
  const int steps = 2 * m + w;
  const int nbytes = steps / PER;
  const uint8_t* t = tb + (size_t)b * m * p;
  uint8_t* o = out + (size_t)b * (hdr + nbytes) + hdr;
  const unsigned cb = opaque_smem(cbuf);
  const unsigned tb0 = opaque_smem(tile_at(0));

  int i = best_i[b];
  int k = best_k[b];
  if (hdr) put_header(o - hdr, best, b, i, k, lane);
  int st = 0;
  bool done = false;
  uint32_t cur = 0;
  // record step s's code (packed: into the byte being filled)
  auto put = [&](int s, int code) {
    if constexpr (PACKED) {
      cur = (cur >> 2) | ((unsigned)code << 6);
      sts_u8(cb + ((s >> 2) & (CODE_BYTES - 1)), cur);
    } else {
      sts_u8(cb + (s & (CODE_BYTES - 1)), (unsigned)code);
    }
  };

  int ti = min(max(i, 0), m - 1) / rows;
  int buf = 0;
  load_tile(tile_at(0), t, ti * rows, min(ti * rows + rows, m), p, lane);
  load_tile(tile_at(1), t, (ti - 1) * rows, ti * rows, p, lane);
  cp_async_wait<1>();
  __syncwarp();

  int s = 0;
  int flushed = 0;
  while (true) {
    int next_tile = 0;
    if (lane == 0) {
      const unsigned tile = tb0 + buf * TILE_BYTES;
      const int lo = ti * rows;
      const int s_stop = min(steps, PER * (flushed + CODE_BYTES));
      // (i, k) outside the matrix (never after K1): the reference's
      // clamped step.  Its loads stay in the first tile.
      while (s < s_stop && !done &&
             ((unsigned)i >= (unsigned)m || (unsigned)k >= (unsigned)w)) {
        const int ii = min(max(i, 0), m - 1);
        const int kk = min(max(k, 0), w - 1);
        const int x = lds_u8(tile + (ii - lo) * p + kk);
        const uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
        const int code = e & 3;
        st = e >> 2;
        put(s, code);
        ++s;
        i -= code == 1 || code == 2;
        k += (code == 2) - (code == 3);
        done = code == 0 || i < 0 || k < 0 || k >= w;
      }
      if (!done && s < s_stop && i >= lo) {
        // inside the matrix the clamps are identities: track the cell's
        // address in the tile, and load the three cells a step can reach
        // (M: a - p, I: a - p + 1, D: a - 1) one step ahead, so that the
        // next cell's code is a select, not a load, on the chain.  They
        // lie at most p bytes below the tile: the guard or the other tile.
        const int pm1 = p - 1;
        unsigned a = tile + (i - lo) * p + k;
        uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        int x = lds_u8(a);
        // the three candidates in one word (bytes 0, 1, 2: M, I, D), so
        // that all three loads are issued before the step that picks one
        unsigned xx = lds_u8(a - p) | (lds_u8(a - pm1) << 8)
                      | (lds_u8(a - 1) << 16);
        while (true) {
          const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
          const int code = e & 3;
          const int nst = e >> 2;
          const bool mv_m = code == 1, mv_i = code == 2;
          a -= mv_m ? p : (mv_i ? pm1 : 1);
          x = (int)__byte_perm(xx, 0u, code + 0x443F);  // byte code-1
          tt = nst == 0 ? T0 : (nst == 1 ? T1 : T2);
          i -= mv_m || mv_i;
          k += (int)mv_i - (code == 3);
          put(s, code);
          ++s;
          st = nst;
          done = code == 0 || i < 0 || k < 0 || k >= w;
          if (done || i < lo || s >= s_stop) {
            next_tile = !done && i < lo;
            break;
          }
          xx = lds_u8(a - p) | (lds_u8(a - pm1) << 8) | (lds_u8(a - 1) << 16);
        }
      } else if (!done && s < s_stop) {
        next_tile = 1;  // i < lo: the walk is in the tile below
      }
    }
    s = __shfl_sync(FULL, s, 0);
    const bool end = __shfl_sync(FULL, (int)(done || s >= steps), 0);
    next_tile = __shfl_sync(FULL, next_tile, 0);
    const int full = s >> SH;
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
      load_tile(tile_at(buf ^ 1), t, (ti - 1) * rows, ti * rows, p, lane);
    }
  }
  cp_async_wait<0>();
  if constexpr (PACKED) {
    if (s & 3) {
      if (lane == 0) o[flushed] = (uint8_t)(cur >> (2 * (4 - (s & 3))));
      ++flushed;
    }
  }
  for (int q = flushed + lane; q < nbytes; q += 32) o[q] = 0;
}


// Pitch > 1024 (W > 1024): a tile of whole rows no longer fits, and a walk
// touches about one byte a step, mostly straight up (in band coordinates an
// M step keeps k; I and D move it by one).  So the warp stages windows of
// WR rows by WC columns around the walk and lane 0 walks inside them:
//
//  * Two windows in dynamic shared memory.  The walk's row never increases
//    and its column moves by at most one a step, so the window above the
//    current one (rows r0 - WR .. r0 - 2 WR + 1, WC columns around the
//    walk's k) is known well before the walk needs it: when the walk has
//    climbed WFETCH rows of a window, the warp starts that window's copy
//    (16-byte cp.async, one commit group) into the other slot and lane 0
//    walks on.  When the walk leaves by the top inside the fetched
//    columns, the warp waits for the group (long landed) and moves into
//    it.  Only a start, or a walk that leaves by a side (or by the top
//    outside the fetched columns), stages a window and waits for it.
//  * Windows of 128 x 128 bytes: an M 1024 walk changes window ~8 times
//    (32-row windows changed ~32 times, each a full trip to device memory
//    while lane 0 waited).
//  * Look-ahead, as walk_kernel's: the three cells the next step can reach
//    (M: a + WC, I: a + WC + 1, D: a - 1; a window's rows go up in shared
//    memory) are loaded one step early into one word.  Loads past a
//    window's edge land in the other window or in the guards around the
//    two and are never used: a step onto them leaves the window.
//  * The codes go out through the same shared ring as walk_kernel's.
constexpr int WR = 128;
constexpr int WC = 128;
constexpr int WIN = WR * WC;
constexpr int WFETCH = WR / 2;
constexpr int WLEAD = 16;       // below window 0: the D look-ahead
constexpr int WTAIL = WC + 16;  // above window 1: the M and I look-aheads
constexpr int WIDE_SMEM = WLEAD + 2 * WIN + WTAIL;

// the window's first column: 16-byte aligned, about WC / 2 left of k, the
// window inside the row's pitch (p >= WC)
__device__ __forceinline__ int window_col(int k, int p) {
  return min(max((k - WC / 2) & ~15, 0), p - WC);
}
// rows r0 .. r0 - WR + 1 (those >= 0) of read t from column c0 into dst,
// a row every WC bytes upward; one commit group
__device__ __forceinline__ void stage_window(uint8_t* dst, const uint8_t* t,
                                             int r0, int c0, int p,
                                             int lane) {
  constexpr int PER_ROW = WC / 16;
  const int n = min(WR, r0 + 1) * PER_ROW;
  for (int q = lane; q < n; q += 32)
    cp_async16(dst + 16 * q,
               t + (size_t)(r0 - q / PER_ROW) * p + c0 + 16 * (q % PER_ROW));
  cp_async_commit();
}

template <bool PACKED>
__global__ void __launch_bounds__(32)
    walk_wide_kernel(const uint8_t* __restrict__ tb,
                     const int32_t* __restrict__ best_i,
                     const int32_t* __restrict__ best_k,
                     const float* __restrict__ best,
                     uint8_t* __restrict__ out, int m, int w, int p,
                     int hdr) {
  extern __shared__ __align__(16) uint8_t ring[];  // WIDE_SMEM bytes
  __shared__ uint8_t cbuf[CODE_BYTES];
  constexpr int PER = PACKED ? 4 : 1;
  constexpr int SH = PACKED ? 2 : 0;

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int steps = 2 * m + w;
  const int nbytes = steps / PER;
  const uint8_t* t = tb + (size_t)b * m * p;
  uint8_t* o = out + (size_t)b * (hdr + nbytes) + hdr;
  const unsigned cb = opaque_smem(cbuf);
  const unsigned wb = opaque_smem(ring + WLEAD);  // window slot 0

  int i = best_i[b];
  int k = best_k[b];
  if (hdr) put_header(o - hdr, best, b, i, k, lane);
  int st = 0;
  bool done = false;
  uint32_t cur = 0;
  auto put = [&](int s, int code) {
    if constexpr (PACKED) {
      cur = (cur >> 2) | ((unsigned)code << 6);
      sts_u8(cb + ((s >> 2) & (CODE_BYTES - 1)), cur);
    } else {
      sts_u8(cb + (s & (CODE_BYTES - 1)), (unsigned)code);
    }
  };

  // the window: rows r0 .. r0 - WR + 1 from column c0, in slot `slot`
  // (r0 < 0: none yet); `ahead`: the window above it, from column c1, is
  // in the other slot or on its way
  int r0 = -1, c0 = 0, c1 = 0, slot = 0;
  bool ahead = false;
  int s = 0;
  int flushed = 0;
  while (true) {
    // what the warp does next: 0 flush the codes and go on, 1 fetch the
    // window above, 2 move into it, 3 stage a window around (i, k)
    int act = 0;
    if (lane == 0) {
      const int s_stop = min(steps, PER * (flushed + CODE_BYTES));
      // (i, k) outside the matrix (never after K1): the reference's
      // clamped step, read from device memory
      while (s < s_stop && !done &&
             ((unsigned)i >= (unsigned)m || (unsigned)k >= (unsigned)w)) {
        const int x =
            t[(size_t)min(max(i, 0), m - 1) * p + min(max(k, 0), w - 1)];
        const uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
        const int code = e & 3;
        st = e >> 2;
        put(s, code);
        ++s;
        i -= code == 1 || code == 2;
        k += (code == 2) - (code == 3);
        done = code == 0 || i < 0 || k < 0 || k >= w;
      }
      const int top = r0 - WR + 1;
      // lane 0 stops at the fetch row until the window above is fetched
      const int lim = ahead ? top : r0 - WFETCH + 1;
      if (!done && s < s_stop && i <= r0 && i >= lim &&
          (unsigned)(k - c0) < (unsigned)WC) {
        unsigned a = wb + slot * WIN + (r0 - i) * WC + (k - c0);
        uint64_t tt = st == 0 ? T0 : (st == 1 ? T1 : T2);
        int x = lds_u8(a);
        unsigned xx = lds_u8(a + WC) | (lds_u8(a + WC + 1) << 8)
                      | (lds_u8(a - 1) << 16);
        while (true) {
          const unsigned e = (unsigned)(tt >> (4 * x)) & 15u;
          const int code = e & 3;
          const int nst = e >> 2;
          const bool mv_m = code == 1, mv_i = code == 2;
          a += mv_m ? WC : (mv_i ? WC + 1 : -1);
          x = (int)__byte_perm(xx, 0u, code + 0x443F);  // byte code-1
          tt = nst == 0 ? T0 : (nst == 1 ? T1 : T2);
          i -= mv_m || mv_i;
          k += (int)mv_i - (code == 3);
          put(s, code);
          ++s;
          st = nst;
          done = code == 0 || i < 0 || k < 0 || k >= w;
          if (done || i < lim || (unsigned)(k - c0) >= (unsigned)WC ||
              s >= s_stop)
            break;
          xx = lds_u8(a + WC) | (lds_u8(a + WC + 1) << 8)
               | (lds_u8(a - 1) << 16);
        }
      }
      if (!done && s < s_stop) {
        if (i <= r0 && i >= top && (unsigned)(k - c0) < (unsigned)WC)
          act = 1;  // at the fetch row
        else if (ahead && i == top - 1 && (unsigned)(k - c1) < (unsigned)WC)
          act = 2;  // out by the top, into the fetched columns
        else
          act = 3;
      }
    }
    s = __shfl_sync(FULL, s, 0);
    const bool end = __shfl_sync(FULL, (int)(done || s >= steps), 0);
    act = __shfl_sync(FULL, act, 0);
    const int wi = __shfl_sync(FULL, i, 0);
    const int wk = __shfl_sync(FULL, k, 0);
    const int full = s >> SH;
    __syncwarp();
    for (int q = flushed + lane; q < full; q += 32)
      o[q] = cbuf[q & (CODE_BYTES - 1)];
    flushed = full;
    __syncwarp();
    if (end) break;
    if (act == 1) {
      c1 = window_col(wk, p);
      stage_window(ring + WLEAD + (slot ^ 1) * WIN, t, r0 - WR, c1, p, lane);
      ahead = true;
    } else if (act == 2) {
      cp_async_wait<0>();
      __syncwarp();
      slot ^= 1;
      r0 -= WR;
      c0 = c1;
      ahead = false;
    } else if (act == 3) {
      // the slot just left; a window above still in flight lands too
      r0 = wi;
      c0 = window_col(wk, p);
      ahead = false;
      stage_window(ring + WLEAD + slot * WIN, t, r0, c0, p, lane);
      cp_async_wait<0>();
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  if constexpr (PACKED) {
    if (s & 3) {
      if (lane == 0) o[flushed] = (uint8_t)(cur >> (2 * (4 - (s & 3))));
      ++flushed;
    }
  }
  for (int q = flushed + lane; q < nbytes; q += 32) o[q] = 0;
}

}  // namespace

// w in [1, 32768]; pitch: tb's row stride, a multiple of 16 in [w,
// 32768]; packed != 0: four codes a byte, 2m + w a multiple of 4 (the
// wrapper checks all three).  best: null, or the DP's [B] best scores,
// and then each row of out is the 12-byte header and the codes.  A pitch
// above GUARD walks in windows.
extern "C" int nm_walk(const void* tb, const void* bi, const void* bk,
                       const void* best, void* out, int bsz, int m, int w,
                       int pitch, int packed, void* stream) {
  if (bsz <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int hdr = best ? 12 : 0;
#define NM_WALK(KERNEL, PACKED, SMEM)                                      \
  KERNEL<PACKED><<<bsz, 32, SMEM, st>>>(                                   \
      (const uint8_t*)tb, (const int32_t*)bi, (const int32_t*)bk,          \
      (const float*)best, (uint8_t*)out, m, w, pitch, hdr)
  if (pitch > GUARD) {
    if (packed)
      NM_WALK(walk_wide_kernel, true, WIDE_SMEM);
    else
      NM_WALK(walk_wide_kernel, false, WIDE_SMEM);
  } else if (packed) {
    NM_WALK(walk_kernel, true, 0);
  } else {
    NM_WALK(walk_kernel, false, 0);
  }
#undef NM_WALK
  return (int)cudaGetLastError();
}
