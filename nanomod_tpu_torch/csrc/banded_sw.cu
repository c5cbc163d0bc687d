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
// Layout: one block per read, one thread per band lane k (W threads, W a
// multiple of 32), a loop over the read's rows inside the block.  H and F
// of the previous row stay in registers; the k+1 neighbour comes by
// __shfl_down_sync, and across a warp edge from a word of shared memory.
// The exclusive running max of E is a warp shuffle scan plus a combine of
// the warps' totals; the row's max and first argmax is a warp reduction
// plus an in-order scan of the warp results.  Two __syncthreads per row.
// The substitution score is computed here from the u8 codes: the [B,M,W]
// f32 score array that the Pallas wrapper builds is never materialised.
//
// What bounds it on the card: the row loop is sequential, so a block is
// latency bound (about ten shuffles and two barriers per row); the only
// bulk traffic is the [B,M,W] u8 traceback, written once, 128 coalesced
// bytes per row per block.  Parallelism comes from B blocks in flight.
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

__global__ void banded_sw_kernel(const uint8_t* __restrict__ read,
                                 const uint8_t* __restrict__ ref,
                                 const int32_t* __restrict__ lens,
                                 uint8_t* __restrict__ tb,
                                 float* __restrict__ best_out,
                                 int32_t* __restrict__ bi_out,
                                 int32_t* __restrict__ bk_out,
                                 int m, int w, float match, float mismatch,
                                 float go, float ge) {
  __shared__ float s_hfirst[32];    // lane-0 H of each warp, previous row
  __shared__ float s_ffirst[32];    // lane-0 F of each warp, previous row
  __shared__ float s_wmax[32];      // each warp's inclusive running max
  __shared__ float s_hnoe_last[32]; // lane-31 Hnoe of each warp
  __shared__ float s_rmax[32];      // each warp's row max ...
  __shared__ int s_rarg[32];        // ... and its first lane

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int nw = w >> 5;
  const uint8_t* rd = read + (size_t)b * m;
  const uint8_t* rf = ref + (size_t)b * (m + w);
  uint8_t* tbb = tb + (size_t)b * m * w;
  const int len = lens[b];

  const float gek = __fmul_rn(ge, (float)k);
  const float e_base = __fsub_rn(__fadd_rn(gek, go), ge);

  float h = 0.f, f = NEGF;
  float best = 0.f;
  int best_i = 0, best_k = 0;
  if (lane == 0) {
    s_hfirst[warp] = 0.f;
    s_ffirst[warp] = NEGF;
  }
  __syncthreads();

  for (int i = 0; i < m; ++i) {
    // predecessors at (i-1, k+1)
    float h_up = __shfl_down_sync(FULL, h, 1);
    float f_up = __shfl_down_sync(FULL, f, 1);
    if (lane == 31) {
      const bool has_next = warp + 1 < nw;
      h_up = has_next ? s_hfirst[warp + 1] : NEGF;
      f_up = has_next ? s_ffirst[warp + 1] : NEGF;
    }
    const int rc = rd[i];
    const int rr = rf[i + k];
    const float sub = (rr == rc && rc < 4 && rr < 4) ? match : mismatch;

    float f_cur = fmaxf(__fadd_rn(h_up, go), __fadd_rn(f_up, ge));
    const float hdiag = __fadd_rn(h, sub);
    const float h_noe = fmaxf(fmaxf(hdiag, f_cur), 0.f);

    // exclusive running max of a = Hnoe - ge*k over the band
    const float a = __fsub_rn(h_noe, gek);
    float cm = a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, cm, o);
      if (lane >= o) cm = fmaxf(cm, t);
    }
    const float cm_prev = __shfl_up_sync(FULL, cm, 1);
    float hn_prev = __shfl_up_sync(FULL, h_noe, 1);
    if (lane == 31) {
      s_wmax[warp] = cm;
      s_hnoe_last[warp] = h_noe;
    }
    __syncthreads();
    float pre = NEGF;
    for (int q = 0; q < warp; ++q) pre = fmaxf(pre, s_wmax[q]);
    float cm_shift;
    if (lane == 0) {
      cm_shift = pre;
      hn_prev = warp > 0 ? s_hnoe_last[warp - 1] : NEGF;
    } else {
      cm_shift = fmaxf(pre, cm_prev);
    }
    const float e_cur = __fadd_rn(e_base, cm_shift);
    float h_cur = fmaxf(h_noe, e_cur);
    if (i >= len) {
      h_cur = 0.f;
      f_cur = NEGF;
    }

    int src;
    if (h_cur <= 0.f) {
      src = 0;
    } else if (e_cur >= h_noe) {
      src = 2;
    } else if (f_cur >= fmaxf(hdiag, 0.f)) {
      src = 3;
    } else {
      src = 1;
    }
    const int e_ext = e_cur > __fadd_rn(__fadd_rn(hn_prev, go), 1e-4f);
    const int f_ext = f_cur > __fadd_rn(__fadd_rn(h_up, go), 1e-4f);
    tbb[(size_t)i * w + k] = (uint8_t)(src | (e_ext << 2) | (f_ext << 3));

    // row max, first lane on ties
    float v = h_cur;
    int arg = k;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_down_sync(FULL, v, o);
      const int a2 = __shfl_down_sync(FULL, arg, o);
      if (v2 > v || (v2 == v && a2 < arg)) {
        v = v2;
        arg = a2;
      }
    }
    if (lane == 0) {
      s_rmax[warp] = v;
      s_rarg[warp] = arg;
      s_hfirst[warp] = h_cur;
      s_ffirst[warp] = f_cur;
    }
    h = h_cur;
    f = f_cur;
    __syncthreads();
    float rb = s_rmax[0];
    int ra = s_rarg[0];
    for (int q = 1; q < nw; ++q) {
      if (s_rmax[q] > rb) {
        rb = s_rmax[q];
        ra = s_rarg[q];
      }
    }
    if (rb > best) {  // a later row replaces the best only if strictly higher
      best = rb;
      best_i = i;
      best_k = ra;
    }
  }
  if (k == 0) {
    best_out[b] = best;
    bi_out[b] = best_i;
    bk_out[b] = best_k;
  }
}

}  // namespace

extern "C" int nm_banded_sw(const void* read, const void* ref,
                            const void* lens, void* tb, void* best, void* bi,
                            void* bk, int bsz, int m, int w, float match,
                            float mismatch, float go, float ge,
                            void* stream) {
  if (bsz <= 0 || m <= 0) return 0;
  banded_sw_kernel<<<bsz, w, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)read, (const uint8_t*)ref, (const int32_t*)lens,
      (uint8_t*)tb, (float*)best, (int32_t*)bi, (int32_t*)bk, m, w, match,
      mismatch, go, ge);
  return (int)cudaGetLastError();
}

extern "C" const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
