// K2: traceback walk of every read's banded-DP matrix, on the card.
//
// Replaces nanomod_tpu/resquiggle/banded.py walk_device (a lax.scan over
// 2M+W steps, vectorised over the batch) so that only the per-step op
// codes, not the [B,M,W] traceback matrix, cross to the host.  Output is
// the same [B, 2M+W] u8 code array, byte-equal: 0 stop, 1 M, 2 I, 3 D, in
// walk (3'->5') order; the plain-PyTorch pack_codes2 then packs it four
// codes a byte.
//
// Layout: one thread per read running the 3-state automaton (H, E, F) from
// (best_i, best_k).  Each step reads one traceback byte at a data-dependent
// address, so a thread is bound by the latency of that dependent load (the
// matrix is far larger than L2 at long buckets); the design keeps the
// state in registers, stops loading as soon as the read's walk is done and
// then only writes the zero tail.  Blocks of 32 threads spread the B reads
// over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void walk_kernel(const uint8_t* __restrict__ tb,
                            const int32_t* __restrict__ best_i,
                            const int32_t* __restrict__ best_k,
                            uint8_t* __restrict__ codes, int bsz, int m,
                            int w) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bsz) return;
  const int steps = 2 * m + w;
  const uint8_t* t = tb + (size_t)b * m * w;
  uint8_t* out = codes + (size_t)b * steps;
  int i = best_i[b];
  int k = best_k[b];
  int st = 0;  // 0 = H, 1 = E (deletion run), 2 = F (insertion run)
  bool done = false;
  int s = 0;
  for (; s < steps && !done; ++s) {
    const int ii = min(max(i, 0), m - 1);
    const int kk = min(max(k, 0), w - 1);
    const int bits = t[(size_t)ii * w + kk];
    const int src = bits & 3;
    const bool e_ext = (bits & 4) != 0;
    const bool f_ext = (bits & 8) != 0;
    const bool is_h = st == 0;
    const bool act_m = is_h && src == 1;
    const bool act_d = (is_h && src == 2) || st == 1;
    const bool act_i = (is_h && src == 3) || st == 2;
    const bool stop = is_h && src == 0;
    out[s] = stop ? 0 : (act_m ? 1 : (act_i ? 2 : 3));
    const int ni = (act_m || act_i) ? i - 1 : i;
    const int nk = act_d ? k - 1 : (act_i ? k + 1 : k);
    const int nst = act_m ? 0
                    : act_d ? (e_ext ? 1 : 0)
                    : act_i ? (f_ext ? 2 : 0)
                            : st;
    done = stop || ni < 0 || nk < 0 || nk >= w;
    i = ni;
    k = nk;
    st = nst;
  }
  for (; s < steps; ++s) out[s] = 0;
}

}  // namespace

extern "C" int nm_walk(const void* tb, const void* bi, const void* bk,
                       void* codes, int bsz, int m, int w, void* stream) {
  if (bsz <= 0) return 0;
  const int threads = 32;
  walk_kernel<<<(bsz + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int32_t*)bi, (const int32_t*)bk,
      (uint8_t*)codes, bsz, m, w);
  return (int)cudaGetLastError();
}
