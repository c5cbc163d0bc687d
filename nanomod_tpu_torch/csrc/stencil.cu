// K7: the neighbor-combination stencil of one position shard, on the card.
//
// Replaces the step of nanomod_tpu/parallel/sharded.py _stencil_fn (XLA
// under shard_map): per position of the shard's [L] slice, pick the KS
// numerator and effective sizes the test used (the capped subsample's where
// a group exceeds the per-strand cap cov, the plain ones otherwise), and
// assemble the [2k+1, L] stencil of (numerator, ne1, ne2, ok) for the
// offsets -k..k.  Columns past the shard's edges come from the [5, k] halo
// blocks (selected numerator, ne1, ne2, position, valid) that the wrapper
// copied from the neighbour shards; a mesh edge's halo is zeros, so its
// valid is 0 and the host gives that neighbor p = 1.0.  ok is the
// reference's pos_check: valid at offset 0, elsewhere the neighbor's valid,
// the center's valid and a genomic distance equal to the offset.
//
// What bounds it: bytes.  It reads five int32 vectors and one byte vector
// of [L] and writes (2k+1) x L x 13 bytes, with a handful of integer
// operations a written column, so the outputs' writes set its time.  The
// design is one thread per (offset, column): the grid's y is the offset,
// its x the column, so a warp reads and writes neighbouring addresses and
// no thread divides an index; the selection is recomputed per thread from
// the center vectors (cached in L2), which costs less than a second pass
// over memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stencil_kernel(const int* __restrict__ num,
                               const int* __restrict__ cap,
                               const int* __restrict__ n1c,
                               const int* __restrict__ n2c,
                               const int* __restrict__ pos,
                               const uint8_t* __restrict__ valid,
                               const int* __restrict__ left,
                               const int* __restrict__ right, int L, int k,
                               int cov, int* __restrict__ d_out,
                               int* __restrict__ ne1_out,
                               int* __restrict__ ne2_out,
                               uint8_t* __restrict__ ok_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int off = (int)blockIdx.y - k;
  const int t = (int)blockIdx.y * L + j;
  const int src = j + off;
  int p_num, p_ne1, p_ne2, p_pos, p_valid;
  if (src < 0 || src >= L) {
    // halo block [5, k]: left holds the k columns just before the shard,
    // right the k just after it
    const int* h = src < 0 ? left : right;
    const int c = src < 0 ? k + src : src - L;
    p_num = h[c];
    p_ne1 = h[k + c];
    p_ne2 = h[2 * k + c];
    p_pos = h[3 * k + c];
    p_valid = h[4 * k + c];
  } else {
    const int a = n1c[src], b = n2c[src];
    const bool need = cov > 0 && (a > cov || b > cov);
    p_num = need ? cap[src] : num[src];
    p_ne1 = need ? min(a, cov) : a;
    p_ne2 = need ? min(b, cov) : b;
    p_pos = pos[src];
    p_valid = valid[src];
  }
  const bool center = valid[j] != 0;
  bool ok;
  if (off == 0) {
    ok = center;
  } else {
    // int32 wrap-around difference, as the reference's int32 subtract
    const int dist = (int)((uint32_t)p_pos - (uint32_t)pos[j]);
    ok = p_valid > 0 && center && dist == off;
  }
  d_out[t] = p_num;
  ne1_out[t] = p_ne1;
  ne2_out[t] = p_ne2;
  ok_out[t] = ok ? 1 : 0;
}

}  // namespace

// num, cap, n1c, n2c, pos: [L] int32; valid [L] u8; left, right: [5, k]
// int32; outputs [2k+1, L] (d, ne1, ne2 int32, ok u8); (2k+1) L < 2^31
// and 2k+1 <= 65535 (the grid's y).
extern "C" int nm_stencil(const void* num, const void* cap, const void* n1c,
                          const void* n2c, const void* pos, const void* valid,
                          const void* left, const void* right, int L, int k,
                          int cov, void* d, void* ne1, void* ne2, void* ok,
                          void* stream) {
  if (L == 0) return 0;
  const int threads = 256;
  const dim3 grid((L + threads - 1) / threads, 2 * k + 1);
  stencil_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)num, (const int*)cap, (const int*)n1c, (const int*)n2c,
      (const int*)pos, (const uint8_t*)valid, (const int*)left,
      (const int*)right, L, k, cov, (int*)d, (int*)ne1, (int*)ne2,
      (uint8_t*)ok);
  return (int)cudaGetLastError();
}
