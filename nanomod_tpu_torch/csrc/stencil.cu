// K7: the neighbor-combination stencil of every position shard on one card,
// in one launch.
//
// Replaces the step of nanomod_tpu/parallel/sharded.py _stencil_fn (XLA
// under shard_map): its ppermute halo exchange and the stencil assembly.
// Per position of a shard's [L] slice, pick the KS numerator and effective
// sizes the test used (the capped subsample's where a group exceeds the
// per-strand cap cov, the plain ones otherwise), and assemble the [2k+1, L]
// stencil of (numerator, ne1, ne2, ok) for the offsets -k..k.  ok is the
// reference's pos_check: valid at offset 0, elsewhere the neighbor's valid,
// the center's valid and a genomic distance equal to the offset.
//
// What bounds it: bytes.  A shard reads five int32 vectors and one byte
// vector of [L] and writes (2k+1) x L x 13 bytes, with a handful of integer
// operations a written entry, so the outputs' writes set its time.  At the
// main path's sizes that is a few microseconds a shard, so what bounded
// the step was the host: a launch a shard, and a dozen small device ops a
// shard to cut, select and copy its [5, k] halo blocks.
//
// The design: one launch for every shard a card holds (the grid's z is the
// shard, its y the offset, its x the column, so a warp reads and writes
// neighbouring addresses).  Each shard is a ShardCols descriptor of input
// pointers, its own and its two neighbours', passed by value in the kernel's
// parameters (a __grid_constant__ struct, read from the constant bank), so
// nothing is copied before the launch.  A column past the shard's edge is
// read straight from the neighbour's [L] inputs, with the same selection as
// the shard's own columns: the halo exchange becomes k loads at each edge.
// A neighbour on another card is read over NVLink through peer access
// (nm_enable_peer_access, called by the wrapper once per pair of cards).
// Where two cards cannot reach each other, the wrapper copies the
// neighbour's k edge columns onto the reader's card first, and the
// descriptor says at which column those copies start (Cols::first), so the
// kernel reads them at their own offset.  A mesh edge has null pointers
// and reads as zeros with valid 0, as the reference's zero-filled
// ppermute.  The selection is recomputed per
// (offset, column) from the vectors (cached in L2), which costs less than
// a second pass over memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;

// one shard's inputs: columns first .. of its [L] vectors (a neighbour's
// edge columns staged on the reader's card start at first = L - k on the
// left; else first = 0)
struct Cols {
  const int* num;
  const int* cap;
  const int* n1c;
  const int* n2c;
  const int* pos;
  const uint8_t* valid;
  int first;
};

struct ShardCols {
  Cols self, left, right;
};

// the outputs are [nshards, 2k+1, L], shard after shard
struct StepArgs {
  ShardCols shard[kMaxShards];
  int* d;
  int* ne1;
  int* ne2;
  uint8_t* ok;
  int L, k, cov;
};

__global__ void __launch_bounds__(kThreads)
stencil_step_kernel(const __grid_constant__ StepArgs a) {
  const int L = a.L;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int row = blockIdx.y;
  const int off = row - a.k;
  const int src = j + off;
  const ShardCols& sh = a.shard[blockIdx.z];
  const Cols c = src < 0 ? sh.left : (src >= L ? sh.right : sh.self);
  const int i = (src < 0 ? src + L : (src >= L ? src - L : src)) - c.first;
  int p_num = 0, p_ne1 = 0, p_ne2 = 0, p_pos = 0, p_valid = 0;
  if (c.num != nullptr) {
    const int n1 = c.n1c[i], n2 = c.n2c[i];
    const bool need = a.cov > 0 && (n1 > a.cov || n2 > a.cov);
    p_num = need ? c.cap[i] : c.num[i];
    p_ne1 = need ? min(n1, a.cov) : n1;
    p_ne2 = need ? min(n2, a.cov) : n2;
    p_pos = c.pos[i];
    p_valid = c.valid[i];
  }
  const bool center = sh.self.valid[j] != 0;
  bool ok;
  if (off == 0) {
    ok = center;
  } else {
    // int32 wrap-around difference, as the reference's int32 subtract
    const int dist = (int)((uint32_t)p_pos - (uint32_t)sh.self.pos[j]);
    ok = p_valid > 0 && center && dist == off;
  }
  const size_t t = ((size_t)blockIdx.z * gridDim.y + row) * L + j;
  a.d[t] = p_num;
  a.ne1[t] = p_ne1;
  a.ne2[t] = p_ne2;
  a.ok[t] = ok ? 1 : 0;
}

}  // namespace

// cols: host array of nshards x 21 words, a shard's own (num, cap, n1c,
// n2c, pos: int32; valid: u8; then the index of the column they start at,
// 0), then its left and its right neighbour's (the same seven; pointers
// null at a mesh edge); outputs d, ne1, ne2 (int32) and ok (u8) of
// [nshards, 2k+1, L].  nshards <= 16, 2k+1 <= 65535, k <= L.
extern "C" int nm_stencil_step(const uint64_t* cols, int nshards, int L,
                               int k, int cov, void* d, void* ne1, void* ne2,
                               void* ok, void* stream) {
  if (nshards < 0 || nshards > kMaxShards || k < 0 || k > L ||
      2 * k + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  if (L == 0 || nshards == 0) return 0;
  StepArgs a;
  for (int s = 0; s < nshards; ++s) {
    Cols* dst[3] = {&a.shard[s].self, &a.shard[s].left, &a.shard[s].right};
    for (int side = 0; side < 3; ++side) {
      const uint64_t* p = cols + 21 * s + 7 * side;
      dst[side]->num = (const int*)p[0];
      dst[side]->cap = (const int*)p[1];
      dst[side]->n1c = (const int*)p[2];
      dst[side]->n2c = (const int*)p[3];
      dst[side]->pos = (const int*)p[4];
      dst[side]->valid = (const uint8_t*)p[5];
      dst[side]->first = (int)p[6];
    }
  }
  a.d = (int*)d;
  a.ne1 = (int*)ne1;
  a.ne2 = (int*)ne2;
  a.ok = (uint8_t*)ok;
  a.L = L;
  a.k = k;
  a.cov = cov;
  const dim3 grid((L + kThreads - 1) / kThreads, 2 * k + 1, nshards);
  stencil_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Let the current card read the memory of card ``peer`` (cudaDeviceCanAccess
// Peer, then cudaDeviceEnablePeerAccess).  Returns 0 when it can (access
// enabled now, before, or peer is the current card), -1 when the two cards
// cannot reach each other, else a CUDA error code.  Access that PyTorch's
// own peer copies enabled already counts as success, and its error is
// cleared.
extern "C" int nm_enable_peer_access(int peer) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev == peer) return 0;
  int can = 0;
  e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return -1;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}
