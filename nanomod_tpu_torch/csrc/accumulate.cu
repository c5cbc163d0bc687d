// K9: per-position (count, sum, sum of squares) of read events, on the card.
//
// Replaces nanomod_tpu/parallel/mesh.py _accumulate (an XLA scatter-add of
// each data shard's [R, L] events into [G + 1] accumulators, the last slot
// taking the events that are not ok and being dropped).  The scatter indexes
// as numpy does: a negative position p lands at p + G + 1 (so -1 is the
// dropped slot, -2 position G - 1), and what is still outside [0, G + 1)
// after that is dropped.  Here an event that is not ok, or whose position so
// wrapped lies outside [0, G), is skipped, so the dropped slot is never
// written.
//
// What bounds it: bytes.  It reads 9 bytes an event and writes 12 a
// position; its f32 work is three adds and a multiply an event.  The events
// land on positions in no order, so each is a read-modify-write in L2.  The
// design makes that one operation an event: the accumulator is [G, 4]
// (count, sum, sum of squares, unused), 16-byte aligned, and an event adds
// (1, v, v*v, 0) with one vector atomicAdd on a float4 (Hopper's vector
// float atomics on global memory), where three scalar atomics on three
// arrays would touch three cache lines.  The sums depend on the order in
// which the atomics land: counts are exact (integers below 2^24 in f32),
// the sums agree with an ordered sum to f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void accumulate_kernel(const int* __restrict__ pos,
                                  const float* __restrict__ val,
                                  const uint8_t* __restrict__ ok, int n,
                                  int genome_len, float4* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !ok[i]) return;
  long long p = pos[i];
  if (p < 0) p += (long long)genome_len + 1;
  if (p < 0 || p >= genome_len) return;
  const float v = val[i];
  atomicAdd(acc + p, make_float4(1.0f, v, __fmul_rn(v, v), 0.0f));
}

}  // namespace

// pos [n] int32, val [n] f32, ok [n] u8; acc [genome_len, 4] f32 (count,
// sum, sum of squares, unused), zeroed by the caller, 16-byte aligned.
extern "C" int nm_accumulate(const void* pos, const void* val, const void* ok,
                             int n, int genome_len, void* acc, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)pos, (const float*)val, (const uint8_t*)ok, n, genome_len,
      (float4*)acc);
  return (int)cudaGetLastError();
}
