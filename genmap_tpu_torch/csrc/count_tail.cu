// Per-k-mer saturating occurrence counts from the final extension states.
//
// Replaces: genmap_tpu/search/engine.py:_count_tail (counting part) with
// genmap_tpu/ops/rank.py:rc_strand_count for forward-only (-nc) counts.
//
// Bound on the H100: bytes for reverse-complement counting (one pass over
// the [B, J, Fe] states); with -nc, the latency of two random strand-row
// reads (20 B each) per valid state.
//
// Design: one warp per (block, k-mer); lanes stride over the k-mer's Fe
// states, each adds min(count, cap) of its valid states, and a shuffle
// reduction sums the lanes before the result saturates at cap.  k-mers at
// or past the block's count are written as 0.

#include "genmap.cuh"

__global__ void count_tail_kernel(const int32_t* __restrict__ st,
                                  const uint8_t* __restrict__ valid,
                                  int64_t rows, int Fe, int J,
                                  const int32_t* __restrict__ cnt,
                                  const uint32_t* __restrict__ strand,
                                  int rev_compl, uint32_t cap,
                                  uint16_t* __restrict__ hits) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int64_t N = rows * Fe;
  uint32_t acc = 0;
  for (int s = lane; s < Fe; s += 32) {
    const int64_t k = row * Fe + s;
    if (!valid[k]) continue;
    const uint32_t flo = (uint32_t)st[k];
    const uint32_t size = (uint32_t)st[2 * N + k];
    uint32_t counting = size;
    if (!rev_compl)
      counting = size - (gm_rc_count(strand, flo + size) - gm_rc_count(strand, flo));
    acc += counting < cap ? counting : cap;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
  if (lane == 0) {
    const int64_t b = row / J;
    const int j = (int)(row - b * J);
    hits[row] = (uint16_t)(j < cnt[b] ? (acc < cap ? acc : cap) : 0u);
  }
}

extern "C" int genmap_count_tail(const void* st, const void* valid,
                                 long long rows, int Fe, int J,
                                 const void* cnt, const void* strand,
                                 int rev_compl, unsigned int cap, void* hits,
                                 void* stream) {
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((rows * 32 + threads - 1) / threads);
  count_tail_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)st, (const uint8_t*)valid, (int64_t)rows, Fe, J,
      (const int32_t*)cnt, (const uint32_t*)strand, rev_compl, cap,
      (uint16_t*)hits);
  return (int)cudaGetLastError();
}
