// Per-k-mer saturating occurrence counts from the final extension states,
// and optionally the zero-error interval of every k-mer.
//
// Replaces: genmap_tpu/search/engine.py:_count_tail (counting part, and
// its with_exact / with_states outputs exact_size, exact_size_total and
// exact_flo) with genmap_tpu/ops/rank.py:rc_strand_count for forward-only
// (-nc) counts.
//
// Bound on the H100: bytes for reverse-complement counting (one pass over
// the [B, J, Fe] states); with -nc or the exact outputs, the latency of two
// random strand-row reads (20 B each) per valid state.
//
// Design: one warp per (block, k-mer); lanes stride over the k-mer's Fe
// states, each adds min(count, cap) of its valid states, and a shuffle
// reduction sums the lanes before the result saturates at cap.  k-mers at
// or past the block's count are written as 0.  With `with_exact` the same
// lanes also sum, over valid states with err == 0, the interval size, its
// forward-strand part (strand rows read even when counting both strands)
// and the interval start; these sums wrap mod 2^32 as the JAX package's
// uint32 sums do.  exact_size and exact_size_total are 0 past the block's
// count; exact_flo is not masked (as in JAX).

#include "genmap.cuh"

__global__ void count_tail_kernel(const int32_t* __restrict__ st,
                                  const uint8_t* __restrict__ valid,
                                  int64_t rows, int Fe, int J,
                                  const int32_t* __restrict__ cnt,
                                  const uint32_t* __restrict__ strand,
                                  int rev_compl, uint32_t cap,
                                  uint16_t* __restrict__ hits, int with_exact,
                                  uint32_t* __restrict__ exact_size,
                                  uint32_t* __restrict__ exact_total,
                                  uint32_t* __restrict__ exact_flo) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int64_t N = rows * Fe;
  uint32_t acc = 0, e_fwd = 0, e_tot = 0, e_flo = 0;
  for (int s = lane; s < Fe; s += 32) {
    const int64_t k = row * Fe + s;
    if (!valid[k]) continue;
    const uint32_t flo = (uint32_t)st[k];
    const uint32_t size = (uint32_t)st[2 * N + k];
    const bool exact_state = with_exact && st[3 * N + k] == 0;
    uint32_t fwd = size;
    if (!rev_compl || exact_state)
      fwd = size - (gm_rc_count(strand, flo + size) - gm_rc_count(strand, flo));
    const uint32_t counting = rev_compl ? size : fwd;
    acc += counting < cap ? counting : cap;
    if (exact_state) {
      e_fwd += fwd;
      e_tot += size;
      e_flo += flo;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
  if (with_exact) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      e_fwd += __shfl_xor_sync(0xFFFFFFFFu, e_fwd, d);
      e_tot += __shfl_xor_sync(0xFFFFFFFFu, e_tot, d);
      e_flo += __shfl_xor_sync(0xFFFFFFFFu, e_flo, d);
    }
  }
  if (lane == 0) {
    const int64_t b = row / J;
    const int j = (int)(row - b * J);
    const bool in = j < cnt[b];
    hits[row] = (uint16_t)(in ? (acc < cap ? acc : cap) : 0u);
    if (with_exact) {
      exact_size[row] = in ? e_fwd : 0u;
      exact_total[row] = in ? e_tot : 0u;
      exact_flo[row] = e_flo;
    }
  }
}

extern "C" int genmap_count_tail(const void* st, const void* valid,
                                 long long rows, int Fe, int J,
                                 const void* cnt, const void* strand,
                                 int rev_compl, unsigned int cap, void* hits,
                                 int with_exact, void* exact_size,
                                 void* exact_total, void* exact_flo,
                                 void* stream) {
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((rows * 32 + threads - 1) / threads);
  count_tail_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)st, (const uint8_t*)valid, (int64_t)rows, Fe, J,
      (const int32_t*)cnt, (const uint32_t*)strand, rev_compl, cap,
      (uint16_t*)hits, with_exact, (uint32_t*)exact_size,
      (uint32_t*)exact_total, (uint32_t*)exact_flo);
  return (int)cudaGetLastError();
}
