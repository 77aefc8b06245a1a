// SA rows to (sequence, position) by LF walks to a sampled row.
//
// Replaces: genmap_tpu/ops/rank.py:locate with :bwt_char (an XLA fori_loop
// of gathers on the TPU, `sampling` iterations over every row).
//
// Bound on the H100: latency.  A row walks up to `sampling` dependent LF
// steps; each step reads the 512-symbol rank sub-row that covers the
// current row (208 B Dna4, 276 B Dna5) and one 20 B indicator row, at an
// address known only after the previous step.  Neighbouring threads walk
// unrelated rows, so nothing coalesces; the least time is `sampling`
// dependent reads per row, hidden only by many rows in flight.
//
// Design: one thread per SA row, no shared memory.  The loop keeps the JAX
// semantics exactly: `sampling` iterations; in each, a row that is done
// stays put; otherwise the indicator bit of its current row is read first
// and a set bit marks it done (no step), else it takes one LF step, code =
// the BWT symbol (N bit -> code 4) and next row = C[code] + occ[code].  At
// the end, the indicator rank of the row gives the sample index, and the
// sampled (seq, pos) plus the step count is the answer.  Invalid rows read
// sample 0 and take no step.

#include "genmap.cuh"

__device__ __forceinline__ uint32_t gm_ind_bit(const uint32_t* __restrict__ ind,
                                               uint32_t p) {
  const uint32_t* r = ind + (size_t)(p >> 7) * (1 + GM_BVWORDS);
  const uint32_t off = p & 127u;
  return (r[1 + (off >> 5)] >> (off & 31u)) & 1u;
}

__global__ void locate_kernel(const uint32_t* __restrict__ rows, int row_w,
                              int has_n, const uint32_t* __restrict__ C,
                              const uint32_t* __restrict__ ind,
                              const uint32_t* __restrict__ sa_i1,
                              const uint32_t* __restrict__ sa_i2,
                              int64_t n_samples,
                              const uint32_t* __restrict__ pos,
                              const uint8_t* __restrict__ valid, int64_t N,
                              int sampling, uint32_t* __restrict__ i1,
                              uint32_t* __restrict__ i2) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const bool ok = valid[i] != 0;
  uint32_t p = pos[i];
  uint32_t steps = 0;
  bool done = !ok;
  for (int it = 0; it < sampling && !done; ++it) {
    if (gm_ind_bit(ind, p)) {
      done = true;
      break;
    }
    const uint32_t* sub = rows + (size_t)(p >> 9) * row_w;  // first half
    const uint32_t off = p & 511u;
    uint32_t code = (sub[off >> 4] >> ((off & 15u) * 2u)) & 3u;
    if (has_n && ((sub[GM_S_NBITS + (off >> 5)] >> (off & 31u)) & 1u)) code = 4;
    uint32_t occ[5], sent;
    gm_occ_sub(sub, p, has_n, occ, &sent);
    p = C[code] + occ[code];
    ++steps;
  }
  uint32_t vidx = 0;
  if (ok) {
    const uint32_t* r = ind + (size_t)(p >> 7) * (1 + GM_BVWORDS);
    const int off = (int)(p & 127u);
    vidx = r[0];
#pragma unroll
    for (int k = 0; k < GM_BVWORDS; ++k) vidx += __popc(r[1 + k] & gm_bit_mask(off, k));
    if ((int64_t)vidx >= n_samples) vidx = (uint32_t)(n_samples - 1);
  }
  i1[i] = sa_i1[vidx];
  i2[i] = sa_i2[vidx] + steps;
}

extern "C" int genmap_locate(const void* rows, int row_w, int has_n,
                             const void* C, const void* ind, const void* sa_i1,
                             const void* sa_i2, long long n_samples,
                             const void* pos, const void* valid, long long N,
                             int sampling, void* i1, void* i2, void* stream) {
  if (N == 0) return 0;
  if (n_samples < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  locate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, row_w, has_n, (const uint32_t*)C,
      (const uint32_t*)ind, (const uint32_t*)sa_i1, (const uint32_t*)sa_i2,
      (int64_t)n_samples, (const uint32_t*)pos, (const uint8_t*)valid,
      (int64_t)N, sampling, (uint32_t*)i1, (uint32_t*)i2);
  return (int)cudaGetLastError();
}
