// The split pipeline's rung gather: phase-B rows of phase-A survivor states.
//
// Replaces: genmap_tpu/engine/mappability.py:_run_tier_split's sl()
// (:1477-1486): a take of the chosen phase-A rows from each of the four
// [B, Fc] operands (flo, rlo, size, err) and from the validity, then a cut
// to the rung's Fe slots or a zero padding up to them; rows past the live
// count are marked invalid.
//
// Bound on the H100: bytes.  It reads min(Fc, Fe) slots of four int32
// operands and a validity byte per gathered row and writes Fe of each; the
// rows are contiguous, so a warp's reads and writes coalesce.
//
// Design: one thread per (output row, slot), all four operands in one
// launch.  Padding rows (index >= n) gather row ridx[i] (0) like the
// JAX take and are marked invalid.

#include "genmap.cuh"

__global__ void gather_states_kernel(const int32_t* __restrict__ st,
                                     const uint8_t* __restrict__ valid, int B,
                                     int Fc, const int32_t* __restrict__ ridx,
                                     int npad, int n, int Fe,
                                     int32_t* __restrict__ out,
                                     uint8_t* __restrict__ out_valid) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t N = (int64_t)npad * Fe;
  if (idx >= N) return;
  const int i = (int)(idx / Fe);
  const int s = (int)(idx - (int64_t)i * Fe);
  const int64_t S = (int64_t)B * Fc;
  if (s < Fc) {
    const int64_t src = (int64_t)ridx[i] * Fc + s;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k * N + idx] = st[k * S + src];
    out_valid[idx] = i < n ? valid[src] : 0;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k * N + idx] = 0;
    out_valid[idx] = 0;
  }
}

extern "C" int genmap_gather_states(const void* st, const void* valid, int B,
                                    int Fc, const void* ridx, int npad, int n,
                                    int Fe, void* out, void* out_valid,
                                    void* stream) {
  const int64_t m = (int64_t)npad * Fe;
  if (m == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((m + threads - 1) / threads);
  gather_states_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)st, (const uint8_t*)valid, B, Fc, (const int32_t*)ridx,
      npad, n, Fe, (int32_t*)out, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
