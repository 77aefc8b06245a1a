// Unique-infix probe: per-plan survivor mass of every block and its skip bit.
//
// Replaces: the probe branch of genmap_tpu/search/engine.py:block_mapper_impl
// (mass_p, nwin and the skip test against probe_thresholds; an XLA one-hot
// product and sum on the TPU).
//
// Bound on the H100: bytes.  A block reads its F validity bytes, and the
// size and plan rows of its valid slots (8 B each), and, for Dna5, its Ln
// needle bytes; it writes one skip byte (and P mass words when asked).
// Nothing is read twice and the rows of a block are contiguous.
//
// Design: one warp per block.  Lanes stride over the F survivor slots and
// add the size of each valid slot into a per-plan accumulator (P <= 16;
// the plan count of e <= 4 is at most 7).  Accumulators are 64-bit, so a
// block whose summed interval sizes pass 2^32 cannot wrap to a small mass
// and be skipped unsoundly (the JAX package sums in uint32); the written
// mass saturates at 2^32 - 1, which equals JAX's sum wherever that does not
// wrap.  A shuffle reduction combines the lanes.  For Dna5 the lanes also
// scan the needle window for code 4 (N) and a ballot combines them.  Lane
// 0 then compares each plan's mass against thr[p], ORs in the block's
// overflow flag and N flag, and writes skip[B].
//
// Multi-part indexes: the engine launches once per part.  acc_in (when
// given) is the running [B, P + 1] int64 sum of the earlier parts: the
// per-plan masses (each saturated at 2^32 - 1) and, in column P, their
// overflow and N-window flags ORed.  A launch with acc_out adds this part
// and writes the new sum there (the decision waits for the last part); a
// launch with skip decides on the sum.  With one part neither accumulator
// is given and the launch is the plain one.
//
// Part mesh (entry genmap_probe_mass_reduced; replaces the psum-then-
// decide of genmap_tpu/parallel/partmesh.py:make_part_prober): each device
// runs its part's launch with acc_out, the accumulators are summed over
// the devices of the part axis (an all_reduce outside the kernel), and
// this entry decides on the sum: one thread per block reads its P + 1
// int64 words, saturates each mass at 2^32 - 1 (a sum of saturated part
// masses cannot wrap int64), tests it against thr[p] and the flag column
// against 0, and writes the skip byte (and the saturated masses when
// asked).  Bound: bytes, 8 (P + 1) read and 1 (+ 4 P) written per block.

#include "genmap.cuh"

#define GM_PROBE_MAX_P 16

__global__ void probe_mass_kernel(const int32_t* __restrict__ st,
                                  const uint8_t* __restrict__ valid,
                                  int64_t B, int F, int P,
                                  const uint8_t* __restrict__ ovf,
                                  const uint8_t* __restrict__ needles, int Ln,
                                  int has_n, const int32_t* __restrict__ thr,
                                  const int64_t* __restrict__ acc_in,
                                  int64_t* __restrict__ acc_out,
                                  uint8_t* __restrict__ skip,
                                  int32_t* __restrict__ mass_out,
                                  uint8_t* __restrict__ nwin_out) {
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // warp-uniform
  const int64_t N = B * F;
  unsigned long long acc[GM_PROBE_MAX_P];
#pragma unroll
  for (int p = 0; p < GM_PROBE_MAX_P; ++p) acc[p] = 0ull;
  for (int s = lane; s < F; s += 32) {
    const int64_t k = b * F + s;
    if (!valid[k]) continue;
    const int plan = st[4 * N + k];
    const unsigned long long size = (uint32_t)st[2 * N + k];
#pragma unroll
    for (int p = 0; p < GM_PROBE_MAX_P; ++p)
      if (p == plan) acc[p] += size;  // unrolled select keeps acc in registers
  }
  bool n_here = false;
  if (has_n)
    for (int j = lane; j < Ln; j += 32) n_here |= needles[b * Ln + j] == 4;
  const bool nwin = __any_sync(0xFFFFFFFFu, n_here);
  bool ok = true;
#pragma unroll
  for (int p = 0; p < GM_PROBE_MAX_P; ++p) {
    if (p >= P) break;  // P is uniform across the warp
    unsigned long long m = acc[p];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m += __shfl_xor_sync(0xFFFFFFFFu, m, d);
    if (acc_in) m += (unsigned long long)acc_in[b * (P + 1) + p];
    const uint32_t sat = m > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)m;
    ok = ok && sat <= (uint32_t)thr[p];
    if (lane == 0 && mass_out) mass_out[b * P + p] = (int32_t)sat;
    if (lane == 0 && acc_out) acc_out[b * (P + 1) + p] = (int64_t)sat;
  }
  if (lane == 0) {
    const bool bad = ovf[b] || nwin || (acc_in && acc_in[b * (P + 1) + P] != 0);
    if (skip) skip[b] = (ok && !bad) ? 1 : 0;
    if (acc_out) acc_out[b * (P + 1) + P] = bad ? 1 : 0;
    if (nwin_out) nwin_out[b] = nwin ? 1 : 0;
  }
}

extern "C" int genmap_probe_mass(const void* st, const void* valid,
                                 long long B, int F, int P, const void* ovf,
                                 const void* needles, int Ln, int has_n,
                                 const void* thr, const void* acc_in,
                                 void* acc_out, void* skip, void* mass_out,
                                 void* nwin_out, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > GM_PROBE_MAX_P) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 blocks of the batch per CUDA block
  const unsigned int blocks = (unsigned int)((B * 32 + threads - 1) / threads);
  probe_mass_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)st, (const uint8_t*)valid, (int64_t)B, F, P,
      (const uint8_t*)ovf, (const uint8_t*)needles, Ln, has_n,
      (const int32_t*)thr, (const int64_t*)acc_in, (int64_t*)acc_out,
      (uint8_t*)skip, (int32_t*)mass_out,
      (uint8_t*)nwin_out);
  return (int)cudaGetLastError();
}

__global__ void probe_mass_reduced_kernel(const int64_t* __restrict__ acc,
                                          int64_t B, int P,
                                          const int32_t* __restrict__ thr,
                                          uint8_t* __restrict__ skip,
                                          int32_t* __restrict__ mass_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* row = acc + b * (P + 1);
  bool ok = row[P] == 0;
  for (int p = 0; p < P; ++p) {
    const int64_t m = row[p];
    const uint32_t sat = m > 0xFFFFFFFFll ? 0xFFFFFFFFu : (uint32_t)m;
    ok = ok && sat <= (uint32_t)thr[p];
    if (mass_out) mass_out[b * P + p] = (int32_t)sat;
  }
  skip[b] = ok ? 1 : 0;
}

extern "C" int genmap_probe_mass_reduced(const void* acc, long long B, int P,
                                         const void* thr, void* skip,
                                         void* mass_out, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > GM_PROBE_MAX_P) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
  probe_mass_reduced_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (int64_t)B, P, (const int32_t*)thr, (uint8_t*)skip,
      (int32_t*)mass_out);
  return (int)cudaGetLastError();
}
