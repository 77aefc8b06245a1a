// Needle windows from the 2-bit packed text.
//
// Replaces: genmap_tpu/ops/rank.py:extract_needles (an XLA gather of text
// words plus shifts on the TPU).
//
// Bound on the H100: bytes.  Each output byte needs one 2-bit field and, for
// Dna5, one N bit; neighbouring threads read neighbouring text words, so
// the reads coalesce and hit L2 for overlapping windows.  The least work is
// the [B, Ln] output plus ~Ln/4 + Ln/8 bytes of packed input per block.
//
// Design: one thread per (block, position), no shared memory.  Positions at
// or past the file limit read as code 0; an N base reads as code 4.

#include "genmap.cuh"

__global__ void extract_needles_kernel(const uint32_t* __restrict__ words,
                                       const uint32_t* __restrict__ nwords,
                                       int has_n,
                                       const uint32_t* __restrict__ starts,
                                       int B, int Ln, uint32_t limit,
                                       uint32_t text_last,
                                       uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * Ln) return;
  const int b = (int)(idx / Ln);
  const int j = (int)(idx - (int64_t)b * Ln);
  const uint32_t pos = starts[b] + (uint32_t)j;
  uint8_t code = 0;
  if (pos < limit) {
    const uint32_t pc = pos < text_last ? pos : text_last;
    code = (uint8_t)((words[pc >> 4] >> ((pc & 15u) * 2u)) & 3u);
    if (has_n && ((nwords[pc >> 5] >> (pc & 31u)) & 1u)) code = 4;
  }
  out[idx] = code;
}

extern "C" int genmap_extract_needles(const void* words, const void* nwords,
                                      int has_n, const void* starts, int B,
                                      int Ln, unsigned int limit,
                                      unsigned int text_last, void* out,
                                      void* stream) {
  const int64_t n = (int64_t)B * Ln;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  extract_needles_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)nwords, has_n,
      (const uint32_t*)starts, B, Ln, limit, text_last, (uint8_t*)out);
  return (int)cudaGetLastError();
}
