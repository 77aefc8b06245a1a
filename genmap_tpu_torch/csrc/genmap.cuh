// Shared layout constants and device helpers of the port's CUDA kernels.
//
// The rank-row layout is the one of genmap_tpu_torch/index/fmindex.py: a
// SUB-row covers 512 BWT symbols,
//   cols  0..31  2-bit symbol codes, 16 per word (N and sentinel stored as 0)
//   cols 32..34  absolute counts of codes <= 0, <= 1, <= 2 at the sub-row start
//   col   35     absolute sentinel count at the sub-row start
//   cols 36..51  sentinel bitvector
//   [Dna5 only] col 52 absolute N count, cols 53..68 N bitvector
// and a stored (paired) row i is sub-rows i and i+1 side by side.  Strand
// rank rows are [count, 4 bit words] per 128 SA rows.
//
// All uint32 data arrives from PyTorch as int32 tensors with the same bits
// and is read here as uint32_t; arithmetic wraps mod 2^32 exactly like the
// JAX package's uint32 arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GM_SUBWORDS 32
#define GM_SUBBITS 16
#define GM_S_LE 32
#define GM_S_SCNT 35
#define GM_S_SBITS 36
#define GM_S_NCNT 52
#define GM_S_NBITS 53
#define GM_BVWORDS 4

// Mask of the 2-bit fields < off within word k (fields 16k .. 16k+15).
// A shift by 32 is undefined in CUDA, so full and empty words are explicit.
__device__ __forceinline__ uint32_t gm_field_mask(int off, int k) {
  int nf = off - 16 * k;
  if (nf <= 0) return 0u;
  if (nf >= 16) return 0xFFFFFFFFu;
  return (1u << (2 * nf)) - 1u;
}

// Mask of the bits < off within bitvector word k (bits 32k .. 32k+31).
__device__ __forceinline__ uint32_t gm_bit_mask(int off, int k) {
  int nb = off - 32 * k;
  if (nb <= 0) return 0u;
  if (nb >= 32) return 0xFFFFFFFFu;
  return (1u << nb) - 1u;
}

// #SA rows before p whose suffix lies in the reverse-complement half
// (ops/rank.py rc_strand_count).
__device__ __forceinline__ uint32_t gm_rc_count(const uint32_t* __restrict__ strand,
                                                uint32_t p) {
  const uint32_t* r = strand + (size_t)(p >> 7) * (1 + GM_BVWORDS);
  const int off = (int)(p & 127u);
  uint32_t c = r[0];
#pragma unroll
  for (int k = 0; k < GM_BVWORDS; ++k) c += __popc(r[1 + k] & gm_bit_mask(off, k));
  return c;
}
