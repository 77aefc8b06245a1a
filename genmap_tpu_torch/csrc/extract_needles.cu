// Needle windows from the 2-bit packed text.
//
// Replaces: genmap_tpu/ops/rank.py:extract_needles (an XLA gather of text
// words plus shifts on the TPU).
//
// Bound on the H100: bytes, and below them launch latency.  The least work
// is the [B, Ln] output plus ~Ln/4 + Ln/8 bytes of packed input per block:
// at the map's largest call ~1.3 MB, 0.4 us at 3.35 TB/s, far below one
// launch and one cold DRAM round trip.  A thread per output byte reads
// each text word 16 times (each N word 32 times), divides per byte and
// stores single bytes: it pays only where latency hides all of that.
//
// Design, two regimes by output size (`chip_ab.py --kernels`'s sweep, which
// builds this file with EN_THREADS and EN_WIDE_BYTES overridden):
//   wide (outputs of at least EN_WIDE_BYTES, rows of at least 16): one
//     thread per 16-byte chunk of the flattened [B * Ln] output (16-byte
//     aligned: one vector store), one 32-bit divide per chunk finding its
//     row.  For a window of 16 symbols the thread reads the two text words
//     that hold them and joins them with a funnel shift, does the same
//     with the N words, and spreads the codes into 16 bytes with shifts and
//     masks.  A chunk that crosses a row's end (one in Ln / 16: every warp
//     has some) reads both rows' windows at once and joins them with a
//     128-bit shift, so that no lane waits on a second round trip.
//   small: one thread per output byte.  Below ~0.5 MB a call's time is
//     its latency, and there 16 bytes per thread measured 6-14 % slower
//     than a byte per thread (a longer chain per thread, fewer threads).
// Positions at or past the file limit read as code 0; an N base reads as
// code 4.  A window reaching past the text's last symbol reads each
// position clamped to it, as the plain version does.

#include "genmap.cuh"

#ifndef EN_THREADS
#define EN_THREADS 256
#endif
// outputs from this size take 16 bytes per thread, smaller ones one
#ifndef EN_WIDE_BYTES
#define EN_WIDE_BYTES (1 << 19)
#endif

// 16 codes / N bits of positions pos0 .. pos0 + 15, each clamped to the
// text's last symbol as the plain version does.
__device__ __forceinline__ void en_window(const uint32_t* __restrict__ words,
                                          const uint32_t* __restrict__ nwords,
                                          int has_n, uint64_t pos0, uint32_t text_last,
                                          uint32_t* codes, uint32_t* nbits) {
  uint32_t c = 0, nb = 0;
  if (pos0 + 15 <= text_last) {  // one or two words, joined by a funnel shift
    const uint64_t w = pos0 >> 4;
    const uint32_t sh = (uint32_t)(pos0 & 15u);
    c = sh ? __funnelshift_r(words[w], words[w + 1], 2 * sh) : words[w];
    if (has_n) {
      const uint64_t nw = pos0 >> 5;
      const uint32_t nsh = (uint32_t)(pos0 & 31u);
      nb = nsh > 16 ? __funnelshift_r(nwords[nw], nwords[nw + 1], nsh) : nwords[nw] >> nsh;
    }
  } else {  // the window reaches past the text's end
    for (int t = 0; t < 16; ++t) {
      const uint64_t pc = pos0 + t < text_last ? pos0 + t : text_last;
      c |= ((words[pc >> 4] >> ((pc & 15u) * 2u)) & 3u) << (2 * t);
      if (has_n) nb |= ((nwords[pc >> 5] >> (pc & 31u)) & 1u) << t;
    }
  }
  *codes = c;
  *nbits = nb & 0xFFFFu;
}

// Bytes 4k .. 4k + 3 of a window: the 2-bit codes spread to bytes, N bases
// as code 4, and only the first `keep` (0..4) bytes kept (the rest, at or
// past the file limit, read as code 0).
__device__ __forceinline__ uint32_t en_bytes(uint32_t codes, uint32_t nbits, int k,
                                             int keep) {
  const uint32_t y = (codes >> (8 * k)) & 0xFFu;
  const uint32_t b = (y | (y << 6) | (y << 12) | (y << 18)) & 0x03030303u;
  const uint32_t n = (nbits >> (4 * k)) & 0xFu;
  const uint32_t m = ((n | (n << 7) | (n << 14) | (n << 21)) & 0x01010101u) * 0xFFu;
  const uint32_t x = (b & ~m) | (0x04040404u & m);
  return keep >= 4 ? x : (keep <= 0 ? 0u : x & ((1u << (8 * keep)) - 1u));
}

// The 16 bytes of a window as two 64-bit halves, only its first `keep`
// bytes kept.
__device__ __forceinline__ void en_spread(uint32_t codes, uint32_t nbits, int keep,
                                          uint64_t* lo, uint64_t* hi) {
  *lo = en_bytes(codes, nbits, 0, keep) | (uint64_t)en_bytes(codes, nbits, 1, keep - 4) << 32;
  *hi = en_bytes(codes, nbits, 2, keep - 8) |
        (uint64_t)en_bytes(codes, nbits, 3, keep - 12) << 32;
}

// Bytes of a window at pos0 that lie before the file limit, at most `most`.
__device__ __forceinline__ int en_keep(uint64_t pos0, uint32_t limit, int most) {
  return pos0 >= limit ? 0 : (limit - pos0 >= (uint64_t)most ? most : (int)(limit - pos0));
}

// The wide regime: a thread per 16-byte chunk (rows of at least 16).
__global__ void __launch_bounds__(EN_THREADS) extract_needles_wide(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ nwords,
    int has_n, const uint32_t* __restrict__ starts, int B, int Ln,
    uint32_t limit, uint32_t text_last, uint8_t* __restrict__ out) {
  const int64_t total = (int64_t)B * Ln;
  const int64_t idx0 = ((int64_t)blockIdx.x * EN_THREADS + threadIdx.x) * 16;
  if (idx0 >= total) return;
  const int n = total - idx0 < 16 ? (int)(total - idx0) : 16;
  const int64_t b = total <= 0xFFFFFFFFll ? (int64_t)((uint32_t)idx0 / (uint32_t)Ln)
                                         : idx0 / Ln;
  const int j = (int)(idx0 - b * Ln);
  // bytes [0, s) from row b at j, and where that row ends inside the chunk,
  // bytes [s, n) from the start of row b + 1: both rows' reads go out
  // together
  const int s = n < Ln - j ? n : Ln - j;
  const bool two = s < n;
  const uint64_t pa = (uint64_t)starts[b] + (uint64_t)j;
  const uint64_t pb = two ? (uint64_t)starts[b + 1] : 0;
  uint32_t ca, na, cb = 0, nb = 0;
  en_window(words, nwords, has_n, pa, text_last, &ca, &na);
  if (two) en_window(words, nwords, has_n, pb, text_last, &cb, &nb);
  uint64_t lo, hi;  // the chunk's bytes 0..7 and 8..15
  en_spread(ca, na, en_keep(pa, limit, s), &lo, &hi);
  if (two) {
    uint64_t blo, bhi;
    en_spread(cb, nb, en_keep(pb, limit, n - s), &blo, &bhi);
    const int sh = 8 * s;  // 8 .. 120 bits
    if (sh >= 64) {
      hi |= blo << (sh - 64);
    } else {
      hi |= (bhi << sh) | (blo >> (64 - sh));
      lo |= blo << sh;
    }
  }
  if (n == 16) {
    *reinterpret_cast<uint4*>(out + idx0) =
        make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
  } else {  // the output's last, partial chunk
    for (int p = 0; p < n; ++p)
      out[idx0 + p] = (uint8_t)((p < 8 ? lo >> (8 * p) : hi >> (8 * (p - 8))) & 0xFFu);
  }
}

// The small regime: a thread per output byte.
__global__ void __launch_bounds__(EN_THREADS) extract_needles_small(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ nwords,
    int has_n, const uint32_t* __restrict__ starts, int B, int Ln,
    uint32_t limit, uint32_t text_last, uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * EN_THREADS + threadIdx.x;
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
  const int64_t total = (int64_t)B * Ln;
  if (total == 0) return 0;
  const bool wide = total >= EN_WIDE_BYTES && Ln >= 16;
  const int64_t threads = wide ? (total + 15) / 16 : total;
  const unsigned int blocks = (unsigned int)((threads + EN_THREADS - 1) / EN_THREADS);
  const uint32_t* w = (const uint32_t*)words;
  const uint32_t* nw = (const uint32_t*)nwords;
  const uint32_t* st = (const uint32_t*)starts;
  if (wide)
    extract_needles_wide<<<blocks, EN_THREADS, 0, (cudaStream_t)stream>>>(
        w, nw, has_n, st, B, Ln, limit, text_last, (uint8_t*)out);
  else
    extract_needles_small<<<blocks, EN_THREADS, 0, (cudaStream_t)stream>>>(
        w, nw, has_n, st, B, Ln, limit, text_last, (uint8_t*)out);
  return (int)cudaGetLastError();
}
