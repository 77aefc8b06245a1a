// The pooled infix scan's starting pool: one seed-table lookup per plan.
//
// Replaces: genmap_tpu/search/engine.py:_search_infix:529-555 (the seeded
// prefix; _search_infix_dimer:687-713 is the same code).  Every search plan
// opens with t_seed exact steps, so its state after them is the FMD
// interval of the needle window it consumed, read from the seed tables of
// genmap_tpu/ops/rank.py:with_seed_tables: per plan, the window's code and
// its reverse complement's, and gathers of seed_mlo[code],
// seed_size[code] and seed_mlo[rc_code].
//
// Bound on the H100, as chip_smoke.py counts it: bytes.  Per (block, plan)
// t_seed needle bytes and three 4-byte table reads; the [5, B, Fp] state
// and [B, Fp] validity outputs, every slot written.  A call moves at most
// about a megabyte, so its time is the launch and its dependent trips to
// memory: a_pos, the needle window, then the tables (random over
// ~4^t_seed entries, 179 MB per part at t_seed = 12: an HBM trip each).
//
// What held the first version back (a thread per (block, slot)): a 64-bit
// division per thread, and a plan's t_seed window bytes read as single-byte
// loads folded in a runtime loop.  What did not: its stores (neighbouring
// threads write neighbouring words of every plane, padding included) and
// its three independent table loads.
//
// Design: still a thread per (block, slot), so that the stores coalesce,
// with 32-bit index math (the slot count is checked below 2^31) and a
// 32-bit division by Fp.  A plan slot loads its a_pos, then the aligned
// words that hold its window (at most five, issued together, predicated
// on the window's length, so no byte past the row is read), funnel-shifts
// them into four window words, folds the codes four characters at a time
// (`sl_fold`: no chain through the characters) and issues its three table
// loads together.  A padding slot writes zeros, invalid, with plan id
// s % P as in the JAX package: every slot is written, since the padding
// costs a few hundred KB of coalesced stores that no load waits for.
// Without seed tables (t_seed = 0) a plan slot holds the whole index
// (size n_total).  A window that holds an N, or an empty interval, leaves
// the slot invalid.
//
// Measured on the card (chip_ab.py --busy and --kernels): the map's calls
// take their latency, ~3.5 us each.  This kernel is level with the parent
// per (24,1) map and 5 % faster per (100,2) map.  A serial fold of the
// same words was 5 % slower per (24,1) map (a chain of 15 predicated
// steps).  Staging each block's needle row in shared memory (8 lanes a
// block, one trip for the row and a_pos) was 0.92-1.04x the parent on
// isolated calls: it read the whole row, and its group stores coalesced
// less.  Passing the positions as launch parameters (the engine has them
// on the host) was 0.94-1.07x, no gain on the largest call.  SL_THREADS
// comes from chip_ab.py --kernels's sweep (-D override).

#include "genmap.cuh"

#ifndef SL_THREADS
#define SL_THREADS 256
#endif

#define SL_T_MAX 15

// The window's codes a word at a time, from its bytes in win (byte i of
// the window is byte i % 4 of win[i / 4]): each byte clamped to 3 (an N,
// 4, is flagged), its two bits packed with the first character lowest;
// that packing complemented is rc_code = sum (3 - w_i) 4^i, and reversed
// by pairs it is code = sum w_i 4^(t-1-i).  Returns whether the first t
// (1 <= t <= 15) bytes are all below 4.
__device__ __forceinline__ bool sl_fold(const uint32_t win[4], int t, uint32_t* code,
                                        uint32_t* rc) {
  uint32_t packed = 0, flags = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = win[k];
    const uint32_t g = x & 0xFCFCFCFCu;  // a byte's bits above its code
    const uint32_t hi = (((g & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | g) & 0x80808080u;
    uint32_t c = (x | ((hi >> 7) * 3u)) & 0x03030303u;  // byte >= 4: 3
    c = (c | (c >> 6)) & 0x000F000Fu;
    packed |= ((c | (c >> 12)) & 0xFFu) << (8 * k);
    uint32_t f = hi >> 7;  // one bit a flagged byte
    f = (f | (f >> 7)) & 0x00030003u;
    flags |= ((f | (f >> 14)) & 0xFu) << (4 * k);
  }
  const uint32_t cm = (1u << (2 * t)) - 1u;
  packed &= cm;
  *rc = packed ^ cm;
  uint32_t y = __brev(packed);
  y = ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
  *code = y >> (32 - 2 * t);
  return (flags & ((1u << t) - 1u)) == 0u;
}

__global__ void __launch_bounds__(SL_THREADS)
seed_lookup_kernel(const uint32_t* __restrict__ seed_mlo,
                   const uint32_t* __restrict__ seed_size,
                   const uint8_t* __restrict__ needles, int Ln,
                   const int32_t* __restrict__ a_pos, int P, int t_seed,
                   uint32_t off, uint32_t n_total, uint32_t n, int Fp,
                   int32_t* __restrict__ st, uint8_t* __restrict__ valid) {
  const uint32_t idx = blockIdx.x * SL_THREADS + threadIdx.x;
  if (idx >= n) return;
  const uint32_t b = idx / (uint32_t)Fp;
  const int s = (int)(idx - b * (uint32_t)Fp);
  uint32_t flo = 0, rlo = 0, size = 0;
  uint8_t ok = 0;
  if (s < P) {
    if (t_seed == 0) {
      size = n_total;
      ok = 1;
    } else {
      const uint8_t* w = needles + (size_t)b * Ln + __ldg(a_pos + s);
      const int head = (int)((uintptr_t)w & 3u);
      const uint32_t* wp = (const uint32_t*)(w - head);
      const int nw = (head + t_seed + 3) >> 2;  // words holding the window
      uint32_t raw[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) raw[k] = k < nw ? __ldg(wp + k) : 0u;
      uint32_t win[4];  // window bytes 4k .. 4k + 3
#pragma unroll
      for (int k = 0; k < 4; ++k)
        win[k] = __funnelshift_r(raw[k], raw[k + 1], 8 * head);
      uint32_t code, rc;
      const bool okw = sl_fold(win, t_seed, &code, &rc);
      const uint32_t f = __ldg(seed_mlo + off + code);
      const uint32_t z = __ldg(seed_size + off + code);
      const uint32_t q = __ldg(seed_mlo + off + rc);
      flo = f;
      size = z;
      rlo = q;
      ok = (okw && z != 0u) ? 1 : 0;
    }
  }
  st[idx] = (int32_t)flo;
  st[(size_t)n + idx] = (int32_t)rlo;
  st[2 * (size_t)n + idx] = (int32_t)size;
  st[3 * (size_t)n + idx] = 0;
  st[4 * (size_t)n + idx] = s < P ? s : s % P;
  valid[idx] = ok;
}

extern "C" int genmap_seed_lookup(const void* seed_mlo, const void* seed_size,
                                  const void* needles, int Ln, const void* a_pos,
                                  int P, int t_seed, unsigned int off,
                                  unsigned int n_total, int B, int Fp, void* st,
                                  void* valid, void* stream) {
  const int64_t n = (int64_t)B * Fp;
  if (n == 0) return 0;
  if (P < 1 || t_seed < 0 || t_seed > SL_T_MAX || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + SL_THREADS - 1) / SL_THREADS);
  seed_lookup_kernel<<<blocks, SL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seed_mlo, (const uint32_t*)seed_size,
      (const uint8_t*)needles, Ln, (const int32_t*)a_pos, P, t_seed, off,
      n_total, (uint32_t)n, Fp, (int32_t*)st, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
