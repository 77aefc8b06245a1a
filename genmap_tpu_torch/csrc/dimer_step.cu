// One bidirectional FMD search step of every state on the DIMER rank rows:
// each state consumes 0, 1 or 2 pattern characters per row read.
//
// Replaces: genmap_tpu/search/engine.py:_candidate_step_fused together with
// genmap_tpu/ops/rank.py:_dimer_occ, _dimer_tail, extend_dimer (exact: one
// dimer row per bound, `far` when a sentinel/N-adjacent row lies inside the
// slice) and extend_dimer_fast (one paired row for both bounds, `far` when
// the interval leaves its 256-symbol window).
//
// Dimer sub-row layout (genmap_tpu_torch/index/fmindex.py build_dimer_rows),
// 128 symbols in 64 words, stored paired with the next sub-row:
//   w[0:16]   4-bit dimer codes, 8 per word (invalid rows stored as 0)
//   w[16:32]  L_0..L_15 at the sub-row start (#rows with a valid code <= t)
//   w[32:60]  per-16-symbol deltas, byte 16*(d-1)+t = #codes <= t in [0, 16d)
//   w[60:64]  mono les at the sub-row start; bit 31 of w[60] = sub-row flag
//
// Bound on the H100: the bytes written.  A valid consuming state reads
// 26 of a dimer sub-row's 64 words per bound (2 field words, 4 delta words,
// 16 cumulative and 4 mono counts) at addresses set by its own interval,
// and does 16 nibble-equality masks and popcounts per bound; but every
// state, invalid ones included, writes its 16 candidate slots (R x 64 B
// and 16 validity bytes), and at the wide pools of the escalation tiers a
// few percent of the states are valid, so the writes are nearly all the
// traffic.
//
// Design: one thread per state.  The 16 threshold counts of a bound come
// from one pass over the codes t = 0..15 (nibble-equality mask of t over
// the two field words of p's 16-symbol group, masked to the fields before
// p, popcount, running sum).  Then the 16 dimer candidates and (on mono
// steps) the A mono candidates are computed into registers, with the error
// counts of the first char (checked against the mid bounds) and of the
// pair.  A passthrough state is copied to all 16 slots and stays valid in
// slot 0.  A state's 16 slots of an output row are 64 contiguous bytes,
// stored as four 16-byte vectors (and its 16 validity bytes as one): the
// outputs, zeros of invalid states included, are most of the bytes the
// step moves, and scalar stores of them cost four times the instructions.
//
// Layouts: st [R, N] (flo, rlo, size, err[, plan]); out [R, N, 16];
// valid2 [N, 16]; far [N].  State i is in block i / per_block; its group is
// st[4][i] when R == 5 (search plan) or (i % per_block) / inner (tree node).

#include "genmap.cuh"

#define GM_D_CUM 16
#define GM_D_DELTA 32
#define GM_D_MONO 60
#define GM_D_WIDTH 64
#define GM_D_SLOTS 16

// Store the 16 slots of one output row of a state (64 B, 16-B aligned).
__device__ __forceinline__ void gm_store16(int32_t* __restrict__ dst, const int32_t v[16]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// Store one value into all 16 slots of an output row.
__device__ __forceinline__ void gm_fill16(int32_t* __restrict__ dst, int32_t x) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = make_int4(x, x, x, x);
}

// Store 16 validity bytes, bit c of `bits` giving slot c (16 B, aligned).
__device__ __forceinline__ void gm_store_valid16(uint8_t* __restrict__ dst, uint32_t bits) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[k] |= ((bits >> (4 * k + j)) & 1u) << (8 * j);
  }
  *reinterpret_cast<int4*>(dst) = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// Mask of the 4-bit fields < nf of one word (a shift by 32 is undefined).
__device__ __forceinline__ uint32_t gm_nibble_mask(int nf) {
  if (nf <= 0) return 0u;
  if (nf >= 8) return 0xFFFFFFFFu;
  return (1u << (4 * nf)) - 1u;
}

// Threshold counts at p from the 64-word dimer sub-row covering p
// (ops/rank.py _dimer_occ): L[t] = #rows < p with a valid code <= t,
// Lm[y] = #rows < p with a real char <= y; *flag = the sub-row is flagged.
__device__ __forceinline__ void gm_dimer_occ(const uint32_t* __restrict__ sub,
                                             uint32_t p, uint32_t L[16],
                                             uint32_t Lm[4], bool* flag) {
  const int off = (int)(p & 127u);
  const int d = off >> 4;
  const int tail = off & 15;
  const uint32_t m0 = gm_nibble_mask(tail) & 0x11111111u;
  const uint32_t m1 = gm_nibble_mask(tail - 8) & 0x11111111u;
  const uint32_t w0 = m0 ? sub[2 * d] : 0u;
  const uint32_t w1 = m1 ? sub[2 * d + 1] : 0u;
  uint32_t dsel[4] = {0u, 0u, 0u, 0u};
  if (d > 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dsel[k] = sub[GM_D_DELTA + 4 * (d - 1) + k];
  }
  const uint32_t mono0 = sub[GM_D_MONO];
  uint32_t run = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint32_t pat = 0x11111111u * (uint32_t)t;
    const uint32_t x0 = w0 ^ pat;
    const uint32_t x1 = w1 ^ pat;
    // a field equals t where all four of its bits are 0 after the xor;
    // fields at or past p are cut by the masks (so code 0 does not count
    // the zeroed fields there)
    run += __popc(~(x0 | (x0 >> 1) | (x0 >> 2) | (x0 >> 3)) & m0);
    run += __popc(~(x1 | (x1 >> 1) | (x1 >> 2) | (x1 >> 3)) & m1);
    const uint32_t inblk = ((dsel[t >> 2] >> (8 * (t & 3))) & 0xFFu) + run;
    L[t] = sub[GM_D_CUM + t] + inblk;
    if ((t & 3) == 3) {
      const uint32_t base = t == 3 ? (mono0 & 0x7FFFFFFFu) : sub[GM_D_MONO + (t >> 2)];
      Lm[t >> 2] = base + inblk;
    }
  }
  *flag = (mono0 >> 31) != 0u;
}

__global__ void dimer_step_kernel(
    const uint32_t* __restrict__ rows, int row_w, const uint32_t* __restrict__ C2,
    const uint32_t* __restrict__ C, const int32_t* __restrict__ st, int R,
    const uint8_t* __restrict__ valid, int64_t N, int64_t per_block,
    int64_t inner, int G, const uint8_t* __restrict__ consume_tab,
    const uint8_t* __restrict__ right_tab, const int32_t* __restrict__ u_mid_tab,
    const int32_t* __restrict__ u_end_tab, const int32_t* __restrict__ l_mid_tab,
    const int32_t* __restrict__ l_end_tab, const uint8_t* __restrict__ ncha_tab,
    const uint8_t* __restrict__ nchb_tab, int exact, int with_mono,
    int with_pass, int A, int32_t* __restrict__ out,
    uint8_t* __restrict__ valid2, uint8_t* __restrict__ far_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t blk = i / per_block;
  int g = (R == 5) ? st[4 * N + i] : (int)((i % per_block) / inner);
  g = g < 0 ? 0 : (g >= G ? G - 1 : g);
  const uint8_t v = valid[i];
  const int cons = consume_tab[g];
  const int64_t NS = N * (int64_t)GM_D_SLOTS;
  int32_t* o = out + i * GM_D_SLOTS;
  uint8_t* v2 = valid2 + i * GM_D_SLOTS;

  if (with_pass && cons == 0) {  // passthrough: the state stays in slot 0
    for (int r = 0; r < R; ++r) gm_fill16(o + r * NS, st[r * N + i]);
    gm_store_valid16(v2, v ? 1u : 0u);
    far_out[i] = 0;
    return;
  }
  if (!v) {
    for (int r = 0; r < R; ++r) gm_fill16(o + r * NS, 0);
    gm_store_valid16(v2, 0u);
    far_out[i] = 0;
    return;
  }

  const uint32_t flo = (uint32_t)st[i];
  const uint32_t rlo = (uint32_t)st[N + i];
  const uint32_t size = (uint32_t)st[2 * N + i];
  const int32_t err = st[3 * N + i];
  const bool right = right_tab[g] != 0;
  const int na = ncha_tab[blk * G + g];
  const int nb = nchb_tab[blk * G + g];
  const int32_t u_mid = u_mid_tab[g], u_end = u_end_tab[g];
  const int32_t l_mid = l_mid_tab[g], l_end = l_end_tab[g];

  const uint32_t mlo = right ? rlo : flo;  // the interval being LF-stepped
  const uint32_t olo = right ? flo : rlo;  // its companion's start
  const uint32_t hi = mlo + size;
  uint32_t L0[16], L1[16], Lm0[4], Lm1[4];
  bool f0, f1, far;
  if (exact) {
    gm_dimer_occ(rows + (size_t)(mlo >> 7) * row_w, mlo, L0, Lm0, &f0);
    gm_dimer_occ(rows + (size_t)(hi >> 7) * row_w, hi, L1, Lm1, &f1);
    far = f0 || f1 || (L1[15] - L0[15]) != size;
  } else {
    const uint32_t* row = rows + (size_t)(mlo >> 7) * row_w;
    const int dq = (int)(hi >> 7) - (int)(mlo >> 7);
    gm_dimer_occ(row, mlo, L0, Lm0, &f0);
    gm_dimer_occ(dq > 0 ? row + GM_D_WIDTH : row, hi, L1, Lm1, &f1);
    far = dq > 1 || f0 || f1;
  }
  const bool mono_step = with_mono && cons != 2;
  int32_t f[GM_D_SLOTS], rr[GM_D_SLOTS], sz[GM_D_SLOTS], e2[GM_D_SLOTS];
  uint32_t ok_bits = 0u;

  if (!mono_step) {  // 16 dimer candidates, code t = c2*4 + c1
    const uint32_t S15 = L1[15] - L0[15];
    uint32_t prev_lo = 0, prev_s = 0;
#pragma unroll
    for (int t = 0; t < GM_D_SLOTS; ++t) {
      const uint32_t s = L1[t] - L0[t];
      const uint32_t d_mlo = C2[t] + (L0[t] - prev_lo);
      const uint32_t d_size = s - prev_s;
      const uint32_t d_olo = olo + (S15 - s);
      prev_lo = L0[t];
      prev_s = s;
      // a left step consumes (c2, c1), a right step their complements
      const int c2 = t >> 2, c1 = t & 3;
      const int first = right ? 3 - c2 : c2;
      const int second = right ? 3 - c1 : c1;
      const int32_t e_mid = err + ((first != na || na >= 4) ? 1 : 0);
      e2[t] = e_mid + ((second != nb || nb >= 4) ? 1 : 0);
      const bool ok = e_mid <= u_mid && e_mid >= l_mid && e2[t] <= u_end &&
                      e2[t] >= l_end && d_size > 0u && !far;
      f[t] = (int32_t)(right ? d_olo : d_mlo);
      rr[t] = (int32_t)(right ? d_mlo : d_olo);
      sz[t] = (int32_t)d_size;
      ok_bits |= (ok ? 1u : 0u) << t;
    }
  } else {  // mono candidates in slots 0..A-1 (thresholds 3, 7, 11, 15)
    uint32_t m_mlo[5], m_size[5], m_olo[5];
    const uint32_t Sm3 = Lm1[3] - Lm0[3];
    uint32_t prev_lo = 0, prev_s = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint32_t s = Lm1[y] - Lm0[y];
      m_mlo[y] = C[y] + (Lm0[y] - prev_lo);
      m_size[y] = s - prev_s;
      m_olo[y] = olo + (Sm3 - s);
      prev_lo = Lm0[y];
      prev_s = s;
    }
    m_mlo[4] = m_size[4] = m_olo[4] = 0u;  // N: impossible in unflagged rows
#pragma unroll
    for (int c = 0; c < GM_D_SLOTS; ++c) {
      f[c] = rr[c] = sz[c] = e2[c] = 0;
      if (c < A) {
        // right steps read the complement-permuted results (N maps to itself)
        const int pc = right ? (c == 4 ? 4 : 3 - c) : c;
        const uint32_t mm = m_mlo[pc], ms = m_size[pc], mo = m_olo[pc];
        f[c] = (int32_t)(right ? mo : mm);
        rr[c] = (int32_t)(right ? mm : mo);
        sz[c] = (int32_t)ms;
        e2[c] = err + ((c != na || na >= 4) ? 1 : 0);
        const bool ok = e2[c] <= u_end && e2[c] >= l_end && ms > 0u && !far;
        ok_bits |= (ok ? 1u : 0u) << c;
      }
    }
  }
  gm_store16(o, f);
  gm_store16(o + NS, rr);
  gm_store16(o + 2 * NS, sz);
  gm_store16(o + 3 * NS, e2);
  if (R == 5) gm_fill16(o + 4 * NS, g);
  gm_store_valid16(v2, ok_bits);
  far_out[i] = far ? 1 : 0;
}

extern "C" int genmap_dimer_step(
    const void* rows, int row_w, const void* C2, const void* C, const void* st,
    int R, const void* valid, long long N, long long per_block,
    long long inner, int G, const void* consume, const void* right,
    const void* u_mid, const void* u_end, const void* l_mid, const void* l_end,
    const void* nchA, const void* nchB, int exact, int with_mono,
    int with_pass, int A, void* out, void* valid2, void* far, void* stream) {
  if (N == 0) return 0;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  dimer_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, row_w, (const uint32_t*)C2, (const uint32_t*)C,
      (const int32_t*)st, R, (const uint8_t*)valid, (int64_t)N,
      (int64_t)per_block, (int64_t)inner, G, (const uint8_t*)consume,
      (const uint8_t*)right, (const int32_t*)u_mid, (const int32_t*)u_end,
      (const int32_t*)l_mid, (const int32_t*)l_end, (const uint8_t*)nchA,
      (const uint8_t*)nchB, exact, with_mono, with_pass, A, (int32_t*)out,
      (uint8_t*)valid2, (uint8_t*)far);
  return (int)cudaGetLastError();
}
