// One bidirectional FMD search step of every state by every character.
//
// Replaces: genmap_tpu/search/engine.py:_candidate_step_dir together with
// genmap_tpu/ops/rank.py:extend_core (exact: one paired row per bound),
// extend_core_fast (one paired row for both bounds, `far` when the interval
// leaves its 1024-symbol window), _occ_sub, _half_sub and _fmd_tail.
//
// Bound on the H100: the latency of dependent random row reads.  Each state
// reads one or two rank rows of 208 B (Dna4) or 276 B (Dna5) at an address
// that depends on its own interval; rows of neighbouring states are
// unrelated, so nothing coalesces and the 50 MB L2 holds only a slice of
// a genome's rows.  Arithmetic is a few dozen popcounts per bound.
//
// Design: one thread per state; a state only reads the words of its
// sub-row that lie before its position (the field and bit masks cut the
// rest), and inactive or invalid states read nothing.  Many states in
// flight per SM hide the row latency; that is the kernel's only defence
// in this first version (no shared-memory staging, no warp cooperation).
//
// Layouts: st [R, N] (flo, rlo, size, err[, plan]); out [R, N, A];
// valid2 [N, A]; far [N].  State i is in block i / per_block; its group is
// st[4][i] when R == 5 (search plan) or (i % per_block) / inner (tree node).

#include "genmap.cuh"

__global__ void candidate_step_kernel(
    const uint32_t* __restrict__ rows, int row_w, int subw,
    const uint32_t* __restrict__ C, const int32_t* __restrict__ st, int R,
    const uint8_t* __restrict__ valid, int64_t N, int64_t per_block,
    int64_t inner, int G, const uint8_t* __restrict__ nch_tab,
    const uint8_t* __restrict__ right_tab, const uint8_t* __restrict__ act_tab,
    const int32_t* __restrict__ u_tab, const int32_t* __restrict__ lreq_tab,
    int exact, int has_n, int A, int32_t* __restrict__ out,
    uint8_t* __restrict__ valid2, uint8_t* __restrict__ far_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t blk = i / per_block;
  int g = (R == 5) ? st[4 * N + i] : (int)((i % per_block) / inner);
  g = g < 0 ? 0 : (g >= G ? G - 1 : g);
  const uint8_t v = valid[i];

  if (!act_tab[g]) {  // inactive node: the state passes through unchanged
    for (int r = 0; r < R; ++r) {
      const int32_t x = st[r * N + i];
      for (int c = 0; c < A; ++c) out[(r * N + i) * A + c] = x;
    }
    for (int c = 0; c < A; ++c) valid2[i * A + c] = (c == 0) ? v : 0;
    far_out[i] = 0;
    return;
  }
  if (!v) {
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < A; ++c) out[(r * N + i) * A + c] = 0;
    for (int c = 0; c < A; ++c) valid2[i * A + c] = 0;
    far_out[i] = 0;
    return;
  }

  const uint32_t flo = (uint32_t)st[i];
  const uint32_t rlo = (uint32_t)st[N + i];
  const uint32_t size = (uint32_t)st[2 * N + i];
  const int32_t err = st[3 * N + i];
  const bool right = right_tab[g] != 0;
  const int nch = nch_tab[blk * G + g];
  const int32_t u = u_tab[g];
  const int32_t lreq = lreq_tab[g];

  const uint32_t mlo = right ? rlo : flo;  // the interval being LF-stepped
  const uint32_t olo = right ? flo : rlo;  // its companion's start
  const uint32_t hi = mlo + size;
  uint32_t occ_lo[5], occ_hi[5], s_lo, s_hi;
  bool far = false;
  if (exact) {
    gm_occ_sub(rows + (size_t)(mlo >> 9) * row_w, mlo, has_n, occ_lo, &s_lo);
    gm_occ_sub(rows + (size_t)(hi >> 9) * row_w, hi, has_n, occ_hi, &s_hi);
  } else {
    const uint32_t* row = rows + (size_t)(mlo >> 9) * row_w;
    const int d = (int)(hi >> 9) - (int)(mlo >> 9);
    far = d > 1;
    gm_occ_sub(row, mlo, has_n, occ_lo, &s_lo);
    gm_occ_sub(d > 0 ? row + subw : row, hi, has_n, occ_hi, &s_hi);
  }

  // FMD tail: descended-char intervals and companion offsets
  uint32_t nmlo[5], nsize[5], nolo[5];
  for (int c = 0; c < A; ++c) {
    nmlo[c] = C[c] + occ_lo[c];
    nsize[c] = occ_hi[c] - occ_lo[c];
  }
  const uint32_t sent_sl = s_hi - s_lo;
  const uint32_t o2 = nsize[3];
  const uint32_t o1 = o2 + nsize[2];
  const uint32_t o0 = o1 + nsize[1];
  nolo[0] = olo + sent_sl + o0;
  nolo[1] = olo + sent_sl + o1;
  nolo[2] = olo + sent_sl + o2;
  nolo[3] = olo + sent_sl;
  if (A == 5) nolo[4] = olo + sent_sl + o0 + nsize[0];

  const int64_t NA = N * (int64_t)A;
  for (int c = 0; c < A; ++c) {
    // right steps read the complement-permuted results (N maps to itself)
    const int pc = right ? (c == 4 ? 4 : 3 - c) : c;
    const uint32_t f = right ? nolo[pc] : nmlo[c];
    const uint32_t rr = right ? nmlo[pc] : nolo[c];
    const uint32_t sz = nsize[pc];
    const int32_t e2 = err + ((c != nch || nch == 4) ? 1 : 0);
    const bool ok = e2 <= u && e2 >= lreq && sz > 0u && !far;
    const int64_t o = i * A + c;
    out[o] = (int32_t)f;
    out[NA + o] = (int32_t)rr;
    out[2 * NA + o] = (int32_t)sz;
    out[3 * NA + o] = e2;
    if (R == 5) out[4 * NA + o] = g;
    valid2[o] = ok ? 1 : 0;
  }
  far_out[i] = far ? 1 : 0;
}

extern "C" int genmap_candidate_step(
    const void* rows, int row_w, int subw, const void* C, const void* st,
    int R, const void* valid, long long N, long long per_block,
    long long inner, int G, const void* nch, const void* right,
    const void* act, const void* u, const void* lreq, int exact, int has_n,
    int A, void* out, void* valid2, void* far, void* stream) {
  if (N == 0) return 0;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  candidate_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, row_w, subw, (const uint32_t*)C,
      (const int32_t*)st, R, (const uint8_t*)valid, (int64_t)N,
      (int64_t)per_block, (int64_t)inner, G, (const uint8_t*)nch,
      (const uint8_t*)right, (const uint8_t*)act, (const int32_t*)u,
      (const int32_t*)lreq, exact, has_n, A, (int32_t*)out,
      (uint8_t*)valid2, (uint8_t*)far);
  return (int)cudaGetLastError();
}
