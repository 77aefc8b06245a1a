// Shared layout constants and device helpers of the port's CUDA kernels,
// and one state's step on the mono rows (cs_state) and on the dimer rows
// (ds_state) with their rank helpers, shared by candidate_step.cu,
// dimer_step.cu and extend_level.cu.
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

#define GM_FULL 0xFFFFFFFFu

// ---------------------------------------------------------------------------
// The mono rank step (candidate_step.cu, extend_level.cu)
// ---------------------------------------------------------------------------

// One bound's words as lane j of an L-lane group reads them from the
// sub-row `sub` (offset `off`): `codes` packs the lane's counts of code 0,
// <= 1, <= 2 before off in 10-bit fields, `sn` its sentinels and Ns in
// 16-bit fields (each sum over the group is at most 511); every lane also
// holds the sub-row's absolute counts.  The word loop is unrolled with a
// guard per word: a runtime-bounded loop measured slower on the H100, and
// loading 8 or all of a lane's words before using any took 96-128
// registers and was slower again (`chip_ab.py --kernels`).
struct CsBound {
  uint32_t codes, sn, le0, le1, le2, scnt, ncnt;
};

template <int L>
__device__ __forceinline__ CsBound cs_part(const uint32_t* __restrict__ sub, int off,
                                           int has_n, int j) {
  CsBound b;
  b.le0 = sub[GM_S_LE + 0];
  b.le1 = sub[GM_S_LE + 1];
  b.le2 = sub[GM_S_LE + 2];
  b.scnt = sub[GM_S_SCNT];
  b.ncnt = has_n ? sub[GM_S_NCNT] : 0u;
  const int nw = (off + 15) >> 4;  // code words holding fields < off
  uint32_t l0 = 0, l1 = 0, l2 = 0;
#pragma unroll
  for (int m = 0; m < GM_SUBWORDS / L; ++m) {
    const int k = j + m * L;
    if (k < nw) {
      const uint32_t w = sub[k];
      const uint32_t hi = w >> 1;
      const uint32_t msk = gm_field_mask(off, k) & 0x55555555u;
      l0 += __popc(~(w | hi) & msk);
      l1 += __popc(~hi & msk);
      l2 += __popc(~(hi & w) & msk);
    }
  }
  const int nb = (off + 31) >> 5;  // bitvector words holding bits < off
  uint32_t s = 0, nc = 0;
#pragma unroll
  for (int m = 0; m < (16 + L - 1) / L; ++m) {
    const int k = j + m * L;
    if (k < nb) {
      const uint32_t bm = gm_bit_mask(off, k);
      s += __popc(sub[GM_S_SBITS + k] & bm);
      if (has_n) nc += __popc(sub[GM_S_NBITS + k] & bm);
    }
  }
  b.codes = l0 | (l1 << 10) | (l2 << 20);
  b.sn = s | (nc << 16);
  return b;
}

// Sums the partial counts over each L-lane group of the warp.
template <int L>
__device__ __forceinline__ void cs_reduce(CsBound& b) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    b.codes += __shfl_xor_sync(GM_FULL, b.codes, o);
    b.sn += __shfl_xor_sync(GM_FULL, b.sn, o);
  }
}

// occ / sentinel count before p from a bound's summed counts (the
// arithmetic of ops/rank.py _occ_sub).
__device__ __forceinline__ void cs_occ(const CsBound& b, uint32_t p, uint32_t occ[5],
                                       uint32_t* sent) {
  const uint32_t s = b.scnt + (b.sn & 0xFFFFu);
  const uint32_t nc = b.ncnt + (b.sn >> 16);
  const uint32_t le0 = b.le0 + (b.codes & 1023u) - s - nc;
  const uint32_t le1 = b.le1 + ((b.codes >> 10) & 1023u) - s - nc;
  const uint32_t le2 = b.le2 + (b.codes >> 20) - s - nc;
  const uint32_t le3 = p - s - nc;
  occ[0] = le0;
  occ[1] = le1 - le0;
  occ[2] = le2 - le1;
  occ[3] = le3 - le2;
  occ[4] = nc;
  *sent = s;
}

// The FMD tail of one working state from its two bounds' counts: val[r][c]
// is output row r of candidate c; returns the valid2 bits (far in bit 7).
__device__ __forceinline__ uint32_t cs_tail(const uint32_t* __restrict__ C, int A,
                                            const uint32_t occ_lo[5],
                                            const uint32_t occ_hi[5], uint32_t s_lo,
                                            uint32_t s_hi, uint32_t olo, uint32_t rn,
                                            int32_t err, int g, int32_t u, int32_t lreq,
                                            bool far, int32_t val[5][5]) {
  // descended-char intervals and companion offsets
  uint32_t nmlo[5], nsize[5], nolo[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    nmlo[c] = C[c < A ? c : 0] + occ_lo[c];
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
  nolo[4] = olo + sent_sl + o0 + nsize[0];
  const bool right = (rn & 1u) != 0;
  const int nch = (int)(rn >> 8);
  uint32_t res = far ? 0x80u : 0u;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    // right steps read the complement-permuted results (N maps to itself);
    // both indices are constants, so the arrays stay in registers
    const int cc = c == 4 ? 4 : 3 - c;
    const int32_t e2 = err + ((c != nch || nch == 4) ? 1 : 0);
    const uint32_t sz = right ? nsize[cc] : nsize[c];
    val[0][c] = (int32_t)(right ? nolo[cc] : nmlo[c]);
    val[1][c] = (int32_t)(right ? nmlo[cc] : nolo[c]);
    val[2][c] = (int32_t)sz;
    val[3][c] = e2;
    val[4][c] = g;
    if (c < A && e2 <= u && e2 >= lreq && sz > 0u && !far) res |= 1u << c;
  }
  return res;
}

// The sub-rows of a state's two bounds, and `far` (fast mode).
__device__ __forceinline__ bool cs_subrows(const uint32_t* __restrict__ rows, int row_w,
                                           int subw, int exact, uint32_t mlo,
                                           uint32_t hi, const uint32_t** lo_sub,
                                           const uint32_t** hi_sub) {
  *lo_sub = rows + (size_t)(mlo >> 9) * row_w;
  if (exact) {
    *hi_sub = rows + (size_t)(hi >> 9) * row_w;
    return false;
  }
  const int d = (int)(hi >> 9) - (int)(mlo >> 9);
  *hi_sub = d > 0 ? *lo_sub + subw : *lo_sub;
  return d > 1;
}

// One state's mono step (every candidate) by a group of L lanes (lane j of
// it; `has`: the group holds a state; every lane of the warp calls it, in
// step): the candidates' output rows in val (every lane of the group), and
// their valid2 bits with far in bit 7 (0 for an empty group).  `rn` packs
// the step as cs_tail reads it.
template <int L>
__device__ __forceinline__ uint32_t cs_state(const uint32_t* __restrict__ rows, int row_w,
                                             int subw, int exact, int has_n,
                                             const uint32_t* __restrict__ C, int A, bool has,
                                             int j, uint32_t mlo, uint32_t olo,
                                             uint32_t size, int32_t err, int g, uint32_t rn,
                                             int32_t u, int32_t lreq, int32_t val[5][5]) {
  const uint32_t hi = mlo + size;
  const uint32_t *lo_sub, *hi_sub;
  const bool far = cs_subrows(rows, row_w, subw, exact, mlo, hi, &lo_sub, &hi_sub);
  CsBound blo = {}, bhi = {};
  if (has) {
    blo = cs_part<L>(lo_sub, (int)(mlo & 511u), has_n, j);
    bhi = cs_part<L>(hi_sub, (int)(hi & 511u), has_n, j);
  }
  cs_reduce<L>(blo);
  cs_reduce<L>(bhi);
  if (!has) return 0u;
  uint32_t occ_lo[5], occ_hi[5], s_lo, s_hi;
  cs_occ(blo, mlo, occ_lo, &s_lo);
  cs_occ(bhi, hi, occ_hi, &s_hi);
  return cs_tail(C, A, occ_lo, occ_hi, s_lo, s_hi, olo, rn, err, g, u, lreq, far, val);
}

// ---------------------------------------------------------------------------
// The dimer rank step (dimer_step.cu, extend_level.cu)
// ---------------------------------------------------------------------------

#define GM_D_CUM 16
#define GM_D_DELTA 32
#define GM_D_MONO 60
#define GM_D_WIDTH 64
#define GM_D_SLOTS 16

// Mask of the 4-bit fields < nf of one word (a shift by 32 is undefined).
__device__ __forceinline__ uint32_t gm_nibble_mask(int nf) {
  if (nf <= 0) return 0u;
  if (nf >= 8) return 0xFFFFFFFFu;
  return (1u << (4 * nf)) - 1u;
}

// Bits of the fields of `w` equal to code t, among the fields of mask m
// (fields past the bound are cut by m, so code 0 does not count them).
__device__ __forceinline__ uint32_t gm_code_count(uint32_t w, uint32_t m, int t) {
  const uint32_t x = w ^ (0x11111111u * (uint32_t)t);
  return __popc(~(x | (x >> 1) | (x >> 2) | (x >> 3)) & m);
}

// W consecutive words from p (4W-byte aligned) by the widest loads.
template <int W>
__device__ __forceinline__ void ds_ld(const uint32_t* __restrict__ p, uint32_t* v) {
  if constexpr (W == 1) {
    v[0] = p[0];
  } else if constexpr (W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[k];
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }
}

// One of four values by a run-time index (selects: no local memory).
__device__ __forceinline__ uint32_t ds_sel4(const uint32_t v[4], int y) {
  return y == 0 ? v[0] : y == 1 ? v[1] : y == 2 ? v[2] : v[3];
}

// The words of one bound that lane j of a state needs for its C codes
// C*j .. C*j + C - 1: their cumulative counts, the delta and mono words
// holding them (one word per four codes), the two field words of the
// bound's 16-symbol group.
template <int C>
struct DsWords {
  static constexpr int NW = C >= 4 ? C / 4 : 1;
  uint32_t cum[C], dw[NW], mw[NW], f0, f1;
  int tail;
};

template <int C>
__device__ __forceinline__ void ds_load(const uint32_t* __restrict__ sub, uint32_t p, int j,
                                        DsWords<C>& w) {
  constexpr int NW = DsWords<C>::NW;
  const int off = (int)(p & 127u);
  const int d = off >> 4;
  w.tail = off & 15;
  const uint2 f = w.tail > 0 ? reinterpret_cast<const uint2*>(sub)[d] : make_uint2(0u, 0u);
  w.f0 = f.x;
  w.f1 = w.tail > 8 ? f.y : 0u;
  ds_ld<C>(sub + GM_D_CUM + C * j, w.cum);
  if (d > 0) {
    ds_ld<NW>(sub + GM_D_DELTA + 4 * (d - 1) + ((C * j) >> 2), w.dw);
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) w.dw[k] = 0u;
  }
  ds_ld<NW>(sub + GM_D_MONO + ((C * j) >> 2), w.mw);
}

// Packed per-state flags of a working state (`rn`): bit 0 a right step,
// bit 1 a mono step, bits 8-15 nchA, bits 16-23 nchB.  Returns the error
// count after the step's two chars of dimer code t (*e_mid: after the
// first).
__device__ __forceinline__ int32_t ds_errs(int32_t err, uint32_t rn, int t, int32_t* e_mid) {
  const bool right = (rn & 1u) != 0;
  const int na = (int)((rn >> 8) & 0xFFu), nb = (int)(rn >> 16);
  const int c2 = t >> 2, c1 = t & 3;
  // a left step consumes (c2, c1), a right step their complements
  const int first = right ? 3 - c2 : c2;
  const int second = right ? 3 - c1 : c1;
  *e_mid = err + ((first != na || na >= 4) ? 1 : 0);
  return *e_mid + ((second != nb || nb >= 4) ? 1 : 0);
}

// One state's dimer step (consume 1 or 2) by a group of L = 16 / C lanes
// (lane j takes codes C*j .. C*j + C - 1, at `lane` of the warp; `has`:
// the group holds a state; every lane of the warp calls it, in step): the
// values of the lane's slots in vf / vr / vs / ve (slot t0 + c), and the
// state's valid2 bits over all 16 slots with far in bit 16, in every lane
// of the group (0 for an empty group).  `srn` packs the step (ds_errs'
// `rn`); a mono step's slots 0..A-1 hold its A candidates.
template <int C>
__device__ __forceinline__ uint32_t ds_state(
    const uint32_t* __restrict__ rows, int row_w, int exact,
    const uint32_t* __restrict__ C2, const uint32_t* __restrict__ Cm, int A,
    int with_mono, bool has, int lane, uint32_t smlo, uint32_t solo, uint32_t ssize,
    int32_t serr, uint32_t srn, int32_t u_mid, int32_t u_end, int32_t l_mid,
    int32_t l_end, int32_t vf[C], int32_t vr[C], int32_t vs[C], int32_t ve[C]) {
  constexpr int L = 16 / C;  // lanes per state
  constexpr int NW = DsWords<C>::NW;
  const int q = lane / L;  // this lane's state in the warp's pass
  const int j = lane % L;  // its lane in the state
  const int t0 = C * j;    // its first code
  const uint32_t hi = smlo + ssize;
  // the sub-rows of the two bounds (fast: the paired row at mlo; `far`
  // past its 256-symbol window)
  const uint32_t* lo_sub = rows + (size_t)(smlo >> 7) * row_w;
  const uint32_t* hi_sub;
  bool far_win = false;
  if (exact) {
    hi_sub = rows + (size_t)(hi >> 7) * row_w;
  } else {
    const int dq = (int)(hi >> 7) - (int)(smlo >> 7);
    hi_sub = dq > 0 ? lo_sub + GM_D_WIDTH : lo_sub;
    far_win = dq > 1;
  }
  DsWords<C> w0, w1;
  if (has) {
    ds_load<C>(lo_sub, smlo, j, w0);
    ds_load<C>(hi_sub, hi, j, w1);
  } else {
    w0.tail = w1.tail = 0;
    w0.f0 = w0.f1 = w1.f0 = w1.f1 = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) w0.cum[c] = w1.cum[c] = 0u;
#pragma unroll
    for (int c = 0; c < NW; ++c) w0.dw[c] = w1.dw[c] = w0.mw[c] = w1.mw[c] = 0u;
  }
  // each code's count among the fields before the bound (at most 15 per
  // bound: the lo bound's in bits 0-15 of `run`, the hi bound's in bits
  // 16-31), its inclusive prefix over the lane's codes, and then over the
  // state's lanes before this one by a scan
  const uint32_t m00 = gm_nibble_mask(w0.tail) & 0x11111111u;
  const uint32_t m01 = gm_nibble_mask(w0.tail - 8) & 0x11111111u;
  const uint32_t m10 = gm_nibble_mask(w1.tail) & 0x11111111u;
  const uint32_t m11 = gm_nibble_mask(w1.tail - 8) & 0x11111111u;
  // L[t] of both bounds and the mono thresholds at codes 3, 7, 11, 15
  uint32_t L0[C], L1[C], M0[NW], M1[NW];
  uint32_t run = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = t0 + c;
    run += gm_code_count(w0.f0, m00, t) + gm_code_count(w0.f1, m01, t) +
           ((gm_code_count(w1.f0, m10, t) + gm_code_count(w1.f1, m11, t)) << 16);
    const int sh = 8 * (t & 3);
    const int wi = C >= 4 ? c >> 2 : 0;
    const uint32_t in0 = ((w0.dw[wi] >> sh) & 0xFFu) + (run & 0xFFFFu);
    const uint32_t in1 = ((w1.dw[wi] >> sh) & 0xFFu) + (run >> 16);
    L0[c] = w0.cum[c] + in0;
    L1[c] = w1.cum[c] + in1;
    if (C >= 4 ? (c & 3) == 3 : c == C - 1) {
      // bit 31 of the first mono word is the sub-row flag, not a count
      const uint32_t fm = t == 3 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
      M0[wi] = (w0.mw[wi] & fm) + in0;
      M1[wi] = (w1.mw[wi] & fm) + in1;
    }
  }
  // a flagged sub-row: bit 31 of its first mono word (held by lane 0)
  const bool flag = j == 0 && ((w0.mw[0] | w1.mw[0]) >> 31) != 0u;
  uint32_t incl = run;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    const uint32_t y = __shfl_up_sync(GM_FULL, incl, o, L);
    if (j >= o) incl += y;
  }
  const uint32_t excl = incl - run;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    L0[c] += excl & 0xFFFFu;
    L1[c] += excl >> 16;
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    M0[k] += excl & 0xFFFFu;
    M1[k] += excl >> 16;
  }
  const uint32_t fb = __ballot_sync(GM_FULL, has && flag);
  const uint32_t gmask = ((1u << L) - 1u) << (L * q);
  // differences with code t - 1 (across the lane edge by a shuffle) and
  // the slice total at code 15
  uint32_t S[C];
#pragma unroll
  for (int c = 0; c < C; ++c) S[c] = L1[c] - L0[c];
  uint32_t Lp = 0u, Sp = 0u, S15 = S[C - 1];
  if constexpr (L > 1) {
    Lp = __shfl_up_sync(GM_FULL, L0[C - 1], 1, L);
    Sp = __shfl_up_sync(GM_FULL, S[C - 1], 1, L);
    if (j == 0) Lp = Sp = 0u;
    S15 = __shfl_sync(GM_FULL, S[C - 1], L - 1, L);
  }
  const bool far = (fb & gmask) != 0u || (exact ? S15 != ssize : far_win);
  const bool right = (srn & 1u) != 0;
  const bool mono = (srn & 2u) != 0;
  // the mono thresholds of y = 0..3 (code 4y + 3), gathered in every lane
  uint32_t Mlo[4], Ms[4];
  if (with_mono) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int wi = C >= 4 ? (((4 * y + 3) % C) >> 2) : 0;
      const uint32_t mlo_v = M0[wi], ms_v = M1[wi] - M0[wi];
      if constexpr (L > 1) {
        Mlo[y] = __shfl_sync(GM_FULL, mlo_v, (4 * y + 3) / C, L);
        Ms[y] = __shfl_sync(GM_FULL, ms_v, (4 * y + 3) / C, L);
      } else {
        Mlo[y] = mlo_v;
        Ms[y] = ms_v;
      }
    }
  }
  // this lane's candidates: row values of slots t0 .. t0 + C - 1
  uint32_t okb = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = t0 + c;
    const uint32_t lprev = c ? L0[c - 1] : Lp;
    const uint32_t sprev = c ? S[c - 1] : Sp;
    uint32_t xm = C2[t] + (L0[c] - lprev);  // the stepped interval's start
    uint32_t xs = S[c] - sprev;               // its size
    uint32_t xo = solo + (S15 - S[c]);        // its companion's start
    int32_t e_mid;
    int32_t e2 = ds_errs(serr, srn, t, &e_mid);
    bool ok = e_mid <= u_mid && e_mid >= l_mid && e2 <= u_end && e2 >= l_end;
    if (with_mono && mono) {
      // mono candidate t (slots 0..A-1); right steps read the
      // complement-permuted results (N maps to itself)
      const int pc = right ? (t == 4 ? 4 : 3 - t) : t;
      const int y = pc < 0 ? 0 : (pc > 3 ? 3 : pc);
      const uint32_t b_lo = y > 0 ? ds_sel4(Mlo, y - 1) : 0u;
      const uint32_t b_s = y > 0 ? ds_sel4(Ms, y - 1) : 0u;
      const uint32_t a_s = ds_sel4(Ms, y);
      const bool n_cand = pc == 4;  // N: impossible in unflagged rows
      xm = n_cand ? 0u : Cm[y] + (ds_sel4(Mlo, y) - b_lo);
      xs = n_cand ? 0u : a_s - b_s;
      xo = n_cand ? 0u : solo + (Ms[3] - a_s);
      const int na = (int)((srn >> 8) & 0xFFu);
      e2 = serr + ((t != na || na >= 4) ? 1 : 0);
      ok = t < A && e2 <= u_end && e2 >= l_end;
    }
    ok = ok && xs > 0u && !far;
    okb |= (ok ? 1u : 0u) << c;
    vf[c] = (int32_t)(right ? xo : xm);
    vr[c] = (int32_t)(right ? xm : xo);
    vs[c] = (int32_t)xs;
    ve[c] = e2;
  }
  // the state's valid2 bits (OR over its lanes) and far
  uint32_t bits = (okb << t0) | (far ? 1u << 16 : 0u);
#pragma unroll
  for (int o = 1; o < L; o <<= 1) bits |= __shfl_xor_sync(GM_FULL, bits, o, L);
  return has ? bits : 0u;
}
