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
// Output contract (what the kernel writes; every consumer reads no more):
//   valid2 [N, 16] and far [N]  written for every state;
//   out[:, i, :]                defined where state i is valid and consumes:
//                               all 16 slots on a dimer step (consume 2),
//                               slots 0..A-1 on a mono step (consume 1);
//   out[:, i, 0]                defined where state i is valid and passes
//                               through (consume 0 with with_pass: the
//                               state itself);
//   every other slot of out is undefined (left as allocated).
// compact reads operands only at slots whose valid2 is 1, a subset of the
// defined slots; `far` is read whole.
//
// Bound on the H100: bytes, counted as the data needs them (chip_smoke.py
// dimer_work): the validity of every state, valid2 and far of every state,
// and for the working states (valid and consuming) their rows and group
// tables, the 26 words a bound needs of its 64-word dimer sub-row (2 field
// words, 4 delta words, 16 cumulative counts, 4 mono counts) and their
// defined outputs.  At the escalation tiers' wide pools a few percent of
// the states work (67,294 of 3,145,728 in a (24,1) record call), so R x 16
// outputs for every state would be 90 % zeros that no consumer reads.  A
// working state's two sub-rows lie where its own interval puts them, so
// neighbouring states' reads do not coalesce.  Tensor cores and TMA do not
// apply: the work is integer popcounts over scattered 256-byte sub-rows,
// chosen by each state's own interval.
//
// Design: a warp takes tiles of 32 consecutive states, U tiles at a time
// (as many as leave a grid of DS_WAVES waves of resident blocks, at most
// DS_UMAX), loading their validity bytes together and OR-reducing them
// over the warp: a tile without a valid state writes its valid2 (one
// 16-byte store per state) and far and reads nothing else.  In a tile with
// one, each valid lane loads its state's row (the plan id of R = 5 among
// it) and then its group's tables: a valid passthrough copies its R values
// into slot 0, and a ballot gives the working states.
// Then the sixteen codes of each working state are spread over L =
// DS_LANES lanes, C = 16 / L codes each, 32 / L states per pass: lane j
// reads its C cumulative counts (the L lanes together: one 64-byte read),
// the delta and mono words of its codes and the two field words (a
// broadcast), for both bounds; it counts each of its codes among the fields
// before the bound with one nibble-equality mask and popcount per field
// word, and a local prefix plus an inclusive scan over the L lanes (both
// bounds packed in one word) gives L[t] (replacing a serial 16-step loop).
// A shuffle up gives L[t-1] at the lanes' edges, the lanes holding codes 3,
// 7, 11 and 15 give the mono thresholds to the mono candidates, and lane j
// stores its C slots of each output row: a row is one coalesced 64-byte
// store by the L lanes.  The state's valid2 bits and far go back to its own
// lane by a shuffle, and the warp writes valid2 and far of its 32 states
// last.
//
// Registers set occupancy, and occupancy the time of most call shapes
// more than any other choice measured (`chip_ab.py --kernels`, H100): the
// kernel asks for 6 resident blocks per SM, which caps it at 80 registers
// with nothing spilled.  Uncapped it takes 140 and ran 1.10-1.29x slower
// on every call of 65k states or more; capped at 64 (8 blocks, a few
// words spilled) it was within 6 % either way there and 6-10 % slower on
// small calls.  4 lanes per state won over 1, 8 and 16 on the largest,
// dense and mid-density calls; a lane per state was 1.12-2.26x slower on
// them, and 2 lanes 7 % faster on the largest call but 1.2-1.7x slower at
// mid densities and dense.  On small calls of ~10k states with full tiles
// a tile takes up to four passes, each a dependent read, and 1 or 2 lanes
// per state, or the previous design (a thread per state writing every
// slot), were up to 11 % faster there.  DS_LANES, DS_WAVES and
// DS_MIN_BLOCKS come from that sweep, which builds this file with them
// overridden (-D).
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

#define DS_FULL 0xFFFFFFFFu
#define DS_THREADS 128
#define DS_WARPS (DS_THREADS / 32)
#define DS_UMAX 16  // most tiles a warp loads the validity of at once
// lanes per working state (1, 2, 4, 8 or 16): 16 / DS_LANES codes each
#ifndef DS_LANES
#define DS_LANES 4
#endif
// least waves of resident blocks a grid keeps
#ifndef DS_WAVES
#define DS_WAVES 4
#endif
// least resident blocks per SM asked of the compiler (it caps registers)
#ifndef DS_MIN_BLOCKS
#define DS_MIN_BLOCKS 6
#endif

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

// W consecutive slots of an output row from v (4W-byte aligned).
template <int W>
__device__ __forceinline__ void ds_st(int32_t* __restrict__ p, const int32_t* v) {
  if constexpr (W == 1) {
    p[0] = v[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      reinterpret_cast<int4*>(p)[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                                v[4 * k + 3]);
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

// The call's arguments (one kernel parameter block).
struct DsArgs {
  const uint32_t* rows;
  int row_w;
  const uint32_t *C2, *C;
  const int32_t* st;
  int R;
  const uint8_t* valid;
  int64_t N, per_block, inner;
  int G;
  const uint8_t *consume_tab, *right_tab;
  const int32_t *u_mid_tab, *u_end_tab, *l_mid_tab, *l_end_tab;
  const uint8_t *ncha_tab, *nchb_tab;
  int exact, with_mono, with_pass, A;
  int32_t* out;
  uint8_t *valid2, *far_out;
  int U;  // tiles per warp at a time (<= DS_UMAX)
};

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

// The warp's nwork working states (lane of working rank k: order[k]), 32 / L
// at a time with L = 16 / C lanes each (lane j of a state takes codes C*j ..
// C*j + C - 1); returns to each working lane its valid2 bits (far in bit
// 16).
template <int C>
__device__ __forceinline__ uint32_t ds_coop(const DsArgs& a, int64_t tile, int lane,
                                            const uint8_t* order, int nwork, int rk,
                                            bool work, uint32_t mlo, uint32_t olo,
                                            uint32_t size, uint32_t err, int g,
                                            uint32_t rn, uint32_t res) {
  constexpr int L = 16 / C;   // lanes per state
  constexpr int GPW = 32 / L; // states per pass
  constexpr int NW = DsWords<C>::NW;
  const int q = lane / L;  // this lane's state in the pass
  const int j = lane % L;  // its lane in the state
  const int t0 = C * j;    // its first code
  const int64_t NS = a.N * (int64_t)GM_D_SLOTS;
  for (int base = 0; base < nwork; base += GPW) {
    const int k = base + q;
    const bool has = k < nwork;
    const int src = has ? order[k] : lane;
    const uint32_t smlo = __shfl_sync(DS_FULL, mlo, src);
    const uint32_t solo = __shfl_sync(DS_FULL, olo, src);
    const uint32_t ssize = __shfl_sync(DS_FULL, size, src);
    const int32_t serr = (int32_t)__shfl_sync(DS_FULL, err, src);
    const int sg = __shfl_sync(DS_FULL, g, src);
    const uint32_t srn = __shfl_sync(DS_FULL, rn, src);
    const int64_t si = (tile << 5) + src;
    const uint32_t hi = smlo + ssize;
    // the sub-rows of the two bounds (fast: the paired row at mlo; `far`
    // past its 256-symbol window)
    const uint32_t* lo_sub = a.rows + (size_t)(smlo >> 7) * a.row_w;
    const uint32_t* hi_sub;
    bool far_win = false;
    if (a.exact) {
      hi_sub = a.rows + (size_t)(hi >> 7) * a.row_w;
    } else {
      const int dq = (int)(hi >> 7) - (int)(smlo >> 7);
      hi_sub = dq > 0 ? lo_sub + GM_D_WIDTH : lo_sub;
      far_win = dq > 1;
    }
    DsWords<C> w0, w1;
    int32_t u_mid = 0, u_end = 0, l_mid = 0, l_end = 0;
    if (has) {
      ds_load<C>(lo_sub, smlo, j, w0);
      ds_load<C>(hi_sub, hi, j, w1);
      u_mid = a.u_mid_tab[sg];
      u_end = a.u_end_tab[sg];
      l_mid = a.l_mid_tab[sg];
      l_end = a.l_end_tab[sg];
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
      const uint32_t y = __shfl_up_sync(DS_FULL, incl, o, L);
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
    const uint32_t fb = __ballot_sync(DS_FULL, has && flag);
    const uint32_t gmask = ((1u << L) - 1u) << (L * q);
    // differences with code t - 1 (across the lane edge by a shuffle) and
    // the slice total at code 15
    uint32_t S[C];
#pragma unroll
    for (int c = 0; c < C; ++c) S[c] = L1[c] - L0[c];
    uint32_t Lp = 0u, Sp = 0u, S15 = S[C - 1];
    if constexpr (L > 1) {
      Lp = __shfl_up_sync(DS_FULL, L0[C - 1], 1, L);
      Sp = __shfl_up_sync(DS_FULL, S[C - 1], 1, L);
      if (j == 0) Lp = Sp = 0u;
      S15 = __shfl_sync(DS_FULL, S[C - 1], L - 1, L);
    }
    const bool far = (fb & gmask) != 0u || (a.exact ? S15 != ssize : far_win);
    const bool right = (srn & 1u) != 0;
    const bool mono = (srn & 2u) != 0;
    // the mono thresholds of y = 0..3 (code 4y + 3), gathered in every lane
    uint32_t Mlo[4], Ms[4];
    if (a.with_mono) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int wi = C >= 4 ? (((4 * y + 3) % C) >> 2) : 0;
        const uint32_t mlo_v = M0[wi], ms_v = M1[wi] - M0[wi];
        if constexpr (L > 1) {
          Mlo[y] = __shfl_sync(DS_FULL, mlo_v, (4 * y + 3) / C, L);
          Ms[y] = __shfl_sync(DS_FULL, ms_v, (4 * y + 3) / C, L);
        } else {
          Mlo[y] = mlo_v;
          Ms[y] = ms_v;
        }
      }
    }
    // this lane's candidates: row values of slots t0 .. t0 + C - 1
    int32_t vf[C], vr[C], vs[C], ve[C];
    uint32_t okb = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c;
      const uint32_t lprev = c ? L0[c - 1] : Lp;
      const uint32_t sprev = c ? S[c - 1] : Sp;
      uint32_t xm = a.C2[t] + (L0[c] - lprev);  // the stepped interval's start
      uint32_t xs = S[c] - sprev;               // its size
      uint32_t xo = solo + (S15 - S[c]);        // its companion's start
      int32_t e_mid;
      int32_t e2 = ds_errs(serr, srn, t, &e_mid);
      bool ok = e_mid <= u_mid && e_mid >= l_mid && e2 <= u_end && e2 >= l_end;
      if (a.with_mono && mono) {
        // mono candidate t (slots 0..A-1); right steps read the
        // complement-permuted results (N maps to itself)
        const int pc = right ? (t == 4 ? 4 : 3 - t) : t;
        const int y = pc < 0 ? 0 : (pc > 3 ? 3 : pc);
        const uint32_t b_lo = y > 0 ? ds_sel4(Mlo, y - 1) : 0u;
        const uint32_t b_s = y > 0 ? ds_sel4(Ms, y - 1) : 0u;
        const uint32_t a_s = ds_sel4(Ms, y);
        const bool n_cand = pc == 4;  // N: impossible in unflagged rows
        xm = n_cand ? 0u : a.C[y] + (ds_sel4(Mlo, y) - b_lo);
        xs = n_cand ? 0u : a_s - b_s;
        xo = n_cand ? 0u : solo + (Ms[3] - a_s);
        const int na = (int)((srn >> 8) & 0xFFu);
        e2 = serr + ((t != na || na >= 4) ? 1 : 0);
        ok = t < a.A && e2 <= u_end && e2 >= l_end;
      }
      ok = ok && xs > 0u && !far;
      okb |= (ok ? 1u : 0u) << c;
      vf[c] = (int32_t)(right ? xo : xm);
      vr[c] = (int32_t)(right ? xm : xo);
      vs[c] = (int32_t)xs;
      ve[c] = e2;
    }
    // lane j stores its slots of each defined row (a mono step: slots < A)
    if (has) {
      constexpr int V = C < 4 ? C : 4;
      int32_t* o = a.out + si * GM_D_SLOTS + t0;
      int32_t vg[V];
#pragma unroll
      for (int c = 0; c < V; ++c) vg[c] = sg;
#pragma unroll
      for (int v = 0; v < C; v += V) {
        if (!mono || t0 + v + V <= a.A) {
          ds_st<V>(o + v, vf + v);
          ds_st<V>(o + v + NS, vr + v);
          ds_st<V>(o + v + 2 * NS, vs + v);
          ds_st<V>(o + v + 3 * NS, ve + v);
          if (a.R == 5) ds_st<V>(o + v + 4 * NS, vg);
        } else {
#pragma unroll
          for (int c = v; c < v + V; ++c) {
            if (t0 + c < a.A) {
              o[c] = vf[c];
              o[c + NS] = vr[c];
              o[c + 2 * NS] = vs[c];
              o[c + 3 * NS] = ve[c];
              if (a.R == 5) o[c + 4 * NS] = sg;
            }
          }
        }
      }
    }
    // the state's valid2 bits (OR over its lanes) and far, to its own lane
    uint32_t bits = (okb << t0) | (far ? 1u << 16 : 0u);
#pragma unroll
    for (int o = 1; o < L; o <<= 1) bits |= __shfl_xor_sync(DS_FULL, bits, o, L);
    const uint32_t got = __shfl_sync(DS_FULL, bits, ((rk - base) & (GPW - 1)) * L);
    if (work && rk >= base && rk < base + GPW) res = got;
  }
  return res;
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

__global__ void __launch_bounds__(DS_THREADS, DS_MIN_BLOCKS) dimer_step_kernel(const DsArgs a) {
  __shared__ uint8_t order[DS_WARPS][32];  // lane of each working rank
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t N = a.N;
  const int R = a.R;
  const int32_t* __restrict__ st = a.st;
  const int64_t ntiles = (N + 31) >> 5;
  const int64_t nwarps = (int64_t)gridDim.x * DS_WARPS;
  for (int64_t first = ((int64_t)blockIdx.x * DS_WARPS + wib) * a.U; first < ntiles;
       first += nwarps * a.U) {
    // the validity of the warp's next U tiles, loaded together
    uint8_t vb[DS_UMAX];
#pragma unroll
    for (int u = 0; u < DS_UMAX; ++u) {
      const int64_t i = ((first + u) << 5) + lane;
      vb[u] = u < a.U && i < N ? a.valid[i] : 0;
    }
    uint32_t vbits = 0;
#pragma unroll
    for (int u = 0; u < DS_UMAX; ++u) vbits |= (vb[u] != 0 ? 1u : 0u) << u;
    const uint32_t any = __reduce_or_sync(DS_FULL, vbits);  // tiles with a valid state
    for (int u = 0; u < a.U; ++u) {
      const int64_t tile = first + u;
      if (tile >= ntiles) break;
      const int64_t i = (tile << 5) + lane;
      if (!((any >> u) & 1u)) {  // no valid state: valid2 and far are 0
        if (i < N) {
          *reinterpret_cast<int4*>(a.valid2 + i * GM_D_SLOTS) = make_int4(0, 0, 0, 0);
          a.far_out[i] = 0;
        }
        continue;
      }
      const bool v = (vbits >> u) & 1u;
      // a valid state's row (its plan id among it) and then its group's
      // tables, each set of loads issued together
      uint32_t flo = 0, rlo = 0, size = 0, err = 0, right = 0, nch = 0;
      int32_t plan = 0;
      int g = 0, cons = 2;
      if (v) {
        flo = (uint32_t)st[i];
        rlo = (uint32_t)st[N + i];
        size = (uint32_t)st[2 * N + i];
        err = (uint32_t)st[3 * N + i];
        if (R == 5) plan = st[4 * N + i];
        g = (R == 5) ? plan : (int)((i % a.per_block) / a.inner);
        g = g < 0 ? 0 : (g >= a.G ? a.G - 1 : g);
        const int64_t tab = (i / a.per_block) * a.G + g;
        cons = a.consume_tab[g];
        right = a.right_tab[g] != 0;
        nch = ((uint32_t)a.ncha_tab[tab] << 8) | ((uint32_t)a.nchb_tab[tab] << 16);
      }
      const bool pass = v && a.with_pass && cons == 0;
      const bool work = v && !pass;
      uint32_t res = 0;  // valid2 bits 0..15, far in bit 16
      if (pass) {        // passthrough: slot 0 is the state itself
        int32_t* o = a.out + i * GM_D_SLOTS;
        const int64_t NS = N * (int64_t)GM_D_SLOTS;
        o[0] = (int32_t)flo;
        o[NS] = (int32_t)rlo;
        o[2 * NS] = (int32_t)size;
        o[3 * NS] = (int32_t)err;
        if (R == 5) o[4 * NS] = plan;
        res = 1u;
      }
      const uint32_t wmask = __ballot_sync(DS_FULL, work);
      if (wmask) {
        uint32_t mlo = 0, olo = 0, rn = 0;
        if (work) {
          mlo = right ? rlo : flo;  // the interval being LF-stepped
          olo = right ? flo : rlo;  // its companion's start
          rn = right | ((a.with_mono && cons != 2) ? 2u : 0u) | nch;
        }
        const int nwork = __popc(wmask);
        const int rk = __popc(wmask & ((1u << lane) - 1u));
        if (work) order[wib][rk] = (uint8_t)lane;
        __syncwarp();
        res = ds_coop<16 / DS_LANES>(a, tile, lane, order[wib], nwork, rk, work, mlo, olo,
                                     size, err, g, rn, res);
        __syncwarp();  // `order` is rewritten by the warp's next tile
      }
      if (i < N) {
        gm_store_valid16(a.valid2 + i * GM_D_SLOTS, res & 0xFFFFu);
        a.far_out[i] = (uint8_t)((res >> 16) & 1u);
      }
    }
  }
}

// Blocks that fit on the card at once, per device (queried once: the map
// launches this kernel thousands of times).
static int64_t ds_resident_blocks() {
  static int64_t cache[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 16 && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dimer_step_kernel,
                                                    DS_THREADS, 0) != cudaSuccess)
    return 0;
  const int64_t n = (int64_t)sms * per_sm;
  if (dev < 16) cache[dev] = n;
  return n;
}

extern "C" int genmap_dimer_step(
    const void* rows, int row_w, const void* C2, const void* C, const void* st,
    int R, const void* valid, long long N, long long per_block,
    long long inner, int G, const void* consume, const void* right,
    const void* u_mid, const void* u_end, const void* l_mid, const void* l_end,
    const void* nchA, const void* nchB, int exact, int with_mono,
    int with_pass, int A, void* out, void* valid2, void* far, void* stream) {
  if (N == 0) return 0;
  if ((A != 4 && A != 5) || (R != 4 && R != 5)) return (int)cudaErrorInvalidValue;
  DsArgs a = {(const uint32_t*)rows, row_w, (const uint32_t*)C2, (const uint32_t*)C,
              (const int32_t*)st, R, (const uint8_t*)valid, (int64_t)N,
              (int64_t)per_block, (int64_t)inner, G, (const uint8_t*)consume,
              (const uint8_t*)right, (const int32_t*)u_mid, (const int32_t*)u_end,
              (const int32_t*)l_mid, (const int32_t*)l_end, (const uint8_t*)nchA,
              (const uint8_t*)nchB, exact, with_mono, with_pass, A, (int32_t*)out,
              (uint8_t*)valid2, (uint8_t*)far, 1};
  // U tiles per warp at a time: as many as leave the grid DS_WAVES waves
  // of resident blocks (few tiles per warp for a small call)
  const int64_t tiles = (a.N + 31) / 32;
  const int64_t resident = ds_resident_blocks();
  const int64_t U = resident > 0 ? tiles / (resident * DS_WARPS * DS_WAVES) : 1;
  a.U = (int)(U < 1 ? 1 : (U > DS_UMAX ? DS_UMAX : U));
  int64_t grid = (tiles + (int64_t)a.U * DS_WARPS - 1) / ((int64_t)a.U * DS_WARPS);
  if (grid > 0x7FFFFFFF) grid = 0x7FFFFFFF;
  dimer_step_kernel<<<(unsigned int)grid, DS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
