// One bidirectional FMD search step of every state by every character.
//
// Replaces: genmap_tpu/search/engine.py:_candidate_step_dir together with
// genmap_tpu/ops/rank.py:extend_core (exact: one paired row per bound),
// extend_core_fast (one paired row for both bounds, `far` when the interval
// leaves its 1024-symbol window), _occ_sub, _half_sub and _fmd_tail.
//
// Output contract (what the kernel writes; every consumer reads no more):
//   valid2 [N, A] and far [N]  written for every state;
//   out[:, i, :]               defined where state i is valid and active
//                              (all A candidates);
//   out[:, i, 0]               defined where state i is valid and passes
//                              through (an inactive group: the state itself);
//   every other slot of out is undefined (left as allocated).
// compact reads operands only at slots whose valid2 is 1, a subset of the
// defined slots; the seed-table build passes every state valid and active.
//
// Bound on the H100: bytes, counted as the data needs them.  The frontier
// that compact leaves is sparse (each row's valid states first, then
// zeros): at the map's largest call 7,643 of 3,145,728 states are valid,
// so the least work is the validity of every state, valid2 and far of
// every state, and the rows, rank sub-rows and outputs of the few working
// states (R x A outputs for every state would be 90 % zeros that no
// consumer reads).  A working state reads one or two rank sub-rows of 208 B
// (Dna4) or 276 B (Dna5) at addresses that depend on its interval, so
// neighbouring states' reads do not coalesce; several lanes per state
// keep more of those sectors in flight than one thread walking the words.
//
// Design: a warp takes tiles of 32 consecutive states, U tiles at a time
// (as many as leave a grid of CS_WAVES waves of resident blocks, at most
// CS_UMAX), loading their validity bytes together (coalesced 32-byte
// loads) and OR-reducing them over the warp: a tile without a valid state
// writes its valid2 (one 4-byte store per state for A = 4) and far and
// reads nothing else.  In a tile with one, each valid lane loads its
// state's row (the plan id of R = 5 among it) and its group's `act`; a
// valid inactive state copies its R values into candidate 0.  A ballot
// gives the working states (valid and active), whose lanes load their
// group tables.  Then:
//   few (at most CS_COOP_MAX): one pass, 32 / nwork lanes per state (4, 8,
//     16 or 32): lane j of a group popcounts words j, j + L, ... of the two
//     sub-rows' codes and bitvectors (only words before the bound's
//     offset), shuffles reduce the packed partial counts, every lane of
//     the group computes the FMD tail, lane r writes output row r (one
//     16-byte store for A = 4), and the state's valid2 bits and far go back
//     to its own lane by a shuffle;
//   many: each working lane reads its own state's sub-rows.
// The warp writes valid2 and far of its 32 states last.  CS_LANES,
// CS_COOP_MAX and CS_WAVES come from `chip_ab.py --kernels`'s sweep, which
// builds this file with them overridden (-D); a grid of one wave with each
// warp's tiles spread over the call measured up to 3x slower on sparse
// calls (its warps' strides aligned with the frontier's rows, so that a
// few warps got every working tile).

// Layouts: st [R, N] (flo, rlo, size, err[, plan]); out [R, N, A];
// valid2 [N, A]; far [N].  State i is in block i / per_block; its group is
// st[4][i] when R == 5 (search plan) or (i % per_block) / inner (tree node).

#include "genmap.cuh"

#define CS_FULL 0xFFFFFFFFu
#define CS_THREADS 128
#define CS_WARPS (CS_THREADS / 32)
#define CS_UMAX 16  // most tiles a warp loads the validity of at once
// lanes per cooperatively read state (4, 8, 16, 32), or 0: as many as one
// pass over the warp's working states allows (32 / nwork, rounded down)
#ifndef CS_LANES
#define CS_LANES 0
#endif
// a warp with more working states reads them a lane per state (0: always)
#ifndef CS_COOP_MAX
#define CS_COOP_MAX 8
#endif
// least waves of resident blocks a grid keeps
#ifndef CS_WAVES
#define CS_WAVES 4
#endif

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
    b.codes += __shfl_xor_sync(CS_FULL, b.codes, o);
    b.sn += __shfl_xor_sync(CS_FULL, b.sn, o);
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

// Output row r (a compile-time constant after unrolling) of state i.
__device__ __forceinline__ void cs_store(int32_t* __restrict__ out, int64_t N,
                                         int64_t i, int A, int r,
                                         const int32_t val[5][5]) {
  int32_t* dst = out + ((int64_t)r * N + i) * A;
  if (A == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(val[r][0], val[r][1], val[r][2], val[r][3]);
  } else {
#pragma unroll
    for (int c = 0; c < 5; ++c) dst[c] = val[r][c];
  }
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

// The call's arguments (one kernel parameter block).
struct CsArgs {
  const uint32_t* rows;
  int row_w, subw;
  const uint32_t* C;
  const int32_t* st;
  int R;
  const uint8_t* valid;
  int64_t N, per_block, inner;
  int G;
  const uint8_t *nch_tab, *right_tab, *act_tab;
  const int32_t *u_tab, *lreq_tab;
  int exact, has_n, A;
  int32_t* out;
  uint8_t *valid2, *far_out;
  int U;  // tiles per warp at a time (<= CS_UMAX)
};

// The warp's nwork working states (lane of working rank k: order[k]), 32 / L
// at a time, L lanes each; returns to each working lane its valid2 bits.
template <int L>
__device__ __forceinline__ uint32_t cs_coop(const CsArgs& a, int64_t tile, int lane,
                                            const uint8_t* order, int nwork, int rk,
                                            bool work, uint32_t mlo, uint32_t olo,
                                            uint32_t size, uint32_t err, int g,
                                            uint32_t rn, uint32_t res) {
  constexpr int GPW = 32 / L;
  const int q = lane / L;  // this lane's group in the warp
  const int j = lane % L;  // its lane in the group
  for (int base = 0; base < nwork; base += GPW) {
    const int k = base + q;
    const bool has = k < nwork;
    const int src = has ? order[k] : lane;
    const uint32_t smlo = __shfl_sync(CS_FULL, mlo, src);
    const uint32_t solo = __shfl_sync(CS_FULL, olo, src);
    const uint32_t ssize = __shfl_sync(CS_FULL, size, src);
    const int32_t serr = (int32_t)__shfl_sync(CS_FULL, err, src);
    const int sg = __shfl_sync(CS_FULL, g, src);
    const uint32_t srn = __shfl_sync(CS_FULL, rn, src);
    const int64_t si = (tile << 5) + src;
    const uint32_t hi = smlo + ssize;
    const uint32_t *lo_sub, *hi_sub;
    const bool far = cs_subrows(a.rows, a.row_w, a.subw, a.exact, smlo, hi, &lo_sub, &hi_sub);
    CsBound blo = {}, bhi = {};
    if (has) {
      blo = cs_part<L>(lo_sub, (int)(smlo & 511u), a.has_n, j);
      bhi = cs_part<L>(hi_sub, (int)(hi & 511u), a.has_n, j);
    }
    cs_reduce<L>(blo);
    cs_reduce<L>(bhi);
    uint32_t gres = 0;
    if (has) {
      uint32_t occ_lo[5], occ_hi[5], s_lo, s_hi;
      cs_occ(blo, smlo, occ_lo, &s_lo);
      cs_occ(bhi, hi, occ_hi, &s_hi);
      int32_t val[5][5];
      gres = cs_tail(a.C, a.A, occ_lo, occ_hi, s_lo, s_hi, solo, srn, serr, sg,
                     a.u_tab[sg], a.lreq_tab[sg], far, val);
      // lane r of the group writes output row r
#pragma unroll
      for (int r = 0; r < 5; ++r)
        if (r < a.R && r % L == j) cs_store(a.out, a.N, si, a.A, r, val);
    }
    // the state's own lane takes its valid2 bits and far
    const uint32_t got = __shfl_sync(CS_FULL, gres, ((rk - base) & (GPW - 1)) * L);
    if (work && rk >= base && rk < base + GPW) res = got;
  }
  return res;
}

__global__ void __launch_bounds__(CS_THREADS) candidate_step_kernel(const CsArgs a) {
  __shared__ uint8_t order[CS_WARPS][32];  // lane of each working rank
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t N = a.N;
  const int R = a.R, A = a.A;
  const int32_t* __restrict__ st = a.st;
  int32_t* __restrict__ out = a.out;
  const int64_t ntiles = (N + 31) >> 5;
  const int64_t nwarps = (int64_t)gridDim.x * CS_WARPS;
  // the warp's tiles come U consecutive ones at a time (a grid of several
  // waves of blocks, so that the card balances the working tiles)
  for (int64_t first = ((int64_t)blockIdx.x * CS_WARPS + wib) * a.U; first < ntiles;
       first += nwarps * a.U) {
    // their validity, loaded together (no load behind a branch on an
    // earlier one)
    uint8_t vb[CS_UMAX];
#pragma unroll
    for (int u = 0; u < CS_UMAX; ++u) {
      const int64_t i = ((first + u) << 5) + lane;
      vb[u] = u < a.U && i < N ? a.valid[i] : 0;
    }
    uint32_t vbits = 0;
#pragma unroll
    for (int u = 0; u < CS_UMAX; ++u) vbits |= (vb[u] != 0 ? 1u : 0u) << u;
    const uint32_t any = __reduce_or_sync(CS_FULL, vbits);  // tiles with a valid state
    for (int u = 0; u < a.U; ++u) {
      const int64_t tile = first + u;
      if (tile >= ntiles) break;
      const int64_t i = (tile << 5) + lane;
      if (!((any >> u) & 1u)) {  // no valid state: valid2 and far are 0
        if (i < N) {
          if (A == 4) *reinterpret_cast<uint32_t*>(a.valid2 + i * 4) = 0u;
          else for (int c = 0; c < A; ++c) a.valid2[i * A + c] = 0;
          a.far_out[i] = 0;
        }
        continue;
      }
      const bool v = (vbits >> u) & 1u;
      // a valid state's row, read at once (its plan id among it)
      uint32_t flo = 0, rlo = 0, size = 0, err = 0;
      int g = 0;
      if (v) {
        flo = (uint32_t)st[i];
        rlo = (uint32_t)st[N + i];
        size = (uint32_t)st[2 * N + i];
        err = (uint32_t)st[3 * N + i];
        g = (R == 5) ? st[4 * N + i] : (int)((i % a.per_block) / a.inner);
      }
      g = g < 0 ? 0 : (g >= a.G ? a.G - 1 : g);
      const bool act = v && a.act_tab[g] != 0;
      const bool work = v && act;
      uint32_t res = 0;  // valid2 bits 0..A-1, far in bit 7
      if (v && !act) {   // passthrough: candidate 0 is the state itself
        out[i * A] = (int32_t)flo;
        out[(N + i) * A] = (int32_t)rlo;
        out[(2 * N + i) * A] = (int32_t)size;
        out[(3 * N + i) * A] = (int32_t)err;
        if (R == 5) out[(4 * N + i) * A] = st[4 * N + i];
        res = 1u;
      }
      const uint32_t wmask = __ballot_sync(CS_FULL, work);
      if (wmask) {
        uint32_t mlo = 0, olo = 0, rn = 0;
        if (work) {
          const uint32_t right = a.right_tab[g] != 0;
          mlo = right ? rlo : flo;  // the interval being LF-stepped
          olo = right ? flo : rlo;  // its companion's start
          rn = right | ((uint32_t)a.nch_tab[(i / a.per_block) * a.G + g] << 8);
        }
        const int nwork = __popc(wmask);
        if (nwork > CS_COOP_MAX) {
          // many working states: each lane reads its own state's sub-rows
          if (work) {
            const uint32_t hi = mlo + size;
            const uint32_t *lo_sub, *hi_sub;
            const bool far =
                cs_subrows(a.rows, a.row_w, a.subw, a.exact, mlo, hi, &lo_sub, &hi_sub);
            const CsBound blo = cs_part<1>(lo_sub, (int)(mlo & 511u), a.has_n, 0);
            const CsBound bhi = cs_part<1>(hi_sub, (int)(hi & 511u), a.has_n, 0);
            uint32_t occ_lo[5], occ_hi[5], s_lo, s_hi;
            cs_occ(blo, mlo, occ_lo, &s_lo);
            cs_occ(bhi, hi, occ_hi, &s_hi);
            int32_t val[5][5];
            res = cs_tail(a.C, A, occ_lo, occ_hi, s_lo, s_hi, olo, rn, (int32_t)err, g,
                          a.u_tab[g], a.lreq_tab[g], far, val);
#pragma unroll
            for (int r = 0; r < 5; ++r)
              if (r < R) cs_store(out, N, i, A, r, val);
          }
        } else {
          // few: groups of lanes take them by shuffle
          const int rk = __popc(wmask & ((1u << lane) - 1u));
          if (work) order[wib][rk] = (uint8_t)lane;
          __syncwarp();
          const int lanes = CS_LANES ? CS_LANES
                          : nwork == 1 ? 32 : nwork == 2 ? 16 : nwork <= 4 ? 8 : 4;
#define CS_COOP(LL)                                                                \
  cs_coop<LL>(a, tile, lane, order[wib], nwork, rk, work, mlo, olo, size, err, g, rn, res)
          res = lanes == 32 ? CS_COOP(32) : lanes == 16 ? CS_COOP(16)
              : lanes == 8 ? CS_COOP(8) : CS_COOP(4);
#undef CS_COOP
          __syncwarp();  // `order` is rewritten by the warp's next tile
        }
      }
      if (i < N) {
        if (A == 4) {
          *reinterpret_cast<uint32_t*>(a.valid2 + i * 4) =
              (res & 1u) | ((res >> 1) & 1u) << 8 | ((res >> 2) & 1u) << 16 |
              ((res >> 3) & 1u) << 24;
        } else {
          for (int c = 0; c < A; ++c) a.valid2[i * A + c] = (uint8_t)((res >> c) & 1u);
        }
        a.far_out[i] = (uint8_t)(res >> 7);
      }
    }
  }
}

// Blocks that fit on the card at once, per device (queried once: the map
// launches this kernel ~11,000 times).
static int64_t cs_resident_blocks() {
  static int64_t cache[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 16 && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, candidate_step_kernel,
                                                    CS_THREADS, 0) != cudaSuccess)
    return 0;
  const int64_t n = (int64_t)sms * per_sm;
  if (dev < 16) cache[dev] = n;
  return n;
}

extern "C" int genmap_candidate_step(
    const void* rows, int row_w, int subw, const void* C, const void* st,
    int R, const void* valid, long long N, long long per_block,
    long long inner, int G, const void* nch, const void* right,
    const void* act, const void* u, const void* lreq, int exact, int has_n,
    int A, void* out, void* valid2, void* far, void* stream) {
  if (N == 0) return 0;
  if ((A != 4 && A != 5) || (R != 4 && R != 5)) return (int)cudaErrorInvalidValue;
  CsArgs a = {(const uint32_t*)rows, row_w, subw, (const uint32_t*)C,
              (const int32_t*)st, R, (const uint8_t*)valid, (int64_t)N,
              (int64_t)per_block, (int64_t)inner, G, (const uint8_t*)nch,
              (const uint8_t*)right, (const uint8_t*)act, (const int32_t*)u,
              (const int32_t*)lreq, exact, has_n, A, (int32_t*)out,
              (uint8_t*)valid2, (uint8_t*)far, 1};
  // U tiles per warp at a time: as many as leave the grid CS_WAVES waves
  // of resident blocks (few tiles per warp for a small call)
  const int64_t tiles = (a.N + 31) / 32;
  const int64_t resident = cs_resident_blocks();
  const int64_t U = resident > 0 ? tiles / (resident * CS_WARPS * CS_WAVES) : 1;
  a.U = (int)(U < 1 ? 1 : (U > CS_UMAX ? CS_UMAX : U));
  int64_t grid = (tiles + (int64_t)a.U * CS_WARPS - 1) / ((int64_t)a.U * CS_WARPS);
  if (grid > 0x7FFFFFFF) grid = 0x7FFFFFFF;
  candidate_step_kernel<<<(unsigned int)grid, CS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
