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

// A state's step (cs_state and its rank helpers) is in genmap.cuh, shared
// with extend_level.cu.
//
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
    int32_t val[5][5];
    const uint32_t gres = cs_state<L>(a.rows, a.row_w, a.subw, a.exact, a.has_n, a.C, a.A,
                                      has, j, smlo, solo, ssize, serr, sg, srn,
                                      has ? a.u_tab[sg] : 0, has ? a.lreq_tab[sg] : 0, val);
    if (has) {
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
            int32_t val[5][5];
            res = cs_state<1>(a.rows, a.row_w, a.subw, a.exact, a.has_n, a.C, A, true, 0,
                              mlo, olo, size, (int32_t)err, g, rn, a.u_tab[g],
                              a.lreq_tab[g], val);
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
