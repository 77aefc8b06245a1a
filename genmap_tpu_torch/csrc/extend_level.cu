// Levels of the doubling-tree extension in one launch: every (block,
// node) frontier of a level takes its parent's states, runs all of the
// level's steps on chip, and hands its frontier to the next level, the
// tree's consecutive levels one after another in the same launch.
//
// Replaces: genmap_tpu/search/engine.py:_ext_phase (:907) and
// _ext_phase_fused (:1020), with the levels of _extend_to_kmers (:1124):
// per level the pmap gather of the parent frontiers, the cut or pad to the
// level's width, and per step the candidate step of every state
// (candidate_step.cu on the mono rows, dimer_step.cu on the dimer rows;
// the three kernels share one copy of the step's device functions,
// genmap.cuh) and the compaction of every (block, node) row (compact.cu),
// with the capacity and far flags and the candidate counts that the host
// loop ORs and reduces.  The results are those of that loop, bit for bit.
//
// What it keeps out of device memory: the host loop runs a level of T
// steps as two launches a step (the step, then compact), each step writing
// every state's outputs and validity and compact reading them back, with
// the needle characters and the parent frontiers gathered by PyTorch.
// Here a (block, node) frontier stays in shared memory from its level's
// cut to its last step; between levels the packed frontiers and their
// counts pass through a scratch buffer that stays in L2; the device reads
// the first level's parents once and writes the last level's frontiers
// once.
//
// Bound on the H100: latency.  A step is a chain of dependent reads (the
// state, then its rank sub-rows at addresses that its interval sets), and
// the frontiers are few and mostly small (one to 128 states each at the
// map's fast rungs, up to 4,096 at its exact mono rungs), so the card is
// filled by running every (block, node) frontier of a level at once, not
// by bytes.
//
// Design: a block of the grid per block of the batch, which runs the
// launch's levels in order (a barrier between two levels: a node's parent
// is another warp's).  A node's team is one warp on a level of Fe <= 128
// (the block's warps take the nodes m = w, w + W, ..., and the cut, steps
// and compaction need only warp collectives), or the whole block on a wider
// level (a node at a time, the warps sharing its passes; a block scan of
// the warps' counts places their results).  For its node the team
//   - cuts the parent frontier (node pmap[m] of the parent level) to the
//     level's width Fe: from the caller's frontiers a ballot over each 32
//     slots' validity places the first Fe valid states in order in shared
//     memory, from the scratch buffer the first Fe of the packed row; a
//     count past Fe raises the capacity flag;
//   - runs each step with its node's consume, side and needle positions
//     (the level's table): a passthrough (consume 0) keeps the frontier; a
//     mono step takes the frontier's states 32 / L a warp and pass, L = 32,
//     16, 8 or 4 lanes each by the frontier's size up to 8 states and one
//     lane each past it (candidate_step's two paths, cs_state); a dimer or
//     one-character step on the dimer rows 8 a warp and pass, 4 lanes each
//     (dimer_step's design, ds_state).  A scan of the states' candidate
//     counts over the pass's lane groups (and warps) gives every kept
//     candidate its rank in (state, slot) order, the order compact keeps;
//     the first Fe go to the other shared buffer (a count past Fe raises
//     the capacity flag; `far` the far flag; the count before the cut is
//     the step's occupancy);
//   - writes its frontier: packed with its count into the scratch buffer,
//     or on the last level with validity and zeros past its count (as
//     compact leaves a row).
// The block ORs its warps' flags and takes each level's largest occupancy
// in shared memory; one thread writes the block's cap, far and occ.  A
// warp a node measured 2.7x the device time of the block a node on the
// map's wide rungs (1,024-4,096 states, 128 serial passes a step at 4,096;
// `PERF.md` §6).
//
// Layouts: st [4, B, Mp, Fp] (flo, rlo, size, err) and valid [B, Mp, Fp]:
// the first level's parents; per level pmap [M] and tab [4, T, M] int32
// rows consume, right, posA, posB; needles [B, Ln]; out [4, B, M, Fe] and
// valid_out [B, M, Fe] of the last level; cap, far [B] bytes (inputs
// optional); occ [B, levels] int32 (optional); scratch: two packed
// frontiers [4, B, Ms, Fs] int32 with their counts [B, Ms].

#include "genmap.cuh"

#define EL_WARPS 8  // most warps (nodes at once) a block
// a level wider than this runs a node at a time on all of the block's
// warps (its passes spread over them), narrower ones a node a warp
#define EL_WIDE 128
#define EL_MAX_LEVELS 16  // most levels a launch runs (J up to 65,536)
// most dynamic shared memory a block takes (of the 227 KB a block may opt
// in to): two frontiers of a wide level up to Fe = 6,144
#define EL_SMEM_MAX 196608
// least resident blocks per SM asked of the compiler: it caps registers at
// 80, as dimer_step's 6 blocks of 128 threads do
#ifndef EL_MIN_BLOCKS
#define EL_MIN_BLOCKS 3
#endif
#define EL_DIMER_C 4  // codes per lane of a dimer state: 4 lanes a state
// a mono frontier of more states runs a lane per state (candidate_step's
// CS_COOP_MAX: past it the lanes' own reads beat cooperation)
#define EL_COOP_MAX 8

// One level: each node's parent, its steps' table, its width.
struct ElLevel {
  const int32_t *pmap, *tab;
  int T, M, Fe;
};

// The call's arguments (one kernel parameter block).
struct ElArgs {
  const uint32_t* rows;
  int row_w, subw;
  const uint32_t *C, *C2;
  int has_n, A, exact, errors;
  int64_t B;
  const int32_t* st;
  const uint8_t* valid;
  int64_t Mp, Fp;
  const uint8_t* needles;
  int64_t Ln;
  const uint8_t *cap_in, *far_in;
  int32_t* scratch;
  int64_t Ms, Fs;
  int32_t* out;
  uint8_t *valid_out, *cap_out, *far_out;
  int32_t* occ_out;
  int nlev;
  ElLevel lev[EL_MAX_LEVELS];
};

// A level's frontiers in device memory: rows of F slots, node m of block b
// at row b * M + m, the four state rows `rs` apart; with `valid` a byte per
// slot, else packed with a count per row (`cnt`).
struct ElRows {
  int32_t* st;
  uint8_t* valid;
  int32_t* cnt;
  int64_t rs, M, F;
};

// A frontier in shared memory: rows flo, rlo, size, err of Fe slots each.
struct ElFront {
  int32_t* s;
  int Fe;
  __device__ __forceinline__ int32_t* row(int r) const { return s + r * Fe; }
};

// Inclusive sum of `x` over the warp's lane groups of L lanes (every lane of
// a group holds its group's value), and the warp's total.
template <int L>
__device__ __forceinline__ int el_group_scan(int x, int lane, int* total) {
  int incl = x;
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(GM_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(GM_FULL, incl, 31);
  return incl;
}

// A node's team: one warp, or (WIDE) every warp of the block.  The team's
// sum of each warp's `x` before this warp's (warps in order), and *total
// the team's; a block team shares the warps' values through `s_tot` (every
// thread of the block calls it, in step).
template <bool WIDE>
__device__ __forceinline__ int el_team_scan(int x, int* s_tot, int* total) {
  if constexpr (!WIDE) {
    *total = x;
    return 0;
  } else {
    const int w = threadIdx.x >> 5, W = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) s_tot[w] = x;
    __syncthreads();
    int before = 0, all = 0;
    for (int i = 0; i < W; ++i) {
      const int y = s_tot[i];
      all += y;
      before += i < w ? y : 0;
    }
    __syncthreads();  // s_tot is rewritten by the next call
    *total = all;
    return before;
  }
}

template <bool WIDE>
__device__ __forceinline__ void el_team_sync() {
  if constexpr (WIDE) __syncthreads();
  else __syncwarp();
}

template <bool WIDE>
__device__ __forceinline__ bool el_team_any(bool x) {
  if constexpr (WIDE) return __syncthreads_or(x) != 0;
  else return __any_sync(GM_FULL, x);
}

// One mono step of the nv states of `cur` by the team (L lanes a state,
// 32 / L states a warp and pass): the first Fe kept candidates go to
// `nxt`; returns their count before the cut, and far.
template <int L, bool WIDE>
__device__ __forceinline__ int el_mono(const ElArgs& a, int lane, const ElFront& cur,
                                       const ElFront& nxt, int nv, uint32_t rn,
                                       int* s_tot, bool* far) {
  constexpr int GPW = 32 / L;
  const int q = lane / L, j = lane % L;
  const int tw = WIDE ? (int)(threadIdx.x >> 5) : 0;
  const int TW = WIDE ? (int)(blockDim.x >> 5) : 1;
  const bool right = (rn & 1u) != 0;
  int run = 0;
  uint32_t fa = 0;
  for (int base = 0; base < nv; base += GPW * TW) {
    const int k = base + GPW * tw + q;
    const bool has = k < nv;
    uint32_t flo = 0, rlo = 0, size = 0;
    int32_t err = 0;
    if (has) {
      flo = (uint32_t)cur.row(0)[k];
      rlo = (uint32_t)cur.row(1)[k];
      size = (uint32_t)cur.row(2)[k];
      err = cur.row(3)[k];
    }
    int32_t val[5][5];
    const uint32_t res =
        cs_state<L>(a.rows, a.row_w, a.subw, a.exact, a.has_n, a.C, a.A, has, j,
                    right ? rlo : flo, right ? flo : rlo, size, err, 0, rn, a.errors, 0, val);
    const uint32_t mask = res & 0x1Fu;
    fa |= res >> 7;
    const int cnt = __popc(mask);
    int wtot, total;
    const int incl = el_group_scan<L>(cnt, lane, &wtot);
    const int at = run + el_team_scan<WIDE>(wtot, s_tot, &total) + incl - cnt;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      if (c % L == j && ((mask >> c) & 1u)) {
        const int p = at + __popc(mask & ((1u << c) - 1u));
        if (p < cur.Fe) {
#pragma unroll
          for (int r = 0; r < 4; ++r) nxt.row(r)[p] = val[r][c];
        }
      }
    }
    run += total;
  }
  *far = el_team_any<WIDE>(fa != 0u);
  return run;
}

// One step on the dimer rows (consume 2, or 1 with `mono`) of the nv states
// of `cur` by the team (4 lanes a state), as el_mono.
template <bool WIDE>
__device__ __forceinline__ int el_dimer(const ElArgs& a, int lane, const ElFront& cur,
                                        const ElFront& nxt, int nv, uint32_t rn, bool mono,
                                        int* s_tot, bool* far) {
  constexpr int C = EL_DIMER_C, L = 16 / C, GPW = 32 / L;
  const int q = lane / L, j = lane % L, t0 = C * j;
  const int tw = WIDE ? (int)(threadIdx.x >> 5) : 0;
  const int TW = WIDE ? (int)(blockDim.x >> 5) : 1;
  const bool right = (rn & 1u) != 0;
  int run = 0;
  uint32_t fa = 0;
  for (int base = 0; base < nv; base += GPW * TW) {
    const int k = base + GPW * tw + q;
    const bool has = k < nv;
    uint32_t flo = 0, rlo = 0, size = 0;
    int32_t err = 0;
    if (has) {
      flo = (uint32_t)cur.row(0)[k];
      rlo = (uint32_t)cur.row(1)[k];
      size = (uint32_t)cur.row(2)[k];
      err = cur.row(3)[k];
    }
    int32_t vf[C], vr[C], vs[C], ve[C];
    const uint32_t bits = ds_state<C>(
        a.rows, a.row_w, a.exact, a.C2, a.C, a.A, mono, has, lane, right ? rlo : flo,
        right ? flo : rlo, size, err, rn, a.errors, a.errors, 0, 0, vf, vr, vs, ve);
    const uint32_t mask = bits & 0xFFFFu;
    fa |= bits >> 16;
    const int cnt = __popc(mask);
    int wtot, total;
    const int incl = el_group_scan<L>(cnt, lane, &wtot);
    const int at = run + el_team_scan<WIDE>(wtot, s_tot, &total) + incl - cnt;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c;
      if ((mask >> t) & 1u) {
        const int p = at + __popc(mask & ((1u << t) - 1u));
        if (p < cur.Fe) {
          nxt.row(0)[p] = vf[c];
          nxt.row(1)[p] = vr[c];
          nxt.row(2)[p] = vs[c];
          nxt.row(3)[p] = ve[c];
        }
      }
    }
    run += total;
  }
  *far = el_team_any<WIDE>(fa != 0u);
  return run;
}

// Node m of level `lv` for block b by its team (a warp, or with WIDE the
// block), from the parent frontiers `src` to `dst`; returns its flags (bit
// 0 capacity, bit 1 far) and *occ its occupancy.
template <bool DIMER, bool WIDE>
__device__ __forceinline__ uint32_t el_node(const ElArgs& a, const ElLevel& lv,
                                            const ElRows& src, const ElRows& dst,
                                            int64_t b, int m, int32_t* smem, int* s_tot,
                                            int* occ) {
  const int lane = threadIdx.x & 31;
  const int tid = WIDE ? (int)threadIdx.x : lane;  // the thread in its team
  const int NT = WIDE ? (int)blockDim.x : 32;
  const int Fe = lv.Fe;
  ElFront cur = {smem, Fe}, nxt = {smem + 4 * Fe, Fe};
  uint32_t flags = 0;
  // the cut: the parent's first Fe valid states, in order
  const int64_t prow = (b * src.M + lv.pmap[m]) * src.F;
  int n = 0;
  if (src.valid) {
    for (int64_t base = 0; base < src.F && n <= Fe; base += NT) {
      const int64_t f = base + tid;
      const bool v = f < src.F && src.valid[prow + f] != 0;
      const uint32_t bal = __ballot_sync(GM_FULL, v);
      int total;
      const int k = n + el_team_scan<WIDE>(__popc(bal), s_tot, &total) +
                    __popc(bal & ((1u << lane) - 1u));
      if (v && k < Fe) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cur.row(r)[k] = src.st[r * src.rs + prow + f];
      }
      n += total;
    }
  } else {
    n = src.cnt[b * src.M + lv.pmap[m]];
    for (int k = tid; k < n && k < Fe; k += NT) {
#pragma unroll
      for (int r = 0; r < 4; ++r) cur.row(r)[k] = src.st[r * src.rs + prow + k];
    }
  }
  if (n > Fe) flags |= 1u;
  int nv = n < Fe ? n : Fe;
  int oc = lv.T == 0 ? nv : 0;
  const int64_t TM = (int64_t)lv.T * lv.M;
  const uint8_t* nd = a.needles + b * a.Ln;
  for (int t = 0; t < lv.T; ++t) {
    const int64_t ti = (int64_t)t * lv.M + m;
    const int cons = lv.tab[ti];
    if (cons == 0) {  // passthrough: the frontier as it is
      oc = max(oc, nv);
      continue;
    }
    const uint32_t right = lv.tab[TM + ti] != 0 ? 1u : 0u;
    const uint32_t na = nd[lv.tab[2 * TM + ti]];
    el_team_sync<WIDE>();  // `cur` written, `nxt` free
    bool far;
    int run;
    if constexpr (DIMER) {
      const uint32_t nb = nd[lv.tab[3 * TM + ti]];
      const bool mono = cons == 1;
      run = el_dimer<WIDE>(a, lane, cur, nxt, nv,
                           right | (mono ? 2u : 0u) | (na << 8) | (nb << 16), mono, s_tot,
                           &far);
    } else {
      const uint32_t rn = right | (na << 8);
      run = nv <= 1   ? el_mono<32, WIDE>(a, lane, cur, nxt, nv, rn, s_tot, &far)
            : nv <= 2 ? el_mono<16, WIDE>(a, lane, cur, nxt, nv, rn, s_tot, &far)
            : nv <= 4 ? el_mono<8, WIDE>(a, lane, cur, nxt, nv, rn, s_tot, &far)
            : nv <= EL_COOP_MAX ? el_mono<4, WIDE>(a, lane, cur, nxt, nv, rn, s_tot, &far)
                                : el_mono<1, WIDE>(a, lane, cur, nxt, nv, rn, s_tot, &far);
    }
    if (far) flags |= 2u;
    if (run > Fe) flags |= 1u;
    oc = max(oc, run);
    nv = run < Fe ? run : Fe;
    const ElFront tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  el_team_sync<WIDE>();
  // the node's frontier: packed with its count, or (the last level) with
  // validity and zeros past its count
  const int64_t orow = b * dst.M + m;
  if (dst.valid) {
    for (int k = tid; k < Fe; k += NT) {
      const bool v = k < nv;
      dst.valid[orow * dst.F + k] = v ? 1 : 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) dst.st[r * dst.rs + orow * dst.F + k] = v ? cur.row(r)[k] : 0;
    }
  } else {
    for (int k = tid; k < nv; k += NT) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dst.st[r * dst.rs + orow * dst.F + k] = cur.row(r)[k];
    }
    if (tid == 0) dst.cnt[orow] = nv;
  }
  el_team_sync<WIDE>();  // the team's next node rewrites `cur`
  *occ = oc;
  return flags;
}

template <bool DIMER>
__device__ __forceinline__ void el_block(const ElArgs& a) {
  extern __shared__ int32_t el_smem[];
  __shared__ uint32_t s_flags;
  __shared__ int s_occ[EL_MAX_LEVELS];
  __shared__ int s_tot[EL_WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  if (threadIdx.x == 0) s_flags = 0u;
  if (threadIdx.x < EL_MAX_LEVELS) s_occ[threadIdx.x] = 0;
  __syncthreads();
  // a warp's region of shared memory (narrow levels): two frontiers of the
  // widest narrow level; a wide level's team takes the block's whole
  int Fn = 1;
  for (int l = 0; l < a.nlev; ++l)
    if (a.lev[l].Fe <= EL_WIDE) Fn = max(Fn, a.lev[l].Fe);
  // the scratch buffers: packed frontiers [4, B, Ms, Fs], counts [B, Ms]
  const int64_t SS = a.B * a.Ms * a.Fs;
  const ElRows first = {const_cast<int32_t*>(a.st), const_cast<uint8_t*>(a.valid), nullptr,
                        a.B * a.Mp * a.Fp, a.Mp, a.Fp};
  uint32_t flags = 0;
  for (int l = 0; l < a.nlev; ++l) {
    const ElLevel& lv = a.lev[l];
    ElRows src = first, dst;
    if (l > 0) {
      int32_t* buf = a.scratch + ((l - 1) & 1) * (4 * SS + a.B * a.Ms);
      src = {buf, nullptr, buf + 4 * SS, SS, a.Ms, a.Fs};
    }
    if (l == a.nlev - 1) {
      dst = {a.out, a.valid_out, nullptr, a.B * lv.M * lv.Fe, lv.M, lv.Fe};
    } else {
      int32_t* buf = a.scratch + (l & 1) * (4 * SS + a.B * a.Ms);
      dst = {buf, nullptr, buf + 4 * SS, SS, a.Ms, a.Fs};
    }
    int occ = 0;
    if (lv.Fe > EL_WIDE) {  // the block takes the nodes one at a time
      for (int m = 0; m < lv.M; ++m) {
        int oc;
        flags |= el_node<DIMER, true>(a, lv, src, dst, b, m, el_smem, s_tot, &oc);
        occ = max(occ, oc);
      }
    } else {  // a warp takes a node
      for (int m = w; m < lv.M; m += W) {
        int oc;
        flags |= el_node<DIMER, false>(a, lv, src, dst, b, m, el_smem + w * 8 * Fn, s_tot,
                                       &oc);
        occ = max(occ, oc);
      }
    }
    if (a.occ_out && lane == 0) atomicMax(&s_occ[l], occ);
    __syncthreads();  // the level's frontiers, before the next level reads them
  }
  if (lane == 0) atomicOr(&s_flags, flags);
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t f = s_flags;
    a.cap_out[b] = ((a.cap_in && a.cap_in[b]) || (f & 1u)) ? 1 : 0;
    a.far_out[b] = ((a.far_in && a.far_in[b]) || (f & 2u)) ? 1 : 0;
  }
  if (a.occ_out && (int)threadIdx.x < a.nlev)
    a.occ_out[b * a.nlev + threadIdx.x] = s_occ[threadIdx.x];
}

__global__ void __launch_bounds__(EL_WARPS * 32, EL_MIN_BLOCKS)
extend_level_mono_kernel(const ElArgs a) {
  el_block<false>(a);
}

__global__ void __launch_bounds__(EL_WARPS * 32, EL_MIN_BLOCKS)
extend_level_dimer_kernel(const ElArgs a) {
  el_block<true>(a);
}

// Lets the kernel take EL_SMEM_MAX of dynamic shared memory on the current
// device (once a device and kernel: a block above 48 KB needs the opt-in).
static bool el_opt_in(int dimer) {
  static bool done[16][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return false;
  if (!done[dev][dimer ? 1 : 0]) {
    const cudaError_t e =
        dimer ? cudaFuncSetAttribute(extend_level_dimer_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, EL_SMEM_MAX)
              : cudaFuncSetAttribute(extend_level_mono_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, EL_SMEM_MAX);
    if (e != cudaSuccess) return false;
    done[dev][dimer ? 1 : 0] = true;
  }
  return true;
}

extern "C" int genmap_extend_level(
    const void* rows, int row_w, int subw, const void* C, const void* C2, int has_n,
    int A, int dimer, int exact, int errors, const void* st, const void* valid,
    long long B, long long Mp, long long Fp, int nlev, const void* const* pmaps,
    const void* const* tabs, const int* Ts, const int* Ms, const int* Fes,
    const void* needles, long long Ln, const void* cap_in, const void* far_in,
    void* scratch, long long Msc, long long Fsc, void* out, void* valid_out,
    void* cap_out, void* far_out, void* occ_out, void* stream) {
  if (B == 0) return 0;
  if ((A != 4 && A != 5) || nlev < 1 || nlev > EL_MAX_LEVELS || Mp < 1 || Fp < 1 ||
      B > 0x7FFFFFFF || (nlev > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  ElArgs a = {(const uint32_t*)rows, row_w, subw, (const uint32_t*)C,
              (const uint32_t*)C2, has_n, A, exact, errors, (int64_t)B,
              (const int32_t*)st, (const uint8_t*)valid, (int64_t)Mp, (int64_t)Fp,
              (const uint8_t*)needles, (int64_t)Ln, (const uint8_t*)cap_in,
              (const uint8_t*)far_in, (int32_t*)scratch, (int64_t)Msc, (int64_t)Fsc,
              (int32_t*)out, (uint8_t*)valid_out, (uint8_t*)cap_out, (uint8_t*)far_out,
              (int32_t*)occ_out, nlev, {}};
  long long Mmax = 1, Fn = 1, Fw = 0;
  for (int l = 0; l < nlev; ++l) {
    if (Ms[l] < 1 || Fes[l] < 1 || Ts[l] < 0 ||
        (l < nlev - 1 && (Ms[l] > Msc || Fes[l] > Fsc)))
      return (int)cudaErrorInvalidValue;
    a.lev[l] = {(const int32_t*)pmaps[l], (const int32_t*)tabs[l], Ts[l], Ms[l], Fes[l]};
    Mmax = Ms[l] > Mmax ? Ms[l] : Mmax;
    if (Fes[l] > EL_WIDE) Fw = Fes[l] > Fw ? Fes[l] : Fw;
    else Fn = Fes[l] > Fn ? Fes[l] : Fn;
  }
  // warps a block: all EL_WARPS for a run with a wide level (its team is
  // the block), else at most the widest level's nodes; shared memory: two
  // frontiers of the widest narrow level a warp, or of the widest wide level
  const long long per_warp = 8LL * Fn * (long long)sizeof(int32_t);
  long long W = Fw ? EL_WARPS : (Mmax < EL_WARPS ? Mmax : EL_WARPS);
  const long long wide = 8LL * Fw * (long long)sizeof(int32_t);
  const size_t smem = (size_t)(W * per_warp > wide ? W * per_warp : wide);
  if (smem > EL_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && !el_opt_in(dimer)) return (int)cudaErrorInvalidValue;
  if (dimer) {
    extend_level_dimer_kernel<<<(unsigned int)B, (unsigned int)(32 * W), smem,
                                (cudaStream_t)stream>>>(a);
  } else {
    extend_level_mono_kernel<<<(unsigned int)B, (unsigned int)(32 * W), smem,
                               (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
