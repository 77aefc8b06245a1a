// The seed-table build: the FMD interval of every ACGT string of length
// 0..t0.
//
// Replaces: genmap_tpu/ops/rank.py:345 with_seed_tables (a jitted loop of
// t0 levels, each extend_all(:290, i.e. extend_core :259) of every string
// of the level by every character, then nm[:, :4].T.reshape(-1) into
// c-major order and one concatenate of all levels).
//
// The tables: seed_mlo / seed_size [(4^(t0+1) - 1) / 3] int32 holding
// uint32, levels back to back (level t at (4^t - 1) / 3).  Level 0 is
// (0, n_total).  Entry c * 4^t + code(w) of level t + 1 is the string c.w:
// C[c] + occ(c, lo) and occ(c, hi) - occ(c, lo) of the parent w = (lo,
// size), hi = lo + size, for c = A, C, G, T (a Dna5 index counts N in its
// rank rows but stores only ACGT children).  Empty intervals keep the mlo
// this formula gives (they are neither zeroed nor skipped); arithmetic
// wraps mod 2^32.  Each bound p reads the paired row at p >> 9 (the exact
// branch of candidate_step.cu's cs_subrows; hi may equal n_total, whose
// sub-row the index stores), and occ takes the values of the plain
// version's ops/rank.py _occ_sub.
//
// Bound on the H100, as chip_smoke.py counts it: bytes.  The tables
// written once and each rank sub-row that a parent's bound falls in read
// once (179 MB and ~20 MB for the 24 M-symbol main index at t0 = 12).  The
// strings of a level sit in lexicographic order, so their intervals rise
// with the entry: neighbouring threads read the same or neighbouring
// sub-rows, which stay in L1 / L2, and the writes are four coalesced
// streams.
//
// What held the first version back (a host loop over candidate_step): each
// level stacked its states, ran the exact step with R = 4 (four output rows
// of which the build reads two, five candidates on Dna5), sliced,
// concatenated and transposed into c-major order, and a final concatenate
// copied all 179 MB again: 137 PyTorch ops and 12 launches on the main
// index, 716 MB of peak device memory, and the host took ~4 ms to issue
// them while the card was busy ~1.4 ms (chip_ab.py --kernels, PR 12).
//
// Design: two kernels, no host sync and no PyTorch op between launches.
//   shallow  one launch for levels 0..L (L = min(t0, SB_SHALLOW)): a
//            thread per entry walks its string's t <= L steps from the
//            whole index, last character first (prepending c is one LF
//            step of both bounds: lo' = C[c] + occ(c, lo), hi' = C[c] +
//            occ(c, hi), the same uint32 values the level loop stores),
//            so the ~4^L strings of the small levels take one launch and
//            no level waits for the one before it;
//   level    one launch per deeper level t -> t + 1: a thread per parent
//            reads (lo, size) coalesced, counts the four characters at lo
//            and, where hi shares its sub-row, adds the counts of the
//            words in [lo, hi) to them (an empty interval adds nothing; a
//            wider one counts hi on its own), and writes the four children
//            at c * 4^t + w.
// A bound is counted over the nearer half of its sub-row (`sb_occ`: at
// and above p from the next sub-row's start counts when p is in the upper
// half, as locate.cu does), three popcounts a word, and the sentinel and
// N bit words only where the sub-row holds any: the first version of this
// kernel counted every bound from its sub-row's start and took 0.406 ms
// on the main index, 0.245 ms with sb_occ (its last level 0.115).  At t0 = 12 that is
// 1 + 12 - L launches.  Measured on the card (chip_ab.py --kernels):
// SB_SHALLOW 8 and SB_THREADS 128 beat 6 and 256 by 0.4-2 % on the main
// and 64 Mbp indexes and by up to 1.3x on the Dna5 one, SB_SHALLOW 10 is
// 2.1-4.7x slower (1.4 M walks of 10 steps), and a variant that stepped
// two levels a thread (children and grandchildren from registers, half
// the deep launches) 1.05-1.4x slower, so it was dropped.  SB_SHALLOW and
// SB_THREADS are -D overrides for that sweep.

#include "genmap.cuh"

#ifndef SB_SHALLOW
#define SB_SHALLOW 8
#endif
#ifndef SB_THREADS
#define SB_THREADS 128
#endif

#define SB_T_MAX 15

static_assert(SB_SHALLOW >= 0 && SB_SHALLOW <= SB_T_MAX, "SB_SHALLOW is a level");

__host__ __device__ __forceinline__ int64_t sb_offset(int t) {
  return (((int64_t)1 << (2 * t)) - 1) / 3;
}

// The sub-row covering position p (the first half of the paired row).
__device__ __forceinline__ const uint32_t* sb_sub(const uint32_t* __restrict__ rows,
                                                  int row_w, uint32_t p) {
  return rows + (size_t)(p >> 9) * row_w;
}

// Counts over the 2-bit code fields of one word selected by the even-bit
// mask m (codes as stored: N and sentinel are 0): a = fields of a code
// above 0, b = of a code above 1, d = of code 3.
struct SbCnt {
  uint32_t a, b, d;
};

__device__ __forceinline__ void sb_add(SbCnt& c, uint32_t w, uint32_t m) {
  const uint32_t x = w & m, y = (w >> 1) & m;
  c.a += __popc(x | y);
  c.b += __popc(y);
  c.d += __popc(x & y);
}

// Set bits of the bitvector words v[0..15] at positions < off (below) or
// >= off (above).
__device__ __forceinline__ uint32_t sb_bits(const uint32_t* __restrict__ v, int off,
                                            bool above) {
  uint32_t n = 0;
  for (int k = above ? off >> 5 : 0; k < (above ? GM_SUBBITS : (off + 31) >> 5); ++k) {
    const uint32_t m = gm_bit_mask(off, k);
    n += __popc(v[k] & (above ? ~m : m));
  }
  return n;
}

// occ[0..3] before position p (ops/rank.py _occ_sub), counted over the nearer
// half of p's sub-row.  Below p from the sub-row's start counts, or, for p
// in the upper half of a sub-row that is not the index's last (the last
// one's tail is padding), at and above p, subtracted from the start counts
// of the next sub-row (the paired row's second half).  Sentinel and N bits
// are counted only where the two start counts differ, and always in the
// last sub-row.
__device__ __forceinline__ void sb_occ(const uint32_t* __restrict__ rows, int row_w,
                                       uint32_t last_sub, int has_n, uint32_t p,
                                       uint32_t occ[4]) {
  const uint32_t q = p >> 9;
  const uint32_t* sub = rows + (size_t)q * row_w;
  const uint32_t* nxt = sub + (row_w >> 1);
  const int off = (int)(p & 511u);
  const bool last = q == last_sub;
  const bool up = off >= 256 && !last;
  const uint32_t* base = up ? nxt : sub;
  SbCnt c = {0, 0, 0};
  const int kb = off >> 4;  // the word holding position off
  const uint32_t below = gm_field_mask(off, kb) & 0x55555555u;
  sb_add(c, sub[kb], up ? ~below & 0x55555555u : below);
  for (int k = up ? kb + 1 : 0; k < (up ? GM_SUBWORDS : kb); ++k) sb_add(c, sub[k], 0x55555555u);
  const uint32_t F = up ? 512u - (uint32_t)off : (uint32_t)off;  // fields counted
  // stored codes <= 0, <= 1, <= 2 before p
  const uint32_t L0 = up ? base[GM_S_LE + 0] - (F - c.a) : base[GM_S_LE + 0] + (F - c.a);
  const uint32_t L1 = up ? base[GM_S_LE + 1] - (F - c.b) : base[GM_S_LE + 1] + (F - c.b);
  const uint32_t L2 = up ? base[GM_S_LE + 2] - (F - c.d) : base[GM_S_LE + 2] + (F - c.d);
  uint32_t s = sub[GM_S_SCNT];
  if (last || nxt[GM_S_SCNT] != s) {
    const uint32_t n = sb_bits(sub + GM_S_SBITS, off, up);
    s = up ? nxt[GM_S_SCNT] - n : s + n;
  }
  uint32_t nc = 0;
  if (has_n) {
    nc = sub[GM_S_NCNT];
    if (last || nxt[GM_S_NCNT] != nc) {
      const uint32_t n = sb_bits(sub + GM_S_NBITS, off, up);
      nc = up ? nxt[GM_S_NCNT] - n : nc + n;
    }
  }
  occ[0] = L0 - s - nc;
  occ[1] = L1 - L0;
  occ[2] = L2 - L1;
  occ[3] = p - L2;
}

// occ[0..3] at lo + (offsets lo..hi of one sub-row): the counts of the
// words between the two offsets (off_lo <= off_hi < 512) added to occ, with
// sb_occ's arithmetic (sentinels and N are stored as code 0).
__device__ __forceinline__ void sb_occ_add(const uint32_t* __restrict__ sub, int off_lo,
                                           int off_hi, int has_n, uint32_t occ[4]) {
  uint32_t l0 = 0, l1 = 0, l2 = 0;
  for (int k = off_lo >> 4; k < (off_hi + 15) >> 4; ++k) {
    const uint32_t w = sub[k];
    const uint32_t hi = w >> 1;
    const uint32_t m = gm_field_mask(off_hi, k) & ~gm_field_mask(off_lo, k) & 0x55555555u;
    l0 += __popc(~(w | hi) & m);
    l1 += __popc(~hi & m);
    l2 += __popc(~(hi & w) & m);
  }
  uint32_t sn = 0;
  for (int k = off_lo >> 5; k < (off_hi + 31) >> 5; ++k) {
    const uint32_t m = gm_bit_mask(off_hi, k) & ~gm_bit_mask(off_lo, k);
    sn += __popc(sub[GM_S_SBITS + k] & m);
    if (has_n) sn += __popc(sub[GM_S_NBITS + k] & m);
  }
  const uint32_t d0 = l0 - sn, d1 = l1 - sn, d2 = l2 - sn;
  const uint32_t d3 = (uint32_t)(off_hi - off_lo) - sn;
  occ[0] += d0;
  occ[1] += d1 - d0;
  occ[2] += d2 - d1;
  occ[3] += d3 - d2;
}

// Levels 0..L: a thread per entry, walking its string from the whole index.
__global__ void __launch_bounds__(SB_THREADS)
seed_build_shallow_kernel(const uint32_t* __restrict__ rows, int row_w, uint32_t last_sub,
                          int has_n, const uint32_t* __restrict__ C, uint32_t n_total,
                          int L, uint32_t* __restrict__ mlo, uint32_t* __restrict__ size) {
  const int64_t e = (int64_t)blockIdx.x * SB_THREADS + threadIdx.x;
  if (e >= sb_offset(L + 1)) return;
  int t = 0;
  while (sb_offset(t + 1) <= e) ++t;
  const uint32_t code = (uint32_t)(e - sb_offset(t));
  uint32_t lo = 0, hi = n_total;
  for (int j = 0; j < t; ++j) {  // prepend the characters, last one first
    const int c = (int)((code >> (2 * j)) & 3u);
    uint32_t occ[4];
    sb_occ(rows, row_w, last_sub, has_n, lo, occ);
    const uint32_t nlo = C[c] + occ[c];
    sb_occ(rows, row_w, last_sub, has_n, hi, occ);
    hi = C[c] + occ[c];
    lo = nlo;
  }
  mlo[e] = lo;
  size[e] = hi - lo;
}

// The four children c.w of the interval (lo, size): their mlo and size.
__device__ __forceinline__ void sb_children(const uint32_t* __restrict__ rows, int row_w,
                                            uint32_t last_sub, int has_n,
                                            const uint32_t* __restrict__ C, uint32_t lo,
                                            uint32_t sz, uint32_t cmlo[4],
                                            uint32_t csize[4]) {
  const uint32_t hi = lo + sz;
  uint32_t occ_lo[4], occ_hi[4];
  sb_occ(rows, row_w, last_sub, has_n, lo, occ_lo);
  if ((hi >> 9) == (lo >> 9) && hi >= lo) {  // hi in lo's sub-row
#pragma unroll
    for (int c = 0; c < 4; ++c) occ_hi[c] = occ_lo[c];
    if (sz != 0u)
      sb_occ_add(sb_sub(rows, row_w, lo), (int)(lo & 511u), (int)(hi & 511u), has_n,
                 occ_hi);
  } else {
    sb_occ(rows, row_w, last_sub, has_n, hi, occ_hi);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cmlo[c] = C[c] + occ_lo[c];
    csize[c] = occ_hi[c] - occ_lo[c];
  }
}

// Level t -> t + 1: a thread per parent w, its children c.w at c * 4^t + w.
__global__ void __launch_bounds__(SB_THREADS)
seed_build_level_kernel(const uint32_t* __restrict__ rows, int row_w, uint32_t last_sub,
                        int has_n, const uint32_t* __restrict__ C, int t,
                        uint32_t* __restrict__ mlo, uint32_t* __restrict__ size) {
  const int64_t n = (int64_t)1 << (2 * t);
  const int64_t w = (int64_t)blockIdx.x * SB_THREADS + threadIdx.x;
  if (w >= n) return;
  const int64_t src = sb_offset(t) + w;
  uint32_t cmlo[4], csize[4];
  sb_children(rows, row_w, last_sub, has_n, C, mlo[src], size[src], cmlo, csize);
  const int64_t dst = sb_offset(t + 1) + w;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mlo[dst + c * n] = cmlo[c];
    size[dst + c * n] = csize[c];
  }
}

static unsigned int sb_grid(int64_t threads) {
  return (unsigned int)((threads + SB_THREADS - 1) / SB_THREADS);
}

// The deepest level the shallow launch fills (the wrapper plans its
// launches with it).
extern "C" int genmap_seed_build_depth(void) { return SB_SHALLOW; }

// Levels 0..L of the tables (L <= SB_T_MAX); rows: the nrows paired rank
// rows of row_w words.
extern "C" int genmap_seed_build_shallow(const void* rows, int row_w, int nrows, int has_n,
                                         const void* C, unsigned int n_total, int L,
                                         void* mlo, void* size, void* stream) {
  if (L < 0 || L > SB_T_MAX || nrows < 1) return (int)cudaErrorInvalidValue;
  seed_build_shallow_kernel<<<sb_grid(sb_offset(L + 1)), SB_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint32_t*)rows, row_w, (uint32_t)(nrows - 1), has_n, (const uint32_t*)C,
      n_total, L, (uint32_t*)mlo, (uint32_t*)size);
  return (int)cudaGetLastError();
}

// Level t + 1 of the tables from level t (t + 1 <= SB_T_MAX).
extern "C" int genmap_seed_build_level(const void* rows, int row_w, int nrows, int has_n,
                                       const void* C, int t, void* mlo, void* size,
                                       void* stream) {
  if (t < 0 || t >= SB_T_MAX || nrows < 1) return (int)cudaErrorInvalidValue;
  seed_build_level_kernel<<<sb_grid((int64_t)1 << (2 * t)), SB_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)rows, row_w, (uint32_t)(nrows - 1), has_n, (const uint32_t*)C, t,
      (uint32_t*)mlo, (uint32_t*)size);
  return (int)cudaGetLastError();
}
