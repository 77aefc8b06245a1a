// SA rows to (sequence, position) by LF walks to a sampled row.
//
// Replaces: genmap_tpu/ops/rank.py:617 locate, with :589 bwt_char folded in
// (an XLA fori_loop of gathers on the TPU: `sampling` iterations over every
// row, each an indicator-bit test and, where the bit is clear, one LF step).
//
// Bound on the H100, as chip_smoke.py's locate_work counts it: per LF step
// the code words between the row's offset and the nearer end of its
// sub-row, counted for one code (a compare, a mask and a popcount each),
// the start counts of the sub-row and the next, the sentinel and N bit words
// on that side where the sub-row holds any, and one indicator word; per
// row its position, validity, final rank and answer.  The walks of one call
// touch a few thousand distinct sub-rows, which stay in L2, so the
// operations set the bound, not the bytes.
//
// What held the first version back (a thread per row): each LF step made
// two dependent trips to memory (the indicator word, and only then the
// sub-row), and one thread counted all four codes from up to ~50 scalar
// 4-byte loads of a sub-row that no neighbouring lane shared, so every warp
// load instruction asked the L1 for 32 unrelated sectors: the L1's sector
// rate set the time, not bytes or latency.
//
// Design: a thread walks a row.  In each step it issues at once, before it
// tests the indicator bit: the indicator word, p's code word, the start
// counts of its sub-row and of the next one (the paired row's second half)
// and the code words between p and the nearer end of the sub-row, as
// 16-byte loads where the stored row width keeps sub-rows 16-byte aligned
// (Dna4's 104 words; else 8-byte, as Dna5's 138): one trip to memory per
// step, and a row that is done ignores what it fetched.  It counts the one
// code of p, two words a popcount: below p from the sub-row's start counts,
// or (p in the second half) at and above p, subtracted from the next
// sub-row's start counts, so a step reads at most 16 code words, not 32.
// Sentinel and N bits (both stored as code 0) are read only where the two
// start counts differ, a second trip that few sub-rows take.  C stays in
// registers.  Measured on the H100 (chip_ab.py --kernels): LC_LANES lanes
// per row (2-8) split the code words and sum by shuffles, but every lane
// pays the step's fixed cost and the issue of instructions set their time
// (1.2-2.3x slower than a lane per row on L2-resident indexes); LC_WAVES > 0
// caps the grid so that a thread whose walk ends takes a new row, but the
// end of a walk (rank, answer, next row: three dependent reads) then
// stalls the other 31 walks of its warp (1.0-1.4x slower than a row per
// thread); LC_MIN_BLOCKS above 64 registers a thread spills (1.1-2.9x
// slower).  Tensor cores and TMA do not apply: nothing is a matrix
// product, and every address depends on the previous step's data, row by
// row.  `chip_ab.py --kernels` builds this file with LC_LANES, LC_THREADS,
// LC_WAVES and LC_MIN_BLOCKS overridden (-D).
//
// Exactness (the JAX semantics): `sampling` iterations; in each, a row
// whose indicator bit is set stops without a step; an LF step reads code 4
// where the N bit is set and code 0 for the sentinel (stored as 0); masks
// of 16 or more fields are the whole word; invalid rows take no step and
// read sample 0; vidx is clamped to n_samples - 1; i2 = sa_i2[vidx] +
// steps wraps mod 2^32.

#include "genmap.cuh"

#ifndef LC_LANES
#define LC_LANES 1
#endif
#ifndef LC_THREADS
#define LC_THREADS 128
#endif
#ifndef LC_WAVES
#define LC_WAVES 0
#endif
#ifndef LC_MIN_BLOCKS  // resident blocks per SM asked of the compiler (0: none)
#define LC_MIN_BLOCKS 0
#endif
#if LC_MIN_BLOCKS > 0
#define LC_BOUNDS __launch_bounds__(LC_THREADS, LC_MIN_BLOCKS)
#else
#define LC_BOUNDS __launch_bounds__(LC_THREADS)
#endif

static_assert(LC_LANES >= 1 && LC_LANES <= 32 && (LC_LANES & (LC_LANES - 1)) == 0,
              "LC_LANES is a power of two up to 32");
static_assert(LC_THREADS % 32 == 0, "LC_THREADS is a multiple of the warp");

#define LC_SUBW 52         // words of a Dna4 sub-row
#define LC_SUBW_N 69       // words of a Dna5 sub-row
#define LC_IND (1 + GM_BVWORDS)  // words of an indicator row

// VW consecutive words at p (16- or 8-byte aligned).  The load is volatile
// so that it is issued where it stands, before the indicator test, and not
// sunk behind it into the path that reads it.
template <int VW>
__device__ __forceinline__ void lc_load(const uint32_t* p, uint32_t (&w)[VW]) {
#if defined(__CUDA_ARCH__)
  if constexpr (VW == 4) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  }
#else
  struct alignas(4 * VW) Vec { uint32_t x[VW]; };
  const Vec v = *reinterpret_cast<const Vec*>(p);
  for (int j = 0; j < VW; ++j) w[j] = v.x[j];
#endif
}

__device__ __forceinline__ uint32_t lc_load1(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  uint32_t w;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(w) : "l"(p));
  return w;
#else
  return *p;
#endif
}

template <int L>
__device__ __forceinline__ uint32_t lc_sum(unsigned m, uint32_t v) {
#pragma unroll
  for (int d = L / 2; d >= 1; d /= 2) v += __shfl_xor_sync(m, v, d, L);
  return v;
}

// Fields of word w equal to the code whose 2-bit pattern repeated is pat,
// one bit per field (the even bits), within mask m.
__device__ __forceinline__ uint32_t lc_eq(uint32_t w, uint32_t pat, uint32_t m) {
  const uint32_t y = w ^ pat;
  return ~(y | (y >> 1)) & m;
}

// Words k..k+VW-1 at p into w: one VW-word load where p is aligned for it.
template <int VW, bool ALIGNED>
__device__ __forceinline__ void lc_load_any(const uint32_t* p, uint32_t (&w)[VW]) {
  if constexpr (ALIGNED) {
    lc_load<VW>(p, w);
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) w[j] = lc_load1(p + j);
  }
}

// A group of LC_LANES lanes (1 as built) walks one row at a time, in a
// grid-stride loop over the rows (one pass unless LC_WAVES caps the grid).
// A step counts the code of p in half a sub-row: below p from the
// sub-row's start counts (off < 256, or the last sub-row, whose pair is
// padding), else at and above p, subtracted from the next sub-row's start
// counts.  Lane l holds code vectors l, l + L, ... of that half.
template <int VW, bool HN>
__global__ void LC_BOUNDS
locate_kernel(const uint32_t* __restrict__ rows, int row_w,
              const uint32_t* __restrict__ C, const uint32_t* __restrict__ ind,
              const uint32_t* __restrict__ sa_i1, const uint32_t* __restrict__ sa_i2,
              int64_t n_samples, const uint32_t* __restrict__ pos,
              const uint8_t* __restrict__ valid, int64_t N, int sampling,
              uint32_t* __restrict__ i1, uint32_t* __restrict__ i2) {
  constexpr int L = LC_LANES;
  constexpr int SUBW = HN ? LC_SUBW_N : LC_SUBW;
  constexpr int HV = GM_SUBWORDS / 2 / VW;   // code vectors in half a sub-row
  constexpr int TC = (HV + L - 1) / L;       // of them per lane
  constexpr int IPL = (LC_IND + L - 1) / L;  // indicator words per lane (final rank)
  constexpr int BITW = 16;                   // words of a sub-row's bit vector
  constexpr uint32_t M55 = 0x55555555u;
  const int lane = (int)(threadIdx.x & (L - 1));
  const unsigned gm = L == 32 ? 0xFFFFFFFFu
                              : ((1u << (L & 31)) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(L - 1));
  const uint32_t c0 = C[0], c1 = C[1], c2 = C[2], c3 = C[3], c4 = C[4];
  const uint32_t last_sub = C[5] >> 9;  // the last sub-row: its pair is padding
  const int64_t stride = (int64_t)gridDim.x * (LC_THREADS / L);
  int64_t row = (int64_t)blockIdx.x * (LC_THREADS / L) + threadIdx.x / L;
  uint32_t p = 0, steps = 0;
  int it = 0;
  bool ok = false;
  if (row < N) {
    p = pos[row];
    ok = valid[row] != 0;
  }
  while (row < N) {
    bool fin = !ok;
    if (ok) {
      const uint32_t q = p >> 9;
      const int off = (int)(p & 511u), o7 = (int)(p & 127u), cw = off >> 4;
      const bool last = q == last_sub;
      const bool hi = off >= 256;          // p in the second half of its sub-row
      const bool up = hi && !last;
      const int h0 = hi ? HV : 0;          // the half whose code words are loaded
      const uint32_t* sub = rows + (size_t)q * row_w;
      const uint32_t* nxt = sub + SUBW;
      // one trip: the indicator word, p's code word, the start counts of
      // this sub-row and the next (and the N counts and p's N word), and
      // the code words between p and the counting end
      const uint32_t ib = lc_load1(ind + (size_t)(p >> 7) * LC_IND + 1 + (o7 >> 5));
      const uint32_t cwd = lc_load1(sub + cw);
      uint32_t b[4], bn[4];
      if constexpr (VW == 4) {
        lc_load<4>(sub + GM_S_LE, b);
      } else {
        lc_load<2>(sub + GM_S_LE, *reinterpret_cast<uint32_t(*)[2]>(b));
        lc_load<2>(sub + GM_S_LE + 2, *reinterpret_cast<uint32_t(*)[2]>(b + 2));
      }
      lc_load_any<4, (SUBW + GM_S_LE) % 4 == 0 && VW == 4>(nxt + GM_S_LE, bn);
      uint32_t ncn = 0, nnx = 0, nwd = 0;
      if constexpr (HN) {
        ncn = lc_load1(sub + GM_S_NCNT);
        nnx = lc_load1(nxt + GM_S_NCNT);
        nwd = lc_load1(sub + GM_S_NBITS + (off >> 5));
      }
      uint32_t w[TC][VW];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const int v = lane + L * t;
        const int k0 = VW * (h0 + v);
        if (v < HV && (up ? k0 + VW - 1 > cw : k0 < cw)) {
          lc_load<VW>(sub + k0, w[t]);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) w[t][j] = 0u;
        }
      }
      if ((ib >> (o7 & 31)) & 1u) {
        fin = true;  // a sampled row: no step
      } else {
        const bool hs = last || b[3] != bn[3];                // a sentinel in this sub-row
        const bool hn = HN && (last || ncn != nnx);           // an N in it
        const uint32_t c = (hn && ((nwd >> (off & 31)) & 1u)) ? 4u
                                                              : (cwd >> ((off & 15) * 2)) & 3u;
        const uint32_t pat = (c & 3u) * M55;
        // loc: fields of code c below p (forward) or at and above it
        // (backward) in this sub-row, two words a popcount
        uint32_t loc = 0;
        if (c < 4u) {
#pragma unroll
          for (int t = 0; t < TC; ++t) {
            const bool mine = lane + L * t < HV;
            const int k0 = VW * (h0 + lane + L * t);
#pragma unroll
            for (int j = 0; j < VW; j += 2) {
              const bool in0 = mine && (up ? k0 + j > cw : k0 + j < cw);
              const bool in1 = mine && (up ? k0 + j + 1 > cw : k0 + j + 1 < cw);
              loc += __popc(lc_eq(w[t][j], pat, in0 ? M55 : 0u) |
                            (lc_eq(w[t][j + 1], pat, in1 ? M55 : 0u) << 1));
            }
          }
          if (lane == 0) {  // p's own word: fields below p, or p's and above
            const int f = off & 15;
            const uint32_t m = up ? M55 << (2 * f) : (f ? M55 >> (32 - 2 * f) : 0u);
            loc += __popc(lc_eq(cwd, pat, m));
          }
          if (hi && last) {  // the last sub-row, counted forward: its first half too
            for (int k = lane; k < GM_SUBWORDS / 2; k += L) loc += __popc(lc_eq(sub[k], pat, M55));
          }
        }
        // a second trip where this sub-row holds sentinels or N (both
        // stored as code 0): their bits on the same side of p
        if ((c == 0u && (hs || hn)) || c == 4u) {
          for (int m = lane; m < BITW; m += L) {
            const uint32_t bm = up ? ~gm_bit_mask(off, m) : gm_bit_mask(off, m);
            if (c == 0u && hs) loc -= __popc(sub[GM_S_SBITS + m] & bm);
            if (hn) {
              const uint32_t x = __popc(sub[GM_S_NBITS + m] & bm);
              loc += c == 4u ? x : 0u - x;
            }
          }
        }
        loc = lc_sum<L>(gm, loc);
        // occ[c] = the start count of c, plus loc (forward), or the next
        // sub-row's start count minus loc (backward)
        uint32_t le0 = b[0], le1 = b[1], le2 = b[2], sc = b[3], nc = ncn;
        uint32_t start = p - (uint32_t)off;
        if (up) {
          le0 = bn[0], le1 = bn[1], le2 = bn[2], sc = bn[3], nc = nnx;
          start += 512u;
        }
        const uint32_t base = c == 0u ? le0 - sc - nc : c == 1u ? le1 - le0
                              : c == 2u ? le2 - le1 : c == 3u ? start - le2 : nc;
        const uint32_t occ = up ? base - loc : base + loc;
        p = (c == 0u ? c0 : c == 1u ? c1 : c == 2u ? c2 : c == 3u ? c3 : c4) + occ;
        ++steps;
        fin = ++it == sampling;
      }
    }
    if (fin) {
      // the rank of p among the sampled rows (its indicator row was read by
      // the last test, unless the walk used every iteration), the answer,
      // and this group's next row
      uint32_t vidx = 0;
      if (ok) {
        const uint32_t* irow = ind + (size_t)(p >> 7) * LC_IND;
        const int o7 = (int)(p & 127u);
        uint32_t r = 0;
#pragma unroll
        for (int t = 0; t < IPL; ++t) {
          const int j = lane + L * t;
          if (j == 0) r += irow[0];
          else if (j < LC_IND) r += __popc(irow[j] & gm_bit_mask(o7, j - 1));
        }
        vidx = lc_sum<L>(gm, r);
        if ((int64_t)vidx >= n_samples) vidx = (uint32_t)(n_samples - 1);
      }
      if (lane == 0) {
        i1[row] = sa_i1[vidx];
        i2[row] = sa_i2[vidx] + steps;
      }
      row += stride;
      if (row < N) {
        p = pos[row];
        ok = valid[row] != 0;
        steps = 0;
        it = 0;
      }
    }
  }
}

// Blocks of one instantiation that fit on the card at once, per device.
template <int VW, bool HN>
static int64_t lc_resident_blocks() {
  static int64_t cache[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 16 && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, locate_kernel<VW, HN>,
                                                    LC_THREADS, 0) != cudaSuccess)
    return 0;
  const int64_t n = (int64_t)sms * per_sm;
  if (dev < 16) cache[dev] = n;
  return n;
}

template <int VW, bool HN>
static int lc_launch(const uint32_t* rows, int row_w, const uint32_t* C, const uint32_t* ind,
                     const uint32_t* sa_i1, const uint32_t* sa_i2, int64_t n_samples,
                     const uint32_t* pos, const uint8_t* valid, int64_t N, int sampling,
                     uint32_t* i1, uint32_t* i2, cudaStream_t s) {
  const int64_t per_block = LC_THREADS / LC_LANES;
  int64_t blocks = (N + per_block - 1) / per_block;
  if (LC_WAVES > 0) {
    const int64_t resident = lc_resident_blocks<VW, HN>();
    if (resident > 0 && blocks > resident * LC_WAVES) blocks = resident * LC_WAVES;
  }
  locate_kernel<VW, HN><<<(unsigned int)blocks, LC_THREADS, 0, s>>>(
      rows, row_w, C, ind, sa_i1, sa_i2, n_samples, pos, valid, N, sampling, i1, i2);
  return (int)cudaGetLastError();
}

extern "C" int genmap_locate(const void* rows, int row_w, int has_n,
                             const void* C, const void* ind, const void* sa_i1,
                             const void* sa_i2, long long n_samples,
                             const void* pos, const void* valid, long long N,
                             int sampling, void* i1, void* i2, void* stream) {
  if (N == 0) return 0;
  if (n_samples < 1 || sampling < 1) return (int)cudaErrorInvalidValue;
  // 16-byte vectors where every sub-row starts 16-byte aligned, else 8
  const uintptr_t base = (uintptr_t)rows;
  const int vw = (row_w % 4 == 0 && base % 16 == 0) ? 4
                 : (row_w % 2 == 0 && base % 8 == 0) ? 2 : 0;
  if (vw == 0) return (int)cudaErrorMisalignedAddress;
  const uint32_t* r = (const uint32_t*)rows;
  const uint32_t* c = (const uint32_t*)C;
  const uint32_t* in = (const uint32_t*)ind;
  const uint32_t* s1 = (const uint32_t*)sa_i1;
  const uint32_t* s2 = (const uint32_t*)sa_i2;
  const uint32_t* ps = (const uint32_t*)pos;
  const uint8_t* va = (const uint8_t*)valid;
  uint32_t* o1 = (uint32_t*)i1;
  uint32_t* o2 = (uint32_t*)i2;
  cudaStream_t s = (cudaStream_t)stream;
  if (vw == 4 && !has_n) return lc_launch<4, false>(r, row_w, c, in, s1, s2, n_samples, ps, va, N, sampling, o1, o2, s);
  if (vw == 4) return lc_launch<4, true>(r, row_w, c, in, s1, s2, n_samples, ps, va, N, sampling, o1, o2, s);
  if (!has_n) return lc_launch<2, false>(r, row_w, c, in, s1, s2, n_samples, ps, va, N, sampling, o1, o2, s);
  return lc_launch<2, true>(r, row_w, c, in, s1, s2, n_samples, ps, va, N, sampling, o1, o2, s);
}
