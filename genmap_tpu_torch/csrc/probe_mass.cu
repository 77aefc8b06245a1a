// Unique-infix probe: per-plan survivor mass of every block and its skip bit.
//
// Replaces: the probe branch of genmap_tpu/search/engine.py:block_mapper_impl
// (mass_p, nwin and the skip test against probe_thresholds; an XLA one-hot
// product and sum on the TPU).
//
// Bound on the H100, as chip_smoke.py counts it: bytes.  A block reads its
// F validity bytes, and the size and plan rows of its valid slots (8 B
// each), and, for Dna5, its Ln needle bytes; it writes one skip byte (and
// P mass words when asked).  A call moves well under a megabyte, so the
// launch and two dependent trips (the validity, then the rows of the valid
// slots) set its time.
//
// What held the first version back: a warp per block whatever F (most
// lanes idle where F < 32), sixteen 64-bit accumulators a lane, and a
// 5-step 64-bit shuffle tree per plan, one plan after another.
//
// Design: a block is a segment of L lanes, the least power of two >= F (at
// most a warp), so a warp holds 32 / L blocks.  Lanes stride over the F
// survivor slots and add the size of each valid slot into a per-plan
// 64-bit accumulator (NP of them: the least of 4, 8, 16 that holds P; the
// plan count of e <= 4 is at most 7).  Where F <= PM_SPEC_F (a lane then
// holds one slot) the plan and size words are loaded beside the validity
// byte, a trip shorter at the price of the invalid slots' 8 bytes; the
// thresholds and the block's flags are loaded before the slots, and no
// branch waits on them until the slots are summed.  Masses are summed in
// 64 bits, so a block whose summed interval sizes pass 2^32 cannot wrap
// to a small mass and be skipped unsoundly (the JAX package sums in
// uint32); a written mass saturates at 2^32 - 1, which equals JAX's sum
// wherever that does not wrap.  For Dna5 the lanes also scan the needle
// row for code 4 (N), four bytes a word, and one ballot combines the
// segment.
//
// The combine depends on what the launch returns.  The map's launch (one
// part, the skip bit only) needs each mass only against thr[p], and the
// thresholds are 0 or 1: when every thr[p] < PM_CAP (the kernel reads thr
// itself, so no host knowledge is needed) each lane's masses saturate at
// PM_CAP and pack into bytes, four plans a word, and one REDUX (a full
// warp) or log2 L shuffles per word combine them; a sum of 32 lanes'
// bytes of at most 7 cannot carry into the next byte, and a saturated
// lane already makes its plan's total exceed thr[p].  Launches that
// return masses, sum over parts or test a threshold >= PM_CAP combine the
// exact 64-bit sums with a log2 L shuffle tree per plan.
//
// Multi-part indexes: the engine launches once per part.  acc_in (when
// given) is the running [B, P + 1] int64 sum of the earlier parts: the
// per-plan masses (each saturated at 2^32 - 1) and, in column P, their
// overflow and N-window flags ORed.  A launch with acc_out adds this part
// and writes the new sum there (the decision waits for the last part); a
// launch with skip decides on the sum.  With one part neither accumulator
// is given and the launch is the plain one.
//
// Part mesh (entry genmap_probe_mass_reduced; replaces the psum-then-
// decide of genmap_tpu/parallel/partmesh.py:make_part_prober): each device
// runs its part's launch with acc_out, the accumulators are summed over
// the devices of the part axis (an all_reduce outside the kernel), and
// this entry decides on the sum: one thread per block reads its P + 1
// int64 words, saturates each mass at 2^32 - 1 (a sum of saturated part
// masses cannot wrap int64), tests it against thr[p] and the flag column
// against 0, and writes the skip byte (and the saturated masses when
// asked).  Bound: bytes, 8 (P + 1) read and 1 (+ 4 P) written per block.
// PM_THREADS, PM_CAP, PM_SPEC_F and PM_MIN_BLOCKS come from chip_ab.py
// --kernels's sweep (-D).

#include "genmap.cuh"

#define GM_PROBE_MAX_P 16
#ifndef PM_THREADS
#define PM_THREADS 256
#endif
#ifndef PM_CAP
#define PM_CAP 7
#endif
#ifndef PM_SPEC_F
#define PM_SPEC_F 16
#endif
// resident blocks per SM asked of the compiler for P <= 8 (8 x 256 threads:
// at most 32 registers, so the largest map call, 8,192 blocks of 32
// lanes, is one wave)
#ifndef PM_MIN_BLOCKS
#define PM_MIN_BLOCKS (2048 / PM_THREADS)
#endif

static_assert(PM_THREADS % 32 == 0, "PM_THREADS is a multiple of the warp");
static_assert(PM_CAP >= 1 && 32 * PM_CAP <= 255, "32 lanes' capped masses fit a byte");

// Does any of the row's Ln bytes at p equal 4 (N)?  Lanes j, j + L, ... of
// the segment test the aligned words that hold the row, four bytes a word.
__device__ __forceinline__ bool pm_has_n(const uint8_t* p, int Ln, int j, int L) {
  const int head = (int)((uintptr_t)p & 3u);
  const uint32_t* w = (const uint32_t*)(p - head);
  const int nw = (head + Ln + 3) >> 2;
  bool n = false;
  for (int i = j; i < nw; i += L) {
    uint32_t x = __ldg(w + i) ^ 0x04040404u;  // a byte of N is now 0
    const int lo = 4 * i - head, hi = lo + 4;  // the word's bytes in the row
    if (lo < 0) x |= 0xFFFFFFFFu >> (8 * (4 + lo));  // bytes before the row
    if (hi > Ln) x |= 0xFFFFFFFFu << (8 * (4 - (hi - Ln)));  // bytes after it
    n |= ((x - 0x01010101u) & ~x & 0x80808080u) != 0u;  // a zero byte
  }
  return n;
}

template <int NP>
__global__ void __launch_bounds__(PM_THREADS, NP <= 8 ? PM_MIN_BLOCKS : 1)
probe_mass_kernel(const int32_t* __restrict__ st, const uint8_t* __restrict__ valid,
                  int64_t B, int F, int P, int lg,
                  const uint8_t* __restrict__ ovf,
                  const uint8_t* __restrict__ needles, int Ln, int has_n,
                  const int32_t* __restrict__ thr,
                  const int64_t* __restrict__ acc_in,
                  int64_t* __restrict__ acc_out, uint8_t* __restrict__ skip,
                  int32_t* __restrict__ mass_out, uint8_t* __restrict__ nwin_out) {
  const int L = 1 << lg;
  const int64_t b = ((int64_t)blockIdx.x * PM_THREADS + threadIdx.x) >> lg;
  const int lane = threadIdx.x & 31;
  const int j = lane & (L - 1);
  const bool live = b < B;  // no return: every lane takes the collectives
  const int64_t N = B * F;
  // loads whose addresses need no loaded value, all issued before the
  // slot loads: no branch waits on them (a branch on a loaded threshold
  // or flag here would hold the slot loads back by a trip).  The
  // thresholds are kept as bytes, min(thr, 255), four a register.
  constexpr int NW = (NP + 3) / 4;
  uint32_t tb[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) tb[q] = 0u;
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (p < P) tb[p >> 2] |= min((uint32_t)__ldg(thr + p), 255u) << (8 * (p & 3));
  const bool first = j == 0 && live;  // writes the block's decision
  const uint32_t ov = first ? __ldg(ovf + b) : 0u;
  const int64_t fl = first && acc_in ? __ldg(acc_in + b * (P + 1) + P) : 0;
  const bool flagged = (ov != 0u) | (fl != 0);  // no short circuit: no branch
  unsigned long long acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0ull;
  if (live) {
    // where a lane holds at most one slot, its plan and size words are
    // loaded beside its validity byte (the bytes of invalid slots are
    // read too, but the valid -> operands trip is gone)
    const bool spec = F <= PM_SPEC_F;
    for (int s = j; s < F; s += L) {
      const int64_t k = b * F + s;
      int plan = 0;
      uint32_t size = 0;
      if (spec) {
        plan = __ldg(st + 4 * N + k);
        size = (uint32_t)__ldg(st + 2 * N + k);
      }
      if (!__ldg(valid + k)) continue;
      if (!spec) {
        plan = __ldg(st + 4 * N + k);
        size = (uint32_t)__ldg(st + 2 * N + k);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p == plan) acc[p] += size;  // unrolled select keeps acc in registers
    }
  }
  bool n_here = false;
  if (has_n && live) n_here = pm_has_n(needles + b * Ln, Ln, j, L);
  const unsigned seg = (L == 32 ? 0xFFFFFFFFu : ((1u << L) - 1u)) << (lane & ~(L - 1));
  const bool nwin = (__ballot_sync(0xFFFFFFFFu, n_here) & seg) != 0u;
  const bool exact = acc_in || acc_out || mass_out;  // uniform
  bool cap_ok = !exact;
#pragma unroll
  for (int p = 0; p < NP; ++p)
    cap_ok = cap_ok && (p >= P || ((tb[p >> 2] >> (8 * (p & 3))) & 0xFFu) < PM_CAP);
  bool ok = true;
  if (cap_ok) {  // the decision only: capped masses, a byte each
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      uint32_t w = 0;
#pragma unroll
      for (int p = 4 * q; p < 4 * q + 4 && p < NP; ++p)
        w |= (uint32_t)(acc[p] < PM_CAP ? acc[p] : PM_CAP) << (8 * (p - 4 * q));
      if (L == 32) {
        w = __reduce_add_sync(0xFFFFFFFFu, w);
      } else {
        for (int d = L >> 1; d > 0; d >>= 1) w += __shfl_xor_sync(0xFFFFFFFFu, w, d);
      }
#pragma unroll
      for (int p = 4 * q; p < 4 * q + 4 && p < NP; ++p) {
        const int sh = 8 * (p - 4 * q);
        if (p < P) ok = ok && ((w >> sh) & 0xFFu) <= ((tb[q] >> sh) & 0xFFu);
      }
    }
  } else {  // exact 64-bit sums, saturated at 2^32 - 1
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p >= P) break;  // P is uniform across the warp
      unsigned long long m = acc[p];
      for (int d = L >> 1; d > 0; d >>= 1) m += __shfl_xor_sync(0xFFFFFFFFu, m, d);
      if (acc_in && live) m += (unsigned long long)acc_in[b * (P + 1) + p];
      const uint32_t sat = m > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)m;
      ok = ok && sat <= (uint32_t)__ldg(thr + p);
      if (first && mass_out) mass_out[b * P + p] = (int32_t)sat;
      if (first && acc_out) acc_out[b * (P + 1) + p] = (int64_t)sat;
    }
  }
  if (first) {
    const bool bad = flagged || nwin;
    if (skip) skip[b] = (ok && !bad) ? 1 : 0;
    if (acc_out) acc_out[b * (P + 1) + P] = bad ? 1 : 0;
    if (nwin_out) nwin_out[b] = nwin ? 1 : 0;
  }
}

extern "C" int genmap_probe_mass(const void* st, const void* valid,
                                 long long B, int F, int P, const void* ovf,
                                 const void* needles, int Ln, int has_n,
                                 const void* thr, const void* acc_in,
                                 void* acc_out, void* skip, void* mass_out,
                                 void* nwin_out, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > GM_PROBE_MAX_P) return (int)cudaErrorInvalidValue;
  int lg = 0;  // lanes per block: the least power of two >= F, at most 32
  while (lg < 5 && (1 << lg) < F) ++lg;
  const unsigned int blocks =
      (unsigned int)(((B << lg) + PM_THREADS - 1) / PM_THREADS);
#define PM_LAUNCH(NP)                                                        \
  probe_mass_kernel<NP><<<blocks, PM_THREADS, 0, (cudaStream_t)stream>>>(   \
      (const int32_t*)st, (const uint8_t*)valid, (int64_t)B, F, P, lg,      \
      (const uint8_t*)ovf, (const uint8_t*)needles, Ln, has_n,              \
      (const int32_t*)thr, (const int64_t*)acc_in, (int64_t*)acc_out,       \
      (uint8_t*)skip, (int32_t*)mass_out, (uint8_t*)nwin_out)
  if (P <= 4)
    PM_LAUNCH(4);
  else if (P <= 8)
    PM_LAUNCH(8);
  else
    PM_LAUNCH(16);
#undef PM_LAUNCH
  return (int)cudaGetLastError();
}

__global__ void probe_mass_reduced_kernel(const int64_t* __restrict__ acc,
                                          int64_t B, int P,
                                          const int32_t* __restrict__ thr,
                                          uint8_t* __restrict__ skip,
                                          int32_t* __restrict__ mass_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* row = acc + b * (P + 1);
  bool ok = row[P] == 0;
  for (int p = 0; p < P; ++p) {
    const int64_t m = row[p];
    const uint32_t sat = m > 0xFFFFFFFFll ? 0xFFFFFFFFu : (uint32_t)m;
    ok = ok && sat <= (uint32_t)thr[p];
    if (mass_out) mass_out[b * P + p] = (int32_t)sat;
  }
  skip[b] = ok ? 1 : 0;
}

extern "C" int genmap_probe_mass_reduced(const void* acc, long long B, int P,
                                         const void* thr, void* skip,
                                         void* mass_out, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > GM_PROBE_MAX_P) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((B + threads - 1) / threads);
  probe_mass_reduced_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (int64_t)B, P, (const int32_t*)thr, (uint8_t*)skip,
      (int32_t*)mass_out);
  return (int)cudaGetLastError();
}
