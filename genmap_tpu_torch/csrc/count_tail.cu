// Per-k-mer saturating occurrence counts from the final extension states,
// and optionally the zero-error interval of every k-mer.
//
// Replaces: genmap_tpu/search/engine.py:_count_tail (counting part, and
// its with_exact / with_states outputs exact_size, exact_size_total and
// exact_flo) with genmap_tpu/ops/rank.py:rc_strand_count for forward-only
// (-nc) counts.
//
// Bound on the H100: bytes for reverse-complement counting (the validity
// of every state, the size of the valid ones); with -nc or the exact
// outputs, the latency of two random strand-row reads (20 B each) per
// valid state.  At the sizes the map gives it (~50,000 k-mers) the kernel
// is bound by load latency: what held the first version (one warp per
// k-mer) back was 31 idle lanes of 32 at Fe = 1 (every f_extend = 1 tier)
// and, at Fe = 64, a validity load and then, behind a branch on it, the
// interval's loads, slot after slot, in one warp per k-mer.
//
// Design: g = min(32, the power of two >= Fe / CT_SPL) lanes per k-mer and
// 32 / g k-mers per warp, so a lane holds ~CT_SPL slots and neighbouring
// k-mers' reads coalesce.  A lane loads the validity of CT_BATCH of its
// slots together, then the size (and flo, err where needed) of the valid
// ones together; loading every slot's interval whatever its validity
// measured slower, since valid states come first in each k-mer's slots and
// the rest would be read for nothing.  One instantiation per strand mode
// and exact outputs keeps the common case (both strands, counts only) to
// validity and size, and its registers low.  A lane adds min(count, cap)
// of its valid states, and xor shuffles of width g sum the segment before
// the result saturates at cap.  Each sum wraps mod 2^32 and the clamp at
// cap comes before it, so the order of the sum changes nothing.  Lane 0 of
// each segment writes; k-mers at or past the block's count are written as
// 0.  With `with_exact` the same lanes also sum, over valid states with
// err == 0, the interval size, its forward-strand part (strand rows read
// even when counting both strands) and the interval start; these sums wrap
// mod 2^32 as the JAX package's uint32 sums do.  exact_size and
// exact_size_total are 0 past the block's count; exact_flo is not masked
// (as in JAX).  (CT_BATCH and CT_SPL were chosen by timing variants on the
// H100.)

#include "genmap.cuh"

#define CT_FULL 0xFFFFFFFFu
#define CT_BATCH 2  // slots per lane whose loads are issued together
#define CT_SPL 8    // slots per lane that the segment width aims at

// RC: count both strands (size); EXACT: the zero-error outputs too.  Only
// -nc and EXACT read flo and the strand rows.
template <bool RC, bool EXACT>
__global__ void count_tail_kernel(const int32_t* __restrict__ st,
                                  const uint8_t* __restrict__ valid,
                                  int64_t rows, int Fe, int J, int g,
                                  const int32_t* __restrict__ cnt,
                                  const uint32_t* __restrict__ strand, uint32_t cap,
                                  uint16_t* __restrict__ hits,
                                  uint32_t* __restrict__ exact_size,
                                  uint32_t* __restrict__ exact_total,
                                  uint32_t* __restrict__ exact_flo) {
  constexpr bool FLO = !RC || EXACT;
  const int lane = threadIdx.x & 31;
  const int per = 32 / g;
  const int64_t row0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per;
  if (row0 >= rows) return;  // warp-uniform
  const int seg = lane / g, sub = lane - seg * g;
  const int64_t row = row0 + seg;
  const bool live = row < rows;
  const int64_t N = rows * Fe;
  const int64_t b = row / J;
  const int in_cnt = live && sub == 0 ? cnt[b] : 0;
  uint32_t acc = 0, e_fwd = 0, e_tot = 0, e_flo = 0;
  // every lane runs the same number of batches (Fe is uniform)
  for (int s0 = 0; s0 < Fe; s0 += g * CT_BATCH) {
    bool vv[CT_BATCH];
    uint32_t flo[CT_BATCH], size[CT_BATCH];
    int32_t err[CT_BATCH];
#pragma unroll
    for (int i = 0; i < CT_BATCH; ++i) {
      const int s = s0 + i * g + sub;
      vv[i] = live && s < Fe && valid[row * Fe + s] != 0;
    }
#pragma unroll
    for (int i = 0; i < CT_BATCH; ++i) {  // the valid slots' loads, together
      const int64_t k = row * Fe + s0 + i * g + sub;
      size[i] = vv[i] ? (uint32_t)st[2 * N + k] : 0u;
      flo[i] = FLO && vv[i] ? (uint32_t)st[k] : 0u;
      err[i] = EXACT && vv[i] ? st[3 * N + k] : 1;
    }
#pragma unroll
    for (int i = 0; i < CT_BATCH; ++i) {
      if (!vv[i]) continue;
      const bool exact_state = EXACT && err[i] == 0;
      uint32_t fwd = size[i];
      if (!RC || exact_state)
        fwd = size[i] - (gm_rc_count(strand, flo[i] + size[i]) - gm_rc_count(strand, flo[i]));
      const uint32_t counting = RC ? size[i] : fwd;
      acc += counting < cap ? counting : cap;
      if (exact_state) {
        e_fwd += fwd;
        e_tot += size[i];
        e_flo += flo[i];
      }
    }
  }
  for (int d = g >> 1; d > 0; d >>= 1) acc += __shfl_xor_sync(CT_FULL, acc, d, g);
  if (EXACT) {
    for (int d = g >> 1; d > 0; d >>= 1) {
      e_fwd += __shfl_xor_sync(CT_FULL, e_fwd, d, g);
      e_tot += __shfl_xor_sync(CT_FULL, e_tot, d, g);
      e_flo += __shfl_xor_sync(CT_FULL, e_flo, d, g);
    }
  }
  if (live && sub == 0) {
    const int j = (int)(row - b * J);
    const bool in = j < in_cnt;
    hits[row] = (uint16_t)(in ? (acc < cap ? acc : cap) : 0u);
    if (EXACT) {
      exact_size[row] = in ? e_fwd : 0u;
      exact_total[row] = in ? e_tot : 0u;
      exact_flo[row] = e_flo;
    }
  }
}

template <bool RC, bool EXACT>
static void ct_launch(unsigned int blocks, int threads, cudaStream_t s, const void* st,
                      const void* valid, long long rows, int Fe, int J, int g,
                      const void* cnt, const void* strand, unsigned int cap, void* hits,
                      void* exact_size, void* exact_total, void* exact_flo) {
  count_tail_kernel<RC, EXACT><<<blocks, threads, 0, s>>>(
      (const int32_t*)st, (const uint8_t*)valid, (int64_t)rows, Fe, J, g,
      (const int32_t*)cnt, (const uint32_t*)strand, cap, (uint16_t*)hits,
      (uint32_t*)exact_size, (uint32_t*)exact_total, (uint32_t*)exact_flo);
}

extern "C" int genmap_count_tail(const void* st, const void* valid,
                                 long long rows, int Fe, int J,
                                 const void* cnt, const void* strand,
                                 int rev_compl, unsigned int cap, void* hits,
                                 int with_exact, void* exact_size,
                                 void* exact_total, void* exact_flo,
                                 void* stream) {
  if (rows == 0) return 0;
  const int want = (Fe + CT_SPL - 1) / CT_SPL;  // lanes for CT_SPL slots each
  int g = 1;
  while (g < want && g < 32) g <<= 1;
  const int threads = 256;
  const long long warps = (rows + 32 / g - 1) / (32 / g);
  const unsigned int blocks = (unsigned int)((warps * 32 + threads - 1) / threads);
  auto launch = rev_compl ? (with_exact ? ct_launch<true, true> : ct_launch<true, false>)
                          : (with_exact ? ct_launch<false, true> : ct_launch<false, false>);
  launch(blocks, threads, (cudaStream_t)stream, st, valid, rows, Fe, J, g, cnt, strand, cap,
         hits, exact_size, exact_total, exact_flo);
  return (int)cudaGetLastError();
}
