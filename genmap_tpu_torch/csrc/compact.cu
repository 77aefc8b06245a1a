// Frontier compaction: the first F valid candidates of every row, in order.
//
// Replaces: genmap_tpu/search/engine.py:_compact (a one-hot product, an
// argmax select or a stable sort on the validity key, by frontier size).
// All three keep candidate order, so this kernel's valid slots equal the
// JAX package's slot for slot.
//
// Bound on the H100: bytes, and at real densities the sectors behind them.
// A row reads M validity bytes (count off: only up to its (F+1)-th valid
// slot) and R int32 operands of each kept slot, and writes R x F operands
// and F validity bytes.  The kept slots lie scattered along the row, so
// each 4-byte operand read costs a 32-byte sector: at the smoke's largest
// call (1.5 % of slots valid) those sector reads are about as many bytes
// as the validity and the outputs together.  What held the first version
// (one warp per row, one byte per lane per step) back was bytes in flight:
// 1-byte loads of the resident warps keep ~270 KB in flight where the
// H100 needs ~3 MB (3.35 TB/s x ~1 us); long rows ran one warp serially on
// a few SMs, and rows of M <= 30 left most lanes idle.
//
// Design: the wrapper picks one of three regimes from the row length
// (kernels.compact_chunks), all behind one C entry:
//   short  (M <= 32)  a segment of g lanes per row (g the power of two
//          >= M), 32 / g rows per warp: one validity byte per lane, a ballot
//          masked to the segment ranks the valid slots; neighbouring rows'
//          reads coalesce.
//   middle (32 < M < 4096)  a segment of g <= 32 lanes per row, as many as
//          the row has 16-byte validity units; each step a lane reads one
//          unit, SIMD byte compares and popcounts count its valid bytes, an
//          inclusive scan across the segment gives its base rank, and the
//          lane writes the operands of its valid slots ranked below F.
//          Without `count`, a row stops reading once more than F of its
//          slots are valid.
//   long   (M >= 4096)  each row is cut into chunks of 256 units, one block
//          each.  Grid 1 counts every chunk into a scratch array; grid 2
//          gives each chunk its base rank (the sum of the row's earlier
//          chunk counts), writes the chunks whose base is below F, and
//          fills its share of the row's slots past the valid count.
// (The crossover at M = 4096 is `chip_ab.py --kernels`'s sweep.  One lane
// per unit rather than two or four, and no register cap, were chosen by
// timing variants on the H100: the middle regime waits on its dependent
// loads, so occupancy decides.)
// Rows need not start 16-byte aligned (M = 5, 20, 30, 96 ...): a unit that
// straddles a row's edge is read byte by byte, and bytes outside the row
// count as invalid.  Slots past the valid count are zero; the row's
// overflow flag says whether more than F were valid.  On request the
// row's valid count before the cut is written too (the JAX
// package's occupancy signal, v.sum(-1) at genmap_tpu/search/engine.py:
// 588/816/946, and the split pipeline's survivor count, :1304-1306).

#include "genmap.cuh"

#define CP_FULL 0xFFFFFFFFu
#define CP_THREADS 256
#define CP_CHUNK_UNITS 256  // long regime: units per chunk (one per thread)

// The 16-byte validity unit at row offset `off` (16-byte aligned in memory;
// off may be negative at a row's unaligned start).  Bytes outside [0, M)
// read as 0.
__device__ __forceinline__ uint4 cp_unit(const uint8_t* __restrict__ row, int64_t M,
                                         int64_t off) {
  if (off >= 0 && off + 16 <= M) return *reinterpret_cast<const uint4*>(row + off);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (off + b >= 0 && off + b < M) w[b >> 2] |= (uint32_t)row[off + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Number of nonzero bytes of a unit.
__device__ __forceinline__ int cp_count(uint4 w) {
  return (__popc(__vcmpne4(w.x, 0u)) + __popc(__vcmpne4(w.y, 0u)) +
          __popc(__vcmpne4(w.z, 0u)) + __popc(__vcmpne4(w.w, 0u))) >> 3;
}

// Write the operands of the unit's valid slots (row offset `off`), ranked
// from rk on, while the rank is below F; returns the next rank.
__device__ __forceinline__ int cp_emit(uint4 w, int64_t off, int rk, int F,
                                       const int32_t* __restrict__ in, int R,
                                       int64_t rows, int64_t row, int64_t M,
                                       int32_t* __restrict__ out) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t m = __vcmpne4(ws[k], 0u) & 0x01010101u;
    while (m && rk < F) {
      const int64_t col = off + 4 * k + ((__ffs(m) - 1) >> 3);
      m &= m - 1u;
      for (int r = 0; r < R; ++r) {
        const int64_t rr = (int64_t)r * rows + row;
        out[rr * F + rk] = in[rr * M + col];
      }
      ++rk;
    }
  }
  return rk;
}

// The row's slots [s0, s1) past the kept ones: validity = slot < keep and
// zero operands; `n` threads, this one `t`.
__device__ __forceinline__ void cp_fill(int R, int64_t rows, int64_t row, int F,
                                        int keep, int s0, int s1, int t, int n,
                                        int32_t* __restrict__ out,
                                        uint8_t* __restrict__ out_valid) {
  for (int s = s0 + t; s < s1; s += n) out_valid[row * F + s] = s < keep ? 1 : 0;
  for (int s = (keep > s0 ? keep : s0) + t; s < s1; s += n)
    for (int r = 0; r < R; ++r) out[((int64_t)r * rows + row) * F + s] = 0;
}

__global__ void compact_short_kernel(const int32_t* __restrict__ in,
                                     const uint8_t* __restrict__ valid, int R,
                                     int64_t rows, int M, int F, int g,
                                     int32_t* __restrict__ out,
                                     uint8_t* __restrict__ out_valid,
                                     uint8_t* __restrict__ ovf,
                                     int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / g;
  const int64_t row0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per;
  if (row0 >= rows) return;  // warp-uniform
  const int seg = lane / g, sub = lane - seg * g;
  const int64_t row = row0 + seg;
  const bool live = row < rows;
  const bool vv = live && sub < M && valid[row * M + sub] != 0;
  const uint32_t bal = __ballot_sync(CP_FULL, vv);
  const uint32_t mine = g == 32 ? bal : bal & (((1u << g) - 1u) << (seg * g));
  if (!live) return;  // past the warp's only collective
  const int total = __popc(mine);
  const int rk = __popc(mine & ((1u << lane) - 1u));
  if (vv && rk < F)
    for (int r = 0; r < R; ++r) {
      const int64_t rr = (int64_t)r * rows + row;
      out[rr * F + rk] = in[rr * M + sub];
    }
  const int keep = total < F ? total : F;
  cp_fill(R, rows, row, F, keep, 0, F, sub, g, out, out_valid);
  if (sub == 0) {
    ovf[row] = total > F ? 1 : 0;
    if (cnt) cnt[row] = total;
  }
}

__global__ void compact_mid_kernel(const int32_t* __restrict__ in,
                                   const uint8_t* __restrict__ valid, int R,
                                   int64_t rows, int M, int F, int g,
                                   int64_t nunits, int32_t* __restrict__ out,
                                   uint8_t* __restrict__ out_valid,
                                   uint8_t* __restrict__ ovf,
                                   int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / g;
  const int64_t row0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per;
  if (row0 >= rows) return;  // warp-uniform
  const int seg = lane / g, sub = lane - seg * g;
  const int64_t row = row0 + seg;
  const bool live = row < rows;
  const uint8_t* v = valid + (live ? row : 0) * (int64_t)M;
  const int head = (int)((uintptr_t)v & 15u);  // row start past its unit
  const int64_t nu = live ? (head + (int64_t)M + 15) >> 4 : 0;
  int base = 0;  // valid slots of this row before the step
  bool done = !live;
  // nunits bounds every row's units, so every lane runs every step and
  // reaches every shuffle
  for (int64_t u0 = 0; u0 < nunits; u0 += g) {
    const int64_t u = u0 + sub;
    const uint4 w = !done && u < nu ? cp_unit(v, M, 16 * u - head) : make_uint4(0u, 0u, 0u, 0u);
    const int c = cp_count(w);
    int inc = c;
    for (int d = 1; d < g; d <<= 1) {
      const int t = __shfl_up_sync(CP_FULL, inc, d, g);
      if (sub >= d) inc += t;
    }
    const int rk = base + inc - c;
    if (rk < F && c) cp_emit(w, 16 * u - head, rk, F, in, R, rows, row, M, out);
    base += __shfl_sync(CP_FULL, inc, g - 1, g);
    if (!cnt && base > F) done = true;  // early stop: the F kept slots are known
    if (__all_sync(CP_FULL, done)) break;
  }
  if (!live) return;
  const int keep = base < F ? base : F;
  cp_fill(R, rows, row, F, keep, 0, F, sub, g, out, out_valid);
  if (sub == 0) {
    ovf[row] = base > F ? 1 : 0;
    if (cnt) cnt[row] = base;
  }
}

// Sum of x over the block (CP_THREADS threads), in every thread.
__device__ __forceinline__ int cp_block_sum(int x, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(CP_FULL, x, d);
  __syncthreads();  // sh may still be read by an earlier call
  if (lane == 0) sh[wid] = x;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < CP_THREADS / 32; ++i) s += sh[i];
  return s;
}

// Exclusive prefix sum of x over the block's threads.
__device__ __forceinline__ int cp_block_excl(int x, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(CP_FULL, inc, d);
    if (lane >= d) inc += t;
  }
  __syncthreads();
  if (lane == 31) sh[wid] = inc;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < wid; ++i) before += sh[i];
  return before + inc - x;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_long_count_kernel(const uint8_t* __restrict__ valid, int64_t M, int nch,
                          int32_t* __restrict__ chunk_cnt) {
  __shared__ int sh[CP_THREADS / 32];
  const int64_t row = blockIdx.x / nch;
  const int c = (int)(blockIdx.x - row * nch);
  const uint8_t* v = valid + row * M;
  const int head = (int)((uintptr_t)v & 15u);
  const int64_t nu = (head + M + 15) >> 4;
  const int64_t u = (int64_t)c * CP_CHUNK_UNITS + threadIdx.x;
  const int x = u < nu ? cp_count(cp_unit(v, M, 16 * u - head)) : 0;
  const int s = cp_block_sum(x, sh);
  if (threadIdx.x == 0) chunk_cnt[blockIdx.x] = s;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_long_write_kernel(const int32_t* __restrict__ in,
                          const uint8_t* __restrict__ valid, int R, int64_t rows,
                          int64_t M, int F, int nch,
                          const int32_t* __restrict__ chunk_cnt,
                          int32_t* __restrict__ out, uint8_t* __restrict__ out_valid,
                          uint8_t* __restrict__ ovf, int32_t* __restrict__ cnt) {
  __shared__ int sh[CP_THREADS / 32];
  const int64_t row = blockIdx.x / nch;
  const int c = (int)(blockIdx.x - row * nch);
  int pre = 0, all = 0;
  for (int i = threadIdx.x; i < nch; i += CP_THREADS) {
    const int x = chunk_cnt[row * nch + i];
    all += x;
    if (i < c) pre += x;
  }
  const int base = cp_block_sum(pre, sh);
  const int total = cp_block_sum(all, sh);
  if (base < F) {  // block-uniform
    const uint8_t* v = valid + row * M;
    const int head = (int)((uintptr_t)v & 15u);
    const int64_t nu = (head + M + 15) >> 4;
    const int64_t u = (int64_t)c * CP_CHUNK_UNITS + threadIdx.x;
    const uint4 w = u < nu ? cp_unit(v, M, 16 * u - head) : make_uint4(0u, 0u, 0u, 0u);
    const int x = cp_count(w);
    const int rk = base + cp_block_excl(x, sh);
    if (rk < F && x) cp_emit(w, 16 * u - head, rk, F, in, R, rows, row, M, out);
  }
  // this chunk's share of the row's slots
  const int keep = total < F ? total : F;
  const int share = (F + nch - 1) / nch;
  const int s0 = c * share < F ? c * share : F;
  const int s1 = s0 + share < F ? s0 + share : F;
  cp_fill(R, rows, row, F, keep, s0, s1, threadIdx.x, CP_THREADS, out, out_valid);
  if (c == 0 && threadIdx.x == 0) {
    ovf[row] = total > F ? 1 : 0;
    if (cnt) cnt[row] = total;
  }
}

static int cp_pow2_at_least(int64_t n) {
  int g = 1;
  while (g < n && g < 32) g <<= 1;
  return g;
}

// nch > 0: the long-row regime with nch chunks per row and chunk_cnt
// [rows x nch] int32 scratch; otherwise short (M <= 32) or middle.
extern "C" int genmap_compact(const void* in, const void* valid, int R,
                              long long rows, int M, int F, void* out,
                              void* out_valid, void* ovf, void* cnt,
                              void* chunk_cnt, int nch, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* in_ = (const int32_t*)in;
  const uint8_t* v_ = (const uint8_t*)valid;
  if (nch > 0) {
    const unsigned int blocks = (unsigned int)(rows * nch);
    compact_long_count_kernel<<<blocks, CP_THREADS, 0, s>>>(v_, M, nch, (int32_t*)chunk_cnt);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    compact_long_write_kernel<<<blocks, CP_THREADS, 0, s>>>(
        in_, v_, R, (int64_t)rows, M, F, nch, (const int32_t*)chunk_cnt, (int32_t*)out,
        (uint8_t*)out_valid, (uint8_t*)ovf, (int32_t*)cnt);
    return (int)cudaGetLastError();
  }
  if (M <= 32) {
    const int g = cp_pow2_at_least(M);
    const long long warps = (rows + 32 / g - 1) / (32 / g);
    const unsigned int blocks = (unsigned int)((warps * 32 + CP_THREADS - 1) / CP_THREADS);
    compact_short_kernel<<<blocks, CP_THREADS, 0, s>>>(
        in_, v_, R, (int64_t)rows, M, F, g, (int32_t*)out, (uint8_t*)out_valid,
        (uint8_t*)ovf, (int32_t*)cnt);
    return (int)cudaGetLastError();
  }
  // units a row can span: M / 16 when every row starts 16-byte aligned
  const bool aligned = ((uintptr_t)valid & 15u) == 0 && (M & 15) == 0;
  const int64_t nunits = aligned ? M / 16 : (M + 15) / 16 + 1;
  const int g = cp_pow2_at_least(nunits);
  const long long warps = (rows + 32 / g - 1) / (32 / g);
  const unsigned int blocks = (unsigned int)((warps * 32 + CP_THREADS - 1) / CP_THREADS);
  compact_mid_kernel<<<blocks, CP_THREADS, 0, s>>>(
      in_, v_, R, (int64_t)rows, M, F, g, nunits, (int32_t*)out, (uint8_t*)out_valid,
      (uint8_t*)ovf, (int32_t*)cnt);
  return (int)cudaGetLastError();
}
