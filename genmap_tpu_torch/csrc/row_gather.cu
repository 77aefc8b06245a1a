// The rank-row gather: the sum of many random rows of a table, and the
// dependent chain of row reads that was its baseline.
//
// Replaces: benchmarks/pallas_experiments.py:pallas_dma_sum (:106-122), whose
// body dma_kernel (:81-104) DMAs each row table[idx[r], :] from HBM into VMEM,
// CHUNK descriptors in flight, for the first (ND // CHUNK) * CHUNK ids and
// sums every gathered int32 into one int32 (wrapping mod 2^32).  Entry _chain
// ports the harness's baseline xla_chain (:72-78): STEPS dependent steps
// c <- (int32-wrapped row sum of table[c]) floor-mod NR, then the wrapped sum
// of c.  These are the measurement behind the index's rank-row layout: the
// port's rank step reads one random 208 B (Dna4) / 276 B (Dna5) sub-row per
// bound, and the dimer step 256-512 B rows.
//
// Bound on the H100: bytes.  Each id reads one row of W int32 at an address
// nothing else predicts; a read coalesces only within its row, so the rate
// is set by how many rows are in flight (latency) and by the 32 B sectors a
// row spans, out of L2 when the table fits its 50 MB and out of HBM when it
// does not.  Arithmetic is one add per word.
//
// Design: `lanes` threads (1, 4, 8 or 32) read one row together: lane l of
// the group takes words l, l + lanes, ... of it, as 16 B vectors when W % 4
// == 0 and the table is 16 B aligned, else as words.  lanes = 32 is a warp
// per row; lanes = 1 is a thread per row, the access pattern of
// candidate_step.  Blocks of 256 threads walk the ids with a grid stride, so
// `blocks` sets the rows in flight (0: one id per row group, capped at the
// blocks the card holds at once).  Sums are uint32: addition mod 2^32 is
// JAX's int32 sum, in any order.  Each warp reduces with shuffles and each
// block adds its total into the zeroed output word with one atomicAdd.  Ids
// outside [0, NR) read nothing (the plain version raises on them).
//
// Chain: each row group follows one id through all `steps` (the chains are
// independent, so one launch runs them with no grid-wide sync).  The group's
// lanes reduce the row sum with shuffles of width `lanes`, so each of them
// holds it, wrapped to int32 before the modulo (trap 1: an unwrapped sum
// gives other ids), then take the floor modulo ((s % NR) + NR) % NR (trap 2:
// CUDA's % truncates toward zero and half the wrapped sums are negative).
// The id loop is warp-uniform so that every lane reaches every shuffle.

#include "genmap.cuh"

#define RG_THREADS 256

template <int LANES>
__device__ __forceinline__ uint32_t rg_row_sum(const uint32_t* __restrict__ row,
                                               int W, int vec, int sub) {
  uint32_t s = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const int W4 = W >> 2;
    for (int j = sub; j < W4; j += LANES) {
      const uint4 v = r4[j];
      s += v.x + v.y + v.z + v.w;
    }
  } else {
    for (int j = sub; j < W; j += LANES) s += row[j];
  }
  return s;
}

// Sum of the `LANES`-wide group's values, in every lane of the group.
template <int LANES>
__device__ __forceinline__ uint32_t rg_group_sum(uint32_t s) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  return s;
}

// The block's total, added once into *out.
__device__ __forceinline__ void rg_block_add(uint32_t acc, uint32_t* out) {
  __shared__ uint32_t part[RG_THREADS / 32];
  acc = rg_group_sum<32>(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < RG_THREADS / 32; ++k) s += part[k];
    atomicAdd(out, s);
  }
}

template <int LANES>
__global__ void __launch_bounds__(RG_THREADS)
row_gather_sum_kernel(const uint32_t* __restrict__ table, int NR, int W, int vec,
                      const int32_t* __restrict__ idx, int64_t n,
                      uint32_t* __restrict__ out) {
  constexpr int G = 32 / LANES;  // rows per warp at a time
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * RG_THREADS + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (RG_THREADS / 32) * G;
  uint32_t acc = 0;
  for (int64_t r = warp * G + lane / LANES; r < n; r += stride) {
    const uint32_t id = (uint32_t)idx[r];
    if (id < (uint32_t)NR)
      acc += rg_row_sum<LANES>(table + (int64_t)id * W, W, vec, lane % LANES);
  }
  rg_block_add(acc, out);
}

template <int LANES>
__global__ void __launch_bounds__(RG_THREADS)
row_gather_chain_kernel(const uint32_t* __restrict__ table, int NR, int W,
                        int vec, const int32_t* __restrict__ idx, int64_t n,
                        int steps, uint32_t* __restrict__ out) {
  constexpr int G = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;
  const int64_t warp = ((int64_t)blockIdx.x * RG_THREADS + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (RG_THREADS / 32) * G;
  uint32_t acc = 0;
  for (int64_t r0 = warp * G; r0 < n; r0 += stride) {  // warp-uniform
    const int64_t r = r0 + lane / LANES;
    const bool live = r < n;
    int32_t c = live ? idx[r] : 0;
    for (int s = 0; s < steps; ++s) {
      const bool in = live && (uint32_t)c < (uint32_t)NR;
      uint32_t v = in ? rg_row_sum<LANES>(table + (int64_t)c * W, W, vec, sub) : 0u;
      const int32_t w = (int32_t)rg_group_sum<LANES>(v);  // wrapped to int32
      c = ((w % NR) + NR) % NR;                           // floor modulo
    }
    if (live && sub == 0) acc += (uint32_t)c;
  }
  rg_block_add(acc, out);
}

// The grid: `blocks` when given, else one id per row group, capped at the
// blocks that fit on the card at once (the rest would only queue behind
// them: a block per few rows spends more on starting than on reading).
template <typename K>
static unsigned int rg_grid(K kernel, int64_t n, int lanes, int blocks) {
  if (blocks > 0) return (unsigned int)blocks;
  const int64_t per_block = RG_THREADS / lanes;
  int64_t g = (n + per_block - 1) / per_block;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RG_THREADS, 0) ==
          cudaSuccess &&
      sms * per_sm > 0 && g > (int64_t)sms * per_sm)
    g = (int64_t)sms * per_sm;
  if (g > 0x7FFFFFFF) g = 0x7FFFFFFF;
  return (unsigned int)(g < 1 ? 1 : g);
}

static int rg_vec(const void* table, int W) {
  return W % 4 == 0 && ((uintptr_t)table & 15u) == 0;
}

#define RG_LAUNCH(KERNEL, L, n, ...)                                           \
  {                                                                            \
    const unsigned int grid = rg_grid(KERNEL<L>, n, L, blocks);                \
    KERNEL<L><<<grid, RG_THREADS, 0, (cudaStream_t)stream>>>(__VA_ARGS__);     \
  }

#define RG_DISPATCH(KERNEL, n, ...)                                            \
  switch (lanes) {                                                             \
    case 1: RG_LAUNCH(KERNEL, 1, n, __VA_ARGS__); break;                       \
    case 4: RG_LAUNCH(KERNEL, 4, n, __VA_ARGS__); break;                       \
    case 8: RG_LAUNCH(KERNEL, 8, n, __VA_ARGS__); break;                       \
    case 32: RG_LAUNCH(KERNEL, 32, n, __VA_ARGS__); break;                     \
    default: return (int)cudaErrorInvalidValue;                                \
  }

// out: one zeroed uint32 word; the sum of every int32 of rows idx[0..n_used).
extern "C" int genmap_row_gather_sum(const void* table, int NR, int W,
                                     const void* idx, long long n_used,
                                     int lanes, int blocks, void* out,
                                     void* stream) {
  if (n_used <= 0) return 0;
  RG_DISPATCH(row_gather_sum_kernel, n_used, (const uint32_t*)table, NR, W,
              rg_vec(table, W), (const int32_t*)idx, (int64_t)n_used,
              (uint32_t*)out);
  return (int)cudaGetLastError();
}

// out: one zeroed uint32 word; the sum of the n chains' last ids.
extern "C" int genmap_row_gather_chain(const void* table, int NR, int W,
                                       const void* idx, long long n, int steps,
                                       int lanes, int blocks, void* out,
                                       void* stream) {
  if (n <= 0) return 0;
  RG_DISPATCH(row_gather_chain_kernel, n, (const uint32_t*)table, NR, W,
              rg_vec(table, W), (const int32_t*)idx, (int64_t)n, steps,
              (uint32_t*)out);
  return (int)cudaGetLastError();
}
