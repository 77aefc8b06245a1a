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
//
// lanes = 0, the bulk copies (entries _sum_bulk, _chain_bulk): what
// dma_kernel does with its DMA engine, done with the card's: whole rows
// moved global -> shared by `cp.async.bulk`, completion counted in bytes
// on an `mbarrier`, so a thread spends no registers on a row in flight.
//   sum    a block keeps RB_STAGES chunks of up to 32 rows in flight; warp 0
//          issues a chunk (a lane a row, the stage's barrier expecting the
//          chunk's bytes), the block sums the previous chunk from shared
//          memory as 16 B vectors, meets at a barrier, and warp 0 refills;
//   chain  a thread per chain, a slot per thread (an odd number of 16 B
//          units, so that a quarter warp's vector reads hit distinct banks),
//          one copy per step, a barrier per warp.
// The copies need rows of whole 16 B units at 16 B aligned addresses (not
// Dna5's 276 B sub-rows) and stages or slots that fit the shared memory
// (rg_bulk_plan, which entry _bulk_ok reports); the _bulk entries refuse
// any other table, and the wrappers then launch a word kernel.
//
// Measured on the H100 (chip_ab.py --kernels, PR 12's third A/B call, A B
// B A, 2^20 ids summed or 2^17 chains of 8 steps, runs within 1 % of each
// other; ms at 208 / 416 / 512 B rows):
//   20 MB (L2)   the word kernels win: sum 0.049 (lanes 8) / 0.073 (4) /
//                0.081 (8) against the bulk copies' 0.085 / 0.089 / 0.097,
//                chains 0.052 / 0.071 / 0.081 against 0.058 / 0.088 / 0.105;
//   4 GiB (HBM)  the bulk copies win or come close: sum 0.117 against
//                lanes 8's 0.125 at 208 B, 0.177 against lanes 32's 0.179
//                at 416 B, 0.198 against lanes 8's 0.193 at 512 B (2.9 %
//                behind); chains 0.112 / 0.176 / 0.195 against 0.130 (8)
//                / 0.190 (32) / 0.198 (8).
// chip_smoke.py's rowgather sweep (PR 12's proof) reads the same from a
// 256 MiB table: bulk sum level with the best word kernel at 208 and 416
// B and 3.5 % behind lanes 8 at 512 B, chains 1.20x and 1.25x faster at
// 208 and 416 B, level at 512 B.
// RB_STAGES (the sum only; the same A/B call): 2 stages fastest from L2,
// where 1, 3 and 4 took 1.01-1.77x as long (4 stages at 512 B: 0.171
// against 0.097 ms); from HBM they took 0.98-1.13x as long.
//
// The wrappers' default (`lanes=None`, kernels.row_gather_lanes), one
// rule for both entries and each residency (it gives up the 2.9-3.5 % of
// the 512 B sum above L2): calls of fewer than
// 16,384 ids (the harness's 4,096) take 32 lanes, which measured fastest
// there; tables above 32 MiB (no size between 20 MB and 256 MiB was
// measured) the bulk copies where they apply; else the word kernel of the
// nearest measured width: lanes 8 at 208 and 512 B, at 416 B lanes 4 from
// L2 and lanes 32 from HBM.

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

// ---------------------------------------------------------------------------
// The bulk-copy design (lanes = 0): the card's copy engine moves whole rows
// into shared memory, as dma_kernel's per-row DMAs move them into VMEM.
// ---------------------------------------------------------------------------

#ifndef RB_STAGES  // chunks of rows a block keeps in flight (sum)
#define RB_STAGES 2
#endif
#define RB_SMEM 65536  // shared memory a block of the sum takes at most, bytes
#define RB_ROWS 32  // most rows a chunk holds: a lane of warp 0 copies each

// The PTX of the copies and barriers (a host build of this file for a CPU
// mock of the runtime defines RG_MOCK_BARRIERS and brings its own).
#if defined(__CUDA_ARCH__) || !defined(RG_MOCK_BARRIERS)
__device__ __forceinline__ uint32_t rg_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void rg_bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(rg_smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on `bar` that also expects `bytes` more of copies.
__device__ __forceinline__ void rg_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   rg_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed; traps
// (a launch failure, not a hang) if that takes more than ~2^34 cycles.
__device__ __forceinline__ void rg_bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(rg_smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// An asynchronous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void rg_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(rg_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(rg_smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void rg_bars_init(uint64_t* bars, int n, uint32_t count) {
  for (int k = 0; k < n; ++k) rg_bar_init(&bars[k], count);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
#endif

// Sum: the ids in chunks of `rows` (block b takes chunks b, b + grid, ...),
// RB_STAGES chunks in flight.  Warp 0 issues a chunk: its lanes read `rows`
// ids, each lane with an id in [0, NR) copies its row to the next free slot
// of the chunk's stage, and lane 0 arrives on the stage's barrier expecting
// their bytes.  All 256 threads wait for the chunk, sum its rows from shared
// memory as 16-byte vectors, meet at a barrier, and warp 0 refills the stage.
__global__ void __launch_bounds__(RG_THREADS)
row_gather_sum_bulk_kernel(const uint32_t* __restrict__ table, int NR, int W,
                           const int32_t* __restrict__ idx, int64_t n, int rows,
                           uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t rb_buf[];
  __shared__ uint64_t full[RB_STAGES];
  __shared__ int nrows[RB_STAGES];
  const uint32_t rb = 4u * (uint32_t)W;
  const int64_t nchunks = (n + rows - 1) / rows;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) rg_bars_init(full, RB_STAGES, 1);
  __syncthreads();
  auto issue = [&](int64_t k) {  // warp 0: the block's chunk k
    const int64_t c = blockIdx.x + k * gridDim.x;
    if (c >= nchunks) return;
    const int s = (int)(k % RB_STAGES);
    const int64_t r = c * rows + lane;
    const bool has = lane < rows && r < n;
    const uint32_t id = has ? (uint32_t)idx[r] : 0u;
    const bool ok = has && id < (uint32_t)NR;
    const uint32_t m = __ballot_sync(0xFFFFFFFFu, ok);
    if (lane == 0) {
      nrows[s] = __popc(m);
      rg_bar_expect(&full[s], __popc(m) * rb);
    }
    __syncwarp();
    if (ok)
      rg_bulk_load(rb_buf + ((size_t)s * rows + __popc(m & ((1u << lane) - 1u))) * rb,
                   table + (size_t)id * W, rb, &full[s]);
  };
  if (threadIdx.x < 32)
    for (int k = 0; k < RB_STAGES; ++k) issue(k);
  uint32_t acc = 0;
  for (int64_t k = 0; blockIdx.x + k * gridDim.x < nchunks; ++k) {
    const int s = (int)(k % RB_STAGES);
    rg_bar_wait(&full[s], (uint32_t)((k / RB_STAGES) & 1));
    const uint4* v = reinterpret_cast<const uint4*>(rb_buf + (size_t)s * rows * rb);
    const int nv = nrows[s] * (W >> 2);
    for (int j = threadIdx.x; j < nv; j += RG_THREADS) {
      const uint4 x = v[j];
      acc += x.x + x.y + x.z + x.w;
    }
    __syncthreads();  // the stage is read: warp 0 refills it
    if (threadIdx.x < 32) issue(k + RB_STAGES);
  }
  rg_block_add(acc, out);
}

// Chain: a thread per chain, each step one bulk copy of its row into its own
// slot (a stride of an odd number of 16-byte units, so that the 8 threads of
// a quarter warp read 16-byte vectors from distinct banks), completing on
// its warp's barrier; the warp waits, each thread sums its row and takes
// the next id.  Warps step independently.
__global__ void __launch_bounds__(RG_THREADS)
row_gather_chain_bulk_kernel(const uint32_t* __restrict__ table, int NR, int W,
                             const int32_t* __restrict__ idx, int64_t n, int steps,
                             uint32_t slot_bytes, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t rb_buf[];
  __shared__ uint64_t bar[RG_THREADS / 32];
  const uint32_t rb = 4u * (uint32_t)W;
  const int wib = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) rg_bars_init(&bar[wib], 1, 32);
  __syncthreads();
  uint8_t* slot = rb_buf + (size_t)threadIdx.x * slot_bytes;
  const uint4* v = reinterpret_cast<const uint4*>(slot);
  const int64_t stride = (int64_t)gridDim.x * RG_THREADS;
  uint32_t acc = 0, phase = 0;
  for (int64_t r0 = (int64_t)blockIdx.x * RG_THREADS + (threadIdx.x & ~31); r0 < n;
       r0 += stride) {  // warp-uniform
    const int64_t r = r0 + (threadIdx.x & 31);
    const bool live = r < n;
    int32_t c = live ? idx[r] : 0;
    for (int s = 0; s < steps; ++s) {
      const bool in = live && (uint32_t)c < (uint32_t)NR;
      rg_bar_expect(&bar[wib], in ? rb : 0u);
      if (in) rg_bulk_load(slot, table + (size_t)(uint32_t)c * W, rb, &bar[wib]);
      rg_bar_wait(&bar[wib], phase);
      phase ^= 1u;
      uint32_t sum = 0;
      if (in)
        for (int j = 0; j < (W >> 2); ++j) {
          const uint4 x = v[j];
          sum += x.x + x.y + x.z + x.w;
        }
      __syncwarp();  // every lane has read its slot before the next copy
      const int32_t w = (int32_t)sum;
      c = ((w % NR) + NR) % NR;
    }
    if (live) acc += (uint32_t)c;
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

// The rows a stage of the bulk sum holds (RB_STAGES stages in RB_SMEM
// bytes, at most RB_ROWS), and the bytes of a chain's slot.
static int rg_sum_rows(int W) {
  const int64_t fit = RB_SMEM / (RB_STAGES * 4 * (int64_t)W);
  return fit > RB_ROWS ? RB_ROWS : (int)fit;
}

static uint32_t rg_slot_bytes(int W) { return 16u * (((uint32_t)W / 4) | 1u); }

// Whether the bulk kernel of the chain (else the sum) runs on rows of W
// words at `table`, with its dynamic shared memory and blocks per SM: rows
// of whole 16-byte units at a 16-byte aligned base, and a block's stages
// (sum) or slots (chain) in the shared memory an SM gives one block.  The
// one test of it: the _bulk entries refuse a table that fails it, and the
// wrappers ask it (entry _bulk_ok) before they launch one.
static bool rg_bulk_plan(const void* table, int W, int chain, size_t* smem, int* per_sm) {
  if (!rg_vec(table, W)) return false;
  const void* kernel;
  if (chain) {
    *smem = (size_t)RG_THREADS * rg_slot_bytes(W);
    kernel = (const void*)row_gather_chain_bulk_kernel;
  } else {
    const int rows = rg_sum_rows(W);
    if (rows < 1) return false;
    *smem = (size_t)RB_STAGES * rows * 4 * W;
    kernel = (const void*)row_gather_sum_bulk_kernel;
  }
  // no call here may fail: a failed runtime call would stay the last
  // error, which the next launch's cudaGetLastError reports
  int dev = 0, most = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      *smem > (size_t)most)
    return false;
  if (*smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem) !=
          cudaSuccess)
    return false;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, RG_THREADS, *smem) ==
             cudaSuccess &&
         *per_sm >= 1;
}

// The grid of a bulk kernel: `blocks` when given, else `units` blocks
// capped at the per_sm blocks of each SM that fit on the card at once.
static unsigned int rg_bulk_grid(int64_t units, int blocks, int per_sm) {
  if (blocks > 0) return (unsigned int)blocks;
  int dev = 0, sms = 0;
  int64_t g = units;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      sms > 0 && g > (int64_t)sms * per_sm)
    g = (int64_t)sms * per_sm;
  if (g > 0x7FFFFFFF) g = 0x7FFFFFFF;
  return (unsigned int)(g < 1 ? 1 : g);
}

// 1 where the bulk copies run on rows of W words at `table` for the chain
// (chain != 0) or the sum, else 0.
extern "C" int genmap_row_gather_bulk_ok(const void* table, int W, int chain) {
  size_t smem;
  int per_sm;
  return rg_bulk_plan(table, W, chain, &smem, &per_sm) ? 1 : 0;
}

// lanes = 0 of the sum: the bulk-copy design; cudaErrorInvalidValue where
// _bulk_ok refuses the table.
extern "C" int genmap_row_gather_sum_bulk(const void* table, int NR, int W,
                                          const void* idx, long long n_used, int blocks,
                                          void* out, void* stream) {
  size_t smem;
  int per_sm;
  if (!rg_bulk_plan(table, W, 0, &smem, &per_sm)) return (int)cudaErrorInvalidValue;
  if (n_used <= 0) return 0;
  const int rows = rg_sum_rows(W);
  const unsigned int grid = rg_bulk_grid((n_used + rows - 1) / rows, blocks, per_sm);
  row_gather_sum_bulk_kernel<<<grid, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)table, NR, W, (const int32_t*)idx, (int64_t)n_used, rows,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

// lanes = 0 of the chain: the bulk-copy design; cudaErrorInvalidValue
// where _bulk_ok refuses the table.
extern "C" int genmap_row_gather_chain_bulk(const void* table, int NR, int W,
                                            const void* idx, long long n, int steps,
                                            int blocks, void* out, void* stream) {
  size_t smem;
  int per_sm;
  if (!rg_bulk_plan(table, W, 1, &smem, &per_sm)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned int grid = rg_bulk_grid((n + RG_THREADS - 1) / RG_THREADS, blocks, per_sm);
  row_gather_chain_bulk_kernel<<<grid, RG_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)table, NR, W, (const int32_t*)idx, (int64_t)n, steps,
      rg_slot_bytes(W), (uint32_t*)out);
  return (int)cudaGetLastError();
}
