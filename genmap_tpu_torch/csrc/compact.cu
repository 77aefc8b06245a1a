// Frontier compaction: the first F valid candidates of every row, in order.
//
// Replaces: genmap_tpu/search/engine.py:_compact (a one-hot product, an
// argmax select or a stable sort on the validity key, by frontier size).
// All three keep candidate order, so this kernel's valid slots equal the
// JAX package's slot for slot.
//
// Bound on the H100: bytes.  A row reads M validity bytes and R x M int32
// operands and writes R x F operands; rows are contiguous, so a warp's
// reads coalesce.  The least work is one pass over input and output.
//
// Design: one warp per row.  The row is walked in 32-wide chunks; a ballot
// of the validity bits and a popcount of the lanes below give each valid
// candidate its rank, and candidates ranked < F are written to their slot.
// One kernel covers every regime of the JAX function (F = 1, small and
// large frontiers).  Slots past the valid count are zeroed; the row's
// overflow flag says whether more than F were valid.  On request the row's
// valid count before the cut is written too (the JAX package's occupancy
// signal, v.sum(-1) at genmap_tpu/search/engine.py:588/816/946, and the
// split pipeline's survivor count, :1304-1306): the kernel has it anyway.

#include "genmap.cuh"

__global__ void compact_kernel(const int32_t* __restrict__ in,
                               const uint8_t* __restrict__ valid, int R,
                               int64_t rows, int M, int F,
                               int32_t* __restrict__ out,
                               uint8_t* __restrict__ out_valid,
                               uint8_t* __restrict__ ovf,
                               int32_t* __restrict__ cnt) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const uint8_t* v = valid + row * M;
  const uint32_t below = (1u << lane) - 1u;
  int base = 0;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    const bool vv = m < M && v[m] != 0;
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, vv);
    if (vv) {
      const int rk = base + __popc(bal & below);
      if (rk < F) {
        for (int r = 0; r < R; ++r)
          out[((int64_t)r * rows + row) * F + rk] = in[((int64_t)r * rows + row) * M + m];
        out_valid[row * F + rk] = 1;
      }
    }
    base += __popc(bal);
  }
  const int keep = base < F ? base : F;
  for (int s = keep + lane; s < F; s += 32) {
    for (int r = 0; r < R; ++r) out[((int64_t)r * rows + row) * F + s] = 0;
    out_valid[row * F + s] = 0;
  }
  if (lane == 0) {
    ovf[row] = base > F ? 1 : 0;
    if (cnt) cnt[row] = base;
  }
}

extern "C" int genmap_compact(const void* in, const void* valid, int R,
                              long long rows, int M, int F, void* out,
                              void* out_valid, void* ovf, void* cnt,
                              void* stream) {
  if (rows == 0) return 0;
  const int threads = 256;  // 8 rows per block
  const unsigned int blocks = (unsigned int)((rows * 32 + threads - 1) / threads);
  compact_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (const uint8_t*)valid, R, (int64_t)rows, M, F,
      (int32_t*)out, (uint8_t*)out_valid, (uint8_t*)ovf, (int32_t*)cnt);
  return (int)cudaGetLastError();
}
