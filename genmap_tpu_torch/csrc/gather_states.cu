// The split pipeline's rung gather: phase-B rows of phase-A survivor states.
//
// Replaces: genmap_tpu/engine/mappability.py:_run_tier_split's sl()
// (:1477-1486): a take of the chosen phase-A rows from each of the four
// [B, Fc] operands (flo, rlo, size, err) and from the validity, then a cut
// to the rung's Fe slots or a zero padding up to them; rows past the live
// count are marked invalid (they still copy row ridx[i]'s operands, like
// the JAX take).
//
// Bound on the H100, as chip_smoke.py counts it: bytes.  Per output row the
// row id, min(Fc, Fe) slots of four int32 operands and of the validity
// read, Fe of each written.  The rows are contiguous, so the bytes
// coalesce; but every call is small (at most a few hundred KB), so one
// launch and two dependent trips to memory (the row id, then the row) set
// its time, not the bytes.
//
// What held the first version back (a thread per output slot): a 64-bit
// division per thread, the row id reloaded by every slot, and four 4-byte
// loads and five scalar stores per slot: four times the load and store
// instructions of 16-byte accesses, over twice the threads.
//
// Design: a row is a segment of TX lanes (the least power of two that
// covers its Fe / 4 vectors, at most a warp); its first lane loads the row
// id and shuffles it to the segment.  A lane copies 16 bytes, four slots,
// of each of the four operands (int4) and four validity bytes (one
// uint32, normalised to 0/1 per byte and masked to 0 on rows >= n); slots
// >= Fc store zeros without a load.  Row and slot come from shifts, not a
// division.  Where Fc or Fe is not a multiple of 4, or a pointer is not
// aligned for that (the pool ladder of the infix search has widths 2, 3
// and 6), the same kernel runs with one slot per lane.  GS_THREADS (rows
// per block = GS_THREADS / TX) comes from `chip_ab.py --kernels`'s sweep,
// which builds this file with it overridden (-D).  Tensor cores and TMA do
// not apply: a call moves a few hundred rows, each from an address that
// the row id gives.

#include "genmap.cuh"

#ifndef GS_THREADS
#define GS_THREADS 256
#endif

static_assert(GS_THREADS % 32 == 0, "GS_THREADS is a multiple of the warp");

// VW slots per lane: the operand and validity types that hold them.
template <int VW> struct GsVec;
template <> struct GsVec<4> {
  typedef int4 T;
  typedef uint32_t M;
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
  // each validity byte to 0 or 1 (as the plain version's bool)
  static __device__ __forceinline__ M norm(M x) {
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    return x & 0x01010101u;
  }
};
template <> struct GsVec<1> {
  typedef int32_t T;
  typedef uint8_t M;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ M norm(M x) { return x != 0; }
};

template <int VW>
__global__ void __launch_bounds__(GS_THREADS)
gather_states_kernel(const int32_t* __restrict__ st, const uint8_t* __restrict__ valid,
                     int B, int Fc, const int32_t* __restrict__ ridx, int npad, int n,
                     int Fe, int tx_log2, int32_t* __restrict__ out,
                     uint8_t* __restrict__ out_valid) {
  typedef GsVec<VW> V;
  typedef typename V::T T;
  typedef typename V::M M;
  const int tx = 1 << tx_log2;
  const int s0 = (int)threadIdx.x & (tx - 1);
  const int i = (int)blockIdx.x * (GS_THREADS >> tx_log2) + ((int)threadIdx.x >> tx_log2);
  if (i >= npad) return;  // a whole segment: its lanes share i
  int r = s0 == 0 ? ridx[i] : 0;
  if (tx > 1) {
    const unsigned seg = tx == 32 ? 0xFFFFFFFFu
                                  : ((1u << (tx & 31)) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(tx - 1));
    r = __shfl_sync(seg, r, 0, tx);
  }
  const int nv = Fe / VW;                          // vectors of an output row
  const int nc = (Fc < Fe ? Fc : Fe) / VW;         // of them copied
  const int64_t S = (int64_t)B * Fc / VW;          // operand stride, in vectors
  const int64_t O = (int64_t)npad * Fe / VW;
  const T* src = reinterpret_cast<const T*>(st) + (int64_t)r * (Fc / VW);
  const M* vsrc = reinterpret_cast<const M*>(valid + (int64_t)r * Fc);
  T* dst = reinterpret_cast<T*>(out) + (int64_t)i * nv;
  M* vdst = reinterpret_cast<M*>(out_valid + (int64_t)i * Fe);
  const bool live = i < n;
  for (int s = s0; s < nv; s += tx) {
    T a0 = V::zero(), a1 = V::zero(), a2 = V::zero(), a3 = V::zero();
    M m = 0;
    if (s < nc) {
      a0 = src[s];
      a1 = src[S + s];
      a2 = src[2 * S + s];
      a3 = src[3 * S + s];
      m = live ? V::norm(vsrc[s]) : (M)0;
    }
    dst[s] = a0;
    dst[O + s] = a1;
    dst[2 * O + s] = a2;
    dst[3 * O + s] = a3;
    vdst[s] = m;
  }
}

extern "C" int genmap_gather_states(const void* st, const void* valid, int B,
                                    int Fc, const void* ridx, int npad, int n,
                                    int Fe, void* out, void* out_valid,
                                    void* stream) {
  if ((int64_t)npad * Fe == 0) return 0;
  const bool wide = Fc % 4 == 0 && Fe % 4 == 0 && (uintptr_t)st % 16 == 0 &&
                    (uintptr_t)out % 16 == 0 && (uintptr_t)valid % 4 == 0 &&
                    (uintptr_t)out_valid % 4 == 0;
  const int items = wide ? Fe / 4 : Fe;
  int tx_log2 = 0;
  while ((1 << tx_log2) < items && tx_log2 < 5) ++tx_log2;
  const int per_block = GS_THREADS >> tx_log2;
  const unsigned int blocks = (unsigned int)((npad + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    gather_states_kernel<4><<<blocks, GS_THREADS, 0, s>>>(
        (const int32_t*)st, (const uint8_t*)valid, B, Fc, (const int32_t*)ridx, npad, n,
        Fe, tx_log2, (int32_t*)out, (uint8_t*)out_valid);
  } else {
    gather_states_kernel<1><<<blocks, GS_THREADS, 0, s>>>(
        (const int32_t*)st, (const uint8_t*)valid, B, Fc, (const int32_t*)ridx, npad, n,
        Fe, tx_log2, (int32_t*)out, (uint8_t*)out_valid);
  }
  return (int)cudaGetLastError();
}
