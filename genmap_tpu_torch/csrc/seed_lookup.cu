// The pooled infix scan's starting pool: one seed-table lookup per plan.
//
// Replaces: genmap_tpu/search/engine.py:_search_infix:529-555 (the seeded
// prefix; _search_infix_dimer:687-713 is the same code).  Every search plan
// opens with t_seed exact steps, so its state after them is the FMD
// interval of the needle window it consumed, read from the seed tables of
// genmap_tpu/ops/rank.py:with_seed_tables: per plan, the window's code and
// its reverse complement's, and gathers of seed_mlo[code],
// seed_size[code] and seed_mlo[rc_code].
//
// Bound on the H100: bytes.  The [5, B, Fp] state and [B, Fp] validity
// outputs are most of them; per (block, plan) t_seed needle bytes and three
// 4-byte table reads (random over the ~4^t_seed-entry tables, so each read
// moves a 32-byte sector).
//
// Design: one thread per (block, pool slot), so that neighbouring threads
// write neighbouring output words.  Slot p < P looks plan p up (without
// seed tables, t_seed = 0, it holds the whole index: size n_total); slots
// P..Fp-1 are zero and invalid.  Every slot carries its plan id p % P, as
// in the JAX package.  A window that holds an N, or an empty interval,
// leaves the slot invalid.

#include "genmap.cuh"

__global__ void seed_lookup_kernel(const uint32_t* __restrict__ seed_mlo,
                                   const uint32_t* __restrict__ seed_size,
                                   const uint8_t* __restrict__ needles, int Ln,
                                   const int32_t* __restrict__ a_pos, int P,
                                   int t_seed, uint32_t off, uint32_t n_total,
                                   int B, int Fp, int32_t* __restrict__ st,
                                   uint8_t* __restrict__ valid) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t N = (int64_t)B * Fp;
  if (idx >= N) return;
  const int b = (int)(idx / Fp);
  const int s = (int)(idx - (int64_t)b * Fp);
  uint32_t flo = 0, rlo = 0, size = 0;
  uint8_t ok = 0;
  if (s < P) {
    if (t_seed == 0) {
      size = n_total;
      ok = 1;
    } else {
      const uint8_t* w = needles + (int64_t)b * Ln + a_pos[s];
      // code = sum w_i 4^(t-1-i); rc_code = sum (3 - w_i) 4^i
      uint32_t code = 0, rc = 0, pw = 1;
      bool okw = true;
      for (int i = 0; i < t_seed; ++i) {
        uint32_t c = w[i];
        okw = okw && c < 4u;
        c = c < 3u ? c : 3u;
        code = code * 4u + c;
        rc += (3u - c) * pw;
        pw *= 4u;
      }
      flo = seed_mlo[off + code];
      size = seed_size[off + code];
      rlo = seed_mlo[off + rc];
      ok = (okw && size != 0u) ? 1 : 0;
    }
  }
  st[idx] = (int32_t)flo;
  st[N + idx] = (int32_t)rlo;
  st[2 * N + idx] = (int32_t)size;
  st[3 * N + idx] = 0;
  st[4 * N + idx] = s % P;
  valid[idx] = ok;
}

extern "C" int genmap_seed_lookup(const void* seed_mlo, const void* seed_size,
                                  const void* needles, int Ln, const void* a_pos,
                                  int P, int t_seed, unsigned int off,
                                  unsigned int n_total, int B, int Fp, void* st,
                                  void* valid, void* stream) {
  const int64_t n = (int64_t)B * Fp;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  seed_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seed_mlo, (const uint32_t*)seed_size,
      (const uint8_t*)needles, Ln, (const int32_t*)a_pos, P, t_seed, off,
      n_total, B, Fp, (int32_t*)st, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
