"""`kernels.seed_build` (the seed tables of an index part) against the JAX
package's `with_seed_tables`, against a naive count of the strings, and,
where g++ is installed, the CUDA source `csrc/seed_build.cu` compiled for
the CPU against a minimal mock of the CUDA runtime (blocks and threads run
one after another: the kernels use no block-level sync or warp collective).

The same numpy-built host index goes to both packages.  All arithmetic is
integer: every comparison is exact (byte-equal tables).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from genmap_tpu.index.build import build_index as jax_build_index
from genmap_tpu.io.fasta import FastaFile as JaxFastaFile
from genmap_tpu.ops import rank as jr
from genmap_tpu_torch import kernels
from genmap_tpu_torch.alphabet import revcomp_codes
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr

torch.set_num_threads(1)


def _seqs(alpha, n, seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, size=n, dtype=np.uint8)
    if n > 2000:
        seq[1000:1600] = np.tile(seq[:100], 6)  # a repeat: wide intervals
    if alpha == 5:
        seq[rng.integers(0, n, max(1, n // 200))] = 4
        seq[n // 3 : n // 3 + min(60, n // 10)] = 4
    return [seq, rng.integers(0, 4, size=max(1, n // 3), dtype=np.uint8)]


_CACHE = {}


def _indexes(alpha, n=3000, seed=7):
    """(seqs, the port's CPU index, the JAX package's index) of one part,
    both from the same host index arrays, with no seed tables built yet."""
    key = (alpha, n, seed)
    if key not in _CACHE:
        seqs = _seqs(alpha, n, seed + alpha)
        ff = FastaFile(name="g.fa")
        ff.ids, ff.seqs = [f"s{i}" for i in range(len(seqs))], seqs
        data = build_index([ff], sampling=4)
        part = data.parts[0]
        ti = tr.DeviceIndex.from_numpy(part.fwd.blocks, part.C, part.strand_blocks,
                                       has_n=data.has_n, sampling=data.sampling,
                                       device="cpu", seed_t0=0)
        jff = JaxFastaFile(name="g.fa")
        jff.ids, jff.seqs = ff.ids, seqs
        jdata = jax_build_index([jff], sampling=4)
        ji = jr.DeviceIndex.from_part(jdata, jdata.parts[0], light=True)
        _CACHE[key] = (seqs, ti, ji)
    return _CACHE[key]


def _u(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("t0", [0, 1, 3, "depth", "below"])
def test_seed_build_plain_equals_jax(alpha, t0):
    """Byte-equal to JAX's with_seed_tables at t0 = 0, 1, 3, the part's
    seed_depth, and a t0 below it (a part mesh passes its smallest part's
    depth to every part)."""
    _seqs_, ti, ji = _indexes(alpha)
    depth = tr.seed_depth(ti.n_total)
    t = {"depth": depth, "below": depth - 2}.get(t0, t0)
    mlo, size = kernels.seed_build(ti, t)
    assert mlo.dtype == size.dtype == torch.int32
    assert mlo.shape == size.shape == (tr.seed_level_offset(t + 1),)
    jt = jr.with_seed_tables(ji, t)
    np.testing.assert_array_equal(_u(mlo), _u(jt.seed_mlo))
    np.testing.assert_array_equal(_u(size), _u(jt.seed_size))
    # with_seed_tables attaches the same tables and records the depth
    wt = tr.with_seed_tables(ti, None if t0 == "depth" else t)
    assert wt.seed_t0 == t
    assert torch.equal(wt.seed_mlo, mlo) and torch.equal(wt.seed_size, size)


def _count(seqs, w):
    """Occurrences of the code string w in the index's text (both
    strands), overlapping ones included."""
    n = 0
    for s in list(seqs) + [revcomp_codes(s) for s in seqs]:
        if len(s) >= len(w):
            win = np.lib.stride_tricks.sliding_window_view(s, len(w))
            n += int((win == np.asarray(w, dtype=s.dtype)).all(axis=1).sum())
    return n


@pytest.mark.parametrize("alpha", [4, 5])
def test_levels_are_c_major_and_count_the_strings(alpha):
    """On a tiny index: level t starts at (4^t - 1) / 3; entry c * 4^t +
    code(w) of level t + 1 is the string c.w (code big-endian, first
    character most significant), so its size is the count of c.w in the
    text and its mlo is C[c] + occ(c, lo(w)) (the extension of w); within a
    level the intervals rise with the code (lexicographic order)."""
    seqs, ti, _ji = _indexes(alpha, n=90, seed=3)
    t0 = 3
    mlo, size = (_u(x) for x in kernels.seed_build(ti, t0))
    assert [tr.seed_level_offset(t) for t in range(5)] == [0, 1, 5, 21, 85]
    assert mlo[0] == 0 and size[0] == ti.n_total
    for t in range(1, t0 + 1):
        off = tr.seed_level_offset(t)
        lv_mlo, lv_size = mlo[off : off + 4**t], size[off : off + 4**t]
        for code in range(4**t):
            w = [(code >> (2 * (t - 1 - i))) & 3 for i in range(t)]
            assert lv_size[code] == _count(seqs, w), (t, w)
        assert (np.diff(lv_mlo) >= 0).all()
        # c.w from w: the exact extension of the parent level's intervals
        poff = tr.seed_level_offset(t - 1)
        p_mlo = torch.from_numpy(mlo[poff : poff + 4 ** (t - 1)])
        p_size = torch.from_numpy(size[poff : poff + 4 ** (t - 1)])
        nm, ns, _no = tr.extend_core(ti, p_mlo, p_size, torch.zeros_like(p_mlo))
        np.testing.assert_array_equal(lv_mlo, nm[:, :4].T.reshape(-1).numpy())
        np.testing.assert_array_equal(lv_size, ns[:, :4].T.reshape(-1).numpy())


@pytest.mark.parametrize("alpha", [4, 5])
def test_empty_children_keep_their_extension(alpha):
    """A part whose intervals empty out before t0: an empty child is not
    zeroed and not skipped, its mlo is C[c] + occ(c, lo) of its parent (so
    its own children sit at the same place, empty too)."""
    _seqs_, ti, ji = _indexes(alpha, n=40, seed=5)
    t0 = 6
    mlo, size = (_u(x) for x in kernels.seed_build(ti, t0))
    jt = jr.with_seed_tables(ji, t0)
    np.testing.assert_array_equal(mlo, _u(jt.seed_mlo))
    np.testing.assert_array_equal(size, _u(jt.seed_size))
    off = tr.seed_level_offset(t0)
    last_mlo, last_size = mlo[off:], size[off:]
    assert (last_size == 0).mean() > 0.9  # the deepest level is nearly all empty
    assert (last_mlo[last_size == 0] != 0).any()
    C = _u(ti.C)
    poff = tr.seed_level_offset(t0 - 1)
    for code in np.flatnonzero(last_size == 0)[:200]:
        c, w = divmod(int(code), 4 ** (t0 - 1))
        lo = torch.tensor([mlo[poff + w]])
        occ, _sent = tr._occ_sub(ti.fwd_blocks[lo >> 9, : tr.sub_width(ti.has_n)], lo,
                                 ti.has_n)
        assert last_mlo[code] == (C[c] + int(occ[0, c])) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# csrc/seed_build.cu on a CPU mock of the CUDA runtime
# ---------------------------------------------------------------------------

_MOCK_RUNTIME = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <functional>
struct mock_dim3 { unsigned x, y, z; };
static thread_local mock_dim3 blockIdx, threadIdx;
static mock_dim3 gridDim, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
static inline int cudaGetLastError() { return 0; }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
static inline void mock_launch(unsigned grid, unsigned threads, std::function<void()> f) {
  gridDim = {grid, 1, 1};
  blockDim = {threads, 1, 1};
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {t, 0, 0};
      f();
    }
}
"""
_LAUNCH = re.compile(r"(\w+)\s*<<<(.*?),\s*([^,]*?),\s*[^,]*?,\s*[^>]*?>>>\s*\((.*?)\);", re.S)


def _mock_library(tmp, shallow):
    """seed_build.cu built with g++ against the mock runtime (each
    `kernel<<<grid, threads, 0, stream>>>(args);` rewritten into a loop
    over blocks and threads), SB_SHALLOW overridden."""
    with open(os.path.join(kernels.CSRC, "seed_build.cu")) as f:
        src = _LAUNCH.sub(lambda m: f"mock_launch({m.group(2)}, {m.group(3)}, "
                                    f"[&]{{ {m.group(1)}({m.group(4)}); }});", f.read())
    assert src.count("mock_launch(") == 2
    inc = os.path.join(tmp, "inc")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "cuda_runtime.h"), "w") as f:
        f.write(_MOCK_RUNTIME)
    cpp = os.path.join(tmp, "seed_build_mock.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(tmp, f"libseed_build_mock_{shallow}.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", inc,
                    "-I", kernels.CSRC, f"-DSB_SHALLOW={shallow}", "-o", lib, cpp],
                   check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    so.genmap_seed_build_shallow.argtypes = kernels.SEED_BUILD.entries["_shallow"]
    so.genmap_seed_build_level.argtypes = kernels.SEED_BUILD.entries["_level"]
    assert [P, I, I, I, P, U, I, P, P, P] == so.genmap_seed_build_shallow.argtypes
    return so


def _mock_build(so, index, t0):
    """The launches of kernels.seed_build, made on CPU tensors through the
    mock library (the tables start poisoned, so an entry no launch writes
    shows)."""
    total = tr.seed_level_offset(t0 + 1)
    mlo = torch.full((total,), 0x5A5A5A5A, dtype=torch.int32)
    size = torch.full((total,), 0x5A5A5A5A, dtype=torch.int32)
    nrows, w = index.fwd_blocks.shape
    rows = (index.fwd_blocks.data_ptr(), w, nrows, int(index.has_n), index.C.data_ptr())
    L = min(t0, so.genmap_seed_build_depth())
    assert so.genmap_seed_build_shallow(*rows, index.n_total & 0xFFFFFFFF, L,
                                        mlo.data_ptr(), size.data_ptr(), None) == 0
    for t in range(L, t0):
        assert so.genmap_seed_build_level(*rows, t, mlo.data_ptr(), size.data_ptr(),
                                          None) == 0
    return mlo, size


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ for the CPU mock")
@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("shallow", [0, 2, 3, 8])
def test_cuda_source_on_a_cpu_mock_equals_plain(alpha, shallow, tmp_path):
    """csrc/seed_build.cu, run on the CPU through the mock runtime with the
    shallow launch 0, 2, 3 and 8 levels deep, equals seed_build_plain at
    every
    t0 from 0 to one past the part's depth, on parts of 82, 512, 514, 1,024
    and 6,002 symbols (hi = n_total at a sub-row's start and end; intervals
    that empty out; a sub-row shared by both bounds and not)."""
    so = _mock_library(str(tmp_path), shallow)
    for n, seed in ((40, 5), (255, 2), (256, 3), (511, 6), (3000, 7)):
        _seqs_, ti, _ji = _indexes(alpha, n=n, seed=seed)
        for t0 in range(0, tr.seed_depth(ti.n_total) + 2):
            want = kernels.seed_build_plain(ti, t0)
            got = _mock_build(so, ti, t0)
            for g, w_ in zip(got, want):
                assert torch.equal(g, w_), (n, t0)


def test_wrapper_checks_its_arguments():
    _seqs_, ti, _ji = _indexes(4)
    assert kernels.KERNELS["seed_build"] is kernels.SEED_BUILD
    assert kernels.SEED_BUILD.replaces == "genmap_tpu/ops/rank.py:345"
    kernels.reset_launches()
    kernels.seed_build(ti, 2)  # a CPU index: the plain version, no launch
    assert kernels.launch_counts()["seed_build"] == 0
