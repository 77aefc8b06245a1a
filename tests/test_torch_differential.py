"""Differential test of genmap_tpu_torch against the port's brute-force
oracle, on the CPU (the kernels' plain versions).

The port's counterpart of tests/test_engine_differential.py (after GenMap's
randomized test, tests/tests.cpp:133-210): random multi-chromosome genomes,
every error count, every legal overlap, Dna4 and Dna5, with and without the
reverse complement; frequency vectors must match exactly.  The oracle is
held against the JAX package's in tests/test_torch_oracle.py.  The JAX
file's quick cases that the port covers elsewhere stay there:
`test_quick_differential` is test_torch_mappability.py's `test_oracle`,
`test_multipart_matches_single` test_torch_multipart.py's, and
`test_dedup_matches_normal` test_torch_dedup.py's.
"""

import numpy as np
import pytest
import torch

from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.engine.oracle import trivial_frequency
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)


def _mk_engine(seqs_codes, batch_blocks=64):
    ff = FastaFile(name="genome.fa")
    ff.ids = [f"seq{i}" for i in range(len(seqs_codes))]
    ff.seqs = seqs_codes
    data = build_index([ff], sampling=3)
    return MappabilityEngine(data, batch_blocks=batch_blocks, device="cpu")


def _run_case(rng, errors, alpha, nseq=3, seqlen=120, ks=None, cap=255):
    seqs = [rng.integers(0, alpha, size=seqlen, dtype=np.uint8) for _ in range(nseq)]
    eng = _mk_engine(seqs)
    layout = eng.layouts[0]
    min_k = errors + 1 + (errors >= 2)
    ks = ks or range(min_k, 9)
    for k in ks:
        rev_compl = bool(rng.integers(0, 2))
        expected = trivial_frequency(seqs, seqs, k, errors, cap, rev_compl)
        for overlap in range(min_k, k + 1):
            params = SearchParams(length=k, overlap=overlap, rev_compl=rev_compl)
            res = eng.compute_file(layout, params, errors, cap)
            np.testing.assert_array_equal(
                res.c, expected, err_msg=f"k={k} o={overlap} e={errors} rc={rev_compl}"
            )


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4, 5])
def test_exact(alpha):
    _run_case(np.random.default_rng(100 + alpha), 0, alpha)


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4, 5])
def test_hamming_1(alpha):
    _run_case(np.random.default_rng(200 + alpha), 1, alpha, ks=[2, 4, 6])


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4, 5])
def test_hamming_2(alpha):
    _run_case(np.random.default_rng(300 + alpha), 2, alpha, ks=[4, 6, 8])


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4, 5])
def test_hamming_3(alpha):
    _run_case(np.random.default_rng(400 + alpha), 3, alpha, ks=[5, 8])


@pytest.mark.slow
@pytest.mark.parametrize("alpha", [4, 5])
def test_hamming_4(alpha):
    _run_case(np.random.default_rng(500 + alpha), 4, alpha, ks=[6, 8])


def test_saturation_uint8():
    # a genome that is one repeated letter: every k-mer saturates the cap
    seqs = [np.zeros(300, dtype=np.uint8)]
    eng = _mk_engine(seqs)
    layout = eng.layouts[0]
    params = SearchParams(length=4, overlap=4, rev_compl=False)
    res = eng.compute_file(layout, params, 0, 255)
    expected = trivial_frequency(seqs, seqs, 4, 0, 255, False)
    np.testing.assert_array_equal(res.c, expected)
    assert res.c[0] == 255


def test_sequences_shorter_than_k():
    rng = np.random.default_rng(2)
    seqs = [
        rng.integers(0, 4, size=20, dtype=np.uint8),
        rng.integers(0, 4, size=3, dtype=np.uint8),
        rng.integers(0, 4, size=6, dtype=np.uint8),
    ]
    eng = _mk_engine(seqs)
    layout = eng.layouts[0]
    for k, o in [(4, 4), (6, 6), (4, 2), (6, 4)]:
        params = SearchParams(length=k, overlap=o, rev_compl=True)
        res = eng.compute_file(layout, params, 0, 65535)
        expected = trivial_frequency(seqs, seqs, k, 0, 65535, True)
        np.testing.assert_array_equal(res.c, expected, err_msg=f"k={k} o={o}")
