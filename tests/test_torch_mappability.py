"""genmap_tpu_torch's compute_file against the brute-force oracle, on the
CPU (the kernels' plain versions).

Frequencies are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from genmap_tpu.engine.oracle import trivial_frequency
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)


def _seqs(alpha, seed, nseq=3, seqlen=120):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, alpha, size=seqlen, dtype=np.uint8) for _ in range(nseq)]


def _engine(seqs, **kw):
    ff = FastaFile(name="genome.fa")
    ff.ids = [f"seq{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    return MappabilityEngine(build_index([ff], sampling=3), device="cpu", **kw)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("errors", [0, 1, 2, 3, 4])
def test_oracle(alpha, errors):
    """e = 0..4 on Dna4 and Dna5, with and without the reverse complement."""
    seqs = _seqs(alpha, 900 + 10 * alpha + errors, seqlen=120 if errors < 3 else 90)
    eng = _engine(seqs, batch_blocks=64)
    min_k = errors + 1 + (errors >= 2)
    # high e on a few hundred bases matches nearly everything; a longer k
    # keeps the plain CPU path's frontiers (and this test) small
    k = min_k + (2 if errors < 3 else 5)
    for rc, overlap in ((True, min_k + 1), (False, min_k)):
        expected = trivial_frequency(seqs, seqs, k, errors, 255, rc)
        params = SearchParams(length=k, overlap=overlap, rev_compl=rc)
        res = eng.compute_file(eng.layouts[0], params, errors, 255)
        np.testing.assert_array_equal(res.c, expected, err_msg=f"rc={rc}")


def test_bed_selection_and_cap():
    """A BED-style selection computes only the selected k-mers; a repeat
    saturates the cap."""
    rng = np.random.default_rng(7)
    seqs = [np.concatenate([np.tile(rng.integers(0, 4, 5, dtype=np.uint8), 70),
                            rng.integers(0, 5, 200, dtype=np.uint8)]),
            rng.integers(0, 4, 150, dtype=np.uint8)]
    eng = _engine(seqs, batch_blocks=32)
    lay = eng.layouts[0]
    K, e = 8, 1
    params = SearchParams(length=K, overlap=6, rev_compl=True)
    intervals = [(10, 90), (300, 340), (560, 620)]
    res = eng.compute_file(lay, params, e, 60, intervals=intervals)
    full = trivial_frequency(seqs, seqs, K, e, 60, True)
    mask = np.zeros(len(full), bool)
    for b, e_ in intervals:
        mask[b:e_] = True
    np.testing.assert_array_equal(res.c[mask], full[mask])
    assert not res.c[~mask].any()
    assert (full[mask] == 60).any()
