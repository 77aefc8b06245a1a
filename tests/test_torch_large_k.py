"""Differential tests of genmap_tpu_torch at realistic k against the port's
brute-force oracle, on the CPU (the kernels' plain versions).

The port's counterpart of tests/test_large_k.py, including GenMap's bowtie
cross-validation configuration (20,1) (tests/bowtie-test.sh).
"""

import numpy as np
import pytest
import torch

from genmap_tpu_torch.cli.map_cmd import default_overlap
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.engine.oracle import trivial_frequency
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)


def _engine_for(seqs):
    ff = FastaFile(name="genome.fa")
    ff.ids = [f"seq{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    data = build_index([ff], sampling=7)
    return MappabilityEngine(data, batch_blocks=32, device="cpu")


@pytest.mark.parametrize(
    "K,errors,overlap_frac",
    [
        (20, 1, None),   # the bowtie-test configuration (quick tier)
        pytest.param(24, 2, None, marks=pytest.mark.slow),
        pytest.param(30, 2, 0.5, marks=pytest.mark.slow),
        pytest.param(16, 3, None, marks=pytest.mark.slow),
        (12, 0, None),
    ],
)
def test_large_k_differential(K, errors, overlap_frac):
    rng = np.random.default_rng(K * 100 + errors)
    # planted repeats so frequencies > 1 occur at large K
    seq = rng.integers(0, 4, size=3000, dtype=np.uint8)
    block = seq[100:160].copy()
    for p in (500, 1200, 2444):
        seq[p : p + 60] = block
    seqs = [seq, rng.integers(0, 4, size=800, dtype=np.uint8)]

    eng = _engine_for(seqs)
    if overlap_frac is None:
        x = default_overlap(K, errors)
    else:
        x = int(K * overlap_frac)
    x = min(x, K - errors - 2, K - 1)
    o = K - x
    for rev_compl in (True, False):
        params = SearchParams(length=K, overlap=o, rev_compl=rev_compl)
        cap = 255
        res = eng.compute_file(eng.layouts[0], params, errors, cap)
        expected = trivial_frequency(seqs, seqs, K, errors, cap, rev_compl)
        np.testing.assert_array_equal(
            res.c, expected, err_msg=f"K={K} e={errors} o={o} rc={rev_compl}"
        )
    assert expected.max() >= 4  # the planted repeat
