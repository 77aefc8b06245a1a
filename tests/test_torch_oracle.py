"""The port's brute-force oracle (`genmap_tpu_torch.engine.oracle`) against
the JAX package's (`genmap_tpu.engine.oracle`): equal uint32 vectors on the
same inputs, made from a numpy seed.  Both are numpy; the port's takes its
reverse complement from its own alphabet.
"""

import numpy as np
import pytest

from genmap_tpu.engine.oracle import trivial_frequency as jax_oracle
from genmap_tpu_torch.engine.oracle import trivial_frequency


@pytest.mark.parametrize("cap", [255, 65535])
@pytest.mark.parametrize("errors", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("rev_compl", [True, False])
@pytest.mark.parametrize("alpha", [4, 5])
def test_oracle_equals_jax(alpha, rev_compl, errors, cap):
    """Three sequences of a genome and a file of two other sequences (so
    that index and queries differ), with a repeat that passes the 255 cap
    at the higher error counts; an N in a query never matches."""
    rng = np.random.default_rng(1000 + 100 * alpha + 10 * errors + rev_compl)
    seqs = [rng.integers(0, alpha, size=n, dtype=np.uint8) for n in (90, 70, 40)]
    seqs[1][:36] = np.tile(seqs[0][:4], 9)  # a short tandem repeat
    file_seqs = [seqs[0], rng.integers(0, alpha, size=25, dtype=np.uint8)]
    k = errors + 1 + (errors >= 2) + 2
    want = jax_oracle(seqs, file_seqs, k, errors, cap, rev_compl)
    got = trivial_frequency(seqs, file_seqs, k, errors, cap, rev_compl)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 2  # the repeat is counted


@pytest.mark.parametrize("K,errors", [(4, 0), (6, 0), (6, 1), (9, 2), (21, 3), (30, 4)])
def test_sequences_shorter_than_k(K, errors):
    """Sequences shorter than K (and one of exactly K) contribute no window
    and keep frequency 0; k-mers that span a boundary are 0."""
    rng = np.random.default_rng(2 + K)
    seqs = [rng.integers(0, 5, size=n, dtype=np.uint8) for n in (20, 3, K, 6, 40)]
    for rc in (True, False):
        want = jax_oracle(seqs, seqs, K, errors, 65535, rc)
        got = trivial_frequency(seqs, seqs, K, errors, 65535, rc)
        np.testing.assert_array_equal(got, want, err_msg=f"rc={rc}")
    assert not got[20:23].any()  # the 3-base sequence
