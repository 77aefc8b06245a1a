"""genmap_tpu_torch's engine on the CPU: agreement with the JAX engine and
the tier ladder's escalation and rescue paths, against the oracle.

Frequencies are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.engine.oracle import trivial_frequency
from genmap_tpu.index.build import build_index as jax_build_index
from genmap_tpu.io.fasta import FastaFile as JaxFastaFile
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.search.engine import Tier

torch.set_num_threads(1)


def _seqs(alpha, seed, nseq=3, seqlen=120):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, alpha, size=seqlen, dtype=np.uint8) for _ in range(nseq)]


def _engine(seqs, **kw):
    ff = FastaFile(name="genome.fa")
    ff.ids = [f"seq{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    return MappabilityEngine(build_index([ff], sampling=3), device="cpu", **kw)


def test_matches_jax_engine():
    """The port and the JAX engine (probe, dedup, calibration and all) give
    the same frequency vector on a repeat-rich Dna5 genome."""
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 5, size=40, dtype=np.uint8)
    seq = np.concatenate([np.tile(unit, 12), rng.integers(0, 4, size=500, dtype=np.uint8)])
    seqs = [seq, rng.integers(0, 4, size=200, dtype=np.uint8)]
    jff = JaxFastaFile(name="g.fa")
    jff.ids = ["a", "b"]
    jff.seqs = seqs
    jeng = JaxEngine(jax_build_index([jff], sampling=3), batch_blocks=64)
    eng = _engine(seqs, batch_blocks=64)
    for K, e, o, rc in ((12, 2, 9, True), (10, 1, 7, False)):
        want = jeng.compute_file(jeng.layouts[0], JaxParams(K, o, rc), e, 65535)
        got = eng.compute_file(eng.layouts[0], SearchParams(K, o, rc), e, 65535)
        np.testing.assert_array_equal(got.c, want.c, err_msg=f"K={K} e={e}")


def test_forced_escalation_through_a_tiny_ladder():
    """Tiny tiers force far-flag and capacity escalations through every rung
    (including a fast rung past the first); results stay exact."""
    seqs = _seqs(5, 31, nseq=2, seqlen=200)
    tiers = (Tier(2, 2, 1, exact=False), Tier(2, 2, 1), Tier(4, 4, 2, exact=False),
             Tier(16, 16, 4), Tier(256, 256, 64))
    eng = _engine(seqs, batch_blocks=16, tiers=tiers)
    K, e, o = 9, 2, 6
    res = eng.compute_file(eng.layouts[0], SearchParams(K, o, True), e, 255)
    np.testing.assert_array_equal(res.c, trivial_frequency(seqs, seqs, K, e, 255, True))
    tb = eng.stats["tier_blocks"]
    assert len(tb) >= 3 and max(tb) == len(tiers) - 1, tb


def test_rescue_pass_runs_and_never_returns_wrong_counts():
    """Capacity overflows at a tier with no larger successor fall off the
    routing table; the rescue pass re-runs them at the ladder's static last
    tier, and blocks it cannot resolve raise instead of returning counts."""
    seqs = _seqs(4, 41, nseq=2, seqlen=150)
    K, e, o = 8, 2, 5
    expected = trivial_frequency(seqs, seqs, K, e, 255, True)
    # tier 1 is the ladder's widest: its capacity overflows have nowhere to
    # go and reach the rescue pass at the (smaller) static last tier
    tiers = (Tier(2, 2, 1, exact=False), Tier(256, 256, 64), Tier(2, 2, 1))
    eng = _engine(seqs, batch_blocks=16, tiers=tiers)
    res = eng.compute_file(eng.layouts[0], SearchParams(K, o, True), e, 255)
    np.testing.assert_array_equal(res.c, expected)
    tiny = (Tier(2, 2, 1, exact=False), Tier(4, 4, 1), Tier(2, 2, 1))
    eng = _engine(seqs, batch_blocks=16, tiers=tiny)
    with pytest.raises(RuntimeError, match="overflowed the largest frontier tier"):
        eng.compute_file(eng.layouts[0], SearchParams(K, o, True), e, 255)
