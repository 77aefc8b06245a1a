"""Repeat-rich and low-complexity genomes through genmap_tpu_torch, on the
CPU (the kernels' plain versions), against the port's brute-force oracle.

The port's counterpart of tests/test_stress_repeats.py: a genome of tandem
repeats, homopolymer runs and dispersed mutated mobile-element copies, where
the fixed-capacity frontier tiers are stressed (huge SA intervals, deep
candidate fan-out); sampled positions are checked against the oracle (one
k-mer at a time: `trivial_frequency` over the genome's windows), and the
tier escalation must have run.  The genome and the sampled oracle are
chip_smoke.py's (its oracle phase runs these cases on the card); the
genome is held equal to the JAX test's.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_oracle", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the genome and the sampled oracle of chip_smoke.py's oracle phase
_SMOKE = _smoke()


def _engine(seq, name, sampling, batch_blocks):
    ff = FastaFile(name=name)
    ff.ids = ["chr1"]
    ff.seqs = [seq]
    return MappabilityEngine(build_index([ff], sampling=sampling),
                             batch_blocks=batch_blocks, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("ke", [(20, 1), (36, 2)])
def test_repeat_rich_sampled_oracle(ke):
    K, E = ke
    rng = np.random.default_rng(1000 + K)
    seq = _SMOKE.repeat_genome(rng)
    eng = _engine(seq, "rep.fa", sampling=8, batch_blocks=256)
    o = K - min(max(1, int(K * 0.25)), K - E - 2)
    params = SearchParams(length=K, overlap=o, rev_compl=True)
    res = eng.compute_file(eng.layouts[0], params, E, 65535)

    # repeat-rich text must stress the capacity tiers
    assert eng.stats["max_tier"] >= 1, eng.stats

    pos = rng.integers(0, len(seq) - K + 1, size=30)
    # make sure some sampled positions hit high-frequency (repeat) regions
    pos = np.concatenate([pos, np.argsort(res.c[: len(seq) - K + 1])[-3:]])
    np.testing.assert_array_equal(res.c[pos], _SMOKE.oracle_at([seq], pos, K, E, 65535))


def test_saturation_and_homopolymer():
    """Homopolymer genomes saturate the uint8 cap everywhere in range."""
    rng = np.random.default_rng(77)
    seq = np.concatenate([
        np.zeros(3000, np.uint8),
        rng.integers(0, 4, size=2000, dtype=np.uint8),
        np.full(3000, 3, np.uint8),
    ])
    eng = _engine(seq, "h.fa", sampling=5, batch_blocks=64)
    params = SearchParams(length=15, overlap=12, rev_compl=True)
    res = eng.compute_file(eng.layouts[0], params, 1, 255)
    # poly-A k-mers: thousands of occurrences on both strands -> saturated
    assert int(res.c[0]) == 255
    assert int(res.c[6500]) == 255  # poly-T region (also matches poly-A rc)
    # the random middle and its edges against the oracle
    pos = np.array([2990, 3000, 3500, 4000, 4500, 4990, 5000])
    np.testing.assert_array_equal(res.c[pos], _SMOKE.oracle_at([seq], pos, 15, 1, 255))


def test_repeat_genome_is_the_jax_tests():
    from test_stress_repeats import _repeat_genome

    a = _SMOKE.repeat_genome(np.random.default_rng(5), total=30_000)
    b = _repeat_genome(np.random.default_rng(5), total=30_000)
    np.testing.assert_array_equal(a, b)
