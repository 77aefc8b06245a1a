"""Multi-part indexes on one device in genmap_tpu_torch (after
tests/test_engine_differential.py::test_multipart_matches_single).

A forced split (`build_index(max_part_symbols=...)`, three or more parts)
must give the frequencies of the single-part index, of the JAX engine on the
same split and of the oracle; the probe sums its per-plan masses over the
parts on the device and skips exactly the blocks the JAX engine skips;
dedup's two key paths (packed values, per-part zero-error intervals) change
nothing; the dimer tier runs on every part.  Integer results: exact.
"""

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.engine.oracle import trivial_frequency
from genmap_tpu_torch import kernels
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)


def _index(seqs, max_part=None, sampling=3):
    ff = FastaFile(name="genome.fa")
    ff.ids = [f"seq{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    if max_part is None:
        return build_index([ff], sampling=sampling)
    return build_index([ff], sampling=sampling, max_part_symbols=max_part)


@pytest.mark.parametrize("errors,K,o,rc", [(0, 6, 4, True), (1, 8, 6, False), (2, 8, 6, True)])
def test_multipart_matches_single_jax_and_oracle(errors, K, o, rc):
    """Four sequences of 90 bp (one with N, two sharing a 30 bp unit) in
    four equal parts."""
    rng = np.random.default_rng(900 + errors)
    unit = rng.integers(0, 4, size=30, dtype=np.uint8)
    seqs = [rng.integers(0, 4, size=90, dtype=np.uint8),
            np.concatenate([unit, rng.integers(0, 5, size=60, dtype=np.uint8)]),
            np.concatenate([rng.integers(0, 4, size=60, dtype=np.uint8), unit]),
            rng.integers(0, 4, size=90, dtype=np.uint8)]
    one, split = _index(seqs), _index(seqs, max_part=200)
    assert len(split.parts) == 4
    want = trivial_frequency(seqs, seqs, K, errors, 255, rc)
    for data in (one, split):
        eng = MappabilityEngine(data, batch_blocks=16, device="cpu")
        got = eng.compute_file(eng.layouts[0], SearchParams(K, o, rc), errors, 255).c
        np.testing.assert_array_equal(got, want, err_msg=f"{len(data.parts)} parts")
    jeng = JaxEngine(split, batch_blocks=16)
    np.testing.assert_array_equal(
        jeng.compute_file(jeng.layouts[0], JaxParams(K, o, rc), errors, 255).c, want)


def test_multipart_probe_matches_jax(monkeypatch):
    """40 kbp in three equal parts, (64,1): 1,250 blocks of 32 k-mers pass
    the probe's 2^15 k-mer gate.  Every probe batch accumulates the parts'
    masses (two launches with last=False, one deciding launch)."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, size=39_999, dtype=np.uint8)
    s[25_000:33_000] = np.tile(s[10_000:10_400], 20)  # repeats across parts
    seqs = [s[:13_333], s[13_333:26_666], s[26_666:]]
    split = _index(seqs, max_part=30_000, sampling=5)
    assert len(split.parts) == 3
    K, E, O = 64, 1, 33
    calls = []
    orig = kernels.probe_mass

    def spy(*a, **kw):
        calls.append((kw.get("acc") is not None, kw.get("last", True)))
        return orig(*a, **kw)

    monkeypatch.setattr(kernels, "probe_mass", spy)
    res = {}
    for probe in (True, False):
        eng = MappabilityEngine(split, batch_blocks=1024, dedup=False, device="cpu")
        eng._probe_enabled = probe
        eng._calibrate_enabled = False  # like for like with the JAX engine
        res[probe] = (eng.compute_file(eng.layouts[0], SearchParams(K, O), E, 65535).c,
                      eng.stats["probe_skipped"])
    jeng = JaxEngine(split, batch_blocks=1024, dedup=False)
    jeng._calibrate_enabled = False
    want = jeng.compute_file(jeng.layouts[0], JaxParams(K, O), E, 65535).c
    (cp, sp), (cf, sf) = res[True], res[False]
    assert sp == jeng.stats["probe_skipped"] and sp > 0.5 * (len(s) // 32) and sf == 0
    np.testing.assert_array_equal(cp, cf)
    np.testing.assert_array_equal(cp, want)
    assert (cp > 1).sum() > 5000
    assert calls and calls[:3] == [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("ke", [(20, 1, 16), (30, 2, 27)], ids=["value_keys", "interval_keys"])
def test_multipart_dedup_matches_normal(ke, monkeypatch):
    """A genome that holds a second copy of itself, the copy in another
    part: dedup takes over on both key paths (the interval keys are one
    (flo, size) pair per part)."""
    K, e, o = ke
    rng = np.random.default_rng(17)
    half = rng.integers(0, 4, 4300, dtype=np.uint8)
    half[rng.integers(0, len(half), 5)] = 4
    seqs = [half, half.copy(), rng.integers(0, 4, 300, dtype=np.uint8)]
    split = _index(seqs, max_part=9000, sampling=4)
    assert len(split.parts) == 3
    ran = []
    orig = MappabilityEngine._compute_with_dedup

    def spy(self, *a, **kw):
        ran.append(orig(self, *a, **kw))
        return ran[-1]

    monkeypatch.setattr(MappabilityEngine, "_compute_with_dedup", spy)
    out = {}
    for dedup in (True, False):
        eng = MappabilityEngine(split, batch_blocks=64, dedup=dedup, device="cpu")
        lay = eng.layouts[0]
        eng._dup_rate_cache[(lay.start, lay.length, K)] = 0.5  # the known share
        out[dedup] = eng.compute_file(lay, SearchParams(K, o), e, 255).c
    assert ran == [True]
    np.testing.assert_array_equal(out[True], out[False])
    assert (out[True][:4300 - K] >= 2).mean() > 0.9


def test_dimer_tier_runs_on_every_part(monkeypatch):
    rng = np.random.default_rng(5)
    s = rng.integers(0, 4, size=24_000, dtype=np.uint8)
    s[15_000:17_000] = np.tile(s[2_000:2_100], 20)
    seqs = [s[:8000], s[8000:16_000], s[16_000:]]
    one, split = _index(seqs, sampling=4), _index(seqs, max_part=20_000, sampling=4)
    assert len(split.parts) == 3
    seen = set()
    orig = kernels.dimer_step

    def spy(index, *a, **kw):
        seen.add(id(index))
        return orig(index, *a, **kw)

    monkeypatch.setattr(kernels, "dimer_step", spy)
    K, e, o = 24, 1, 20
    eng2 = MappabilityEngine(split, batch_blocks=256, device="cpu", dimer_tier=True)
    got = eng2.compute_file(eng2.layouts[0], SearchParams(K, o), e, 65535).c
    assert eng2.stats["dimer_tier"]
    assert seen == {id(ix) for ix in eng2.indices}
    eng1 = MappabilityEngine(one, batch_blocks=256, device="cpu", dimer_tier=False)
    np.testing.assert_array_equal(
        got, eng1.compute_file(eng1.layouts[0], SearchParams(K, o), e, 65535).c)
