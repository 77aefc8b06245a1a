"""The dimer-table policy of genmap_tpu_torch's engine against the JAX
engine's and the oracle (after tests/test_dimer_engine.py and
tests/test_probe_dimer_cut.py).

`dimer_tier` True / False / None: the same frequencies, the same
`stats["dimer_tier"]` and the same blocks per tier as the JAX engine (its
occupancy calibration off: it only resizes pools); None runs tier 0 on the
dimer rows for a wide-pool configuration and mono otherwise, twins before
the wide exact tiers either way.  The flagged-fraction and ladder gates
decide as JAX's do.  The probe on a forced dimer tier 0 with a cut inside
the e=2 l-bound ramps skips what JAX skips and changes no frequency.  A
twin-expanded custom ladder that forces the rescue pass (where the JAX
engine raises IndexError, ROADMAP Queue 3) equals the oracle.  Integer
results: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.engine.oracle import trivial_frequency
from genmap_tpu.search.engine import DEFAULT_TIERS as JAX_TIERS
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.search.engine import DEFAULT_TIERS, Tier

torch.set_num_threads(1)


def _data(seed, n, repeats=False, nseq=1, with_n=False, dimer=True):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, size=n, dtype=np.uint8)
    if repeats:
        unit = rng.integers(0, 4, size=37, dtype=np.uint8)
        for off in range(0, n // 3, 4000):
            s[off : off + len(unit) * 3] = np.tile(unit, 3)
        s[n // 2 : n // 2 + n // 20] = np.tile(s[1000:1100], n // 2000)  # exact dups
    if with_n:
        s[rng.integers(0, n, size=5)] = 4
    ff = FastaFile(name="g.fa")
    ff.ids = [f"chr{i}" for i in range(nseq)]
    ff.seqs = [s[i * n // nseq : (i + 1) * n // nseq] for i in range(nseq)]
    return build_index([ff], sampling=5, dimer=dimer)


@pytest.fixture(scope="module")
def genome():
    """40 kbp, repeat-rich.  Its flagged sub-block fraction (~5e-3: two
    sequence ends in 630 sub-blocks) is set to what a genome-sized index
    reads, so that the automatic gate opens; the flagged sub-blocks still
    escalate their blocks, as they do on any genome."""
    data = _data(seed=241, n=40_000, repeats=True)
    assert data.parts[0].dimer_flag_frac >= 1e-3
    data.parts[0].dimer_flag_frac = 5e-4
    return data


def _both(data, mode, K, e, o, cap=65535, rev_compl=True, csv=False):
    """(port engine, its result, JAX engine, its result) of one compute."""
    eng = MappabilityEngine(data, batch_blocks=512, dedup=False, device="cpu",
                            dimer_tier=mode, light=not csv)
    eng._calibrate_enabled = False  # like for like with the JAX engine below
    got = eng.compute_file(eng.layouts[0], SearchParams(K, o, rev_compl), e, cap,
                           csv=csv)
    jeng = JaxEngine(data, batch_blocks=512, dedup=False, dimer_tier=mode,
                     light=not csv)
    jeng._calibrate_enabled = False  # pool resizing only; keeps tiers comparable
    want = jeng.compute_file(jeng.layouts[0], JaxParams(K, o, rev_compl), e, cap,
                             csv=csv)
    return eng, got, jeng, want


@pytest.mark.parametrize("mode,K,e,o,twin_from", [
    (True, 24, 1, 20, 32),  # forced: tier 0 and twins on the dimer rows
    (False, 24, 1, 20, None),  # never
    (None, 20, 1, 11, 4),  # auto: pool mean 17 >= 12, tier 0 on the dimer rows
    (None, 24, 1, 20, 32),  # auto: pool mean 4.4, tier 0 mono, twins only
], ids=["forced", "off", "auto_tier0", "auto_twins"])
def test_dimer_engine_matches_jax(genome, mode, K, e, o, twin_from):
    eng, got, jeng, want = _both(genome, mode, K, e, o)
    np.testing.assert_array_equal(got.c, want.c)
    assert eng.stats["dimer_tier"] == jeng.stats["dimer_tier"]
    assert eng.stats["dimer_tier"] == (mode is True or (mode is None and K == 20))
    assert eng.stats["tier_blocks"] == jeng.stats["tier_blocks"]
    ladder = [(t.f_search, t.dimer) for t in eng.stats["tiers"]]
    # a twin before every exact tier whose pool mean is >= 12 slots
    assert ladder[1:] == [x for t in DEFAULT_TIERS[1:] for x in
                          ([(t.f_search, True)] if twin_from and t.f_search >= twin_from
                           else []) + [(t.f_search, False)]]
    assert ladder[0][1] == eng.stats["dimer_tier"]


def test_dimer_csv_rev_compl_off_matches_jax():
    """CSV locations (the count kernel's zero-error outputs and the final
    states) and forward-only counts, with every tier on the dimer rows
    where it has a twin."""
    data = _data(seed=9, n=6000, repeats=True, nseq=2, with_n=True)
    eng, got, _jeng, want = _both(data, True, 20, 1, 14, cap=255,
                                  rev_compl=False, csv=True)
    assert eng.stats["dimer_tier"]
    np.testing.assert_array_equal(got.c, want.c)
    assert got.locations.keys() == want.locations.keys()
    for key, (f, r) in want.locations.items():
        (gf, gr) = got.locations[key]
        for a, b in zip(gf + gr, f + r):
            np.testing.assert_array_equal(a, b)


def test_dimer_gates_match_jax():
    small = _data(seed=12, n=30_000, nseq=10)
    assert small.parts[0].dimer_flag_frac >= 1e-3
    big_frac = _data(seed=12, n=30_000, nseq=10)
    big_frac.parts[0].dimer_flag_frac = 5e-4
    none = _data(seed=12, n=3000, nseq=2, dimer=False)
    for data, default, ok, forced_ok in ((small, True, False, True),
                                         (big_frac, True, True, True),
                                         (big_frac, False, False, True),
                                         (none, True, False, False)):
        # a copy of the default ladder is equal to it, but not the default
        eng = MappabilityEngine(data, device="cpu", tiers=DEFAULT_TIERS if default
                                else tuple(list(DEFAULT_TIERS)))
        jeng = JaxEngine(data, tiers=JAX_TIERS if default else tuple(list(JAX_TIERS)))
        assert (eng._dimer_ok, eng._dimer_forced_ok) == (ok, forced_ok)
        assert (jeng._dimer_ok, jeng._dimer_forced_ok) == (ok, forced_ok)
    # forced on an index without dimer rows: nothing runs on them
    eng = MappabilityEngine(none, device="cpu", dimer_tier=True)
    res = eng.compute_file(eng.layouts[0], SearchParams(12, 8), 1, 255)
    assert not eng.stats["dimer_tier"]
    seqs = [none.decode_slice(0, int(none.seq_lens[0])),
            none.decode_slice(int(none.seq_lens[0]), int(none.seq_lens[1]))]
    np.testing.assert_array_equal(res.c, trivial_frequency(seqs, seqs, 12, 1, 255, True))


def test_probe_on_forced_dimer_tier0_with_cut():
    """The probe on a dimer tier 0 with its scan cut amid the e=2 l-bound
    ramps (2-char steps straddling the cut must consume their first char
    only) skips what the JAX probe skips and changes no frequency."""
    rng = np.random.default_rng(11)
    n = 36_000
    s = rng.integers(0, 4, size=n, dtype=np.uint8)
    s[n // 2 : n // 2 + 4000] = np.tile(s[1000:1400], 10)
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["chr0"], [s]
    data = build_index([ff], sampling=5)
    K, e, o = 64, 2, 33
    res = {}
    for probe in (True, False):
        eng = MappabilityEngine(data, batch_blocks=512, dedup=False, device="cpu",
                                dimer_tier=True)
        eng._probe_cut_slack = 3
        eng._probe_enabled = probe
        eng._calibrate_enabled = False  # like for like with the JAX engine
        res[probe] = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535).c
        if probe:
            skipped = eng.stats["probe_skipped"]
            assert eng.stats["dimer_tier"]
    jeng = JaxEngine(data, batch_blocks=512, dedup=False, dimer_tier=True)
    jeng._probe_cut_slack = 3
    jeng._calibrate_enabled = False
    want = jeng.compute_file(jeng.layouts[0], JaxParams(K, o), e, 65535).c
    assert skipped > 0 and skipped == jeng.stats["probe_skipped"]
    np.testing.assert_array_equal(res[True], res[False])
    np.testing.assert_array_equal(res[True], want)
    assert (want > 1).sum() > 1000  # the planted repeat family


@pytest.mark.parametrize("mode", [True, False, None])
def test_dimer_modes_match_oracle(mode):
    """Small Dna5 genome (nearly every dimer sub-block flagged: blocks fall
    through the twins to their mono tiers) against the oracle."""
    rng = np.random.default_rng(31)
    seqs = [rng.integers(0, 5, size=400, dtype=np.uint8),
            np.tile(rng.integers(0, 4, size=30, dtype=np.uint8), 10)]
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["a", "b"], seqs
    eng = MappabilityEngine(build_index([ff], sampling=3), batch_blocks=16,
                            device="cpu", dimer_tier=mode)
    for K, e, o in ((12, 2, 8), (10, 1, 7)):
        res = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 255)
        np.testing.assert_array_equal(res.c, trivial_frequency(seqs, seqs, K, e, 255, True))
        assert eng.stats["dimer_tier"] == (mode is True)


def test_twin_ladder_rescue_matches_oracle(monkeypatch):
    """The probe's residual cohort starts at the last tier of a
    twin-expanded custom ladder and modifies it (fast extension), so blocks
    whose extension leaves the fast window overflow a modified last tier:
    the rescue pass re-runs them at the static ladder's last tier.  (The
    JAX engine indexes its static ladder with the expanded ladder's index
    there and raises IndexError.)  Frequencies of a window over the tandem
    repeat and the region around it equal the oracle's."""
    rng = np.random.default_rng(41)
    n = 34_000
    s = rng.integers(0, 4, size=n, dtype=np.uint8)
    s[20_000:27_000] = np.tile(rng.integers(0, 4, size=7, dtype=np.uint8), 1000)
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["chr0"], [s]
    tiers = (Tier(4, 4, 1, exact=False), Tier(256, 256, 64))
    eng = MappabilityEngine(build_index([ff], sampling=5), batch_blocks=256,
                            dedup=False, tiers=tiers, device="cpu", dimer_tier=True)
    orig = MappabilityEngine._run_blocks
    calls = []

    def spy(self, job, tier, ids, B, t_i, progress, pools_list=None):
        far, cap = orig(self, job, tier, ids, B, t_i, progress, pools_list)
        calls.append((tier, t_i, len(ids), len(far) + len(cap)))
        return far, cap

    monkeypatch.setattr(MappabilityEngine, "_run_blocks", spy)
    # J = 15: below the split pipeline's J >= 16 gate, so the residual
    # cohort runs the fused per-tier program this rescue path belongs to
    K, e, o = 64, 2, 50
    res = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535)
    ladder = eng.stats["tiers"]
    assert [(t.f_search, t.dimer) for t in ladder] == [(4, True), (256, True), (256, False)]
    assert ladder[2].ext_exact is False and eng.stats["probe_skipped"] > 0
    # the residual cohort overflowed the modified last tier; the rescue ran
    # those blocks at the static last tier and resolved them all
    (t1, i1, _n1, ovf1), (t2, i2, n2, ovf2) = calls
    assert (t1, i1) == (ladder[2], 2) and ovf1 > 0
    assert (t2, i2, n2, ovf2) == (tiers[-1], 2, ovf1, 0)
    a, b = 19_900, 20_200  # into the tandem repeat
    want = trivial_frequency([s], [s[a:b]], K, e, 65535, True)[: b - a - K + 1]
    np.testing.assert_array_equal(res.c[a : b - K + 1], want)
    assert want.min() == 1 and want.max() > 900
