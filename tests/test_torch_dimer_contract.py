"""`kernels.dimer_step`'s output contract is all that its consumers read.

The CUDA kernel leaves every slot of `out` undefined except all 16 slots of
a valid dimer step, slots 0..A-1 of a valid mono step and slot 0 of a valid
passthrough (`kernels.dimer_step_defined`).  Here, on the CPU, a wrapper
overwrites every other slot of the plain version's `out` with a poison
pattern; a map whose tier 0 runs on the dimer rows (with `-d` locations),
a forced dimer map whose twins escalate, the split pipeline's dimer mode
ladder and a three-part index must then give the same results as without
it (a second run, unwrapped: frequencies, locations and engine state) and
as the JAX package (its engine's frequencies, locations and engine state
on the first map; its brute-force oracle's counts on a sample of the
others): so neither the engine nor compact reads a slot that the contract
leaves undefined.  A planted consumer that reads the undefined slots shows
that the poison would reach it.  Integer results: exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from genmap_tpu.alphabet import revcomp_codes
from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.engine.oracle import _count, _windows
from genmap_tpu_torch import kernels
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.search import engine as te

torch.set_num_threads(1)

POISON = 0x5A5A5A5A


@contextlib.contextmanager
def poisoned():
    """kernels.dimer_step with every slot of `out` outside the contract
    overwritten by POISON; yields the calls seen as (R, with_mono,
    with_pass, the call's arguments)."""
    orig = kernels.dimer_step
    seen = []

    def wrapper(index, st, valid, **kw):
        out, valid2, far = orig(index, st, valid, **kw)
        defined = kernels.dimer_step_defined(
            st, valid, kw["consume"], kw["per_block"], kw["inner"], index.nchars,
            kw["with_mono"], kw["with_pass"])
        out = out.clone()
        out[:, ~defined] = POISON
        seen.append((st.shape[0], kw["with_mono"], kw["with_pass"],
                     dict(kw, index=index, st=st, valid=valid)))
        return out, valid2, far

    kernels.dimer_step = wrapper
    try:
        yield seen
    finally:
        kernels.dimer_step = orig


@pytest.mark.parametrize("A", [4, 5])
@pytest.mark.parametrize("R", [4, 5])
def test_defined_slots(R, A):
    """Hand-built states of each consume kind, valid and not: groups of two
    states consume 2, 1 and 0 (state i is valid where i is 0, 3 or 4)."""
    st = torch.zeros((R, 6), dtype=torch.int32)
    if R == 5:
        st[4] = torch.tensor([0, 0, 1, 1, 2, 2])  # the plan id is the group
    valid = torch.tensor([1, 0, 0, 1, 1, 0], dtype=torch.uint8)
    consume = torch.tensor([2, 1, 0], dtype=torch.uint8)
    slot = torch.arange(16)
    dimer, mono, first, none = slot < 16, slot < A, slot < 1, slot < 0
    for with_mono, with_pass, rows in (
            (True, True, (dimer, none, none, mono, first, none)),
            (True, False, (dimer, none, none, mono, mono, none)),
            (False, True, (dimer, none, none, dimer, first, none)),
            (False, False, (dimer, none, none, dimer, dimer, none))):
        d = kernels.dimer_step_defined(st, valid, consume, per_block=6, inner=2, A=A,
                                       with_mono=with_mono, with_pass=with_pass)
        assert torch.equal(d, torch.stack(rows)), (with_mono, with_pass)


def _genome(seed=241, n=16_000):
    """tests/test_torch_dimer_engine.py's repeat-rich genome at 16 kbp, its
    flagged sub-block fraction set to a genome-sized index's so that the
    automatic dimer gate opens."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, size=n, dtype=np.uint8)
    unit = rng.integers(0, 4, size=37, dtype=np.uint8)
    for off in range(0, n // 3, 4000):
        s[off : off + len(unit) * 3] = np.tile(unit, 3)
    s[n // 2 : n // 2 + n // 20] = np.tile(s[1000:1100], n // 2000)
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["chr0"], [s]
    data = build_index([ff], sampling=5)
    data.parts[0].dimer_flag_frac = 5e-4
    return data


@pytest.fixture(scope="module")
def genome():
    return _genome()


def _port_runs(data, mode, K, e, o, csv=False, setup=lambda eng: None):
    """The port's engine poisoned, then unwrapped: ((result, engine, calls
    seen), (result, engine))."""
    runs = []
    for wrap in (poisoned, lambda: contextlib.nullcontext([])):
        eng = MappabilityEngine(data, batch_blocks=512, device="cpu", dimer_tier=mode,
                                light=not csv)
        setup(eng)
        with wrap() as seen:
            res = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535, csv=csv)
        runs.append((res, eng, seen))
    return runs


def _same_state(eng, other):
    assert eng.stats["tier_blocks"] == other.stats["tier_blocks"]
    assert eng._tuned_pools == other._tuned_pools
    assert eng._ext_sched == other._ext_sched


def _same_locations(got, want):
    assert got.locations and got.locations.keys() == want.locations.keys()
    for key, (f, r) in want.locations.items():
        gf, gr = got.locations[key]
        for a, b in zip(gf + gr, f + r):
            np.testing.assert_array_equal(a, b)


def _oracle_sample(seqs, got, K, e, seed):
    """The JAX package's brute-force counts at 200 positions of the first
    sequence (half of them where the port counts a repeat) equal `got`'s."""
    seq = seqs[0]
    rng = np.random.default_rng(seed)
    nk = len(seq) - K + 1
    pos = np.concatenate([rng.integers(0, nk, 100),
                          rng.choice(np.nonzero(got[:nk] > 1)[0], 100)])
    q = np.lib.stride_tricks.sliding_window_view(seq, K)[pos]
    rc = np.stack([revcomp_codes(x) for x in q])
    targets = _windows(seqs, K)
    oracle = _count(q, targets, e) + _count(rc, targets, e)
    np.testing.assert_array_equal(got[pos], np.minimum(oracle, 65535))


def test_dimer_tier0_map_reads_only_defined_slots(genome):
    """(20,1) with the automatic dimer policy: tier 0 on the dimer rows
    (a (24,1)-like map), calibrated, with `-d` locations.  Poisoned,
    unwrapped and the JAX engine: frequencies, locations and engine state
    equal."""
    K, e, o = 20, 1, 11
    (got, eng, seen), (again, eng2, _) = _port_runs(genome, None, K, e, o, csv=True)
    jeng = JaxEngine(genome, batch_blocks=512, dimer_tier=None, light=False)
    want = jeng.compute_file(jeng.layouts[0], JaxParams(K, o), e, 65535, csv=True)
    assert eng.stats["dimer_tier"] and jeng.stats["dimer_tier"]
    assert {(5, False, False), (4, True, True)} <= {s[:3] for s in seen}
    np.testing.assert_array_equal(got.c, again.c)
    np.testing.assert_array_equal(got.c, want.c)
    _same_locations(got, again)
    _same_locations(got, want)
    _same_state(eng, eng2)
    _same_state(eng, jeng)


def test_forced_dimer_twins_read_only_defined_slots(genome):
    """(24,1) with every tier on the dimer rows where it has a twin: blocks
    escalate through the dimer twins.  Poisoned and unwrapped runs agree in
    frequencies and engine state, and the frequencies equal the JAX
    package's oracle on a sample (tests/test_torch_dimer_engine.py holds
    the unwrapped engine to the JAX engine here)."""
    K, e, o = 24, 1, 20
    (got, eng, _seen), (again, eng2, _) = _port_runs(genome, True, K, e, o)
    tiers = eng.stats["tiers"]
    twins = [i for i, t in enumerate(tiers) if i > 0 and t.dimer]
    assert twins and sum(eng.stats["tier_blocks"].get(i, 0) for i in twins) > 0
    np.testing.assert_array_equal(got.c, again.c)
    _same_state(eng, eng2)
    _oracle_sample([genome.decode_slice(0, genome.text_len)], got.c, K, e, K)


def family_genome(seed=5, n_random=4000, copies=200, n_runs=6):
    """tests/test_torch_split.py's genome: random flanks around 2 %-mutated
    copies of one 150 bp unit, with a few 20 bp N runs (flagged dimer
    sub-blocks)."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 150, dtype=np.uint8)
    parts = [rng.integers(0, 4, n_random, dtype=np.uint8)]
    for _ in range(copies):
        u = unit.copy()
        m = rng.random(150) < 0.02
        u[m] = rng.integers(0, 4, int(m.sum()))
        parts.append(u)
    parts.append(rng.integers(0, 4, n_random // 2, dtype=np.uint8))
    seq = np.concatenate(parts)
    for s in rng.integers(0, len(seq) - 20, n_runs):
        seq[s : s + 20] = 4
    return seq


def test_split_dimer_ladder_reads_only_defined_slots():
    """Forced dimer tiers, calibration and the split pipeline (J = 16):
    phase-B rows walk fast-dimer -> exact-dimer -> exact-mono.  Poisoned and
    unwrapped runs agree in frequencies and engine state, and the
    frequencies equal the JAX package's oracle on a sample
    (tests/test_torch_split.py holds the unwrapped engine to the JAX
    engine)."""
    seq = family_genome(copies=120, n_random=3000)
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["c1"], [seq]
    data = build_index([ff], sampling=4)
    K, e, o = 30, 1, 15

    def setup(eng):
        eng._cal_batch = 96
        eng._record_tier_sel = True

    (got, eng, seen), (again, eng2, _) = _port_runs(data, True, K, e, o, setup=setup)
    modes = {}
    for t_i, Fe, exact, dimer in eng.stats["rung_sel"]:
        modes.setdefault((t_i, Fe), set()).add((exact, dimer))
    assert any({(False, True), (True, True), (True, False)} <= m for m in modes.values())
    assert {r for r, *_ in seen} == {4, 5}
    np.testing.assert_array_equal(got.c, again.c)
    _same_state(eng, eng2)
    assert eng.stats["routes"] == eng2.stats["routes"]
    for k, v in eng.stats["rung_sel"].items():
        np.testing.assert_array_equal(np.concatenate(v),
                                      np.concatenate(eng2.stats["rung_sel"][k]))
    assert eng._tuned_pools  # calibrated
    _oracle_sample([seq], got.c, K, e, K)


def test_multipart_dimer_reads_only_defined_slots():
    """A three-part index with every tier on the dimer rows (each part's
    dimer rows stepped): poisoned and unwrapped runs agree in frequencies
    and engine state, and the frequencies equal the JAX package's oracle
    over all three sequences on a sample of the first."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 4, size=18_000, dtype=np.uint8)
    s[10_000:12_000] = np.tile(s[2_000:2_100], 20)
    seqs = [s[:6000], s[6000:12_000], s[12_000:]]
    ff = FastaFile(name="genome.fa")
    ff.ids, ff.seqs = ["a", "b", "c"], seqs
    data = build_index([ff], sampling=4, max_part_symbols=15_000)
    assert len(data.parts) == 3
    K, e, o = 24, 1, 20
    (got, eng, seen), (again, eng2, _) = _port_runs(data, True, K, e, o)
    assert eng.stats["dimer_tier"]
    assert {id(s[3]["index"]) for s in seen} == {id(ix) for ix in eng.indices}
    np.testing.assert_array_equal(got.c, again.c)
    _same_state(eng, eng2)
    _oracle_sample(seqs, got.c, K, e, K)


@pytest.mark.parametrize("R", [5, 4])
def test_poison_reaches_a_consumer_of_undefined_slots(genome, R):
    """A planted consumer, the engine's compaction fed a dimer step's `out`
    with valid2 of all ones, reads the undefined slots: on a poisoned call
    of a (20,1) map (R = 5: the infix scan; R = 4: an extension step with
    passthrough slots) the poison reaches its result, while the compaction
    by the call's own valid2 equals the unwrapped call's."""
    with poisoned() as seen:
        eng = MappabilityEngine(genome, batch_blocks=512, device="cpu", dimer_tier=True)
        eng._calibrate_enabled = False
        eng.compute_file(eng.layouts[0], SearchParams(20, 11), 1, 255)
    calls = [s[3] for s in seen if s[0] == R and (R == 5 or s[2])]
    assert calls
    args = max(calls, key=lambda a: int(a["valid"].sum()))
    with poisoned():
        out, valid2, _far = kernels.dimer_step(**args)
    ref, ref_valid2, _ = kernels.dimer_step(**args)
    inner = args["inner"]
    rows = out.shape[1] // inner
    planted = te._compact(out.view(R, rows, -1), torch.ones_like(valid2).view(rows, -1),
                          inner)
    assert (planted[0] == POISON).any()
    kept = te._compact(out.view(R, rows, -1), valid2.view(rows, -1), inner)
    want = te._compact(ref.view(R, rows, -1), ref_valid2.view(rows, -1), inner)
    for a, b in zip(kept, want):
        assert torch.equal(a, b)
    assert kept[1].any() and not (kept[0] == POISON).any()
