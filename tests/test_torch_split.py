"""genmap_tpu_torch's split pipeline and occupancy outputs against the JAX
package's.

Batch level, on a repeat-family genome with seed tables: the block mapper's
occupancy outputs (`with_occ`: per-step counts and survivor counts) on a
mono and a forced dimer tier, phase A (`collect_only`) at given pools, the
rung gather (`kernels.gather_states`' plain version against the JAX
engine's take-and-cut), phase B (`Extender` against `make_extender`) at a
fast mono, a fast dimer and an exact rung with per-level schedules and
their demand output, and the seed-table lookup against the JAX seeded pool.
Engine level: whole single-part maps whose J >= 16 opens the split gate
equal the JAX engine's in frequencies, blocks per tier, calibrated pools,
extension schedules and blocks per rung, and a sampled brute-force oracle;
a forced dimer map walks the fast-dimer -> exact-dimer -> exact-mono mode
ladder with frequencies unchanged.  Integer results: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmap_tpu.alphabet import revcomp_codes
from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.engine.oracle import _count, _windows
from genmap_tpu.ops import rank as jr
from genmap_tpu.search import engine as je
from genmap_tpu_torch import kernels
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr
from genmap_tpu_torch.search import engine as te
from genmap_tpu_torch.search.schemes import plans_for

torch.set_num_threads(1)


def family_genome(seed=5, n_random=4000, copies=200, n_runs=6):
    """Random flanks around `copies` 2 %-mutated copies of one 150 bp unit
    (a high-copy repeat family: wide intervals, many infix survivors), with
    a few 20 bp N runs (flagged dimer sub-blocks)."""
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


def repeat_rich_genome(seed=11, n=60_000):
    """The genome of tests/test_calibration.py: half its segments are
    lightly mutated copies from a 6 kbp core."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=n // 10, dtype=np.uint8)
    parts, tot = [], 0
    while tot < n:
        if rng.random() < 0.5:
            s = rng.integers(0, max(1, len(core) - 600))
            seg = core[s : s + rng.integers(100, 600)].copy()
            idx = rng.integers(0, len(seg), max(1, len(seg) // 80))
            seg[idx] = rng.integers(0, 4, len(idx))
        else:
            seg = rng.integers(0, 4, size=rng.integers(100, 600), dtype=np.uint8)
        parts.append(seg)
        tot += len(seg)
    return np.concatenate(parts)[:n].astype(np.uint8)


def _index(seq):
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["c1"], [seq]
    return build_index([ff], sampling=5)


def sampled_oracle(seq, K, e, pos):
    """Brute-force (K, e)-frequencies (both strands, no cap) at `pos`."""
    targets = _windows([seq], K)
    q = np.lib.stride_tricks.sliding_window_view(seq, K)[pos]
    rc = np.stack([revcomp_codes(x) for x in q])
    return _count(q, targets, e) + _count(rc, targets, e)


_BATCH = {}


def _batch():
    """(data, JAX index and text, port index and text) of the family
    genome, and a batch of B block starts over it."""
    if not _BATCH:
        data = _index(family_genome(copies=60))
        part = data.parts[0]
        assert part.dimer is not None
        ji, ti = (jr.DeviceIndex.from_part(data, part, light=True),
                  tr.DeviceIndex.from_part(data, part, light=True, device="cpu"))
        assert ji.has_seed and ti.has_seed
        _BATCH.update(data=data, ji=ji, jt=jr.DeviceText.from_host(data), ti=ti,
                      tt=tr.DeviceText.from_host(data, "cpu"))
    return _BATCH


K, E, O = 30, 1, 15
J = K - O + 1
B = 64


def _starts(data):
    rng = np.random.default_rng(3)
    nk = data.text_len - K + 1
    starts = np.sort(rng.choice(np.arange(0, nk - J, J), B, replace=False))
    return starts.astype(np.uint32), np.full(B, J, np.int32)


@pytest.mark.parametrize("dimer", [False, True], ids=["mono", "dimer"])
def test_block_mapper_occupancy_matches_jax(dimer):
    b = _batch()
    data = b["data"]
    starts, cnt = _starts(data)
    tier = te.Tier(32, 64, 8, dimer=dimer)
    jrun = je.make_block_mapper(
        b["ji"], b["jt"], K=K, errors=E, overlap=O, J=J, B=B,
        tier=je.Tier(32, 64, 8, dimer=dimer), cap=65535, rev_compl=True,
        with_occ=True)
    want = {k: np.asarray(v) for k, v in jrun(starts, cnt, np.uint32(data.text_len)).items()}
    run = te.BlockMapper(b["ti"], b["tt"], K=K, errors=E, overlap=O, J=J, B=B, tier=tier,
                         cap=65535, rev_compl=True, with_occ=True)
    got = run(torch.from_numpy(starts.view(np.int32)), torch.from_numpy(cnt),
              data.text_len)
    assert got["occ"].dtype == torch.uint16 and got["surv"].dtype == torch.uint16
    for k in ("occ", "surv", "hits", "overflow", "overflow_cap"):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    assert want["occ"].shape == (B, run.sched.T) and (want["surv"] > 8).any()


def _phase_a(pools):
    """Phase A of one batch on the port and on JAX at the same pools."""
    b = _batch()
    data = b["data"]
    starts, cnt = _starts(data)
    jrun = je.make_block_mapper(
        b["ji"], b["jt"], K=K, errors=E, overlap=O, J=J, B=B, tier=je.Tier(32, 64, 8),
        cap=65535, rev_compl=True, pools=pools, collect_only=True)
    want = {k: np.asarray(v) for k, v in jrun(starts, cnt, np.uint32(data.text_len)).items()}
    run = te.BlockMapper(b["ti"], b["tt"], K=K, errors=E, overlap=O, J=J, B=B,
                         tier=te.Tier(32, 64, 8), cap=65535, rev_compl=True,
                         pools=pools, collect_only=True)
    got = run(torch.from_numpy(starts.view(np.int32)), torch.from_numpy(cnt),
              data.text_len)
    return want, got, starts, cnt


def _pools():
    n = _batch()["ti"].n_total
    return tuple(int(x) for x in te.infix_pool_schedule(plans_for(E, O), K - O, n, 16.0))


def test_collect_only_matches_jax():
    want, got, _, _ = _phase_a(_pools())
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy().astype(bool), v)
    for k in ("surv", "overflow", "overflow_cap"):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    for r, k in enumerate(("flo", "rlo", "size", "err")):
        np.testing.assert_array_equal(tr.u32(got["st"][r]).numpy()[v],
                                      want[k].astype(np.int64)[v], err_msg=k)
    # packed to the front: the survivor count is the prefix of valid slots
    np.testing.assert_array_equal(v.sum(-1), want["surv"])
    assert (want["surv"] > 1).any() and (~want["overflow"]).any()


def _jax_sl(a, ridx, n, Fe, valid=False):
    """The JAX engine's rung gather (_run_tier_split's sl() and mask)."""
    npad = len(ridx)
    x = jnp.take(jnp.asarray(a), jnp.asarray(ridx), axis=0)
    Fc = x.shape[1]
    if Fc >= Fe:
        x = x[:, :Fe]
    else:
        x = jnp.concatenate([x, jnp.zeros((npad, Fe - Fc), x.dtype)], axis=1)
    if valid:
        x = x & (jnp.arange(npad) < n)[:, None]
    return np.asarray(x)


@pytest.mark.parametrize("Fe", [8, 128], ids=["Fc>Fe", "Fc<Fe"])
def test_gather_states_matches_jax_sl(Fe):
    want, got, _, _ = _phase_a(_pools())
    Fc = want["flo"].shape[1]
    assert (Fc > Fe) == (Fe == 8)
    rng = np.random.default_rng(Fe)
    n, npad = 37, 64
    ridx = np.zeros(npad, np.int32)
    ridx[:n] = rng.integers(0, B, n)
    st, valid = kernels.gather_states_plain(got["st"], got["valid"],
                                            torch.from_numpy(ridx), n, Fe)
    np.testing.assert_array_equal(valid.numpy().astype(bool),
                                  _jax_sl(want["valid"], ridx, n, Fe, valid=True))
    for r, k in enumerate(("flo", "rlo", "size", "err")):
        w = _jax_sl(want[k], ridx, n, Fe).astype(np.int64)
        np.testing.assert_array_equal(tr.u32(st[r]).numpy() * valid.numpy(),
                                      w * valid.numpy(), err_msg=k)


@pytest.mark.parametrize("Fe,exact,dimer,fe_sched", [
    (4, False, False, None),  # fast mono
    (16, False, True, (16, 16, 8, 8, 4)),  # fast dimer
    (256, True, False, (256, 128, 64, 16, 8)),  # exact mono
], ids=["fast-mono-4", "fast-dimer-16", "exact-256"])
def test_extender_matches_make_extender(Fe, exact, dimer, fe_sched):
    b = _batch()
    data = b["data"]
    want_a, got_a, starts, cnt = _phase_a(_pools())
    live = np.nonzero(want_a["surv"] > 0)[0]
    n = len(live)
    npad = 1 << int(np.ceil(np.log2(n)))
    ridx = np.zeros(npad, np.int32)
    ridx[:n] = live
    gs = np.zeros(npad, np.uint32)
    gs[:n] = starts[live]
    gc = np.zeros(npad, np.int32)
    gc[:n] = cnt[live]
    jst = tuple(_jax_sl(want_a[k], ridx, n, Fe) for k in ("flo", "rlo", "size", "err"))
    jst += (_jax_sl(want_a["valid"], ridx, n, Fe, valid=True),)
    jrun = je.make_extender(b["ji"], b["jt"], K=K, errors=E, overlap=O, J=J, B=npad,
                            Fe=Fe, cap=65535, rev_compl=True, exact=exact, dimer=dimer,
                            fe_sched=fe_sched, with_occ=True)
    want = {k: np.asarray(v) for k, v in
            jrun(gs, gc, np.uint32(data.text_len), jst).items()}
    run = te.Extender(b["ti"], b["tt"], K=K, errors=E, overlap=O, J=J, B=npad, Fe=Fe,
                      cap=65535, rev_compl=True, exact=exact, dimer=dimer,
                      fe_sched=fe_sched, with_occ=True)
    got = run(torch.from_numpy(gs.view(np.int32)), torch.from_numpy(gc),
              data.text_len, (got_a["st"], got_a["valid"]), torch.from_numpy(ridx), n)
    for k in ("hits", "overflow", "overflow_cap", "ext_occ"):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    assert (~want["overflow"][:n]).any() and want["ext_occ"].max() > 4


def test_seed_lookup_matches_jax_seeded_pool():
    """The JAX scan cut at the seeded prefix returns the starting pool
    itself."""
    b = _batch()
    data = b["data"]
    starts, _ = _starts(data)
    plans = plans_for(E, O)
    n = b["ti"].n_total
    sched = te._InfixSchedule(plans, K - O, "cpu")
    t_seed = te.seed_steps(b["ti"], sched, sched.T)
    assert t_seed > 0
    Fp = int(te.infix_pool_schedule(plans, K - O, n, 1.0)[-1])
    jneedles = jr.extract_needles(b["jt"], jnp.asarray(starts), K + J - 1,
                                  jnp.uint32(data.text_len))
    jpool, _cap, _far = je._search_infix(b["ji"], plans, K - O, jneedles, B,
                                         je.Tier(4, 4, 1), n, 64, n, stop_at=t_seed)
    tneedles = tr.extract_needles(b["tt"], torch.from_numpy(starts.view(np.int32)),
                                  K + J - 1, data.text_len)
    st, valid = kernels.seed_lookup_plain(b["ti"], tneedles, sched.seed_pos(t_seed),
                                          t_seed, Fp, n)
    jf, jrl, js, jerr, jv, jp = (np.asarray(x) for x in jpool)
    np.testing.assert_array_equal(valid.numpy().astype(bool), jv)
    for r, w in enumerate((jf, jrl, js, jerr, jp)):
        np.testing.assert_array_equal(tr.u32(st[r]).numpy(), w.astype(np.int64))
    assert jv.any() and not jv.all()


def _routes_ok(eng):
    for src, dst, kind, cnt in eng.stats["routes"]:
        assert cnt > 0 and (dst is None or dst > src)
        if kind == "far":
            assert dst == src + 1 or dst is None


def split_map_matches_jax_and_oracle(K_, e, o):
    """Calibration (a 96-block sample) and the split pipeline on the
    repeat-rich genome: the port's engine state equals the JAX engine's.
    (Run at (30,1) here and at (40,2) in tests/test_torch_calibration.py.)"""
    seq = repeat_rich_genome()
    data = _index(seq)
    engs = []
    for cls, kw in ((MappabilityEngine, dict(device="cpu")), (JaxEngine, {})):
        eng = cls(data, batch_blocks=1024, **kw)
        eng._cal_batch = 96
        eng._record_tier_sel = True
        engs.append(eng)
    eng, jeng = engs
    got = eng.compute_file(eng.layouts[0], SearchParams(K_, o), e, 65535).c
    want = jeng.compute_file(jeng.layouts[0], JaxParams(K_, o), e, 65535).c
    np.testing.assert_array_equal(got, want)
    assert eng.stats["tier_blocks"] == jeng.stats["tier_blocks"]
    assert eng._tuned_pools == jeng._tuned_pools and eng._tuned_pools
    assert eng._ext_sched == jeng._ext_sched
    assert eng.stats["routes"] == jeng.stats["routes"]
    _routes_ok(eng)
    rung = {k: np.concatenate(v) for k, v in eng.stats["rung_sel"].items()}
    jrung = {k: np.concatenate(v) for k, v in jeng.stats["rung_sel"].items()}
    assert sorted(rung) == sorted(jrung) and rung
    for k in rung:
        np.testing.assert_array_equal(rung[k], jrung[k])
    rng = np.random.default_rng(K_)
    nk = len(seq) - K_ + 1
    pos = np.concatenate([rng.integers(0, nk, 150),
                          rng.choice(np.nonzero(got[:nk] > 1)[0], 150)])
    np.testing.assert_array_equal(got[pos], np.minimum(sampled_oracle(seq, K_, e, pos),
                                                       65535))


def test_split_map_matches_jax_and_oracle():
    """The probe's residual cohort (start tier 1) through the split
    pipeline, calibrated per tier."""
    split_map_matches_jax_and_oracle(30, 1, 15)


def test_dimer_mode_ladder_keeps_frequencies():
    """Forced dimer tiers on the family genome: phase-B rows walk fast-dimer
    -> exact-dimer (window too narrow) -> exact-mono (flagged sub-block) at
    one rung; frequencies equal the mono run's and the oracle's."""
    seq = family_genome()
    data = _index(seq)
    K_, e, o = 30, 1, 15
    res = {}
    for mode in (True, False):
        eng = MappabilityEngine(data, batch_blocks=1024, device="cpu", dimer_tier=mode)
        eng._cal_batch = 96
        eng._record_tier_sel = True
        res[mode] = eng.compute_file(eng.layouts[0], SearchParams(K_, o), e, 65535).c
        _routes_ok(eng)
        modes = {}
        for t_i, Fe, exact, dimer in eng.stats["rung_sel"]:
            modes.setdefault((t_i, Fe), set()).add((exact, dimer))
        ladder = [k for k, m in modes.items()
                  if {(False, True), (True, True), (True, False)} <= m]
        assert bool(ladder) == mode, modes
    np.testing.assert_array_equal(res[True], res[False])
    rng = np.random.default_rng(1)
    nk = len(seq) - K_ + 1
    pos = np.concatenate([rng.integers(0, nk, 100),
                          rng.choice(np.nonzero(res[True][:nk] > 20)[0], 200)])
    np.testing.assert_array_equal(res[True][pos], np.minimum(
        sampled_oracle(seq, K_, e, pos), 65535))
