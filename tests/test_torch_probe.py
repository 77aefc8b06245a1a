"""The unique-infix probe of genmap_tpu_torch against the JAX package's.

Block level: one probe batch through the JAX engine's probe program and the
port's probe mode (`BlockMapper(probe=True)`, the `probe_mass` plain
version on the CPU) must give the same per-plan masses, N-window and
overflow flags and skip decisions, on Dna4 and on Dna5 with N, for the full
scan and for a tight cut.

Engine level (after tests/test_probe.py, on a 40 kbp genome, the smallest
whose 1,250 blocks of 32 k-mers pass the probe's 2^15 k-mer gate, so that
the probe-less CPU runs stay short): the probe leaves every frequency
unchanged, skips the same number of blocks as the JAX engine, and abandons
on a genome in which every block repeats.  Integer results: exact.
"""

import math

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu.search.engine import DEFAULT_TIERS as JAX_TIERS
from genmap_tpu.search.engine import probe_thresholds as jax_thresholds
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr
from genmap_tpu_torch.search import engine as te
from genmap_tpu_torch.search.schemes import plans_for

torch.set_num_threads(1)

K, E, O = 64, 1, 33  # J = 32: extension-dominated, so the probe is worth it
J = K - O + 1


def _data(seed, n, nseq=2, with_n=False, repeat_all=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, size=n, dtype=np.uint8)
    if repeat_all:
        s[n // 2 :] = s[: n - n // 2]  # every k-mer occurs twice
    else:
        s[n // 4 : n // 4 + 8000] = np.tile(s[10_000:10_400], 20)  # repeat region
    if with_n:
        s[rng.integers(0, n, size=6)] = 4
    ff = FastaFile(name="g.fa")
    ff.ids = [f"chr{i}" for i in range(nseq)]
    ff.seqs = [s[i * n // nseq : (i + 1) * n // nseq] for i in range(nseq)]
    return build_index([ff], sampling=5)


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("cut", [None, "log4+2"])
def test_probe_batch_matches_jax(with_n, cut):
    data = _data(seed=11 + with_n, n=24_000, with_n=with_n)
    n = data.parts[0].n_total
    probe_cut = None if cut is None else math.ceil(math.log(2 * n, 4)) + 2
    B = 384
    rng = np.random.default_rng(5)
    nk = data.text_len - K + 1
    starts = np.sort(rng.choice(np.arange(0, nk - J, J), B, replace=False))
    cnt = np.full(B, J, np.int32)
    tier = JAX_TIERS[0]

    jeng = JaxEngine(data, batch_blocks=B, dedup=False, dimer_tier=False)
    jrun = jeng._probe_runner(0, K, E, O, J, B, tier, 65535, True, mode=True,
                              probe_cut=probe_cut)
    jout = jrun(starts.astype(np.uint32), cnt, np.uint32(data.text_len))
    j_mass = np.asarray(jout["mass_p"]).astype(np.int64)
    j_nwin = np.asarray(jout["nwin"])
    j_ovf = np.asarray(jout["overflow"])
    thr = jax_thresholds(plans_for(E, O), K - O, probe_cut).astype(np.int64)
    j_skip = (j_mass <= thr[None, :]).all(axis=1) & ~j_ovf & ~j_nwin

    index = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    text = tr.DeviceText.from_host(data, "cpu")
    run = te.BlockMapper(index, text, K=K, errors=E, overlap=O, J=J, B=B,
                         tier=te.Tier(tier.f_search, tier.f_collect, tier.f_extend,
                                      exact=tier.exact),
                         cap=65535, rev_compl=True, probe=True,
                         probe_cut=probe_cut, probe_mass=True)
    out = run(torch.from_numpy(starts.astype(np.uint32).view(np.int32)),
              torch.from_numpy(cnt), data.text_len)
    np.testing.assert_array_equal(j_mass, tr.u32(out["mass_p"]).numpy())
    np.testing.assert_array_equal(j_nwin, out["nwin"].numpy().astype(bool))
    np.testing.assert_array_equal(j_ovf, out["overflow"].numpy().astype(bool))
    np.testing.assert_array_equal(j_skip, out["skip"].numpy().astype(bool))
    np.testing.assert_array_equal(thr, run.thr.numpy())
    assert 0 < j_skip.sum() < B  # both outcomes occur
    if with_n:
        assert j_nwin.any()


N_BP = 40_000


def _map_port(data, cap):
    """(frequencies, probe_skipped) of the port with and without the probe."""
    params = SearchParams(length=K, overlap=O, rev_compl=True)
    res = []
    for probe in (True, False):
        eng = MappabilityEngine(data, batch_blocks=1024, dedup=False, device="cpu")
        eng._probe_enabled = probe
        eng._calibrate_enabled = False  # like for like with the JAX engine
        res.append((eng.compute_file(eng.layouts[0], params, E, cap).c,
                    eng.stats["probe_skipped"]))
    return res


def test_probe_engine_matches_jax():
    data = _data(seed=3, n=N_BP)
    (cp, sp), (cf, sf) = _map_port(data, 65535)
    jeng = JaxEngine(data, batch_blocks=1024, dedup=False, dimer_tier=False)
    jeng._calibrate_enabled = False  # runs after the probe; results unchanged
    cj = jeng.compute_file(jeng.layouts[0], JaxParams(length=K, overlap=O), E, 65535).c
    assert sp > 0.5 * (N_BP // J)
    assert sf == 0
    assert sp == jeng.stats["probe_skipped"]
    np.testing.assert_array_equal(cp, cf)
    np.testing.assert_array_equal(cp, cj)
    assert (cp > 1).sum() > 5000  # the planted repeat region


def test_probe_abandons_on_repeat_genome():
    (cp, sp), (cf, _) = _map_port(_data(seed=9, n=N_BP, repeat_all=True), 255)
    assert sp < 0.3 * (N_BP // J)  # abandoned after the first batch
    np.testing.assert_array_equal(cp, cf)
    assert (cp[: N_BP // 2 - K] >= 2).all()
