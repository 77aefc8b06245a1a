"""genmap_tpu_torch's occupancy calibration against the JAX engine's.

After tests/test_calibration.py, on its 60 kbp repeat-rich genome: a
calibrated map equals the uncalibrated one and the JAX engine's, and its
calibrated pools, blocks per tier and the rerun's cached calibration equal
JAX's; the tier router sends far-flagged blocks to the next tier and
capacity overflows to a larger one; a one-tier ladder's calibration never
tightens it; and a (40,2) map through calibration and the split pipeline
equals the JAX engine's.  Integer results: exact.
"""

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.search.engine import Tier, infix_pool_schedule
from genmap_tpu_torch.search.schemes import plans_for
from test_torch_split import (
    _index,
    family_genome,
    repeat_rich_genome,
    split_map_matches_jax_and_oracle,
)

torch.set_num_threads(1)


def _measuring_batches(monkeypatch):
    """Record, per engine batch, whether it ran a calibration (with_occ)
    program."""
    calls = []
    orig = MappabilityEngine._run_batch

    def spy(self, runs, *a):
        calls.append(runs[0].with_occ)
        return orig(self, runs, *a)

    monkeypatch.setattr(MappabilityEngine, "_run_batch", spy)
    return calls


def test_calibrated_matches_uncalibrated_and_jax(monkeypatch):
    K, e, o = 18, 1, 15
    data = _index(repeat_rich_genome())
    ref = MappabilityEngine(data, batch_blocks=256, device="cpu")
    ref._calibrate_enabled = False
    want = ref.compute_file(ref.layouts[0], SearchParams(K, o), e, 65535).c

    calls = _measuring_batches(monkeypatch)
    eng = MappabilityEngine(data, batch_blocks=256, device="cpu")
    jeng = JaxEngine(data, batch_blocks=256)
    for x in (eng, jeng):
        x._cal_batch = 96  # a small sample leaves plenty of the cohort
    for run in (1, 2):  # the rerun takes the cached calibration
        got = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535).c
        jgot = jeng.compute_file(jeng.layouts[0], JaxParams(K, o), e, 65535).c
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jgot)
        assert eng.stats["tier_blocks"] == jeng.stats["tier_blocks"], run
        assert eng._tuned_pools == jeng._tuned_pools, run
        if run == 1:
            n_measured = sum(calls)
            assert n_measured >= 1 and calls[0]
    assert sum(calls) == n_measured  # no calibration batch in the rerun
    tuned = [v for k, v in eng._tuned_pools.items() if k[:3] == (K, e, o)]
    assert any(isinstance(p, list) for p, _fe in tuned), "no pools were adopted"
    # adopted pools stay within the next tier's scale
    n = data.parts[0].n_total
    base1 = infix_pool_schedule(plans_for(e, o), K - o, n, 1.0)
    base8 = infix_pool_schedule(plans_for(e, o), K - o, n, 8.0)
    for pools, fe in tuned:
        if isinstance(pools, list):
            assert all(a <= max(b, c) for a, b, c in zip(pools[0], base1, base8))
        assert fe is None or 2 <= fe <= 8 * 16384


def test_far_routes_to_next_tier_and_cap_to_a_larger_one():
    """Branchy blocks on heavy repeats overflow the pools (cap) and go to a
    tier with a larger static capacity; with forced dimer tiers on a repeat
    family, the fast dimer tier 0's far flags go to the next tier."""
    routes = {}
    for name, seq, (K, e, o), mode in (
        ("cap", repeat_rich_genome(seed=23), (20, 1, 17), None),
        ("far", family_genome(copies=100), (30, 1, 15), True),
    ):
        data = _index(seq)
        eng = MappabilityEngine(data, batch_blocks=256, dedup=False, device="cpu",
                                dimer_tier=mode)
        eng._record_tier_sel = True
        eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535)
        routes[name] = eng.stats["routes"]
        tiers = eng.stats["tiers"]
        n_max = data.parts[0].n_total

        def caps(i):
            t = tiers[i]
            pools = infix_pool_schedule(plans_for(e, o), K - o, n_max, t.f_search / 4.0)
            return (int(pools.sum()), t.f_extend, t.f_collect)

        for src, dst, kind, n in routes[name]:
            assert n > 0
            if kind == "far":
                assert dst == src + 1 or dst is None
            else:
                assert dst is None or dst > src
                if dst is not None:
                    assert any(a > b for a, b in zip(caps(dst), caps(src))), (src, dst)
    for name, r in routes.items():
        assert name in {kind for *_x, kind, _n in r}, routes


def test_final_tier_calibration_never_tightens():
    """A one-tier ladder is its own final tier: its calibration adopts no
    tighter pools and no smaller f_extend, and the map equals the
    uncalibrated one."""
    K, e, o = 20, 1, 17
    data = _index(repeat_rich_genome(seed=31, n=30_000))
    only = (Tier(256, 512, 64),)
    res = {}
    for cal in (True, False):
        eng = MappabilityEngine(data, batch_blocks=256, dedup=False, tiers=only,
                                device="cpu")
        eng._calibrate_enabled = cal
        eng._cal_batch = 96
        res[cal] = eng.compute_file(eng.layouts[0], SearchParams(K, o), e, 65535).c
        if cal:
            entries = [v for k, v in eng._tuned_pools.items() if k[:3] == (K, e, o)]
            assert entries, "calibration did not run"
            for pools, fe in entries:
                assert pools == "static", "the final tier adopted tightened pools"
                assert fe is None or fe >= 64, "the final tier adopted a smaller f_extend"
    np.testing.assert_array_equal(res[True], res[False])


def test_split_map_40_2_matches_jax_and_oracle():
    """(40,2): no probe residual; the whole genome is the calibrated cohort
    of tier 0 and goes through the split pipeline."""
    split_map_matches_jax_and_oracle(40, 2, 20)
