"""Same-k-mer dedup of genmap_tpu_torch against dedup off and the JAX engine.

After tests/test_engine_differential.py::test_dedup_matches_normal, on a
Dna5 genome that holds a second copy of itself (duplicate rate ~0.5), so
that dedup is worth it and `_compute_with_dedup` takes over: the value-key
path (K <= 27; at e = 0 too, the JAX file's quick case (8,0,8)) and the zero-error interval-key path (K > 27, e > 0, an e=0
pre-pass collecting exact intervals).  Integer results: exact.
"""

import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.engine.mappability import SearchParams as JaxParams
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)


def _data():
    rng = np.random.default_rng(17)
    half = rng.integers(0, 4, 4300, dtype=np.uint8)
    half[rng.integers(0, len(half), 5)] = 4  # N: matches nothing, not itself
    ff = FastaFile(name="g.fa")
    ff.ids = ["chr1", "chr2"]
    ff.seqs = [np.concatenate([half, half]), rng.integers(0, 4, 300, dtype=np.uint8)]
    return build_index([ff], sampling=4)


@pytest.mark.parametrize("ke", [(20, 1, 16), (30, 2, 27), (8, 0, 8)],
                         ids=["value_keys", "interval_keys", "exact_value_keys"])
def test_dedup_matches_normal_and_jax(ke, monkeypatch):
    K, e, o = ke
    data = _data()
    ran = []
    orig = MappabilityEngine._compute_with_dedup

    def spy(self, *a, **kw):
        ran.append(orig(self, *a, **kw))
        return ran[-1]

    monkeypatch.setattr(MappabilityEngine, "_compute_with_dedup", spy)
    params = SearchParams(length=K, overlap=o, rev_compl=True)
    eng_d = MappabilityEngine(data, batch_blocks=256, device="cpu")
    eng_n = MappabilityEngine(data, batch_blocks=256, dedup=False, device="cpu")
    for eng in (eng_d, eng_n):  # like for like with the JAX engine below
        eng._calibrate_enabled = False
    rd = eng_d.compute_file(eng_d.layouts[0], params, e, 255)
    assert ran == [True]
    rn = eng_n.compute_file(eng_n.layouts[0], params, e, 255)
    assert ran == [True]  # dedup off never enters the dedup pass
    np.testing.assert_array_equal(rd.c, rn.c)

    # the JAX reference without its own dedup and calibration passes (both
    # leave results unchanged; they only add programs to compile)
    jeng = JaxEngine(data, batch_blocks=256, dedup=False, dimer_tier=False)
    jeng._calibrate_enabled = False
    rj = jeng.compute_file(jeng.layouts[0], JaxParams(length=K, overlap=o), e, 255)
    np.testing.assert_array_equal(rd.c, rj.c)
    np.testing.assert_array_equal(eng_d.text, jeng.text)
    assert (rd.c[: 8600 - K] >= 2).mean() > 0.9  # the second copy is found
