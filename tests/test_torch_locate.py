"""genmap_tpu_torch locate (LF walks to sampled SA rows) against the JAX
package's `locate` and against the suffix array of the index build, and
the engine's strand split of located rows against the JAX engine's.

Every SA row of small Dna4 and Dna5 indexes is located at sampling rates 1,
3 and 10.  The port runs its plain version on the CPU (the `locate` kernel
is held against that version on the card).  Integer results: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
from genmap_tpu.ops import rank as jr
from genmap_tpu_torch.alphabet import revcomp_codes
from genmap_tpu_torch.engine.mappability import MappabilityEngine
from genmap_tpu_torch.index.build import _make_ctext, build_index
from genmap_tpu_torch.index.suffix import suffix_array
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr

torch.set_num_threads(1)


def _seqs(alpha, seed):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 40, dtype=np.uint8)
    a = np.concatenate([rng.integers(0, alpha, 300, dtype=np.uint8),
                        np.tile(unit, 4), rng.integers(0, alpha, 200, dtype=np.uint8)])
    b = rng.integers(0, alpha, 170, dtype=np.uint8)
    if alpha == 5:
        a[60:75] = 4
    return [a, b, rng.integers(0, 4, 9, dtype=np.uint8)]


def _sa_truth(seqs):
    """(i1, i2) of every SA row from the suffix array of the both-strand
    text; a sentinel row is (sequence, its length)."""
    all_seqs = seqs + [revcomp_codes(s) for s in seqs]
    sa = suffix_array(_make_ctext(all_seqs)).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum([len(s) + 1 for s in all_seqs])])
    i1 = np.searchsorted(starts, sa, side="right") - 1
    return i1, sa - starts[i1]


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("sampling", [1, 3, 10])
def test_locate_every_sa_row(alpha, sampling):
    seqs = _seqs(alpha, 20 + alpha + sampling)
    ff = FastaFile(name="g.fa")
    ff.ids = [f"s{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    data = build_index([ff], sampling=sampling)
    part = data.parts[0]
    n = part.n_total
    want_i1, want_i2 = _sa_truth(seqs)

    ti = tr.DeviceIndex.from_part(data, part, light=False, device="cpu")
    rows = np.arange(n, dtype=np.uint32)
    valid = np.ones(n, np.uint8)
    valid[::7] = 0  # invalid rows read sample 0 and take no step
    pos = torch.from_numpy(rows.view(np.int32))
    t1, t2 = tr.locate(ti, pos, torch.from_numpy(valid))
    t1, t2 = tr.u32(t1).numpy(), tr.u32(t2).numpy()

    ji = jr.DeviceIndex.from_part(data, part)
    j1, j2 = jr.locate(ji, jnp.asarray(rows), jnp.asarray(valid.astype(bool)))
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1)
    np.testing.assert_array_equal(np.asarray(j2).astype(np.int64), t2)

    ok = valid.astype(bool)
    np.testing.assert_array_equal(t1[ok], want_i1[ok])
    np.testing.assert_array_equal(t2[ok], want_i2[ok])
    assert (t1[~ok] == part.sa_i1[0]).all() and (t2[~ok] == part.sa_i2[0]).all()

    # bwt_char of every BWT position, read from its covering sub-row
    p = torch.arange(n, dtype=torch.int64)
    sub = ti.fwd_blocks[p >> 9, : ti.fwd_blocks.shape[1] // 2]
    code, sbit = tr.bwt_char(sub, p, ti.has_n)
    jsub = jnp.take(ji.fwd_blocks, jnp.asarray(rows >> 9, dtype=jnp.int32), axis=0)
    jcode, jsbit = jr.bwt_char(jsub[:, : sub.shape[1]], jnp.asarray(rows), ji.has_n)
    np.testing.assert_array_equal(np.asarray(jcode).astype(np.int64), code.numpy())
    np.testing.assert_array_equal(np.asarray(jsbit).astype(np.int64), sbit.numpy())


def test_split_strand_matches_jax():
    """Located rows split by strand, rc rows mapped back to forward
    coordinates, each strand position-sorted."""
    seqs = _seqs(4, 31)
    ff = FastaFile(name="g.fa")
    ff.ids = [f"s{i}" for i in range(len(seqs))]
    ff.seqs = seqs
    data = build_index([ff], sampling=3)
    K = 5
    rng = np.random.default_rng(4)
    i1 = rng.integers(0, 2 * len(seqs), 400).astype(np.uint32)
    i2 = (rng.random(400) * (np.asarray([len(s) for s in seqs * 2])[i1] - K + 1)).astype(np.uint32)
    got = MappabilityEngine(data, device="cpu")._split_strand(i1, i2, K)
    want = JaxEngine(data, dedup=False)._split_strand(i1, i2, K)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_light_index_refuses_locate():
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["a"], [np.random.default_rng(3).integers(0, 4, 200, dtype=np.uint8)]
    data = build_index([ff], sampling=4)
    ti = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    with pytest.raises(RuntimeError, match="light=False"):
        tr.locate(ti, torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.uint8))
