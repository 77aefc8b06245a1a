"""genmap_tpu_torch.ops.rank against genmap_tpu.ops.rank (JAX on the CPU).

Both packages get the same index arrays (the port's from_numpy takes the
JAX package's host index) and the same random queries from a numpy seed.
All arithmetic is integer: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmap_tpu.index.build import build_index
from genmap_tpu.io.fasta import FastaFile
from genmap_tpu.ops import rank as jr
from genmap_tpu_torch.ops import rank as tr

torch.set_num_threads(1)


def _data(alpha, seed=0):
    rng = np.random.default_rng(seed + alpha)
    unit = rng.integers(0, 4, size=80, dtype=np.uint8)
    seqs = [
        np.concatenate([rng.integers(0, alpha, size=1500, dtype=np.uint8),
                        np.tile(unit, 8)]),
        rng.integers(0, alpha, size=700, dtype=np.uint8),
    ]
    if alpha == 5:
        seqs[0][200:230] = 4
    ff = FastaFile(name="g.fa")
    ff.ids = ["s0", "s1"]
    ff.seqs = seqs
    return build_index([ff], sampling=3)


_CACHE = {}


def _pair(alpha):
    if alpha not in _CACHE:
        data = _data(alpha)
        part = data.parts[0]
        ji = jr.DeviceIndex.from_part(data, part)
        ti = tr.DeviceIndex.from_numpy(
            part.fwd.blocks, part.C, part.strand_blocks, has_n=data.has_n,
            sampling=data.sampling, device="cpu",
        )
        _CACHE[alpha] = (data, ji, ti)
    return _CACHE[alpha]


def _u(x):
    return np.asarray(x).astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _queries(rng, n, count, top):
    mlo = rng.integers(0, n, count)
    size = np.minimum(rng.integers(0, top, count), n - mlo)
    olo = rng.integers(0, n, count)
    return mlo, size, olo


@pytest.mark.parametrize("alpha", [4, 5])
def test_seed_tables(alpha):
    _data_, ji, ti = _pair(alpha)
    assert ji.seed_t0 == ti.seed_t0
    np.testing.assert_array_equal(_u(ji.seed_mlo), tr.u32(ti.seed_mlo).numpy())
    np.testing.assert_array_equal(_u(ji.seed_size), tr.u32(ti.seed_size).numpy())


@pytest.mark.parametrize("alpha", [4, 5])
def test_extend_core(alpha):
    _data_, ji, ti = _pair(alpha)
    rng = np.random.default_rng(10 + alpha)
    mlo, size, olo = _queries(rng, ji.n_total, 400, 3000)
    want = jr.extend_core(ji, *(jnp.asarray(x, jnp.uint32) for x in (mlo, size, olo)))
    got = tr.extend_core(ti, _t(mlo), _t(size), _t(olo))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_u(w), g.numpy())


@pytest.mark.parametrize("alpha", [4, 5])
def test_extend_core_fast_and_far(alpha):
    _data_, ji, ti = _pair(alpha)
    rng = np.random.default_rng(20 + alpha)
    mlo, size, olo = _queries(rng, ji.n_total, 400, 1500)
    want = jr.extend_core_fast(ji, *(jnp.asarray(x, jnp.uint32) for x in (mlo, size, olo)))
    got = tr.extend_core_fast(ti, _t(mlo), _t(size), _t(olo))
    far = np.asarray(want[3])
    assert far.any() and not far.all()
    np.testing.assert_array_equal(far, got[3].numpy())
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(_u(w)[~far], g.numpy()[~far])


@pytest.mark.parametrize("alpha", [4, 5])
def test_rc_strand_count(alpha):
    _data_, ji, ti = _pair(alpha)
    p = np.random.default_rng(30 + alpha).integers(0, ji.n_total + 1, 500)
    np.testing.assert_array_equal(
        _u(jr.rc_strand_count(ji, jnp.asarray(p, jnp.uint32))),
        tr.rc_strand_count(ti, _t(p)).numpy(),
    )


@pytest.mark.parametrize("alpha", [4, 5])
def test_extract_needles(alpha):
    data, _ji, _ti = _pair(alpha)
    jt = jr.DeviceText.from_host(data)
    tt = tr.DeviceText.from_host(data, device="cpu")
    starts = np.random.default_rng(40 + alpha).integers(0, data.text_len, 200)
    starts = starts.astype(np.uint32)
    for Ln, limit in ((21, data.text_len), (149, data.text_len - 300)):
        want = jr.extract_needles(jt, jnp.asarray(starts), Ln, jnp.uint32(limit))
        got = tr.extract_needles(tt, torch.from_numpy(starts.view(np.int32)), Ln, limit)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_from_part_matches_from_numpy():
    data, _ji, ti = _pair(5)
    tp = tr.DeviceIndex.from_part(data, data.parts[0], device="cpu")
    for name in ("fwd_blocks", "C", "strand_blocks", "seed_mlo", "seed_size",
                 "sa_i1", "sa_i2", "ind_blocks"):
        if name in ("sa_i1", "sa_i2", "ind_blocks"):
            assert getattr(tp, name).numel() > 0  # uploaded unless light
            continue
        assert torch.equal(getattr(tp, name), getattr(ti, name)), name
    light = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    assert light.sa_i1.numel() == 0 and light.ind_blocks.numel() == 0
