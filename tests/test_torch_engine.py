"""genmap_tpu_torch.search.engine against genmap_tpu.search.engine.

Compaction keeps candidate order in every regime of the JAX `_compact`, so
valid slots agree slot for slot; invalid slots are unspecified in both and
every comparison masks by `valid`.  Exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmap_tpu.index.build import build_index
from genmap_tpu.io.fasta import FastaFile
from genmap_tpu.ops import rank as jr
from genmap_tpu.search import engine as je
from genmap_tpu_torch import kernels
from genmap_tpu_torch.ops import rank as tr
from genmap_tpu_torch.search import engine as te
from genmap_tpu_torch.search.schemes import plans_for

torch.set_num_threads(1)

_CACHE = {}


def _pair(alpha):
    if alpha not in _CACHE:
        rng = np.random.default_rng(50 + alpha)
        unit = rng.integers(0, 4, size=60, dtype=np.uint8)
        seq = np.concatenate([rng.integers(0, alpha, size=1200, dtype=np.uint8),
                              np.tile(unit, 6),
                              rng.integers(0, alpha, size=400, dtype=np.uint8)])
        if alpha == 5:
            seq[500:520] = 4
        ff = FastaFile(name="g.fa")
        ff.ids = ["s0"]
        ff.seqs = [seq]
        data = build_index([ff], sampling=3)
        part = data.parts[0]
        ji = jr.DeviceIndex.from_part(data, part)
        ti = tr.DeviceIndex.from_part(data, part, light=True, device="cpu")
        _CACHE[alpha] = (data, ji, ti, jr.DeviceText.from_host(data),
                         tr.DeviceText.from_host(data, "cpu"))
    return _CACHE[alpha]


def _tier(t):
    return te.Tier(t.f_search, t.f_collect, t.f_extend, exact=t.exact)


@pytest.mark.parametrize("F,M", [(1, 16), (4, 16), (8, 40), (64, 96), (16, 300),
                                 (4096, 16385)])
def test_compact_regimes(F, M):
    """F = 1 (argmax), one-hot (F < 64, M < 256) and sort (F >= 64 or
    M >= 256) regimes of the JAX function; the last case's rows are long
    enough for the CUDA kernel's long-row regime."""
    rng = np.random.default_rng(F * 1000 + M)
    rows = 50 if M < kernels.COMPACT_LONG_M else 4
    arrays = rng.integers(0, 2**31 - 1, (4, rows, M)).astype(np.int32)
    valid = rng.random((rows, M)) < rng.random((rows, 1))
    jout, jvalid, jovf = je._compact(
        tuple(jnp.asarray(a.view(np.uint32)) for a in arrays), jnp.asarray(valid), F
    )
    tout, tvalid, tovf = te._compact(torch.from_numpy(arrays),
                                     torch.from_numpy(valid.astype(np.uint8)), F)
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(jvalid, tvalid.numpy().astype(bool))
    np.testing.assert_array_equal(np.asarray(jovf), tovf.numpy())
    for r in range(4):
        np.testing.assert_array_equal(
            np.asarray(jout[r]).astype(np.int64)[jvalid],
            tr.u32(tout[r]).numpy()[jvalid],
        )


@pytest.mark.parametrize("Fe", [1, 6])
@pytest.mark.parametrize("rev_compl", [True, False])
@pytest.mark.parametrize("with_exact", [False, True])
def test_count_tail(Fe, rev_compl, with_exact):
    """Per-k-mer counts (and zero-error interval outputs) from final states:
    Fe = 1 (every f_extend = 1 tier) and Fe = 6."""
    _data, ji, ti, _jt, _tt = _pair(4)
    rng = np.random.default_rng(10 * Fe + 2 * rev_compl + with_exact)
    B, J, cap = 9, 7, 255
    n = ji.n_total
    flo = rng.integers(0, n, (B, J, Fe))
    size = np.minimum(rng.integers(1, 400, (B, J, Fe)), n - flo)
    rlo = rng.integers(0, n, (B, J, Fe))
    err = rng.integers(0, 3, (B, J, Fe))
    valid = rng.random((B, J, Fe)) < 0.7
    cnt = rng.integers(0, J + 1, B).astype(np.int32)
    U = jnp.uint32
    want = je._count_tail(
        ji, (jnp.asarray(flo, U), jnp.asarray(rlo, U), jnp.asarray(size, U),
             jnp.asarray(err, U), jnp.asarray(valid)),
        jnp.asarray(cnt), J, cap, rev_compl, with_exact=with_exact)
    st = np.stack([flo, rlo, size, err]).astype(np.uint32).view(np.int32)
    got = te._count_tail(ti, (torch.from_numpy(st), torch.from_numpy(valid.astype(np.uint8))),
                         torch.from_numpy(cnt), J, cap, rev_compl, with_exact)
    got = got if with_exact else (got,)
    keys = ("hits", "exact_size", "exact_size_total", "exact_flo")[:len(got)]
    for key, g in zip(keys, got):
        np.testing.assert_array_equal(np.asarray(want[key]).astype(np.int64),
                                      tr.u32(g).numpy() if key != "hits" else
                                      g.numpy().astype(np.int64), err_msg=key)
    assert np.asarray(want["hits"]).any()


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("exact", [True, False])
def test_candidate_step_dir(alpha, exact):
    _data, ji, ti, _jt, _tt = _pair(alpha)
    rng = np.random.default_rng(60 + alpha + 2 * exact)
    B, F, P = 30, 8, 3
    N = B * F
    n = ji.n_total
    flo = rng.integers(0, n, N)
    rlo = rng.integers(0, n, N)
    size = np.minimum(rng.integers(1, 900, N), n - np.maximum(flo, rlo))
    err = rng.integers(0, 3, N)
    plan = rng.integers(0, P, N)
    valid = rng.random(N) < 0.8
    nch_tab = rng.integers(0, 5, (B, P)).astype(np.uint8)
    right = rng.integers(0, 2, P).astype(bool)
    u = rng.integers(0, 4, P).astype(np.int32)
    lreq = rng.integers(0, 2, P).astype(np.int32)
    blk = np.arange(N) // F

    U = jnp.uint32
    want = je._candidate_step_dir(
        ji, jnp.asarray(right[plan]), jnp.asarray(flo, U),
        jnp.asarray(rlo, U), jnp.asarray(size, U), jnp.asarray(err, jnp.int32),
        jnp.asarray(valid), jnp.asarray(nch_tab[blk, plan], U),
        jnp.asarray(u[plan])[:, None], jnp.asarray(lreq[plan])[:, None],
        exact=exact,
    )
    st = np.stack([flo, rlo, size, err, plan]).astype(np.uint32).view(np.int32)
    out, valid2, far = kernels.candidate_step(
        ti, torch.from_numpy(st), torch.from_numpy(valid.astype(np.uint8)),
        per_block=F, inner=F, nch=torch.from_numpy(nch_tab),
        right=torch.from_numpy(right.astype(np.uint8)),
        act=torch.ones(P, dtype=torch.uint8), u=torch.from_numpy(u),
        lreq=torch.from_numpy(lreq), exact=exact,
    )
    np.testing.assert_array_equal(np.asarray(want[5]), far.numpy().astype(bool))
    if not exact:
        assert far.any()
    np.testing.assert_array_equal(np.asarray(want[4]), valid2.numpy().astype(bool))
    ok = valid & ~np.asarray(want[5])  # far states carry no valid result
    for r in range(4):
        np.testing.assert_array_equal(
            np.asarray(want[r]).astype(np.int64)[ok],
            (tr.u32(out[r]) if r < 3 else out[r].to(torch.int64)).numpy()[ok],
        )
    np.testing.assert_array_equal(out[4].numpy()[valid], np.repeat(plan[valid, None], ji.nchars, 1))


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("tier_i", [0, 2])
def test_search_infix_survivors(alpha, tier_i):
    data, ji, ti, jt, tt = _pair(alpha)
    K, e, o = 16, 2, 12
    J = K - o + 1
    B = 40
    tier = je.DEFAULT_TIERS[tier_i]
    starts = np.random.default_rng(70 + alpha).integers(0, data.text_len - K - J, B)
    starts = starts.astype(np.uint32)
    plans = plans_for(e, o)
    n = ji.n_total
    ex = je.exact_prefix_steps(n, 64)
    jneedles = jr.extract_needles(jt, jnp.asarray(starts), K + J - 1,
                                  jnp.uint32(data.text_len))
    (jf, jrl, js, jerr, jv, jp), jcap, jfar = je._search_infix(
        ji, plans, K - o, jneedles, B, tier, n, ex, n)
    tneedles = tr.extract_needles(tt, torch.from_numpy(starts.view(np.int32)),
                                  K + J - 1, data.text_len)
    pools = te.infix_pool_schedule(plans, K - o, n, tier.f_search / 4.0)
    (st, tv), tcap, tfar = te._search_infix(
        ti, te._InfixSchedule(plans, K - o, "cpu"), tneedles, B, _tier(tier),
        n, ex, pools)
    jv = np.asarray(jv)
    assert jv.any()
    np.testing.assert_array_equal(jv, tv.numpy().astype(bool))
    np.testing.assert_array_equal(np.asarray(jcap), tcap.numpy())
    np.testing.assert_array_equal(np.asarray(jfar), tfar.numpy())
    for r, w in enumerate((jf, jrl, js, jerr, jp)):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64)[jv],
                                      tr.u32(st[r]).numpy()[jv])


@pytest.mark.parametrize("alpha", [4, 5])
def test_block_mapper_tiers(alpha):
    """hits / overflow / overflow_cap of the whole batch program against the
    JAX make_block_mapper at tiers 0-2, with and without -nc."""
    data, ji, ti, jt, tt = _pair(alpha)
    K, e, o = 14, 1, 9
    J = K - o + 1
    B = 48
    rng = np.random.default_rng(80 + alpha)
    starts = np.sort(rng.integers(0, data.text_len - K, B)).astype(np.uint32)
    cnt = rng.integers(1, J + 1, B).astype(np.int32)
    limit = data.text_len - 40
    for tier_i, rev_compl in ((0, True), (1, False), (2, True)):
        tier = je.DEFAULT_TIERS[tier_i]
        jm = je.make_block_mapper(ji, jt, K=K, errors=e, overlap=o, J=J, B=B,
                                  tier=tier, cap=255, rev_compl=rev_compl)
        want = jm(jnp.asarray(starts), jnp.asarray(cnt), jnp.uint32(limit))
        tm = te.BlockMapper(ti, tt, K=K, errors=e, overlap=o, J=J, B=B,
                            tier=_tier(tier), cap=255, rev_compl=rev_compl)
        kernels.reset_launches()
        got = tm(torch.from_numpy(starts.view(np.int32)), torch.from_numpy(cnt), limit)
        for k in ("hits", "overflow", "overflow_cap"):
            np.testing.assert_array_equal(
                np.asarray(want[k]).astype(np.int64), got[k].numpy().astype(np.int64),
                err_msg=f"{k} tier {tier_i}",
            )
        assert np.asarray(want["hits"]).any()
