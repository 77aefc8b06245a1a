"""The port's plain versions at values at or past 2^31 (hg38 scale).

At 3.1 Gbp the text positions of chr21 start near 2.79e9 and a 4.17e9-symbol
index part has SA rows and interval sizes past 2^31.  They travel as int32
tensors holding uint32 bits; any step that reads such a value as a signed
int32 sees a negative number.  Each test feeds small inputs whose values lie
past 2^31 (and at 2^32 - 1) through the port's function and through the JAX
package's function (or, where the JAX code is inline, its own expressions on
jnp arrays), and requires equal results.  The CUDA kernels are held against
these plain versions at the same kind of values by `chip_smoke.py`'s `wide`
phase.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmap_tpu.search import engine as je
from genmap_tpu_torch import kernels
from genmap_tpu_torch.engine.mappability import MappabilityEngine
from genmap_tpu_torch.ops import rank as tr
from genmap_tpu_torch.search import engine as te

torch.set_num_threads(1)

U32 = jnp.uint32
TOP = 2**32 - 1


def _i32(a: np.ndarray) -> torch.Tensor:
    """int32 tensor holding the uint32 bits of `a`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _wide(rng, shape, lo=2**31, hi=2**32):
    """uint32 values in [lo, hi), with 2^31 and 2^32 - 1 planted."""
    a = rng.integers(lo, hi, shape, dtype=np.uint64).astype(np.uint32)
    flat = a.reshape(-1)
    flat[0], flat[-1] = np.uint32(lo), np.uint32(hi - 1)
    return a


def _strand_table(rng, rows: int, touched: np.ndarray) -> np.ndarray:
    """[rows, 5] uint32 strand rank rows (count + 4 words), zero except
    around the rows that `touched` positions read, which get random words
    and counts past 2^31."""
    t = np.zeros((rows, 5), np.uint32)
    r = np.unique(np.clip(touched.astype(np.int64) >> 7, 0, rows - 1))
    t[r, 0] = rng.integers(2**31, 2**32 - 2**20, len(r), dtype=np.uint64).astype(np.uint32)
    t[r, 1:] = rng.integers(0, 2**32, (len(r), 4), dtype=np.uint64).astype(np.uint32)
    return t


@pytest.mark.parametrize("rev_compl,with_exact", [(True, False), (False, False),
                                                   (True, True), (False, True)])
@pytest.mark.parametrize("cap", [255, 65535])
def test_count_tail_past_2_31(rev_compl, with_exact, cap):
    """Sizes and flo past 2^31; hits saturate at the cap, exact sums wrap
    mod 2^32 as JAX's uint32 sums do.  Without the strand rows (rev_compl,
    no exact outputs) sizes reach 2^32 - 1."""
    rng = np.random.default_rng(cap + 2 * rev_compl + with_exact)
    B, J, Fe = 6, 5, 4
    reads_strand = with_exact or not rev_compl
    if reads_strand:
        flo = rng.integers(2**31 - 2**12, 2**31 + 2**22, (B, J, Fe), dtype=np.uint64)
        size = rng.integers(0, 2**20, (B, J, Fe), dtype=np.uint64)
        size[0, 0, 0] = 2**21  # past 2^31 from below
        flo[1] = 2**31 + 2**22  # at the top of the table
    else:
        flo = _wide(rng, (B, J, Fe)).astype(np.uint64)
        size = np.minimum(_wide(rng, (B, J, Fe), lo=2**30).astype(np.uint64), 2**32 - 1 - flo)
        size[0, 0] = 2**32 - 1 - flo[0, 0]
    flo, size = flo.astype(np.uint32), size.astype(np.uint32)
    rlo = _wide(rng, (B, J, Fe))
    err = rng.integers(0, 3, (B, J, Fe)).astype(np.uint32)
    err[:, :2] = 0
    valid = rng.random((B, J, Fe)) < 0.8
    cnt = rng.integers(1, J + 1, B).astype(np.int32)
    rows = (2**31 + 2**23) // 128 if reads_strand else 2
    table = _strand_table(rng, rows, np.concatenate([flo.ravel(), (flo + size).ravel()]))
    jidx = types.SimpleNamespace(strand_blocks=jnp.asarray(table))
    tidx = types.SimpleNamespace(strand_blocks=_i32(table))
    want = je._count_tail(
        jidx, tuple(jnp.asarray(x, U32) for x in (flo, rlo, size, err)) + (jnp.asarray(valid),),
        jnp.asarray(cnt), J, cap, rev_compl, with_exact=with_exact)
    st = torch.stack([_i32(x) for x in (flo, rlo, size, err)])
    got = te._count_tail(tidx, (st, torch.from_numpy(valid.astype(np.uint8))),
                         torch.from_numpy(cnt), J, cap, rev_compl, with_exact)
    got = got if with_exact else (got,)
    keys = ("hits", "exact_size", "exact_size_total", "exact_flo")[:len(got)]
    for key, g in zip(keys, got):
        w = np.asarray(want[key]).astype(np.int64)
        v = g.numpy().astype(np.int64) if key == "hits" else tr.u32(g).numpy()
        np.testing.assert_array_equal(v, w, err_msg=key)
    hits = np.asarray(want["hits"])
    assert (hits == cap).any()
    if with_exact:
        assert (np.asarray(want["exact_flo"]) >= 2**31).any()


@pytest.mark.parametrize("F,M", [(1, 16), (4, 16), (64, 96), (16, 300)])
def test_compact_payloads_past_2_31(F, M):
    """Every regime of the JAX `_compact` carries states whose rows all lie
    past 2^31, 2^32 - 1 included, slot for slot."""
    rng = np.random.default_rng(F * 7 + M)
    arrays = _wide(rng, (4, 40, M))
    arrays[:, ::2, 0] = TOP
    valid = rng.random((40, M)) < rng.random((40, 1))
    valid[:, 0] = True
    jout, jvalid, jovf = je._compact(tuple(jnp.asarray(a) for a in arrays),
                                     jnp.asarray(valid), F)
    tout, tvalid, tovf = te._compact(_i32(arrays), torch.from_numpy(valid.astype(np.uint8)), F)
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy().astype(bool), jvalid)
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    for r in range(4):
        np.testing.assert_array_equal(tr.u32(tout[r]).numpy()[jvalid],
                                      np.asarray(jout[r]).astype(np.int64)[jvalid])
    assert (np.asarray(jout[0])[::2, 0] == TOP).all()


def _jax_gather(x, ridx, n, Fe, valid=False):
    """The split pipeline's rung gather (`sl()` of the JAX engine's
    `_run_tier_split`): rows `ridx`, cut or zero-padded to Fe slots, rows
    >= n invalid."""
    x = jnp.take(jnp.asarray(x), jnp.asarray(ridx), axis=0)
    Fc = x.shape[1]
    x = x[:, :Fe] if Fc >= Fe else jnp.concatenate(
        [x, jnp.zeros((x.shape[0], Fe - Fc), x.dtype)], axis=1)
    if valid:
        x = x & (jnp.arange(x.shape[0]) < n)[:, None]
    return np.asarray(x)


@pytest.mark.parametrize("Fc,Fe", [(16, 8), (8, 32)])
def test_gather_states_payloads_past_2_31(Fc, Fe):
    rng = np.random.default_rng(Fc + Fe)
    B, n, npad = 30, 21, 32
    st = _wide(rng, (4, B, Fc))
    valid = rng.random((B, Fc)) < 0.6
    ridx = np.zeros(npad, np.int32)
    ridx[:n] = rng.integers(0, B, n)
    gst, gvalid = kernels.gather_states_plain(
        _i32(st), torch.from_numpy(valid.astype(np.uint8)), torch.from_numpy(ridx), n, Fe)
    wvalid = _jax_gather(valid, ridx, n, Fe, valid=True)
    np.testing.assert_array_equal(gvalid.numpy().astype(bool), wvalid)
    for r in range(4):
        w = _jax_gather(st[r], ridx, n, Fe).astype(np.int64)
        np.testing.assert_array_equal(tr.u32(gst[r]).numpy()[wvalid], w[wvalid])
    assert (tr.u32(gst).numpy()[:, wvalid] >= 2**31).all()


def _jax_mass(size, plan, valid, P):
    """The JAX probe branch's per-plan mass (uint32 sums, which wrap)."""
    pm = (jnp.asarray(plan)[..., None] == jnp.arange(P, dtype=jnp.int32)) \
        & jnp.asarray(valid)[..., None]
    return np.asarray(jnp.where(pm, jnp.asarray(size, U32)[..., None], U32(0))
                      .sum(axis=-2, dtype=U32)).astype(np.int64)


@pytest.mark.parametrize("has_n", [False, True])
def test_probe_mass_past_2_31(has_n):
    """Per-plan masses past 2^31 equal the JAX probe's where its uint32 sum
    does not wrap; past 2^32 the port saturates at 2^32 - 1 (the JAX sum
    wraps there: ROADMAP Queue 3), also summed over two parts."""
    rng = np.random.default_rng(11 + has_n)
    B, F, P, Ln = 8, 12, 3, 40
    size = rng.integers(0, 2**29, (B, F), dtype=np.uint64).astype(np.uint32)
    size[:4, 0] = 2**31 + rng.integers(0, 2**20, 4)  # one big interval: no wrap
    size[4:, :6] = 2**31 + 2**30  # six big intervals: past 2^32
    plan = (np.arange(F) % P)[None, :].repeat(B, 0).astype(np.int32)
    valid = rng.random((B, F)) < 0.9
    valid[:, :6] = True
    st = np.zeros((5, B, F), np.uint32)
    st[2], st[4] = size, plan.view(np.uint32)
    needles = rng.integers(0, 4, (B, Ln)).astype(np.uint8)
    if has_n:
        needles[1, 7] = 4
    thr = np.array([1, 0, 2], np.int32)
    ovf = np.zeros(B, np.uint8)
    args = (_i32(st), torch.from_numpy(valid.astype(np.uint8)), torch.from_numpy(ovf),
            torch.from_numpy(needles), torch.from_numpy(thr), has_n)
    skip, mass, nwin = kernels.probe_mass_plain(*args, with_mass=True)
    exact = size.astype(np.int64)[..., None] * ((plan[..., None] == np.arange(P))
                                                & valid[..., None])
    exact = exact.sum(axis=1)
    jmass = _jax_mass(size, plan, valid, P)
    got = tr.u32(mass).numpy()
    fits = exact < 2**32
    assert fits[:4].all() and (exact[:4] >= 2**31).any() and not fits[4:].all()
    np.testing.assert_array_equal(got[fits], jmass[fits])
    np.testing.assert_array_equal(got, np.minimum(exact, TOP))
    np.testing.assert_array_equal(skip.numpy(), np.zeros(B, np.uint8))
    # two parts: the first's accumulator plus the second's masses
    acc = kernels.probe_mass_plain(*args, last=False)
    skip2, mass2, _ = kernels.probe_mass_plain(*args, with_mass=True, acc=acc)
    np.testing.assert_array_equal(tr.u32(mass2).numpy(), np.minimum(2 * exact, TOP))


@pytest.mark.parametrize("t_seed", [0, 1, 3])
def test_seed_lookup_tables_past_2_31(t_seed):
    """Seed tables whose entries lie past 2^31 and a part of n_total past
    2^31 (t_seed 0 gives the whole part), held against the JAX engine's
    seeded prefix (`_search_infix`, its own expressions on jnp arrays)."""
    rng = np.random.default_rng(5 + t_seed)
    B, Ln, Fp = 9, 24, 8
    a_pos = np.array([0, 5, 13], np.int32)
    P = len(a_pos)
    n_total = 4_169_941_722
    levels = tr.seed_level_offset(4)
    mlo = _wide(rng, levels)
    size = _wide(rng, levels, lo=2**31 + 1)
    size[rng.random(levels) < 0.2] = 0
    needles = rng.integers(0, 4, (B, Ln)).astype(np.uint8)
    needles[2, 6] = 4
    tidx = types.SimpleNamespace(seed_mlo=_i32(mlo), seed_size=_i32(size))
    st, valid = kernels.seed_lookup_plain(tidx, torch.from_numpy(needles),
                                          torch.from_numpy(a_pos), t_seed, Fp, n_total)
    st = tr.u32(st).numpy()
    valid = valid.numpy().astype(bool)
    if t_seed == 0:
        assert (st[2, :, :P] == n_total).all() and valid[:, :P].all()
        assert not valid[:, P:].any()
        return
    off = tr.seed_level_offset(t_seed)
    pw = (4 ** np.arange(t_seed - 1, -1, -1, dtype=np.int64)).astype(np.uint32)
    for p in range(P):
        w = jnp.asarray(needles[:, a_pos[p]: a_pos[p] + t_seed]).astype(U32)
        okw = (w < 4).all(axis=-1)
        code = (jnp.minimum(w, 3) * jnp.asarray(pw)).sum(axis=-1)
        rc_code = ((U32(3) - jnp.minimum(w, 3)) * jnp.asarray(pw[::-1])).sum(axis=-1)
        wm = np.asarray(jnp.take(jnp.asarray(mlo), (off + code).astype(jnp.int32)))
        ws = np.asarray(jnp.take(jnp.asarray(size), (off + code).astype(jnp.int32)))
        wr = np.asarray(jnp.take(jnp.asarray(mlo), (off + rc_code).astype(jnp.int32)))
        np.testing.assert_array_equal(st[0, :, p], wm)
        np.testing.assert_array_equal(st[1, :, p], wr)
        np.testing.assert_array_equal(st[2, :, p], ws)
        np.testing.assert_array_equal(valid[:, p], np.asarray(okw) & (ws > 0))
    assert not valid[:, P:].any()
    assert (st[0, :, :P] >= 2**31).all()


def test_extract_needles_plain_past_2_31():
    """Windows at starts just below and past 2^31, ending at `limit` and at
    the text's last symbol, with N bits, from a packed text of 2^31 + 2^16
    symbols (zero pages except where the windows read)."""
    rng = np.random.default_rng(9)
    n = 2**31 + 2**16
    words = np.zeros((n + 15) // 16, np.uint32)
    nwords = np.zeros((n + 31) // 32, np.uint32)
    Ln = 40
    starts = np.array([2**31 - 20, 2**31 - 1, 2**31, 2**31 + 1000, n - Ln, n - 7,
                       n - Ln - 1000, 5], np.int64)
    limit = n - 1000
    ref = np.zeros(n, np.uint8)  # lazily paged: only the windows are touched
    for s in starts:
        seg = rng.integers(0, 5, Ln).astype(np.uint8)
        e = min(int(s) + Ln, n)
        ref[s:e] = seg[: e - s]
    for s in starts:
        for q in range(int(s) & ~31, min(int(s) + Ln + 32, n), 32):
            c = ref[q: q + 32]
            w0 = q // 16
            two = np.where(c >= 4, 0, c).astype(np.uint64)
            lo, hi = two[:16], two[16:]
            words[w0] = np.uint32((lo << (2 * np.arange(len(lo), dtype=np.uint64))).sum())
            if len(hi):
                words[w0 + 1] = np.uint32((hi << (2 * np.arange(len(hi), dtype=np.uint64))).sum())
            nb = (c == 4).astype(np.uint64)
            nwords[q // 32] = np.uint32((nb << np.arange(len(nb), dtype=np.uint64)).sum())
    got = kernels.extract_needles_plain(
        _i32(words), _i32(nwords), _i32(starts.astype(np.uint32)), Ln, limit, n).numpy()
    for i, s in enumerate(starts):
        pos = int(s) + np.arange(Ln)
        want = np.where(pos < limit, ref[np.minimum(pos, n - 1)], 0)
        np.testing.assert_array_equal(got[i], want, err_msg=f"start {s}")


def test_run_batch_ships_starts_past_2_31():
    """The engine's host conversion (`_run_batch`) of block starts of a file
    that begins past 2^31: every mapper sees the uint32 bits of the global
    positions and the exclusive end `limit` as a Python int past 2^31."""
    seen = []

    class Run:
        probe = False

        def __call__(self, st, ct, limit):
            seen.append((tr.u32(st).numpy().copy(), ct.numpy().copy(), limit))
            return {}

    layout = types.SimpleNamespace(start=2_788_092_608, length=1_200_000_000)
    bstarts = np.array([0, 5, 1_000_000_000, 1_199_999_990], np.int64)
    bcnts = np.array([5, 5, 3, 1], np.int32)
    eng = types.SimpleNamespace(device=torch.device("cpu"))
    MappabilityEngine._run_batch(eng, [Run(), Run()], layout, bstarts, bcnts, 6)
    assert len(seen) == 2
    for st, ct, limit in seen:
        np.testing.assert_array_equal(st, np.concatenate([layout.start + bstarts,
                                                          [layout.start] * 2]))
        np.testing.assert_array_equal(ct, [5, 5, 3, 1, 0, 0])
        assert limit == 3_988_092_608
