"""The dimer rank path of genmap_tpu_torch against the JAX package's.

Rank level (after tests/test_dimer.py): the port's `_dimer_occ` equals the
JAX function and brute-force counts over the suffix array on Dna4 and Dna5;
flagged sub-blocks raise `far` in both extension variants.

Step level: `kernels.dimer_step` (its plain version on the CPU) equals the
JAX package's `_candidate_step_fused` on the same states for every static
variant (exact / fast rank path x mono steps x passthrough slots), on Dna4
and Dna5, with left and right steps, consume 0, 1 and 2, needles with N,
and intervals at the fast window's edges; plan-id (R = 5) and tree-node
(R = 4) groups.  Batch level: one batch of the port's block mapper on a
dimer tier equals the JAX mapper's.  Integer results: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genmap_tpu.alphabet import revcomp_codes
from genmap_tpu.index.build import _make_ctext
from genmap_tpu.index.build import build_index as jax_build_index
from genmap_tpu.index.suffix import suffix_array
from genmap_tpu.io.fasta import FastaFile as JaxFastaFile
from genmap_tpu.ops import rank as jr
from genmap_tpu.search import engine as je
from genmap_tpu_torch import kernels
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank as tr
from genmap_tpu_torch.search import engine as te

torch.set_num_threads(1)


def _seqs(seed, n, nseq, with_n):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(nseq):
        s = rng.integers(0, 4, size=n // nseq, dtype=np.uint8)
        if with_n:  # sparse N, as in real genomes
            s[rng.integers(0, len(s), size=2)] = 4
        seqs.append(s)
    return seqs


def _data(seed=0, n=9000, nseq=3, with_n=False, jax_build=False):
    ff = (JaxFastaFile if jax_build else FastaFile)(name="t.fa")
    ff.ids = [f"chr{i}" for i in range(nseq)]
    ff.seqs = _seqs(seed, n, nseq, with_n)
    return (jax_build_index if jax_build else build_index)([ff], sampling=4)


@pytest.fixture(scope="module", params=[False, True], ids=["dna4", "dna5"])
def pair(request):
    """(data, JAX DeviceIndex, port DeviceIndex) of a 9 kbp genome."""
    data = _data(seed=2, with_n=request.param)
    assert data.parts[0].dimer is not None
    ji = jr.DeviceIndex.from_part(data, data.parts[0])
    ti = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    assert ti.has_dimer and ti.nchars == (5 if request.param else 4)
    return data, ji, ti


@pytest.mark.parametrize("with_n", [False, True])
def test_dimer_occ_matches_jax_and_bruteforce(with_n):
    data = _data(seed=1, with_n=with_n, jax_build=True)
    part = data.parts[0]
    seqs, pos = [], 0
    for ln in data.seq_lens:
        seqs.append(data.decode_slice(pos, int(ln)))
        pos += int(ln)
    ctext = _make_ctext(seqs + [revcomp_codes(s) for s in seqs])
    sa = suffix_array(ctext)
    n = len(ctext)
    b1 = ctext[(sa.astype(np.int64) - 1) % n]
    b2 = ctext[(sa.astype(np.int64) - 2) % n]
    valid = (b1 >= 1) & (b1 <= 4) & (b2 >= 1) & (b2 <= 4)
    code = np.where(valid, (b1 - 1) * 4 + (b2 - 1), 0)
    mono_real = (b1 >= 1) & (b1 <= 4)
    nblk = n // 128 + 1
    bad = np.concatenate([~valid, np.zeros(nblk * 128 - n, bool)])
    blk_bad = bad.reshape(nblk, 128).any(axis=1)

    rng = np.random.default_rng(3)
    ps = np.sort(np.concatenate([rng.integers(0, n + 1, size=200),
                                 [0, 15, 16, 127, 128, n]])).astype(np.uint32)
    sub = np.vstack([part.dimer, np.zeros((1, 64), np.uint32)])[ps >> 7]
    jL, jLm, jflag = (np.asarray(x) for x in jr._dimer_occ(jnp.asarray(sub), jnp.asarray(ps)))
    tL, tLm, tflag = tr._dimer_occ(torch.from_numpy(sub.view(np.int32)),
                                   torch.from_numpy(ps.astype(np.int64)))
    np.testing.assert_array_equal(tL.numpy(), jL.astype(np.int64))
    np.testing.assert_array_equal(tLm.numpy(), jLm.astype(np.int64))
    np.testing.assert_array_equal(tflag.numpy(), jflag)
    n_checked = 0
    for i, p in enumerate(ps.astype(np.int64)):
        assert bool(tflag[i]) == bool(blk_bad[p >> 7])
        if tflag[i]:
            continue  # flagged sub-blocks escalate; counts are unreliable
        n_checked += 1
        want = [(valid[:p] & (code[:p] <= t)).sum() for t in range(16)]
        np.testing.assert_array_equal(tL[i].numpy(), want)
        want = [(mono_real[:p] & (b1[:p] - 1 <= y)).sum() for y in range(4)]
        np.testing.assert_array_equal(tLm[i].numpy(), want)
    assert n_checked >= len(ps) // 2


def test_flagged_subblocks_raise_far():
    # a tiny genome: nearly every sub-block holds a sentinel-adjacent row
    data = _data(seed=4, n=120, nseq=3)
    ti = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    mlo = torch.zeros(4, dtype=torch.int64)
    size = torch.full((4,), min(ti.n_total, 100), dtype=torch.int64)
    for fn in (tr.extend_dimer, tr.extend_dimer_fast):
        assert fn(ti, mlo, size, torch.zeros(4, dtype=torch.int64))[2].all()


def _step_inputs(ti, rng, R, exact, with_mono, with_pass):
    """Random step inputs: (st, valid, kwargs) with intervals spread over
    the index, at the dimer sub-rows' edges and around the fast window."""
    n = ti.n_total
    G, nblk = 4, 8
    N = 384
    per_block = N // nblk
    inner = per_block // G
    lo = np.concatenate([
        rng.integers(0, n + 1, N // 2),
        (128 * rng.integers(0, n // 128, N // 2)
         + rng.choice([0, 1, 15, 16, 126, 127], N // 2)),
    ])
    lo = np.minimum(lo, n)
    kind = rng.integers(0, 4, N)
    edge = 128 * rng.integers(0, 3, N) + rng.integers(-2, 3, N)  # 0, 1 or 2 rows on
    size = np.where(kind == 0, rng.integers(0, 20, N),
                    np.where(kind == 1, np.maximum(0, 128 - lo % 128 + edge),
                             np.where(kind == 2, rng.integers(0, 600, N),
                                      rng.integers(0, n + 1, N))))
    size = np.minimum(size, n - lo)
    st = np.zeros((R, N), np.int64)
    other = (rng.random(N) * (n - size + 1)).astype(np.int64)  # also fits size
    side = rng.integers(0, 2, N).astype(bool)  # which interval starts at lo
    st[0] = np.where(side, lo, other)
    st[1] = np.where(side, other, lo)
    st[2] = size
    st[3] = rng.integers(0, 3, N)
    if R == 5:
        st[4] = rng.integers(0, G, N)
    valid = (rng.random(N) < 0.9).astype(np.uint8)
    allowed = [2] + ([1] if with_mono else []) + ([0] if with_pass else [])
    consume = np.array([allowed[g % len(allowed)] for g in range(G)], np.uint8)
    right = np.array([0, 1, 1, 0], np.uint8)
    u_mid = rng.integers(0, 3, G)
    u_end = u_mid + rng.integers(0, 2, G)
    l_mid = rng.integers(0, 2, G)
    l_end = l_mid + rng.integers(0, 2, G)
    nch = rng.integers(0, 5, (2, nblk, G)).astype(np.uint8)
    kw = dict(per_block=per_block, inner=inner,
              consume=torch.from_numpy(consume), right=torch.from_numpy(right),
              u_mid=torch.from_numpy(u_mid.astype(np.int32)),
              u_end=torch.from_numpy(u_end.astype(np.int32)),
              l_mid=torch.from_numpy(l_mid.astype(np.int32)),
              l_end=torch.from_numpy(l_end.astype(np.int32)),
              nchA=torch.from_numpy(nch[0]), nchB=torch.from_numpy(nch[1]),
              exact=exact, with_mono=with_mono, with_pass=with_pass)
    return tr.as_i32(torch.from_numpy(st)), torch.from_numpy(valid), kw


@pytest.mark.parametrize("with_pass", [False, True], ids=["nopass", "pass"])
@pytest.mark.parametrize("with_mono", [False, True], ids=["dimer", "mono"])
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_dimer_step_matches_jax(pair, exact, with_mono, with_pass):
    _data_, ji, ti = pair
    rng = np.random.default_rng(10 + 4 * exact + 2 * with_mono + with_pass)
    for R in (5, 4):
        st, valid, kw = _step_inputs(ti, rng, R, exact, with_mono, with_pass)
        out, valid2, far = kernels.dimer_step(ti, st, valid, **kw)
        N = st.shape[1]
        G = kw["right"].shape[0]
        blk, g = (x.numpy() for x in kernels._state_groups(st, kw["per_block"], kw["inner"], G))

        def per_state(name):
            return jnp.asarray(kw[name].numpy()[g])

        u = tr.u32(st).numpy().astype(np.uint32)
        jout = je._candidate_step_fused(
            ji, per_state("right") > 0, per_state("consume").astype(jnp.int32),
            jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(u[2]),
            jnp.asarray(st[3].numpy()), jnp.asarray(valid.numpy().astype(bool)),
            jnp.asarray(kw["nchA"].numpy()[blk, g]), jnp.asarray(kw["nchB"].numpy()[blk, g]),
            *(per_state(b)[:, None] for b in ("u_mid", "u_end", "l_mid", "l_end")),
            exact=exact, with_mono=with_mono, with_pass=with_pass,
        )
        jflo, jrlo, jsize, jerr, jvalid2, jfar = (np.asarray(x) for x in jout)
        v2 = valid2.numpy().astype(bool)
        np.testing.assert_array_equal(v2, jvalid2)
        np.testing.assert_array_equal(far.numpy().astype(bool), jfar)
        got = tr.u32(out).numpy()
        for r, want in enumerate((jflo, jrlo, jsize)):
            np.testing.assert_array_equal(got[r][v2], want.astype(np.int64)[v2])
        np.testing.assert_array_equal(out[3].numpy()[v2], jerr[v2])
        if R == 5:
            np.testing.assert_array_equal(out[4].numpy()[v2], np.broadcast_to(g[:, None], (N, 16))[v2])
        assert v2.any() and jfar.any() and (~jfar & valid.numpy().astype(bool)).any()


@pytest.mark.parametrize("probe", [False, True], ids=["map", "probe"])
def test_dimer_batch_matches_jax(probe):
    """One (36,2) batch of the block mapper on a dimer tier, with the probe's
    scan cut for the probe program."""
    data = _data(seed=6, n=30_000, nseq=1)
    K, E, O = 36, 2, 24
    J = K - O + 1
    B = 96
    rng = np.random.default_rng(8)
    nk = data.text_len - K + 1
    starts = np.sort(rng.choice(np.arange(0, nk - J, J), B, replace=False)).astype(np.uint32)
    cnt = np.full(B, J, np.int32)
    cut = 12 if probe else None
    tr_ix = tr.DeviceIndex.from_part(data, data.parts[0], light=True, device="cpu")
    text = tr.DeviceText.from_host(data, "cpu")
    ji = jr.DeviceIndex.from_part(data, data.parts[0], light=True)
    jt = jr.DeviceText.from_host(data)
    for tier in (te.Tier(4, 4, 4, exact=False, dimer=True), te.Tier(32, 64, 8, dimer=True)):
        jtier = je.Tier(tier.f_search, tier.f_collect, tier.f_extend,
                        exact=tier.exact, dimer=True)
        jrun = je.make_block_mapper(ji, jt, K=K, errors=E, overlap=O, J=J, B=B,
                                    tier=jtier, cap=65535, rev_compl=True,
                                    probe_only=probe, probe_cut=cut)
        jout = {k: np.asarray(v) for k, v in
                jrun(starts, cnt, np.uint32(data.text_len)).items()}
        run = te.BlockMapper(tr_ix, text, K=K, errors=E, overlap=O, J=J, B=B,
                             tier=tier, cap=65535, rev_compl=True, probe=probe,
                             probe_cut=cut, probe_mass=probe)
        out = run(torch.from_numpy(starts.view(np.int32)), torch.from_numpy(cnt),
                  data.text_len)
        if probe:
            np.testing.assert_array_equal(tr.u32(out["mass_p"]).numpy(),
                                          jout["mass_p"].astype(np.int64))
            np.testing.assert_array_equal(out["overflow"].numpy().astype(bool),
                                          jout["overflow"])
            continue
        ovf = out["overflow"].numpy()
        np.testing.assert_array_equal(ovf, jout["overflow"])
        np.testing.assert_array_equal(out["overflow_cap"].numpy(), jout["overflow_cap"])
        np.testing.assert_array_equal(out["hits"].numpy()[~ovf], jout["hits"][~ovf])
        assert (~ovf).sum() > B // 4
