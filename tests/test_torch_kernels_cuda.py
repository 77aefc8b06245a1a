"""CUDA kernels of genmap_tpu_torch against their plain PyTorch versions.

Every case needs a card and is marked `cuda`; without one it skips.  The
module imports neither jax nor genmap_tpu, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

All arithmetic is integer, so every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank
from genmap_tpu_torch.search.engine import Tier

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _genome(alpha, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    seq = np.concatenate([rng.integers(0, 4, size=n, dtype=np.uint8),
                          np.tile(unit, 6), rng.integers(0, 4, size=n // 2, dtype=np.uint8)])
    if alpha == 5:
        seq[100:140] = 4
        seq[rng.integers(0, len(seq), 30)] = 4
    return [seq, rng.integers(0, 4, size=n // 3, dtype=np.uint8)]


_DATA = {}


def _data(alpha):
    if alpha not in _DATA:
        ff = FastaFile(name="g.fa")
        ff.seqs = _genome(alpha)
        ff.ids = [f"s{i}" for i in range(len(ff.seqs))]
        _DATA[alpha] = build_index([ff], sampling=4)
    return _DATA[alpha]


def _indexes(alpha, cuda):
    data = _data(alpha)
    part = data.parts[0]
    gi = rank.DeviceIndex.from_part(data, part, light=True, device=cuda)
    ci = rank.DeviceIndex.from_part(data, part, light=True, device="cpu")
    return data, gi, ci


def _eq(a, b):
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("alpha", [4, 5])
def test_seed_tables_and_needles(cuda, alpha):
    data, gi, ci = _indexes(alpha, cuda)
    _eq(gi.seed_mlo, ci.seed_mlo)
    _eq(gi.seed_size, ci.seed_size)
    rng = np.random.default_rng(1)
    starts = rng.integers(0, data.text_len, 300).astype(np.uint32).view(np.int32)
    gt = rank.DeviceText.from_host(data, cuda)
    ct = rank.DeviceText.from_host(data, "cpu")
    # 300 blocks: a thread per byte; 36,000: outputs of 512 KiB and more,
    # where rows of 16 or more take 16 bytes per thread
    many = rng.integers(0, data.text_len, 36_000).astype(np.uint32).view(np.int32)
    for B, Ln, limit in ((300, 37, data.text_len), (300, 149, data.text_len - 500),
                         (300, 1, data.text_len), (300, 5, data.text_len),
                         (300, 16, data.text_len - 3), (300, 17, data.text_len),
                         (36_000, 15, data.text_len), (36_000, 16, data.text_len - 3),
                         (36_000, 17, data.text_len), (36_000, 149, data.text_len - 500)):
        s = torch.from_numpy(starts if B == 300 else many)
        _eq(rank.extract_needles(gt, s.to(cuda), Ln, limit),
            rank.extract_needles(ct, s, Ln, limit))


def _states(rng, n_total, N, R, P, wide):
    mlo = rng.integers(0, n_total, N)
    top = 5000 if wide else 600
    size = np.minimum(rng.integers(1, top, N), n_total - mlo)
    st = np.stack([
        mlo, rng.integers(0, n_total, N), size, rng.integers(0, 3, N),
        rng.integers(0, P, N),
    ])[:R].astype(np.int64)
    valid = (rng.random(N) < 0.8).astype(np.uint8)
    return torch.from_numpy(st.astype(np.uint32).view(np.int32)), torch.from_numpy(valid)


def _views_equal(got, ref, args):
    """candidate_step results agree under the kernel's output contract
    (`kernels.candidate_step_view`): valid2 and far in full, out on the
    defined slots, and the compaction of out by valid2."""
    gv = kernels.candidate_step_view(tuple(x.cpu() for x in got), **args)
    rv = kernels.candidate_step_view(ref, **args)
    for a, b in zip(gv, rv):
        _eq(a, b)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("exact", [True, False])
def test_candidate_step(cuda, alpha, exact):
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(2 + alpha)
    B = 64
    for R, per_block, inner, G in ((5, 16, 16, 3), (4, 6 * 4, 4, 6)):
        N = B * per_block
        st, valid = _states(rng, gi.n_total, N, R, G, wide=not exact)
        nch = torch.from_numpy(rng.integers(0, 5, (B, G)).astype(np.uint8))
        right = torch.from_numpy(rng.integers(0, 2, G).astype(np.uint8))
        act = torch.from_numpy((rng.random(G) < 0.7).astype(np.uint8))
        u = torch.from_numpy(rng.integers(0, 4, G).astype(np.int32))
        lreq = torch.from_numpy(rng.integers(0, 2, G).astype(np.int32))
        args = dict(per_block=per_block, inner=inner, exact=exact)
        ref = kernels.candidate_step(ci, st, valid, nch=nch, right=right,
                                     act=act, u=u, lreq=lreq, **args)
        got = kernels.candidate_step(
            gi, st.to(cuda), valid.to(cuda), nch=nch.to(cuda),
            right=right.to(cuda), act=act.to(cuda), u=u.to(cuda),
            lreq=lreq.to(cuda), **args)
        torch.cuda.synchronize()
        _views_equal(got, ref, dict(args, st=st, valid=valid, act=act))
        if not exact:
            assert ref[2].any()  # the far path was exercised


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("nwork", [1, 2, 3, 4, 5, 8, 9, 32])
def test_candidate_step_lane_widths(cuda, alpha, nwork):
    """Exactly `nwork` working states in every tile of 32 consecutive
    states, at random lanes: a warp reads 1-8 of them by 32 / nwork lanes
    each (32, 16, 8, 4) and more by a lane each; exact and fast rank mode."""
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(60 + 2 * alpha + nwork)
    B, per_block, inner, G = 48, 64, 64, 3
    N = B * per_block
    n = int(gi.n_total)
    for exact in (True, False):
        flo, rlo = rng.integers(0, n, N), rng.integers(0, n, N)
        size = np.minimum(rng.integers(1, 600 if exact else 5000, N),
                          n - np.maximum(flo, rlo))
        st = np.stack([flo, rlo, size, rng.integers(0, 3, N), rng.integers(0, G, N)])
        st = torch.from_numpy(st.astype(np.uint32).view(np.int32))
        valid = np.zeros((N // 32, 32), np.uint8)
        lanes = np.argsort(rng.random((N // 32, 32)), axis=1)[:, :nwork]
        np.put_along_axis(valid, lanes, 1, axis=1)
        valid = torch.from_numpy(valid.reshape(-1))
        args = dict(per_block=per_block, inner=inner, exact=exact,
                    nch=torch.from_numpy(rng.integers(0, 5, (B, G)).astype(np.uint8)),
                    right=torch.from_numpy(rng.integers(0, 2, G).astype(np.uint8)),
                    act=torch.ones(G, dtype=torch.uint8),
                    u=torch.from_numpy(rng.integers(0, 4, G).astype(np.int32)),
                    lreq=torch.from_numpy(rng.integers(0, 2, G).astype(np.int32)))
        ref = kernels.candidate_step(ci, st, valid, **args)
        got = kernels.candidate_step(gi, st.to(cuda), valid.to(cuda),
                                     **{k: v.to(cuda) if torch.is_tensor(v) else v
                                        for k, v in args.items()})
        torch.cuda.synchronize()
        _views_equal(got, ref, dict(args, st=st, valid=valid))
        assert ref[1].any()


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("R", [4, 5])
def test_candidate_step_sparse_frontier(cuda, alpha, R):
    """A frontier as compact leaves it (each row's valid states first, most
    warps without one), with passthrough groups; fast rank mode."""
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(40 + 2 * alpha + R)
    n = int(gi.n_total)
    B, per_block, inner, G = (96, 64, 64, 4) if R == 5 else (48, 5 * 32, 32, 5)
    N = B * per_block
    flo, rlo = rng.integers(0, n, N), rng.integers(0, n, N)
    size = np.minimum(rng.integers(1, 3000, N), n - np.maximum(flo, rlo))
    st = np.stack([flo, rlo, size, rng.integers(0, 3, N), rng.integers(0, G, N)])[:R]
    st = torch.from_numpy(st.astype(np.uint32).view(np.int32))
    nv = rng.integers(0, 4, N // inner) * (rng.random(N // inner) < 0.3)
    valid = torch.from_numpy((np.arange(inner)[None, :] < nv[:, None])
                             .reshape(-1).astype(np.uint8))
    args = dict(per_block=per_block, inner=inner, exact=False,
                nch=torch.from_numpy(rng.integers(0, 5, (B, G)).astype(np.uint8)),
                right=torch.from_numpy(rng.integers(0, 2, G).astype(np.uint8)),
                act=torch.from_numpy(np.array([1, 0] + [1] * (G - 2), np.uint8)),
                u=torch.full((G,), 3, dtype=torch.int32),
                lreq=torch.zeros(G, dtype=torch.int32))
    ref = kernels.candidate_step(ci, st, valid, **args)
    got = kernels.candidate_step(gi, st.to(cuda), valid.to(cuda),
                                 **{k: v.to(cuda) if torch.is_tensor(v) else v
                                    for k, v in args.items()})
    torch.cuda.synchronize()
    _views_equal(got, ref, dict(args, st=st, valid=valid))
    assert ref[1].any()


# compact's regimes (kernels.compact_chunks): short rows (M <= 32), middle
# rows (a warp segment per row) and long rows (chunks over blocks, from
# M = 4096); F = 1, below, at and above M; row starts off 16-byte alignment
# (M = 5, 20, 30, 96, 513 ...); one row
_COMPACT_CASES = [
    (5, 300, 16, 4), (4, 300, 16, 1), (4, 100, 40, 8), (5, 50, 256, 64),
    (4, 20, 1000, 300), (4, 30, 7, 16),
    (4, 70, 1, 1), (5, 40, 2, 1), (4, 33, 5, 2), (4, 64, 20, 20), (4, 64, 30, 6),
    (4, 33, 31, 8), (4, 33, 32, 32), (5, 40, 33, 40), (4, 64, 96, 6),
    (4, 50, 511, 64), (4, 50, 512, 512), (4, 50, 513, 1), (4, 1, 1000, 1000),
    (4, 300, 4095, 64), (4, 3, 4096, 1024), (4, 2, 4097, 5000), (4, 1, 4096, 4096),
    (4, 3, 16383, 4096), (4, 2, 16384, 16384), (5, 1, 262144, 16384),
]


def _compact_inputs(seed, R, rows, M):
    """Operands, and validity at four densities (none, sparse, a random
    density per row, all), each also at an odd byte offset so that rows do
    not start 16-byte aligned; valid bytes are nonzero values other than
    1."""
    rng = np.random.default_rng(seed)
    arr = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (R, rows, M)).astype(np.int32))
    for dens in (np.zeros((rows, 1)), np.full((rows, 1), 0.02), rng.random((rows, 1)),
                 np.ones((rows, 1))):
        v = (rng.random((rows, M)) < dens) * rng.integers(1, 256, (rows, M))
        for off in (0, 3):
            buf = torch.zeros(rows * M + off, dtype=torch.uint8)
            valid = buf[off:].view(rows, M)
            valid.copy_(torch.from_numpy(v.astype(np.uint8)))
            yield arr, valid


@pytest.mark.parametrize("R,rows,M,F", _COMPACT_CASES)
def test_compact(cuda, R, rows, M, F):
    for arr, valid in _compact_inputs(rows + M + F, R, rows, M):
        ref = kernels.compact(arr, valid, F)
        buf = torch.zeros(valid.numel() + 3, dtype=torch.uint8, device=cuda)
        off = valid.storage_offset()
        gvalid = buf[off:off + valid.numel()].view(valid.shape)
        gvalid.copy_(valid)
        got = kernels.compact(arr.to(cuda), gvalid, F)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            _eq(a, b)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("rev_compl", [True, False])
@pytest.mark.parametrize("cap", [255, 65535])
def test_count_tail(cuda, alpha, rev_compl, cap):
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(cap + alpha)
    B, J = 40, 7
    for Fe in (1, 2, 3, 4, 6, 31, 32, 33, 64, 512):
        N = B * J * Fe
        st, valid = _states(rng, gi.n_total, N, 4, 1, wide=True)
        cnt = torch.from_numpy(rng.integers(0, J + 1, B).astype(np.int32))
        ref = kernels.count_tail(ci, st, valid, cnt, J, cap, rev_compl)
        got = kernels.count_tail(gi, st.to(cuda), valid.to(cuda), cnt.to(cuda),
                                 J, cap, rev_compl)
        torch.cuda.synchronize()
        _eq(got, ref)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("rev_compl", [True, False])
def test_count_tail_exact(cuda, alpha, rev_compl):
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(7 + alpha + 2 * rev_compl)
    B, J = 40, 7
    for Fe in (1, 2, 3, 4, 6, 31, 32, 33, 64, 512):
        N = B * J * Fe
        st, valid = _states(rng, gi.n_total, N, 4, 1, wide=True)
        cnt = torch.from_numpy(rng.integers(0, J + 1, B).astype(np.int32))
        ref = kernels.count_tail(ci, st, valid, cnt, J, 255, rev_compl, True)
        got = kernels.count_tail(gi, st.to(cuda), valid.to(cuda), cnt.to(cuda),
                                 J, 255, rev_compl, True)
        torch.cuda.synchronize()
        assert len(got) == 4
        for a, b in zip(got, ref):
            _eq(a, b)
        assert ref[1].any() and ref[3].any()


def _probe_inputs(rng, B, F, P, Ln, big, thr_fn):
    st = np.zeros((5, B, F), np.int64)
    st[2] = rng.integers(1, 4, (B, F))
    big = rng.random((B, F)) < big  # sums past 2^32 saturate
    st[2][big] = rng.integers(2**31, 2**32, int(big.sum()))
    st[4] = rng.integers(0, P, (B, F))
    valid = rng.random((B, F)) < rng.random((B, 1)) * 0.3
    ovf = rng.random(B) < 0.1
    needles = rng.integers(0, 4, (B, Ln))
    needles[rng.random((B, Ln)) < 0.002] = 4
    thr = thr_fn(P)
    return [torch.from_numpy(st.astype(np.uint32).view(np.int32)),
            torch.from_numpy(valid.astype(np.uint8)),
            torch.from_numpy(ovf.astype(np.uint8)),
            _unaligned(needles.astype(np.uint8), (B + F + Ln) % 16),
            torch.from_numpy(np.asarray(thr, np.int32))]


def _to(args, cuda):
    """The arguments on the card, the needle rows as far off their 16-byte
    alignment as on the CPU."""
    out = [a.to(cuda) for a in args]
    out[3] = _unaligned(args[3].numpy(), args[3].data_ptr() % 16, cuda)
    return out


def _unaligned(a, off, device="cpu"):
    """A contiguous copy of uint8 array `a` whose data starts `off` bytes
    past a 16-byte boundary."""
    buf = torch.zeros(a.size + 32, dtype=torch.uint8, device=device)
    base = (16 - buf.data_ptr() % 16) % 16
    view = buf[base + off : base + off + a.size].view(a.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return view


# (B, F, P, Ln): F of one lane a block, under a warp, over a warp and
# 4,096 slots; P of 1 to the kernel's 16 plans
_PROBE_SHAPES = ((200, 4, 3, 148), (64, 40, 7, 37), (33, 300, 2, 90), (50, 1, 1, 9),
                 (70, 7, 3, 30), (40, 31, 16, 148), (30, 33, 7, 5), (3, 4096, 3, 148))


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("with_mass", [True, False])
@pytest.mark.parametrize("thr_kind", ["0/1", "large"])
def test_probe_mass(cuda, alpha, with_mass, thr_kind):
    """Thresholds of 0 and 1 take the decision-only combine (with_mass
    the exact one); thresholds of 7 and up the exact 64-bit combine."""
    rng = np.random.default_rng(11 + alpha + 31 * (thr_kind == "large"))
    skips, blocks = 0, 0
    for B, F, P, Ln in _PROBE_SHAPES:
        args = _probe_inputs(rng, B, F, P, Ln, 0.05,
                             lambda P: rng.integers(0, 2, P) if thr_kind == "0/1"
                             else rng.choice([1, 7, 8, 2**31 - 1], P))
        ref = kernels.probe_mass(*args, alpha == 5, with_mass)
        got = kernels.probe_mass(*_to(args, cuda), alpha == 5, with_mass)
        torch.cuda.synchronize()
        ref = ref if with_mass else (ref,)
        got = got if with_mass else (got,)
        for a, b in zip(got, ref):
            _eq(a, b)
        skips += int(ref[0].sum())
        blocks += B
        if (B, F, P, Ln) in _PROBE_SHAPES[:3] and thr_kind == "0/1":
            assert ref[0].any() and not ref[0].all()
    assert 0 < skips < blocks


def test_probe_mass_lane_masses_carry(cuda):
    """Sizes that would carry a packed byte or wrap 32 bits if a lane's
    mass were not capped: 8 and 256 per slot, 2^32 - 1, on 0/1 thresholds."""
    rng = np.random.default_rng(77)
    for B, F, P, Ln in _PROBE_SHAPES:
        args = _probe_inputs(rng, B, F, P, Ln, 0.0, lambda P: rng.integers(0, 2, P))
        sizes = rng.choice([0, 1, 8, 256, 2**32 - 256, 2**32 - 1], (B, F))
        sizes[rng.random((B, F)) < 0.7] = 0
        args[0][2] = torch.from_numpy(sizes.astype(np.uint32).view(np.int32))
        args[1] = torch.from_numpy((rng.random((B, F)) < 0.5).astype(np.uint8))
        ref = kernels.probe_mass(*args, False)
        got = kernels.probe_mass(*_to(args, cuda), False)
        torch.cuda.synchronize()
        _eq(got, ref)


@pytest.mark.parametrize("with_mass", [True, False])
def test_probe_mass_reduced(cuda, with_mass):
    """The part mesh's decision on accumulators summed over devices: masses
    past 2^32 saturate, a non-zero flag column blocks the skip."""
    rng = np.random.default_rng(41)
    for B, P in ((500, 3), (33, 7), (1, 1)):
        acc = rng.integers(0, 3, (B, P + 1))
        acc[:, P] = rng.random(B) < 0.1
        big = rng.random((B, P)) < 0.05
        acc[:, :P][big] = rng.integers(2**32 - 2, 2**34, int(big.sum()))
        thr = rng.integers(0, 2, P).astype(np.int32)
        args = (torch.from_numpy(acc.astype(np.int64)), torch.from_numpy(thr))
        ref = kernels.probe_mass(None, None, None, None, args[1], False, with_mass,
                                 acc=args[0])
        got = kernels.probe_mass(None, None, None, None, args[1].to(cuda), False,
                                 with_mass, acc=args[0].to(cuda))
        torch.cuda.synchronize()
        ref = ref if with_mass else (ref,)
        got = got if with_mass else (got,)
        for a, b in zip(got, ref):
            _eq(a, b)


_SAMPLED = {}


def _sampled(alpha, sampling):
    """The test genome's index at another SA sampling rate, cut so that its
    last rank sub-row (whose pair is padding) is 416 of 512 rows full."""
    if (alpha, sampling) not in _SAMPLED:
        ff = FastaFile(name="g.fa")
        seqs = _genome(alpha)
        ff.seqs = seqs[:-1] + [seqs[-1][:-50]]
        ff.ids = [f"s{i}" for i in range(len(ff.seqs))]
        _SAMPLED[alpha, sampling] = build_index([ff], sampling=sampling)
    return _SAMPLED[alpha, sampling]


def _locate_rows(n, seed):
    """(label, rows, valid) sets: every row (a fifth invalid); runs of
    consecutive rows, as -d draws them; scattered rows at N = 1, 31, 33
    (around a warp) and 4,097; every row invalid; the rows of the last
    sub-row."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n - 8, 700)
    runs = np.concatenate([np.arange(s, s + rng.integers(1, 9)) for s in starts])
    sets = [("every row", np.arange(n), np.arange(n) % 5 != 0),
            ("clustered", runs, np.ones(len(runs), bool))]
    for N in (1, 31, 33, 4097):
        sets.append((f"scattered N={N}", rng.integers(0, n, N), rng.random(N) < 0.9))
    sets.append(("every row invalid", rng.integers(0, n, 500), np.zeros(500, bool)))
    last = np.arange(n // 512 * 512, n)
    sets.append(("the last sub-row", last, np.ones(len(last), bool)))
    return sets


def _row_layouts(fb):
    """The rank rows as stored, 8 bytes off 16-byte alignment (8-byte
    vectors), and padded to a width that is a multiple of 4 (16-byte
    vectors): each alphabet reaches both of the kernel's vector widths."""
    buf = torch.zeros(fb.numel() + 8, dtype=torch.int32, device=fb.device)
    skew = ((16 - buf.data_ptr() % 16) % 16) // 4 + 2
    off8 = buf[skew:skew + fb.numel()].view(fb.shape)
    off8.copy_(fb)
    w = fb.shape[1] + (-fb.shape[1]) % 4 + (4 if fb.shape[1] % 4 == 0 else 0)
    pad = torch.zeros((fb.shape[0], w), dtype=torch.int32, device=fb.device)
    pad[:, :fb.shape[1]] = fb
    return [("stored", fb), ("8 B off", off8), (f"padded to {w}", pad)]


@pytest.mark.parametrize("sampling", [1, 10, 32])
@pytest.mark.parametrize("alpha", [4, 5])
def test_locate(cuda, alpha, sampling):
    data = _sampled(alpha, sampling)
    part = data.parts[0]
    gi = rank.DeviceIndex.from_part(data, part, light=False, device=cuda)
    ci = rank.DeviceIndex.from_part(data, part, light=False, device="cpu")
    assert part.n_total % 512 > 400  # the last sub-row's second half is walked
    for label, rows, ok in _locate_rows(part.n_total, 10 * alpha + sampling):
        pos = torch.from_numpy(rows.astype(np.uint32).view(np.int32))
        valid = torch.from_numpy(ok.astype(np.uint8))
        ref = kernels.locate(ci, pos, valid)
        for layout, fb in _row_layouts(gi.fwd_blocks):
            index = dataclasses.replace(gi, fwd_blocks=fb)
            got = kernels.locate(index, pos.to(cuda), valid.to(cuda))
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                assert torch.equal(a.cpu(), b), (label, layout)


@pytest.mark.parametrize("alpha", [4, 5])
def test_engine_cuda_equals_cpu(cuda, alpha):
    data = _data(alpha)
    tiers = (Tier(4, 4, 1, exact=False), Tier(4, 4, 1), Tier(32, 64, 8),
             Tier(256, 512, 64))
    ge = MappabilityEngine(data, batch_blocks=64, tiers=tiers, device=cuda)
    ce = MappabilityEngine(data, batch_blocks=64, tiers=tiers, device="cpu")
    steps = 0
    for K, e, o, rc in ((12, 0, 8, True), (16, 1, 10, False), (20, 2, 12, True)):
        params = SearchParams(length=K, overlap=o, rev_compl=rc)
        lay = ge.layouts[0]
        kernels.reset_launches()
        g = ge.compute_file(lay, params, e, 255)
        counts = kernels.launch_counts()
        c = ce.compute_file(ce.layouts[0], params, e, 255)
        np.testing.assert_array_equal(g.c, c.c, err_msg=f"K={K} e={e}")
        # this genome is below the probe's gate and runs no CSV: the
        # kernels of the plain map path (the extension's levels fused; at
        # e = 0 the seed tables may leave the infix no step)
        assert all(counts[n] > 0 for n in ("extract_needles", "compact", "count_tail",
                                           "extend_level")), counts
        steps += counts["candidate_step"]
    assert steps > 0
    # CSV locations and exclude-pseudo go through the locate kernel
    params = SearchParams(length=16, overlap=10, rev_compl=True, exclude_pseudo=True)
    kernels.reset_launches()
    g = ge.compute_file(ge.layouts[0], params, 1, 255, csv=True)
    assert kernels.launch_counts()["locate"] > 0
    c = ce.compute_file(ce.layouts[0], params, 1, 255, csv=True)
    np.testing.assert_array_equal(g.c, c.c)
    assert g.locations and sorted(g.locations) == sorted(c.locations)
    for key, ((f1, f2), (r1, r2)) in g.locations.items():
        for a, b in zip((f1, f2, r1, r2), (x for pair in c.locations[key] for x in pair)):
            np.testing.assert_array_equal(a, b)


def _dimer_intervals(rng, n, N):
    """(lo, size) of N states: intervals anywhere, at the 128-symbol sub-row
    edges and around the fast window (0, 1 or 2 sub-rows past the start),
    and wide ones."""
    lo = np.concatenate([rng.integers(0, n + 1, N // 2),
                         128 * rng.integers(0, n // 128, N // 2)
                         + rng.choice([0, 1, 15, 16, 126, 127], N // 2)])
    lo = np.minimum(lo, n)
    kind = rng.integers(0, 4, N)
    edge = 128 * rng.integers(0, 3, N) + rng.integers(-2, 3, N)
    size = np.select([kind == 0, kind == 1, kind == 2],
                     [rng.integers(0, 20, N), np.maximum(0, 128 - lo % 128 + edge),
                      rng.integers(0, 600, N)], rng.integers(0, n + 1, N))
    return lo, np.minimum(size, n - lo)


def _dimer_inputs(rng, n, R, exact, with_mono, with_pass):
    """dimer_step inputs: `_dimer_intervals`; every consume kind the variant
    allows; needles with N."""
    G, nblk, N = 4, 16, 2048
    lo, size = _dimer_intervals(rng, n, N)
    other = (rng.random(N) * (n - size + 1)).astype(np.int64)
    side = rng.integers(0, 2, N).astype(bool)
    st = np.stack([np.where(side, lo, other), np.where(side, other, lo), size,
                   rng.integers(0, 3, N), rng.integers(0, G, N)])[:R]
    allowed = [2] + ([1] if with_mono else []) + ([0] if with_pass else [])

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dt))

    u_mid = rng.integers(0, 3, G)
    l_mid = rng.integers(0, 2, G)
    kw = dict(per_block=N // nblk, inner=N // nblk // G,
              consume=t([allowed[g % len(allowed)] for g in range(G)], np.uint8),
              right=t([0, 1, 1, 0], np.uint8), u_mid=t(u_mid, np.int32),
              u_end=t(u_mid + rng.integers(0, 2, G), np.int32), l_mid=t(l_mid, np.int32),
              l_end=t(l_mid + rng.integers(0, 2, G), np.int32),
              nchA=t(rng.integers(0, 5, (nblk, G)), np.uint8),
              nchB=t(rng.integers(0, 5, (nblk, G)), np.uint8),
              exact=exact, with_mono=with_mono, with_pass=with_pass)
    return (t(st.astype(np.uint32).view(np.int32), np.int32),
            t(rng.random(N) < 0.9, np.uint8), kw)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("with_mono", [True, False])
@pytest.mark.parametrize("with_pass", [True, False])
def test_dimer_step(cuda, alpha, exact, with_mono, with_pass):
    data, gi, ci = _indexes(alpha, cuda)
    assert gi.has_dimer and data.parts[0].dimer_flag_frac > 0  # flagged rows exist
    rng = np.random.default_rng(20 + alpha + 2 * exact + 4 * with_mono + 8 * with_pass)
    for R in (5, 4):
        st, valid, kw = _dimer_inputs(rng, gi.n_total, R, exact, with_mono, with_pass)
        ref = kernels.dimer_step(ci, st, valid, **kw)
        got = kernels.dimer_step(gi, st.to(cuda), valid.to(cuda),
                                 **{k: v.to(cuda) if torch.is_tensor(v) else v
                                    for k, v in kw.items()})
        torch.cuda.synchronize()
        _dimer_views_equal(got, ref, dict(kw, index=ci, st=st, valid=valid))
        assert ref[1].any() and ref[2].any()  # valid candidates and far states


def _dimer_views_equal(got, ref, args):
    """dimer_step results agree under the kernel's output contract
    (`kernels.dimer_step_view`): valid2 and far in full, out on the defined
    slots, and the compaction of out by valid2."""
    gv = kernels.dimer_step_view(tuple(x.cpu() for x in got), **args)
    rv = kernels.dimer_step_view(ref, **args)
    for a, b in zip(gv, rv):
        _eq(a, b)


# working states (valid and consuming) per tile of 32 consecutive states:
# a warp reads up to 8 of them with the sixteen codes of each across its
# lanes and more with a lane each
_DIMER_LANE_CASES = ["0", "1", "2", "8", "9", "32", "all_valid", "none_valid",
                     "only_pass", "sparse"]


def _dimer_lane_inputs(rng, n, R, exact, case):
    """dimer_step inputs whose tiles hold a set number of working states.
    Groups consume 2, 1, 2, 0 (mono and passthrough slots on); R = 5 draws
    each state's plan id by its role (a warp mixes dimer, mono and
    passthrough states), R = 4 has one group per tile (inner = 32)."""
    G, nblk, per_block = 4, 16, 128
    N = nblk * per_block
    tiles = N // 32
    lo, size = _dimer_intervals(rng, n, N)
    other = (rng.random(N) * (n - size + 1)).astype(np.int64)
    side = rng.integers(0, 2, N).astype(bool)
    consume = np.array([0] * G if case == "only_pass" else [2, 1, 2, 0])
    consuming = np.nonzero(consume > 0)[0]
    if R == 5:
        grp = rng.integers(0, G, N)
    else:
        grp = (np.arange(N) % per_block) // 32
    if case in ("all_valid", "only_pass"):
        valid = np.ones(N, bool)
    elif case == "none_valid":
        valid = np.zeros(N, bool)
    else:
        k = int(case) if case != "sparse" else 3
        valid = np.zeros((tiles, 32), bool)
        lanes = np.argsort(rng.random((tiles, 32)), axis=1)[:, :k]
        np.put_along_axis(valid, lanes, True, axis=1)
        if case == "sparse":  # a frontier with states in every 7th tile only
            valid[np.arange(tiles) % 7 != 3] = False
        valid = valid.reshape(-1)
        if R == 5:  # working lanes consume; some other lanes pass through
            grp = np.where(valid, consuming[rng.integers(0, len(consuming), N)], 3)
            extra = ~valid & (rng.random(N) < 0.2)
            valid |= extra
    st = np.stack([np.where(side, lo, other), np.where(side, other, lo), size,
                   rng.integers(0, 3, N), grp])[:R]

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dt))

    u_mid = rng.integers(1, 3, G)
    kw = dict(per_block=per_block, inner=per_block if R == 5 else 32,
              consume=t(consume, np.uint8), right=t([0, 1, 1, 0], np.uint8),
              u_mid=t(u_mid, np.int32), u_end=t(u_mid + 1, np.int32),
              l_mid=t(np.zeros(G), np.int32), l_end=t(rng.integers(0, 2, G), np.int32),
              nchA=t(rng.integers(0, 5, (nblk, G)), np.uint8),
              nchB=t(rng.integers(0, 5, (nblk, G)), np.uint8),
              exact=exact, with_mono=True, with_pass=True)
    return t(st.astype(np.uint32).view(np.int32), np.int32), t(valid, np.uint8), kw


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("case", _DIMER_LANE_CASES)
def test_dimer_step_lane_paths(cuda, alpha, case):
    """Every lane path of dimer_step: tiles with exactly 0, 1, 2, 8, 9 and
    32 working states (a warp per state, two states per warp, a lane per
    state), every state valid, none, only passthroughs, and a sparse
    frontier; R = 5 and 4, exact and fast rank mode."""
    data, gi, ci = _indexes(alpha, cuda)
    rng = np.random.default_rng(80 + alpha + 2 * _DIMER_LANE_CASES.index(case))
    for exact in (True, False):
        for R in (5, 4):
            st, valid, kw = _dimer_lane_inputs(rng, gi.n_total, R, exact, case)
            ref = kernels.dimer_step(ci, st, valid, **kw)
            got = kernels.dimer_step(gi, st.to(cuda), valid.to(cuda),
                                     **{k: v.to(cuda) if torch.is_tensor(v) else v
                                        for k, v in kw.items()})
            torch.cuda.synchronize()
            _dimer_views_equal(got, ref, dict(kw, index=ci, st=st, valid=valid))
            if case not in ("0", "none_valid", "only_pass"):
                assert ref[1].any()  # valid candidates


@pytest.mark.parametrize("Ln", [1, 3, 5, 29, 37, 148])
def test_probe_mass_n_window_edges(cuda, Ln):
    """N only in a row's first or last byte, beside rows without one, at
    every offset of the rows from a 16-byte boundary: a word that holds
    bytes of two rows must count only its own row's."""
    rng = np.random.default_rng(90 + Ln)
    B, F, P = 64, 4, 3
    for off in range(16):
        args = _probe_inputs(rng, B, F, P, Ln, 0.0, lambda P: np.full(P, 2**31 - 1))
        needles = np.zeros((B, Ln), np.uint8)
        kind = rng.integers(0, 3, B)
        needles[kind == 1, 0] = 4
        needles[kind == 2, Ln - 1] = 4
        args[3] = _unaligned(needles, off)
        ref = kernels.probe_mass(*args, True, True)
        got = kernels.probe_mass(*_to(args, cuda), True, True)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            _eq(a, b)
        _eq(ref[2], torch.from_numpy((kind != 0).astype(np.uint8)))


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("B,F,P,Ln", [(300, 12, 3, 90), (40, 1, 1, 9), (60, 33, 7, 37),
                                      (20, 31, 16, 148), (3, 4096, 3, 148)])
def test_probe_mass_accumulates_over_parts(cuda, alpha, B, F, P, Ln):
    """Three parts' launches: two adding into the running sum, the third
    deciding (and reporting the summed mass)."""
    rng = np.random.default_rng(31 + alpha)
    needles = rng.integers(0, 4, (B, Ln))
    needles[rng.random((B, Ln)) < 0.002] = 4
    needles = torch.from_numpy(needles.astype(np.uint8))
    thr = torch.from_numpy(rng.integers(0, 2, P).astype(np.int32))
    acc = {"cpu": None, "cuda": None}
    for last in (False, False, True):
        st = np.zeros((5, B, F), np.int64)
        st[2] = rng.integers(1, 3, (B, F))
        big = rng.random((B, F)) < 0.02
        st[2][big] = rng.integers(2**31, 2**32, int(big.sum()))
        st[4] = rng.integers(0, P, (B, F))
        valid = rng.random((B, F)) < rng.random((B, 1)) * 0.2
        args = [torch.from_numpy(st.astype(np.uint32).view(np.int32)),
                torch.from_numpy(valid.astype(np.uint8)),
                torch.from_numpy((rng.random(B) < 0.05).astype(np.uint8)), needles, thr]
        ref = kernels.probe_mass(*args, alpha == 5, last, acc=acc["cpu"], last=last)
        got = kernels.probe_mass(*(a.to(cuda) for a in args), alpha == 5, last,
                                 acc=acc["cuda"], last=last)
        torch.cuda.synchronize()
        for a, b in zip(got if last else (got,), ref if last else (ref,)):
            _eq(a, b)
        acc = {"cpu": ref, "cuda": got}
    if (B, F, P, Ln) == (300, 12, 3, 90):
        assert ref[0].any() and not ref[0].all()


def test_engine_multipart_dimer_cuda_equals_cpu(cuda):
    """A three-part index, every tier twinned onto the dimer rows."""
    seq = _genome(4, n=9000, seed=3)[0]
    ff = FastaFile(name="g.fa")
    ff.seqs = [seq[:5000], seq[5000:10_000], seq[10_000:15_000]]
    ff.ids = ["a", "b", "c"]
    data = build_index([ff], sampling=4, max_part_symbols=12_000)
    assert len(data.parts) == 3
    ge = MappabilityEngine(data, batch_blocks=64, device=cuda, dimer_tier=True)
    ce = MappabilityEngine(data, batch_blocks=64, device="cpu", dimer_tier=True)
    for K, e, o in ((20, 1, 12), (30, 2, 20)):
        params = SearchParams(length=K, overlap=o)
        kernels.reset_launches()
        g = ge.compute_file(ge.layouts[0], params, e, 255)
        assert kernels.launch_counts()["dimer_step"] > 0
        c = ce.compute_file(ce.layouts[0], params, e, 255)
        np.testing.assert_array_equal(g.c, c.c, err_msg=f"K={K} e={e}")
        assert ge.stats["dimer_tier"] and ge.stats["tier_blocks"] == ce.stats["tier_blocks"]


@pytest.mark.parametrize("R,rows,M,F", [
    (5, 300, 16, 4), (4, 300, 16, 1), (5, 50, 256, 64), (4, 20, 1000, 300),
] + _COMPACT_CASES[6:])
def test_compact_count(cuda, R, rows, M, F):
    """The valid count before the cut (the occupancy and survivor counts)."""
    for arr, valid in _compact_inputs(7 * rows + M + F, R, rows, M):
        ref = kernels.compact(arr, valid, F, count=True)
        buf = torch.zeros(valid.numel() + 3, dtype=torch.uint8, device=cuda)
        off = valid.storage_offset()
        gvalid = buf[off:off + valid.numel()].view(valid.shape)
        gvalid.copy_(valid)
        got = kernels.compact(arr.to(cuda), gvalid, F, count=True)
        torch.cuda.synchronize()
        assert len(got) == 4
        for a, b in zip(got, ref):
            _eq(a, b)
        _eq(ref[3], (valid != 0).sum(-1).to(torch.int32))


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7])
def test_seed_lookup(cuda, alpha, P):
    """Every t_seed up to the tables' depth, padding up to 256 slots, 8,192
    blocks, rows shorter than 8 and of 1,100 bytes, needles off their word
    alignment, N windows (all-N rows too) and empty intervals (the deepest
    levels of a small index)."""
    data, gi, ci = _indexes(alpha, cuda)
    assert gi.has_seed
    rng = np.random.default_rng(50 + alpha + 10 * P)
    for t_seed in range(ci.seed_t0 + 1):
        for B, Ln, Fp in ((500, 60, P), (8192, 148, max(P, 4)), (300, max(t_seed, 1) + 2, 16),
                          (40, 1100, 256), (1, 29, P + 1)):
            needles = rng.integers(0, 4, (B, Ln))
            needles[rng.random((B, Ln)) < 0.01] = 4
            needles[rng.random(B) < 0.05] = 4
            off = int(rng.integers(0, 16))
            cpu_needles = _unaligned(needles.astype(np.uint8), off)
            a_pos = torch.from_numpy(rng.integers(0, Ln - t_seed + 1, P).astype(np.int32))
            ref = kernels.seed_lookup(ci, cpu_needles, a_pos, t_seed, Fp, ci.n_total)
            got = kernels.seed_lookup(gi, _unaligned(needles.astype(np.uint8), off, cuda),
                                      a_pos.to(cuda), t_seed, Fp, gi.n_total)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                _eq(a, b)
            if t_seed == 0:
                assert ref[1][:, :P].all()
            if (B, Ln) == (500, 60):  # the original shape looks windows up
                assert ref[1][:, :P].any()
    # the deepest level of this small index holds empty intervals
    assert not bool((ci.seed_size[rank.seed_level_offset(ci.seed_t0):] != 0).all())


@pytest.mark.parametrize("Fc,Fe", [(64, 16), (16, 64), (32, 32), (4, 4), (4, 8),
                                   (256, 128), (128, 256), (256, 256), (6, 8), (8, 6)])
def test_gather_states(cuda, Fc, Fe):
    """16-byte vectors from Fc = 4 (exactly one) up; Fc above, below and
    equal to Fe; widths that are not a multiple of 4 (one slot per lane);
    n = 0, npad = 1, repeated row ids, source rows of 8,192; validity bytes
    other than 0 and 1; inputs off their 16-byte alignment."""
    rng = np.random.default_rng(Fc + 3 * Fe)
    for B in (200, 8192):
        st = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (4, B, Fc)).astype(np.int32))
        valid = torch.from_numpy(rng.integers(0, 3, (B, Fc)).astype(np.uint8))
        for n, npad in ((37, 64), (64, 64), (1, 2), (0, 8), (1, 1), (26, 32)):
            ridx = np.zeros(npad, np.int32)
            ridx[:n] = rng.integers(0, B, n)
            if n > 2:
                ridx[1] = ridx[0]
            ridx = torch.from_numpy(ridx)
            ref = kernels.gather_states(st, valid, ridx, n, Fe)
            for skew in (0, 1):  # skew 1: 4 bytes (st) and 1 byte (valid) off
                gst = torch.zeros(4 * B * Fc + 4, dtype=torch.int32, device=cuda)
                gst = gst[skew:skew + 4 * B * Fc].view(4, B, Fc)
                gst.copy_(st)
                gv = torch.zeros(B * Fc + 4, dtype=torch.uint8, device=cuda)
                gv = gv[skew:skew + B * Fc].view(B, Fc)
                gv.copy_(valid)
                got = kernels.gather_states(gst, gv, ridx.to(cuda), n, Fe)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    _eq(a, b)


def test_engine_split_cuda_equals_cpu(cuda):
    """Calibration and the split pipeline (J >= 16, one part), with the
    dimer mode ladder forced: frequencies, blocks per tier, calibrated pools
    and extension schedules equal the CPU's."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 150, dtype=np.uint8)
    copies = []
    for _ in range(200):
        u = unit.copy()
        m = rng.random(150) < 0.02
        u[m] = rng.integers(0, 4, int(m.sum()))
        copies.append(u)
    seq = np.concatenate([rng.integers(0, 4, 6000, dtype=np.uint8)] + copies
                         + [rng.integers(0, 4, 3000, dtype=np.uint8)])
    seq[rng.integers(0, len(seq) - 30, 6)[:, None] + np.arange(20)] = 4
    ff = FastaFile(name="g.fa")
    ff.seqs, ff.ids = [seq], ["s0"]
    data = build_index([ff], sampling=4)
    for dimer in (None, True):
        engs = []
        for dev in (cuda, "cpu"):
            eng = MappabilityEngine(data, batch_blocks=1024, device=dev, dimer_tier=dimer)
            eng._cal_batch = 96
            eng._record_tier_sel = True
            engs.append(eng)
        ge, ce = engs
        for K, e, o in ((30, 1, 15), (40, 2, 20)):
            params = SearchParams(length=K, overlap=o)
            kernels.reset_launches()
            g = ge.compute_file(ge.layouts[0], params, e, 65535)
            counts = kernels.launch_counts()
            c = ce.compute_file(ce.layouts[0], params, e, 65535)
            np.testing.assert_array_equal(g.c, c.c, err_msg=f"K={K} e={e} dimer={dimer}")
            assert counts["gather_states"] > 0 and counts["seed_lookup"] > 0, counts
            assert ge.stats["tier_blocks"] == ce.stats["tier_blocks"]
            assert ({k: sum(map(len, v)) for k, v in ge.stats["rung_sel"].items()}
                    == {k: sum(map(len, v)) for k, v in ce.stats["rung_sel"].items()})
        assert ge._tuned_pools == ce._tuned_pools and ge._tuned_pools
        assert ge._ext_sched == ce._ext_sched


@pytest.mark.parametrize("W", [16, 52, 69, 128, 138])
@pytest.mark.parametrize("lanes", kernels.ROW_GATHER_LANES)
def test_row_gather(cuda, lanes, W):
    """Both entries, every lanes variant, 16 B vector rows (W % 4 == 0) and
    word rows, row sums wrapping negative, a DMA id count with a tail that
    is dropped and one below a chunk, a capped grid, an unaligned table."""
    from genmap_tpu_torch.experiments.row_gather import harness_inputs, negative_wrap_table

    NR = 997
    rng = np.random.default_rng(W)
    for table in (harness_inputs(NR, W, 0, 0)[0], negative_wrap_table(NR, W, seed=W)):
        t = torch.from_numpy(table)
        tc = t.to(cuda)
        shifted = torch.cat([tc.new_zeros(1), tc.flatten()])[1:].view(NR, W)
        for ND in (4096, 4000, 100):
            idx = torch.from_numpy(rng.integers(0, NR, ND).astype(np.int32))
            want = kernels.row_gather_sum_plain(t, idx)
            for tt in (tc, shifted):
                for blocks in (0, 3):
                    got = kernels.row_gather_sum(tt, idx.to(cuda), lanes=lanes, blocks=blocks)
                    torch.cuda.synchronize()
                    assert got.dtype == torch.int32 and got.dim() == 0
                    _eq(got, want)
        idx = torch.from_numpy(rng.integers(0, NR, 5000).astype(np.int32))
        want = kernels.row_gather_chain_plain(t, idx, steps=8)
        for tt in (tc, shifted):
            for blocks in (0, 3):
                got = kernels.row_gather_chain(tt, idx.to(cuda), steps=8, lanes=lanes,
                                               blocks=blocks)
                torch.cuda.synchronize()
                _eq(got, want)


def test_row_gather_entry_point_quick(cuda):
    """The entry point at its CPU sizes on the card: every call it makes is
    held against the plain version inside it; row_gather launches."""
    from genmap_tpu_torch.experiments import row_gather as rg

    kernels.reset_launches()
    res = rg.run(cuda, quick=True, say=lambda _line: None)
    assert kernels.launch_counts()["row_gather"] > 0
    assert set(res["harness"]) == {"sum", "chain"} and res["sweep"]


@pytest.mark.parametrize("W", [4, 52, 104, 128, 256, 1024])
def test_row_gather_bulk_shapes(cuda, W):
    """lanes 0 (the bulk copies) where rows are whole 16-byte units: a
    partial last stage (chunk 1, odd ND), fewer ids than a stage, grids of
    1 and 3 blocks; rows of 1,024 and 4,096 B (the sum's stages hold 16 and
    4 of them; the chain's 256 slots do not fit there, and it takes the
    word kernel), a table off 16-byte alignment (the word kernel).  The
    bulk entries refuse the tables that `row_gather_bulk` rules out."""
    from genmap_tpu_torch.experiments.row_gather import negative_wrap_table

    NR = 601
    rng = np.random.default_rng(W + 1)
    t = torch.from_numpy(negative_wrap_table(NR, W, seed=W + 1))
    tc = t.to(cuda)
    shifted = torch.cat([tc.new_zeros(1), tc.flatten()])[1:].view(NR, W)
    assert kernels.row_gather_bulk(tc, "sum") and not kernels.row_gather_bulk(shifted, "sum")
    assert kernels.row_gather_bulk(tc, "chain") == (W <= 128)
    assert not kernels.row_gather_bulk(shifted, "chain")
    out = torch.zeros((), dtype=torch.int32, device=cuda)
    ids = torch.zeros(128, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="_sum_bulk"):
        kernels.ROW_GATHER.launch(shifted.data_ptr(), NR, W, ids.data_ptr(), 128, 0,
                                  out.data_ptr(), None, entry="_sum_bulk")
    with pytest.raises(RuntimeError, match="_chain_bulk"):
        kernels.ROW_GATHER.launch(shifted.data_ptr(), NR, W, ids.data_ptr(), 128, 8, 0,
                                  out.data_ptr(), None, entry="_chain_bulk")
    for ND, chunk in ((4007, 1), (31, 1), (4096, 128), (33, 1)):
        idx = torch.from_numpy(rng.integers(0, NR, ND).astype(np.int32))
        want = kernels.row_gather_sum_plain(t, idx, chunk)
        for tt in (tc, shifted):
            for blocks in (0, 1, 3):
                got = kernels.row_gather_sum(tt, idx.to(cuda), chunk, lanes=0, blocks=blocks)
                torch.cuda.synchronize()
                _eq(got, want)
    for n in (5000, 7):
        idx = torch.from_numpy(rng.integers(0, NR, n).astype(np.int32))
        want = kernels.row_gather_chain_plain(t, idx, steps=8)
        for tt in (tc, shifted):
            for blocks in (0, 1):
                got = kernels.row_gather_chain(tt, idx.to(cuda), steps=8, lanes=0,
                                               blocks=blocks)
                torch.cuda.synchronize()
                _eq(got, want)


@pytest.mark.parametrize("alpha", [4, 5])
def test_seed_build(cuda, alpha):
    """seed_build on the card against seed_build_plain (on the card and on
    the CPU) at every t0 from 0 to one past the index's depth: tables
    byte-equal; the build launches seed_build only (no candidate_step),
    once for the shallow levels and once per deeper level; with_seed_tables
    attaches the same tables at a t0 override (a part mesh's shared
    depth)."""
    _data_, gi, ci = _indexes(alpha, cuda)
    depth = rank.seed_depth(gi.n_total)
    assert kernels.seed_build_depth() < depth + 1  # a level launch runs below
    for t0 in range(depth + 2):
        kernels.reset_launches()
        got = kernels.seed_build(gi, t0)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        want = 1 + max(0, t0 - kernels.seed_build_depth())  # shallow, then a level each
        assert counts == {"seed_build": want}, (t0, counts)
        for g, w, wc in zip(got, kernels.seed_build_plain(gi, t0),
                            kernels.seed_build_plain(ci, t0)):
            assert g.is_cuda and g.dtype == torch.int32
            _eq(g, w)
            _eq(g, wc)
    kernels.reset_launches()
    over = rank.with_seed_tables(gi, depth - 2)
    torch.cuda.synchronize()
    assert over.seed_t0 == depth - 2 and kernels.launch_counts()["candidate_step"] == 0
    ref = rank.with_seed_tables(ci, depth - 2)
    _eq(over.seed_mlo, ref.seed_mlo)
    _eq(over.seed_size, ref.seed_size)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("n", [40, 255, 256, 511])
def test_seed_build_small_parts(cuda, alpha, n):
    """Parts of 82, 512, 514 and 1,024 symbols (hi = n_total at a sub-row's
    start or in the last sub-row; intervals that empty out before t0), to
    t0 = 10 (level launches past the shallow one)."""
    rng = np.random.default_rng(n + alpha)
    seq = rng.integers(0, 4, size=n, dtype=np.uint8)
    if alpha == 5:
        seq[rng.integers(0, n, max(1, n // 50))] = 4
    ff = FastaFile(name="g.fa")
    ff.seqs, ff.ids = [seq], ["s"]
    data = build_index([ff], sampling=4)
    part = data.parts[0]
    gi = rank.DeviceIndex.from_part(data, part, light=True, device=cuda, seed_t0=0)
    ci = rank.DeviceIndex.from_part(data, part, light=True, device="cpu", seed_t0=0)
    for t0 in [*range(rank.seed_depth(gi.n_total) + 3), 9, 10]:  # 9, 10: level launches
        got = kernels.seed_build(gi, t0)
        torch.cuda.synchronize()
        for g, w in zip(got, kernels.seed_build_plain(ci if t0 < 8 else gi, t0)):
            _eq(g, w)


# ---------------------------------------------------------------------------
# extend_level: runs of doubling-tree levels in one launch, against the host loop
# ---------------------------------------------------------------------------


def _repeat_genome(seed=4, n=5000, copies=12, unit_len=240):
    """Random flanks around `copies` 2 %-mutated copies of one unit."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, unit_len, dtype=np.uint8)
    reps = []
    for _ in range(copies):
        u = unit.copy()
        m = rng.random(unit_len) < 0.02
        u[m] = rng.integers(0, 4, int(m.sum()))
        reps.append(u)
    return np.concatenate([rng.integers(0, 4, n, dtype=np.uint8), *reps,
                           rng.integers(0, 4, n // 2, dtype=np.uint8)])


_EXT = {}


def _ext_inputs(cuda, K, E, alpha=4):
    """Phase-A survivors (the exact mono scan) of 64 blocks at (K, E) on the
    card (a third of the blocks in the repeat), with the batch's needles
    and the index (alpha 5: N runs in the genome, A = 5 candidates)."""
    from genmap_tpu_torch.search import engine as te

    key = (K, E, alpha)
    if key not in _EXT:
        seq = _repeat_genome()
        if alpha == 5:
            for s0 in (300, 2000, 5400, 7000):
                seq[s0 : s0 + 20] = 4
        ff = FastaFile(name="g.fa")
        ff.ids, ff.seqs = ["c1"], [seq]
        data = build_index([ff], sampling=5)
        index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device=cuda)
        text = rank.DeviceText.from_host(data, cuda)
        J = 5 if K == 20 else 50
        B = 64
        rng = np.random.default_rng(K)
        starts = np.sort(rng.choice(np.arange(0, data.text_len - K - J, J), B,
                                    replace=False)).astype(np.uint32)
        starts[: B // 3] = 5000 + J * np.arange(B // 3)
        run = te.BlockMapper(index, text, K=K, errors=E, overlap=K - J + 1, J=J, B=B,
                             tier=Tier(32, 64, 8, exact=True), cap=65535, rev_compl=True,
                             collect_only=True)
        st_ = torch.from_numpy(starts.view(np.int32)).to(cuda)
        out = run(st_, torch.full((B,), J, dtype=torch.int32, device=cuda), data.text_len)
        needles = rank.extract_needles(text, st_, K + J - 1, data.text_len)
        _EXT[key] = dict(index=index, B=B, J=J, K=K, E=E, needles=needles,
                         survivors=(out["st"], out["valid"]))
    return _EXT[key]


def _ext_run(b, Fe, exact, dimer, fe_sched, with_occ):
    from genmap_tpu_torch.search import engine as te

    dev = b["needles"].device
    levels = [te._ExtensionLevel(lv, b["E"], dev, dimer)
              for lv in te._tree_levels(b["J"], b["K"])]
    tier = Tier(4, max(4, Fe), Fe, exact=exact, dimer=dimer, ext_exact=exact)
    ridx = torch.arange(b["B"], dtype=torch.int32, device=dev)
    states = kernels.gather_states(*b["survivors"], ridx, b["B"], Fe)
    res = te._extend_to_kmers(b["index"], states, b["needles"], levels, b["B"], tier,
                              fe_sched, with_occ)
    torch.cuda.synchronize()
    return res


@pytest.mark.parametrize("K,E", [(20, 1), (101, 2)], ids=["J5", "J50"])
@pytest.mark.parametrize("dimer", [False, True], ids=["mono", "dimer"])
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("Fe", [1, 4, 16, 128, 1024, "past"])
@pytest.mark.parametrize("decay", [False, True], ids=["flat", "decaying"])
@pytest.mark.parametrize("with_occ", [False, True], ids=["", "occ"])
def test_extend_level(cuda, monkeypatch, K, E, dimer, exact, Fe, decay, with_occ):
    """The engine's extension with its fitting levels fused (a launch per
    run of them) equals the host loop of step and compact launches byte for
    byte: final states where valid, validity, both flags and the per-level
    demand.  `past`: a width past the kernel's budget (mono 8,192, dimer
    2,048), which keeps the loop (decaying: until the width fits)."""
    from genmap_tpu_torch.search import engine as te

    slots = kernels.DIMER_SLOTS if dimer else 4
    Fe = (2048 if dimer else 8192) if Fe == "past" else Fe
    b = _ext_inputs(cuda, K, E)
    n = len(te._tree_levels(b["J"], K))
    sched = [Fe] + [max(1, Fe >> (i // 2)) for i in range(n)] if decay else None
    kernels.reset_launches()
    got = _ext_run(b, Fe, exact, dimer, sched, with_occ)
    fused = kernels.launch_counts()["extend_level"]
    monkeypatch.setattr(te, "_fused_level", lambda *a: False)
    kernels.reset_launches()
    want = _ext_run(b, Fe, exact, dimer, sched, with_occ)
    assert kernels.launch_counts()["extend_level"] == 0
    # a launch per run of consecutive levels that fit
    fits = [te.level_fuses(w, slots) for w in (sched[1:] if decay else [Fe] * n)]
    assert fused == sum(f and (i == 0 or not fits[i - 1]) for i, f in enumerate(fits))
    if not decay:
        assert fused == (0 if Fe in (2048, 8192) else 1)
    (gst, gv), gcap, gfar, *gocc = got
    (wst, wv), wcap, wfar, *wocc = want
    _eq(gv, wv)
    m = wv.bool()[None]
    _eq(torch.where(m, gst, 0), torch.where(m, wst, 0))
    _eq(gcap, wcap)
    _eq(gfar, wfar)
    assert len(gocc) == len(wocc) == int(with_occ)
    for a, w in zip(gocc, wocc):
        _eq(a, w)
    assert wv.any()
    if Fe == 1:
        assert wcap.any()


@pytest.mark.parametrize("dimer", [False, True], ids=["mono", "dimer"])
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("Fe", [1, 16])
def test_extend_level_dna5(cuda, monkeypatch, dimer, exact, Fe):
    """test_extend_level on a Dna5 index (A = 5 candidates; N-adjacent
    dimer sub-rows flagged), J = 50 with occupancy."""
    from genmap_tpu_torch.search import engine as te

    b = _ext_inputs(cuda, 101, 2, alpha=5)
    assert b["index"].nchars == 5
    kernels.reset_launches()
    got = _ext_run(b, Fe, exact, dimer, None, True)
    assert kernels.launch_counts()["extend_level"] == 1
    monkeypatch.setattr(te, "_fused_level", lambda *a: False)
    want = _ext_run(b, Fe, exact, dimer, None, True)
    (gst, gv), gcap, gfar, gocc = got
    (wst, wv), wcap, wfar, wocc = want
    _eq(gv, wv)
    m = wv.bool()[None]
    _eq(torch.where(m, gst, 0), torch.where(m, wst, 0))
    for a, w in ((gcap, wcap), (gfar, wfar), (gocc, wocc)):
        _eq(a, w)
    assert wv.any()


@pytest.mark.parametrize("Fe,exact,dimer,fe_sched", [
    (4, False, False, None),
    (16, False, True, (16, 16, 8, 8, 4)),
    (256, True, False, (256, 128, 64, 16, 8)),
], ids=["fast-mono-4", "fast-dimer-16", "exact-256"])
def test_extender_card_equals_cpu(cuda, Fe, exact, dimer, fe_sched):
    """An Extender batch (J = 16) on the card, its levels fused, equals the
    CPU port's, which tests/test_torch_split.py holds to the JAX package's
    make_extender at these rungs."""
    from genmap_tpu_torch.search import engine as te

    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["c1"], [_repeat_genome(seed=5, n=4000, copies=60, unit_len=150)]
    data = build_index([ff], sampling=5)
    K, E, O, B = 30, 1, 15, 64
    J = K - O + 1
    rng = np.random.default_rng(3)
    starts = np.sort(rng.choice(np.arange(0, data.text_len - K - J, J), B,
                                replace=False)).astype(np.uint32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        index = rank.DeviceIndex.from_part(data, data.parts[0], light=True, device=dev)
        text = rank.DeviceText.from_host(data, dev)
        st_ = torch.from_numpy(starts.view(np.int32)).to(dev)
        cnt = torch.full((B,), J, dtype=torch.int32, device=dev)
        a = te.BlockMapper(index, text, K=K, errors=E, overlap=O, J=J, B=B,
                           tier=Tier(32, 64, 8, exact=True), cap=65535, rev_compl=True,
                           collect_only=True)(st_, cnt, data.text_len)
        live = torch.nonzero(a["surv"].to(torch.int32).cpu() > 0).squeeze(1)
        n = live.numel()
        npad = 1 << int(np.ceil(np.log2(n)))
        ridx = torch.zeros(npad, dtype=torch.int32)
        ridx[:n] = live
        run = te.Extender(index, text, K=K, errors=E, overlap=O, J=J, B=npad, Fe=Fe,
                          cap=65535, rev_compl=True, exact=exact, dimer=dimer,
                          fe_sched=fe_sched, with_occ=True)
        kernels.reset_launches()
        gs = torch.zeros(npad, dtype=torch.int32)
        gs[:n] = st_.cpu()[live]
        gc = torch.zeros(npad, dtype=torch.int32)
        gc[:n] = J
        out = run(gs.to(dev), gc.to(dev), data.text_len, (a["st"], a["valid"]),
                  ridx.to(dev), n)
        outs.append({k: v.cpu() for k, v in out.items()})
        if dev == cuda:
            torch.cuda.synchronize()
            assert kernels.launch_counts()["extend_level"] == 1
    got, want = outs
    for k in ("hits", "overflow", "overflow_cap", "ext_occ"):
        _eq(got[k], want[k])
    assert (~want["overflow"][:n]).any() and want["ext_occ"].to(torch.int32).max() > 4
