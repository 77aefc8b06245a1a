"""The work that chip_smoke.py charges a kernel's bound with, held against
what the kernel's plain version does on the CPU.

`locate_work` counts the LF steps of the walks that `locate_plain` takes
(with the samples' positions set to 0, locate_plain's i2 is each row's
step count); `kernel_work` of `gather_states`, `seed_lookup` and
`probe_mass` counts the bytes that their plain versions read (the
validity of every slot, the operands of valid slots only) and write, and
of `seed_build` the plain build's tables and the rank sub-rows of the
states it steps.  Small indexes, ~10 s.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from genmap_tpu_torch import kernels
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.index.fmindex import sub_width
from genmap_tpu_torch.io.fasta import FastaFile
from genmap_tpu_torch.ops import rank

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_INDEX = {}


def _index(alpha, sampling):
    key = (alpha, sampling)
    if key not in _INDEX:
        rng = np.random.default_rng(10 * alpha + sampling)
        seq = rng.integers(0, 4, size=5000, dtype=np.uint8)
        seq[1000:1600] = np.tile(seq[:100], 6)
        if alpha == 5:
            seq[200:260] = 4
            seq[rng.integers(0, len(seq), 25)] = 4
        ff = FastaFile(name="g.fa")
        ff.seqs = [seq, rng.integers(0, 4, size=1500, dtype=np.uint8)]
        ff.ids = ["a", "b"]
        data = build_index([ff], sampling=sampling)
        _INDEX[key] = rank.DeviceIndex.from_part(data, data.parts[0], light=False,
                                                 device="cpu")
    return _INDEX[key]


def _rows(ix, clustered, seed):
    rng = np.random.default_rng(seed)
    n = ix.n_total
    if clustered:  # runs of consecutive SA rows, as -d draws them
        starts = rng.integers(0, n - 8, 300)
        pos = np.concatenate([np.arange(s, s + rng.integers(1, 8)) for s in starts])
    else:
        pos = rng.integers(0, n, 2000)
    valid = rng.random(len(pos)) < 0.9
    return (torch.from_numpy(pos.astype(np.uint32).view(np.int32)),
            torch.from_numpy(valid.astype(np.uint8)))


@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("sampling", [1, 10, 32])
@pytest.mark.parametrize("alpha", [4, 5])
def test_locate_work_counts_the_plain_walks(alpha, sampling, clustered):
    cs = _smoke()
    ix = _index(alpha, sampling)
    pos, valid = _rows(ix, clustered, sampling + alpha)
    zero = dataclasses.replace(ix, sa_i2=torch.zeros_like(ix.sa_i2))
    _i1, per_row = kernels.locate_plain(zero, pos, valid)  # i2 = steps
    walk = cs.locate_walk(ix, pos, valid)
    assert torch.equal(walk["steps"], per_row.to(torch.int64))
    steps = int(per_row.sum())
    assert steps > 0 or sampling == 1  # sampling 1: (nearly) every row is sampled
    assert walk["sub"].numel() == walk["off"].numel() == walk["code"].numel() == steps
    nbytes, nops, shape, reads = cs.locate_work(dict(index=ix, pos=pos, valid=valid))
    assert f"{steps} LF steps" in shape
    # an indicator test per iteration of a live row: each step, and the
    # test that ends a walk before `sampling` steps
    ended = int(((per_row < sampling) & valid.bool()).sum())
    assert reads == 2 * steps + ended
    assert nops < steps * (32 * 10 + 2 * 16 * 4 + 10) + 12 * pos.numel()
    assert nbytes > pos.numel() * 13


def test_locate_work_all_invalid():
    cs = _smoke()
    ix = _index(4, 10)
    pos, _ = _rows(ix, False, 3)
    valid = torch.zeros_like(pos, dtype=torch.uint8)
    walk = cs.locate_walk(ix, pos, valid)
    assert int(walk["steps"].sum()) == 0 and walk["tests"].numel() == 0
    nbytes, _nops, _shape, reads = cs.locate_work(dict(index=ix, pos=pos, valid=valid))
    assert reads == 0 and nbytes == pos.numel() * 13


@pytest.mark.parametrize("Fc,Fe", [(256, 128), (64, 16), (32, 64), (4, 8), (16, 16)])
def test_gather_states_work_counts_plain_bytes(Fc, Fe):
    cs = _smoke()
    rng = np.random.default_rng(Fc + Fe)
    B, npad, n = 300, 40, 29
    st = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (4, B, Fc)).astype(np.int32))
    valid = torch.from_numpy((rng.random((B, Fc)) < 0.5).astype(np.uint8))
    ridx = torch.from_numpy(rng.integers(0, B, npad).astype(np.int32))
    args = dict(st=st, valid=valid, ridx=ridx, n=n, Fe=Fe)
    out, out_valid = kernels.gather_states_plain(**args)
    keep = min(Fc, Fe)
    read = (ridx.numel() * ridx.element_size()
            + st[:, ridx.long(), :keep].numel() * st.element_size()
            + valid[ridx.long(), :keep].numel() * valid.element_size())
    written = out.numel() * out.element_size() + out_valid.numel() * out_valid.element_size()
    nbytes, _nops, shape, _reads = cs.kernel_work("gather_states", args)
    assert nbytes == read + written
    assert f"B={B} Fc={Fc} Fe={Fe}" in shape
    assert cs.variant("gather_states", args) == f"B={B} Fc={Fc} Fe={Fe}"


@pytest.mark.parametrize("t_seed,P,Fp", [(0, 3, 4), (1, 2, 16), (5, 3, 4), (5, 7, 8)])
def test_seed_lookup_work_counts_plain_bytes(t_seed, P, Fp):
    cs = _smoke()
    ix = _index(4, 10)
    assert ix.has_seed and ix.seed_t0 >= t_seed
    rng = np.random.default_rng(t_seed + P + Fp)
    B, Ln = 200, 40
    needles = torch.from_numpy(rng.integers(0, 5, (B, Ln)).astype(np.uint8))
    a_pos = torch.from_numpy(rng.integers(0, Ln - t_seed + 1, P).astype(np.int32))
    args = dict(index=ix, needles=needles, a_pos=a_pos, t_seed=t_seed, Fp=Fp,
                n_total=ix.n_total)
    st, valid = kernels.seed_lookup_plain(**args)
    # per (block, plan) its window and three table words; the plans'
    # window positions once
    read = (B * P * t_seed * needles.element_size()
            + (B * P * 3 * ix.seed_mlo.element_size() if t_seed else 0)
            + a_pos.numel() * a_pos.element_size())
    written = st.numel() * st.element_size() + valid.numel() * valid.element_size()
    nbytes, _nops, shape, _reads = cs.kernel_work("seed_lookup", args)
    assert nbytes == read + written
    assert shape == f"B={B} P={P} t_seed={t_seed} Fp={Fp}"


def _probe_args(has_n, with_mass, with_acc, last, seed):
    rng = np.random.default_rng(seed)
    B, F, P, Ln = 300, 12, 3, 90
    st = np.zeros((5, B, F), np.int64)
    st[2] = rng.integers(1, 4, (B, F))
    st[4] = rng.integers(0, P, (B, F))
    acc = np.stack([rng.integers(0, 3, B) for _ in range(P)] + [rng.random(B) < 0.1], 1)
    return dict(st=torch.from_numpy(st.astype(np.int32)),
                valid=torch.from_numpy((rng.random((B, F)) < 0.3).astype(np.uint8)),
                ovf=torch.from_numpy((rng.random(B) < 0.1).astype(np.uint8)),
                needles=torch.from_numpy(rng.integers(0, 5, (B, Ln)).astype(np.uint8)),
                thr=torch.from_numpy(rng.integers(0, 2, P).astype(np.int32)), has_n=has_n,
                with_mass=with_mass,
                acc=torch.from_numpy(acc.astype(np.int64)) if with_acc else None, last=last)


def _nbytes(ts):
    ts = ts if isinstance(ts, tuple) else (ts,)
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("has_n,with_mass,with_acc,last", [
    (False, False, False, True), (True, False, False, True), (False, True, False, True),
    (False, False, True, False), (True, True, True, True)])
def test_probe_mass_work_counts_plain_bytes(has_n, with_mass, with_acc, last):
    cs = _smoke()
    args = _probe_args(has_n, with_mass, with_acc, last, 5 * has_n + 3 * with_mass + last)
    out = kernels.probe_mass_plain(**args)
    st, valid = args["st"], args["valid"]
    # every slot's validity, the size and plan words of valid slots, the
    # overflow flags, the needle rows when they may hold N, the thresholds
    # and the earlier parts' sums
    read = (_nbytes(valid) + 2 * st.element_size() * int(valid.bool().sum())
            + _nbytes(args["ovf"]) + (_nbytes(args["needles"]) if has_n else 0)
            + _nbytes(args["thr"]) + (_nbytes(args["acc"]) if with_acc else 0))
    nbytes, _nops, shape, _reads = cs.kernel_work("probe_mass", args)
    assert nbytes == read + _nbytes(out)
    assert shape == f"B=300 F=12 P=3 valid={int(valid.bool().sum())}"


@pytest.mark.parametrize("with_mass", [True, False])
def test_probe_mass_reduced_work_counts_plain_bytes(with_mass):
    cs = _smoke()
    args = _probe_args(False, with_mass, True, True, 7)
    args.update(st=None, valid=None, ovf=None, needles=None)
    out = kernels.probe_mass_plain(**args)
    nbytes, _nops, shape, _reads = cs.kernel_work("probe_mass", args)
    assert nbytes == _nbytes(args["acc"]) + _nbytes(args["thr"]) + _nbytes(out)
    assert shape == "B=300 P=3 (reduced)"


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("t0", [0, 1, 4, 7])
def test_seed_build_work_counts_plain_bytes(alpha, t0):
    """seed_build's bytes: the plain build's outputs written once, and once
    each distinct rank sub-row that a bound of a state it steps (its
    parents, levels 0..t0-1, as `candidate_step_plain` receives them) falls
    in."""
    cs = _smoke()
    ix = _index(alpha, 10)
    orig, stepped = kernels.candidate_step_plain, []

    def spy(index, st, valid, **kw):
        stepped.append(st.clone())
        return orig(index, st, valid, **kw)

    kernels.candidate_step_plain = spy
    try:
        out = kernels.seed_build_plain(ix, t0)
    finally:
        kernels.candidate_step_plain = orig
    none = torch.zeros(0, dtype=torch.int64)
    flo = torch.cat([none] + [rank.u32(st[0]) for st in stepped])
    size = torch.cat([none] + [rank.u32(st[2]) for st in stepped])
    assert flo.numel() == rank.seed_level_offset(t0)
    rows = torch.unique(torch.cat([flo, (flo + size) & rank.MASK32]).long() >> 9)
    subw = sub_width(ix.has_n)
    nbytes, nops, shape, reads = cs.kernel_work("seed_build", dict(index=ix, t0=t0))
    assert nbytes == _nbytes(out) + rows.numel() * subw * 4
    assert reads == 0 and nops >= 8 * (out[0].numel() - 1)
    assert f"t0={t0} on the {ix.n_total}-symbol A={alpha} index" in shape
    assert cs.variant("seed_build", dict(index=ix, t0=t0)) == f"A={alpha} t0={t0}"


def _replay_sb_children(rows, subw, last_sub, has_n, lo, sz):
    """The operations of csrc/seed_build.cu's sb_children on one parent,
    loop by loop: sb_occ at lo, and sb_occ_add (hi in lo's sub-row) or
    sb_occ at hi, with ~10 ops a code word, 4 a bit word, 12 for sb_occ's
    start counts and 8 for sb_occ_add's sums."""

    def sb_occ(p):
        q, off = p >> 9, p & 511
        last = q == last_sub
        up = off >= 256 and not last
        kb = off >> 4
        words = 1 + len(range(kb + 1, 32) if up else range(0, kb))
        ops = 10 * words + 12
        for cnt in [35] + ([52] if has_n else []):
            if last or rows[q][cnt] != rows[q][subw + cnt]:
                ops += 4 * len(range(off >> 5, 16) if up else range(0, (off + 31) >> 5))
        return ops

    hi = (lo + sz) & 0xFFFFFFFF
    ops = sb_occ(lo)
    if hi >> 9 == lo >> 9 and hi >= lo:
        if sz:
            a, b = lo & 511, hi & 511
            ops += 10 * len(range(a >> 4, (b + 15) >> 4)) + 8
            ops += 4 * (1 + has_n) * len(range(a >> 5, (b + 31) >> 5))
        return ops
    return ops + sb_occ(hi)


@pytest.mark.parametrize("alpha", [4, 5])
@pytest.mark.parametrize("t0", [1, 4, 7])
def test_seed_build_ops_replay_sb_occ(alpha, t0):
    """seed_build's operations: per parent what sb_children counts (the
    nearer half of each bound's sub-row, the sentinel and N bit words only
    where present, the words between lo and hi where they share a
    sub-row), replayed loop by loop, plus 8 per child written."""
    cs = _smoke()
    ix = _index(alpha, 10)
    mlo, size = kernels.seed_build_plain(ix, t0)
    npar = rank.seed_level_offset(t0)
    lo, sz = rank.u32(mlo[:npar]), rank.u32(size[:npar])
    rows = rank.u32(ix.fwd_blocks).tolist()
    subw, last_sub = sub_width(ix.has_n), ix.fwd_blocks.shape[0] - 1
    want = [_replay_sb_children(rows, subw, last_sub, int(ix.has_n), a, b)
            for a, b in zip(lo.tolist(), sz.tolist())]
    got = cs.seed_build_parent_ops(ix, lo, sz)
    assert got.tolist() == want
    _nbytes_, nops, _shape, _reads = cs.kernel_work("seed_build", dict(index=ix, t0=t0))
    assert nops == sum(want) + 8 * (mlo.numel() - 1)
    # the cases the replay must cover: upper halves, the last sub-row, hi
    # in lo's sub-row (empty or not) and in another
    off, q = lo & 511, lo >> 9
    hi = (lo + sz) & rank.MASK32
    if t0 == 7:
        assert bool((off >= 256).any()) and bool((q == last_sub).any())
        assert bool(((hi >> 9) == q).any()) and bool(((hi >> 9) != q).any())
        assert bool((sz == 0).any())
