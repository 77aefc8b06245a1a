"""Bytes and operations that one call of a port kernel needs, from its
arguments: a frozen copy of `kernel_work`, `dimer_work`, `seed_build_work`
and `seed_build_parent_ops` of the repository's `chip_smoke.py`, with the
port helpers they call (`kernels._state_groups`, `rank.u32`,
`fmindex.sub_width`, `rank.seed_level_offset`) copied beside them, so that a
change to the port cannot change the yardstick.  `locate` and `row_gather`
have no count here (no cell runs them).

Each count takes each input byte that the call's data need read once and
each output byte written once (see chip_smoke.py for the reasoning of each
kernel's count).  The call's bound is max(bytes / peak bytes/s, operations /
peak operations/s), with the peaks of `peaks.json`.
"""

from __future__ import annotations

import json
import os

import torch

MASK32 = 0xFFFFFFFF
_HERE = os.path.dirname(os.path.abspath(__file__))
COUNTED = ("extract_needles", "candidate_step", "compact", "count_tail",
           "seed_lookup", "gather_states", "probe_mass", "dimer_step",
           "seed_build")


def peaks(kind: str) -> dict | None:
    """The published peaks of the device named `kind`, or None."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f).get(kind)


def u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def sub_width(has_n: bool) -> int:
    """Words of a mono rank sub-row: 32 code words, 3 start counts, the
    sentinel count and 16 sentinel bit words, then (Dna5) the N count and
    16 N bit words."""
    return 52 + 17 * int(has_n)


def seed_level_offset(t: int) -> int:
    return (4**t - 1) // 3


def _state_groups(st, per_block, inner, G):
    N = st.shape[1]
    i = torch.arange(N, dtype=torch.int64, device=st.device)
    grp = st[4].to(torch.int64) if st.shape[0] == 5 else (i % per_block) // inner
    return i // per_block, grp.clamp(0, G - 1)


def kernel_work(name, args, result=None):
    """(bytes, operations) of one call of kernel `name` with the bound
    arguments `args` (and, for seed_build, its result: the tables)."""
    if name == "extract_needles":
        Bn, Ln = args["starts"].shape[0], args["Ln"]
        nbytes = (Bn * 4 + Bn * Ln + Bn * ((Ln + 15) // 16 + 1) * 4
                  + (Bn * ((Ln + 31) // 32 + 1) * 4 if args["nwords"].numel() else 0))
        return nbytes, 10 * Bn * Ln
    if name == "candidate_step":
        ix, st, valid = args["index"], args["st"], args["valid"]
        R, N = st.shape
        A = ix.nchars
        G = args["right"].shape[0]
        _blk, g = _state_groups(st, args["per_block"], args["inner"], G)
        active = args["act"].bool()[g]
        work = valid.bool() & active
        nwork = int(work.sum())
        npass = int((valid.bool() & ~active).sum())
        r = args["right"].bool()[g]
        mlo = torch.where(r, u32(st[1]), u32(st[0]))[work]
        hi = (mlo + u32(st[2])[work]) & MASK32
        if args["exact"]:
            addr = torch.cat([mlo >> 9, hi >> 9]) * 2
        else:
            q = mlo >> 9
            addr = torch.cat([q * 2, (q * 2 + 1)[(hi >> 9) > q]])
        n_rows = int(torch.unique(addr).numel())
        subw = sub_width(ix.has_n)
        nbytes = (N + 4 * (4 + (R == 5)) * nwork + 2 * 4 * R * npass
                  + n_rows * subw * 4 + R * A * 4 * nwork + N * A + N)
        nops = nwork * (2 * (32 * 10 + 2 * 16 * 4) + 20 * A)
        return nbytes, nops
    if name == "compact":
        R, nrows, M = args["arrays"].shape
        F = args["F"]
        v = args["valid"].bool()
        nvalid = v.sum(dim=-1)
        kept = int(nvalid.clamp(max=F).sum())
        if args.get("count") or nrows * M == 0:
            n_read = nrows * M
        else:
            over = (torch.cumsum(v, dim=-1, dtype=torch.int32) > F).to(torch.uint8)
            n_read = int(torch.where(nvalid > F, over.argmax(dim=-1) + 1, M).sum())
        nbytes = (n_read + R * kept * 4 + R * nrows * F * 4 + nrows * F + nrows
                  + (4 * nrows if args.get("count") else 0))
        return nbytes, 6 * n_read
    if name == "seed_lookup":
        Bn = args["needles"].shape[0]
        P, t, Fp = args["a_pos"].numel(), args["t_seed"], args["Fp"]
        nbytes = Bn * P * (t + (12 if t else 0)) + 4 * P + Bn * Fp * (5 * 4 + 1)
        return nbytes, Bn * P * (8 * t + 10) + 8 * Bn * Fp
    if name == "gather_states":
        _R, _Bc, Fc = args["st"].shape
        npad, Fe = args["ridx"].numel(), args["Fe"]
        return npad * 4 + npad * min(Fc, Fe) * 17 + npad * Fe * 17, 4 * npad * Fe
    if name == "probe_mass" and args["st"] is None:
        Bp, P = args["acc"].shape[0], args["thr"].numel()
        nbytes = 8 * Bp * (P + 1) + 4 * P + Bp + (4 * P * Bp if args.get("with_mass") else 0)
        return nbytes, 3 * Bp * (P + 1)
    if name == "probe_mass":
        st, valid = args["st"], args["valid"]
        _R, Bp, F = st.shape
        P = args["thr"].numel()
        nvalid = int(valid.sum())
        Ln = args["needles"].shape[1]
        acc_bytes = 8 * Bp * (P + 1)
        nbytes = (Bp * F + 8 * nvalid + Bp + (Bp * Ln if args["has_n"] else 0)
                  + 4 * P + (0 if args.get("last", True) else acc_bytes - Bp) + Bp
                  + (acc_bytes if args.get("acc") is not None else 0)
                  + ((4 * P + 1) * Bp if args.get("with_mass") else 0))
        return nbytes, 4 * Bp * F + 2 * P * nvalid
    if name == "dimer_step":
        return dimer_work(args)
    if name == "seed_build":
        return seed_build_work(args, result)
    if name != "count_tail":
        raise KeyError(f"no count for kernel {name}")
    cnt, J = args["cnt"], args["J"]
    N = args["valid"].numel()
    v = args["valid"].bool()
    nvalid = int(v.sum())
    exact = bool(args.get("with_exact"))
    n_exact = int((v & (args["st"][3] == 0)).sum()) if exact else 0
    n_strand = (0 if args["rev_compl"] else nvalid) + (n_exact if args["rev_compl"] else 0)
    nbytes = (N + 2 * nvalid * 4 + cnt.numel() * 4 + cnt.numel() * J * 2
              + 2 * n_strand * 20 + (nvalid * 4 + 3 * cnt.numel() * J * 4 if exact else 0))
    return nbytes, 6 * N + 30 * n_strand + 4 * n_exact


def seed_build_parent_ops(ix, lo, sz):
    """Operations to count the four children of each parent (lo, sz)."""
    subw = sub_width(ix.has_n)
    last_sub = ix.fwd_blocks.shape[0] - 1

    def occ_ops(p):
        q, off = p >> 9, p & 511
        kb = off >> 4
        last = q == last_sub
        up = (off >= 256) & ~last
        code_words = torch.where(up, 32 - kb, kb + 1)
        bit_words = torch.where(up, 16 - (off >> 5), (off + 31) >> 5)
        rows = ix.fwd_blocks

        def differs(col):
            return last | (rows[q, col] != rows[q, subw + col])

        nbit = differs(35).to(torch.int64)
        if ix.has_n:
            nbit = nbit + differs(52).to(torch.int64)
        return 10 * code_words + 12 + 4 * nbit * bit_words

    hi = (lo + sz) & MASK32
    same = ((hi >> 9) == (lo >> 9)) & (hi >= lo)
    off_lo, off_hi = lo & 511, hi & 511
    between = torch.where(
        sz != 0,
        10 * (((off_hi + 15) >> 4) - (off_lo >> 4))
        + 4 * (1 + ix.has_n) * (((off_hi + 31) >> 5) - (off_lo >> 5)) + 8, 0)
    return occ_ops(lo) + torch.where(same, between, occ_ops(hi))


def seed_build_work(args, tables):
    """The tables written once, each distinct rank sub-row that a parent's
    bound falls in read once; per parent its two counts, 8 per child."""
    ix, t0 = args["index"], args["t0"]
    mlo, size = tables
    npar = seed_level_offset(t0)
    lo = u32(mlo[:npar])
    sz = u32(size[:npar])
    hi = (lo + sz) & MASK32
    bounds = torch.cat([lo, hi])
    n_rows = int(torch.unique(bounds >> 9).numel()) if npar else 0
    nbytes = 4 * (mlo.numel() + size.numel()) + n_rows * sub_width(ix.has_n) * 4
    nops = int(seed_build_parent_ops(ix, lo, sz).sum()) + 8 * (mlo.numel() - 1)
    return nbytes, nops


def dimer_work(args):
    """Validity of every state, rows and plan ids of the consuming valid
    states, 26 words per distinct dimer sub-row read, the outputs that a
    consumer reads; ~420 ops per bound and ~20 per candidate."""
    ix, st, valid = args["index"], args["st"], args["valid"]
    R, N = st.shape
    G = args["right"].shape[0]
    _blk, g = _state_groups(st, args["per_block"], args["inner"], G)
    cons = args["consume"].to(torch.int64)[g]
    passing = (cons == 0) if args["with_pass"] else torch.zeros_like(cons, dtype=torch.bool)
    work = valid.bool() & ~passing
    nwork = int(work.sum())
    r = args["right"].bool()[g]
    mlo = torch.where(r, u32(st[1]), u32(st[0]))[work]
    hi = (mlo + u32(st[2])[work]) & MASK32
    if args["exact"]:
        subs = torch.cat([mlo >> 7, hi >> 7])
    else:
        q = mlo >> 7
        subs = torch.cat([q, (q + 1)[(hi >> 7) > q]])
    n_subs = int(torch.unique(subs).numel())
    mono = (cons == 1) if args["with_mono"] else torch.zeros_like(passing)
    slots = int(torch.where(mono[work], ix.nchars, 16).sum())
    npass = int((valid.bool() & passing).sum())
    nbytes = (N + 4 * (4 + (R == 5)) * nwork + 2 * 4 * R * npass
              + n_subs * 26 * 4 + R * 4 * slots + N * 16 + N)
    return nbytes, nwork * (2 * 420 + 16 * 20)
