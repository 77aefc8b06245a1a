"""Batched FM-index rank / LF primitives on torch tensors.

Port of `genmap_tpu/ops/rank.py`.  The index is the paired-rank-row FMD
index of `index/fmindex.py`: a sub-row covers 512 BWT symbols (2-bit codes,
absolute prefix counts, sentinel and N bitvectors) and the stored row i is
sub-rows i and i+1 side by side, so one row read answers the rank queries
at both bounds of an interval whenever the interval fits its 1024-symbol
window (`extend_core_fast`); `extend_core` reads one row per bound and is
exact for any interval.

Bidirectional search uses the FMD scheme over the single both-strand BWT: a
pattern P is tracked as the interval pair (I(P), I(rc(P))).  Left extension
by c is an LF step on I(P); right extension by c is a left extension of
I(rc(P)) by comp(c).  The companion offset follows from suffix sums of the
per-character slice counts.

Conventions of the port:
  * uint32 data (rank rows, positions, interval bounds) is stored in int32
    tensors with the same bits; CUDA kernels read it as `const uint32_t*`.
  * The functions here are the plain PyTorch versions.  They widen to int64
    and mask to 32 bits wherever uint32 arithmetic wraps (torch has no
    uint32 shifts or comparisons, and an int32 `>>` is arithmetic), and
    count bits with a SWAR popcount (torch has no popcount op).  Results
    come back as int64 tensors holding the unsigned value.
  * The main path runs the hand-written kernels of `kernels.py`; these plain
    versions are what a CPU tensor takes and what the kernels are held
    against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from genmap_tpu_torch.index.fmindex import (
    BVWORDS,
    D_CUM,
    D_DELTA,
    D_MONO,
    D_WIDTH,
    SUBBITS,
    SUBWORDS,
    S_LE,
    S_SBITS,
    S_SCNT,
    S_WORDS,
    FMIndexData,
    IndexPart,
    _col_ncnt,
    sub_width,
    wide_rows,
)

MASK32 = 0xFFFFFFFF
_M55 = 0x55555555

# complement permutation over candidate characters (N is self-complementary)
_COMP4 = (3, 2, 1, 0)
_COMP5 = (3, 2, 1, 0, 4)

# Max seeded prefix length; tables hold all levels 0..t0 where t0 is chosen
# per index part (seed_depth): the size is sum 4^t ~ (4/3)·4^t0 entries x
# 8 B — t0=12 is ~179 MB per part; small parts stop where their intervals
# are empty anyway.
SEED_T0 = 12


def seed_depth(n_total: int, t0_max: int = SEED_T0) -> int:
    """Seed-table depth for a part of n_total (both-strand) symbols."""
    return max(1, min(t0_max, math.ceil(math.log(max(2, n_total), 4))))


def seed_level_offset(t: int) -> int:
    """Start of the level-t block in the concatenated seed tables: levels are
    stored back to back, level t holding 4^t entries in big-endian code
    order (code(w) = sum w_i * 4^(t-1-i))."""
    return (4**t - 1) // 3


def comp_perm(A: int) -> tuple[int, ...]:
    """Complement permutation over the candidate-character axis."""
    return _COMP5 if A == 5 else _COMP4


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; a CUDA request without a card
    raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run the plain PyTorch "
            "path on the CPU"
        )
    return dev


def u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned value of uint32 bits held in an int32 (or int64) tensor."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the low 32 bits of an int64 tensor."""
    return (x & MASK32).to(torch.int32)


def np_i32(a: np.ndarray, device) -> torch.Tensor:
    """Upload a uint32 numpy array as an int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


@dataclass(frozen=True)
class DeviceIndex:
    """Device-resident FMD-index part (paired mono rank rows)."""

    fwd_blocks: torch.Tensor  # [nb, 2*sub_width] int32 (uint32 bits)
    C: torch.Tensor  # [6] int32 (uint32 bits)
    sa_i1: torch.Tensor  # sampled SA values (empty when light)
    sa_i2: torch.Tensor
    strand_blocks: torch.Tensor  # [nb128, 5] int32: rc-strand ranks over SA rows
    ind_blocks: torch.Tensor  # [nb128, 5] int32 (empty [0, 5] when light)
    # interval seed tables over all ACGT strings of length 0..seed_t0
    # (levels concatenated, see seed_level_offset); empty = disabled
    seed_mlo: torch.Tensor
    seed_size: torch.Tensor
    # dimer rank rows (paired [nb, 2*D_WIDTH]) + C2[16]; a [1, 2*D_WIDTH]
    # placeholder when the part has none
    dimer_blocks: torch.Tensor
    C2: torch.Tensor
    has_n: bool
    sampling: int
    n_total: int
    seed_t0: int = 0

    @property
    def device(self) -> torch.device:
        return self.fwd_blocks.device

    @property
    def has_seed(self) -> bool:
        return self.seed_mlo.shape[0] > 0

    @property
    def has_dimer(self) -> bool:
        return self.dimer_blocks.shape[0] > 1

    @property
    def nchars(self) -> int:
        return 5 if self.has_n else 4

    def resident_bytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.fwd_blocks, self.C, self.sa_i1, self.sa_i2,
                      self.strand_blocks, self.ind_blocks, self.seed_mlo,
                      self.seed_size, self.dimer_blocks, self.C2)
        )

    @staticmethod
    def from_numpy(
        blocks: np.ndarray,
        C: np.ndarray,
        strand_blocks: np.ndarray,
        *,
        has_n: bool,
        sampling: int,
        sa_i1: np.ndarray | None = None,
        sa_i2: np.ndarray | None = None,
        ind_blocks: np.ndarray | None = None,
        dimer: np.ndarray | None = None,
        C2: np.ndarray | None = None,
        device="cuda",
        seed_t0: int | None = None,
    ) -> "DeviceIndex":
        """Upload one part from its host arrays: `blocks` are the rank
        SUB-rows of `index/fmindex.py` (paired here), `C` the [6] C array.
        The SA samples and indicator rows are only read by `locate` (CSV,
        exclude-pseudo); pass None to skip them.  `dimer` / `C2` are the
        part's dimer sub-rows and C2 array (None: no dimer rows).  The seed
        tables are built on the device, `seed_t0` levels deep (default:
        seed_depth of the part)."""
        dev = resolve_device(device)
        light = sa_i1 is None
        C = np.asarray(C)
        index = DeviceIndex(
            fwd_blocks=np_i32(wide_rows(np.asarray(blocks, dtype=np.uint32)), dev),
            C=np_i32(C.astype(np.uint32), dev),
            sa_i1=torch.zeros(0, dtype=torch.int32, device=dev)
            if light else np_i32(sa_i1, dev),
            sa_i2=torch.zeros(0, dtype=torch.int32, device=dev)
            if light else np_i32(sa_i2, dev),
            strand_blocks=np_i32(strand_blocks, dev),
            ind_blocks=torch.zeros((0, 1 + BVWORDS), dtype=torch.int32, device=dev)
            if light or ind_blocks is None else np_i32(ind_blocks, dev),
            seed_mlo=torch.zeros(0, dtype=torch.int32, device=dev),
            seed_size=torch.zeros(0, dtype=torch.int32, device=dev),
            dimer_blocks=np_i32(wide_rows(np.asarray(dimer, dtype=np.uint32)), dev)
            if dimer is not None
            else torch.zeros((1, 2 * D_WIDTH), dtype=torch.int32, device=dev),
            C2=np_i32(C2, dev) if C2 is not None
            else torch.zeros(16, dtype=torch.int32, device=dev),
            has_n=bool(has_n),
            sampling=int(sampling),
            n_total=int(C[5]),
        )
        return with_seed_tables(index, seed_t0)

    @staticmethod
    def from_part(
        data: FMIndexData, part: IndexPart, light: bool = False, device="cuda",
        seed_t0: int | None = None,
    ) -> "DeviceIndex":
        """Upload one part of a host index.  `light=True` skips the
        sampled-SA values and the sampling-indicator rank rows, which only
        `locate` (CSV / exclude-pseudo) reads; the dimer rows go up in both
        modes, whenever the part has them."""
        return DeviceIndex.from_numpy(
            part.fwd.blocks, part.C, part.strand_blocks,
            has_n=data.has_n, sampling=data.sampling,
            sa_i1=None if light else part.sa_i1,
            sa_i2=None if light else part.sa_i2,
            ind_blocks=None if light else part.ind_blocks,
            dimer=part.dimer, C2=part.C2,
            device=device, seed_t0=seed_t0,
        )


# ---------------------------------------------------------------------------
# Plain rank arithmetic (int64 holding uint32 values)
# ---------------------------------------------------------------------------


def _field_masks(off: torch.Tensor) -> torch.Tensor:
    """Per-word 2-bit-field masks selecting fields < off.  off: [...] int64."""
    k = torch.arange(SUBWORDS, dtype=torch.int64, device=off.device)
    nf = (off[..., None] - 16 * k).clamp(0, 16)
    return (torch.ones_like(nf) << (2 * nf)) - 1


def _bit_masks(off: torch.Tensor, words: int) -> torch.Tensor:
    """Per-word bit masks selecting bits < off."""
    k = torch.arange(words, dtype=torch.int64, device=off.device)
    nb = (off[..., None] - 32 * k).clamp(0, 32)
    return (torch.ones_like(nb) << nb) - 1


def _popcount_sum(x: torch.Tensor) -> torch.Tensor:
    return popcount32(x).sum(dim=-1)


def _occ_sub(sub: torch.Tensor, p: torch.Tensor, has_n: bool):
    """Per-character occurrence counts + sentinel count at position p.

    `sub` is the 512-symbol sub-row covering p ([..., sub_width] int32 bits),
    `p` an int64 position.  Returns (occ [..., A], sent [...]) as int64
    values mod 2^32:
      occ[c] = #{i < p : BWT[i] == c},  sent = #{i < p : BWT[i] sentinel}.
    """
    off = p & 511
    fmask = _field_masks(off) & _M55
    w = u32(sub[..., S_WORDS : S_WORDS + SUBWORDS])
    hi = w >> 1  # logical: w is non-negative
    le0 = _popcount_sum(~(w | hi) & fmask)
    le1 = _popcount_sum(~hi & fmask)
    le2 = _popcount_sum(~(hi & w) & fmask)

    bmask = _bit_masks(off, SUBBITS)
    sent = u32(sub[..., S_SCNT]) + _popcount_sum(
        u32(sub[..., S_SBITS : S_SBITS + SUBBITS]) & bmask
    )
    if has_n:
        cn = _col_ncnt(has_n)
        ncnt = u32(sub[..., cn]) + _popcount_sum(
            u32(sub[..., cn + 1 : cn + 1 + SUBBITS]) & bmask
        )
    else:
        ncnt = torch.zeros_like(sent)

    le0 = u32(sub[..., S_LE + 0]) + le0 - sent - ncnt
    le1 = u32(sub[..., S_LE + 1]) + le1 - sent - ncnt
    le2 = u32(sub[..., S_LE + 2]) + le2 - sent - ncnt
    le3 = p - sent - ncnt
    occ = [le0, le1 - le0, le2 - le1, le3 - le2]
    if has_n:
        occ.append(ncnt)
    return torch.stack(occ, dim=-1) & MASK32, sent & MASK32


def _half_sub(rows: torch.Tensor, q: torch.Tensor, p: torch.Tensor, subw: int):
    """Select the sub-row of a paired row that covers position p.

    Correct iff (p >> 9) - q <= 1 (the caller's `far` contract)."""
    half = ((p >> 9) - q) > 0
    return torch.where(half[..., None], rows[..., subw:], rows[..., :subw])


def _fmd_tail(C, occ_lo, occ_hi, sent_lo, sent_hi, olo):
    """Shared FMD extension arithmetic from the two bounds' counts.
    `C` is the int64 C array; all values are int64 mod 2^32."""
    occ_sl = occ_hi - occ_lo  # per-char counts in the slice [..., A]
    sent_sl = sent_hi - sent_lo
    A = occ_lo.shape[-1]

    new_mlo = C[:A] + occ_lo
    new_size = occ_sl

    # companion offsets: suffix sums of real-char slice counts
    o2 = occ_sl[..., 3]
    o1 = o2 + occ_sl[..., 2]
    o0 = o1 + occ_sl[..., 1]
    offs = [o0, o1, o2, torch.zeros_like(o2)]
    if A == 5:
        offs.append(o0 + occ_sl[..., 0])
    new_olo = olo[..., None] + sent_sl[..., None] + torch.stack(offs, dim=-1)
    return new_mlo & MASK32, new_size & MASK32, new_olo & MASK32


def extend_core(index: DeviceIndex, mlo, size, olo):
    """FMD extension by every candidate character, EXACT for any interval
    size: one paired row per bound (first half used).  Inputs and outputs
    are int64 values mod 2^32; outputs are per DESCENDED char [..., A]."""
    p = torch.stack([mlo, (mlo + size) & MASK32])
    rows = index.fwd_blocks[p >> 9]
    subw = sub_width(index.has_n)
    occ, sent = _occ_sub(rows[..., :subw], p, index.has_n)
    return _fmd_tail(u32(index.C), occ[0], occ[1], sent[0], sent[1], olo)


def extend_core_fast(index: DeviceIndex, mlo, size, olo):
    """One-row FMD extension: exact iff the interval fits the 1024-symbol
    window of the row at mlo >> 9 (always for size <= 512).

    Returns (new_mlo, new_size, new_olo, far): `far` marks states whose
    results are NOT valid (interval too wide for the window) — the caller
    discards them and escalates the block to an exact tier."""
    q = mlo >> 9
    rows = index.fwd_blocks[q]
    subw = sub_width(index.has_n)
    hi = (mlo + size) & MASK32
    far = ((hi >> 9) - q) > 1
    occ_lo, sent_lo = _occ_sub(rows[..., :subw], mlo, index.has_n)
    occ_hi, sent_hi = _occ_sub(_half_sub(rows, q, hi, subw), hi, index.has_n)
    nmlo, nsize, nolo = _fmd_tail(u32(index.C), occ_lo, occ_hi, sent_lo,
                                  sent_hi, olo)
    return nmlo, nsize, nolo, far


# ---------------------------------------------------------------------------
# Dimer (two symbols per row read) rank path.  Layout: index/fmindex.py
# build_dimer_rows.  Candidate axis: code = c2*4 + c1 for the prepended dimer
# c1c2 (c2 next to the current pattern).
# ---------------------------------------------------------------------------

_M1 = 0x11111111


def _nibble_mask(nf: torch.Tensor) -> torch.Tensor:
    """Mask of the 4-bit fields < nf of one word (nf: int64 in 0..8)."""
    return (torch.ones_like(nf) << (4 * nf)) - 1


def _dimer_occ(sub: torch.Tensor, p: torch.Tensor):
    """All-threshold counts at p from its covering 64-word dimer sub-row.

    `sub` is [..., D_WIDTH] int32 bits, `p` int64.  Returns (L [..., 16],
    Lm [..., 4], flag [...]) as int64 values mod 2^32 and a bool:
      L[t]  = #rows < p with a valid dimer code <= t
      Lm[y] = #rows < p with a real ACGT BWT char <= y
      flag  = the sub-block holds a sentinel/N-adjacent row (bit 31 of the
              first mono count, masked off before that word is a count)
    The in-tail counts compare every 4-bit field below p with each code
    (nibble-equality masks and a popcount); masked-out fields never count,
    so code 0 does not pick up the zeroed fields past p."""
    dev = p.device
    off = p & 127
    d = off >> 4  # 16-symbol group of p
    tail = off & 15
    fields = u32(sub[..., 0:16])
    w0 = fields.gather(-1, (2 * d)[..., None])
    w1 = fields.gather(-1, (2 * d + 1)[..., None])
    # delta bytes of group d: byte t of the 4-word group d-1 (zero for d = 0)
    dw = u32(sub[..., D_DELTA : D_DELTA + 28]).reshape(*sub.shape[:-1], 7, 4)
    g = (d - 1).clamp(min=0)[..., None, None].expand(*d.shape, 1, 4)
    dsel = torch.where((d > 0)[..., None], dw.gather(-2, g)[..., 0, :], 0)
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=dev)
    dbytes = ((dsel[..., :, None] >> shifts) & 0xFF).reshape(*dsel.shape[:-1], 16)

    m0 = _nibble_mask(tail.clamp(0, 8)) & _M1
    m1 = _nibble_mask((tail - 8).clamp(0, 8)) & _M1
    pat = torch.arange(16, dtype=torch.int64, device=dev) * _M1

    def eq(w, m):  # per code: 1 bits at the fields equal to it, below p
        x = w ^ pat
        return ~(x | (x >> 1) | (x >> 2) | (x >> 3)) & m[..., None]

    cnt = popcount32(eq(w0, m0)) + popcount32(eq(w1, m1))
    inblk = dbytes + torch.cumsum(cnt, dim=-1)
    L = (u32(sub[..., D_CUM : D_CUM + 16]) + inblk) & MASK32
    mono = u32(sub[..., D_MONO : D_MONO + 4])
    flag = (mono[..., 0] >> 31) == 1
    mono = torch.cat([mono[..., :1] & 0x7FFFFFFF, mono[..., 1:]], dim=-1)
    Lm = (mono + inblk[..., 3::4]) & MASK32
    return L, Lm, flag


def _dimer_tail(index: DeviceIndex, L_lo, L_hi, Lm_lo, Lm_hi, olo):
    """FMD results from the two bounds' threshold counts (valid only for
    unflagged sub-blocks, where the sentinel and N terms vanish).

    Dimer candidates [..., 16] (code = c2*4 + c1):
      mlo[code] = C2[code] + (L_code - L_code-1)(lo), size = the slice's
      difference, olo[code] = olo + (L_15 - L_code)(slice).
    Mono candidates [..., A] (prepended char y): the same from the mono les
    (thresholds 3, 7, 11, 15); the N candidate (A = 5) has size 0."""

    def diff(x):
        return (x - torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)) & MASK32

    S = (L_hi - L_lo) & MASK32
    d_mlo = (u32(index.C2) + diff(L_lo)) & MASK32
    d_size = diff(S)
    d_olo = (olo[..., None] + S[..., 15:16] - S) & MASK32
    Sm = (Lm_hi - Lm_lo) & MASK32
    m = [(u32(index.C[:4]) + diff(Lm_lo)) & MASK32, diff(Sm),
         (olo[..., None] + Sm[..., 3:4] - Sm) & MASK32]
    if index.has_n:
        m = [torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1) for x in m]
    return (d_mlo, d_size, d_olo), tuple(m)


def extend_dimer_fast(index: DeviceIndex, mlo, size, olo):
    """One-row dimer + mono extension from the paired dimer row at mlo >> 7.

    Returns ((d_mlo, d_size, d_olo) [..., 16], (m_mlo, m_size, m_olo)
    [..., A], far): `far` marks states whose results are not valid, an
    interval wider than the row's 256-symbol window or a flagged sub-block
    read."""
    q = mlo >> 7
    rows = index.dimer_blocks[q]
    hi = (mlo + size) & MASK32
    dq = (hi >> 7) - q
    sub_hi = torch.where((dq > 0)[..., None], rows[..., D_WIDTH:], rows[..., :D_WIDTH])
    L0, Lm0, f0 = _dimer_occ(rows[..., :D_WIDTH], mlo)
    L1, Lm1, f1 = _dimer_occ(sub_hi, hi)
    dres, mres = _dimer_tail(index, L0, L1, Lm0, Lm1, olo)
    return dres, mres, (dq > 1) | f0 | f1


def extend_dimer(index: DeviceIndex, mlo, size, olo):
    """Two-row dimer + mono extension, exact for any interval width: one
    row per bound.  A sentinel/N-adjacent row inside a wide slice is missing
    from L_15, so `size != L_15(slice)` flags it (`far`) without reading the
    rows between the bounds."""
    hi = (mlo + size) & MASK32
    L0, Lm0, f0 = _dimer_occ(index.dimer_blocks[mlo >> 7, :D_WIDTH], mlo)
    L1, Lm1, f1 = _dimer_occ(index.dimer_blocks[hi >> 7, :D_WIDTH], hi)
    dres, mres = _dimer_tail(index, L0, L1, Lm0, Lm1, olo)
    return dres, mres, f0 | f1 | (((L1[..., 15] - L0[..., 15]) & MASK32) != size)


def rc_strand_count(index: DeviceIndex, p: torch.Tensor) -> torch.Tensor:
    """#SA rows in [0, p) whose suffix starts in the reverse-complement half
    (int64 p in, int64 count out).

    Splits an interval's occurrence count by strand: forward-strand
    occurrences of [lo, lo+size) = size - (rc(lo+size) - rc(lo))."""
    rows = index.strand_blocks[p >> 7]
    bmask = _bit_masks(p & 127, BVWORDS)
    return (u32(rows[..., 0]) + _popcount_sum(u32(rows[..., 1 : 1 + BVWORDS]) & bmask)) & MASK32


def bwt_char(sub: torch.Tensor, p: torch.Tensor, has_n: bool):
    """(code, is_sentinel) of BWT position p from its covering sub-row
    (int64 values; an N reads as code 4)."""
    off = p & 511
    word = u32(sub[..., S_WORDS : S_WORDS + SUBWORDS].gather(-1, (off >> 4)[..., None]))[..., 0]
    code = (word >> ((off & 15) * 2)) & 3
    bidx = (off >> 5)[..., None]
    bsh = off & 31
    sbit = (u32(sub[..., S_SBITS : S_SBITS + SUBBITS].gather(-1, bidx))[..., 0] >> bsh) & 1
    if has_n:
        cn = _col_ncnt(has_n)
        nbit = (u32(sub[..., cn + 1 : cn + 1 + SUBBITS].gather(-1, bidx))[..., 0] >> bsh) & 1
        code = torch.where(nbit == 1, 4, code)
    return code, sbit


def locate(index: DeviceIndex, pos: torch.Tensor, valid: torch.Tensor):
    """Resolve SA rows to (seq_no, seq_pos) via LF walks to a sampled row
    (the `locate` kernel; SeqAn's getOccurrences on the sampled compressed
    SA).  pos [N] int32 holding uint32, valid [N] uint8 masks padding rows.
    Sequence numbers are part-local (the caller maps them to global ids)."""
    from genmap_tpu_torch import kernels

    return kernels.locate(index, pos, valid)


# ---------------------------------------------------------------------------
# Seed tables
# ---------------------------------------------------------------------------


def with_seed_tables(index: DeviceIndex, t0: int | None = None) -> DeviceIndex:
    """Attach interval seed tables: the FMD interval of EVERY ACGT string of
    length 0..t0, levels concatenated (seed_level_offset).

    Every optimal search scheme starts with an exact block, so the first
    steps of every block's infix search descend one exact path — a pure
    function of the needle window — that one table lookup replaces.  Only
    (lo, size) are stored: the companion offset of w is seed_mlo[code(rc(w))]
    by strand symmetry.  Built by `kernels.seed_build` (on the card its
    kernel; on the CPU the level loop of the exact candidate step).  `t0`
    overrides the depth (the parts of a part mesh share the smallest).
    """
    from genmap_tpu_torch import kernels, tracing

    t0 = seed_depth(index.n_total) if t0 is None else t0
    with tracing.span("engine.seed_tables"):
        seed_mlo, seed_size = kernels.seed_build(index, t0)
    return replace(index, seed_mlo=seed_mlo, seed_size=seed_size, seed_t0=t0)


# ---------------------------------------------------------------------------
# Packed text and needle windows
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceText:
    """Device-resident 2-bit packed concatenated text (+ N mask).

    Needle windows are extracted on the device from block start positions,
    so a batch ships B uint32 starts instead of B x (K+J-1) needle bytes."""

    words: torch.Tensor  # [nw] int32 (uint32 bits), 16 x 2-bit codes per word
    nwords: torch.Tensor  # [nnw] int32 N-bit mask (empty for Dna4)
    limit: int  # total bases

    def resident_bytes(self) -> int:
        return 4 * (self.words.numel() + self.nwords.numel())

    @staticmethod
    def from_host(data: FMIndexData, device="cuda") -> "DeviceText":
        dev = resolve_device(device)
        return DeviceText(
            words=np_i32(data.text_words, dev),
            nwords=np_i32(data.text_nwords, dev),
            limit=data.text_len,
        )


def extract_needles(text: DeviceText, starts: torch.Tensor, Ln: int,
                    limit: int) -> torch.Tensor:
    """[B, Ln] uint8 needle windows of the packed text.

    `starts` are GLOBAL base positions ([B] int32 holding uint32); `limit` is
    the exclusive end of the current fasta file's bases — k-mers running
    past it read code 0 there, as the host-side extraction did."""
    from genmap_tpu_torch import kernels

    return kernels.extract_needles(text.words, text.nwords, starts, Ln,
                                   limit, text.limit)
