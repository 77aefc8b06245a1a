"""Bidirectional FMD-index as paired rank rows (on-disk and device layout).

This is the index format shared with the JAX package (`genmap_tpu`): the
port reads and writes byte-identical index directories, so the layout below
is kept as it is.  The BWT of the sentinel-separated concatenated text is
stored as *rank rows*; the hot rank/LF step reads the fewest, widest rows,
so rank data is stored as PAIRED rows:

  * a logical SUB-BLOCK covers 512 BWT symbols:
      cols  0..31  thirty-two uint32 words of 2-bit symbol codes
                   (16 symbols/word); N (code 4) and sentinels are stored as
                   code 0 in the words and marked in separate bitvectors
      cols 32..34  absolute counts at block start of fields <=0, <=1, <=2
      col   35     absolute sentinel count at block start
      cols 36..51  sentinel bitvector (16 x 32 bits)
      [Dna5 only]
      col   52     absolute N count at block start
      cols 53..68  N bitvector
  * the STORED/GATHERED row i is the concatenation of sub-blocks i and i+1,
    covering symbols [512*i, 512*i + 1024).

One paired-row gather at row lo>>9 answers rank queries at BOTH interval
bounds whenever hi = lo + size lies within the next sub-block — always true
for size <= 512.  The search engine's fast path exploits this (one gather
per state instead of two, ops/rank.py extend_core_fast); wide-interval
states fall back to an exact two-gather path via tier escalation
(search/engine.py).

True per-character prefix counts are recovered by subtracting sentinel/N
counts from the raw field counts (N never collides: it is the *last* symbol in
the order A<C<G<T<N, so `smaller-than` counts for bidirectional synchronisation
never need N-specific prefix ranks).

Because the text always contains BOTH strands, bidirectional search needs only
this ONE table (the FMD trick, cf. Heng Li's fermi FMD-index): appending char
c on the right of a pattern P equals prepending comp(c) to rc(P), whose
interval lives in the same BWT.  The reference instead keeps a second BWT of
the reversed text (GenMap src/genmap_helper.hpp:88-95); dropping it
halves index memory and construction work.

Genomes whose both-strand symbol count would exceed uint32 range are split
into PARTS: groups of whole input sequences, each with its own FMD table over
its sequences + their reverse complements.  Occurrence counts are exact under
this split (matches never cross sequence boundaries), so per-part counts
simply add up — this is also the multi-chip sharding axis (one part per
device group, merged with psum).  The reference instead dispatches to wider
integer types (GenMap src/indexing.hpp:151-170).

The suffix array is sampled in text order (i2 % sampling == 0), skipping
sentinel positions, with an indicator bitvector over SA rows — the same
sampling scheme as GenMap src/seqan_libdivsufsort.h:106-147.  The
indicator and the strand bitvector live in their own small 128-symbol rank
rows (only `locate` / strand splitting read them).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

BLOCK = 512  # symbols per logical sub-block
SUBWORDS = BLOCK // 16  # 2-bit words per sub-block (32)
SUBBITS = BLOCK // 32  # bitvector words per sub-block (16)

# sub-block column offsets
S_WORDS = 0
S_LE = SUBWORDS  # 32..34
S_SCNT = SUBWORDS + 3  # 35
S_SBITS = SUBWORDS + 4  # 36..51
_SUB_BASE = SUBWORDS + 4 + SUBBITS  # 52

# auxiliary bitvector rank rows (strand / SA-sampling indicator) keep a
# smaller 128-symbol geometry: [count, 4 bit words] per row
BVBLOCK = 128
BVWORDS = BVBLOCK // 32  # 4

# chunk size (in BLOCK-aligned symbols) for bounded-memory construction
_CHUNK = 64 * 1024 * 1024

# ---------------------------------------------------------------------------
# Dimer (2-symbols-per-LF-step) rank rows.
#
# The search engine's time is bound by rank-row reads: every
# consumed pattern character costs ~1 row gather per live state.  A dimer
# table serves TWO characters per gather: for rows r of the BWT define
# code(r) = BWT[r]*4 + BWT2[r] (BWT2[r] = the char two before the suffix,
# i.e. ctext[SA[r]-2]); then the interval of c1c2·W follows from prefix
# counts of code c2*4+c1 over [0, lo) exactly like a mono LF step
# (the classic multi-step FM-index identity:
#    Occ_{c1}(C[c2] + Occ_{c2}(r)) = Occ_{c1}(C[c2]) + Occ2_{c1c2}(r) ).
# With the BWT-char-MAJOR code order, every FMD quantity reduces to
# "count of codes <= t" (le) thresholds:
#    new_mlo[c1c2]  = C2[c1c2] + (L_code - L_{code-1})(lo)
#    new_size[c1c2] = (L_code - L_{code-1})(hi..lo slice)
#    new_olo[c1c2]  = olo + (L_15 - L_code)(slice)
# and the mono les are the thresholds t = 4y+3.
#
# Rows adjacent to a sentinel or an N (BWT or BWT2 in {sentinel, N}) carry no
# valid dimer code; sub-blocks containing any such row are FLAGGED and a
# query touching a flagged sub-block escalates the block to a mono tier
# (search/engine.py) — there are only O(#sequences + #N-run-boundaries) such
# rows in the whole index, so escalation is negligible and the dimer path
# stays exact for both Dna4 and Dna5.
#
# Sub-block layout (128 symbols, 64 uint32 words; gathered rows are PAIRS of
# adjacent sub-blocks = 512 B, same pairing trick as the mono rows):
#   w[0:16]   4-bit dimer codes, 8 per word (invalid rows stored as 0)
#   w[16:32]  cumulative le counts L_0..L_15 at sub-block start
#             (#rows < start with a VALID dimer code <= t; L_15 = all valid)
#   w[32:60]  le deltas at 16-symbol boundaries, d-MAJOR so a query extracts
#             all 16 thresholds with one one-hot word-group select + static
#             byte shifts:
#             byte 16*(d-1)+t of this region = #codes <= t within symbols
#             [0, 16d), d = 1..7
#   w[60:64]  cumulative mono le counts (#rows < start with BWT real and
#             <= y), y = 0..3; bit 31 of w[60] = sub-block flag
# The flag bit steals bit 31 of a count, so dimer rows require the part's
# n_total < 2^31.  build_index keeps its default fewest-parts partitioning
# (part count scales per-batch query cost) and skips dimer rows for parts
# over the limit with a loud warning; build_index(dimer_parts=True) caps
# parts at DIMER_PART_LIMIT instead so the dimer path stays available.
# ---------------------------------------------------------------------------

DBLOCK = 128  # symbols per dimer sub-block
D_FIELDS = 0
D_CUM = 16
D_DELTA = 32
D_MONO = 60
D_WIDTH = 64
DIMER_PART_LIMIT = 2**31 - 2


def build_dimer_rows(
    bwt: np.ndarray, sbits: np.ndarray, bwt2: np.ndarray, s2bits: np.ndarray
) -> np.ndarray:
    """Dimer rank sub-rows from the BWT and the 2-back BWT stream.

    `bwt`/`bwt2` are real symbol codes 0..4 (4 = N; value irrelevant where the
    corresponding sentinel bit is set); `sbits`/`s2bits` mark sentinels.
    """
    n = int(len(bwt))
    assert n < 2**31, "dimer rows need part n_total < 2^31 (flag bit)"
    nblocks = n // DBLOCK + 1
    out = np.zeros((nblocks, D_WIDTH), dtype=np.uint32)

    cum = np.zeros(16, dtype=np.uint64)
    cum_mono = np.zeros(4, dtype=np.uint64)

    for c0 in range(0, nblocks * DBLOCK, _CHUNK):
        c1 = min(c0 + _CHUNK, nblocks * DBLOCK)
        b0, b1 = c0 // DBLOCK, c1 // DBLOCK
        nb = b1 - b0
        m = c1 - c0
        take = max(0, min(c1, n) - c0)
        bw = np.zeros(m, dtype=np.uint8)
        bw2 = np.zeros(m, dtype=np.uint8)
        sb = np.zeros(m, dtype=bool)
        sb2 = np.zeros(m, dtype=bool)
        real = np.zeros(m, dtype=bool)  # row index < n
        if take:
            bw[:take] = bwt[c0 : c0 + take]
            bw2[:take] = bwt2[c0 : c0 + take]
            sb[:take] = sbits[c0 : c0 + take]
            sb2[:take] = s2bits[c0 : c0 + take]
            real[:take] = True

        valid = real & ~sb & ~sb2 & (bw < 4) & (bw2 < 4)
        code = np.where(valid, bw * 4 + bw2, 0).astype(np.uint8)
        mono_real = real & ~sb & (bw < 4)
        flag = (real & ~valid).reshape(nb, DBLOCK).any(axis=1)

        # pack 4-bit fields, 8 per word
        cc = code.astype(np.uint32).reshape(nb, 16, 8)
        out[b0:b1, D_FIELDS : D_FIELDS + 16] = np.bitwise_or.reduce(
            cc << (4 * np.arange(8, dtype=np.uint32))[None, None, :], axis=-1
        )

        # per-16-symbol-prefix le counts (deltas) + per-block totals
        vcode = np.where(valid, code, 16).astype(np.uint8)  # invalid -> bin 16
        hist16 = np.zeros((nb, 8, 17), dtype=np.int32)
        v16 = vcode.reshape(nb, 8, 16)
        for t in range(17):
            hist16[:, :, t] = (v16 == t).sum(axis=2)
        le16 = np.cumsum(hist16[:, :, :16], axis=2)  # counts per 16-sym group
        ple = np.cumsum(le16, axis=1)  # prefix over groups: [0,16(d+1))
        # delta bytes, d-major: region byte offset 16*(d-1) + t, d = 1..7
        dbytes = ple[:, :7, :].astype(np.uint8)
        dw = dbytes.reshape(nb, 28, 4).astype(np.uint32)
        out[b0:b1, D_DELTA : D_DELTA + 28] = np.bitwise_or.reduce(
            dw << (8 * np.arange(4, dtype=np.uint32))[None, None, :], axis=-1
        )

        per_block = ple[:, 7, :].astype(np.uint64)  # [nb, 16] block totals
        cum_after = cum[None, :] + np.cumsum(per_block, axis=0)
        out[b0:b1, D_CUM : D_CUM + 16] = np.concatenate(
            [cum[None, :], cum_after[:-1]], axis=0
        ).astype(np.uint32)
        cum = cum_after[-1]

        mc = np.where(mono_real, bw, 4).astype(np.uint8)
        mhist = np.zeros((nb, 4), dtype=np.int64)
        mb = mc.reshape(nb, DBLOCK)
        for y in range(4):
            mhist[:, y] = (mb == y).sum(axis=1)
        mle = np.cumsum(mhist, axis=1).astype(np.uint64)
        mcum_after = cum_mono[None, :] + np.cumsum(mle, axis=0)
        mono_rows = np.concatenate(
            [cum_mono[None, :], mcum_after[:-1]], axis=0
        ).astype(np.uint32)
        cum_mono = mcum_after[-1]
        mono_rows[:, 0] |= flag.astype(np.uint32) << 31
        out[b0:b1, D_MONO : D_MONO + 4] = mono_rows

    return out


def sub_width(has_n: bool) -> int:
    return _SUB_BASE + (1 + SUBBITS) * int(has_n)


def _col_ncnt(has_n: bool) -> int:
    return _SUB_BASE  # valid only when has_n


def wide_rows(sub: np.ndarray) -> np.ndarray:
    """Paired gather rows: wide[i] = concat(sub[i], sub[i+1]) (zero pad row).

    The pad half is never addressed by a valid query (half 1 at the last row
    would need a position > n), it only keeps the layout rectangular.
    """
    nxt = np.vstack([sub[1:], np.zeros((1, sub.shape[1]), np.uint32)])
    return np.ascontiguousarray(np.hstack([sub, nxt]))


@dataclass
class RankRows:
    """Rank sub-rows for one BWT (paired into gather rows on device)."""

    blocks: np.ndarray  # [nblocks, sub_width] uint32 sub-rows
    has_n: bool
    length: int  # number of BWT symbols (= text length incl. sentinels)

    @property
    def ncols(self) -> int:
        return sub_width(self.has_n)


def _pack_words(codes2: np.ndarray, nblocks: int) -> np.ndarray:
    """Pack 2-bit codes [nblocks*BLOCK] into uint32 words [nblocks, SUBWORDS]."""
    c = codes2.astype(np.uint32).reshape(nblocks, SUBWORDS, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    out = c << shifts
    return np.bitwise_or.reduce(out, axis=-1)


def _pack_bits(bits: np.ndarray, nblocks: int) -> np.ndarray:
    """Pack bool bits [nblocks*BLOCK] into uint32 words [nblocks, SUBBITS]."""
    b = bits.astype(np.uint32).reshape(nblocks, SUBBITS, 32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    return np.bitwise_or.reduce(b << shifts, axis=-1)


def _exclusive_cumsum_into(per_block: np.ndarray, out: np.ndarray) -> None:
    """out[i] = sum(per_block[:i]) as uint32 (counts fit by construction)."""
    acc = np.cumsum(per_block, dtype=np.uint64)
    out[0] = 0
    out[1:] = acc[:-1].astype(np.uint32)


def build_rank_rows(bwt: np.ndarray, sbits: np.ndarray, has_n: bool) -> RankRows:
    """Build rank sub-rows from BWT codes (0..4) and sentinel bits.

    `bwt[i]` is the real symbol code at BWT position i (value irrelevant where
    `sbits[i]` is set).  Processes the input in bounded chunks so
    multi-gigabase BWTs don't blow up host memory with full-length
    temporaries.
    """
    n = int(len(bwt))
    nblocks = n // BLOCK + 1  # always one extra row so queries at p == n work

    ncols = sub_width(has_n)
    blocks = np.zeros((nblocks, ncols), dtype=np.uint32)
    # per-block counts, accumulated chunk by chunk, cumsum'd at the end
    le_pb = np.zeros((3, nblocks), dtype=np.uint32)
    s_pb = np.zeros(nblocks, dtype=np.uint32)
    n_pb = np.zeros(nblocks, dtype=np.uint32) if has_n else None

    cn = _col_ncnt(has_n)
    for c0 in range(0, nblocks * BLOCK, _CHUNK):
        c1 = min(c0 + _CHUNK, nblocks * BLOCK)
        b0, b1 = c0 // BLOCK, c1 // BLOCK
        m = c1 - c0
        bwt_p = np.zeros(m, dtype=np.uint8)
        sbits_p = np.zeros(m, dtype=bool)
        take = max(0, min(c1, n) - c0)
        if take:
            bwt_p[:take] = bwt[c0 : c0 + take]
            sbits_p[:take] = sbits[c0 : c0 + take]
        nb = b1 - b0

        codes2 = np.where((bwt_p >= 4) | sbits_p, 0, bwt_p).astype(np.uint8)
        blocks[b0:b1, S_WORDS : S_WORDS + SUBWORDS] = _pack_words(codes2, nb)
        c2 = codes2.reshape(nb, BLOCK)
        for k in range(3):
            le_pb[k, b0:b1] = (c2 <= k).sum(axis=1, dtype=np.uint32)

        sb = sbits_p.reshape(nb, BLOCK)
        s_pb[b0:b1] = sb.sum(axis=1, dtype=np.uint32)
        blocks[b0:b1, S_SBITS : S_SBITS + SUBBITS] = _pack_bits(sbits_p, nb)

        if has_n:
            nbits_p = (bwt_p == 4) & ~sbits_p
            n_pb[b0:b1] = nbits_p.reshape(nb, BLOCK).sum(axis=1, dtype=np.uint32)
            blocks[b0:b1, cn + 1 : cn + 1 + SUBBITS] = _pack_bits(nbits_p, nb)

    for k in range(3):
        _exclusive_cumsum_into(le_pb[k], blocks[:, S_LE + k])
    _exclusive_cumsum_into(s_pb, blocks[:, S_SCNT])
    if has_n:
        _exclusive_cumsum_into(n_pb, blocks[:, cn])

    return RankRows(blocks=blocks, has_n=has_n, length=n)


@dataclass
class IndexPart:
    """One FMD sub-index over a contiguous group of input sequences.

    Covers input sequences [seq_off, seq_off + nseq_part) plus their reverse
    complements (local sequence ids nseq_part..2*nseq_part-1 in the same
    order).
    """

    fwd: RankRows
    C: np.ndarray  # [6] uint64: C[c] = 2*nseq_part + #chars < c ; C[5] = n_total
    sa_i1: np.ndarray  # sampled SA values, local sequence number (uint32)
    sa_i2: np.ndarray  # sampled SA values, sequence position (uint32)
    # rank rows of the strand bitvector over SA rows (rc-half suffixes):
    # [nblocks128, 5] uint32 = absolute count + 4 bitvector words per 128 rows
    strand_blocks: np.ndarray
    # rank rows of the SA-sampling indicator bitvector (same [nblocks128, 5]
    # layout); only `locate` reads these
    ind_blocks: np.ndarray
    seq_off: int
    nseq_part: int
    # optional dimer rank rows (2-symbols-per-step fast path, see
    # build_dimer_rows) + the 16-entry C2 array: C2[c2*4+c1] = SA start of
    # the interval of the string c1c2
    dimer: np.ndarray | None = None
    C2: np.ndarray | None = None
    # fraction of flagged (sentinel/N-adjacent) dimer sub-blocks; the engine
    # only schedules the dimer tier when this is tiny (flagged hits escalate
    # whole blocks, so dense flags would make the tier pure overhead)
    dimer_flag_frac: float = 1.0

    @property
    def n_total(self) -> int:
        return int(self.C[5])


@dataclass
class FMIndexData:
    """Host-side FMD-index (one or more parts) + metadata.

    Equivalent capability to the reference's persisted index directory
    (.txt/.sa/.lf/.rev.lf fibres + index.info + index.ids,
    GenMap src/genmap_helper.hpp:71-127) in a row-gather-friendly layout.
    """

    alphabet_size: int  # 4 or 5
    sampling: int
    directory: bool  # was the index built from a fasta directory?
    parts: list  # list[IndexPart]
    # directory information: per INPUT sequence (the rc half is implicit)
    seq_files: list[str]  # source fasta file name per sequence
    seq_names: list[str]
    seq_lens: np.ndarray  # uint64
    # packed concatenated text (no sentinels): 2-bit words + N bitmask words
    text_words: np.ndarray  # uint32
    text_nwords: np.ndarray  # uint32 (empty for Dna4)
    text_len: int

    @property
    def has_n(self) -> bool:
        return self.alphabet_size == 5

    @property
    def nseq(self) -> int:
        return len(self.seq_names)

    # ---- text access -------------------------------------------------------

    def decode_text(self) -> np.ndarray:
        """Decode the packed concatenated text to uint8 codes 0..4."""
        return self.decode_slice(0, self.text_len)

    def decode_slice(self, start: int, length: int) -> np.ndarray:
        """Decode bases [start, start+length) without touching the rest of
        the packed text — the engine's dedup key pass reads one file's slice,
        and at hg38 scale a full decode is gigabytes of host RAM."""
        length = max(0, min(length, self.text_len - start))
        w0, w1 = start >> 4, (start + length + 15) >> 4
        shifts = 2 * np.arange(16, dtype=np.uint32)
        codes = (
            (self.text_words[w0:w1, None] >> shifts[None, :]) & np.uint32(3)
        ).astype(np.uint8).reshape(-1)[start - 16 * w0 :][:length]
        if self.has_n and len(self.text_nwords):
            b0, b1 = start >> 5, (start + length + 31) >> 5
            bshifts = np.arange(32, dtype=np.uint32)
            nbits = (
                (self.text_nwords[b0:b1, None] >> bshifts[None, :]) & np.uint32(1)
            ).astype(bool).reshape(-1)[start - 32 * b0 :][:length]
            codes = np.where(nbits, np.uint8(4), codes)
        return codes

    # ---- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "format_version": 5,  # v5: v4 + optional dimer rank rows
            "alphabet_size": self.alphabet_size,
            "sampling_rate": self.sampling,
            "fasta_directory": self.directory,
            "text_len": self.text_len,
            "parts": [
                {
                    "length": p.fwd.length,
                    "seq_off": p.seq_off,
                    "nseq_part": p.nseq_part,
                    "dimer": p.dimer is not None,
                    "dimer_flag_frac": p.dimer_flag_frac,
                }
                for p in self.parts
            ],
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        # .ids equivalent: fastaFile;length;chromName per sequence
        # (reference format: src/indexing.hpp:268-274)
        with open(os.path.join(path, "index.ids"), "w") as f:
            for fn, ln, nm in zip(self.seq_files, self.seq_lens, self.seq_names):
                f.write(f"{fn};{int(ln)};{nm}\n")
        for i, p in enumerate(self.parts):
            np.save(os.path.join(path, f"p{i}_blocks.npy"), p.fwd.blocks)
            np.save(os.path.join(path, f"p{i}_C.npy"), p.C)
            np.save(os.path.join(path, f"p{i}_sa_i1.npy"), p.sa_i1)
            np.save(os.path.join(path, f"p{i}_sa_i2.npy"), p.sa_i2)
            np.save(os.path.join(path, f"p{i}_strand.npy"), p.strand_blocks)
            np.save(os.path.join(path, f"p{i}_ind.npy"), p.ind_blocks)
            if p.dimer is not None:
                np.save(os.path.join(path, f"p{i}_dimer.npy"), p.dimer)
                np.save(os.path.join(path, f"p{i}_C2.npy"), p.C2)
        np.save(os.path.join(path, "text_words.npy"), self.text_words)
        np.save(os.path.join(path, "text_nwords.npy"), self.text_nwords)

    @staticmethod
    def load(path: str, mmap: bool = False) -> "FMIndexData":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version") not in (4, 5):
            raise ValueError(
                f"unsupported index format_version {meta.get('format_version')};"
                " rebuild the index with this version of genmap-tpu-torch"
            )
        mm = "r" if mmap else None
        seq_files, seq_names, seq_lens = [], [], []
        with open(os.path.join(path, "index.ids")) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                first = line.find(";")
                second = line.find(";", first + 1)
                seq_files.append(line[:first])
                seq_lens.append(int(line[first + 1 : second]))
                seq_names.append(line[second + 1 :])
        has_n = meta["alphabet_size"] == 5
        parts = []
        for i, pm in enumerate(meta["parts"]):
            fwd = RankRows(
                blocks=np.load(os.path.join(path, f"p{i}_blocks.npy"), mmap_mode=mm),
                has_n=has_n,
                length=pm["length"],
            )
            parts.append(
                IndexPart(
                    fwd=fwd,
                    C=np.load(os.path.join(path, f"p{i}_C.npy")),
                    sa_i1=np.load(os.path.join(path, f"p{i}_sa_i1.npy"), mmap_mode=mm),
                    sa_i2=np.load(os.path.join(path, f"p{i}_sa_i2.npy"), mmap_mode=mm),
                    strand_blocks=np.load(
                        os.path.join(path, f"p{i}_strand.npy"), mmap_mode=mm
                    ),
                    ind_blocks=np.load(
                        os.path.join(path, f"p{i}_ind.npy"), mmap_mode=mm
                    ),
                    seq_off=pm["seq_off"],
                    nseq_part=pm["nseq_part"],
                    dimer=np.load(os.path.join(path, f"p{i}_dimer.npy"), mmap_mode=mm)
                    if pm.get("dimer")
                    else None,
                    C2=np.load(os.path.join(path, f"p{i}_C2.npy"))
                    if pm.get("dimer")
                    else None,
                    dimer_flag_frac=pm.get("dimer_flag_frac", 1.0),
                )
            )
        return FMIndexData(
            alphabet_size=meta["alphabet_size"],
            sampling=meta["sampling_rate"],
            directory=meta["fasta_directory"],
            parts=parts,
            seq_files=seq_files,
            seq_names=seq_names,
            seq_lens=np.asarray(seq_lens, dtype=np.uint64),
            text_words=np.load(os.path.join(path, "text_words.npy"), mmap_mode=mm),
            text_nwords=np.load(os.path.join(path, "text_nwords.npy"), mmap_mode=mm),
            text_len=meta["text_len"],
        )
