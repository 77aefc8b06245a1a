"""Host-side index construction.

Pipeline (capability-equivalent to GenMap src/seqan_libdivsufsort.h:35-240
and GenMap src/indexing.hpp:73-148, re-designed around numpy bulk ops):

    partition input sequences into parts (whole-sequence groups whose
        both-strand symbol count fits uint32)
    per part:
        encode [seqs, rc(seqs)] with per-sequence sentinels (ord+1, sentinel=0)
        -> suffix array (native SA-IS)
        -> BWT + sentinel bitvector
        -> text-order sampled SA + indicator bitvector
        -> paired rank rows (see index/fmindex.py)

Because every part's text contains both strands, bidirectional search uses the
FMD trick on a single BWT — no reversed-text index is built (the reference
builds one: GenMap src/indexing.hpp:130-147).  All per-suffix
post-processing is chunked so peak host memory stays a small multiple of the
part size even for multi-gigabase parts.
"""

from __future__ import annotations

import json
import os

import numpy as np

from genmap_tpu_torch.index.fmindex import (
    BVBLOCK,
    BVWORDS,
    FMIndexData,
    IndexPart,
    build_rank_rows,
)
from genmap_tpu_torch.index.suffix import suffix_array
from genmap_tpu_torch.io.fasta import FastaFile

# max symbols (both strands + sentinels) per part: uint32 positions on device,
# and the SA-IS uint32 path needs n_part + 1 < 2^32 - 1
MAX_PART_SYMBOLS = 2**32 - 4

_CHUNK = 64 * 1024 * 1024


def _make_ctext(seqs: list[np.ndarray]) -> np.ndarray:
    """Concatenate code arrays with ord+1 encoding and sentinel 0 after each."""
    total = sum(len(s) for s in seqs) + len(seqs)
    ctext = np.empty(total, dtype=np.uint8)
    pos = 0
    for s in seqs:
        ctext[pos : pos + len(s)] = s + 1
        pos += len(s)
        ctext[pos] = 0
        pos += 1
    return ctext


def _pack_text(seqs: list[np.ndarray], has_n: bool) -> tuple[np.ndarray, np.ndarray, int]:
    codes = np.concatenate(seqs) if seqs else np.empty(0, dtype=np.uint8)
    n = len(codes)
    npad = (-n) % 16
    c2 = np.concatenate([np.where(codes >= 4, 0, codes), np.zeros(npad, np.uint8)])
    c2 = c2.astype(np.uint64).reshape(-1, 16)
    words = (c2 << (2 * np.arange(16, dtype=np.uint64))[None, :]).sum(axis=-1)
    words = words.astype(np.uint32)
    if has_n:
        bpad = (-n) % 32
        nb = np.concatenate([(codes == 4), np.zeros(bpad, bool)]).astype(np.uint64)
        nb = nb.reshape(-1, 32)
        nwords = (nb << np.arange(32, dtype=np.uint64)[None, :]).sum(axis=-1)
        nwords = nwords.astype(np.uint32)
    else:
        nwords = np.empty(0, dtype=np.uint32)
    return words, nwords, n


def _bitvec_rank_rows(bits: np.ndarray) -> np.ndarray:
    """[nblocks, 5] uint32 rank rows (absolute count + 4 words) of a bitvector.

    These 128-symbol rows serve the strand / SA-indicator bitvectors (cold
    paths: locate and strand splitting), not the hot rank rows."""
    n = len(bits)
    nblocks = n // BVBLOCK + 1
    out = np.zeros((nblocks, 1 + BVWORDS), dtype=np.uint32)
    per_block = np.zeros(nblocks, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    for c0 in range(0, nblocks * BVBLOCK, _CHUNK):
        c1 = min(c0 + _CHUNK, nblocks * BVBLOCK)
        b0, b1 = c0 // BVBLOCK, c1 // BVBLOCK
        m = c1 - c0
        bp = np.zeros(m, dtype=bool)
        take = max(0, min(c1, n) - c0)
        if take:
            bp[:take] = bits[c0 : c0 + take]
        nb = b1 - b0
        per_block[b0:b1] = bp.reshape(nb, BVBLOCK).sum(axis=1, dtype=np.uint32)
        b = bp.astype(np.uint32).reshape(nb, BVWORDS, 32)
        out[b0:b1, 1:] = np.bitwise_or.reduce(b << shifts, axis=-1)
    acc = np.cumsum(per_block, dtype=np.uint64)
    out[0, 0] = 0
    out[1:, 0] = acc[:-1].astype(np.uint32)
    return out


def _build_part(
    seqs: list[np.ndarray], sampling: int, has_n: bool, seq_off: int,
    dimer: bool = True,
) -> IndexPart:
    """Build one FMD sub-index over seqs + their reverse complements."""
    from genmap_tpu_torch.alphabet import revcomp_codes

    from genmap_tpu_torch.hostmem import retain_heap

    retain_heap()

    nseq_g = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    all_lens = np.concatenate([lens, lens])
    nseq_all = 2 * nseq_g
    n_total = int(all_lens.sum()) + nseq_all

    all_seqs = seqs + [revcomp_codes(s) for s in seqs]
    ctext = _make_ctext(all_seqs)
    assert len(ctext) == n_total
    sa = suffix_array(ctext)
    n = n_total

    starts = np.zeros(nseq_all + 1, dtype=np.int64)  # ctext start of each sequence
    starts[1:] = np.cumsum(all_lens + 1)
    # match dtypes to the SA's: mixed-dtype searchsorted/arithmetic hits slow
    # numpy paths and spawns wide temporaries (costly on this host, see
    # hostmem.py)
    sd = sa.dtype
    starts_c = starts.astype(sd)
    all_lens_c = all_lens.astype(sd)

    use_dimer = dimer and n < 2**31
    bwt = np.empty(n, dtype=np.uint8)
    sbits = np.empty(n, dtype=bool)
    bwt2 = np.empty(n, dtype=np.uint8) if use_dimer else None
    s2bits = np.empty(n, dtype=bool) if use_dimer else None
    ind = np.empty(n, dtype=bool)
    strand_bits = np.empty(n, dtype=bool)
    char_counts = np.zeros(6, dtype=np.uint64)
    n_sampled = 0
    for c0 in range(0, n, _CHUNK):
        c1 = min(c0 + _CHUNK, n)
        sac = sa[c0:c1]
        prev = sac - sd.type(1)  # wraps at 0; fixed up next line
        prev[sac == 0] = sd.type(n - 1)
        bwt_c = ctext[prev]
        sb = bwt_c == 0
        bwt[c0:c1] = np.where(sb, 0, bwt_c - 1)
        sbits[c0:c1] = sb
        char_counts += np.bincount(bwt_c, minlength=6).astype(np.uint64)
        if use_dimer:
            prev[prev == 0] = sd.type(n)
            prev -= sd.type(1)
            bwt2_c = ctext[prev]
            s2b = bwt2_c == 0
            bwt2[c0:c1] = np.where(s2b, 0, bwt2_c - 1)
            s2bits[c0:c1] = s2b

        i1 = np.searchsorted(starts_c, sac, side="right") - 1
        i2 = sac - starts_c[i1]
        is_sent = i2 == all_lens_c[np.minimum(i1, nseq_all - 1)]
        indc = (~is_sent) & (i2 % sd.type(sampling) == 0)
        ind[c0:c1] = indc
        n_sampled += int(indc.sum())
        strand_bits[c0:c1] = i1 >= nseq_g

    # sampled SA in text order (i2 % sampling == 0), skip sentinel rows
    sa_i1 = np.empty(n_sampled, dtype=np.uint32)
    sa_i2 = np.empty(n_sampled, dtype=np.uint32)
    w = 0
    for c0 in range(0, n, _CHUNK):
        c1 = min(c0 + _CHUNK, n)
        indc = ind[c0:c1]
        sac = sa[c0:c1][indc]
        i1 = np.searchsorted(starts_c, sac, side="right") - 1
        i2 = sac - starts_c[i1]
        m = len(sac)
        sa_i1[w : w + m] = i1.astype(np.uint32)
        sa_i2[w : w + m] = i2.astype(np.uint32)
        w += m
    del sa

    fwd = build_rank_rows(bwt, sbits, has_n)
    strand_blocks = _bitvec_rank_rows(strand_bits)
    ind_blocks = _bitvec_rank_rows(ind)

    dimer_blocks = None
    C2 = None
    if use_dimer:
        from genmap_tpu_torch.index.fmindex import build_dimer_rows

        dimer_blocks = build_dimer_rows(bwt, sbits, bwt2, s2bits)
        del bwt2, s2bits
        dimer_flag_frac = float(
            ((dimer_blocks[:, 60] >> 31) & 1).mean()
        )

    # C array over real symbols, sentinels smallest (char_counts[0] counts
    # sentinel bytes; real chars are stored shifted by one in ctext)
    C = np.zeros(6, dtype=np.uint64)
    C[0] = nseq_all
    np.cumsum(char_counts[1:], out=C[1:])
    C[1:] += nseq_all
    assert C[5] == n_total

    if use_dimer:
        # C2[c2*4+c1] = SA start of the interval of the string "c1 c2"
        #   = C[c1] + #(c1 at a sequence end) + sum_{c<c2} #text dimers (c1,c)
        paircnt = np.zeros((6, 6), dtype=np.int64)
        endcnt = np.zeros(4, dtype=np.int64)
        for c0 in range(0, n - 1, _CHUNK):
            c1_ = min(c0 + _CHUNK, n - 1)
            a = ctext[c0 : c1_].astype(np.int64)
            b = ctext[c0 + 1 : c1_ + 1].astype(np.int64)
            paircnt += np.bincount(a * 6 + b, minlength=36).reshape(6, 6)
        endcnt = paircnt[1:5, 0]
        C2 = np.zeros(16, dtype=np.uint32)
        for cc1 in range(4):
            acc = int(C[cc1]) + int(endcnt[cc1])
            for cc2 in range(4):
                C2[cc2 * 4 + cc1] = acc
                acc += int(paircnt[cc1 + 1, cc2 + 1])

    return IndexPart(
        fwd=fwd,
        C=C,
        sa_i1=sa_i1,
        sa_i2=sa_i2,
        strand_blocks=strand_blocks,
        ind_blocks=ind_blocks,
        seq_off=seq_off,
        nseq_part=nseq_g,
        dimer=dimer_blocks,
        C2=C2,
        dimer_flag_frac=dimer_flag_frac if use_dimer else 1.0,
    )


def _partition(lens: np.ndarray, limit: int) -> list[tuple[int, int]]:
    """Greedy contiguous grouping: each group's 2*(sum(len)+count) <= limit."""
    groups = []
    i, nseq = 0, len(lens)
    while i < nseq:
        s = i
        tot = 0
        while i < nseq and (s == i or 2 * (tot + int(lens[i]) + 1) <= limit):
            if 2 * (int(lens[i]) + 1) > limit:
                raise ValueError(
                    f"sequence {i} is too long for a single index part "
                    f"({int(lens[i])} bases; limit {limit // 2 - 1})"
                )
            tot += int(lens[i]) + 1
            i += 1
        groups.append((s, i))
    return groups


def _build_part_to_dir(args) -> str:
    """Worker: build one part and spill it to `out_dir` (npy files).

    Returning multi-GB arrays through pickle pipes is slower than disk on
    this host; the parent mmap-loads the spilled arrays instead.
    """
    seqs, sampling, has_n, seq_off, dimer, out_dir = args
    part = _build_part(seqs, sampling, has_n, seq_off, dimer=dimer)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "blocks.npy"), part.fwd.blocks)
    np.save(os.path.join(out_dir, "C.npy"), part.C)
    np.save(os.path.join(out_dir, "sa_i1.npy"), part.sa_i1)
    np.save(os.path.join(out_dir, "sa_i2.npy"), part.sa_i2)
    np.save(os.path.join(out_dir, "strand.npy"), part.strand_blocks)
    np.save(os.path.join(out_dir, "ind.npy"), part.ind_blocks)
    if part.dimer is not None:
        np.save(os.path.join(out_dir, "dimer.npy"), part.dimer)
        np.save(os.path.join(out_dir, "C2.npy"), part.C2)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {"length": part.fwd.length, "seq_off": seq_off, "nseq_part": part.nseq_part,
             "dimer": part.dimer is not None,
             "dimer_flag_frac": part.dimer_flag_frac},
            f,
        )
    return out_dir


def _load_part_dir(out_dir: str, has_n: bool) -> IndexPart:
    from genmap_tpu_torch.index.fmindex import RankRows

    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    return IndexPart(
        fwd=RankRows(
            blocks=np.load(os.path.join(out_dir, "blocks.npy"), mmap_mode="r"),
            has_n=has_n,
            length=meta["length"],
        ),
        C=np.load(os.path.join(out_dir, "C.npy")),
        sa_i1=np.load(os.path.join(out_dir, "sa_i1.npy"), mmap_mode="r"),
        sa_i2=np.load(os.path.join(out_dir, "sa_i2.npy"), mmap_mode="r"),
        strand_blocks=np.load(os.path.join(out_dir, "strand.npy"), mmap_mode="r"),
        ind_blocks=np.load(os.path.join(out_dir, "ind.npy"), mmap_mode="r"),
        seq_off=meta["seq_off"],
        nseq_part=meta["nseq_part"],
        dimer=np.load(os.path.join(out_dir, "dimer.npy"), mmap_mode="r")
        if meta.get("dimer")
        else None,
        C2=np.load(os.path.join(out_dir, "C2.npy")) if meta.get("dimer") else None,
        dimer_flag_frac=meta.get("dimer_flag_frac", 1.0),
    )


def build_index(
    fasta_files: list[FastaFile],
    sampling: int = 10,
    directory: bool = False,
    max_part_symbols: int = MAX_PART_SYMBOLS,
    workers: int = 1,
    spill_dir: str | None = None,
    dimer: bool = True,
    dimer_parts: bool = False,
) -> FMIndexData:
    """Build an FMD-index (one or more parts) over all sequences of all files.

    Design choice (diverges from the reference's layout, not its
    semantics): each part's text covers BOTH strands — the input sequences
    followed by their reverse complements in the same order.  One search then
    counts forward and reverse-complement occurrences in a single SA interval
    (occ_{rc(T)}(w) == occ_T(rc(w))), replacing the reference's second search
    pass over reverse-complemented needles (algo.hpp:284-305), and enables
    FMD bidirectional search on a single BWT.  A strand bitvector over SA rows
    (rank rows in `strand_blocks`) recovers forward-only counts for
    --no-reverse-complement and per-strand CSV splitting.
    """
    seqs: list[np.ndarray] = []
    seq_files: list[str] = []
    seq_names: list[str] = []
    for ff in fasta_files:
        for rid, s in zip(ff.ids, ff.seqs):
            seqs.append(np.asarray(s, dtype=np.uint8))
            seq_files.append(ff.name)
            seq_names.append(rid)
    if not seqs:
        raise ValueError("There is no non-empty sequence in the fasta file(s).")

    seq_lens = np.array([len(s) for s in seqs], dtype=np.uint64)
    has_n = any(bool((s == 4).any()) for s in seqs)
    alphabet_size = 5 if has_n else 4

    # dimer rank rows need each part's both-strand symbol count < 2^31 (the
    # sub-block flag steals a count bit, fmindex.py).  Default partitioning
    # aims for the fewest parts (every part is searched per batch, so part
    # count scales query cost); `dimer_parts=True` instead caps parts at
    # DIMER_PART_LIMIT so the dimer fast path stays available at
    # human-genome scale.
    from genmap_tpu_torch.index.fmindex import DIMER_PART_LIMIT

    part_limit = max_part_symbols
    if dimer and dimer_parts:
        part_limit = min(part_limit, DIMER_PART_LIMIT)
    groups = _partition(seq_lens, part_limit)
    if dimer and not dimer_parts:
        import sys

        for s, e in groups:
            n_part = 2 * int((seq_lens[s:e] + 1).sum())
            if n_part >= 2**31:
                print(
                    f"WARNING: index part of {n_part} both-strand symbols "
                    "exceeds the dimer rank-row limit (2^31); the dimer "
                    "(2-chars-per-gather) fast path is DISABLED for this "
                    "part. Build with dimer_parts=True (CLI: index -xd) to "
                    "cap part sizes and keep it.",
                    file=sys.stderr,
                )
    if workers > 1 and len(groups) > 1:
        # parts are fully independent: build them in parallel processes (the
        # SACA is latency-bound on this host, so extra processes scale well)
        import multiprocessing as mp
        import tempfile

        base = spill_dir or tempfile.mkdtemp(prefix="genmap_parts_")
        jobs = [
            (seqs[s:e], sampling, has_n, s, dimer, os.path.join(base, f"part{i}"))
            for i, (s, e) in enumerate(groups)
        ]
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(workers, len(groups))) as pool:
            dirs = pool.map(_build_part_to_dir, jobs)
        parts = [_load_part_dir(d, has_n) for d in dirs]
    else:
        parts = [
            _build_part(seqs[s:e], sampling, has_n, seq_off=s, dimer=dimer)
            for s, e in groups
        ]

    text_words, text_nwords, text_len = _pack_text(seqs, has_n)

    return FMIndexData(
        alphabet_size=alphabet_size,
        sampling=sampling,
        directory=directory,
        parts=parts,
        seq_files=seq_files,
        seq_names=seq_names,
        seq_lens=seq_lens,
        text_words=text_words,
        text_nwords=text_nwords,
        text_len=text_len,
    )
