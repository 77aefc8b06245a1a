"""Brute-force numpy oracle for differential testing.

The port's own copy of the JAX package's `engine/oracle.py` (numpy only, the
port's alphabet), after GenMap's randomized differential test oracle
(tests/tests.cpp:30-131): per-position trivial counting of all genome windows
within Hamming distance <= e, with the N-never-matches rule (a needle N counts
as a mismatch against everything, including N).  It serves the tests and
`chip_smoke.py`; no module of the map path imports it.
"""

from __future__ import annotations

import numpy as np

from genmap_tpu_torch.alphabet import revcomp_codes


def _windows(seqs: list[np.ndarray], K: int) -> np.ndarray:
    """All length-K windows fully inside a sequence, over all sequences."""
    chunks = []
    for s in seqs:
        if len(s) >= K:
            chunks.append(np.lib.stride_tricks.sliding_window_view(s, K))
    if not chunks:
        return np.empty((0, K), dtype=np.uint8)
    return np.concatenate(chunks, axis=0)


def _count(queries: np.ndarray, targets: np.ndarray, e: int) -> np.ndarray:
    """#targets within Hamming distance <= e of each query (N-in-query never matches)."""
    nq, K = queries.shape
    nt = targets.shape[0]
    if nq == 0 or nt == 0:
        return np.zeros(nq, dtype=np.uint64)
    mism = np.zeros((nq, nt), dtype=np.uint16)
    for t in range(K):
        q = queries[:, t][:, None]
        mism += ((q != targets[:, t][None, :]) | (q == 4)).astype(np.uint16)
    return (mism <= e).sum(axis=1).astype(np.uint64)


def trivial_frequency(
    index_seqs: list[np.ndarray],
    file_seqs: list[np.ndarray],
    K: int,
    e: int,
    cap: int,
    rev_compl: bool,
) -> np.ndarray:
    """(K,e)-frequency of every position of the concatenation of file_seqs,
    counting occurrences across all windows of index_seqs.

    Returns uint32 of length sum(len(s) for s in file_seqs): positions whose
    window would span a sequence boundary (or fall off the end) are 0 — the
    resetLimits semantics of GenMap src/algo.hpp:10-22,478-482.
    """
    targets = _windows(index_seqs, K)
    text = np.concatenate(file_seqs) if file_seqs else np.empty(0, np.uint8)
    L = len(text)
    c = np.zeros(L, dtype=np.uint64)
    if L >= K:
        queries = np.lib.stride_tricks.sliding_window_view(text, K)
        fwd = _count(queries, targets, e)
        fwd = np.minimum(fwd, cap)
        if rev_compl:
            rc_all = np.stack([revcomp_codes(q) for q in queries], axis=0)
            rc = np.minimum(_count(rc_all, targets, e), cap)
            fwd = np.minimum(fwd + rc, cap)
        c[: L - K + 1] = fwd
    # zero k-mers spanning sequence boundaries
    pos = 0
    cum = [0]
    for s in file_seqs:
        pos += len(s)
        cum.append(pos)
    for i in range(1, len(cum)):
        for j in range(1, min(K, cum[i] - cum[i - 1] + 1)):
            c[cum[i] - j] = 0
    return c.astype(np.uint32)
