"""Optimal search schemes (e <= 4) and their static execution plans.

The (pi, l, u) tables are the published optimal-search-scheme constants
(Kianfar/Pockrandt et al., "Optimum Search Schemes for Approximate String
Matching Using Bidirectional FM-Index", arXiv:1711.02035) as instantiated by
the reference (GenMap src/find2_index_approx.hpp:67-134).  Semantics
of a scheme: the needle is split into `nblocks` contiguous blocks; search s
processes blocks in the order pi, and after finishing block pi[i] the number
of accumulated mismatches must lie in [l[i], u[i]].

Instead of the reference's recursive interpreter (find2_index_approx.hpp:377-428)
we compile each search into a *static step plan*: the sequence of needle
positions it consumes is independent of the errors encountered, so a search is
a fixed list of (needle position, direction, error bounds) steps — exactly
what a lockstep tensorized frontier needs (no data-dependent control flow
under jit).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# per error count: list of searches, each (pi, l, u); block ids are 1-based
SCHEMES: dict[int, list[tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]]] = {
    0: [((1,), (0,), (0,))],
    1: [
        ((1, 2), (0, 0), (0, 1)),
        ((2, 1), (0, 1), (0, 1)),
    ],
    2: [
        ((1, 2, 3, 4), (0, 0, 1, 1), (0, 0, 2, 2)),
        ((3, 2, 1, 4), (0, 0, 0, 0), (0, 1, 1, 2)),
        ((4, 3, 2, 1), (0, 0, 0, 2), (0, 1, 2, 2)),
    ],
    3: [
        ((1, 2, 3, 4, 5), (0, 0, 0, 0, 3), (0, 1, 2, 3, 3)),
        ((2, 3, 4, 5, 1), (0, 0, 0, 2, 2), (0, 1, 2, 2, 3)),
        ((3, 4, 5, 2, 1), (0, 0, 1, 1, 1), (0, 1, 1, 3, 3)),
        ((5, 4, 3, 2, 1), (0, 0, 0, 0, 0), (0, 0, 3, 3, 3)),
    ],
    4: [
        ((1, 2, 3, 4, 5, 6), (0, 0, 0, 0, 0, 4), (0, 2, 3, 3, 4, 4)),
        ((3, 4, 5, 6, 2, 1), (0, 0, 0, 1, 4, 4), (0, 0, 1, 1, 4, 4)),
        ((2, 3, 4, 5, 6, 1), (0, 0, 0, 0, 0, 0), (0, 2, 2, 3, 3, 4)),
        ((3, 2, 4, 5, 6, 1), (0, 1, 1, 1, 1, 1), (0, 1, 2, 3, 3, 4)),
        ((4, 3, 2, 5, 6, 1), (0, 0, 2, 2, 2, 2), (0, 0, 2, 3, 3, 4)),
        ((4, 3, 2, 5, 6, 1), (0, 1, 2, 2, 2, 2), (0, 1, 2, 3, 3, 4)),
        ((6, 5, 4, 3, 2, 1), (0, 0, 0, 0, 3, 3), (0, 0, 4, 4, 4, 4)),
    ],
}


@dataclass(frozen=True)
class Segment:
    """A maximal run of same-direction steps within one search plan."""

    right: bool  # True: extend right (rev index); False: extend left (fwd index)
    pos: np.ndarray  # [steps] int32 needle positions consumed
    u: np.ndarray  # [steps] int32 max cumulative errors after this step
    lreq: np.ndarray  # [steps] int32 min cumulative errors after this step


@dataclass(frozen=True)
class SearchPlan:
    segments: tuple[Segment, ...]
    n_steps: int


def block_lengths(nblocks: int, needle_len: int) -> list[int]:
    """Even split with the remainder on the leftmost blocks.

    Mirrors _optimalSearchSchemeComputeFixedBlocklengthGM
    (GenMap src/find2_index_approx.hpp:165-176): block id b (1-based)
    gets floor(len/n) + (b-1 < len%n).
    """
    base, rest = divmod(needle_len, nblocks)
    if base == 0:
        raise ValueError(
            f"needle of length {needle_len} too short for {nblocks} scheme blocks"
        )
    return [base + (i < rest) for i in range(nblocks)]


def build_plan(
    pi: tuple[int, ...], l: tuple[int, ...], u: tuple[int, ...], needle_len: int
) -> SearchPlan:
    """Compile one search into its static step plan.

    Simulates the span evolution of the recursive interpreter: the span
    [left, right) starts as [startPos, startPos+1) at the left edge of block
    pi[0]; each step consumes needle[right-1] going right or needle[left-1]
    going left; the direction entering block pi[i+1] is right iff
    pi[i+1] > pi[i] (find2_index_approx.hpp:273-285, 321, 435-442).
    """
    nblocks = len(pi)
    lengths = block_lengths(nblocks, needle_len)  # by block id (1-based)
    # cumulative lengths in pi order
    cum = np.cumsum([lengths[b - 1] for b in pi])
    start = sum(lengths[b - 1] for b in pi if b < pi[0])

    left, right = start, start + 1
    bi = 0
    going_right = True
    steps: list[tuple[int, bool, int, int]] = []  # (pos, right, u, lreq)
    while len(steps) < needle_len:
        if going_right:
            pos = right - 1
            right += 1
        else:
            pos = left - 1
            left -= 1
        consumed = right - left - 1
        rem_after = int(cum[bi]) - consumed
        lreq = max(0, l[bi] - rem_after)
        steps.append((pos, going_right, u[bi], lreq))
        if rem_after == 0 and consumed < needle_len:
            bi2 = min(bi + 1, nblocks - 1)
            going_right = pi[bi2] > pi[bi2 - 1]
            bi = bi2
    assert sorted(s[0] for s in steps) == list(range(needle_len))

    segments: list[Segment] = []
    i = 0
    while i < len(steps):
        j = i
        while j < len(steps) and steps[j][1] == steps[i][1]:
            j += 1
        chunk = steps[i:j]
        segments.append(
            Segment(
                right=chunk[0][1],
                pos=np.array([s[0] for s in chunk], dtype=np.int32),
                u=np.array([s[2] for s in chunk], dtype=np.int32),
                lreq=np.array([s[3] for s in chunk], dtype=np.int32),
            )
        )
        i = j
    return SearchPlan(segments=tuple(segments), n_steps=needle_len)


def plans_for(errors: int, needle_len: int) -> list[SearchPlan]:
    return [build_plan(pi, l, u, needle_len) for pi, l, u in SCHEMES[errors]]
