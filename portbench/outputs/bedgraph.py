"""`-bg`: `chrom<TAB>start<TAB>end<TAB>value` per run of equal nonzero
values, 0-based half-open; positions in no run hold 0.  Values are
frequencies (`-fs`, `-fl`) or mappability, 1/frequency printed as C++
prints a float (`%g`)."""

from __future__ import annotations

import numpy as np


def suffix(flags) -> str:
    return ".bedgraph"


def _mappability(flags) -> bool:
    return not ("-fs" in flags or "-fl" in flags)


def read(path, genome, flags) -> np.ndarray:
    """Every position's value; raises ValueError on a malformed file."""
    index = {name: i for i, name in enumerate(genome.names)}
    out = np.zeros(genome.length, dtype=np.float64 if _mappability(flags) else np.int64)
    with open(path, "rb") as f:
        rows = f.read().split()
    if len(rows) % 4:
        raise ValueError(f"{path}: {len(rows)} fields, not rows of 4")
    if not rows:
        return out
    chrom = np.array([index[c.decode()] for c in rows[0::4]], dtype=np.int64)
    start = np.array(rows[1::4], dtype=np.int64)
    end = np.array(rows[2::4], dtype=np.int64)
    value = np.array(rows[3::4], dtype=out.dtype)
    if (start >= end).any() or (end > genome.lens[chrom]).any():
        raise ValueError(f"{path}: a run outside its sequence")
    lo, hi = genome.cum[chrom] + start, genome.cum[chrom] + end
    delta = np.zeros(genome.length + 1, dtype=np.int64)
    np.add.at(delta, lo, 1)
    np.add.at(delta, hi, -1)
    if (np.cumsum(delta)[:-1] > 1).any():
        raise ValueError(f"{path}: runs overlap")
    run_of = np.zeros(genome.length + 1, dtype=np.int64)
    np.add.at(run_of, lo, np.arange(1, len(lo) + 1))
    np.add.at(run_of, hi, -np.arange(1, len(lo) + 1))
    run = np.cumsum(run_of)[:-1]
    covered = run > 0
    out[covered] = value[run[covered] - 1]
    return out


def expect(freq, flags) -> np.ndarray:
    freq = np.asarray(freq)
    if not _mappability(flags):
        return freq.astype(np.int64)
    f = freq.astype(np.float32)
    rec = np.where(f != 0, np.float32(1.0) / np.maximum(f, 1), np.float32(0.0))
    return np.array([float(f"{float(v):g}") for v in rec], dtype=np.float64)
