"""Deterministic genome-like synthetic corpus (copy of the JAX package's
benchmarks/corpus.py generator, kept inside the port).

Uniform-random text is the best case for a search engine (every k-mer is
unique and frontiers stay minimal); real genomes are ~45-50%
repeat-derived (LINEs/SINEs/LTRs/segmental duplications), which is what
drives residual full-pipeline work and frontier width.  This generator
plants repeat families with genome-like statistics so bench numbers and
cross-checks are measured in the regime the reference is actually used in
(GenMap's own benchmarks run on a real GRCh38 index).

Model (all deterministic from `seed`):
  * background: uniform ACGT
  * F repeat families; family consensus lengths log-uniform in [150, 6000]
    (Alu ~300 bp, L1 ~6 kbp); copy counts follow a power law so a few
    families dominate (Alu: ~1M copies in hg38)
  * each copy: per-base substitution at a family-age rate — most families
    are OLD (log-uniform 3-25% divergence, like the bulk of Alu/L1 copies
    at 85-97% identity), a small young minority (0.3-2%, the recent
    L1HS/AluY/segdup analog) carries the near-identical copies that
    actually survive (k,2)-search neighborhoods; random truncation
    (5' truncation is the norm for L1s), random strand
  * target repeat fraction ~48%

Returns uint8 codes 0..3.  ~1 s per 10 Mbp.
"""

from __future__ import annotations

import numpy as np


def make_genomelike(n: int, seed: int = 0, repeat_frac: float = 0.48,
                    n_families: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty(n + 8192, dtype=np.uint8)

    # family consensi + sampling weights (power law, alpha ~ 1.5)
    fam_len = np.exp(
        rng.uniform(np.log(150.0), np.log(6000.0), size=n_families)
    ).astype(np.int64)
    fams = [rng.integers(0, 4, size=int(m), dtype=np.uint8) for m in fam_len]
    young = rng.random(n_families) < 0.12
    fam_rate = np.where(
        young,
        np.exp(rng.uniform(np.log(0.003), np.log(0.02), size=n_families)),
        np.exp(rng.uniform(np.log(0.03), np.log(0.25), size=n_families)),
    )
    w = rng.pareto(1.5, size=n_families) + 0.05
    w /= w.sum()

    pos = 0
    while pos < n:
        if rng.random() < repeat_frac:
            f = rng.choice(n_families, p=w)
            cons = fams[f]
            m = len(cons)
            # truncation: keep a random 3' suffix (>= 40 bp)
            keep = int(rng.integers(min(40, m), m + 1))
            seg = cons[m - keep :].copy()
            # substitutions at the family age rate
            k = rng.binomial(len(seg), fam_rate[f])
            if k:
                idx = rng.integers(0, len(seg), size=k)
                seg[idx] = (seg[idx] + rng.integers(1, 4, size=k)) % 4
            if rng.random() < 0.5:
                seg = (3 - seg)[::-1]  # reverse complement
        else:
            seg = rng.integers(
                0, 4, size=int(rng.integers(300, 3000)), dtype=np.uint8
            )
        out[pos : pos + len(seg)] = seg[: max(0, min(len(seg), n + 8192 - pos))]
        pos += len(seg)
    return np.ascontiguousarray(out[:n])
