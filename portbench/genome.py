"""The benchmark's genomes, made from a configuration's table of repeats and
the run's seed, and the FASTA writer.

A configuration states its sequences (names and lengths), its GC share and
its repeats as a list of classes, each with the figures that its `source`
gives (share of the genome or number of copies, length, divergence from its
consensus).  The consensus sequences come from the configuration's
`family_seed`, as a species' repeat families are fixed; the genome's seed
draws everything else: the background bases, every copy (which family, its
length, its substitutions, its strand) and the order of all segments.  The
genome's seed is the run's, so that every seed is a new genome with the same
repeat content, unless the configuration states a `genome_seed`: then every
run maps that one genome, and the run's seed draws only the positions that
are checked (harness.py).

Kinds of class:

- `interspersed`: copies of `families` consensus sequences of
  `consensus_bp`.  A copy is a 3' suffix of its consensus: full length where
  `copy_bp` (the mean copy) is the consensus's length, uniform between
  2 * copy_bp - consensus_bp and consensus_bp where that is 40 bp or more,
  else exponential with mean `copy_bp` (5' truncation, as of LINEs), at
  least 20 bp.  Reverse-complemented half of the time.
- `tandem`: a unit of `unit_bp` [lo, hi] bases repeated to `copy_bp`
  [lo, hi] bases (simple sequence repeats).
- `duplication`: a stretch of `copy_bp` [lo, hi] bases of the assembled
  genome pasted elsewhere (segmental duplications), over what was there.

Each class fills `share` of the genome, or makes `copies` copies; each copy
is substituted at a rate from `divergence` [lo, hi], uniformly spread.  The
rest is background: bases drawn at the GC share `gc`, in runs between the
copies.  A class's lengths and divergences are quantiles of their
distributions at evenly spread points (an additive recurrence from a start
the seed draws), so that every seed makes the same set of sizes and
divergences, at other places: seeds change the bases, not the amount of
repeated sequence at each length and divergence.

Everything here is numpy; nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np

_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)
KINDS = ("interspersed", "tandem", "duplication")


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """A numpy seed for stream `stream` of the run seeded `seed` (any whole
    number, negative or past 64 bits included)."""
    return np.random.SeedSequence([seed % (1 << 64), stream])


def base_probs(gc: float) -> np.ndarray:
    """P(A), P(C), P(G), P(T) at GC share `gc`."""
    return np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])


def bases(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    return rng.choice(4, size=n, p=base_probs(gc)).astype(np.uint8)


def mutate(seg: np.ndarray, rate: float, rng: np.random.Generator) -> np.ndarray:
    """`seg` with each base substituted with probability `rate` by one of the
    three others."""
    seg = seg.copy()
    k = rng.binomial(len(seg), rate)
    if k:
        idx = rng.choice(len(seg), size=k, replace=False)
        seg[idx] = (seg[idx] + rng.integers(1, 4, size=k)) % 4
    return seg


def revcomp(seg: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray((3 - seg)[::-1])


# steps of the evenly spread points, one per quantity drawn for a copy
STEPS = {"length": 0.6180339887498949, "divergence": 0.41421356237309515,
         "unit": 0.7320508075688772}


class Spread:
    """Evenly spread points in [0, 1), one sequence per quantity, each from a
    start drawn from `rng`."""

    def __init__(self, rng: np.random.Generator):
        self.start = {k: float(rng.random()) for k in STEPS}
        self.j = 0

    def next(self) -> dict:
        q = {k: (self.start[k] + self.j * a) % 1.0 for k, a in STEPS.items()}
        self.j += 1
        return q


def between(lo: int, hi: int, q: float) -> int:
    """The whole number of [lo, hi] at quantile q."""
    return int(lo + min(int(q * (hi - lo + 1)), hi - lo))


def copy_length(cls: dict, q: float) -> int:
    """The length of a copy of an interspersed class at quantile q."""
    m, mean = int(cls["consensus_bp"]), float(cls["copy_bp"])
    if mean >= m:
        return m
    lo = 2 * mean - m
    if lo >= 40:
        return between(int(lo), m, q)
    return int(min(m, max(20, round(-mean * np.log1p(-q)))))


def class_copies(cls: dict, n: int, consensi: list, gc: float,
                 rng: np.random.Generator) -> list:
    """The copies of one interspersed or tandem class (uint8 arrays)."""
    target = int(cls["copies"]) if "copies" in cls else None
    fill = round(float(cls.get("share", 0.0)) * n)
    out, total = [], 0
    dlo, dhi = cls["divergence"]
    spread = Spread(rng)
    while (len(out) < target) if target is not None else (total < fill):
        q = spread.next()
        if cls["kind"] == "interspersed":
            cons = consensi[int(rng.integers(len(consensi)))]
            seg = cons[len(cons) - copy_length(cls, q["length"]):]
        else:
            unit = bases(rng, between(*cls["unit_bp"], q["unit"]), gc)
            seg = np.resize(unit, between(*cls["copy_bp"], q["length"]))
        seg = mutate(seg, dlo + (dhi - dlo) * q["divergence"], rng)
        if rng.random() < 0.5:
            seg = revcomp(seg)
        out.append(seg)
        total += len(seg)
    return out


def duplicate(codes: np.ndarray, cls: dict, rng: np.random.Generator) -> None:
    """Segmental duplications, pasted in place over `codes`."""
    n = len(codes)
    clo, chi = cls["copy_bp"]
    dlo, dhi = cls["divergence"]
    fill, total = round(float(cls["share"]) * n), 0
    spread = Spread(rng)
    while total < fill:
        q = spread.next()
        length = between(clo, min(chi, n // 4), q["length"])
        src, dst = (int(x) for x in rng.integers(0, n - length, size=2))
        seg = mutate(codes[src:src + length], dlo + (dhi - dlo) * q["divergence"], rng)
        codes[dst:dst + length] = revcomp(seg) if rng.random() < 0.5 else seg
        total += length


class Genome:
    """Sequences as one concatenated uint8 code array (0..3, 4 = N)."""

    def __init__(self, names: list[str], lens: list[int], codes: np.ndarray):
        self.names = list(names)
        self.lens = np.asarray(lens, dtype=np.int64)
        self.codes = codes
        self.cum = np.concatenate(([0], np.cumsum(self.lens)))

    @property
    def length(self) -> int:
        return int(self.cum[-1])

    def kmers(self, K: int) -> int:
        """Positions whose K-mer lies inside one sequence."""
        return int(np.maximum(self.lens - K + 1, 0).sum())


def make_genome(config: dict, seed: int) -> Genome:
    """The configuration's genome for the run seeded `seed` (its
    `genome_seed` where it states one)."""
    seed = int(config.get("genome_seed", seed))
    names = [s[0] for s in config["sequences"]]
    lens = [int(s[1]) for s in config["sequences"]]
    n = sum(lens)
    if n != config["genome_bp"]:
        raise ValueError("the sequences' lengths do not add up to genome_bp")
    gc = float(config["gc"])
    classes = config["repeats"]
    for c in classes:
        if c["kind"] not in KINDS:
            raise ValueError(f"repeat class {c['name']!r}: unknown kind {c['kind']!r}")
    fam_rng = np.random.default_rng(int(config["family_seed"]))
    consensi = {c["name"]: [bases(fam_rng, int(c["consensus_bp"]), gc)
                            for _ in range(int(c.get("families", 1)))]
                for c in classes if c["kind"] == "interspersed"}
    rng = np.random.default_rng(seed_sequence(seed, 0))
    segs = []
    for c in classes:
        if c["kind"] != "duplication":
            segs += class_copies(c, n, consensi.get(c["name"], []), gc, rng)
    rest = n - sum(len(s) for s in segs)
    if rest < 0:
        raise ValueError("the repeats fill more than the genome")
    # background runs between the copies, 300-3,000 bp as long as they last
    runs = []
    while rest > 0:
        runs.append(min(rest, int(rng.integers(300, 3001))))
        rest -= runs[-1]
    bg = bases(rng, sum(runs), gc)
    pieces, used = list(segs), 0
    for r in runs:
        pieces.append(bg[used:used + r])
        used += r
    order = rng.permutation(len(pieces))
    codes = np.concatenate([pieces[i] for i in order]) if pieces else np.zeros(0, np.uint8)
    for c in classes:
        if c["kind"] == "duplication":
            duplicate(codes, c, rng)
    return Genome(names, lens, np.ascontiguousarray(codes[:n]))


def write_fasta(path: str, genome: Genome, width: int = 80) -> None:
    with open(path, "wb") as f:
        for name, lo, hi in zip(genome.names, genome.cum[:-1], genome.cum[1:]):
            f.write(f">{name}\n".encode())
            s = _ACGTN[genome.codes[lo:hi]]
            n = len(s)
            full = n // width * width
            lines = np.full((n // width, width + 1), ord("\n"), dtype=np.uint8)
            lines[:, :width] = s[:full].reshape(-1, width)
            f.write(lines.tobytes())
            if n > full:
                f.write(s[full:].tobytes() + b"\n")
