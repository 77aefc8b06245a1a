"""The plain reference against a brute-force count and against the port's
CPU path."""

import os

import numpy as np
import pytest
from conftest import tiny_config

from portbench.genome import Genome, make_genome, write_fasta
from portbench.reference.frequency import frequencies


def brute(codes, cum, K, e, cap, rc):
    """Position by position, window by window, in plain Python."""
    comp = {0: 3, 1: 2, 2: 1, 3: 0, 4: 4}
    wins = [(a, a + K) for lo, hi in zip(cum[:-1], cum[1:]) for a in range(lo, hi - K + 1)]

    def count(q):
        n = 0
        for a, b in wins:
            mism = sum(1 for x, y in zip(q, codes[a:b]) if x != y or x == 4)
            n += mism <= e
        return n

    out = np.zeros(len(codes), dtype=np.uint32)
    for a, _b in wins:
        q = list(codes[a:a + K])
        n = count(q) + (count([comp[c] for c in reversed(q)]) if rc else 0)
        out[a] = min(n, cap)
    return out


@pytest.mark.parametrize("K,e,rc,alphabet", [(4, 0, True, 4), (5, 1, True, 4),
                                            (6, 2, False, 4), (6, 1, True, 5),
                                            (7, 3, True, 5)])
def test_reference_equals_brute_force(K, e, rc, alphabet):
    rng = np.random.default_rng(K * 10 + e)
    lens = [31, 4, 57, 22]
    codes = rng.integers(0, alphabet, size=sum(lens)).astype(np.uint8)
    codes[40:52] = codes[5:17]  # a repeat across sequences
    cum = np.concatenate(([0], np.cumsum(lens)))
    want = brute(codes, cum, K, e, 255, rc)
    got = frequencies(codes, cum, np.arange(len(codes)), K, e, 255, rc, block=9)
    assert np.array_equal(got, want)


def test_reference_saturates():
    codes = np.zeros(40, dtype=np.uint8)
    got = frequencies(codes, np.array([0, 40]), np.arange(40), 3, 0, 7, True)
    assert got[:38].tolist() == [7] * 38 and got[38:].tolist() == [0, 0]


@pytest.mark.parametrize("K,e,flags", [(20, 1, ("-fl", "-r")), (30, 2, ("-fs", "-r"))])
def test_reference_equals_the_port_on_the_cpu(tmp_path, K, e, flags):
    from genmap_tpu_torch.cli.main import main as cli_main
    from genmap_tpu_torch.cli.map_cmd import map_main

    g = make_genome(tiny_config((3000, 2500, 900)), 7)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, g)
    assert cli_main(["index", "-F", fa, "-I", str(tmp_path / "idx")]) == 0
    out = tmp_path / "out"
    out.mkdir()
    assert map_main(["-I", str(tmp_path / "idx"), "-O", str(out) + "/", "-K", str(K),
                     "-E", str(e), *flags, "--device", "cpu"]) == 0
    got = np.fromfile(os.path.join(out, "g.genmap" + (".freq8" if "-fs" in flags
                                                      else ".freq16")),
                      dtype="<u1" if "-fs" in flags else "<u2")
    cap = 255 if "-fs" in flags else 65535
    want = frequencies(g.codes, g.cum, np.arange(g.length), K, e, cap, True)
    assert np.array_equal(got.astype(np.uint32), want)
    assert (want > 1).sum() > 50  # the repeats are there


def test_the_seed_makes_the_genome_and_the_checks():
    """The same seed gives the same genome and checked positions; another
    seed another genome, from the same consensi; every sequence's ends are
    among the positions checked."""
    from portbench.harness import sample_positions, selected

    cfg = tiny_config()
    a, b, c = make_genome(cfg, 2**40 + 1), make_genome(cfg, 2**40 + 1), make_genome(cfg, -7)
    assert isinstance(a, Genome) and a.length == 20000 == c.length
    assert np.array_equal(a.codes, b.codes) and a.codes.max() == 3
    assert (a.codes != c.codes).mean() > 0.5
    mask = selected(a, None, 30)
    p1 = sample_positions(a, 30, 500, 2**40 + 1, mask)
    p2 = sample_positions(a, 30, 500, 2**40 + 1, mask)
    p3 = sample_positions(a, 30, 500, -7, mask)
    assert np.array_equal(p1, p2) and not np.array_equal(p1, p3)
    for lo, hi in zip(a.cum[:-1], a.cum[1:]):
        assert {lo, lo + 1, hi - 31, hi - 1} <= set(p1.tolist())


def test_copies_follow_their_class(monkeypatch):
    """Each class fills its share or makes its copies, at its lengths and
    divergences; the background has the configuration's GC share."""
    from portbench import genome as gmod

    rng = np.random.default_rng(5)
    cons = [gmod.bases(rng, 6000, 0.41)]
    line = {"kind": "interspersed", "share": 0.1, "consensus_bp": 6000, "copy_bp": 900,
            "divergence": [0.02, 0.02]}
    segs = gmod.class_copies(line, 2_000_000, cons, 0.41, rng)
    lens = np.array([len(s) for s in segs])
    assert 200_000 <= lens.sum() < 200_000 + 6000
    assert 800 < lens.mean() < 1000 and lens.max() <= 6000 and lens.min() >= 20
    sine = dict(line, consensus_bp=300, copy_bp=266, divergence=[0.0, 0.0])
    lens = np.array([len(s) for s in gmod.class_copies(sine, 1_000_000, [cons[0][:300]],
                                                      0.41, rng)])
    assert 256 < lens.mean() < 276 and lens.min() >= 232
    fixed = {"kind": "interspersed", "copies": 7, "consensus_bp": 5000, "copy_bp": 5000,
             "divergence": [0.0, 0.0]}
    segs = gmod.class_copies(fixed, 10**6, [cons[0][:5000]], 0.5, rng)
    assert len(segs) == 7 and all(
        np.array_equal(s, cons[0][:5000]) or np.array_equal(s, gmod.revcomp(cons[0][:5000]))
        for s in segs)
    seg = gmod.mutate(np.zeros(100_000, np.uint8), 0.05, rng)
    assert 0.045 < (seg != 0).mean() < 0.055
    g = make_genome(dict(tiny_config((200_000,)), gc=0.41, repeats=[]), 3)
    assert abs(np.isin(g.codes, [1, 2]).mean() - 0.41) < 0.01


def test_configurations_make_their_genomes():
    """Both configurations' genomes at their full lengths, with repeats: the
    cells' genomes hold k-mers that occur more than once."""
    import json

    from conftest import ROOT

    for name in ("ecoli-k12", "grch38-cut12m"):
        with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
            cfg = json.load(f)
        g = make_genome(cfg, 11)
        assert g.length == cfg["genome_bp"] and g.codes.max() == 3
        assert abs(np.isin(g.codes, [1, 2]).mean() - cfg["gc"]) < 0.02


def test_a_genome_seed_fixes_the_genome():
    """A configuration that states `genome_seed` maps one genome whatever the
    run's seed; without it every run seed makes its own."""
    cfg = dict(tiny_config(), genome_seed=5)
    a, b = make_genome(cfg, 1), make_genome(cfg, 2**40 + 3)
    assert np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.codes, make_genome(tiny_config(), 5).codes)
