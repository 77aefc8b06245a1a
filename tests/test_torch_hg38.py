"""genmap_tpu_torch/scripts/hg38_demo.py, and the shape of an hg38-scale
index, at a small size on the CPU.

The script runs at 1.2 Mbp (its hg38-proportioned chromosomes scaled down,
every planted copy intact at this size) with `--max-part-symbols` forcing
two parts: its genome equals the JAX script's byte for byte (the JAX
script's `main` runs until it calls `build_index`, which is replaced by a
function that keeps its FastaFile and stops), its planted, targeted,
overlap and locate checks pass, its chr21 frequencies equal the JAX
engine's on the same index directory, and one wrong expected count makes it
exit non-zero.  The port's seed tables are cut to depth 8 here (depth changes
the scan's speed only, never a frequency: the plain CPU build of depth 11
takes ~30 s a part).  A two-part index whose first part has no dimer rows (as a
part of 2^31 symbols or more has none) and whose second has them maps as
the JAX engine maps it: frequencies, `-d` locations, blocks per tier, the
dimer tiers off in both.  Exact equality throughout.
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index import build as tbuild
from genmap_tpu_torch.index.fmindex import FMIndexData
from genmap_tpu_torch.ops import rank
from genmap_tpu_torch.scripts import hg38_demo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GBP = 0.0012
XM = 1_400_000
SLICE = 4000
K, E = 30, 2


def _argv(out, *extra):
    return ["--gbp", str(GBP), "--max-part-symbols", str(XM), "--device", "cpu",
            "--slice", str(SLICE), "--batch-blocks", "512", "--out", str(out), *extra]


@pytest.fixture(scope="module", autouse=True)
def shallow_seed_tables():
    depth = rank.seed_depth
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rank, "seed_depth", lambda n, t0_max=8: depth(n, min(t0_max, 8)))
        yield


@pytest.fixture(scope="module")
def script_run(tmp_path_factory, shallow_seed_tables):
    out = tmp_path_factory.mktemp("hg38")
    rc = hg38_demo.main(_argv(out))
    with open(out / "summary.json") as f:
        return out, rc, json.load(f)


class _Captured(Exception):
    pass


def test_genome_equals_jax_script(monkeypatch, tmp_path):
    import genmap_tpu.cache
    import genmap_tpu.index.build

    def capture(files, **kw):
        raise _Captured(files)

    monkeypatch.setattr(genmap_tpu.index.build, "build_index", capture)
    monkeypatch.setattr(genmap_tpu.cache, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["hg38_demo.py", "--gbp", str(GBP), "--out",
                                      str(tmp_path), "--k", str(K)])
    spec = importlib.util.spec_from_file_location(
        "jax_hg38_demo", os.path.join(ROOT, "scripts", "hg38_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Captured) as exc:
        mod.main()
    (ff,) = exc.value.args[0]
    seqs, families = hg38_demo.make_genome(GBP, K)
    assert ff.ids == [f"chr{i + 1}" for i in range(24)]
    assert len(ff.seqs) == len(seqs) == 24
    for a, b in zip(ff.seqs, seqs):
        assert a.dtype == b.dtype == np.uint8
        assert a.tobytes() == b.tobytes()
    assert sum(f["count"] for f in families) == 277
    hg38_demo.check_planted_intact(seqs, families, K)


def test_script_checks_pass_and_match_jax(script_run):
    from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
    from genmap_tpu.engine.mappability import SearchParams as JaxParams
    from genmap_tpu.index.fmindex import FMIndexData as JaxData

    out, rc, summary = script_run
    assert rc == 0 and summary["ok"]
    assert summary["planted_mismatches"] == 0 and summary["planted_checked"] > 0
    assert summary["overlap_invariant"] and summary["locate_mismatches"] == 0
    assert summary["located_rows"] == 277
    assert len(summary["parts"]) == 2
    assert [m["name"] for m in summary["maps"]] == ["chr21", "targeted", "slice o=26",
                                                    "slice o=23", "locate"]
    assert all(m["route"].startswith("J=") for m in summary["maps"])
    assert summary["maps"][0]["route"].startswith("J=5 ")
    jdata = JaxData.load(os.path.join(out, "idx"), mmap=True)
    jeng = JaxEngine(jdata, batch_blocks=512, light=True)
    jeng._calibrate_enabled = False  # pools change speed only, never a frequency
    lay = jeng.layouts[0]
    b, e = int(lay.cum_lens[20]), int(lay.cum_lens[21])
    assert summary["chr21"]["begin"] == b
    c = jeng.compute_file(lay, JaxParams(K, 26, True), E, 65535, intervals=[(b, e - K + 1)]).c
    c21 = np.ascontiguousarray(c[b:e], dtype=np.uint32)
    assert hashlib.sha256(c21.tobytes()).hexdigest() == summary["chr21"]["sha256"]
    assert (c21[: e - b - K + 1] >= 1).all()


def test_planted_wrong_count_exits_nonzero(script_run, monkeypatch):
    out, _rc, _summary = script_run
    make = hg38_demo.make_genome

    def wrong(gbp, k):
        seqs, families = make(gbp, k)
        families[7]["count"] += 1
        return seqs, families

    monkeypatch.setattr(hg38_demo, "make_genome", wrong)
    assert hg38_demo.main(_argv(out, "--skip-build")) == 1
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert not summary["ok"]
    assert summary["planted_mismatches"] >= 1 and summary["locate_mismatches"] == 1


def test_script_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        hg38_demo.main(["--gbp", str(GBP), "--out", str(tmp_path)])


def test_preflight_plans_and_raises_when_short(monkeypatch, tmp_path, capsys):
    """At 3.1 Gbp the default partition is the JAX run's (4.17e9 + 2.03e9
    symbols, the first without dimer rows); a host without the RAM raises
    before anything is built."""
    lens = hg38_demo.chrom_lengths(3.1)
    parts = hg38_demo.plan_parts(lens, tbuild.MAX_PART_SYMBOLS)
    assert [n for _, _, n in parts] == [4_169_941_722, 2_030_058_304]
    assert hg38_demo.plan_parts(lens, 2_500_000_000)[0][2] == 2_473_374_356
    host = dict(mem_available=64 << 30, nproc=8, cpu="x", disk_free=1 << 40)
    monkeypatch.setattr(hg38_demo, "host_facts", lambda path: host)
    with pytest.raises(RuntimeError, match="RAM"):
        hg38_demo.preflight(lens, tbuild.MAX_PART_SYMBOLS, 2, str(tmp_path), 28.0)
    text = capsys.readouterr().out
    assert "4,169,941,722 both-strand symbols, >= 2^31 (no dimer rows)" in text
    assert "2,030,058,304 both-strand symbols, < 2^31 (dimer rows)" in text
    host["mem_available"] = 1 << 40
    plan = hg38_demo.preflight(lens[:10], tbuild.MAX_PART_SYMBOLS, 1, str(tmp_path), 28.0)
    assert len(plan["parts"]) == 1 and plan["workers"] == 1


@pytest.mark.parametrize("chunk", [32, 96, 1 << 26])
def test_pack_text_in_chunks_equals_jax(monkeypatch, chunk):
    """The packed text, built _CHUNK symbols at a time (the hg38 build's
    parent process would otherwise take 16 B per base), is the JAX
    package's, byte for byte."""
    from genmap_tpu.index import build as jbuild

    monkeypatch.setattr(tbuild, "_CHUNK", chunk)
    rng = np.random.default_rng(chunk)
    for trial in range(12):
        seqs = [rng.integers(0, 5 if trial % 2 else 4, int(rng.integers(0, 300)),
                             dtype=np.uint8) for _ in range(int(rng.integers(1, 6)))]
        has_n = any(bool((s == 4).any()) for s in seqs)
        got, want = tbuild._pack_text(seqs, has_n), jbuild._pack_text(seqs, has_n)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _two_part_index():
    """Two sequences per part; part 0 built without dimer rows, part 1 with
    them; a 60 bp unit repeated across both parts."""
    rng = np.random.default_rng(38)
    unit = rng.integers(0, 4, 60, dtype=np.uint8)
    seqs = []
    for i in range(4):
        s = rng.integers(0, 4, 1500, dtype=np.uint8)
        s[200 + 100 * i: 260 + 100 * i] = unit
        seqs.append(s)
    groups = [(0, 2), (2, 4)]
    parts = [tbuild._build_part(seqs[s:e], 5, False, s, dimer=d)
             for (s, e), d in zip(groups, (False, True))]
    words, nwords, n = tbuild._pack_text(seqs, False)
    return FMIndexData(alphabet_size=4, sampling=5, directory=False, parts=parts,
                       seq_files=["g.fa"] * 4, seq_names=[f"chr{i + 1}" for i in range(4)],
                       seq_lens=np.array([len(s) for s in seqs], np.uint64),
                       text_words=words, text_nwords=nwords, text_len=n)


def test_two_part_index_mono_and_dimer_matches_jax(tmp_path):
    from genmap_tpu.engine.mappability import MappabilityEngine as JaxEngine
    from genmap_tpu.engine.mappability import SearchParams as JaxParams
    from genmap_tpu.index.fmindex import FMIndexData as JaxData

    data = _two_part_index()
    assert data.parts[0].dimer is None and data.parts[1].dimer is not None
    data.save(str(tmp_path))
    jdata = JaxData.load(str(tmp_path))
    assert jdata.parts[0].dimer is None and jdata.parts[1].dimer is not None
    k, e, o = 16, 1, 12
    eng = MappabilityEngine(FMIndexData.load(str(tmp_path)), batch_blocks=64, device="cpu")
    jeng = JaxEngine(jdata, batch_blocks=64)
    assert eng._dimer_ok is False and jeng._dimer_ok is False
    for csv in (False, True):
        got = eng.compute_file(eng.layouts[0], SearchParams(k, o, True), e, 255, csv=csv)
        want = jeng.compute_file(jeng.layouts[0], JaxParams(k, o, True), e, 255, csv=csv)
        np.testing.assert_array_equal(got.c, want.c)
        assert eng.stats["tier_blocks"] == jeng.stats["tier_blocks"]
        assert eng.stats["dimer_tier"] is False and jeng.stats["dimer_tier"] is False
        assert all(not t.dimer for t in eng.stats["tiers"])
        assert got.c.max() == 4  # the repeated unit: 4 copies
        if csv:
            assert got.locations.keys() == want.locations.keys() and got.locations
            for key, (gf, gr) in got.locations.items():
                wf, wr = want.locations[key]
                for g, w in zip(gf + gr, wf + wr):
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
