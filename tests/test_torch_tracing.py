"""genmap_tpu_torch.tracing: span totals, self time under nested spans,
records on the profiler's clock, and the spans of a `map` job and of the engine, which
name all of `compute_file`'s time and fill the engine's stats."""

import re

import numpy as np
import pytest
import torch

from genmap_tpu_torch import tracing
from genmap_tpu_torch.cli.main import main as torch_main
from genmap_tpu_torch.cli.map_cmd import map_main
from genmap_tpu_torch.engine.mappability import MappabilityEngine, SearchParams
from genmap_tpu_torch.index.build import build_index
from genmap_tpu_torch.io.fasta import FastaFile

torch.set_num_threads(1)

LEAVES = ("engine.dispatch", "engine.fetch", "engine.scatter")


def test_self_time_and_parent_of_nested_spans():
    tr = tracing.Tracer()
    with tr.recording():
        with tr.span("outer"):
            with tr.span("inner"):
                sum(range(10_000))
            with tr.span("inner"):
                sum(range(10_000))
            sum(range(10_000))
        with tr.span("outer"):
            pass
    recs = tr.take()
    # kept as the spans end
    assert [r[2] for r in recs] == ["inner", "inner", "outer", "outer"]
    assert all(r[0] <= r[1] for r in recs)
    assert recs[2][0] <= recs[0][0] <= recs[0][1] <= recs[1][0] <= recs[1][1] <= recs[2][1]
    outer, inner = tr.totals["outer"], tr.totals["inner"]
    assert outer[2] == 2 and inner[2] == 2
    assert inner[0] == inner[1] > 0
    # the parent's self time leaves out what its children cover
    assert outer[1] == outer[0] - inner[0] > 0
    assert tr.take() == []


def test_totals_are_kept_and_records_only_while_recording():
    tr = tracing.Tracer()
    snap = tr.snapshot()
    for _ in range(3):
        with tr.span("a"):
            tr.count("things", 2)
    assert tr.take() == []
    added = tr.since(snap)
    assert added["spans"]["a"]["n"] == 3 and added["spans"]["a"]["s"] > 0
    assert added["counters"] == {"things": 6}
    assert added["n_spans"] == 3
    # only the spans begun inside recording() are kept
    with tr.span("open"):
        with tr.recording():
            with tr.span("b"):
                pass
    (rec,) = tr.take()
    assert rec[2] == "b"
    assert tr.since(tr.snapshot()) == {"spans": {}, "counters": {}, "n_spans": 0}


def test_each_thread_nests_its_own_spans():
    """A span open on one thread is no parent of another thread's."""
    import threading

    tr = tracing.Tracer()

    def work():
        with tr.span("worker"):
            pass

    with tr.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    main, worker = tr.totals["main"], tr.totals["worker"]
    assert main[1] == main[0] and worker[1] == worker[0]


def test_decorated_function_runs_in_a_span():
    tr = tracing.Tracer()

    @tr.spanned("f")
    def f(x):
        with tr.span("g"):
            return x + 1

    assert f(1) == 2 and f(2) == 3 and f.__name__ == "f"
    assert tr.totals["f"][2] == 2 and tr.totals["g"][2] == 2


def test_recorded_stamps_bracket_the_profilers_events():
    """The records and torch.profiler's events share one clock."""
    from torch.profiler import ProfilerActivity, profile

    tr = tracing.Tracer()
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.recording():
            with tr.span("mm"):
                torch.mm(a, a)
    (rec,) = tr.take()
    evs = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert evs
    for ev in evs:
        assert rec[0] <= ev.start_ns() <= ev.end_ns() <= rec[1]


def repeat_rich_genome(seed=11, n=60_000):
    """Half its segments are lightly mutated copies from a 6 kbp core (the
    genome of tests/test_torch_split.py)."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, size=n // 10, dtype=np.uint8)
    parts, tot = [], 0
    while tot < n:
        if rng.random() < 0.5:
            s = rng.integers(0, max(1, len(core) - 600))
            seg = core[s : s + rng.integers(100, 600)].copy()
            idx = rng.integers(0, len(seg), max(1, len(seg) // 80))
            seg[idx] = rng.integers(0, 4, len(idx))
        else:
            seg = rng.integers(0, 4, size=rng.integers(100, 600), dtype=np.uint8)
        parts.append(seg)
        tot += len(seg)
    return np.concatenate(parts)[:n].astype(np.uint8)


def named_parts(spans):
    """compute_file's time as its named parts: the leaves' totals and the
    self time of the phases above them."""
    return (sum(spans[n]["s"] for n in LEAVES if n in spans)
            + tracing.seconds(spans, tracing.ORCHESTRATOR + ("engine.dedup",), "self_s"))


def test_engine_spans_name_all_of_compute_file():
    """The dedup pre-pass, the probe, calibration and the split pipeline
    (J = 16): every second of compute_file is a leaf (dispatch, fetch,
    scatter) or the self time of a phase, and the engine's timers are the
    leaves' totals."""
    ff = FastaFile(name="g.fa")
    ff.ids, ff.seqs = ["c1"], [repeat_rich_genome()]
    eng = MappabilityEngine(build_index([ff], sampling=5), batch_blocks=1024, device="cpu")
    eng._cal_batch = 96
    snap = tracing.snapshot()
    with tracing.span("map.compute"):
        eng.compute_file(eng.layouts[0], SearchParams(30, 15), 1, 65535)
    added = tracing.since(snap)
    spans = added["spans"]
    assert {"engine.dedup", "engine.blocks", "engine.probe", "engine.calibration",
            "engine.tier", "engine.prep", *LEAVES, "mapper.needles", "mapper.infix", "mapper.pack",
            "mapper.gather", "mapper.extend", "mapper.count", "mapper.probe"} <= set(spans)
    assert named_parts(spans) == pytest.approx(spans["map.compute"]["s"], rel=1e-9)
    for key, name in zip(("dispatch_s", "fetch_s", "scatter_s"), LEAVES):
        assert eng.stats[key] == pytest.approx(spans[name]["s"], rel=1e-9)
    assert eng.stats["batches"] == added["counters"]["engine.batches"] > 0
    # each phase-B batch is one prep and one dispatch, and no batch
    assert spans["engine.dispatch"]["n"] == eng.stats["batches"] + sum(
        eng.stats["rung_batches"].values())
    assert spans["engine.prep"]["n"] == sum(eng.stats["rung_batches"].values())


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 300)
    codes = np.concatenate([rng.integers(0, 4, 6000), np.tile(unit, 8),
                            rng.integers(0, 4, 6000)])
    with open(root / "g.fa", "w") as f:
        f.write(">c1\n" + np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode() + "\n")
    assert torch_main(["index", "-F", str(root / "g.fa"), "-I", str(root / "idx"),
                       "-S", "4"]) == 0
    return root


def map_job(root, name):
    out = root / name
    out.mkdir()
    report = {}
    assert map_main(["-I", str(root / "idx"), "-O", str(out) + "/", "-K", "20", "-E", "1",
                     "-fl", "-bg", "-r", "--device", "cpu"], report=report) == 0
    return report


def test_map_job_reports_its_trace(index_dir):
    rep = map_job(index_dir, "a")
    trace, st = rep["trace"], rep["stats"]
    spans = trace["spans"]
    assert trace["n_spans"] == sum(d["n"] for d in spans.values()) > 0
    for key, name in zip(("dispatch_s", "fetch_s", "scatter_s"), LEAVES):
        assert st[key] == pytest.approx(spans[name]["s"], rel=1e-9)
    assert st["batches"] == trace["counters"]["engine.batches"] > 0
    assert rep["compute_s"] == spans["map.compute"]["s"] > 0
    assert named_parts(spans) == pytest.approx(rep["compute_s"], rel=1e-9)
    assert {"map.job", "map.load_index", "map.engine_init", "engine.upload",
            "engine.seed_tables", "map.write.raw", "map.write.bedgraph"} <= set(spans)
    assert spans["map.job"]["n"] == 1
    # the job span holds its children
    inner = sum(spans[n]["s"] for n in spans if n.startswith("map.") and n != "map.job")
    assert inner <= spans["map.job"]["s"]


def test_each_map_job_records_its_spans_inside_its_root(index_dir):
    """Recorded, a job's spans lie inside its `map.job` and are as many as
    its report counts."""
    with tracing.recording():
        one = map_job(index_dir, "b")["trace"]
        two = map_job(index_dir, "c")["trace"]
    recs = tracing.take()
    roots = sorted(r for r in recs if r[2] == "map.job")
    assert len(roots) == 2 and roots[0][1] <= roots[1][0]
    inside = [[r for r in recs if root[0] <= r[0] <= r[1] <= root[1]] for root in roots]
    assert [len(x) for x in inside] == [one["n_spans"], two["n_spans"]]
    assert len(recs) == one["n_spans"] + two["n_spans"]


def test_verbose_engine_line_reads_the_totals(index_dir, capsys):
    out = index_dir / "v"
    out.mkdir()
    assert map_main(["-I", str(index_dir / "idx"), "-O", str(out) + "/", "-K", "20",
                     "-E", "1", "-fl", "-r", "-v", "--device", "cpu"]) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("- engine:"))
    named = re.findall(r"(\w+) [0-9.]+s", line)
    assert named == ["dispatch", "wait", "scatter", "dedup", "orchestrator"]
