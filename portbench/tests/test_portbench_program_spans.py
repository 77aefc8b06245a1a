"""The metrics that read the program's own spans (`report["trace"]`): each on
a synthetic record, nothing from a program that reports no trace, and on a
CPU-traced window the program's spans fed to `read_events` beside the
harness's name the idle gaps and change no other metric.  `program_gaps`
(a traced run whose gaps are named by the program's spans): its sweep labels
every piece as `read_events`'s search does, and a traced run through it
names the gaps by program spans."""

import time

import numpy as np
import pytest
from conftest import tiny_config, tiny_spec

from portbench import program_gaps
from portbench.harness import load_module, result_line, run_cell
from portbench.trace import JOB_SPAN, WINDOW_SPAN, Profiled, Spans, read_events

NEW = ("engine_wait_pct", "engine_scatter_pct", "engine_dedup_pct", "engine_self_pct",
       "mapper_issue_us_per_launch")


def spans(**kw):
    return {n.replace("__", "."): dict(zip(("s", "self_s", "n"), v)) for n, v in kw.items()}


def job(trace=True, ok=True, compute=10.0, launches=2000):
    report = dict(compute_s=compute, stats=dict(dispatch_s=6.0, batches=10, rung_batches={}))
    if trace:
        report["trace"] = dict(n_spans=40, counters={"engine.batches": 10}, spans=spans(
            map__compute=(compute, 0.1, 1), engine__dedup=(0.5, 0.4, 1),
            engine__blocks=(9.0, 0.2, 1), engine__probe=(1.0, 0.1, 1),
            engine__calibration=(0.6, 0.1, 2), engine__tier=(7.0, 0.6, 3),
            engine__dispatch=(6.0, 0.5, 20), engine__fetch=(1.0, 1.0, 20),
            engine__scatter=(1.5, 1.5, 20), mapper__infix=(3.0, 3.0, 20),
            mapper__extend=(2.0, 2.0, 18), mapper__needles=(0.5, 0.5, 20)))
    return dict(ok=ok, wall_s=compute + 1, n_kmers=10**6, launches={"compact": launches},
                report=report)


def record(jobs):
    return dict(window=dict(window_s=sum(j["wall_s"] for j in jobs), jobs=jobs))


def read(name, rec):
    return load_module("metrics", name).read(rec)


def test_each_metric_on_a_synthetic_record():
    rec = record([job(), job(compute=30.0, launches=6000), job(ok=False, trace=False)])
    # fetch 1.0 + 1.0, scatter 1.5 + 1.5, dedup self 0.4 + 0.4, orchestrator
    # self (0.1 + 0.2 + 0.1 + 0.1 + 0.6) x 2 over compute 40 s; mapper 5.5 s
    # x 2 over 8,000 launches
    assert read("engine_wait_pct", rec) == pytest.approx(100 * 2.0 / 40)
    assert read("engine_scatter_pct", rec) == pytest.approx(100 * 3.0 / 40)
    assert read("engine_dedup_pct", rec) == pytest.approx(100 * 0.8 / 40)
    assert read("engine_self_pct", rec) == pytest.approx(100 * 2.2 / 40)
    assert read("mapper_issue_us_per_launch", rec) == pytest.approx(1e6 * 11.0 / 8000)


def test_a_job_without_the_dedup_or_a_phase_reads_zero():
    j = job()
    del j["report"]["trace"]["spans"]["engine.dedup"]
    rec = record([j])
    assert read("engine_dedup_pct", rec) == 0.0
    assert read("engine_wait_pct", rec) == pytest.approx(10.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_a_program_without_a_trace(name):
    assert read(name, record([job(trace=False)])) is None
    assert read(name, record([job(), job(trace=False)])) is None
    assert read(name, record([job(ok=False)])) is None


def test_the_parts_split_compute_file(bench):
    """dispatch + wait + scatter + dedup + orchestrator self cover compute_s
    when the spans name all of it (synthetic: 6 + 1 + 1.5 + 0.4 + 1.1 =
    10 s)."""
    rec = record([job()])
    rec["window"]["jobs"][0]["report"]["stats"]["dispatch_s"] = 6.0
    total = sum(read(n, rec) for n in ("engine_dispatch_pct", "engine_wait_pct",
                                        "engine_scatter_pct", "engine_dedup_pct",
                                        "engine_self_pct"))
    assert total == pytest.approx(100.0)
    assert {m["name"] for m in bench["per_layer"]} >= set(NEW)


def test_program_spans_name_the_idle_gaps_and_change_no_other_metric(tmp_path, bench):
    """Two CPU map jobs in a traced window (the harness's spans around the
    port's layers, the program recording its own): read with the program's
    spans added, the idle gaps fall on program spans, and every per-layer
    metric reads as without them."""
    from genmap_tpu_torch import tracing
    from portbench import program
    from portbench.genome import make_genome, write_fasta

    g = make_genome(tiny_config((6000, 3000)), 5)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, g)
    program.build_index(fa, str(tmp_path / "idx"), 10)
    harness = Spans()
    jobs = []
    with Profiled(False) as prof, program.host_spans(harness), tracing.recording():
        with harness.span(WINDOW_SPAN):
            for i in range(2):
                out = tmp_path / f"job{i}"
                out.mkdir()
                with harness.span(JOB_SPAN):
                    res = program.map_job(["-I", str(tmp_path / "idx"), "-O", f"{out}/",
                                           "-K", "20", "-E", "1", "-fl", "-bg"], "cpu")
                jobs.append(dict(res, ok=res["rc"] == 0, wall_s=1.0,
                                 n_kmers=res["report"]["n_kmers"]))
    recs = tracing.take()
    assert sum(r[2] == "map.job" for r in recs) == 2 and all(j["ok"] for j in jobs)
    window = next(s for s in harness.spans if s[2] == WINDOW_SPAN)[:2]
    symbols = program.kernel_symbols()
    events = prof.events()
    alone = read_events(events, symbols, harness.spans, window)
    fed = read_events(events, symbols, harness.spans + recs, window)
    gaps, before = dict(fed["idle_gaps"]), dict(alone["idle_gaps"])
    idle = sum(before.values())
    assert before["MappabilityEngine.compute_file"] > 0.5 * idle
    unnamed = gaps.get("MappabilityEngine.compute_file", 0) + gaps.get("map.compute", 0)
    assert unnamed < 0.1 * idle
    assert any(n.startswith(("engine.", "mapper.")) for n in gaps)
    for name in ("window_s", "busy_s", "kernel_s", "device_ops", "device_events"):
        assert fed[name] == alone[name]
    assert program_gaps.read_events(events, symbols, harness.spans + recs, window) == fed
    base = dict(setup=dict(setup_s=1.0, index_build_s=1.0),
                window=dict(window_s=2.0, jobs=jobs),
                memory=dict(window_peak_bytes=2**30), work=None)
    for m in bench["per_layer"]:
        mod = load_module("metrics", m["name"])
        assert mod.read(dict(base, trace=fed)) == mod.read(dict(base, trace=alone)), m["name"]


def searched_labels(spans, cuts):
    """`trace.read_events`'s labelling as it stands (the oracle): each
    piece's middle searched over every span."""
    labels = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        mid = (a + b) // 2
        best = min(((e_ - s_, n) for s_, e_, n in spans if s_ <= mid < e_), default=None)
        labels.append(best[1] if best else "outside any span")
    return labels


NAMES = ("map.job", "engine.tier", "engine.dispatch", "mapper.extend", "engine.fetch")


def nested(rng, t0, t1, depth):
    """Properly nested spans inside [t0, t1): children in turn inside each
    span, some empty, some twins (same ends, another name)."""
    out, t = [], t0
    while depth and t < t1:
        s = t + int(rng.integers(0, 40))
        e = min(t1, s + int(rng.integers(0, 600)))
        if e < s:
            break
        out.append((s, e, str(rng.choice(NAMES))))
        if rng.random() < 0.1:
            out.append((s, e, str(rng.choice(NAMES))))
        out += nested(rng, s, e, depth - 1)
        t = e + int(rng.integers(0, 40))
    return out


def span_set(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "nested":
        spans = nested(rng, 0, 20_000, 5)
    else:  # any overlap: the rule is a minimum over the spans around a point
        s = rng.integers(-500, 20_000, 400)
        spans = [(int(a), int(a + rng.integers(0, 3000)), str(rng.choice(NAMES))) for a in s]
    return spans, (int(rng.integers(0, 300)), int(rng.integers(19_000, 21_000)))


class DeviceEvent:
    def __init__(self, s, e):
        self.s, self.e = s, e

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def name(self):
        return "void k<1>(int)"


@pytest.mark.parametrize("kind", ["nested", "overlapping"])
@pytest.mark.parametrize("seed", range(6))
def test_the_sweep_labels_as_the_search_does(kind, seed):
    spans, (w0, w1) = span_set(kind, seed)
    cuts = sorted({w0, w1, *(t for s, e, _n in spans for t in (s, e) if w0 < t < w1)})
    assert program_gaps.label_pieces(spans, cuts) == searched_labels(spans, cuts)
    rng = np.random.default_rng(seed + 100)
    starts = np.sort(rng.integers(-200, 21_000, 60))
    events = [DeviceEvent(int(a), int(a + rng.integers(1, 400))) for a in starts]
    window = (w0, w1)
    assert program_gaps.read_events(events, {"k": "k"}, spans, window) == read_events(
        events, {"k": "k"}, spans, window)


def test_a_traced_run_names_its_gaps_by_the_programs_spans(bench):
    """A traced CPU run of a tiny cell through program_gaps: the gaps fall
    on program spans, the run is judged as any other, and the harness is
    left as it was."""
    from portbench import program, trace

    spec = tiny_spec(bench)
    with program_gaps.named_by_program_spans():
        out = run_cell(spec, 2**31 + 7, 0.5, True, "cpu", time.perf_counter(),
                       log=lambda m: None)
    assert program.host_spans is program_gaps.HOST_SPANS
    assert trace.read_events is program_gaps.READ_EVENTS
    tr = out["record"]["trace"]
    gaps = dict(tr["idle_gaps"])
    idle = tr["window_s"] - tr["busy_s"]
    unnamed = gaps.get("MappabilityEngine.compute_file", 0) + gaps.get("map.compute", 0)
    assert unnamed < 0.1 * idle
    assert tr["idle_gaps"][0][0].startswith(("engine.", "mapper."))
    assert result_line(spec, out, True, "cpu", 1)["correct"]
