"""Each metric module on a synthetic record."""

import pytest

from portbench.harness import load_module
from portbench.trace import op_name, read_events


def job(ok=True, wall=2.0, compute=1.5, dispatch=1.2, batches=10, rungs=None,
        launches=None, kmers=1_000_000):
    return dict(ok=ok, wall_s=wall, n_kmers=kmers, launches=launches or {"compact": 100},
                report=dict(compute_s=compute, stats=dict(dispatch_s=dispatch, batches=batches,
                                                          rung_batches=rungs or {})))


def record(jobs, trace=None, work=None):
    return dict(setup=dict(setup_s=20.0, index_build_s=9.0),
                window=dict(seconds=10, window_s=sum(j["wall_s"] for j in jobs), jobs=jobs),
                memory=dict(window_peak_bytes=3 * 2**30), trace=trace, work=work)


def read(name, rec):
    return load_module("metrics", name).read(rec)


def test_end_to_end():
    rec = record([job(), job(), job(ok=False, kmers=0)])
    assert read("kmers_per_s", rec) == pytest.approx(2e6 / 6.0)
    assert read("setup_s", rec) == 20.0
    assert read("index_build_s", rec) == 9.0


def test_layers_of_the_program():
    rec = record([job(rungs={(1, 8): 3, (1, 16): 2}), job(batches=20)])
    assert read("cli_overhead_pct", rec) == pytest.approx(25.0)
    assert read("engine_dispatch_pct", rec) == pytest.approx(80.0)
    assert read("engine_batches_per_mkmer", rec) == pytest.approx(35 / 2)
    assert read("launches_per_mkmer", rec) == pytest.approx(100.0)
    assert read("device_peak_gib", rec) == pytest.approx(3.0)


def test_trace_metrics_read_nothing_without_a_trace():
    rec = record([job()])
    for name in ("kernel_roofline_pct", "device_idle_pct"):
        assert read(name, rec) is None


def test_roofline_scales_the_counted_job_by_launches():
    jobs = [job(launches={"compact": 100, "dimer_step": 10})] * 3
    trace = dict(window_s=6.0, busy_s=1.5,
                 kernel_s={"compact": 0.30, "dimer_step": 0.10, "locate": 0.5})
    work = dict(bound_s={"compact": 0.01, "dimer_step": 0.005},
                launches={"compact": 100, "dimer_step": 10})
    rec = record(jobs, trace, work)
    # (0.01 + 0.005) x 3 jobs over 0.40 s; locate has no count
    assert read("kernel_roofline_pct", rec) == pytest.approx(100 * 0.045 / 0.40)
    assert read("device_idle_pct", rec) == pytest.approx(75.0)


class Ev:
    def __init__(self, name, s, e, cuda):
        from torch.autograd import DeviceType

        self._n, self._s, self._e = name, s, e
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


def test_trace_reading():
    spans = [(100, 900, "MappabilityEngine.compute_file"), (900, 1000, "save_raw"),
             (0, 1000, "portbench.window")]
    evs = [Ev("void compact_kernel<4>(int*, int)", 200, 300, True),
           Ev("void at::native::elementwise<float>(int)", 250, 400, True),
           Ev("Memcpy DtoH (Device -> Pinned)", 950, 960, True),
           Ev("aten::add", 10, 20, False)]
    out = read_events(evs, {"compact_kernel": "compact"}, spans, (0, 1000))
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(210e-9)
    assert out["kernel_s"] == {"compact": pytest.approx(100e-9)}
    gaps = dict(out["idle_gaps"])
    assert gaps["outside any span"] == pytest.approx(100e-9)
    assert gaps["MappabilityEngine.compute_file"] == pytest.approx(600e-9)
    assert gaps["save_raw"] == pytest.approx(90e-9)
    assert dict(out["device_ops"])["at::native::elementwise"] == pytest.approx(150e-9)
    assert op_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert op_name("void at::native::(anonymous namespace)::cat_kernel<int>(int)") == \
        "at::native::cat_kernel"


def test_sampled_bounds_stand_for_every_call():
    from portbench.harness import COUNT_ALL, COUNT_EVERY, sampled_total

    calls = COUNT_ALL + 3 * COUNT_EVERY + 5
    later = [(j, 1.0) for j in range(COUNT_ALL, calls) if (j - COUNT_ALL) % COUNT_EVERY == 0]
    assert sampled_total(float(COUNT_ALL), later, calls) == calls
    assert sampled_total(3.0, [], 3) == 3.0
