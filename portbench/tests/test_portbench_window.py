"""The window's accounting: jobs start until the time has passed, every
started job finishes, the window closes at the last job's end."""

from portbench.harness import load_module
from portbench.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_jobs_run_until_the_time_and_finish():
    clock = Clock()

    def job(i):
        clock.t += 3.0  # each job takes 3 s
        return dict(ok=True, n_kmers=1000)

    w = run_window(job, 10.0, clock)
    # jobs start at 0, 3, 6, 9 (< 10); the fourth ends at 12
    assert len(w["jobs"]) == 4
    assert w["window_s"] == 12.0
    assert [j["start"] for j in w["jobs"]] == [0.0, 3.0, 6.0, 9.0]
    rate = load_module("metrics", "kmers_per_s").read({"window": w})
    assert rate == 4000 / 12.0


def test_a_failed_job_ends_the_window():
    clock = Clock()

    def job(i):
        clock.t += 1.0
        if i == 1:
            raise RuntimeError("boom")
        return dict(ok=True, n_kmers=5)

    w = run_window(job, 10.0, clock)
    assert len(w["jobs"]) == 2 and not w["jobs"][1]["ok"]
    assert "boom" in w["jobs"][1]["error"]
    assert w["window_s"] == 2.0


def test_one_job_longer_than_the_window():
    clock = Clock()

    def job(i):
        clock.t += 25.0
        return dict(ok=True, n_kmers=50)

    w = run_window(job, 10.0, clock)
    assert len(w["jobs"]) == 1 and w["window_s"] == 25.0
