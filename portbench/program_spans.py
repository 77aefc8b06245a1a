"""The program's own span totals, as `map_main` reports them
(`report["trace"]["spans"]`, from `genmap_tpu_torch.tracing`: per span name
its seconds `s`, self seconds `self_s` and calls `n`), summed over the
window's jobs that returned 0.  A checkout whose program reports no trace
gives None, and the harness leaves the metric out."""

from __future__ import annotations

# spans whose self time is the orchestrator's own Python inside compute_file
# (named here, not imported: the yardstick stays the benchmark's)
ORCHESTRATOR = ("map.compute", "engine.blocks", "engine.probe", "engine.calibration",
                "engine.tier", "engine.rescue", "engine.prep")


def traced_jobs(record) -> list | None:
    jobs = [j for j in record["window"]["jobs"] if j["ok"]]
    if not jobs or any("trace" not in j["report"] for j in jobs):
        return None
    return jobs


def seconds(spans: dict, names, key: str = "s") -> float:
    """`key` ("s" or "self_s") summed over the spans `names` (absent: 0)."""
    return sum(spans[n][key] for n in names if n in spans)


def share_of_compute(record, part) -> float | None:
    """100 x the sum of part(spans) over the sum of `compute_s`."""
    jobs = traced_jobs(record)
    if jobs is None:
        return None
    compute = sum(j["report"]["compute_s"] for j in jobs)
    if compute <= 0:
        return None
    return 100.0 * sum(part(j["report"]["trace"]["spans"]) for j in jobs) / compute
