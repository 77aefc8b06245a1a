"""One module per metric of BENCHMARK.json, found by the metric's name
(`metrics/<name>.py`).  Each has `read(record) -> float | None`: the metric
from the run's record (see harness.py), or None where the record holds
nothing to read it from; the harness then leaves the metric out."""
