"""Share of `compute_file` time spent in the orchestrator's own Python
(routing, rung sorting, calibration arithmetic, resetLimits): the self time
of its phase spans (`program_spans.ORCHESTRATOR`) over `compute_s`.  With
`engine_dispatch_pct`, `engine_wait_pct`, `engine_scatter_pct` and
`engine_dedup_pct` it splits `compute_file` into named parts."""

from portbench.program_spans import ORCHESTRATOR, seconds, share_of_compute


def read(record):
    return share_of_compute(record, lambda sp: seconds(sp, ORCHESTRATOR, "self_s"))
