"""Share of `compute_file` time in which the orchestrator waits for a
batch's results: the program's `engine.fetch` span (every `.cpu()` of
results: the wait for the device and the copy) over `compute_s`."""

from portbench.program_spans import seconds, share_of_compute


def read(record):
    return share_of_compute(record, lambda sp: seconds(sp, ("engine.fetch",)))
