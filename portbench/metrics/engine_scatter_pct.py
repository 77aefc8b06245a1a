"""Share of `compute_file` time spent writing results into the frequency
vector on the host: the program's `engine.scatter` span over
`compute_s`."""

from portbench.program_spans import seconds, share_of_compute


def read(record):
    return share_of_compute(record, lambda sp: seconds(sp, ("engine.scatter",)))
