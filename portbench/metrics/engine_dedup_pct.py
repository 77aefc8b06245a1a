"""Share of `compute_file` time spent in the dedup gate's host key pass
(text decode, sampled duplicate rate, keys, `np.unique`, the class copy):
the self time of the program's `engine.dedup` span over `compute_s`."""

from portbench.program_spans import seconds, share_of_compute


def read(record):
    return share_of_compute(record, lambda sp: seconds(sp, ("engine.dedup",), "self_s"))
