"""Host microseconds the block mappers take per kernel launch of the port:
the program's `mapper.*` spans (needle extraction, infix scan, extension
levels, count tail, probe, phase-A pack, phase-B gather) over the port's
launch counters."""

from portbench.program_spans import traced_jobs


def read(record):
    jobs = traced_jobs(record)
    if jobs is None:
        return None
    launches = sum(sum(j["launches"].values()) for j in jobs)
    if not launches:
        return None
    issue = sum(d["s"] for j in jobs for n, d in j["report"]["trace"]["spans"].items()
                if n.startswith("mapper."))
    return 1e6 * issue / launches
