"""Share of `compute_file` time that the orchestrator spends issuing
batches (the engine's `dispatch_s` over the map's `compute_s`)."""


def read(record):
    jobs = [j for j in record["window"]["jobs"] if j["ok"]]
    compute = sum(j["report"]["compute_s"] for j in jobs)
    if not jobs or compute <= 0:
        return None
    return 100.0 * sum(j["report"]["stats"]["dispatch_s"] for j in jobs) / compute
