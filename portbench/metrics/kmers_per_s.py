"""k-mers of the window's jobs that returned 0 over the wall time from the
window's start to the end of its last job (end to end, host clock)."""


def read(record):
    w = record["window"]
    kmers = sum(j["n_kmers"] for j in w["jobs"] if j["ok"])
    return kmers / w["window_s"] if kmers and w["window_s"] > 0 else None
