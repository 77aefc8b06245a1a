"""Kernel launches of the port (its launch counters) per million k-mers."""


def read(record):
    jobs = [j for j in record["window"]["jobs"] if j["ok"]]
    kmers = sum(j["n_kmers"] for j in jobs)
    if not kmers:
        return None
    return 1e6 * sum(sum(j["launches"].values()) for j in jobs) / kmers
