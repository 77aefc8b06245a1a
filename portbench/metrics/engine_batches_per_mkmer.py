"""Batches per million k-mers: the engine's `batches` (phase A included)
and its phase-B `rung_batches`."""


def read(record):
    jobs = [j for j in record["window"]["jobs"] if j["ok"]]
    kmers = sum(j["n_kmers"] for j in jobs)
    if not kmers:
        return None
    batches = sum(j["report"]["stats"]["batches"]
                  + sum(j["report"]["stats"].get("rung_batches", {}).values())
                  for j in jobs)
    return 1e6 * batches / kmers
