"""Share of the window's job wall time spent outside `compute_file`: index
load, engine construction (upload, seed tables) and the writers."""


def read(record):
    jobs = [j for j in record["window"]["jobs"] if j["ok"]]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(j["report"]["compute_s"] for j in jobs) / wall)
