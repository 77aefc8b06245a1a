"""The measured window: a closed loop with one client.

Jobs start back to back until `seconds` have passed since the window
opened; every job that started runs to its end, and the window closes at
the end of the last one.  A job that fails ends the loop (the run is not
correct)."""

from __future__ import annotations

import time
import traceback


def run_window(job, seconds: float, clock=time.perf_counter) -> dict:
    """job(i) -> dict with "ok"; returns the jobs, each with its start, end
    and wall seconds relative to the window's opening, and `window_s`."""
    jobs = []
    t0 = clock()
    while clock() - t0 < seconds:
        start = clock()
        try:
            res = job(len(jobs))
        except Exception:  # the job failed; the harness reports it
            res = dict(ok=False, error=traceback.format_exc(limit=8))
        end = clock()
        jobs.append(dict(res, start=start - t0, end=end - t0, wall_s=end - start))
        if not res["ok"]:
            break
    return dict(seconds=seconds, window_s=jobs[-1]["end"], jobs=jobs)
