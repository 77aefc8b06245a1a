"""The port's kernels' share of their roofline in the window: the sum of
the calls' bounds over the sum of their device time.  The bounds come from
one counted job after the window (work.py, the calls' arguments: all of a
kernel's first 64 calls, then every 8th, harness.counted_job), scaled by
each kernel's launches in the window over those in the counted job; device
time from the trace.  Kernels without a count in work.py are left out of
both sums."""


def read(record):
    trace, work = record.get("trace"), record.get("work")
    if not trace or not work:
        return None
    launches = {}
    for j in record["window"]["jobs"]:
        for k, n in j["launches"].items():
            launches[k] = launches.get(k, 0) + n
    bound = device = 0.0
    for k, dev_s in trace["kernel_s"].items():
        counted = work["launches"].get(k, 0)
        if k not in work["bound_s"] or counted == 0 or dev_s <= 0:
            continue
        bound += work["bound_s"][k] * launches.get(k, 0) / counted
        device += dev_s
    return 100.0 * bound / device if device > 0 and bound > 0 else None
