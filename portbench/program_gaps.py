"""A traced run of a cell whose idle gaps are named by the port's own spans:

    python3 portbench/program_gaps.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with a CUDA card.  It is
`run.py --trace 1` with two changes, made from here: inside the window the
port also records its spans (`genmap_tpu_torch.tracing.recording()`), which
join the harness's own, so each idle gap falls on the innermost program
span the host was in (`mapper.extend`, `engine.scatter`, ...) and no longer
on `MappabilityEngine.compute_file`; and the gaps are labelled by a sweep
(`label_pieces`), since `trace.read_events` searches every span for every
cut and cannot take the ~10^4 spans a job records.  Every other number of
the result line is read as `run.py` reads it.  The benchmark's command does
not run this.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, as run.py does

import bisect  # noqa: E402
import contextlib  # noqa: E402
import heapq  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import program, trace  # noqa: E402

# the harness's own, which a run through this module replaces while it runs
READ_EVENTS = trace.read_events
HOST_SPANS = program.host_spans


def label_pieces(spans, cuts) -> list[str]:
    """Per piece [cuts[i], cuts[i+1]) the innermost span around its middle,
    by `trace.read_events`'s rule (the shortest span with start <= middle <
    end, then the first name), or "outside any span": a sweep over the
    spans by start with a heap of those begun, O((n + m) log n)."""
    order = sorted(spans)
    heap: list = []
    labels, j = [], 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        mid = (a + b) // 2
        while j < len(order) and order[j][0] <= mid:
            s, e, name = order[j]
            heapq.heappush(heap, (e - s, name, e))
            j += 1
        while heap and heap[0][2] <= mid:
            heapq.heappop(heap)
        labels.append(heap[0][1] if heap else "outside any span")
    return labels


def idle_gaps(busy, spans, window) -> dict[str, float]:
    """The idle seconds between the device's busy intervals `busy` (sorted,
    merged) inside `window`, split over the innermost span of each piece
    (the rest of `trace.read_events`, with `label_pieces`)."""
    w0, w1 = window
    cuts = sorted({w0, w1, *(t for s_, e_, _n in spans for t in (s_, e_) if w0 < t < w1)})
    labels = label_pieces(spans, cuts)
    gaps: dict[str, float] = {}
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            i = max(0, bisect.bisect_right(cuts, prev) - 1)
            while i < len(labels) and cuts[i] < s:
                lo, hi = max(prev, cuts[i]), min(s, cuts[i + 1])
                if hi > lo:
                    gaps[labels[i]] = gaps.get(labels[i], 0.0) + (hi - lo) / 1e9
                i += 1
        prev = max(prev, e)
    return gaps


def read_events(events, symbols, spans, window) -> dict:
    """`trace.read_events` with the idle gaps labelled by the sweep: the
    device's numbers as it reads them (given no span, which it does not
    search), the gaps over every span."""
    from torch.autograd import DeviceType

    out = READ_EVENTS(events, symbols, [], window)
    w0, w1 = window
    busy = trace._union([(max(ev.start_ns(), w0), min(ev.end_ns(), w1)) for ev in events
                         if ev.device_type() == DeviceType.CUDA
                         and not ev.is_user_annotation()
                         and min(ev.end_ns(), w1) > max(ev.start_ns(), w0)])
    gaps = idle_gaps(busy, [s_ for s_ in spans if s_[2] != trace.WINDOW_SPAN], window)
    out["idle_gaps"] = [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
    return out


@contextlib.contextmanager
def host_and_program_spans(spans):
    """`program.host_spans`, and the port's spans recorded beside them and
    added to the harness's list on exit."""
    from genmap_tpu_torch import tracing

    tracing.take()
    with HOST_SPANS(spans), tracing.recording():
        yield
    spans.spans.extend(tracing.take())


@contextlib.contextmanager
def named_by_program_spans():
    """While open, the harness's traced runs record the port's spans and
    label the idle gaps by the sweep."""
    program.host_spans, trace.read_events = host_and_program_spans, read_events
    try:
        yield
    finally:
        program.host_spans, trace.read_events = HOST_SPANS, READ_EVENTS


def main(argv: list[str]) -> int:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    from portbench.harness import main as harness_main

    with named_by_program_spans():
        return harness_main([*argv, "--trace", "1"], T_START)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
