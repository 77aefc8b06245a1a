"""The traced window: torch.profiler over it, and its reading.

The profiler records device activity only (CUPTI: kernels, copies, fills):
recording every host op as well doubled a (101,2) job's wall time on the
H100's host.  The host's spans are the harness's own (`Spans`), taken with
`time.time_ns()`, the clock on which the profiler stamps its events.  From
the raw events (no per-op tables are built) come the window's length, the
union of the device's busy intervals inside it, device seconds by kernel of
the port and by device op, and the idle gaps, their time split over the
innermost spans the host was in.
"""

from __future__ import annotations

import bisect
import re

import contextlib
import time

WINDOW_SPAN = "portbench.window"
JOB_SPAN = "portbench.job"


class Spans:
    """Host spans as (start ns, end ns, name), in memory."""

    def __init__(self):
        self.spans: list[tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def wrap(self, fn, name: str):
        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return spanned


def op_name(name: str) -> str:
    """A device op's name without its return type, template arguments and
    parameters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


class Profiled:
    """Context manager: torch.profiler recording the device's activity (on
    the CPU, which has none, the host's ops, so that the tests read a
    trace)."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_events(events, symbols: dict[str, str], spans, window) -> dict:
    """The window's numbers from raw profiler events and the host's spans
    (see the module docstring); `window` is (start ns, end ns); times in
    seconds."""
    from torch.autograd import DeviceType

    dev = [(ev.start_ns(), ev.end_ns(), ev.name()) for ev in events
           if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()]
    spans = [s_ for s_ in spans if s_[2] != WINDOW_SPAN]
    w0, w1 = window
    kernel_s: dict[str, float] = {}
    op_s: dict[str, float] = {}
    inside = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        base = op_name(name)
        op_s[base] = op_s.get(base, 0.0) + (e - s) / 1e9
        k = symbols.get(base)
        if k is not None:
            kernel_s[k] = kernel_s.get(k, 0.0) + (e - s) / 1e9
    busy = _union(inside)
    busy_ns = sum(e - s for s, e in busy)
    # the window cut at every span's ends; each piece named by the innermost
    # span around its middle; each idle gap's time split over the pieces
    cuts = sorted({w0, w1, *(t for s_, e_, _n in spans for t in (s_, e_) if w0 < t < w1)})
    labels = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        mid = (a + b) // 2
        best = min(((e_ - s_, n) for s_, e_, n in spans if s_ <= mid < e_), default=None)
        labels.append(best[1] if best else "outside any span")
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
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                kernel_s=kernel_s, device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
                device_events=len(dev))
