"""Spans and counters of the port's host path: one tracer per process.

`span(name)` times a block of host code (`spanned(name)` a function's
calls).  On exit it adds to per-name totals its duration, its self time
(the duration less what its child spans cover; a span's parent is the
innermost span open on the thread) and one call.  That costs a stack push,
two clock reads and two dict updates, and is always on.  `count(name, n)`
adds to a counter.  `snapshot()` and `since()` read what a piece of work (a
`map` job, one `compute_file`) added to the totals and counters.

Only inside `recording()` does a span also keep a record
(start ns, end ns, name), stamped on `time.time_ns()`, the clock on which
torch.profiler stamps its events, so the records line up with a device
trace.  Records are kept as spans end; `take()` hands out those kept so
far.  A span's `ns` holds its duration once it has ended.

The totals are not locked: one thread issues the map path's spans.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager

_perf = time.perf_counter_ns
_wall = time.time_ns

# the map path's spans whose self time is the orchestrator's own Python
# inside compute_file: routing, rung sorting, phase-B batch prep,
# calibration arithmetic, reset_limits
ORCHESTRATOR = ("map.compute", "engine.blocks", "engine.probe", "engine.calibration",
                "engine.tier", "engine.rescue", "engine.prep")


class _Span:
    __slots__ = ("tr", "name", "stack", "t0", "child", "w0", "ns")

    def __init__(self, tr: Tracer, name: str):
        self.tr, self.name = tr, name

    def __enter__(self):
        tr = self.tr
        stack = self.stack = tr._stack()
        self.w0 = _wall() if tr._recording else None
        stack.append(self)
        self.child = 0
        self.t0 = _perf()
        return self

    def __exit__(self, *exc):
        dt = self.ns = _perf() - self.t0
        tr = self.tr
        if self.w0 is not None:
            tr._records.append((self.w0, _wall(), self.name))
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        tot = tr.totals.get(self.name)
        if tot is None:
            tot = tr.totals[self.name] = [0, 0, 0]
        tot[0] += dt
        tot[1] += dt - self.child
        tot[2] += 1
        return False


class Tracer:
    """Per-name span totals {name: [ns, self ns, calls]}, counters, and the
    records kept while recording (see the module docstring)."""

    def __init__(self):
        self.totals: dict[str, list[int]] = {}
        self.counters: dict[str, int] = {}
        self._records: list = []
        self._recording = 0
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def spanned(self, name: str):
        """Decorator: every call of the function runs in a span `name`."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with _Span(self, name):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextmanager
    def recording(self):
        self._recording += 1
        try:
            yield
        finally:
            self._recording -= 1

    def take(self) -> list:
        out, self._records = self._records, []
        return out

    def snapshot(self) -> tuple[dict, dict]:
        return ({k: tuple(v) for k, v in self.totals.items()}, dict(self.counters))

    def since(self, snap: tuple[dict, dict]) -> dict:
        """What was added after `snap`: spans {name: {"s", "self_s", "n"}},
        counters {name: n} and n_spans, the spans ended."""
        totals0, counters0 = snap
        counters = {k: v - counters0.get(k, 0) for k, v in self.counters.items()
                    if v != counters0.get(k, 0)}
        spans = {}
        for k, (ns, self_ns, n) in self.totals.items():
            ns0, self0, n0 = totals0.get(k, (0, 0, 0))
            if n > n0:
                spans[k] = {"s": (ns - ns0) / 1e9, "self_s": (self_ns - self0) / 1e9,
                            "n": n - n0}
        return {"spans": spans, "counters": counters,
                "n_spans": sum(d["n"] for d in spans.values())}


def seconds(spans: dict, names, key: str = "s") -> float:
    """`key` ("s" or "self_s") summed over the spans `names` of `since`'s
    spans (absent: 0)."""
    return sum(spans[n][key] for n in names if n in spans)


TRACER = Tracer()
span = TRACER.span
spanned = TRACER.spanned
count = TRACER.count
recording = TRACER.recording
take = TRACER.take
snapshot = TRACER.snapshot
since = TRACER.since
