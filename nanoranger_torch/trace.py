"""Spans and counters of one pipeline run: the run statistics' source.

`pipeline.run_pipeline` opens a run (`with trace.run():`). Inside it

    with trace.span("decon.read"):
        ...
    trace.count("match.rows", n)

records each span as [name, t0_ns, t1_ns, parent], parent being the index
of the span that was open around it (-1 for none), and adds to a counter.
Times are `time.time_ns()`, the clock torch.profiler stamps its events
with, so a span can be laid over a device trace of the same process.

Outside a run `span` returns one shared no-op object and `count` returns at
once: library callers (tests, tools, a BarcodeMatcher used directly) are
untraced and pay nothing. A span reads the host's clock and nothing else:
it never synchronises a device or reads from one, so it times what the
host already does. Spans open and close on the thread that runs the
pipeline.
"""

from __future__ import annotations

import contextlib
import time

MAX_SPANS = 100_000        # raw spans a run keeps; `trace.dropped` counts more

_active = None             # the open Run, or None


class Run:
    """The spans and counters of one run."""

    def __init__(self):
        self.t0_ns = time.time_ns()
        self.spans: list = []      # [name, t0_ns, t1_ns, parent index]
        self.counters: dict = {}
        self.totals: dict = {}     # name -> [n, ns, ns in child spans]
        self.dropped = 0
        self.open: list = []       # the open spans, innermost last

    def seconds(self, name: str) -> float:
        """Seconds in the closed spans named `name`."""
        return self.totals.get(name, (0, 0, 0))[1] / 1e9

    def doc(self) -> dict:
        """The run statistics' trace fields: the clock, the raw spans, each
        name's count, seconds and self seconds (less its child spans'), and
        the counters."""
        return {
            "clock": "time_ns",
            "spans": self.spans,
            "span_totals": {k: {"n": n, "s": ns / 1e9,
                                "self_s": (ns - child) / 1e9}
                            for k, (n, ns, child) in self.totals.items()},
            "counters": {**{k: int(v) for k, v in self.counters.items()},
                         "trace.dropped": self.dropped}}


class Span:
    """One timed region of a run (a context manager)."""

    __slots__ = ("name", "t0_ns", "t1_ns", "_run", "_idx", "_child_ns")

    def __init__(self, run: Run, name: str):
        self.name = name
        self._run = run
        self.t0_ns = self.t1_ns = 0

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def __enter__(self):
        r = self._run
        self._child_ns = 0
        self._idx = -1
        self.t0_ns = time.time_ns()
        if len(r.spans) < MAX_SPANS:
            # a parent opened before this span, so it is in the list too
            self._idx = len(r.spans)
            r.spans.append([self.name, self.t0_ns, 0,
                            r.open[-1]._idx if r.open else -1])
        else:
            r.dropped += 1
        r.open.append(self)
        return self

    def __exit__(self, *exc):
        self.t1_ns = t1 = time.time_ns()
        r = self._run
        r.open.pop()
        d = t1 - self.t0_ns
        if self._idx >= 0:
            r.spans[self._idx][2] = t1
        if r.open:
            r.open[-1]._child_ns += d
        tot = r.totals.get(self.name)
        if tot is None:
            r.totals[self.name] = [1, d, self._child_ns]
        else:
            tot[0] += 1
            tot[1] += d
            tot[2] += self._child_ns
        return False


class _NoSpan:
    """The span outside a run: times nothing."""

    name = ""
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager timing `name` in the open run; the shared no-op
    outside a run."""
    return _NO_SPAN if _active is None else Span(_active, name)


def count(name: str, n: int = 1) -> None:
    """Add the host integer `n` to the counter `name` of the open run."""
    if _active is None:
        return
    c = _active.counters
    c[name] = c.get(name, 0) + n


def active() -> Run | None:
    """The open run, or None."""
    return _active


@contextlib.contextmanager
def run():
    """Open a run for the block (a run opened inside it stands alone and
    gives the outer one back at its end)."""
    global _active
    prev, _active = _active, Run()
    try:
        yield _active
    finally:
        _active = prev
