"""The port's tracer (nanoranger_torch/trace.py) and the run statistics
built on it (pipeline.Telemetry): spans nest with their parents and self
times, are free outside a run, stop at the cap and count what they drop,
and share the clock of torch.profiler's events. The stage rows of real
runs are held in the tests that make those runs
(test_torch_fast_path.py, test_torch_genome.py)."""

import json
import time

import torch

from nanoranger_torch import pipeline, trace

torch.set_num_threads(1)


def _busy(ns):
    t = time.time_ns()
    while time.time_ns() - t < ns:
        pass


def test_nesting_parents_and_self_time():
    with trace.run() as r:
        with trace.span("a") as a:
            _busy(2_000_000)
            with trace.span("a.b") as b:
                _busy(3_000_000)
                with trace.span("a.b.c"):
                    _busy(1_000_000)
            with trace.span("a.b"):
                _busy(1_000_000)
        with trace.span("d"):
            pass
        trace.count("rows", 3)
        trace.count("rows", 4)
        trace.count("once")
    names = [s[0] for s in r.spans]
    assert names == ["a", "a.b", "a.b.c", "a.b", "d"]
    assert [s[3] for s in r.spans] == [-1, 0, 1, 0, -1]
    for name, t0, t1, parent in r.spans:
        assert t0 <= t1
        if parent >= 0:
            assert r.spans[parent][1] <= t0 and t1 <= r.spans[parent][2]
    assert (a.t0_ns, a.t1_ns) == tuple(r.spans[0][1:3])
    assert b.seconds == (r.spans[1][2] - r.spans[1][1]) / 1e9
    tot = r.doc()["span_totals"]
    assert tot["a.b"]["n"] == 2 and tot["a"]["n"] == 1
    ab = sum((s[2] - s[1]) for s in r.spans if s[0] == "a.b") / 1e9
    c = (r.spans[2][2] - r.spans[2][1]) / 1e9
    assert abs(tot["a.b"]["s"] - ab) < 1e-9
    assert abs(tot["a.b"]["self_s"] - (ab - c)) < 1e-9
    assert abs(tot["a"]["self_s"] - (a.seconds - ab)) < 1e-9
    assert tot["a"]["self_s"] >= 0.002 and tot["a.b.c"]["self_s"] >= 0.001
    assert r.doc()["counters"] == {"rows": 7, "once": 1, "trace.dropped": 0}
    assert trace.active() is None


def test_outside_a_run_spans_are_one_no_op():
    assert trace.active() is None
    s1, s2 = trace.span("x"), trace.span("y")
    assert s1 is s2
    with s1 as s:
        trace.count("x", 5)
    assert s.seconds == 0.0
    # a run opened inside another stands alone and gives it back
    with trace.run() as outer:
        with trace.run() as inner:
            with trace.span("in"):
                pass
        assert trace.active() is outer
        with trace.span("out"):
            pass
    assert [s[0] for s in inner.spans] == ["in"]
    assert [s[0] for s in outer.spans] == ["out"]
    assert trace.active() is None


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.run() as r:
        for _ in range(2):
            with trace.span("loop"):
                with trace.span("loop.inner"):
                    pass
    assert [s[0] for s in r.spans] == ["loop", "loop.inner", "loop"]
    assert all(s[2] >= s[1] > 0 for s in r.spans)
    doc = r.doc()
    assert doc["counters"]["trace.dropped"] == 1
    # the totals see every span, kept or dropped
    assert doc["span_totals"]["loop.inner"]["n"] == 2


def test_runstats_layout(tmp_path):
    with trace.run() as r:
        tele = pipeline.Telemetry("5p10XGEX", "in.fastq.gz",
                                  torch.device("cpu"), r)
        with trace.span("align_decon") as st:
            with trace.span("decon.read"):
                _busy(1_000_000)
        tele.stage(st, 1000, whitelist_s=0.5, deferred_reads=None,
                   phase_s={"read": 0.001})
        with trace.span("dedup") as st:
            pass
        tele.stage(st)
        trace.count("match.rows", 12)
        tele.write(str(tmp_path), "s")
    with open(tmp_path / "s_runstats.json") as f:
        doc = json.load(f)
    assert {"mode", "infile", "device", "stages", "total_seconds", "clock",
            "spans", "span_totals", "counters"} <= set(doc)
    assert doc["clock"] == "time_ns"
    assert [s[0] for s in doc["spans"]] == ["align_decon", "decon.read",
                                            "dedup"]
    row, dedup = doc["stages"]
    assert row["stage"] == "align_decon" and row["reads"] == 1000
    assert row["seconds"] == round(st_seconds(doc, 0), 3)
    assert row["whitelist_s"] == 0.5 and row["phase_s"] == {"read": 0.001}
    assert "deferred_reads" not in row and row["reads_per_s"] > 0
    assert dedup == {"stage": "dedup", "seconds": round(st_seconds(doc, 2),
                                                         3)}
    assert doc["counters"] == {"match.rows": 12, "trace.dropped": 0}
    assert set(doc["span_totals"]["decon.read"]) == {"n", "s", "self_s"}


def st_seconds(doc, i):
    return (doc["spans"][i][2] - doc["spans"][i][1]) / 1e9


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    with trace.run() as r:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("mm"):
                torch.mm(a, a)
    _, t0, t1, _ = r.spans[0]
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(starts) == 1
    assert t0 <= starts[0] <= t1
