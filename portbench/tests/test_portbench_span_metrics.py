"""The readers of the program's spans and counters on made-up run
statistics, and on run statistics of a program without its tracer."""

import pytest

import harness
from test_portbench_metrics import STATS

SPAN_METRICS = ("whitelist_load_s", "step_issue_ms_per_kread",
                "step_wait_ms_per_kread", "match_tiers_ms_per_kread",
                "match_dp_ms_per_kread", "match_dp_row_pct",
                "vdj_align_ms_per_kread", "vdj_banded_ms_per_kread",
                "vdj_cdr3_ms_per_kread", "vdj_assemble_ms_per_kread")


def tot(s):
    return {"n": 1, "s": s, "self_s": s}


def doc(**spans):
    d = {"stages": STATS[0]["stages"], "clock": "time_ns", "spans": [],
         "span_totals": {k.replace("_", "."): tot(v)
                         for k, v in spans.items()},
         "counters": {"match.rows": 400, "match.rows_dp": 100}}
    return d


def read(name, stats, reads=8000):
    return harness.load_metric(name).read(
        {"stats": stats, "reads": reads, "device": None})


def test_span_readers_on_traced_runstats():
    one = doc(whitelist_load=0.7, decon_step_issue=0.2,
              decon_step_download=0.1, match_tiers=0.05, match_dp=0.02,
              vdj_index=0.3, vdj_align=0.5, vdj_banded=0.04, vdj_cdr3=0.4,
              vdj_assemble=0.25)
    two = doc(whitelist_load=0.9, decon_step_issue=0.4,
              decon_step_download=0.3, match_tiers=0.15, match_dp=0.06,
              vdj_index=0.1, vdj_align=0.3, vdj_banded=0.06, vdj_cdr3=0.2,
              vdj_assemble=0.15)
    two["counters"] = {"match.rows": 600, "match.rows_dp": 600}
    stats = [one, two]
    assert read("whitelist_load_s", stats) == pytest.approx(0.8)
    # seconds over 8 kreads, in ms
    want = {"step_issue_ms_per_kread": 0.6, "step_wait_ms_per_kread": 0.4,
            "match_tiers_ms_per_kread": 0.2, "match_dp_ms_per_kread": 0.08,
            "vdj_align_ms_per_kread": 1.2, "vdj_banded_ms_per_kread": 0.1,
            "vdj_cdr3_ms_per_kread": 0.6, "vdj_assemble_ms_per_kread": 0.4}
    for name, s in want.items():
        assert read(name, stats) == pytest.approx(s * 1e3 / 8), name
    assert read("match_dp_row_pct", stats) == pytest.approx(70.0)
    # issue and wait make up the step as the program derives phase_s
    assert read("step_issue_ms_per_kread", stats) + \
        read("step_wait_ms_per_kread", stats) == pytest.approx(1.0e3 / 8)


def test_span_readers_find_nothing_to_read():
    # run statistics of a program without the tracer: no number, no raise
    for name in SPAN_METRICS:
        assert read(name, STATS) is None, name
        assert read(name, []) is None, name
    # traced, but the cell has no such span or counter
    bare = [doc()]
    bare[0]["counters"] = {}
    for name in SPAN_METRICS:
        assert read(name, bare) is None, name
