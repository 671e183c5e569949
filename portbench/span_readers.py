"""Shared arithmetic of the readers of the program's own spans and counters
(metrics/<name>.py): the span_totals and counters of each run statistics
file ({sample}_runstats.json; nanoranger_torch/trace.py writes them).

A run statistics file without them, from a program older than its tracer,
gives None, and so does a run in which no sample holds the span or counter
read.
"""

from __future__ import annotations


def _traced(run: dict) -> list | None:
    docs = run["stats"]
    if not docs or not all("span_totals" in d for d in docs):
        return None
    return docs


def ms_per_kread(run: dict, *names) -> float | None:
    """Milliseconds a thousand input reads spent in the spans `names`
    (their summed seconds) over the unprofiled samples."""
    docs = _traced(run)
    if docs is None or not run["reads"]:
        return None
    tots = [d["span_totals"] for d in docs]
    if not any(n in t for t in tots for n in names):
        return None
    s = sum(t[n]["s"] for t in tots for n in names if n in t)
    return s * 1e3 / (run["reads"] / 1e3)


def seconds_per_sample(run: dict, name: str) -> float | None:
    """Seconds a sample spent in the spans `name`, averaged over the
    unprofiled samples."""
    docs = _traced(run)
    if docs is None:
        return None
    vals = [d["span_totals"][name]["s"] for d in docs
            if name in d["span_totals"]]
    return sum(vals) / len(docs) if vals else None


def counter_pct(run: dict, part: str, whole: str) -> float | None:
    """The counter `part` over the counter `whole`, summed over the
    unprofiled samples, in percent."""
    docs = _traced(run)
    if docs is None:
        return None
    den = sum(d.get("counters", {}).get(whole, 0) for d in docs)
    if den <= 0:
        return None
    return 100.0 * sum(d["counters"].get(part, 0) for d in docs) / den
