"""Shared arithmetic of the per-layer metric readers (metrics/<name>.py).

A reader gets `run`: {"stats": the run statistics ({sample}_runstats.json)
of the traced run's unprofiled samples, "reads": their reads, "device":
the profiled sample's trace or None}.
It returns a number, or None where the run has nothing to read for it.
"""

from __future__ import annotations

from roofline import kernels


def stage_rows(run: dict, stage: str) -> list:
    return [r for doc in run["stats"] for r in doc["stages"]
            if r["stage"] == stage]


def ms_per_kread(run: dict, stage: str, *keys) -> float | None:
    """Milliseconds a thousand input reads spent in `stage` (or in the
    nested part `keys` of it), over the unprofiled samples."""
    rows = stage_rows(run, stage)
    if not rows or not run["reads"]:
        return None
    total = 0.0
    for r in rows:
        v = r if keys else r["seconds"]
        for k in keys:
            v = v.get(k) if isinstance(v, dict) else None
        if v is None:
            return None
        total += float(v)
    return total * 1e3 / (run["reads"] / 1e3)


def roofline_pct(run: dict, kernel: str, name_part: str) -> float | None:
    """Share of the least time (roofline/kernels.py) in the card's time of
    every launch of `kernel` in the profiled sample, in percent; None
    without launches or when the launches recorded and the kernels traced
    disagree in number."""
    dev = run.get("device")
    if not dev:
        return None
    launches = dev["launches"][kernel]
    traced = [(n, ns) for n, ns in dev["kernel_ns"].items()
              if name_part in n]
    if not launches or not traced:
        return None
    if sum(c for n, c in dev["kernel_n"].items() if name_part in n) != \
            len(launches):
        return None
    least = 0.0
    for shape, n, extra in launches:
        fn = kernels.k1 if kernel == "k1" else kernels.k4
        least += kernels.least_seconds(*fn(shape, n, extra))
    took = sum(ns for _, ns in traced) / 1e9
    return 100.0 * least / took if took > 0 else None
