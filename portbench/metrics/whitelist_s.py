"""Seconds a sample spends building the whitelist tables (the
align_decon stage's whitelist_s, pipeline._matcher and
stages/barcode.build_tables), averaged over the traced run's unprofiled
samples. Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    rows = readers.stage_rows(run, "align_decon")
    vals = [r["whitelist_s"] for r in rows if "whitelist_s" in r]
    return sum(vals) / len(vals) if vals else None
