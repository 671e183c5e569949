"""Milliseconds a thousand reads spend in the staged match's tier passes
after the stream (the match.tiers span: the exact-class and full-class
passes of stages/barcode.BarcodeMatcher.match). A whitelist without tier
tables has none. Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "match.tiers")
