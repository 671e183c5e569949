"""Milliseconds a thousand reads spend in the staged match's exhaustive DP
(the match.dp span: K4, the one-vs-all DP, and K5, the banded UMI
rescore; stages/barcode.BarcodeMatcher._dp_pass). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "match.dp")
