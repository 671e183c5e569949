"""Share of the candidates matched after the stream that reach the
exhaustive DP, in percent (the counters match.rows_dp over match.rows;
stages/barcode.py). 100 where the whitelist has no tier tables. Moves
reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.counter_pct(run, "match.rows_dp", "match.rows")
