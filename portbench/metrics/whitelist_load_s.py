"""Seconds a sample spends loading the whitelist (the whitelist.load span:
pipeline._load_whitelist, the 737K list read and parsed), averaged over
the traced run's unprofiled samples. whitelist_s less it is the table
build. Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.seconds_per_sample(run, "whitelist.load")
