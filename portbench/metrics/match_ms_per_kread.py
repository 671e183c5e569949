"""Milliseconds a thousand reads spend in the staged whitelist match
after the stream (the barcode_match stage; pipeline.match_barcodes,
stages/barcode.py: tiers, K4, K5). Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "barcode_match")
