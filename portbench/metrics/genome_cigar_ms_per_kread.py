"""Milliseconds a thousand reads spend in the genome stage's host banded
DP of the exons and their CIGARs (genome_tag.cigar_s;
runtime/native_lib.banded_align_batch). Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "genome_tag", "cigar_s")
