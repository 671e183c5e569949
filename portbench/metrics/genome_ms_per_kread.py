"""Milliseconds a thousand reads spend in the genome stage (genome_tag:
pipeline.genome_stage, the splice chain on the card, the host banded DP,
io/bam.py). Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "genome_tag")
