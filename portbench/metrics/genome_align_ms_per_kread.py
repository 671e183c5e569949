"""Milliseconds a thousand reads spend in the genome stage's alignment (the
genome.align span: the splice-class chain DP on the card, K1, the records
and, within it, the exon blocks; pipeline.genome_stage). Moves
reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "genome.align")
