"""Milliseconds a thousand reads spend on the genome stage's exon blocks
(the genome.exons span, a child of genome.align: the blocks cut from each
chain's anchors and clipped where they overlap, on the host;
align/aligner.extract_exons, clip_exon_blocks). A program without the span
gives nothing. Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "genome.exons")
