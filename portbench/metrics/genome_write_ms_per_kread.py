"""Milliseconds a thousand reads spend writing the tagged genome BAM (the
genome.write span: the merge of the coordinate-sorted spills into the BAM,
its index and the transcript counts; io/bam.py). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "genome.write")
