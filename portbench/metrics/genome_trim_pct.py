"""Share of the genome records' exon blocks that overlap the block before
them and are trimmed, in percent (the counters genome.blocks_trimmed over
genome.blocks; pipeline.genome_stage). A program without the counters
gives nothing. Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.counter_pct(run, "genome.blocks_trimmed",
                                    "genome.blocks")
