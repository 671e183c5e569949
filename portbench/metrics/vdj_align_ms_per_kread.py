"""Milliseconds a thousand reads spend on the clonotyper's V assignment
(the vdj.index and vdj.align spans: the merged V index and its aligner,
K1 on the V panels, the best record of each subread and the banded jobs
cut from it; vdj/caller.py). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "vdj.index", "vdj.align")
