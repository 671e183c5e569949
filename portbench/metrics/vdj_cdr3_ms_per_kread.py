"""Milliseconds a thousand reads spend in the clonotyper's per-call host
loop (the vdj.cdr3 span: the Cys anchor, CDR3 translation, partial
junctions, the C-region probe; vdj/caller.py). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "vdj.cdr3")
