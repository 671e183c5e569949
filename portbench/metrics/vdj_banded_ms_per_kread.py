"""Milliseconds a thousand reads spend in the clonotyper's host banded DP
of the V spans (the vdj.banded span: runtime/native_lib.banded_align_batch,
C++). Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "vdj.banded")
