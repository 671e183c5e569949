"""Milliseconds a thousand reads spend assembling clones from the calls
(the vdj.assemble span: vdj/clonotype.assemble and its germline context).
Moves reads_per_s."""

import span_readers


def read(run: dict) -> float | None:
    return span_readers.ms_per_kread(run, "vdj.assemble")
