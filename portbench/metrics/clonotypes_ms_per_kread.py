"""Milliseconds a thousand reads spend in the native clonotyper and the
clone joins (the clonotypes stage; vdj/caller.py, vdj/clonotype.py,
stages/clones.py). Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.ms_per_kread(run, "clonotypes")
